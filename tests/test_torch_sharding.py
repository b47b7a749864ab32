"""The port's sharding rules (``distributed/sharding.py``) held against the
JAX package's, entry for entry, on the same trees.

- ``param_specs`` on the SMOKE params of every registry config (the port's
  own ``init_params`` on the CPU against the reference's abstract tree),
  float, integerized (w4), nibble-packed, and with ``expert_fsdp``: the
  same leaves, and each spec equal to JAX's ``PartitionSpec``;
- ``zero1_specs`` over those specs at data sizes 2 and 16;
- ``batch_specs`` and ``cache_specs`` (the ring caches, int and float) for
  batch axes (), ("data",) and ("pod", "data");
- ``enforce_divisible`` and ``filter_mesh_axes`` on meshes that drop
  sharding (a model axis of 3, a mesh without "pod");
- ``named_shardings``: the DTensor placements each spec means.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jregistry
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.distributed import sharding as js
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models import vit as jvit
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.core.api import QuantConfig, integerize_params
from repro_torch.distributed import sharding as ts
from repro_torch.models import encdec, lm, vit

torch.set_num_threads(1)

ARCHS = sorted(registry.ARCHS)
VARIANTS = ("float", "int", "packed", "expert_fsdp")


def _family(cfg):
    if registry.is_encdec(cfg):
        return jencdec, encdec
    if hasattr(cfg, "img_size"):
        return jvit, vit
    return jlm, lm


def _quant(variant):
    if variant == "float":
        return None
    kw = dict(w_bits=4, a_bits=8, mode="int",
              pack_weights=variant == "packed")
    return JQuantConfig(**kw), QuantConfig(**kw)


_TREES = {}


def _trees(arch, variant):
    """(JAX abstract params, the port's params on the CPU) of the SMOKE
    config; ``expert_fsdp`` uses the integerized tree."""
    key = (arch, variant)
    if key not in _TREES:
        jcfg, cfg = jregistry.smoke_config(arch), registry.smoke_config(arch)
        jfam, fam = _family(cfg)
        q = _quant("int" if variant == "expert_fsdp" else variant)
        if hasattr(jcfg, "quant"):
            jcfg, cfg = jcfg.replace(quant=None), cfg.replace(quant=None)

        def jinit(k):
            p = jfam.init_params(k, jcfg)
            return p if q is None else j_integerize(p, q[0])
        jp = jax.eval_shape(jinit, jax.random.PRNGKey(0))
        tp = fam.init_params(cfg, seed=0, device="cpu")
        if q is not None:
            tp = integerize_params(tp, q[1])
        _TREES[key] = jp, tp
    return _TREES[key]


def _jflat(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(k.key for k in path): tuple(s) for path, s in flat}


def _tflat(specs):
    out = {}
    for keys, spec in tree_lib.leaves_with_keys(specs):
        assert isinstance(spec, ts.P), (keys, spec)
        out[keys] = tuple(spec)
    return out


def _same(tspecs, jspecs):
    got, want = _tflat(tspecs), _jflat(jspecs)
    assert got.keys() == want.keys(), got.keys() ^ want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, variant):
    jp, tp = _trees(arch, variant)
    fsdp = variant == "expert_fsdp"
    _same(ts.param_specs(tp, expert_fsdp=fsdp),
          js.param_specs(jp, expert_fsdp=fsdp))


@pytest.mark.parametrize("data_size", (2, 16))
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "qwen2.5-32b",
                                  "recurrentgemma-9b", "whisper-large-v3"])
def test_zero1_specs_equal_reference(arch, data_size):
    jp, tp = _trees(arch, "expert_fsdp")
    jz = js.zero1_specs(jp, js.param_specs(jp, expert_fsdp=True),
                        data_size=data_size)
    tz = ts.zero1_specs(tp, ts.param_specs(tp, expert_fsdp=True),
                        data_size=data_size)
    _same(tz, jz)
    for spec in _tflat(tz).values():
        names = [e for e in spec if e is not None]
        assert len(names) == len(set(names)), spec


BATCH_AXES = [(), ("data",), ("pod", "data")]


@pytest.mark.parametrize("batch_axes", BATCH_AXES)
def test_batch_specs_equal_reference(batch_axes):
    shapes = {"tokens": (8, 16), "labels": (8, 16), "patches": (8, 4, 32),
              "step": ()}
    jb = {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in shapes.items()}
    tb = {k: torch.empty(s, dtype=torch.int32, device="meta")
          for k, s in shapes.items()}
    _same(ts.batch_specs(tb, batch_axes), js.batch_specs(jb, batch_axes))


CACHE_ARCHS = ["mamba2-130m", "qwen2.5-32b", "recurrentgemma-9b",
               "whisper-large-v3"]


@pytest.mark.parametrize("mode", ["int", "float"])
@pytest.mark.parametrize("batch_axes", BATCH_AXES)
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_equal_reference(arch, batch_axes, mode):
    jcfg, cfg = jregistry.smoke_config(arch), registry.smoke_config(arch)
    if mode == "int":
        jcfg = jcfg.replace(quant=JQuantConfig(mode="int"))
        cfg = cfg.replace(quant=QuantConfig(mode="int"))
    jfam, fam = _family(cfg)
    jc = jax.eval_shape(lambda: jfam.init_cache(jcfg, 4, 32))
    tc = fam.init_cache(cfg, 4, 32, device="cpu")
    _same(ts.cache_specs(tc, batch_axes), js.cache_specs(jc, batch_axes))


class _JMesh:
    """What the reference's mesh functions read of a mesh."""

    def __init__(self, sizes):
        self.shape, self.axis_names = dict(sizes), tuple(sizes)


def _tmesh(sizes):
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))


MESHES = [{"data": 2, "model": 3}, {"data": 4, "model": 16},
          {"pod": 2, "data": 2, "model": 2}]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen2.5-32b",
                                  "mamba2-130m", "deit-s"])
def test_filter_and_enforce_divisible_equal_reference(arch, sizes):
    jp, tp = _trees(arch, "expert_fsdp")
    jm, tm = _JMesh(sizes), _tmesh(sizes)
    jspecs = js.zero1_specs(jp, js.param_specs(jp, expert_fsdp=True),
                            data_size=2)
    tspecs = ts.zero1_specs(tp, ts.param_specs(tp, expert_fsdp=True),
                            data_size=2)
    jf = js.enforce_divisible(js.filter_mesh_axes(jspecs, jm), jp, jm)
    tf = ts.enforce_divisible(ts.filter_mesh_axes(tspecs, tm), tp, tm)
    _same(tf, jf)
    # and on the batch specs over ("pod", "data"), which "pod" may lack
    shapes = {"tokens": (6, 16), "labels": (8, 16)}
    jb = js.batch_specs({k: jax.ShapeDtypeStruct(s, np.int32)
                         for k, s in shapes.items()}, ("pod", "data"))
    tb = ts.batch_specs({k: torch.empty(s, device="meta")
                         for k, s in shapes.items()}, ("pod", "data"))
    jabs = {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in shapes.items()}
    tabs = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    _same(ts.enforce_divisible(ts.filter_mesh_axes(tb, tm), tabs, tm),
          js.enforce_divisible(js.filter_mesh_axes(jb, jm), jabs, jm))


def test_enforce_divisible_drops_vocab_as_reference():
    """The reference's own case: vocab 50280 over a model axis of 16."""
    jm, tm = _JMesh({"model": 16}), _tmesh({"model": 16})
    want = js.enforce_divisible({"emb": JP("model", None)},
                                {"emb": jax.ShapeDtypeStruct((50280, 8),
                                                             np.float32)}, jm)
    got = ts.enforce_divisible({"emb": ts.P("model", None)},
                               {"emb": torch.empty((50280, 8),
                                                   device="meta")}, tm)
    assert tuple(got["emb"]) == tuple(want["emb"]) == (None, None)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _tmesh({"pod": 2, "data": 2, "model": 2})
    place = ts.named_shardings(
        {"a": ts.P(None, "model"), "b": ts.P(("pod", "data"), None),
         "c": ts.P(), "d": ts.P("data", None, "model")}, mesh)
    assert place["a"] == [Replicate(), Replicate(), Shard(1)]
    assert place["b"] == [Shard(0), Shard(0), Replicate()]
    assert place["c"] == [Replicate()] * 3
    assert place["d"] == [Replicate(), Shard(0), Shard(2)]
    with pytest.raises(ValueError):
        ts.placements(ts.P(("model", "data")), mesh)


def test_shard_is_the_identity_and_rules_nest():
    x = torch.randn(2, 3)
    rules = ts.Rules(batch=("data",))
    assert ts.current_rules() is None
    with ts.use_rules(rules):
        assert ts.current_rules() is rules
        assert ts.shard(x, "batch", None) is x
        with ts.use_rules(None):
            assert ts.current_rules() is None
        assert rules.axes("batch") == "data"
        assert rules.axes("seq") == ()
        assert rules.axes("model") == "model"
    assert ts.current_rules() is None
