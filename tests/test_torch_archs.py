"""The dense GQA and MoE decoder families of the port (ChatGLM3-6B, Yi-34B,
Phi-3-medium, InternVL2-26B with its patch frontend, Llama-4-Scout,
Phi-3.5-MoE) held against the JAX package at their SMOKE widths, with
JAX's weights carried over by ``interop``.

- The SMOKE configurations: the reference's widths, field for field.
- ``integerize_params``: leaf for leaf equal to JAX's (eager) on the same
  float tree, expert codes and the float router included.
- The ring path: ``prefill`` (InternVL2 with its 8 patch embeddings
  prepended, so the 16-token prompt fills 24 positions of a 20-slot ring,
  which wraps) and 4 greedy ``decode_step``s at w8 and w4, both port
  backends teacher-forced with JAX's tokens; ``pos`` as the reference's
  ``tests/test_models_smoke.py`` asserts it (16 + n_patches + steps).
  Logits within FLIP_TOL of their max in every step (XLA contracts FMAs
  where the port rounds twice, so an activation code can flip at a
  rounding edge: ``tests/test_torch_lm.py``), within 1e-6 in at least
  half; greedy tokens equal in every step.
- The paged path: ``serve`` (3 staggered requests on 3 rows, pages of 8)
  gives exactly the reference engine's tokens, on both port backends.
- For the three dense configurations, a batch row equals the same request
  served solo, bit for bit, on both backends at kv 8 and 4.  For MoE the
  reference's capacity counts every token of a call, so a row's tokens
  depend on its neighbours (ROADMAP queue 3) and this is not asserted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.kernels import dispatch as jdispatch
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.core.api import QuantConfig, integerize_params
from repro_torch.kernels import dispatch
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import PagedEngine, Request
from repro_torch.models import lm

torch.set_num_threads(1)

ARCHS = ["chatglm3-6b", "yi-34b", "phi3-medium-14b", "internvl2-26b",
         "llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b"]
DENSE = ARCHS[:3]
TOL = 1e-6
FLIP_TOL = 0.1
STEPS = 4


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


_FLOAT = {}
_INT = {}


def _float_params(arch):
    if arch not in _FLOAT:
        cfg = jreg.smoke_config(arch)
        _FLOAT[arch] = jax.jit(lambda k: jlm.init_params(k, cfg))(
            jax.random.PRNGKey(0))
    return _FLOAT[arch]


def _jq(w_bits, kv_bits=8):
    return JQuantConfig(w_bits=w_bits, a_bits=8, attn_bits=7,
                        kv_bits=kv_bits, mode="int")


def _models(arch, w_bits, kv_bits=8):
    """JAX config and integerized params; the port's config per backend
    and the same params through interop."""
    if (arch, w_bits) not in _INT:
        jp = j_integerize(_float_params(arch), _jq(w_bits))
        _INT[arch, w_bits] = (jp, interop.to_torch(jax.tree.map(np.asarray,
                                                                jp), "cpu"))
    jp, tp = _INT[arch, w_bits]
    jcfg = jreg.smoke_config(arch).replace(quant=_jq(w_bits, kv_bits))
    ports = {b: registry.smoke_config(arch).replace(quant=QuantConfig(
        w_bits=w_bits, a_bits=8, attn_bits=7, kv_bits=kv_bits, mode="int",
        backend=b)) for b in ("torch", "cuda")}
    return jcfg, jp, ports, tp


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_is_the_reference_s(arch):
    want, got = jreg.smoke_config(arch), registry.smoke_config(arch)
    for f in dataclasses.fields(got):
        w = getattr(want, f.name)
        g = getattr(got, f.name)
        if f.name == "moe" and w is not None:
            w, g = dataclasses.asdict(w), dataclasses.asdict(g)
        assert g == w, f.name
    want, got = jreg.get_config(arch), registry.get_config(arch)
    assert (got.d_model, got.n_heads, got.kv_heads, got.d_ff, got.vocab,
            got.hd, got.frontend, got.n_patches) == \
        (want.d_model, want.n_heads, want.kv_heads, want.d_ff, want.vocab,
         want.hd, want.frontend, want.n_patches)


@pytest.mark.parametrize("arch", ARCHS)
def test_integerized_tree_leaf_for_leaf(arch):
    fp = _float_params(arch)
    want = dict(_leaves(jax.tree.map(np.asarray,
                                     j_integerize(fp, _jq(4)))))
    tree = integerize_params(interop.to_torch(jax.tree.map(np.asarray, fp),
                                              "cpu"),
                             QuantConfig(w_bits=4, mode="int"))
    got = dict(_leaves(interop.to_numpy(tree)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_array_equal(got[path], w.astype(got[path].dtype),
                                      err_msg=path)
    if "moe" in arch:
        assert got["/units/b0/ffn/experts_up/w_q"].dtype == np.int8
        assert got["/units/b0/ffn/router/w"].dtype == np.float32


def _batch(cfg, seed=0, b=2, s=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "patch":
        batch["patches"] = rng.randn(b, cfg.n_patches,
                                     cfg.d_model).astype(np.float32)
    return batch


_JAX_FNS = {}


def _jax_ring(jcfg, jp, batch):
    """JAX ring prefill (max_len 20) + STEPS greedy decode steps on the XLA
    path: logits per step, the tokens fed, the final ``pos``."""
    if jcfg not in _JAX_FNS:
        _JAX_FNS[jcfg] = (
            jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, max_len=20)),
            jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, jcfg)))
    prefill, decode = _JAX_FNS[jcfg]
    with jdispatch.use_backend("xla"):
        lj, jc = prefill(jp, jax.tree.map(jnp.asarray, batch))
        logits, fed = [np.asarray(lj)], []
        for _ in range(STEPS):
            fed.append(np.asarray(jnp.argmax(lj, -1), np.int32))
            lj, jc = decode(jp, jnp.asarray(fed[-1]), jc)
            logits.append(np.asarray(lj))
    return logits, fed, int(jc["pos"])


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_ring_prefill_and_decode_track_jax(arch, w_bits):
    jcfg, jp, ports, tp = _models(arch, w_bits)
    batch = _batch(jcfg)
    want, fed, jpos = _jax_ring(jcfg, jp, batch)
    n_front = jcfg.n_patches if jcfg.frontend == "patch" else 0
    assert jpos == 16 + n_front + STEPS
    tight = steps = 0
    for backend, cfg in ports.items():
        tb = interop.to_torch(batch, "cpu")
        lt, cache = lm.prefill(tp, tb, cfg, max_len=20)
        got = [lt.numpy()]
        for tok in fed:
            lt, cache = lm.decode_step(tp, torch.from_numpy(tok.copy()),
                                       cache, cfg)
            got.append(lt.numpy())
        assert int(cache["pos"]) == jpos
        for g, w in zip(got, want):
            rel = np.abs(g - w).max() / np.abs(w).max()
            assert rel <= FLIP_TOL, (backend, rel)
            tight += int(rel <= TOL)
            steps += 1
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    assert tight >= steps / 2, (tight, steps)


def _prompts(vocab, lens=(13, 7, 10), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serve_tokens_equal_the_reference_engine(arch):
    jcfg, jp, ports, tp = _models(arch, 4)
    prompts = _prompts(jcfg.vocab)
    kw = dict(gen_tokens=5, page_size=8, batch_size=3, audit_every=1)
    with jdispatch.use_backend("xla"):
        want, wstats = jserve.serve(jcfg, jp, prompts, **kw)
    assert [s["status"] for s in wstats["per_seq"]] == ["done"] * 3
    for backend, cfg in ports.items():
        dispatch.reset_stats()
        got, stats = tserve.serve(cfg, tp, prompts, **kw)
        assert [s["status"] for s in stats["per_seq"]] == ["done"] * 3
        assert stats["audit_violations"] == []
        np.testing.assert_array_equal(got, want, err_msg=backend)
        assert dispatch.STATS[f"qlinear_{backend}"] > 0
        assert dispatch.STATS[f"qexpert_{backend}"] > 0 or "moe" not in arch


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_batch_row_equals_the_row_solo(arch, backend, kv_bits):
    _, _, ports, tp = _models(arch, 4, kv_bits)
    cfg = ports[backend]
    prompts = _prompts(cfg.vocab)
    kw = dict(batch_size=3, max_len=32, page_size=8, prefill_buckets=(16,),
              audit_every=1)

    def run(ps):
        eng = PagedEngine(cfg, tp, **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(ps)]
        eng.run(reqs)
        assert all(r.status == "done" for r in reqs)
        assert eng.audit() == []
        return [r.tokens for r in reqs]

    batched = run(prompts)
    for p, toks in zip(prompts, batched):
        assert run([p]) == [toks]
