"""Attention and the ring split by column (``distributed/partition.py``:
``split_plan``'s "columns", where the model ranks do not divide the KV
heads): wq, wk and wv by flat output columns and wo by K, as the
reference's ``param_specs`` cut them (a cut may fall inside a head), and
the ring by slot, as its ``cache_specs``; every rank gathers q, k and v
(bytes), attends every head, writes its slots and decodes over the ring's
slot ranges (``models/lm.py::_ring_split_decode``).

In this process:

- the staged ring, each rank a thread exchanging in memory, at slot splits
  of 2, 4 and 16 over kv8 and kv4 rings partly written, wrapped and
  windowed (dead chunks inside live blocks), of one and two ``bk``
  blocks: its plain stages (``ref.int_decode_attention_staged_ref``, what
  the ``torch`` backend runs on meta tensors, so the dry run counts the
  card's exchanges) bitwise the three passes on the whole ring
  (``ref.int_decode_attention_chunked_ref``), their codes the ring
  oracle's and the output within ATTN_TOL of it;
  ``int_attention.int_decode_attention_staged`` on CPU tensors (its plain
  version gathers the ring) bitwise the ring kernel's plain version on the
  whole ring; a span whose ranges are not whole chunks has no staged plan
  (the layer gathers the ring's codes);
- every attention and ring leaf of the decoder LMs' SMOKE configs on
  (data 1, model 4) and (2, 2), and of their registry configs at model 2,
  4 and 16, against the reference's shard shape (``NamedSharding(
  AbstractMesh).shard_shape`` of JAX's ``param_specs`` and
  ``cache_specs`` after ``enforce_divisible``): equal where attention
  splits by column, the same bytes by head (the ring by KV head there, so
  a decode step exchanges nothing); no rank holds wq, wk, wv or wo whole
  where the reference's column split divides.

In this process too, under torch's fake process group of 4 ranks, a
decode step of the same configs on meta tensors (the dry run: the
``torch`` backend's plain stages) sends exactly
``chip_smoke.decode_wire_analytic``'s bytes.

Over gloo, four ranks on (data 1, model 4) (``tests/_torch_dist_util.py
attnsplit``) against this process's one-rank runs:

- ChatGLM3 and Qwen2.5 SMOKE (kv 2) with a 1024-slot ring (256 slots a
  rank: the staged ring), prefill of 4 x 32 tokens and 4 greedy steps:
  on both backends every rank's logits, fed tokens and the gathered ring
  bitwise one rank's (the ``torch`` backend gathers the ring's codes on
  real tensors); a decode step's bytes sent equal to
  ``chip_smoke.decode_wire_analytic`` (the card's exchanges) with, in
  place of the ring's partials and PV, the ring's codes gathered (and, on
  the ``cuda`` backend's plain version, its slot map too);
- JAX's prefill cache of Qwen2.5 SMOKE (1024 slots) carried into each
  rank's slot shard by ``interop.to_torch_shard`` decodes 4 greedy steps
  bitwise as one rank does from the whole cache;
- a fake-mode train step of ChatGLM3 SMOKE (w4/a8/attn7): the loss and
  the gathered gradients' norm within ``tests/test_torch_partition_train.
  py``'s STEP_LOSS_RTOL and STEP_GNORM_RTOL of one rank's, every
  attention gradient at the rank's shard of its leaf.
"""
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_util as util  # noqa: E402

sys.path.insert(0, util.ROOT)
from chip_smoke import decode_wire_analytic  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core.api import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.api import integerize_params as j_integerize  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa
from repro_torch.core.quant import pack_int4, unpack_int4  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import int_attention as ia  # noqa: E402
from repro_torch.launch import train  # noqa: E402

torch.set_num_threads(1)

JOIN_S = 240
ATTN_TOL = 2e-6
STEP_LOSS_RTOL, STEP_GNORM_RTOL = 5e-3, 5e-2
# the registry's decoder LMs with attention
LM_ARCHS = ["qwen2.5-32b", "chatglm3-6b", "yi-34b", "phi3-medium-14b",
            "llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b",
            "internvl2-26b", "recurrentgemma-9b"]


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


# ---------------------------------------------------------------------------
# The staged ring, its ranks as threads
# ---------------------------------------------------------------------------

class Ranks:
    """``m`` threads' exchanges in memory: an all-gather along dim 1 in
    rank order and an int32 sum."""

    def __init__(self, m):
        self.m, self.bar, self.slot = m, threading.Barrier(m), [None] * m

    def _swap(self, j, t, fn):
        self.slot[j] = t
        self.bar.wait()
        out = fn(list(self.slot))
        self.bar.wait()
        return out

    def gather(self, j, t):
        return self._swap(j, t, lambda ts: torch.cat(ts, 1))

    def reduce(self, j, t):
        return self._swap(j, t, lambda ts: sum(ts))


def staged(fn, args, parts, **kw):
    """``fn`` (a staged ring function) on each of ``parts`` slot ranges in
    a thread of its own: every rank's (out, codes)."""
    q, k, v, sc, vs, kpos, pos = args
    n = k.shape[1] // parts
    ranks, res = Ranks(parts), [None] * parts

    def run(j):
        sl = slice(j * n, (j + 1) * n)
        res[j] = fn(q, k[:, sl], v[:, sl], sc, vs, kpos[sl], pos,
                    parts=parts, index=j,
                    gather=lambda t: ranks.gather(j, t),
                    reduce=lambda t: ranks.reduce(j, t), return_codes=True,
                    **kw)
    threads = [threading.Thread(target=run, args=(j,)) for j in range(parts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return res


def ring_case(kv_bits, span, pos, g=5, d=16, h=3, seed=0):
    rng = np.random.RandomState(seed + span + pos)
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    q = torch.from_numpy(rng.randint(-127, 128, (h, g, d)).astype(np.int8))
    k, v = (torch.from_numpy(rng.randint(lo, hi, (h, span, d)).astype(
        np.int8)) for _ in range(2))
    posd = torch.tensor(pos, dtype=torch.int32)
    kpos = ref.ring_positions(posd, span)
    kpos[torch.from_numpy(rng.rand(span) < 0.03)] = -1   # unwritten slots
    sc = torch.from_numpy(rng.uniform(2e-4, 2e-3, h).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(5e-3, 2e-2, h).astype(np.float32))
    if kv_bits == 4:
        k, v = pack_int4(k), pack_int4(v)
    return q, k, v, sc, vs, kpos, posd


# (kv_bits, span, pos, window, ranks): one 1024-key block partly written,
# wrapped and windowed (dead chunks), kv8 and kv4; 16 ranks of one chunk;
# two 4096-key blocks over 4 ranks
STAGED_CASES = [(8, 1024, 700, None, 2), (4, 1024, 3000, None, 4),
                (8, 1024, 5000, 300, 4), (4, 1024, 800, 200, 2),
                (8, 4096, 9000, None, 16), (4, 4096, 2000, 1000, 16),
                (8, 8192, 20000, 3000, 4), (4, 8192, 6000, None, 4)]


@pytest.mark.parametrize("kv_bits,span,pos,window,parts", STAGED_CASES)
def test_staged_ring_is_bitwise_the_whole_ring(kv_bits, span, pos, window,
                                               parts):
    args = ring_case(kv_bits, span, pos)
    q, k, v, sc, vs, kpos, posd = args
    g, d = q.shape[1:]
    packed = kv_bits == 4
    bk = dispatch.decode_blocks(span, d)
    chunk, _ = ia.staged_ring_plan(g, d, bk, span, parts)
    assert (span // parts) % chunk == 0
    kw = dict(window=window, bk=bk, packed=packed)
    ku, vu = (unpack_int4(t) if packed else t for t in (k, v))
    whole, wcodes = ref.int_decode_attention_chunked_ref(
        q, ku, vu, sc, vs, kpos, posd, window=window, bk=bk, chunk=chunk,
        return_codes=True)
    oracle, ocodes = ref.int_decode_attention_ref(
        q, ku, vu, sc, vs, kpos, posd, window=window, bk=bk,
        return_codes=True)
    assert torch.equal(wcodes, ocodes)
    assert (whole - oracle).abs().max() <= \
        ATTN_TOL * oracle.abs().max()
    res = staged(ref.int_decode_attention_staged_ref, args, parts,
                 chunk=chunk, **kw)
    for out, _ in res:
        assert torch.equal(out, whole)
    assert torch.equal(torch.cat([c for _, c in res], -1), wcodes)
    plain, pcodes = ia.int_decode_attention_plain(*args, return_codes=True,
                                                  **kw)
    before = dict(ia.LAUNCHES)
    res = staged(ia.int_decode_attention_staged, args, parts, **kw)
    assert ia.LAUNCHES == before                     # CPU: plain version
    for out, _ in res:
        assert torch.equal(out, plain)
    assert torch.equal(torch.cat([c for _, c in res], -1), pcodes)


def test_a_range_of_part_chunks_has_no_staged_plan():
    """1000 slots over 4 ranks (250 a rank) and RecurrentGemma-9B's
    2176-slot local ring over 4 and 16 (544 and 136 slots, chunks of 128):
    the layer gathers the ring; 8192 slots over 4 (2048, chunks of 256)
    and 32768 over 16 stage."""
    assert ia.staged_ring_plan(5, 16, dispatch.decode_blocks(1000, 16),
                               1000, 4) is None
    for m in (4, 16):
        assert ia.staged_ring_plan(16, 256, dispatch.decode_blocks(
            2176, 256), 2176, m) is None
    assert ia.staged_ring_plan(16, 128, 4096, 8192, 4) == (256, 128)
    assert ia.staged_ring_plan(5, 128, 4096, 32768, 16) == (256, 128)
    q, k, v, sc, vs, kpos, posd = ring_case(8, 1000, 2500)
    with pytest.raises(ValueError, match="not whole chunks"):
        ia.int_decode_attention_staged(
            q, k[:, :250], v[:, :250], sc, vs, kpos[:250], posd, parts=4,
            index=0, gather=None, reduce=None,
            bk=dispatch.decode_blocks(1000, 16))


# ---------------------------------------------------------------------------
# Attention and ring leaves against the reference's shard shapes
# ---------------------------------------------------------------------------

def _jax_shards(jtree, specs, mesh):
    """{keys: shard shape} of a JAX tree under ``specs``."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(flat, sflat):
        keys = tuple(getattr(p, "key", str(p)) for p in path)
        out[keys] = NamedSharding(mesh, spec).shard_shape(leaf.shape)
    return out


def _finalize(specs, tree, mesh):
    return jsharding.enforce_divisible(
        jsharding.filter_mesh_axes(specs, mesh), tree, mesh)


def _hold_leaves(arch, cfg, jcfg, sizes, batch, max_len):
    """Every attention and ring leaf of rank 0 against JAX's shard."""
    m = sizes["model"]
    mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    jp = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    if jcfg.quant.mode == "int":
        jp = jax.eval_shape(lambda p: j_integerize(p, jcfg.quant), jp)
    jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, max_len))
    want = _jax_shards(jp, _finalize(jsharding.param_specs(jp), jp, mesh),
                       mesh)
    want_c = _jax_shards(jc, _finalize(jsharding.cache_specs(
        jc, ("data",) if "data" in sizes else ()), jc, mesh), mesh)
    layout = partition.Layout.make(sizes, {}, ("data",))
    glob = partition.build_params(cfg, device="meta")
    specs = partition.local_param_specs(glob, cfg, layout)
    how = partition.split_plan(cfg, m)["heads"]
    n = 0
    for (keys, leaf), spec in zip(tree_lib.leaves_with_keys(glob),
                                  tree_lib.leaves(specs)):
        if "attn" not in keys:
            continue
        shape = list(leaf.shape)
        for dim, _, size in partition._region(spec, shape, layout):
            shape[dim] = size
        assert tuple(shape) == want[keys], (arch, sizes, keys)
        if keys[-2] in ("wq", "wk", "wv", "wo") and \
                keys[-1] in ("w", "w_q") and \
                tuple(want[keys]) != tuple(leaf.shape):
            assert shape != list(leaf.shape), (arch, keys)  # not whole
        n += 1
    cache = partition.init_cache(cfg, batch, max_len, layout, device="meta")
    rings = 0
    for keys, leaf in tree_lib.leaves_with_keys(cache):
        if keys[-1] not in ("k", "v"):
            continue
        jshape = tuple(want_c[keys])
        if how == "heads":                     # by KV head: the same bytes
            assert leaf.numel() == np.prod(jshape) and \
                leaf.shape[-3] * m == cfg.kv_heads, (arch, sizes, keys)
        else:
            assert tuple(leaf.shape) == jshape, (arch, sizes, keys)
        rings += 1
    assert n and rings
    return how


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 4},
                                   {"data": 2, "model": 2}],
                         ids=["1x4", "2x2"])
@pytest.mark.parametrize("weights", ["fake", "w4p"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_attention_and_ring_leaves_are_reference_shards(arch, weights,
                                                              sizes):
    from repro_torch.core.api import QuantConfig
    fields = dict(w_bits=4, a_bits=8, attn_bits=7, mode="fake") \
        if weights == "fake" else util.part_quant("w4p", 8)
    cfg = smoke_config(arch).replace(quant=QuantConfig(**fields))
    jcfg = jreg.smoke_config(arch).replace(quant=JQuantConfig(**fields))
    how = _hold_leaves(arch, cfg, jcfg, sizes, 4, 40)
    kv = cfg.kv_heads % sizes["model"]
    assert how == ("columns" if kv else "heads")


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_registry_attention_and_ring_leaves_are_reference_shards(arch, m):
    from repro_torch.core.api import QuantConfig
    cfg = get_config(arch).replace(n_layers=len(get_config(
        arch).block_pattern), quant=QuantConfig(w_bits=4, a_bits=8,
                                                attn_bits=7, mode="fake"))
    jcfg = jreg.get_config(arch).replace(
        n_layers=cfg.n_layers, quant=JQuantConfig(w_bits=4, a_bits=8,
                                                  attn_bits=7, mode="fake"))
    how = _hold_leaves(arch, cfg, jcfg, {"data": 1, "model": m}, 1, 32768)
    assert how in ("heads", "columns")


# ---------------------------------------------------------------------------
# Four gloo ranks against one rank
# ---------------------------------------------------------------------------

def _jax_prefill(tokens):
    """JAX's integerized Qwen2.5 SMOKE tree, its ring prefill at 1024
    slots (XLA path) and the greedy token after it."""
    jcfg = jreg.smoke_config("qwen2.5-32b").replace(
        quant=JQuantConfig(**util.part_quant("w8", 8)))
    params = jax.jit(lambda k: jlm.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    jp = j_integerize(params, JQuantConfig(**util.part_quant("w8", 8)))
    with jdispatch.use_backend("xla"):
        logits, cache = jax.jit(lambda p, b: jlm.prefill(
            p, b, jcfg, max_len=util.ATTN_SPLIT_MAX_LEN))(
                jp, {"tokens": jnp.asarray(tokens)})
    tok = np.asarray(jnp.argmax(logits[:, -1], -1), np.int32)[:, None]
    return jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, cache), tok


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs and this process's one-rank runs."""
    d = tmp_path_factory.mktemp("attnsplit")
    refp = d / "ref.npz"
    tokens = np.random.RandomState(11).randint(
        0, 512, (util.PART_BATCH, util.PART_PROMPT)).astype(np.int32)
    jp, jcache, jtok = _jax_prefill(tokens)
    arrays = {"tokens": tokens, "jax/tok": jtok}
    arrays.update(util.flat(jp, "jax/params/"))
    arrays.update(util.flat(jcache, "jax/cache/"))
    util.save(refp, arrays)
    procs = util.launch("attnsplit", 4, d, refp)
    one = {}
    try:
        toks = torch.from_numpy(tokens)
        for arch in util.ATTN_SPLIT_ARCHS:
            for backend in ("cuda", "torch"):
                cfg = smoke_config(arch).replace(
                    quant=util.attn_split_quant(backend))
                tree = partition.build_params(cfg, seed=0, device="cpu")
                one[arch, backend] = util.greedy(
                    tree, toks, cfg, max_len=util.ATTN_SPLIT_MAX_LEN)
        cfg = smoke_config("qwen2.5-32b").replace(
            quant=util.attn_split_quant())
        one["fromjax"] = util.greedy_from(
            interop.to_torch(jp, "cpu"), interop.to_torch(jcache, "cpu"),
            torch.from_numpy(jtok), cfg)
        cfg = util.attn_split_train_config()
        whole = partition.build_params(cfg, seed=0, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in util.train_batch(
            "attn-split", cfg).items()}
        loss, _, grads = train.value_and_grad(train.model_loss(cfg), whole,
                                              batch)
        one["train"] = (loss, grads)
    finally:
        ranks = util.join(procs, d, "attnsplit", JOIN_S)
    return ranks, one


def _cache_parts(ranks, key, cfg):
    parts = []
    for layout, r in zip(util.train_layouts(ranks, util.ATTN_SPLIT_MESH,
                                            fsdp=False), ranks):
        local = {k: torch.from_numpy(v) for k, v in r.items()
                 if k.startswith(f"{key}/cache/")}
        parts.append((layout, util.unflat(local, f"{key}/cache")))
    return parts


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("arch", util.ATTN_SPLIT_ARCHS)
def test_column_split_serving_is_one_rank(runs, arch, backend):
    ranks, one = runs
    cfg = smoke_config(arch).replace(quant=util.attn_split_quant(backend))
    logits, fed, cache = one[arch, backend]
    key = f"{arch}/{backend}"
    m = util.ATTN_SPLIT_MESH[1]
    for r in ranks:
        np.testing.assert_array_equal(r[f"{key}/fed"], fed.numpy())
        np.testing.assert_array_equal(r[f"{key}/logits"], logits.numpy())
        # the ring decode dispatches of the staged (or gathered) path
        assert int(r[f"{key}/decode"]) == util.PART_STEPS * cfg.n_layers
    parts = _cache_parts(ranks, key, cfg)
    for _, loc in parts:
        k0 = loc["units"]["b0"]["k"]
        assert k0.shape[2] == cfg.kv_heads
        assert k0.shape[3] == util.ATTN_SPLIT_MAX_LEN // m
    got = partition.gather_cache(parts, cfg)
    for (k, x), (_, y) in zip(tree_lib.leaves_with_keys(got),
                              tree_lib.leaves_with_keys(cache)):
        assert torch.equal(x, y), k


def _close(a, b):
    return abs(a - b) <= 1e-9 * max(abs(b), 1)


@pytest.mark.parametrize("arch", util.ATTN_SPLIT_ARCHS)
def test_a_decode_step_sends_the_analytic_bytes(runs, arch):
    """Real tensors: the ranks gather the ring's codes (the cuda backend's
    plain version its slot map too) where the card exchanges its stages'
    partials and PV."""
    ranks, _ = runs
    cfg = smoke_config(arch).replace(quant=util.attn_split_quant())
    m, b, span = util.ATTN_SPLIT_MESH[1], util.PART_BATCH, \
        util.ATTN_SPLIT_MAX_LEN
    want = decode_wire_analytic(cfg, m, b, span)
    g = cfg.n_heads // cfg.kv_heads
    h, hd, n = b * cfg.kv_heads, cfg.hd, span // m
    chunk, _ = ia.staged_ring_plan(g, hd, dispatch.decode_blocks(span, hd),
                                   span, m)
    nblk = 1                      # decode_blocks(1024, 16): one block
    layers = cfg.n_layers
    codes = layers * (m - 1) * 2 * h * n * hd
    partials = layers * (m - 1) * 2 * h * (n // chunk) * g * 4
    pv = layers * 2 * (m - 1) / m * (h * nblk * g * hd * 4)
    for r in ranks:
        for backend, slot_map in (("torch", 0),
                                  ("cuda", layers * (m - 1) * 4 * n)):
            ar, ag, rs = r[f"{arch}/{backend}/wire"]
            assert _close(ag, want["all_gather"] - partials + codes
                          + slot_map), backend
            assert _close(ar, want["all_reduce"] - pv) and rs == 0, backend


@pytest.mark.parametrize("arch", util.ATTN_SPLIT_ARCHS)
def test_a_decode_step_on_meta_sends_the_staged_exchanges(arch):
    """The dry run's decode step (meta tensors, the ``torch`` backend's
    plain stages) on rank 0 of (data 1, model 4): the card's bytes."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    cfg = smoke_config(arch).replace(quant=util.attn_split_quant("torch"))
    m, b, span = util.ATTN_SPLIT_MESH[1], util.PART_BATCH, \
        util.ATTN_SPLIT_MAX_LEN
    with dryrun.fake_group(m):
        mesh = make_test_mesh(util.ATTN_SPLIT_MESH, ("data", "model"),
                              device_type="cpu")
        layout = partition.Layout.of(mesh, ("data",))
        params = partition.build_params(cfg, seed=0, layout=layout,
                                        device="meta")
        cache = partition.init_cache(cfg, b, span, layout, device="meta")
        token = torch.zeros((b, 1), dtype=torch.int32, device="meta")
        col.reset_wire()
        dispatch.reset_stats()
        with use_rules(Rules(batch=("data",), mesh=mesh, partitioned=True)),\
                torch.no_grad():
            lm.decode_step(params, token, cache, cfg)
        wire = dict(col.WIRE)
    assert dispatch.STATS["attention_decode_torch"] == cfg.n_layers
    want = decode_wire_analytic(cfg, m, b, span)
    assert _close(wire["all_gather"], want["all_gather"])
    assert _close(wire["all_reduce"], want["all_reduce"])
    assert not wire.get("reduce_scatter")


def test_a_jax_prefill_cache_decodes_in_slot_shards(runs):
    ranks, one = runs
    logits, fed = one["fromjax"]
    for r in ranks:
        np.testing.assert_array_equal(r["fromjax/logits"], logits.numpy())
        np.testing.assert_array_equal(r["fromjax/fed"], fed.numpy())


def test_a_fake_mode_train_step_is_one_rank_s(runs):
    ranks, one = runs
    cfg = util.attn_split_train_config()
    loss, grads = one["train"]
    norm = lambda t: float(torch.sqrt(sum(
        (x.double() ** 2).sum() for x in tree_lib.leaves(t))))
    got = util.gathered(ranks, util.ATTN_SPLIT_MESH, "train/grads", cfg)
    for r in ranks:
        assert abs(float(r["train/loss"]) - float(loss)) <= \
            STEP_LOSS_RTOL * abs(float(loss))
    assert abs(norm(got) - norm(grads)) <= STEP_GNORM_RTOL * norm(grads)
    # every attention gradient at the rank's shard of its leaf
    layouts = util.train_layouts(ranks, util.ATTN_SPLIT_MESH)
    whole = partition.build_params(cfg, seed=0, device="meta")
    for layout, r in zip(layouts, ranks):
        specs = partition.local_param_specs(whole, cfg, layout)
        for (keys, leaf), spec in zip(tree_lib.leaves_with_keys(whole),
                                      tree_lib.leaves(specs)):
            if "attn" not in keys:
                continue
            shape = list(leaf.shape)
            for dim, _, size in partition._region(spec, shape, layout):
                shape[dim] = size
            g = r["train/grads/" + "/".join(keys)]
            assert list(g.shape) == shape and np.isfinite(g).all(), keys
            if keys[-2] in ("wk", "wv") and keys[-1] == "w":
                assert shape[-1] < cfg.hd          # inside a head
