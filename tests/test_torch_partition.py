"""Partitioned ring serving of the decoder LMs (``distributed/partition.py``):
each rank holds only its shard of the weights and of the ring caches.

Without a process group, on JAX-made integerized SMOKE trees (int8 and
nibble-packed int4 weights), for every rank of (model 2), (model 4) and
(data 2, model 2):

- ``partition_params`` / ``gather_params`` round-trip bit for bit, and
  every local shape is the reference's shard shape (JAX's ``param_specs``,
  ``filter_mesh_axes`` and ``enforce_divisible``), attention included:
  where kv_heads % m != 0 (the kv-2 SMOKE configs at model 4) it splits
  by column, JAX's wk shard cutting inside a head;
- ``build_params`` builds the same values one layer at a time: its
  unpartitioned tree is the whole of its partitioned ones;
- a partitioned tree without partitioned rules raises;
- ``qmatmul_acc`` on CPU tensors is its plain version (the exact int32
  sums, nibbles unpacked) and launches nothing, and the epilogue on its
  sums is ``qmatmul``'s output.

Over gloo, four ranks (``tests/_torch_dist_util.py partition``, a
``file://`` store, every join under a timeout) serve the SMOKE configs of
Qwen2.5 (kv 2: by head at model 2, by column at model 4), Yi, Llama-4-Scout
(top-1 plus a shared expert) and Phi-3.5-MoE (top-2) at kv 8 and 4 on the
(data, model) meshes (1, 4), (2, 2) and (4, 1), on the ``cuda`` backend
(the kernels' plain versions on the CPU) and, on (2, 2), the ``torch``
backend and bf16 (Qwen2.5 and Llama-4-Scout, their trees from
``build_params`` on each rank; bf16 moves as bytes and is widened where
it is reduced): ``prefill`` of 4 x 32 tokens and 4 free-running greedy
ring steps, while this process runs the same on one rank and JAX's
unsharded ``prefill`` / ``decode_step``.  Held:

- every rank's logits at every step, the fed tokens and the gathered ring
  caches (codes, scales, ``pos``) bitwise equal to the one-rank run; each
  rank's cache shard by row and by KV head (by slot where attention splits
  by column); every row-parallel product
  through the int32 accumulator path and no dispatch on the other
  backend;
- the one-rank greedy tokens equal to JAX's up to the first step where
  they part, and there only at a near tie that the two packages' logits'
  own gap explains (XLA contracts FMAs where the port rounds twice, so an
  activation code, and under MoE a route, can flip at a rounding edge:
  ``tests/test_torch_lm.py``), the logits within FLIP_TOL of their max up
  to that step;
- 4 greedy steps from JAX's prefill cache, carried into each rank's shard
  by ``interop.to_torch_shard``, bitwise equal to one rank's steps from
  the whole cache;
- the refusals that remain (a global tree under partitioned rules, the
  paged engine, training in int mode; ``int_bf16_reduce`` and
  ``moe_a2a`` run partitioned: ``tests/test_torch_partition_shard_bodies.py``),
  and no ``_row_codes`` copy of a row-parallel weight on any local tree;
- the local trees equal to ``distribute_tensor(...).to_local()`` on every
  leaf.
"""
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_util as util  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core.api import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.api import integerize_params as j_integerize  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.core.api import QuantConfig  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import qmatmul as qm  # noqa: E402
from repro_torch.models import lm  # noqa: E402

torch.set_num_threads(1)

JOIN_S = 240
FLIP_TOL = 0.1
SHAPE_ARCHS = util.PART_ARCHS + ("chatglm3-6b",)
SIZES = [{"model": 2}, {"model": 4}, {"data": 2, "model": 2}]


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


_FLOAT, _INT = {}, {}


def _jax_tree(arch, weights):
    """JAX's integerized SMOKE tree (numpy leaves)."""
    if arch not in _FLOAT:
        cfg = jreg.smoke_config(arch)
        _FLOAT[arch] = jax.jit(lambda k: jlm.init_params(k, cfg))(
            jax.random.PRNGKey(0))
    if (arch, weights) not in _INT:
        qc = JQuantConfig(**util.part_quant(weights, 8))
        _INT[arch, weights] = jax.tree.map(
            np.asarray, j_integerize(_FLOAT[arch], qc))
    return _INT[arch, weights]


def _cfg(arch, weights, kv_bits=8, backend=None, dtype="float32"):
    return smoke_config(arch).replace(dtype=dtype, quant=QuantConfig(
        **util.part_quant(weights, kv_bits), backend=backend))


def _layouts(sizes):
    names = list(sizes)
    for coords in itertools.product(*(range(n) for n in sizes.values())):
        yield partition.Layout.make(sizes, dict(zip(names, coords)),
                                    ("data",))


class _JMesh:
    """The two attributes JAX's spec helpers read of a mesh."""

    def __init__(self, sizes):
        self.shape, self.axis_names = dict(sizes), tuple(sizes)


def _jax_specs(jtree, sizes):
    jm = _JMesh(sizes)
    specs = jsharding.filter_mesh_axes(jsharding.param_specs(jtree), jm)
    specs = jsharding.enforce_divisible(specs, jtree, jm)

    def walk(s, keys=()):
        if isinstance(s, dict):
            for k in sorted(s):
                yield from walk(s[k], keys + (k,))
        else:
            yield keys, s
    return dict(walk(specs))


def _shard_shape(shape, spec, sizes):
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[dim] //= sizes[a]
    return tuple(out)


def _equal_trees(a, b):
    la, lb = tree_lib.leaves_with_keys(a), tree_lib.leaves_with_keys(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("sizes", SIZES,
                         ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("weights", list(util.PART_WEIGHTS))
@pytest.mark.parametrize("arch", SHAPE_ARCHS)
def test_partition_round_trip_and_shard_shapes(arch, weights, sizes):
    jtree = _jax_tree(arch, weights)
    tree = interop.to_torch(jtree, "cpu")
    cfg = _cfg(arch, weights)
    jspecs = _jax_specs(jtree, sizes)
    heads = partition.split_plan(cfg, sizes["model"])["heads"]
    parts, inside = [], 0
    for layout in _layouts(sizes):
        loc = partition.partition_params(tree, cfg, layout)
        for (keys, leaf), (_, g) in zip(tree_lib.leaves_with_keys(loc),
                                        tree_lib.leaves_with_keys(tree)):
            want = _shard_shape(g.shape, jspecs[keys], sizes)
            assert tuple(leaf.shape) == want, (keys, jspecs[keys])
            inside += keys[-2] == "wk" and keys[-1] == "w_q" and \
                want[-2] % cfg.hd > 0
        parts.append((layout, loc))
    # kv 2 (Qwen2.5, Yi, ChatGLM3 SMOKE) splits attention by column at
    # model 4, a rank's wk rows cutting inside a head, as JAX's shards do
    assert bool(inside) == (heads == "columns") == \
        (cfg.kv_heads % sizes["model"] > 0)
    _equal_trees(partition.gather_params(parts, cfg), tree)


def test_head_rule_keeps_chatglm3_attention_whole_at_model_4():
    """The layout that replaced the whole-attention rule at model 4
    (ChatGLM3's kv 2): attention by column.  JAX's wk shard is half a head
    (32 columns over 4 ranks, head_dim 16), and so is rank 3's: wq, wk,
    wv and their biases by output rows, wo by K, each the rank's block of
    the whole tree's; the ring by slot, a quarter of the slots and every
    KV head (whole, marked, where 4 does not divide its slots)."""
    jtree = _jax_tree("chatglm3-6b", "w8")
    cfg = _cfg("chatglm3-6b", "w8")
    sizes = {"model": 4}
    spec = _jax_specs(jtree, sizes)[("units", "b0", "attn", "wk", "w_q")]
    wk = jtree["units"]["b0"]["attn"]["wk"]["w_q"]
    assert _shard_shape(wk.shape, spec, sizes)[1] < cfg.hd
    assert partition.split_plan(cfg, 4)["heads"] == "columns"
    assert partition.split_plan(cfg, 2)["heads"] == "heads"
    tree = interop.to_torch(jtree, "cpu")
    layout = partition.Layout.make(sizes, {"model": 3})
    loc = partition.partition_params(tree, cfg, layout)
    attn, whole = loc["units"]["b0"]["attn"], tree["units"]["b0"]["attn"]
    q, kv = cfg.n_heads * cfg.hd, cfg.kv_heads * cfg.hd
    assert partition.out_features(attn["wk"]) == kv // 4 < cfg.hd
    assert partition.out_features(attn["wq"]) == q // 4
    assert torch.equal(attn["wk"]["w_q"], whole["wk"]["w_q"][:, 3 * kv // 4:])
    assert torch.equal(attn["wv"]["b"], whole["wv"]["b"][:, 3 * kv // 4:])
    assert torch.equal(attn["wo"]["w_q"],
                       whole["wo"]["w_q"][..., 3 * q // 4:])
    assert partition.local_kv_heads(cfg, 4) == cfg.kv_heads
    assert partition.out_features(loc["units"]["b0"]["ffn"]["up"]) == \
        cfg.d_ff // 4
    cache = partition.init_cache(cfg, 4, 40, layout, device="cpu")
    assert tuple(cache["units"]["b0"]["k"].shape) == \
        (cfg.n_layers, 4, cfg.kv_heads, 10, cfg.hd)
    # 42 slots do not split over 4: the ring stays whole, marked
    odd = partition.init_cache(cfg, 4, 42, layout, device="cpu")
    assert odd["units"]["b0"]["k"].shape[3] == 42
    assert partition.RING_WHOLE in odd["units"]["b0"]
    assert partition.RING_WHOLE not in cache["units"]["b0"]


@pytest.mark.parametrize("sizes", SIZES[1:],
                         ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("weights", list(util.PART_WEIGHTS))
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "llama4-scout-17b-a16e"])
def test_builder_builds_the_partitioned_tree(arch, weights, sizes):
    cfg = _cfg(arch, weights)
    whole = partition.build_params(cfg, seed=3, device="cpu")
    assert partition.tree_dims(whole, cfg) == \
        partition.expected_dims(cfg, 1)
    parts = []
    for layout in _layouts(sizes):
        loc = partition.build_params(cfg, seed=3, layout=layout,
                                     device="cpu")
        _equal_trees(loc, partition.partition_params(whole, cfg, layout))
        metas = partition.global_shapes(loc, cfg, layout)
        assert [tuple(t.shape) for t in tree_lib.leaves(metas)] == \
            [tuple(t.shape) for t in tree_lib.leaves(whole)]
        parts.append((layout, loc))
    _equal_trees(partition.gather_params(parts, cfg), whole)


def test_a_partitioned_tree_without_partitioned_rules_raises():
    cfg = _cfg("qwen2.5-32b", "w8")
    loc = partition.partition_params(
        interop.to_torch(_jax_tree("qwen2.5-32b", "w8"), "cpu"), cfg,
        partition.Layout.make({"model": 2}))
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="not a global tree"):
        lm.prefill(loc, {"tokens": toks}, cfg, 16)


@pytest.mark.parametrize("packed", [False, True])
def test_qmatmul_acc_on_the_cpu_is_its_plain_version(packed):
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-128, 128, (9, 64), generator=g, dtype=torch.int8)
    w = torch.randint(-8, 8, (48, 64), generator=g, dtype=torch.int8)
    wq = quant.pack_int4(w) if packed else w
    s, b = torch.rand(48, generator=g), torch.randn(48, generator=g)
    rs = torch.rand(9, generator=g)
    before = dict(qm.LAUNCHES)
    acc = qm.qmatmul_acc(x, wq, packed=packed)
    assert qm.LAUNCHES == before
    assert acc.dtype == torch.int32
    assert torch.equal(acc, quant.int_matmul_exact(x, w.T))
    assert torch.equal(ref.qmatmul_epilogue(acc, s, b, rs),
                       qm.qmatmul(x, wq, s, b, rs, packed=packed))


# ---------------------------------------------------------------------------
# Four gloo ranks against one rank and JAX
# ---------------------------------------------------------------------------

_JAX_PREFILL = {}


def _jax_prefill(arch, weights, kv_bits, tokens):
    """JAX's unsharded ring prefill (XLA path), once a config: (params,
    the decode step, logits, cache)."""
    key = (arch, weights, kv_bits)
    if key not in _JAX_PREFILL:
        jcfg = jreg.smoke_config(arch).replace(quant=JQuantConfig(
            **util.part_quant(weights, kv_bits)))
        jp = jax.tree.map(jnp.asarray, _jax_tree(arch, weights))
        prefill = jax.jit(lambda p, b: jlm.prefill(
            p, b, jcfg, max_len=util.PART_MAX_LEN))
        decode = jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, jcfg))
        with jdispatch.use_backend("xla"):
            logits, cache = prefill(jp, {"tokens": jnp.asarray(tokens)})
        _JAX_PREFILL[key] = (jp, decode, logits, cache)
    return _JAX_PREFILL[key]


def _jax_greedy(arch, weights, kv_bits, tokens):
    """JAX's unsharded ring prefill and free-running greedy steps (XLA
    path): (logits (steps + 1, B, 1, V), fed tokens (steps, B, 1))."""
    jp, decode, logits, cache = _jax_prefill(arch, weights, kv_bits, tokens)
    with jdispatch.use_backend("xla"):
        out, fed = [logits], []
        for _ in range(util.PART_STEPS):
            fed.append(jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
                       [:, None])
            logits, cache = decode(jp, fed[-1], cache)
            out.append(logits)
    return (np.stack([np.asarray(t) for t in out]),
            np.stack([np.asarray(t) for t in fed]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs; the one-rank runs; JAX's greedy tokens."""
    d = tmp_path_factory.mktemp("partition")
    ref = d / "ref.npz"
    tokens = np.random.RandomState(7).randint(
        0, 512, (util.PART_BATCH, util.PART_PROMPT)).astype(np.int32)
    arrays = {"tokens": tokens}
    from_jax = {}
    for arch in util.PART_ARCHS:
        for w in util.PART_WEIGHTS:
            arrays.update(util.flat(_jax_tree(arch, w),
                                    f"{arch}/{w}/params/"))
        for w, kv in util.PART_FROM_JAX:
            _, _, logits, cache = _jax_prefill(arch, w, kv, tokens)
            tag = f"{arch}/{w}/kv{kv}"
            from_jax[tag] = (jax.tree.map(np.asarray, cache), np.asarray(
                jnp.argmax(logits[:, -1], -1), np.int32)[:, None])
            arrays.update(util.flat(from_jax[tag][0], f"jaxcache/{tag}/"))
            arrays[f"jaxtok/{tag}"] = from_jax[tag][1]
    util.save(ref, arrays)
    procs = util.launch("partition", 4, d, ref)
    one, jax_runs = {}, {}
    try:
        toks = torch.from_numpy(tokens)
        for tag, (cache, tok) in from_jax.items():
            arch, w, kv = tag.split("/")
            one[tag] = util.greedy_from(
                interop.to_torch(_jax_tree(arch, w), "cpu"),
                interop.to_torch(cache, "cpu"), torch.from_numpy(tok),
                _cfg(arch, w, int(kv[2:])))
        runs_of = {(a, w, kv, b, dt) for a, w, kv, _, b, dt in
                   util.part_cases()} | {
            (a, w, kv, b, "float32") for a in util.PART_ARCHS
            for w in util.PART_WEIGHTS for kv in util.PART_KV
            for b in ("cuda", "torch")}
        for arch, w, kv, backend, dtype in sorted(runs_of):
            cfg = _cfg(arch, w, kv, backend, dtype)
            tree = interop.to_torch(_jax_tree(arch, w), "cpu") \
                if dtype == "float32" else partition.build_params(
                    cfg, seed=0, device="cpu")
            one[arch, w, kv, backend, dtype] = util.greedy(tree, toks, cfg)
        for arch in util.PART_ARCHS:
            for w in util.PART_WEIGHTS:
                for kv in util.PART_KV:
                    jax_runs[arch, w, kv] = _jax_greedy(arch, w, kv, tokens)
    finally:
        ranks = util.join(procs, d, "partition", JOIN_S)
    return ranks, one, jax_runs


def _case_id(case):
    return util.part_key(case).replace("/", "-")


def _row_products(cfg):
    """Row-parallel products a forward: wo, and down (a dense FFN's or the
    shared expert's)."""
    moe = cfg.moe
    return cfg.n_layers * (1 + int(moe is None or moe.shared_expert))


@pytest.mark.parametrize("case", util.part_cases(), ids=_case_id)
def test_partitioned_ring_is_bitwise_the_one_rank_run(runs, case):
    arch, w, kv, mesh, backend, dtype = case
    ranks, one, _ = runs
    cfg = _cfg(arch, w, kv, backend, dtype)
    logits, fed, cache = one[arch, w, kv, backend, dtype]
    key = util.part_key(case)
    sizes = {"data": mesh[0], "model": mesh[1]}
    parts = []
    for r in ranks:
        np.testing.assert_array_equal(r[f"{key}/logits"],
                                      logits.float().numpy())
        np.testing.assert_array_equal(r[f"{key}/fed"], fed.numpy())
        di, mi = r[f"layout/{util.mesh_tag(mesh)}"]
        layout = partition.Layout.make(sizes, {"data": int(di),
                                               "model": int(mi)}, ("data",))
        local = {k: torch.from_numpy(v) for k, v in r.items()
                 if k.startswith(f"{key}/cache/")}
        parts.append((layout, util.unflat(local, f"{key}/cache")))
        k0 = parts[-1][1]["units"]["b0"]["k"]
        assert k0.shape[1] == util.PART_BATCH // mesh[0]
        assert k0.shape[2] == partition.local_kv_heads(cfg, mesh[1])
        cols = partition.split_plan(cfg, mesh[1])["heads"] == "columns"
        assert k0.shape[3] == util.PART_MAX_LEN // (mesh[1] if cols else 1)
        # every row-parallel product on the int32 path; nothing on the
        # other backend
        assert r[f"{key}/acc"] == _row_products(cfg) * (1 + util.PART_STEPS)
        assert r[f"{key}/other"] == 0
        assert (r[f"{key}/expert"] > 0) == (cfg.moe is not None)
    _equal_trees(partition.gather_cache(parts, cfg), cache)


@pytest.mark.parametrize("kv", util.PART_KV)
@pytest.mark.parametrize("weights", list(util.PART_WEIGHTS))
@pytest.mark.parametrize("arch", util.PART_ARCHS)
def test_one_rank_greedy_tokens_equal_jax(runs, arch, weights, kv):
    _, one, jax_runs = runs
    want_logits, want_fed = jax_runs[arch, weights, kv]
    for backend in ("cuda", "torch"):
        logits, fed = (t.numpy() for t in one[arch, weights, kv, backend,
                                               "float32"][:2])
        apart = np.nonzero((fed != want_fed).any(axis=(1, 2)))[0]
        last = apart[0] if len(apart) else util.PART_STEPS
        # identical tokens so far: the logits of step `last` come from the
        # same inputs in both packages
        for s in range(last + 1):
            got, want = logits[s, :, -1], want_logits[s, :, -1]
            assert np.abs(got - want).max() <= \
                FLIP_TOL * np.abs(want).max(), (backend, s)
        if len(apart):
            got, want = logits[last, :, -1], want_logits[last, :, -1]
            for r in np.nonzero(fed[last, :, 0] != want_fed[last, :, 0])[0]:
                # two logits each within e of JAX's swap order only if
                # they are within 2e of each other
                gap = got[r].max() - got[r, want_fed[last, r, 0]]
                assert gap <= 2 * np.abs(got[r] - want[r]).max(), \
                    (backend, last, r, gap)


@pytest.mark.parametrize("mesh", util.PART_MESHES, ids=util.mesh_tag)
@pytest.mark.parametrize("weights,kv", util.PART_FROM_JAX)
@pytest.mark.parametrize("arch", util.PART_ARCHS)
def test_partitioned_decode_from_a_jax_cache(runs, arch, weights, kv,
                                             mesh):
    """JAX's prefill cache, carried into each rank's shard by
    ``interop.to_torch_shard``, decodes as the whole cache does on one
    rank, bit for bit."""
    ranks, one, _ = runs
    logits, fed = one[f"{arch}/{weights}/kv{kv}"]
    key = f"fromjax/{arch}/{weights}/kv{kv}/{util.mesh_tag(mesh)}"
    for r in ranks:
        np.testing.assert_array_equal(r[f"{key}/logits"], logits.numpy())
        np.testing.assert_array_equal(r[f"{key}/fed"], fed.numpy())


def test_partitioned_rules_refuse_what_they_do_not_run(runs):
    for r in runs[0]:
        refused = {k: bool(v) for k, v in r.items()
                   if k.startswith("refused/")}
        assert len(refused) == 3 and all(refused.values()), refused


def test_partitioned_runs_leave_no_row_codes_copy(runs):
    """The row-parallel shard body takes a rank's K slice as it holds it:
    ``dispatch.row_codes`` copies only for the body on global tensors."""
    for r in runs[0]:
        assert r["row_memos"] == 0


@pytest.mark.parametrize("mesh", util.PART_MESHES, ids=util.mesh_tag)
@pytest.mark.parametrize("arch", util.PART_ARCHS)
def test_local_trees_are_dtensor_shards(runs, arch, mesh):
    for r in runs[0]:
        same, checked, total = r[f"dtensor/{arch}/{util.mesh_tag(mesh)}"]
        # every leaf, attention's where it splits by column too
        assert same == checked == total
