"""Partitioned ring serving of the recurrent and encoder-decoder families
(``distributed/partition.py``): RecurrentGemma-9B (the RG-LRU split by
d_rnn, its one-KV-head local attention whole), Mamba2-130M (the SSD mixer
whole on every rank) and Whisper-large-v3 (attention and caches split by
head), each rank holding only its shard of the weights, the rings and the
recurrent states.

Without a process group, on JAX-made integerized SMOKE trees (int8 and
nibble-packed int4 weights), for every rank of (model 2), (model 4) and
(data 2, model 2):

- ``partition_params`` / ``gather_params`` round-trip bit for bit, and
  every local shape is the reference's shard shape (JAX's
  ``param_specs``, ``filter_mesh_axes`` and ``enforce_divisible``),
  except RecurrentGemma's attention, which the head rule keeps whole (one
  KV head: JAX's wk shard cuts inside it);
- the SSD mixer is whole on every rank;
- ``build_params``' pieces, one layer at a time, assemble into its whole
  tree;
- a partitioned Whisper tree without partitioned rules raises;
- a decode step's float RG-LRU gate (``rglru.gate_step``) is the same
  bits for any slice of rows and columns, within f32 rounding of the
  matmul, and so across its blocks of rows and columns.

Over gloo, four ranks (``tests/_torch_dist_util.py families``, a
``file://`` store, every join under a timeout) serve the three SMOKE
configs at kv 8 and 4 on the (data, model) meshes (1, 4), (2, 2) and
(4, 1): ``prefill`` of 4 x 32 tokens (Whisper: and 16 stub frames a
row; RecurrentGemma's prompts fill its 32-slot local ring, past its
16-token window) and 4 free-running greedy ring steps, while this process
runs the same on one rank and JAX's unsharded ``prefill`` /
``decode_step``.  Held:

- every rank's logits at every step, the fed tokens and the gathered
  caches (codes, scales, ``pos``, and the states ``h``, ``conv``,
  ``convs``) bitwise equal to the one-rank run; every row-parallel
  product (RG-LRU ``w_out``, attention ``wo``, ``down``) through the
  int32 accumulator path and no dispatch on the other backend;
- the one-rank greedy tokens equal to JAX's up to the first step where
  they part, and there only at a near tie that the two packages' logits'
  own gap explains (``tests/test_torch_partition.py``'s rule);
- 4 greedy steps from JAX's prefill cache, carried into each rank's shard
  by ``interop.to_torch_shard``, bitwise equal to one rank's steps from
  the whole cache.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_util as util  # noqa: E402
from test_torch_partition import (_equal_trees, _jax_specs,  # noqa: E402
                                  _layouts, _shard_shape)

from repro.configs import registry as jreg  # noqa: E402
from repro.core.api import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.api import integerize_params as j_integerize  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.core.api import QuantConfig  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.layers.rglru import (GATE_COLS, GATE_ROWS,  # noqa: E402
                                      gate_step)
from repro_torch.models import encdec  # noqa: E402

torch.set_num_threads(1)

JOIN_S = 240
FLIP_TOL = 0.1
WHISPER = "whisper-large-v3"
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


def _jmodel(arch):
    return jed if arch == WHISPER else jlm


_FLOAT, _INT = {}, {}


def _jax_tree(arch, weights):
    """JAX's integerized SMOKE tree (numpy leaves)."""
    if arch not in _FLOAT:
        cfg = jreg.smoke_config(arch)
        _FLOAT[arch] = jax.jit(lambda k: _jmodel(arch).init_params(k, cfg))(
            jax.random.PRNGKey(0))
    if (arch, weights) not in _INT:
        qc = JQuantConfig(**util.part_quant(weights, 8))
        _INT[arch, weights] = jax.tree.map(
            np.asarray, j_integerize(_FLOAT[arch], qc))
    return _INT[arch, weights]


def _cfg(arch, weights, kv_bits=8):
    return smoke_config(arch).replace(quant=QuantConfig(
        **util.part_quant(weights, kv_bits), backend="cuda"))


def _arrays():
    """The prompts and Whisper's stub frames (numpy, from a seed)."""
    rng = np.random.RandomState(7)
    cfg = smoke_config(WHISPER)
    return {"tokens": rng.randint(0, cfg.vocab, (
        util.PART_BATCH, util.PART_PROMPT)).astype(np.int32),
        "frames": rng.randn(util.PART_BATCH, cfg.n_audio_ctx,
                            cfg.d_model).astype(np.float32)}


@pytest.mark.parametrize("sizes", SIZES,
                         ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("weights", list(util.PART_WEIGHTS))
@pytest.mark.parametrize("arch", util.FAM_ARCHS)
def test_family_round_trip_and_shard_shapes(arch, weights, sizes):
    jtree = _jax_tree(arch, weights)
    tree = interop.to_torch(jtree, "cpu")
    cfg = _cfg(arch, weights)
    jspecs = _jax_specs(jtree, sizes)
    heads = partition.split_plan(cfg, sizes["model"])["heads"]
    parts = []
    for layout in _layouts(sizes):
        loc = partition.partition_params(tree, cfg, layout)
        for (keys, leaf), (_, g) in zip(tree_lib.leaves_with_keys(loc),
                                        tree_lib.leaves_with_keys(tree)):
            want = _shard_shape(g.shape, jspecs[keys], sizes)
            assert tuple(leaf.shape) == want, (keys, jspecs[keys])
        parts.append((layout, loc))
    # RecurrentGemma's one KV head splits by column (a rank's wk rows cut
    # inside it, as JAX's shard does); Whisper's 4 heads by head at 2 and
    # 4; Mamba has no attention
    assert heads == {"recurrentgemma-9b": "columns",
                     WHISPER: "heads"}.get(arch, False)
    _equal_trees(partition.gather_params(parts, cfg), tree)


@pytest.mark.parametrize("sizes", SIZES,
                         ids=lambda s: "x".join(map(str, s.values())))
def test_ssd_mixer_is_whole_on_every_rank(sizes):
    cfg = _cfg("mamba2-130m", "w4p")
    tree = interop.to_torch(_jax_tree("mamba2-130m", "w4p"), "cpu")
    mixer = tree["units"]["b0"]["ssd"]
    assert set(mixer) == {"in_proj", "out_proj", "conv_w", "dt_bias",
                          "A_log", "D", "norm_gamma"}
    for layout in _layouts(sizes):
        loc = partition.partition_params(tree, cfg, layout)
        _equal_trees(loc["units"]["b0"]["ssd"], mixer)
        # the vocabulary splits all the same
        assert partition.out_features(loc["lm_head"]) == \
            cfg.vocab // sizes["model"]


@pytest.mark.parametrize("sizes", SIZES,
                         ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("weights", list(util.PART_WEIGHTS))
@pytest.mark.parametrize("arch", util.FAM_ARCHS)
def test_build_params_assembles_the_partitioned_family_tree(arch, weights, sizes):
    cfg = _cfg(arch, weights)
    whole = partition.build_params(cfg, seed=3, device="cpu")
    partition.check_tree(whole, cfg)
    assert [tuple(t.shape) for t in tree_lib.leaves(whole)] == \
        [tuple(t.shape) for t in tree_lib.leaves(
            interop.to_torch(_jax_tree(arch, weights), "cpu"))]
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


def test_a_partitioned_whisper_tree_without_partitioned_rules_raises():
    cfg = _cfg(WHISPER, "w8")
    loc = partition.partition_params(
        interop.to_torch(_jax_tree(WHISPER, "w8"), "cpu"), cfg,
        partition.Layout.make({"model": 2}))
    batch = util.fam_batch(_arrays(), WHISPER)
    with pytest.raises(ValueError, match="not a global tree"):
        encdec.prefill(loc, batch, cfg, util.PART_MAX_LEN)


def _gate_slices_hold(x, w, dtype):
    b, n = x.shape[0], w.shape[-1]
    y = gate_step(x, w)
    assert y.dtype == dtype and y.shape == (b, 1, n)
    # f32 sums of the same products in another order
    want = x.double() @ w.double()
    assert (y.double() - want).abs().max() <= \
        (1e-6 if dtype == torch.float32 else 2 ** -7) * want.abs().max()
    for rows in (slice(0, b // 2), slice(b // 2, b), slice(1, 2)):
        for cols in (slice(0, n // 4), slice(n // 4, 3 * n // 4),
                     slice(3 * n // 4, n)):
            assert torch.equal(gate_step(x[rows], w[:, cols].contiguous()),
                               y[rows][..., cols])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_step_is_the_same_bits_for_any_slice(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 1, 100), generator=g).to(dtype)
    w = (torch.randn((100, 48), generator=g) * 0.1).to(dtype)
    _gate_slices_hold(x, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_step_is_the_same_bits_across_its_blocks(dtype):
    # more rows than one block of GATE_ROWS, more columns than GATE_COLS
    g = torch.Generator().manual_seed(1)
    x = torch.randn((GATE_ROWS + 4, 1, 64), generator=g).to(dtype)
    w = (torch.randn((64, GATE_COLS + 76), generator=g) * 0.1).to(dtype)
    _gate_slices_hold(x, w, dtype)


# ---------------------------------------------------------------------------
# Four gloo ranks against one rank and JAX
# ---------------------------------------------------------------------------

def _jax_fns(arch, weights, kv_bits):
    jcfg = jreg.smoke_config(arch).replace(quant=JQuantConfig(
        **util.part_quant(weights, kv_bits)))
    model = _jmodel(arch)
    prefill = jax.jit(lambda p, b: model.prefill(
        p, b, jcfg, max_len=util.PART_MAX_LEN))
    decode = jax.jit(lambda p, t, c: model.decode_step(p, t, c, jcfg))
    return prefill, decode


def _jax_greedy(arch, weights, kv_bits, arrays):
    """JAX's unsharded ring prefill and free-running greedy steps (XLA
    path): (logits (steps + 1, B, 1, V), fed tokens (steps, B, 1), the
    prefill cache)."""
    prefill, decode = _jax_fns(arch, weights, kv_bits)
    jp = jax.tree.map(jnp.asarray, _jax_tree(arch, weights))
    batch = {"tokens": jnp.asarray(arrays["tokens"])}
    if arch == WHISPER:
        batch["frames"] = jnp.asarray(arrays["frames"])
    with jdispatch.use_backend("xla"):
        logits, cache = prefill(jp, batch)
        first = jax.tree.map(np.asarray, cache)
        out, fed = [logits], []
        for _ in range(util.PART_STEPS):
            fed.append(jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
                       [:, None])
            logits, cache = decode(jp, fed[-1], cache)
            out.append(logits)
    return (np.stack([np.asarray(t) for t in out]),
            np.stack([np.asarray(t) for t in fed]), first)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs; the one-rank runs; JAX's greedy runs."""
    d = tmp_path_factory.mktemp("families")
    ref = d / "ref.npz"
    arrays = _arrays()
    saved = dict(arrays)
    jax_runs = {}
    for arch in util.FAM_ARCHS:
        for w in util.PART_WEIGHTS:
            saved.update(util.flat(_jax_tree(arch, w),
                                   f"{arch}/{w}/params/"))
        for w, kv in util.PART_FROM_JAX:
            logits, fed, cache = _jax_greedy(arch, w, kv, arrays)
            jax_runs[arch, w, kv] = (logits, fed)
            tag = f"{arch}/{w}/kv{kv}"
            saved.update(util.flat(cache, f"jaxcache/{tag}/"))
            saved[f"jaxtok/{tag}"] = fed[0]
    util.save(ref, saved)
    procs = util.launch("families", 4, d, ref)
    one = {}
    try:
        for arch in util.FAM_ARCHS:
            batch = util.fam_batch(arrays, arch)
            for w in util.PART_WEIGHTS:
                tree = interop.to_torch(_jax_tree(arch, w), "cpu")
                for kv in util.PART_KV:
                    one[arch, w, kv] = util.greedy(tree, batch,
                                                   _cfg(arch, w, kv))
                for w_, kv in util.PART_FROM_JAX:
                    if w_ != w:
                        continue
                    tag = f"{arch}/{w}/kv{kv}"
                    one[tag] = util.greedy_from(
                        tree, interop.to_torch(util.unflat(
                            saved, f"jaxcache/{tag}"), "cpu"),
                        torch.from_numpy(saved[f"jaxtok/{tag}"]),
                        _cfg(arch, w, kv))
    finally:
        ranks = util.join(procs, d, "families", JOIN_S)
    return ranks, one, jax_runs


def _row_products(cfg):
    """Row-parallel products of a prefill, and of a decode step: the
    RG-LRU's w_out or attention's wo and every FFN's down; Whisper's
    encoder wo and down, and its decoder's self and cross wo and down;
    none in Mamba."""
    if cfg.name.startswith("whisper"):
        dec = 3 * cfg.n_dec_layers
        return 2 * cfg.n_enc_layers + dec, dec
    if cfg.ssd is not None:
        return 0, 0
    n = cfg.n_layers * (1 + int(cfg.d_ff > 0))
    return n, n


@pytest.mark.parametrize("case", util.fam_cases(),
                         ids=lambda c: util.fam_key(c).replace("/", "-"))
def test_partitioned_family_is_bitwise_the_one_rank_run(runs, case):
    arch, w, kv, mesh = case
    ranks, one, _ = runs
    cfg = _cfg(arch, w, kv)
    logits, fed, cache = one[arch, w, kv]
    key = util.fam_key(case)
    sizes = {"data": mesh[0], "model": mesh[1]}
    pre, step = _row_products(cfg)
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
        # every row-parallel product on the int32 path; nothing on the
        # other backend
        assert r[f"{key}/acc"] == pre + step * util.PART_STEPS
        assert r[f"{key}/other"] == 0
    got = partition.gather_cache(parts, cfg)
    _equal_trees(got, cache)
    # each rank held its rows, and its heads or d_rnn features
    loc = parts[0][1]
    rows = util.PART_BATCH // mesh[0]
    if arch == WHISPER:
        assert loc["layers"]["ek"].shape[1:3] == (rows, 4 // mesh[1])
    elif arch == "mamba2-130m":
        h = loc["units"]["b0"]["h"]               # (L, B, H, P, N)
        assert h.shape[1] == rows
        assert h.shape[2:] == cache["units"]["b0"]["h"].shape[2:]
    else:
        assert loc["units"]["b0"]["h"].shape == (2, rows,
                                                 cfg.d_rnn // mesh[1])
        assert loc["units"]["b2"]["k"].shape[2] == cfg.kv_heads


@pytest.mark.parametrize("weights,kv", util.PART_FROM_JAX)
@pytest.mark.parametrize("arch", util.FAM_ARCHS)
def test_one_rank_family_greedy_tokens_equal_jax(runs, arch, weights, kv):
    _, one, jax_runs = runs
    want_logits, want_fed = jax_runs[arch, weights, kv]
    logits, fed = (t.numpy() for t in one[arch, weights, kv][:2])
    apart = np.nonzero((fed != want_fed).any(axis=(1, 2)))[0]
    last = apart[0] if len(apart) else util.PART_STEPS
    # identical tokens so far: the logits of step `last` come from the
    # same inputs in both packages
    for s in range(last + 1):
        got, want = logits[s, :, -1], want_logits[s, :, -1]
        assert np.abs(got - want).max() <= \
            FLIP_TOL * np.abs(want).max(), s
    if len(apart):
        got, want = logits[last, :, -1], want_logits[last, :, -1]
        for r in np.nonzero(fed[last, :, 0] != want_fed[last, :, 0])[0]:
            # two logits each within e of JAX's swap order only if they
            # are within 2e of each other
            gap = got[r].max() - got[r, want_fed[last, r, 0]]
            assert gap <= 2 * np.abs(got[r] - want[r]).max(), (last, r, gap)


@pytest.mark.parametrize("mesh", util.PART_MESHES, ids=util.mesh_tag)
@pytest.mark.parametrize("weights,kv", util.PART_FROM_JAX)
@pytest.mark.parametrize("arch", util.FAM_ARCHS)
def test_partitioned_family_decode_from_a_jax_cache(runs, arch, weights, kv,
                                                    mesh):
    """JAX's prefill cache (rings, states, Whisper's cross K/V), carried
    into each rank's shard by ``interop.to_torch_shard``, decodes as the
    whole cache does on one rank, bit for bit."""
    ranks, one, _ = runs
    logits, fed = one[f"{arch}/{weights}/kv{kv}"]
    key = f"fromjax/{arch}/{weights}/kv{kv}/{util.mesh_tag(mesh)}"
    for r in ranks:
        np.testing.assert_array_equal(r[f"{key}/logits"], logits.numpy())
        np.testing.assert_array_equal(r[f"{key}/fed"], fed.numpy())
