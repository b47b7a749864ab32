"""The production-mesh dry run (``repro_torch/launch/dryrun.py``): one
rank's step on meta tensors under torch's fake process group.

Held:

- (i) rank 0's tree at production shapes against the reference's
  shardings: one JAX subprocess (``tests/_torch_dist_util.py jaxdryrun``,
  ``repro/launch/dryrun.py`` imported first: 512 host devices) sums each
  argument leaf's ``NamedSharding.shard_shape`` of four cells, nothing
  compiled; every leaf of the port's meta rank tree holds those bytes,
  except the documented departures, each asserted leaf by leaf: attention
  kept whole on the rank where its KV heads do not divide "model" (every
  model of these cells at m = 16), the ring split by KV head and not by
  sequence (so whole where the heads are), and the global batch on every
  rank; then each departure's bytes, and Qwen2.5-32B's rank at 9.6x the
  reference's device;
- (ii) meta under the fake group against real CPU tensors under gloo
  (four ranks, ``_torch_dist_util.py rank dryrun``): a train, a decode
  and an "opt" prefill cell at SMOKE size on (2, 2) and (1, 4), each rank
  counting the same FLOPs, argument bytes, bytes sent and collective
  result bytes by kind, and dispatch counts; a cell's arguments on meta
  and on the CPU leaf for leaf; the step's own FLOP count
  against ``FlopCounterMode``, its op-by-op peak against torch's
  ``MemTracker``, the meta results it reuses against torch's meta
  functions;
- (iii) an analytic count: a dense decode and prefill cell's FLOPs equal
  the sum of 2·M·N·K over the products the plain path runs, and the SSD
  decode step's readout is added;
- (iv) the variants: an ``sp`` cell runs "ok" with the baseline cell's
  arguments (``sp`` moves activations only), and where nothing splits
  (Whisper, whose stacks take no ``seq_tp``; a decode step, S = 1) counts
  all that the baseline counts; where the residual splits, a train cell's
  temp falls and its row-parallel sums are reduce-scattered; an
  unsupported cell is skipped with ``cell_supported``'s reason, and each
  other variant changes what it should;
- (v) ``launch/analysis.py``'s roofline terms on a hand-worked case;

and the fault the dry run found: a bf16 gather of one row along its last
dim (a rank's one row of logits, ``long_500k``) viewed as bf16 again.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_util as util  # noqa: E402

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed.sharding import use_rules  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh)

torch.set_num_threads(1)

JOIN_S = 240
ATTN = partition.ATTN_KEYS


@pytest.fixture(autouse=True)
def _restore_stats():
    """The dispatch STATS and the exchange counts are process-global: put
    them back."""
    snap = dispatch.snapshot()
    wire, result = dict(col.WIRE), dict(col.RESULT)
    yield
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)
    col.WIRE.update(wire)
    col.RESULT.update(result)


@pytest.fixture
def fake4():
    """A fake default group of 4 ranks (rank 0), destroyed after the test:
    the tests of a pytest-xdist worker share its process."""
    with dryrun.fake_group(4):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's shard shapes, the gloo ranks' counts), made side by
    side."""
    d = tmp_path_factory.mktemp("dryrun")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    log = open(d / "jax.log", "w")
    jax_proc = subprocess.Popen(
        [sys.executable, util.__file__, "jaxdryrun", str(d / "jax.json")],
        stdout=log, stderr=subprocess.STDOUT, env=env)
    none = d / "none.npz"
    util.save(none, {})
    try:
        ranks = util.join(util.launch("dryrun", 4, d, none), d, "dryrun",
                          JOIN_S)
    finally:
        try:
            jax_proc.wait(timeout=JOIN_S)
        finally:
            if jax_proc.poll() is None:
                jax_proc.kill()
                jax_proc.wait()
            log.close()
    assert jax_proc.returncode == 0, (d / "jax.log").read_text()[-3000:]
    return json.loads((d / "jax.json").read_text()), ranks


# ---------------------------------------------------------------------------
# (i) rank 0's layout against the reference's shardings
# ---------------------------------------------------------------------------

def _departure(cell, name, keys, m, n_dp):
    """(what, ratios) a leaf of rank 0 may depart from the reference's
    shard by: Whisper's attention whole where its heads are (m, or 1 for
    a leaf the reference does not split over "model" either) and its rings
    by head (whole where the heads are), the global batch; None where it
    must equal (every LM's attention and ring: by column and by slot where
    its KV heads do not split, by head where they do, the same bytes)."""
    heads_whole = not partition.split_plan(cell.cfg, m)["heads"]
    if name in ("batch", "token"):
        return "global batch", (n_dp,)
    if heads_whole and any(k in ATTN for k in keys):
        return "attention whole", (m, 1)
    if name == "cache" and keys[-1] in ("k", "v", "ek", "ev") and \
            heads_whole:
        return "ring by head", (m,)
    return None


@pytest.mark.parametrize("arch,shape,mesh_kind", util.DRYRUN_LAYOUT_CELLS)
def test_rank_layout_equals_reference_shard_shapes(runs, arch, shape,
                                                   mesh_kind):
    ref, _ = runs
    key = f"{arch}|{shape}|{mesh_kind}"
    with dryrun.fake_group(dryrun.MESHES[mesh_kind]):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device_type="cpu")
        cell = dryrun._make_cell(arch, shape, mesh)
        n_dp = partition.Layout.of(mesh, cell.rules.batch).size(
            cell.rules.batch)
    m = 16
    assert cell.rules.mesh is mesh and all(
        t.is_meta for t in tree_lib.leaves(cell.args["params"]))
    port = {}
    for name, arg in cell.args.items():
        flat = tree_lib.leaves_with_keys(arg) if isinstance(arg, dict) \
            else [([], arg)]
        for keys, leaf in flat:
            port["/".join([key, name, *keys])] = (name, keys, leaf)
    want = {k: v for k, v in ref.items() if k.startswith(key + "/")}
    assert set(port) == set(want)
    departs, total_port, total_ref = {}, 0, 0
    for k, (gshape, sshape, item) in want.items():
        name, keys, leaf = port[k]
        got = leaf.numel() * leaf.element_size()
        shard = math.prod(sshape) * item
        assert leaf.element_size() == item, k
        total_port, total_ref = total_port + got, total_ref + shard
        dep = _departure(cell, name, keys, m, n_dp)
        if dep is None:
            assert got == shard, (k, list(leaf.shape), sshape)
            continue
        what, ratios = dep
        assert got in [r * shard for r in ratios], \
            (k, what, list(leaf.shape), sshape)
        if got != shard:
            mine, theirs = departs.get(what, (0, 0))
            departs[what] = (mine + got, theirs + shard)
    for what, (mine, theirs) in sorted(departs.items()):
        print(f"[dryrun] {key} departure {what}: rank 0 {mine} B, "
              f"reference {theirs} B")
    print(f"[dryrun] {key}: rank 0 {total_port} B, reference {total_ref} B "
          f"({total_port / total_ref:.2f}x)")
    if arch == "whisper-large-v3":
        # its 20 heads stay whole at m = 16 (MHA, its own cross K/V)
        assert "attention whole" in departs
        return
    # no LM keeps attention or its ring whole at m = 16 (by column and by
    # slot): rank 0 holds the reference's shard of every leaf but the
    # global batch
    assert set(departs) <= {"global batch"}
    mine, theirs = departs.get("global batch", (0, 0))
    assert total_port - total_ref == mine - theirs
    if arch == "qwen2.5-32b":
        # the ring: 8 rows x 2048 of 32768 slots x 8 KV heads x 128 x 2
        # (k, v) x 64 layers of int8
        ring = sum(leaf.numel() for keys, leaf in tree_lib.leaves_with_keys(
            cell.args["cache"]) if keys[-1] in ("k", "v"))
        assert ring == 8 * 2048 * 8 * 128 * 2 * 64


# ---------------------------------------------------------------------------
# (ii) meta under the fake group against real tensors under gloo
# ---------------------------------------------------------------------------

def _meta_counts(rank, shape):
    out = {}
    with dryrun.fake_group(4, rank=rank):
        mesh = make_test_mesh(shape, device_type="cpu")
        for tag, arch, cell_shape, seq, batch, variant in util.DRYRUN_CASES:
            cell = dryrun._make_cell(arch, cell_shape, mesh,
                                     cfg=registry.smoke_config(arch),
                                     seq=seq, batch=batch, variant=variant)
            assert all(t.is_meta for t in tree_lib.leaves(cell.args))
            out[tag] = dryrun.measure(cell)[0]
    return out


@pytest.mark.parametrize("shape", util.DRYRUN_MESHES)
def test_meta_counts_equal_real_gloo_ranks(runs, shape):
    _, ranks = runs
    for rank, real in enumerate(ranks):
        for tag, rec in _meta_counts(rank, shape).items():
            key = f"{util.mesh_tag(shape)}/{tag}"
            assert rec["memory"]["argument_size_in_bytes"] == \
                int(real[f"{key}/args"]), (rank, key)
            assert rec["cost"]["flops"] == int(real[f"{key}/flops"]), \
                (rank, key)
            assert rec["cost"]["flops"] > 0
            for what in ("wire", "collectives", "launches"):
                got = {k: float(v) for k, v in rec[what].items()}
                want = {k.split("/")[-1]: float(v) for k, v in real.items()
                        if k.startswith(f"{key}/{what}/")}
                assert got == want, (rank, key, what)
            assert rec["collectives"] and rec["wire"], (rank, key)


@pytest.mark.parametrize("arch,shape,variant", [
    ("qwen2.5-32b", "decode_32k", None), ("qwen2.5-32b", "decode_32k", "kv4"),
    ("llama4-scout-17b-a16e", "train_4k", None),
    ("llama4-scout-17b-a16e", "prefill_32k", "opt"),
    ("recurrentgemma-9b", "long_500k", None),
    ("mamba2-130m", "train_4k", None),
    ("whisper-large-v3", "decode_32k", "packed")])
def test_meta_cell_equals_real_cell_leaf_for_leaf(fake4, arch, shape,
                                                   variant):
    """Rank 0's arguments on meta (``build_params`` draws nothing there)
    against the same cell built on the CPU, leaf for leaf: params (int,
    packed or float as the cell's mode), ZeRO-1 moments, batch, cache."""
    mesh = make_test_mesh((2, 2), device_type="cpu")
    kw = dict(cfg=registry.smoke_config(arch), seq=32, batch=8,
              variant=variant)
    meta = dryrun._make_cell(arch, shape, mesh, **kw)
    real = dryrun._make_cell(arch, shape, mesh, device="cpu", **kw)
    got, want = (tree_lib.leaves_with_keys(c.args) for c in (meta, real))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (keys, m), (_, r) in zip(got, want):
        assert m.is_meta and not r.is_meta
        assert (m.shape, m.dtype) == (r.shape, r.dtype), keys


def test_peak_tracker_equals_memtracker(fake4):
    """A train step's temp beside its arguments (params and moments, which
    the step writes in place and views of which it returns: torch's
    tracker counts them once, as "Other"); a serving cell records none,
    saying why (its int products take the plain route on meta)."""
    from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType
    _OTHER = _MemRefType.OTH
    mesh = make_test_mesh((2, 2), device_type="cpu")
    for arch in ("qwen2.5-32b", "llama4-scout-17b-a16e"):
        kw = dict(cfg=registry.smoke_config(arch), seq=32, batch=4)
        rec, _ = dryrun.measure(dryrun._make_cell(arch, "train_4k", mesh,
                                                  **kw))
        cell = dryrun._make_cell(arch, "train_4k", mesh, **kw)
        tracker = MemTracker()
        tracker.track_external(*tree_lib.leaves(cell.args))
        with use_rules(cell.rules), dispatch.use_backend("torch"), tracker:
            out = cell.run()
        del out
        peak = tracker.get_tracker_snapshot("peak")[torch.device("meta")]
        args = rec["memory"]["argument_size_in_bytes"]
        assert peak[_OTHER] == args
        assert rec["memory"]["temp_size_in_bytes"] == \
            peak["Total"] - args > 0
        assert "temp_not_measured" not in rec["memory"]
    for arch, shape in (("qwen2.5-32b", "decode_32k"),
                        ("llama4-scout-17b-a16e", "prefill_32k")):
        cell = dryrun._make_cell(arch, shape, mesh,
                                 cfg=registry.smoke_config(arch), seq=32,
                                 batch=4)
        mem = dryrun.measure(cell)[0]["memory"]
        assert mem["temp_size_in_bytes"] is None
        assert mem["temp_not_measured"] == dryrun.TEMP_INT


@pytest.mark.parametrize("arch,shape", [
    ("llama4-scout-17b-a16e", "train_4k"), ("recurrentgemma-9b", "train_4k"),
    ("whisper-large-v3", "prefill_32k"), ("mamba2-130m", "decode_32k"),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k")])
def test_step_flops_equal_flopcountermode(fake4, arch, shape):
    """The step's own count by ``flop_counter``'s formulas against
    ``FlopCounterMode`` itself (which also decomposes every op it has no
    formula for), on rank 0 of (2, 2)."""
    from torch.utils.flop_counter import FlopCounterMode
    mesh = make_test_mesh((2, 2), device_type="cpu")
    kw = dict(cfg=registry.smoke_config(arch), seq=32, batch=8,
              variant="opt")
    rec, _ = dryrun.measure(dryrun._make_cell(arch, shape, mesh, **kw))
    cell = dryrun._make_cell(arch, shape, mesh, **kw)
    flops = FlopCounterMode(display=False)
    grad = torch.enable_grad() if cell.kind == "train" else torch.no_grad()
    with use_rules(cell.rules), dispatch.use_backend("torch"), grad, \
            flops:
        cell.run()
    assert rec["cost"]["flops_counted"] == flops.get_total_flops() > 0


_A = torch.ops.aten
DTYPES = [torch.bool, torch.int8, torch.int32, torch.bfloat16, torch.float32]


def _results_case(calls):
    """Each call through ``MetaResults`` twice (the second from its
    cache) gives what the op gives on meta: shape, strides, dtype, a new
    tensor."""
    cache = dryrun.MetaResults()
    for func, args, kw in calls:
        try:
            want = func(*args, **kw)
        except (RuntimeError, TypeError):
            continue
        for _ in range(2):
            got = cache(func, args, kw)
            assert (got.shape, got.stride(), got.dtype, got.device) == \
                (want.shape, want.stride(), want.dtype, want.device), \
                (func, kw)
            assert all(got.untyped_storage()._cdata !=
                       a.untyped_storage()._cdata for a in args
                       if isinstance(a, torch.Tensor))
    return cache


@pytest.mark.parametrize("dtype", DTYPES)
def test_meta_results_equal_torch(dtype):
    """The meta results the dry run reuses, against torch's meta functions:
    elementwise ops over dtype pairs and broadcasts, with numbers, on
    transposed and strided inputs, reductions, casts and gathers; ops that
    write their inputs or return views, and tensors off meta, are never
    cached."""
    meta = lambda shape, dt=dtype: torch.empty(  # noqa: E731
        shape, dtype=dt, device="meta")
    x = meta((4, 6, 8))
    layouts = [x, x.transpose(0, 2), x[:, ::2], meta((4, 1, 8)),
               meta((4, 1, 8)).transpose(1, 2), meta(())]
    calls = []
    for other in DTYPES:
        for a in layouts:
            b = meta(a.shape, other)
            for func in (_A.mul.Tensor, _A.add.Tensor, _A.div.Tensor,
                         _A.sub.Tensor, _A.gt.Tensor, _A.bitwise_and.Tensor,
                         _A.maximum.default):
                calls += [(func, (a, b), {}), (func, (a, meta((), other)), {})]
            calls.append((_A.where.self, (meta(a.shape, torch.bool), a, b),
                          {}))
    for a in layouts:
        calls += [(_A.clamp.default, (a, -3, 5), {}),
                  (_A.clamp.default, (a,), {"min": 0.5}),
                  (_A.mul.Tensor, (a, 0.5), {}), (_A.gt.Scalar, (a, 1), {}),
                  (_A.round.default, (a,), {}), (_A.abs.default, (a,), {}),
                  (_A.amax.default, (a, [-1], True), {}),
                  (_A.sum.dim_IntList, (a, [0]), {}),
                  (_A._to_copy.default, (a,), {"dtype": torch.float32}),
                  (_A.clone.default, (a,), {})]
    idx = torch.empty((3,), dtype=torch.int64, device="meta")
    calls.append((_A.index.Tensor, (x, [idx]), {}))
    cache = _results_case(calls)
    assert len(cache.results) > 50
    for func in (_A.add_.Tensor, _A.transpose.int, _A.view.default,
                 _A.copy_.default):
        assert not dryrun._cacheable(func)
    # a view whose schema does not say so is found out at its first call
    fresh = _A.clone.default(x)
    view = cache(_A._unsafe_view.default, (fresh, [24, 8]), {})
    assert view.untyped_storage()._cdata == fresh.untyped_storage()._cdata
    assert cache.ok[_A._unsafe_view.default] is False
    cpu = torch.zeros(3)
    assert cache(_A.mul.Tensor, (cpu, cpu), {}).device.type == "cpu"
    assert dryrun._meta_key((cpu,)) is None


def test_bf16_gather_of_one_row_views_back(fake4):
    """A rank's one row of logits gathered along the vocabulary (a batch of
    one, ``long_500k``): the gathered bytes' size-1 dims keep stride 1,
    which a view as bf16 refused."""
    grp = make_test_mesh((1, 4), device_type="cpu").get_group("model")
    t = torch.zeros(1, 1, 6, dtype=torch.bfloat16)
    out = col.gather_dim(t, [grp], dim=-1)
    assert out.shape == (1, 1, 24) and out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# (iii) an analytic count
# ---------------------------------------------------------------------------

def _dense_flops(cfg, b, s, span):
    """2·M·N·K over the plain path's products of a dense GQA LM on one
    rank: q/k/v/o and the SwiGLU FFN on B·S tokens, attention scoring
    whole key rows of ``span`` keys for each query (QK and PV), and the
    last position's lm_head."""
    d, hd, t = cfg.d_model, cfg.hd, b * s
    qkvo = 2 * t * d * (2 * cfg.n_heads + 2 * cfg.kv_heads) * hd
    ffn = 3 * 2 * t * d * cfg.d_ff
    attn = 2 * (2 * b * cfg.n_heads * s * span * hd)
    return cfg.n_layers * (qkvo + ffn + attn) + 2 * b * d * cfg.vocab


@pytest.mark.parametrize("shape,seq,batch", [("decode_32k", 40, 4),
                                             ("prefill_32k", 32, 4)])
def test_dense_flops_equal_sum_of_products(shape, seq, batch):
    cfg = registry.smoke_config("qwen2.5-32b")
    cell = dryrun._make_cell("qwen2.5-32b", shape, None, cfg=cfg, seq=seq,
                             batch=batch)
    rec, _ = dryrun.measure(cell, memory=False)
    decode = shape == "decode_32k"
    want = _dense_flops(cfg, batch, 1 if decode else seq, seq)
    assert rec["cost"] == {"flops": want, "flops_counted": want,
                           "flops_added": 0}
    assert not rec["collectives"] and not rec["wire"]


def test_ssd_readout_is_added():
    cfg = registry.smoke_config("mamba2-130m")
    cell = dryrun._make_cell("mamba2-130m", "decode_32k", None, cfg=cfg,
                             seq=40, batch=4)
    rec, _ = dryrun.measure(cell, memory=False)
    s = cfg.ssd
    heads = s.expand * cfg.d_model // s.head_dim
    assert rec["cost"]["flops_added"] == \
        cfg.n_layers * 2 * 4 * heads * s.head_dim * s.d_state > 0
    assert rec["cost"]["flops"] == \
        rec["cost"]["flops_counted"] + rec["cost"]["flops_added"]


# ---------------------------------------------------------------------------
# (iv) variants
# ---------------------------------------------------------------------------

def test_sp_and_unsupported_cells_are_skipped_with_reasons():
    """An ``sp`` cell runs (the residual's sequence split) with the
    baseline cell's arguments; an unsupported cell is skipped with its
    reason."""
    rec = dryrun.run_cell("mamba2-130m", "decode_32k", "single",
                          variant="sp", verbose=False)
    base = dryrun.run_cell("mamba2-130m", "decode_32k", "single",
                           verbose=False)
    assert rec["status"] == base["status"] == "ok"
    assert rec["memory"] == base["memory"] and rec["variant"] == "sp"
    rec = dryrun.run_cell("qwen2.5-32b", "long_500k", "single",
                          verbose=False)
    assert rec["status"] == "skipped" and \
        rec["reason"] == registry.cell_supported("qwen2.5-32b",
                                                 "long_500k")[1]


SP_SAME = (("whisper-large-v3", "train_4k"), ("whisper-large-v3",
                                              "prefill_32k"),
           ("qwen2.5-32b", "decode_32k"), ("recurrentgemma-9b",
                                           "decode_32k"))


def _counts(rec):
    return {k: rec[k] for k in ("memory", "cost", "collectives", "wire",
                                "launches", "kernel_launches")}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=util.mesh_tag)
@pytest.mark.parametrize("arch,cell", SP_SAME)
def test_sp_counts_equal_baseline_where_nothing_splits(fake4, arch, cell,
                                                       shape):
    """Whisper's stacks take no ``seq_tp`` and a decode step's S = 1 keeps
    the residual whole: the ``sp`` cell counts what the baseline counts."""
    mesh = make_test_mesh(shape, device_type="cpu")
    _, base = _smoke(arch, cell, mesh=mesh)
    _, rec = _smoke(arch, cell, "sp", mesh)
    assert _counts(rec) == _counts(base)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=util.mesh_tag)
def test_sp_train_cell_moves_activations_only(fake4, shape):
    """Qwen2.5 SMOKE's train cell under ``sp``: the same arguments and
    FLOPs, a lower temp (each recomputed unit keeps the rank's chunk of
    the residual), its row-parallel sums reduce-scattered where they were
    all-reduced, and the normed stream gathered."""
    mesh = make_test_mesh(shape, device_type="cpu")
    _, base = _smoke("qwen2.5-32b", "train_4k", mesh=mesh)
    _, rec = _smoke("qwen2.5-32b", "train_4k", "sp", mesh)
    mem, mem0 = rec["memory"], base["memory"]
    assert mem["argument_size_in_bytes"] == mem0["argument_size_in_bytes"]
    assert rec["cost"] == base["cost"]
    assert mem["temp_size_in_bytes"] < mem0["temp_size_in_bytes"]
    assert "reduce-scatter" not in base["collectives"]
    assert rec["collectives"]["reduce-scatter"] > 0
    assert rec["collectives"]["all-reduce"] < base["collectives"]["all-reduce"]
    assert rec["collectives"]["all-gather"] > base["collectives"]["all-gather"]


def test_cli_runs_cells_a_process_each_and_resumes(tmp_path):
    """``main`` runs two cells (one a process when the process may use
    more than one core), writes both records, and a second call without
    ``--force`` keeps them and runs nothing."""
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
            "both", "--out", str(out)]
    assert dryrun.main(argv) == 0
    recs = json.loads(out.read_text())
    assert sorted(recs) == ["mamba2-130m|decode_32k|multi",
                            "mamba2-130m|decode_32k|single"]
    assert all(r["status"] == "ok" and r["cost"]["flops"] > 0 and
               r["memory"]["temp_size_in_bytes"] is None
               for r in recs.values())
    assert dryrun.main(argv) == 0
    assert json.loads(out.read_text()) == recs


def _smoke(arch, shape, variant=None, mesh=None):
    cell = dryrun._make_cell(arch, shape, mesh, variant=variant,
                             cfg=registry.smoke_config(arch), seq=32,
                             batch=8)
    return cell, dryrun.measure(cell)[0]


def _leaf_bytes(tree, pred):
    return sum(t.numel() * t.element_size()
               for keys, t in tree_lib.leaves_with_keys(tree) if pred(keys))


def test_variants_change_what_they_should(fake4):
    mesh = make_test_mesh((2, 2), device_type="cpu")
    base, rb = _smoke("qwen2.5-32b", "decode_32k", mesh=mesh)
    ring = lambda keys: keys[-1] in ("k", "v")               # noqa: E731
    codes = lambda keys: keys[-1] == "w_q"                   # noqa: E731
    # the linears' codes (the embedding's stay int8)
    for variant in ("packed", "kv4", "opt"):
        cell, rec = _smoke("qwen2.5-32b", "decode_32k", variant, mesh)
        # int4 weights as nibbles: half the codes' bytes
        assert all(t.dtype == torch.uint8 for keys, t in
                   tree_lib.leaves_with_keys(cell.args["params"])
                   if codes(keys))
        assert 2 * _leaf_bytes(cell.args["params"], codes) == \
            _leaf_bytes(base.args["params"], codes)
        if variant == "kv4":
            # the ring's codes as the port stores them at 4 bits: hd/2
            # nibble bytes
            for (keys, t), (_, t0) in zip(
                    tree_lib.leaves_with_keys(cell.args["cache"]),
                    tree_lib.leaves_with_keys(base.args["cache"])):
                if ring(keys):
                    assert t.dtype == torch.uint8 and \
                        t.shape[-1] * 2 == t0.shape[-1]
            assert 2 * _leaf_bytes(cell.args["cache"], ring) == \
                _leaf_bytes(base.args["cache"], ring)
        else:
            assert _leaf_bytes(cell.args["cache"], ring) == \
                _leaf_bytes(base.args["cache"], ring)
    # the row-parallel bf16 reduce takes every row-parallel product off
    # the int32 accumulator path
    _, rec = _smoke("qwen2.5-32b", "decode_32k", "bf16red", mesh)
    assert rb["launches"]["qlinear_acc_torch"] > 0
    assert "qlinear_acc_torch" not in rec["launches"]
    assert rec["launches"]["qlinear_row_torch"] == \
        rb["launches"]["qlinear_acc_torch"]
    assert "reduce-scatter" in rec["collectives"] and \
        "reduce-scatter" not in rb["collectives"]
    # the all-to-all expert dispatch sends all-to-all bytes
    _, pb = _smoke("llama4-scout-17b-a16e", "prefill_32k", mesh=mesh)
    _, pa = _smoke("llama4-scout-17b-a16e", "prefill_32k", "a2a", mesh)
    assert "all-to-all" not in pb["collectives"]
    assert pa["collectives"]["all-to-all"] > 0 and pa["wire"]["all_to_all"]
    # experts replicated over "data" in training: the rank holds their
    # whole dout, and FSDP's gathers go
    fsdp, tb = _smoke("llama4-scout-17b-a16e", "train_4k", mesh=mesh)
    rep, tr = _smoke("llama4-scout-17b-a16e", "train_4k", "nofsdp", mesh)
    experts = lambda keys: any(k.startswith("experts_")     # noqa: E731
                               for k in keys)
    assert _leaf_bytes(rep.args["params"], experts) == \
        2 * _leaf_bytes(fsdp.args["params"], experts)
    assert tr["collectives"]["all-gather"] < tb["collectives"]["all-gather"]


# ---------------------------------------------------------------------------
# (v) the analysis module
# ---------------------------------------------------------------------------

def test_roofline_terms_hand_worked():
    # 1.979e12 int8 ops in 1 ms, 6.7 GB of HBM in 2 ms, 0.45 GB over one
    # direction of NVLink in 1 ms: bound by memory at 2 ms
    t = analysis.roofline_terms(1.979e12, 6.7e9, 0.45e9, int8_frac=1.0)
    assert t["compute_s"] == pytest.approx(1e-3, rel=1e-12)
    assert t["memory_s"] == pytest.approx(2e-3, rel=1e-12)
    assert t["collective_s"] == pytest.approx(1e-3, rel=1e-12)
    assert t["bottleneck"] == "memory_s"
    assert t["step_time_lb_s"] == t["memory_s"]
    assert t["roofline_fraction"] == pytest.approx(0.5, rel=1e-12)
    # bf16 only: 989e12 FLOP/s; half int8: the peaks blended half and half
    assert analysis.roofline_terms(989e12, 0, 0)["compute_s"] == \
        pytest.approx(1.0, rel=1e-12)
    half = analysis.roofline_terms(1484e12, 0, 0, int8_frac=0.5)
    assert half["compute_s"] == pytest.approx(1.0, rel=1e-12)
    assert half["bottleneck"] == "compute_s" and \
        half["roofline_fraction"] == 1.0
    assert analysis.model_flops_estimate(2e9, 1e3) == 1.2e13
