"""The reference's two shard bodies on rank-local operands: partitioned
rules (``distributed/partition.py``) with ``int_bf16_reduce`` (the
row-parallel integer linear, ``core/api.py::_int_row_parallel``) and
``moe_a2a`` (the expert-parallel MoE, ``layers/moe.py::moe_ffn_a2a``).

Three JAX subprocesses side by side (8 host devices, meshes by
``jax.sharding.Mesh``; ``tests/_torch_dist_util.py jaxshard``) run the
reference's bodies; four
gloo ranks of the port run the same on each rank's shard
(``_torch_dist_util.py rank shardlocal`` beside them, ``shardjax`` after
them; a mesh of 2 ranks runs twice under an outer axis no rule reads).
Held:

- the row-parallel body on (data, model) meshes (1, 2), (1, 4) and (2, 2)
  at Qwen2.5 SMOKE's down and wo widths, 2-D and 3-D x, int8 and packed
  int4: each rank's activation codes and int32 sums equal to the
  reference's rank's; its rows bitwise the reference's at m <= 2 and
  within one bf16 ulp past two ranks (the f32 partials sum in the
  collective's order, not XLA's: a bf16 rounding edge may fall
  differently); both port backends and the same body on global tensors
  bitwise equal, one rank product through ``qlinear_row`` and none
  through the int32 accumulator path;
- the local bodies bitwise equal to the global-tensor ones under the same
  rules on the same mesh: Qwen2.5 and ChatGLM3 SMOKE (attention whole on
  the rank at model 4, where the body slices K per call) under
  ``int_bf16_reduce`` and the "opt" rules (both options, packed int4),
  Llama-4-Scout and Phi-3.5-MoE SMOKE under ``moe_a2a`` and "opt", on
  (1, 4) and (2, 2), prefill and 4 greedy ring steps; every row-parallel
  product on its path, every MoE FFN through the all-to-all, no plain
  dispatch; and no ``_row_codes`` copy on any local tree; the bytes a
  rank sends in Llama-4-Scout SMOKE's layer 0 wo and MoE FFN
  (``distributed/collectives.py``'s counts), today and with both
  options, equal to ``chip_smoke.py``'s analytic counts;
- the MoE FFN of layer 0 of Llama-4-Scout (top-1, shared expert) and
  Phi-3.5-MoE (top-2) SMOKE on (2, 2) within TOL of the reference's
  (f32 sums in another order); a decode-sized call (one token a rank)
  takes the dense dispatch, bitwise as under partitioned rules without
  ``moe_a2a``;
- gradients of ``sum(y ** 2) + lb_loss`` through the all-to-all (8
  experts, top-2), float and fake, with and without ``expert_fsdp``: y,
  ``lb_loss`` and every gradient block within TOL of the reference's, as
  ``tests/test_torch_distributed.py::test_moe_a2a_with_gradients`` holds
  the global-tensor body (f32 sums in another order);
- one partitioned train step of Llama-4-Scout SMOKE under
  ``Rules(partitioned, moe_a2a, expert_fsdp)`` against the reference's
  train cell with ``moe_a2a`` on (2, 2): in float mode the loss within
  2e-5 and every gathered gradient within 1e-5 of its leaf's max (f32
  sums in other orders, as ``tests/test_torch_partition_train.py`` holds
  float mode); in fake mode (w4/a8/attn7) the loss and the gradient norm
  within that file's bounds for a step on the rank's own codes (its codes
  are not replayed: the reference's flip inside its ``shard_map`` bodies,
  where no record is taken);
- greedy tokens of Qwen2.5 and Llama-4-Scout SMOKE under the "opt" rules
  on (2, 2), prefill and 8 ring steps, against JAX's ``jit`` under the
  same rules: equal up to the first step where they part, and there only
  at a near tie that the logits' own gap explains, the logits within
  FLIP_TOL of their max up to that step (each row-parallel output rounds
  to bf16, so a last-bit difference upstream (XLA contracts FMAs) moves
  an element by a whole bf16 ulp at a rounding edge);
- one int forward of RecurrentGemma-9B and Whisper SMOKE under
  ``int_bf16_reduce`` at (1, 2): logits within FLIP_TOL of the
  reference's, bitwise the global-tensor bodies', every row-parallel
  product through ``qlinear_row``; then one decode step, bitwise the
  global-tensor bodies', Whisper's self-attention wo (unmarked in the
  reference) summing int32 partials.

The reference's own behaviour under these options (``ROADMAP.md`` queue
3): with ``int_bf16_reduce`` a row-parallel grid is per tensor over the
rank's rows, so a batch row is not the same sequence run alone; with
``moe_a2a`` capacity is per token sub-shard (``cap_sub``), so the tokens
dropped differ from the dense dispatch's.  No test here asserts the
engine-style invariants under them.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_util as util  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.core.api import QuantConfig  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import lm  # noqa: E402

torch.set_num_threads(1)

JOIN_S = 240
TOL = 1e-6
BF16_ULP = 2.0 ** -7           # one bf16 ulp is at most this share of |v|
FLIP_TOL = 0.1
# a train step on the rank's own codes (tests/test_torch_partition_train.py)
STEP_LOSS_RTOL, STEP_GNORM_RTOL = 5e-3, 5e-2


@pytest.fixture(autouse=True)
def _restore_stats():
    """The dispatch STATS are process-global: put them back."""
    snap = dispatch.snapshot()
    yield
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' "shardlocal" outputs, their "shardjax" outputs, the
    reference's arrays)."""
    d = tmp_path_factory.mktemp("shard_bodies")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_procs = {}
    for which in ("bodies", "serve", "train"):
        log = open(d / f"jax-{which}.log", "w")
        jax_procs[which] = (subprocess.Popen(
            [sys.executable, util.__file__, "jaxshard", which,
             str(d / f"jax-{which}.npz")], stdout=log,
            stderr=subprocess.STDOUT, env=env), log)
    none = d / "none.npz"
    util.save(none, {})
    try:
        local = util.join(util.launch("shardlocal", 4, d, none), d,
                          "shardlocal", JOIN_S)
    finally:
        for which, (p, log) in jax_procs.items():
            try:
                p.wait(timeout=JOIN_S)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    ref = {}
    for which, (p, _) in jax_procs.items():
        assert p.returncode == 0, \
            (d / f"jax-{which}.log").read_text()[-3000:]
        ref.update(util.load(d / f"jax-{which}.npz"))
    util.save(d / "ref.npz", ref)
    ranks = util.join(util.launch("shardjax", 4, d, d / "ref.npz"), d,
                      "shardjax", JOIN_S)
    return local, ranks, ref


def _get(d, key):
    return d[key] if key in d else d[key + "@bf16"]


def _close(got, want, tol=TOL):
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _rows(t, di, n):
    rows = t.shape[0] // n
    return t[di * rows:(di + 1) * rows]


ROW = [(c, m) for m in util.SB_ROW_MESHES for c in util.SB_ROW_CASES]


@pytest.mark.parametrize("case,mesh", ROW, ids=[
    f"{c[0]}-{util.mesh_tag(m)}" for c, m in ROW])
def test_row_body_on_local_operands_is_the_reference_s(runs, case, mesh):
    name = case[0]
    _, ranks, ref = runs
    key = f"row/{name}/{util.mesh_tag(mesh)}"
    y, codes, acc = ref[f"{key}/y"], ref[f"{key}/codes"], ref[f"{key}/acc"]
    b = ref.get(f"{key}/p/b", 0.0)
    for r in ranks:
        di, mj = (int(i) for i in r[f"layout/{util.mesh_tag(mesh)}"])
        i = di * mesh[1] + mj
        np.testing.assert_array_equal(r[f"{key}/codes"], codes[i])
        np.testing.assert_array_equal(r[f"{key}/acc"], acc[i])
        got, want = r[f"{key}/cuda"], _rows(y, di, mesh[0])
        np.testing.assert_array_equal(got, r[f"{key}/torch"])
        np.testing.assert_array_equal(got, r[f"{key}/global"])
        if mesh[1] <= 2:
            np.testing.assert_array_equal(got, want)
        else:
            tol = BF16_ULP * (np.abs(want) + np.abs(b)) + 1e-6
            assert np.all(np.abs(got - want) <= tol)
        for backend in ("cuda", "torch"):
            assert r[f"{key}/{backend}/qlinear_row_{backend}"] == 1
            assert r[f"{key}/{backend}/qlinear_acc_{backend}"] == 0


LOCAL = [(a, t, m) for m in util.SB_LOCAL_MESHES for a in util.SB_LOCAL_ARCHS
         for t in (("a2a", "opt") if smoke_config(a).moe is not None
                   else ("bf16red", "opt"))]


@pytest.mark.parametrize("arch,tag,mesh", LOCAL, ids=[
    f"{a}-{t}-{util.mesh_tag(m)}" for a, t, m in LOCAL])
def test_local_bodies_are_bitwise_the_global_ones(runs, arch, tag, mesh):
    local, _, _ = runs
    cfg = smoke_config(arch)
    key = f"local/{arch}/{tag}/{util.mesh_tag(mesh)}"
    forwards = 1 + util.SB_LOCAL_STEPS
    rows = cfg.n_layers * (1 + int(cfg.moe is None
                                   or cfg.moe.shared_expert)) * forwards
    bf16 = "int_bf16_reduce" in util.SB_RULES[tag]
    for r in local:
        for name in ("logits", "fed"):
            np.testing.assert_array_equal(r[f"{key}/{name}"],
                                          r[f"{key}/global/{name}"])
        assert r[f"{key}/qlinear_row_cuda"] == (rows if bf16 else 0)
        assert r[f"{key}/qlinear_acc_cuda"] == (0 if bf16 else rows)
        assert r[f"{key}/qlinear_row_torch"] == \
            r[f"{key}/qlinear_acc_torch"] == r[f"{key}/qlinear_torch"] == \
            r[f"{key}/qexpert_torch"] == 0
        moe = cfg.moe is not None
        # decode steps too: 4 rows over "data" split over "model"
        assert r[f"{key}/a2a"] == (cfg.n_layers * forwards if moe else 0)
        assert (r[f"{key}/qexpert_cuda"] > 0) == moe


@pytest.mark.parametrize("mesh", util.SB_LOCAL_MESHES, ids=util.mesh_tag)
@pytest.mark.parametrize("what", ["row", "moe"])
def test_wire_bytes_are_the_analytic_counts(runs, what, mesh):
    """``chip_smoke.py``'s gate (d) on gloo: the bytes a rank sends in
    Llama-4-Scout SMOKE's layer 0 wo and MoE FFN, counted in
    ``distributed/collectives.py``, today and with both options."""
    local, _, _ = runs
    for r in local:
        for rules in ("old", "new"):
            pre = f"wire/{what}/{rules}/{util.mesh_tag(mesh)}/"
            kinds = [k for k in r if k.startswith(pre)]
            assert kinds or (rules == "old" and what == "row"), pre
            for k in kinds:
                got, want = r[k]
                assert got == want, (k, got, want)
        new = sum(r[k][0] for k in r if k.startswith(
            f"wire/{what}/new/{util.mesh_tag(mesh)}/"))
        assert new > 0


def test_strided_expert_slices_reach_the_kernel_contiguous():
    """At one slot a source (a decode step over four model ranks) the
    all-to-all body's buffer keeps its transposed strides through the
    reshape to (E/m, m * cap_sub, d); the expert product hands qmatmul
    each expert's slice contiguous and 16-byte aligned."""
    m, e_loc, cap_sub, d = 4, 4, 1, 64
    buf = torch.arange(m * e_loc * cap_sub * d, dtype=torch.float32)
    buf = buf.reshape(m, e_loc, cap_sub, d).transpose(0, 1).reshape(
        e_loc, m * cap_sub, d)
    assert not buf[0].is_contiguous()
    for i in range(e_loc):
        t = dispatch._aligned(buf[i])
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert torch.equal(t, buf[i])


def test_partitioned_runs_leave_no_row_codes_copy(runs):
    local, _, _ = runs
    for r in local:
        assert r["local/row_memos"] == 0


@pytest.mark.parametrize("arch", util.SB_MOE_ARCHS)
def test_moe_a2a_int_forward_is_the_reference_s(runs, arch):
    _, ranks, ref = runs
    y = ref[f"{arch}/moe/y"]
    for r in ranks:
        di, _ = (int(i) for i in r["layout/2x2"])
        got = r[f"{arch}/moe/opt/y"]
        _close(got, _rows(y, di, 2))
        np.testing.assert_array_equal(got, r[f"{arch}/moe/global/y"])
        _close(r[f"{arch}/moe/opt/lb"], ref[f"{arch}/moe/lb"])
        assert r[f"{arch}/moe/opt/a2a"] == 1


@pytest.mark.parametrize("arch", util.SB_MOE_ARCHS)
def test_decode_sized_moe_takes_the_dense_dispatch(runs, arch):
    _, ranks, _ = runs
    for r in ranks:
        assert r[f"{arch}/decode/a2a/a2a"] == 0
        np.testing.assert_array_equal(r[f"{arch}/decode/a2a/y"],
                                      r[f"{arch}/decode/dense/y"])


@pytest.mark.parametrize("fsdp", [0, 1])
@pytest.mark.parametrize("mode", ["float", "fake"])
def test_gradients_through_the_all_to_all(runs, mode, fsdp):
    _, ranks, ref = runs
    tag = f"a2a/{mode}/fsdp{fsdp}"
    e_loc = util.A2A_E // 2
    for r in ranks:
        di, mj = (int(i) for i in r["layout/2x2"])
        _close(r[f"{tag}/y"], _rows(ref[f"{tag}/y"], di, 2))
        _close(r[f"{tag}/lb"], ref[f"{tag}/lb"])
        names = [k[len(f"{tag}/grad/"):] for k in r
                 if k.startswith(f"{tag}/grad/")]
        assert len(names) == 4              # router, experts gate, up, down
        for name in names:
            want = ref[f"{tag}/grad/{name}"]
            block = want
            if name.startswith("experts_"):
                block = block[mj * e_loc:(mj + 1) * e_loc]
                if fsdp:
                    c = block.shape[2] // 2
                    block = block[:, :, di * c:(di + 1) * c]
            got = r[f"{tag}/grad/{name}"]
            assert got.shape == block.shape and np.isfinite(got).all()
            scale = np.abs(want).max()
            np.testing.assert_allclose(got / scale, block / scale, rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("case", util.SB_TRAIN_CASES)
def test_train_step_through_the_all_to_all(runs, case):
    _, ranks, ref = runs
    cfg = util.sb_train_config(case, lm, registry, QuantConfig)
    loss, gnorm = float(ref[f"{case}/loss"]), float(ref[f"{case}/grad_norm"])
    fake = cfg.quant is not None
    rtol = (STEP_LOSS_RTOL, STEP_GNORM_RTOL) if fake else (2e-5, 2e-5)
    for r in ranks:
        assert r[f"{case}/a2a"] >= 2 * cfg.n_layers       # forward, remat
        got = float(r[f"{case}/step/loss"])
        assert got == float(ranks[0][f"{case}/step/loss"])
        assert float(r[f"{case}/loss"]) == got
        assert abs(got - loss) <= rtol[0] * abs(loss)
        assert abs(float(r[f"{case}/step/grad_norm"]) - gnorm) <= \
            rtol[1] * gnorm
        for k, v in r.items():
            if k.startswith(f"{case}/grads/"):
                assert np.isfinite(v).all(), k
    if not fake:
        grads = util.gathered(ranks, util.SB_TRAIN_MESH, f"{case}/grads",
                              cfg)
        util.close_leaves(grads, util.unflat(ref, f"{case}/grads"), 1e-5,
                          "vs jax")


@pytest.mark.parametrize("arch", util.SB_GREEDY_ARCHS)
def test_greedy_tokens_under_the_opt_rules_are_jax_s(runs, arch):
    _, ranks, ref = runs
    want_logits, want_fed = ref[f"{arch}/opt/logits"], ref[f"{arch}/opt/fed"]
    for r in ranks:
        logits, fed = r[f"{arch}/opt/local/logits"], r[f"{arch}/opt/local/fed"]
        np.testing.assert_array_equal(logits, r[f"{arch}/opt/global/logits"])
        np.testing.assert_array_equal(fed, ranks[0][f"{arch}/opt/local/fed"])
        apart = np.nonzero((fed != want_fed).any(axis=(1, 2)))[0]
        last = apart[0] if len(apart) else util.SB_STEPS
        # identical tokens so far: the logits of step `last` come from the
        # same inputs in both packages
        for s in range(last + 1):
            got, want = logits[s, :, -1], want_logits[s, :, -1]
            assert np.abs(got - want).max() <= \
                FLIP_TOL * np.abs(want).max(), s
        if len(apart):
            got, want = logits[last, :, -1], want_logits[last, :, -1]
            for i in np.nonzero(fed[last, :, 0] != want_fed[last, :, 0])[0]:
                # two logits each within e of JAX's swap order only if
                # they are within 2e of each other
                gap = got[i].max() - got[i, want_fed[last, i, 0]]
                assert gap <= 2 * np.abs(got[i] - want[i]).max(), \
                    (last, i, gap)


@pytest.mark.parametrize("arch", util.SB_FAM_ARCHS)
def test_family_forward_under_bf16_reduce(runs, arch):
    _, ranks, ref = runs
    cfg = smoke_config(arch)
    want = ref[f"{arch}/bf16red/logits"]
    # RecurrentGemma: each layer's mixer output (attention wo or RG-LRU
    # w_out) and MLP down; Whisper: the encoder's wo and down, the
    # decoder's self wo, cross wo and down
    rows = 2 * cfg.n_layers if arch.startswith("recurrent") else \
        2 * cfg.n_enc_layers + 3 * cfg.n_dec_layers
    # a decode step: Whisper's self-attention wo is unmarked in the
    # reference (never the bf16 body), so it sums int32 partials
    step = (2 * cfg.n_layers, 0) if arch.startswith("recurrent") else \
        (2 * cfg.n_dec_layers, cfg.n_dec_layers)
    for r in ranks:
        key = f"{arch}/bf16red/local"
        got = r[f"{key}/logits"]
        for name in ("logits", "step"):
            np.testing.assert_array_equal(
                r[f"{key}/{name}"], r[f"{arch}/bf16red/global/{name}"])
        assert np.abs(got - want).max() <= FLIP_TOL * np.abs(want).max()
        assert r[f"{key}/qlinear_row_cuda"] == rows
        assert r[f"{key}/qlinear_acc_cuda"] == 0
        assert (r[f"{key}/step/qlinear_row_cuda"],
                r[f"{key}/step/qlinear_acc_cuda"]) == step
