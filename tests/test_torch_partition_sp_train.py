"""The residual's sequence split (Megatron-SP, ``Rules.seq_tp``) on
rank-local trees, in training: ``lm.lm_loss`` and its gradients under
``Rules(partitioned=True, expert_fsdp=True, seq_tp=("model",))`` against
the same partitioned step without ``seq_tp``.

Four gloo ranks (``tests/_torch_dist_util.py rank sptrain``) run the
partitioned train cell's loss (fake w4/a8/attn7, f32, 8 x 32 tokens) of
Qwen2.5 SMOKE (two loss chunks), Llama-4-Scout SMOKE (MoE, recomputed
units), RecurrentGemma-9B SMOKE at 3 layers and Mamba2-130M SMOKE at 1
(both recomputed) on the (data, model) meshes (2, 2) and (1, 4), each
rank's tree from ``partition.build_params``, with and without
``seq_tp``; ``train.value_and_grad`` sums each rank's gradients over the
batch axes.  Held:

- at m = 2, (2, 2), the loss bitwise equal (the forward is the same
  arithmetic row by row, and a row-parallel f32 sum of two terms is the
  same whether all-reduced or reduce-scattered), and every gradient
  bitwise equal but the norms' gains (``ln1``, ``ln2``, ``final_norm``):
  under the split each rank normalizes its own rows, so a gain's
  gradient is a sum over the rank's rows, then over "model"
  (``Partition.shared``), where without it one sum runs over all rows:
  the same terms added in another order, held within GRAD_TOL of their
  leaf's max;
- at m = 4, (1, 4), the f32 sums of four ranks' partial products (and of
  the normed stream's gradient) add in the reduce-scatter's order, not
  the all-reduce's, so a fake-quant code can flip at a rounding edge and
  the flip cascades, as the partitioned step parts from one rank's
  (``tests/test_torch_partition_train.py``).  So, with that file's bounds:
  on the codes of the run without the split (``chip_smoke.FakeQuantTap``
  replays them) the loss within LOSS_RTOL and every gradient within
  GRAD_TOL of its leaf's max (f32 sums in other orders); on its own codes
  the loss within STEP_LOSS_RTOL, and where a rank's codes differ at all,
  some of them flips that the sums' order alone decides
  (``chip_smoke.code_flips``: a quotient at a rounding edge, or an
  attention row whose prob grid moved by a power of two as its max
  crossed an integer), the rest following them.  A rank with no such
  flip of its own has its first flip later in the step's fake-quant calls
  than one on another rank: under the column split each rank quantizes
  its own K slice of the attention output, and wo's row-parallel sum
  carries a flip there to every rank's rows.

Beside the ranks a JAX subprocess (``_torch_dist_util.py jaxsptrain``, 8
host devices) runs the reference's own ``seq_tp`` train cell: Qwen2.5
SMOKE in fake mode under ``Rules(batch=("data",), seq_tp=("model",))``
on a (data 1, model 4) host mesh, recording its fake-quant codes.  The
ranks take its tree and batch under ``seq_tp`` on both meshes, with
``tests/test_torch_partition_train.py``'s bounds against JAX:

- on the reference's codes (``util.BlockReplay``; every code the rank's
  own forward would have taken otherwise sits at a rounding edge), the
  loss within LOSS_RTOL of JAX's and every gathered gradient within
  GRAD_TOL of its leaf's max in JAX's (f32 sums in other orders);
- on the rank's own codes, the loss within STEP_LOSS_RTOL and the
  gradient norm within STEP_GNORM_RTOL of JAX's (the flips cascade, as
  JAX's own sharded run parts from its one-device run).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_util as util  # noqa: E402

from repro_torch.kernels import dispatch  # noqa: E402

torch.set_num_threads(1)

JOIN_S = 240
# tests/test_torch_partition_train.py's bounds: f32 sums in other orders
# (the loss at the reference's rtol) and a step on its own codes
LOSS_RTOL, GRAD_TOL = 2e-5, 1e-5
STEP_LOSS_RTOL, STEP_GNORM_RTOL = 5e-3, 5e-2
GAINS = ("ln1", "ln2", "final_norm")


@pytest.fixture(autouse=True)
def _restore_stats():
    """The dispatch STATS are process-global: put them back."""
    snap = dispatch.snapshot()
    yield
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' outputs, the reference's arrays)."""
    d = tmp_path_factory.mktemp("sptrain")
    ref = d / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    log = open(d / "jax.log", "w")
    jax_proc = subprocess.Popen(
        [sys.executable, util.__file__, "jaxsptrain", str(ref)], stdout=log,
        stderr=subprocess.STDOUT, env=env)
    try:
        ranks = util.join(util.launch("sptrain", 4, d, ref), d, "sptrain",
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
    return ranks, util.load(ref)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


def _grads(r, key):
    pre = f"{key}/grads/"
    return {k[len(pre):]: v for k, v in r.items() if k.startswith(pre)}


def _bitwise(mesh):
    return mesh[1] == 2


def _first(r, key, col):
    """The index of a rank's first fake-quant call with a flip of the kind
    ``col`` of ``code_flips`` (0 any, 1 primary; shifted ones count as
    primary), or infinity."""
    by_call = r[f"{key}/flips_by_call"]
    hit = by_call[:, 0] > 0 if col == 0 else by_call[:, 1:].sum(1) > 0
    return int(np.argmax(hit)) if hit.any() else np.inf


@pytest.mark.parametrize("mesh", util.SP_MESHES, ids=util.mesh_tag)
@pytest.mark.parametrize("case", util.SP_TRAIN_CASES)
def test_sp_loss_is_bitwise_the_step_without_it(ranks, case, mesh):
    key = f"{case}/{util.mesh_tag(mesh)}"
    for r in ranks:
        loss, want = r[f"{key}/sp/loss"], r[f"{key}/base/loss"]
        assert np.isfinite(loss)
        if _bitwise(mesh):
            np.testing.assert_array_equal(loss, want)
            continue
        assert abs(loss - want) <= STEP_LOSS_RTOL * abs(want), (loss, want)
        total, primary, shifted = r[f"{key}/flips"]
        if total and not primary + shifted:
            assert _first(r, key, 0) > min(_first(q, key, 1) for q in ranks), \
                (total, primary, shifted)
        loss = r[f"{key}/replay/loss"]
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)


@pytest.mark.parametrize("mesh", util.SP_MESHES, ids=util.mesh_tag)
@pytest.mark.parametrize("case", util.SP_TRAIN_CASES)
def test_sp_gradients_equal_the_step_without_it(ranks, case, mesh):
    key = f"{case}/{util.mesh_tag(mesh)}"
    tag = "sp" if _bitwise(mesh) else "replay"
    n_gains = 0
    for r in ranks:
        got, want = _grads(r, f"{key}/{tag}"), _grads(r, f"{key}/base")
        assert sorted(got) == sorted(want) and got
        for k in want:
            gain = any(g in k.split("/") for g in GAINS)
            n_gains += gain
            if _bitwise(mesh) and not gain:
                np.testing.assert_array_equal(got[k], want[k], k)
                continue
            err = np.abs(got[k] - want[k]).max()
            assert err <= GRAD_TOL * np.abs(want[k]).max(), (k, err)
    assert n_gains > 0


def _jax_cfg():
    from repro_torch.configs import registry
    from repro_torch.core.api import QuantConfig
    from repro_torch.models import lm
    return util.train_config(util.SP_JAX_TRAIN_CASE, lm, registry,
                             QuantConfig)


@pytest.mark.parametrize("mesh", util.SP_MESHES, ids=util.mesh_tag)
def test_sp_on_the_reference_codes_is_its_seq_tp_step(runs, mesh):
    ranks, ref = runs
    case = util.SP_JAX_TRAIN_CASE
    want = float(ref[f"{case}/loss"])
    key = f"jax/{util.mesh_tag(mesh)}/replay"
    for r in ranks:
        loss = float(r[f"{key}/loss"])
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    grads = util.gathered(ranks, mesh, f"{key}/grads", _jax_cfg())
    util.close_leaves(grads, util.unflat(
        {k: v for k, v in ref.items() if k.startswith(f"{case}/grads/")},
        f"{case}/grads"), GRAD_TOL, "vs jax seq_tp")


def _norm(leaves):
    return float(np.sqrt(sum(float((np.asarray(v, np.float64) ** 2).sum())
                             for v in leaves)))


@pytest.mark.parametrize("mesh", util.SP_MESHES, ids=util.mesh_tag)
def test_sp_on_own_codes_is_within_the_reference_bound(runs, mesh):
    ranks, ref = runs
    case = util.SP_JAX_TRAIN_CASE
    want = float(ref[f"{case}/loss"])
    key = f"jax/{util.mesh_tag(mesh)}/own"
    for r in ranks:
        loss = float(r[f"{key}/loss"])
        assert np.isfinite(loss)
        assert abs(loss - want) <= STEP_LOSS_RTOL * abs(want), (loss, want)
    got = _norm(util._np(util.gathered(ranks, mesh, f"{key}/grads",
                                       _jax_cfg())).values())
    jnorm = _norm(v for k, v in ref.items()
                  if k.startswith(f"{case}/grads/"))
    assert abs(got - jnorm) <= STEP_GNORM_RTOL * jnorm, (got, jnorm)
