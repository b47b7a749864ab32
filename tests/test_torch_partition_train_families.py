"""Partitioned training of the recurrent and encoder-decoder families
(``distributed/partition.py``, ``layers/rglru.py``, ``layers/ssd.py``,
``models/lm.py::lm_loss``, ``models/encdec.py::loss_fn``,
``launch/train.py``): each rank holds only its shard of the weights and of
the ZeRO-1 moments, and the reference's train cell
(``repro/launch/dryrun.py``: ``value_and_grad`` of ``lm.lm_loss``, or of
``encdec.loss_fn`` for Whisper, LAMB, ``param_specs(expert_fsdp=True)``
and ``zero1_specs``) runs on it.

Cases (``tests/_torch_dist_util.py``, ``FAM_TRAIN_CASES``):
RecurrentGemma-9B SMOKE cut to 3 layers (the RG-LRU split by d_rnn:
w_gate, w_in, w_a, w_i by columns, ``conv_w`` and ``lam`` by feature,
w_out by K; its one-KV-head attention whole) and Mamba2-130M SMOKE cut
to 1 layer (the SSD mixer whole on every rank, on the rank's rows), both
recomputed as the cell sets ``remat``, and Whisper SMOKE (2 + 2 layers,
4 heads: attention, caches and cross K/V by whole heads at m = 4), in
fake w4/a8/attn7, and RecurrentGemma in float mode; f32, one step on 8 x
32 tokens (Whisper with 16 stub frames a row).  JAX runs each case on one
device here (its fake-quant calls recorded); four gloo ranks of the port
run it on the (data, model) meshes (2, 2), (1, 4) and (4, 1) with
``expert_fsdp``; this process runs the port on one rank.  Held, with the
bounds of ``tests/test_torch_partition_train.py``:

- on the codes of JAX's one-device run (``util.BlockReplay``), the loss
  within the reference's rtol 2e-5 of JAX's and every gathered gradient
  within 1e-5 of its leaf's max, of JAX's and of the port's one-rank run
  alike (float mode without replay).  A leaf every model rank computes
  alike from a gradient that is already whole (the SSD mixer, the norms,
  RecurrentGemma's attention) has its whole gradient on every rank and is
  summed over the batch axes only: summed over "model" too it would be m
  times JAX's, which this holds;
- every leaf a rank holds whole has the same gradient bitwise on every
  rank;
- one LAMB step on JAX's one-device gradients: the gathered params within
  1e-6 of the update's max plus one f32 spacing of the leaf's max, and
  the ZeRO-1 moments at the reference's shard shapes on each mesh
  (``zero1_specs`` on ``param_specs(expert_fsdp=True)`` of the global
  tree, Whisper's ``enc_layers`` / ``dec_layers`` included; attention
  kept whole where the head rule keeps it);
- ``make_train_step`` (``encdec.loss_fn`` for Whisper, chosen by
  ``registry.is_encdec``) on the rank's own codes against the one-rank
  step, within the decoder LMs' bounds; float mode within 1e-5;
- the stepped local tree integerized on the rank bitwise equal to the
  partition of the gathered tree's integerization, and served partitioned
  (ring prefill and 4 greedy steps, Whisper's from its frames) bitwise as
  on one rank.
"""
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_util as util  # noqa: E402
from _torch_qat_util import jax_fake_quant_records  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core.api import QuantConfig as JQuantConfig  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import init_opt_state as j_init_opt  # noqa: E402
from repro.optim import opt_update as j_opt_update  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.api import QuantConfig, integerize_params  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state, opt_update  # noqa

torch.set_num_threads(1)

JOIN_S = 240
CASES = util.FAM_TRAIN_CASES
FAKE = [c for c in CASES if c.endswith("-fake")]
# the own-codes step against one rank (tests/test_torch_partition_train.py)
STEP_LOSS_RTOL, STEP_GNORM_RTOL = 5e-3, 5e-2


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def _cfg(case):
    return util.train_config(case, lm, registry, QuantConfig)


def _ref_shard_shapes(params, shape):
    """The reference's ZeRO-1 moment shapes on a (data, model) mesh of
    ``shape``, as its train cell builds them (``launch/dryrun.py``:
    ``zero1_specs`` on ``param_specs(expert_fsdp=True)``, finalized by
    ``filter_mesh_axes`` and ``enforce_divisible``), by flat key."""
    mesh = types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]},
                                 axis_names=("data", "model"))
    pspecs = jsharding.param_specs(params, expert_fsdp=True)
    specs = jsharding.enforce_divisible(jsharding.filter_mesh_axes(
        jsharding.zero1_specs(params, pspecs, data_size=shape[0]), mesh),
        params, mesh)

    def one(spec, leaf):
        out = list(leaf.shape)
        for dim, entry in enumerate(spec):
            for a in _axes(entry):
                out[dim] //= mesh.shape[a]
        return tuple(out)
    return util.flat(jax.tree.map(one, specs, params, is_leaf=lambda x:
                                  isinstance(x, jax.sharding.PartitionSpec)))


def _axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _jax_one(case, arrays, monkeypatch):
    """JAX's one-device train cell on the case (its fake-quant calls and
    exp2_shift inputs recorded into ``arrays``): loss, gradients, updated
    params, the reference's moment shapes on each mesh (numpy)."""
    jcfg = util.train_config(case, jlm, jreg, JQuantConfig)
    jmod = jencdec if case.startswith("whisper") else jlm
    loss = jencdec.loss_fn if jmod is jencdec else jlm.lm_loss
    params = jax.jit(lambda k: jmod.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    batch = util.train_batch(case, jcfg)
    vg = jax.jit(jax.value_and_grad(lambda p, b: loss(p, b, jcfg),
                                    has_aux=True))
    with jax_fake_quant_records(monkeypatch) as rec:
        (value, _), grads = vg(params, batch)
        jax.block_until_ready(grads)
    new, _, _ = jax.jit(lambda p, g, o: j_opt_update(
        p, g, o, JOptConfig(**util.TRAIN_OPT)))(params, grads,
                                                j_init_opt(params))
    arrays.update(util.flat(params, f"{case}/params/"))
    arrays.update(util.flat(batch, f"{case}/batch/"))
    arrays.update(util.flat(grads, f"{case}/jgrads/"))
    if jcfg.quant is not None:
        util.records_to(arrays, f"{case}/rec", rec)
    return {"loss": float(value), "grads": jax.tree.map(np.asarray, grads),
            "params": jax.tree.map(np.asarray, new),
            "old": jax.tree.map(np.asarray, params),
            "mu_shapes": {mesh: _ref_shard_shapes(params, mesh)
                          for mesh in util.TRAIN_MESHES}}


def _port_one(case, ref):
    """The port's one-rank run of each part of ``util.train_cases``."""
    cfg = _cfg(case)
    loss_fn = train.model_loss(cfg)
    glob = util._tree(ref, f"{case}/params")
    batch = util.batch_of(ref, case)
    ocfg = OptConfig(**util.TRAIN_OPT)
    out = {}
    if cfg.quant is None:
        loss, _, grads = train.value_and_grad(loss_fn, glob, batch)
    else:
        with util.BlockReplay(*util.records_from(ref, f"{case}/rec")) as rep:
            loss, _, grads = train.value_and_grad(loss_fn, glob, batch)
        rep.flips()
    out["replay"] = (float(loss), grads)
    p = tree_lib.tree_map(torch.clone, glob)
    opt_update(p, util._tree(ref, f"{case}/jgrads"), init_opt_state(p), ocfg)
    out["opt"] = p
    p = tree_lib.tree_map(torch.clone, glob)
    p, _, met = train.make_train_step(cfg, ocfg)(p, init_opt_state(p), batch)
    out["step"] = (float(met["loss"]), float(met["grad_norm"]), p)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' outputs, JAX one-device, the port's one-rank runs, the
    reference arrays)."""
    d = tmp_path_factory.mktemp("partition_train_families")
    ref = d / "ref.npz"
    arrays = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_one = {case: _jax_one(case, arrays, mp) for case in CASES}
    util.save(ref, arrays)
    procs = util.launch("trainfam", 4, d, ref)
    try:
        loaded = util.load(ref)
        one = {case: _port_one(case, loaded) for case in CASES}
    finally:
        ranks = util.join(procs, d, "trainfam", JOIN_S)
    return ranks, jax_one, one, loaded


CASE_MESH = [(c, m) for c in CASES for m in util.TRAIN_MESHES]
FAKE_MESH = [cm for cm in CASE_MESH if cm[0] in FAKE]


def _id(cm):
    return f"{cm[0]}-{util.mesh_tag(cm[1])}"


@pytest.mark.parametrize("case,mesh", CASE_MESH, ids=map(_id, CASE_MESH))
def test_loss_and_gradients_on_jax_codes(runs, case, mesh):
    ranks, jax_one, one, _ = runs
    cfg = _cfg(case)
    key = f"{case}/{util.mesh_tag(mesh)}"
    want = jax_one[case]
    for r in ranks:
        loss = float(r[f"{key}/replay/loss"])
        assert abs(loss - want["loss"]) <= 2e-5 * abs(want["loss"])
        assert abs(loss - one[case]["replay"][0]) <= \
            2e-5 * abs(want["loss"])
    grads = util.gathered(ranks, mesh, f"{key}/replay/grads", cfg)
    util.close_leaves(grads, want["grads"], 1e-5, "vs jax")
    util.close_leaves(grads, one[case]["replay"][1], 1e-5, "vs one rank")


@pytest.mark.parametrize("case,mesh", CASE_MESH, ids=map(_id, CASE_MESH))
def test_whole_leaves_have_one_gradient_on_every_rank(runs, case, mesh):
    ranks, jax_one, *_ = runs
    key = f"{case}/{util.mesh_tag(mesh)}/replay/grads"
    glob = util.flat(jax_one[case]["grads"])
    whole = [k for k, g in glob.items()
             if all(r[f"{key}/{k}"].shape == g.shape for r in ranks)]
    # the norms at least; the SSD mixer; not RecurrentGemma's one-KV-head
    # attention, which splits by column at every m > 1
    assert any("gamma" in k for k in whole)
    if case.startswith("mamba"):
        assert {"in_proj", "out_proj", "A_log", "D"} <= {
            p for k in whole for p in k.split("/")}
    if case.startswith("rg"):
        assert any("/attn/" in k for k in whole) == (mesh[1] == 1)
    for k in whole:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{key}/{k}"],
                                          ranks[0][f"{key}/{k}"])


@pytest.mark.parametrize("case,mesh", CASE_MESH, ids=map(_id, CASE_MESH))
def test_one_lamb_step_on_jax_gradients(runs, case, mesh):
    ranks, jax_one, one, _ = runs
    cfg = _cfg(case)
    key = f"{case}/{util.mesh_tag(mesh)}"
    got = util.gathered(ranks, mesh, f"{key}/opt/params", cfg)
    want, old = jax_one[case]["params"], jax_one[case]["old"]
    step = {k: np.abs(v - util.flat(old)[k]).max()
            for k, v in util.flat(want).items()}
    for k, v in util._np(got).items():
        w = util.flat(want)[k]
        assert np.abs(v - w).max() <= 1e-6 * step[k] + \
            np.spacing(np.abs(w).max()), k
        np.testing.assert_allclose(v, util._np(one[case]["opt"])[k],
                                   rtol=0, atol=1e-6 * step[k] +
                                   np.spacing(np.abs(w).max()))
    # the moments at the reference's shard shapes, attention's too (by
    # column: RecurrentGemma's one KV head)
    jmu = jax_one[case]["mu_shapes"][mesh]
    checked = 0
    for r in ranks:
        for k in util.flat(jax_one[case]["grads"]):
            assert r[f"{key}/mu/{k}"].shape == jmu[k], (k, jmu[k])
            checked += 1
    assert checked


@pytest.mark.parametrize("case,mesh", CASE_MESH, ids=map(_id, CASE_MESH))
def test_train_step_on_own_codes(runs, case, mesh):
    ranks, _, one, ref = runs
    cfg = _cfg(case)
    key = f"{case}/{util.mesh_tag(mesh)}"
    loss, gnorm, params = one[case]["step"]
    tol = STEP_LOSS_RTOL if cfg.quant is not None else 2e-5
    for r in ranks:
        assert abs(float(r[f"{key}/step/loss"]) - loss) <= tol * abs(loss)
        assert abs(float(r[f"{key}/step/grad_norm"]) - gnorm) <= \
            (STEP_GNORM_RTOL if cfg.quant is not None else 1e-5) * gnorm
    # replicas bitwise (gather_params checks), every leaf finite and moved
    got = util.gathered(ranks, mesh, f"{key}/step/params", cfg)
    old = util._tree(ref, f"{case}/params")
    for (k, g), (_, o) in zip(tree_lib.leaves_with_keys(got),
                              tree_lib.leaves_with_keys(old)):
        assert bool(torch.isfinite(g).all()) and not torch.equal(g, o), k
    if cfg.quant is None:
        util.close_leaves(got, params, 1e-5, "float step")


@pytest.mark.parametrize("case,mesh", FAKE_MESH, ids=map(_id, FAKE_MESH))
def test_local_integerization_serves_as_the_gathered_tree(runs, case, mesh):
    ranks, _, _, ref = runs
    cfg = _cfg(case)
    key = f"{case}/{util.mesh_tag(mesh)}"
    trained = util.gathered(ranks, mesh, f"{key}/step/params", cfg)
    qc = QuantConfig(**util.TRAIN_SERVE)
    icfg = cfg.replace(quant=qc)
    whole = integerize_params(trained, qc)
    logits, fed = util.serve_steps(whole, util.batch_of(ref, case), icfg)
    for layout, r in zip(util.train_layouts(ranks, mesh, fsdp=False), ranks):
        assert r[f"{key}/int_contiguous"]
        want = partition.partition_params(whole, icfg, layout)
        for k, v in util.flat(want).items():
            np.testing.assert_array_equal(r[f"{key}/int/{k}"], v.numpy(), k)
        np.testing.assert_array_equal(r[f"{key}/serve/logits"],
                                      logits.numpy())
        np.testing.assert_array_equal(r[f"{key}/serve/fed"], fed.numpy())
