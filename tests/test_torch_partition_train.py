"""Partitioned training of the decoder LMs (``distributed/partition.py``,
``models/lm.py::lm_loss``, ``launch/train.py``, ``optim/optimizers.py``):
each rank holds only its shard of the weights and of the ZeRO-1 moments,
and the reference's train cell (``repro/launch/dryrun.py``:
``value_and_grad(lm_loss)``, LAMB, ``param_specs(expert_fsdp=True)`` and
``zero1_specs``) runs on it.

Cases (``tests/_torch_dist_util.py``): the SMOKE configs of Qwen2.5-32B
(two loss chunks) and Llama-4-Scout (top-1 experts, a shared expert,
recomputed units) in fake w4/a8/attn7, and Qwen at the widths of
``tests/test_distributed.py`` in float mode; f32, 8 x 32 tokens.  JAX
runs each case on one device here (its fake-quant calls recorded) and on a
(data 2, model 2) host mesh in a subprocess; four gloo ranks of the port
run it on the (data, model) meshes (2, 2), (1, 4) and (4, 1) with
``expert_fsdp``; this process runs the port on one rank.  Held:

- the group max's gradient with ties inside and across ranks, per tensor
  over (data 2, model 2) and per column over a K split four ways, bitwise
  ``jax.grad`` of ``jnp.max`` over the whole tensor;
- on the codes of JAX's one-device run (``util.BlockReplay``: each rank's
  fake-quant call takes the recorded output at its block, and every code
  the rank's own forward would have taken otherwise sits at a rounding
  edge), the loss within the reference's rtol 2e-5 of JAX's and every
  gathered gradient within 1e-5 of its leaf's max (f32 sums in other
  orders), of JAX's and of the port's one-rank run alike; float mode
  without replay.  The loss also within 2e-5 of JAX's sharded run for
  Qwen; for Llama-4-Scout JAX's own sharded run is 1.5e-3 from its
  one-device one (its top-1 routes and codes flip), so it is held against
  the one-device run only;
- every leaf a rank holds whole (norms, the router) has the same gradient
  bitwise on every rank;
- one LAMB step on JAX's one-device gradients: the gathered params within
  1e-6 of the update's max plus one f32 spacing of the leaf's max of JAX's
  (LAMB's norms summed over the ranks in another order, the update's
  rounding), the ZeRO-1 moments and the experts at JAX's shard
  shapes (attention by column where kv_heads % m != 0, as in
  ``tests/test_torch_partition.py``);
- ``make_train_step`` on the rank's own codes: the loss, gradient norm
  and updated params against the one-rank step, within bounds set by the
  flips that cascade from the f32 sums' order (the reference's own kind
  of gap), and its replicas bitwise equal;
- the stepped local tree integerized on the rank bitwise equal to the
  partition of the gathered tree's integerization, and served partitioned
  (ring prefill and 4 greedy steps) bitwise as on one rank;
- what partitioned training still refuses: the paged engine,
  ``lm_loss`` and ``encdec.loss_fn`` in int mode, and a global tree (the
  recurrent and encoder-decoder families train partitioned:
  ``tests/test_torch_partition_train_families.py``).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_util as util  # noqa: E402
from _torch_qat_util import jax_fake_quant_records  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core.api import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
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
FAKE = [c for c in util.TRAIN_CASES if c.endswith("-fake")]
# the own-codes step against one rank: its flips cascade through the
# layers (JAX's own sharded Llama run is 1.5e-3 from its one-device run);
# chip_smoke.py's [tp-train] gates its bf16 runs at 1e-2 and 5e-2
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


def _jax_one(case, arrays, monkeypatch):
    """JAX's one-device train cell on the case (its fake-quant calls and
    exp2_shift inputs recorded into ``arrays``): loss, gradients, updated
    params, gradient norm (numpy)."""
    jcfg = util.train_config(case, jlm, jreg, JQuantConfig)
    params = jax.jit(lambda k: jlm.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    batch = util.train_batch(case, jcfg)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, jcfg),
                                    has_aux=True))
    with jax_fake_quant_records(monkeypatch) as rec:
        (loss, _), grads = vg(params, batch)
        jax.block_until_ready(grads)
    new, _, om = jax.jit(lambda p, g, o: j_opt_update(
        p, g, o, JOptConfig(**util.TRAIN_OPT)))(params, grads,
                                                j_init_opt(params))
    arrays.update(util.flat(params, f"{case}/params/"))
    arrays.update(util.flat(batch, f"{case}/batch/"))
    arrays.update(util.flat(grads, f"{case}/jgrads/"))
    if jcfg.quant is not None:
        util.records_to(arrays, f"{case}/rec", rec)
    return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
            "params": jax.tree.map(np.asarray, new),
            "old": jax.tree.map(np.asarray, params),
            "grad_norm": float(om["grad_norm"])}


def _port_one(case, ref):
    """The port's one-rank run of each part of ``util.train_job``."""
    cfg = _cfg(case)
    glob = util._tree(ref, f"{case}/params")
    batch = {k: torch.from_numpy(ref[f"{case}/batch/{k}"])
             for k in ("tokens", "labels")}
    ocfg = OptConfig(**util.TRAIN_OPT)
    out = {}
    if cfg.quant is None:
        loss, _, grads = train.value_and_grad(
            lambda p, b: lm.lm_loss(p, b, cfg), glob, batch)
    else:
        with util.BlockReplay(*util.records_from(ref, f"{case}/rec")) as rep:
            loss, _, grads = train.value_and_grad(
                lambda p, b: lm.lm_loss(p, b, cfg), glob, batch)
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
    """(the ranks' outputs, JAX one-device, JAX sharded, the port's one-rank
    runs, the reference arrays)."""
    d = tmp_path_factory.mktemp("partition_train")
    ref = d / "ref.npz"
    rs = np.random.RandomState(11)
    arrays = {"ties/x": rs.randint(1 - util.TIES_RANGE, util.TIES_RANGE,
                                   util.TIES_SHAPE).astype(np.float32),
              "ties/c": (2.0 ** rs.randint(-3, 2, util.TIES_SHAPE[1]))
              .astype(np.float32)}
    with pytest.MonkeyPatch.context() as mp:
        jax_one = {case: _jax_one(case, arrays, mp)
                   for case in util.TRAIN_CASES}
    util.save(ref, arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    sharded = d / "sharded.npz"
    jlog = open(d / "jaxtrain.log", "w")
    jproc = subprocess.Popen([sys.executable, util.__file__, "jaxtrain",
                              str(ref), str(sharded)], stdout=jlog,
                             stderr=subprocess.STDOUT, env=env)
    procs = util.launch("train", 4, d, ref)
    try:
        loaded = util.load(ref)
        one = {case: _port_one(case, loaded) for case in util.TRAIN_CASES}
    finally:
        ranks = util.join(procs, d, "train", JOIN_S)
        try:
            jproc.wait(timeout=JOIN_S)
        finally:
            if jproc.poll() is None:
                jproc.kill()
                jproc.wait()
            jlog.close()
    assert jproc.returncode == 0, (d / "jaxtrain.log").read_text()[-3000:]
    return ranks, jax_one, util.load(sharded), one, loaded


CASE_MESH = [(c, m) for c in util.TRAIN_CASES for m in util.TRAIN_MESHES]


def _id(cm):
    return f"{cm[0]}-{util.mesh_tag(cm[1])}"


@pytest.mark.parametrize("tag", ["tensor", "column"])
def test_group_max_gradient_with_ties_is_jax_max(runs, tag):
    ranks, *_, ref = runs
    x = ref["ties/x"]
    c = ref["ties/c"]
    if tag == "tensor":
        amax = np.asarray(jax.numpy.max(jax.numpy.abs(x)))
        grad = np.asarray(jax.grad(lambda t: jax.numpy.max(
            jax.numpy.abs(t)))(x))
    else:
        amax = np.asarray(jax.numpy.max(jax.numpy.abs(x), axis=0))
        grad = np.asarray(jax.grad(lambda t: jax.numpy.sum(
            jax.numpy.max(jax.numpy.abs(t), axis=0) * c))(x))
    # the maxima tie within and across the ranks' blocks
    hits = np.abs(x) == (amax if tag == "tensor" else amax[None])
    assert hits.sum() > (x.shape[1] if tag == "column" else 4)
    rows, cols = x.shape[0] // 2, x.shape[1] // 2
    k = x.shape[0] // 4
    for rank, r in enumerate(ranks):
        if tag == "tensor":
            i, j = divmod(rank, 2)
            want = grad[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]
            np.testing.assert_array_equal(r["ties/tensor/amax"], amax)
        else:
            want = grad[rank * k:(rank + 1) * k]
            np.testing.assert_array_equal(r["ties/column/amax"][0], amax)
        np.testing.assert_array_equal(r[f"ties/{tag}/grad"], want)


@pytest.mark.parametrize("case,mesh", CASE_MESH, ids=map(_id, CASE_MESH))
def test_loss_and_gradients_on_jax_codes(runs, case, mesh):
    ranks, jax_one, _, one, _ = runs
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


@pytest.mark.parametrize("case", ["qwen-fake", "qwen-float"])
def test_loss_within_the_reference_bound_of_its_sharded_run(runs, case):
    ranks, jax_one, sharded, _, _ = runs
    want = float(sharded[f"{case}/loss"])
    assert abs(jax_one[case]["loss"] - want) <= 2e-5 * abs(want)
    for mesh in util.TRAIN_MESHES:
        for r in ranks:
            loss = float(r[f"{case}/{util.mesh_tag(mesh)}/replay/loss"])
            assert abs(loss - want) <= 2e-5 * abs(want)


@pytest.mark.parametrize("case,mesh", CASE_MESH, ids=map(_id, CASE_MESH))
def test_whole_leaves_have_one_gradient_on_every_rank(runs, case, mesh):
    ranks, jax_one, *_ = runs
    key = f"{case}/{util.mesh_tag(mesh)}/replay/grads"
    glob = util.flat(jax_one[case]["grads"])
    whole = [k for k, g in glob.items()
             if all(r[f"{key}/{k}"].shape == g.shape for r in ranks)]
    # the norms at least (and Llama's router)
    assert any("gamma" in k for k in whole)
    assert any("router" in k for k in whole) == case.startswith("llama")
    for k in whole:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{key}/{k}"],
                                          ranks[0][f"{key}/{k}"])


@pytest.mark.parametrize("case,mesh", CASE_MESH, ids=map(_id, CASE_MESH))
def test_one_lamb_step_on_jax_gradients(runs, case, mesh):
    ranks, jax_one, sharded, one, _ = runs
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
    # the moments and the experts at JAX's shard shapes (JAX's sharded run
    # is on (2, 2))
    for r in ranks:
        for k, v in util.flat(jax_one[case]["grads"]).items():
            mu = r[f"{key}/mu/{k}"].shape
            jmu = tuple(sharded[f"{case}/shard/mu/{k}"])
            if mesh == (2, 2):
                assert mu == jmu, (k, mu, jmu)
            if mesh == (2, 2) and "experts_" in k:
                assert r[f"{key}/opt/params/{k}"].shape == \
                    tuple(sharded[f"{case}/shard/params/{k}"]), k


@pytest.mark.parametrize("case,mesh", CASE_MESH, ids=map(_id, CASE_MESH))
def test_train_step_on_own_codes(runs, case, mesh):
    ranks, _, _, one, _ = runs
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
    old = util._tree(runs[4], f"{case}/params")
    for (k, g), (_, o) in zip(tree_lib.leaves_with_keys(got),
                              tree_lib.leaves_with_keys(old)):
        assert bool(torch.isfinite(g).all()) and not torch.equal(g, o), k
    if cfg.quant is None:
        util.close_leaves(got, params, 1e-5, "float step")


@pytest.mark.parametrize("case,mesh", [cm for cm in CASE_MESH
                                       if cm[0] in FAKE],
                         ids=map(_id, [cm for cm in CASE_MESH
                                       if cm[0] in FAKE]))
def test_local_integerization_serves_as_the_gathered_tree(runs, case, mesh):
    ranks = runs[0]
    cfg = _cfg(case)
    key = f"{case}/{util.mesh_tag(mesh)}"
    trained = util.gathered(ranks, mesh, f"{key}/step/params", cfg)
    qc = QuantConfig(**util.TRAIN_SERVE)
    icfg = cfg.replace(quant=qc)
    whole = integerize_params(trained, qc)
    logits, fed = util.serve_steps(whole, util.batch_of(runs[4], case),
                                   icfg)
    for layout, r in zip(util.train_layouts(ranks, mesh, fsdp=False), ranks):
        assert r[f"{key}/int_contiguous"]
        want = partition.partition_params(whole, icfg, layout)
        for k, v in util.flat(want).items():
            np.testing.assert_array_equal(r[f"{key}/int/{k}"], v.numpy(), k)
        np.testing.assert_array_equal(r[f"{key}/serve/logits"],
                                      logits.numpy())
        np.testing.assert_array_equal(r[f"{key}/serve/fed"], fed.numpy())


def test_recurrent_whisper_and_engine_still_refuse(runs):
    for r in runs[0]:
        refused = {k: bool(v) for k, v in r.items()
                   if k.startswith("refused/")}
        assert len(refused) == 4 and all(refused.values()), refused

