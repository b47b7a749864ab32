"""The port's training stack held against the JAX package: the optimizer,
the synthetic data, checkpoints, the training loop and the QAT example.

- ``opt_update`` (LAMB and AdamW, with the global-norm clip and weight
  decay; f32 and bf16 leaves) one and three steps against JAX's: params
  within 2e-6 of their max and the moments within 1e-5 (per-leaf f32 sums
  in another order, XLA's fused multiply-adds, and ``cos`` / ``pow`` from
  other libraries move the last bits), the step counter exact;
  ``cosine_schedule`` at warm-up, middle and end within 1e-6.
- The reference's own properties (``tests/test_optim.py``,
  ``test_data.py``, ``test_checkpoint.py``, ``test_train_loop.py``), each
  on the port: descent on a quadratic, the trust ratio's scale invariance,
  the clip's norm, f32 state; batches deterministic per step, steps and
  shards disjoint, labels the next tokens, an iterator that replays on
  restart, learnable images; checkpoint round trips bitwise, an empty
  directory, keep-k, a partial write invisible, the newest step wins, a
  given step; QAT loss descends, a restart is bit-exact, preemption saves
  and exits 42, the head-only phase freezes every other leaf bitwise.
- A checkpoint written by ``repro.runtime.checkpoint.save`` (a bf16 leaf
  among f32 and int32 ones) restores into the port bit for bit.
- Two steps of ``make_train_step`` (fake w4/a8/attn7, LAMB) against the
  reference's (compiled) on the same params and batches, at eight seeds:
  losses within 1e-6, params within 1e-5 of their max, the port on JAX's
  fake-quant values and ``exp2_shift`` kinks, every code its own forward
  would have taken otherwise at a rounding edge (``tests/test_torch_qat.py``
  says why; without the replay, the losses differ by 7e-6 to 8e-4 and the
  params by 3e-4 to 1e-3 at seeds with such a code).
- ``train_cifar_qat.main`` on the CPU, two steps, prints its three
  accuracies.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_qat_util import (JaxReplay, edge_flips, f32,
                             jax_fake_quant_records, rel, to_port)
from repro.core.api import QuantConfig as JQuantConfig
from repro.data import synthetic as jsynthetic
from repro.kernels import dispatch as jdispatch
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import optimizers as joptim
from repro.runtime import checkpoint as jcheckpoint
from repro_torch import tree as tree_lib
from repro_torch.core.api import QuantConfig
from repro_torch.data.synthetic import (DataConfig, host_shard_iterator,
                                        image_batch, lm_batch)
from repro_torch.examples import train_cifar_qat
from repro_torch.kernels import dispatch
from repro_torch.launch.train import TrainConfig, make_train_step, train
from repro_torch.models import lm
from repro_torch.optim import (OptConfig, cosine_schedule, init_opt_state,
                               opt_update)
from repro_torch.runtime import checkpoint, preemption

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def _equal_trees(a, b):
    la, lb = tree_lib.leaves_with_paths(a), tree_lib.leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    rs = np.random.RandomState(seed)
    return {"lin": {"w": rs.randn(8, 4).astype(np.float32),
                    "b": rs.randn(4).astype(np.float32) * 0.1},
            "emb": {"emb": rs.randn(6, 8).astype(np.float32)},
            "zero": {"w": np.zeros((3,), np.float32)}}


@pytest.mark.parametrize("kind,wd,clip", [("lamb", 0.0, 1.0),
                                          ("lamb", 0.01, None),
                                          ("adamw", 0.01, 1.0),
                                          ("adamw", 0.0, 0.5)])
@pytest.mark.parametrize("steps", [1, 3])
def test_opt_update_matches_jax(kind, wd, clip, steps):
    cfg = dict(kind=kind, lr=1e-2, weight_decay=wd, grad_clip=clip,
               warmup_steps=2, total_steps=10)
    jcfg, tcfg = joptim.OptConfig(**cfg), OptConfig(**cfg)
    np_params = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, np_params)
    jp["emb"]["emb"] = jp["emb"]["emb"].astype(jnp.bfloat16)
    tp = to_port(jp)
    jstate, tstate = joptim.init_opt_state(jp), init_opt_state(tp)
    for i in range(steps):
        g = _opt_tree(10 + i)
        g["zero"]["w"][:] = 0.0
        jg = jax.tree.map(lambda a: jnp.asarray(a) * 3.0, g)
        jg["emb"]["emb"] = jg["emb"]["emb"].astype(jnp.bfloat16)
        jp, jstate, jm = joptim.opt_update(jp, jg, jstate, jcfg)
        tp, tstate, tm = opt_update(tp, to_port(jg), tstate, tcfg)
        assert rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert rel(tm["lr"], jm["lr"]) <= 1e-6
    assert tp["emb"]["emb"].dtype == torch.bfloat16
    assert int(tstate["step"]) == int(jstate["step"]) == steps
    assert tstate["step"].dtype == torch.int32
    for (path, got), (_, want) in zip(tree_lib.leaves_with_paths(tp),
                                      tree_lib.leaves_with_paths(
                                          jax.tree.map(f32, jp))):
        tol = 1e-2 if got.dtype == torch.bfloat16 else 2e-6  # one bf16 ulp
        assert rel(got, want) <= tol, path
    for key in ("mu", "nu"):
        for (path, got), (_, want) in zip(
                tree_lib.leaves_with_paths(tstate[key]),
                tree_lib.leaves_with_paths(jax.tree.map(f32, jstate[key]))):
            assert got.dtype == torch.float32
            assert rel(got, want) <= 1e-5, (key, path)


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 140])
def test_cosine_schedule_matches_jax(step):
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = float(joptim.cosine_schedule(step, joptim.OptConfig(**cfg)))
    got = cosine_schedule(step, OptConfig(**cfg))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("kind", ["lamb", "adamw"])
def test_optimizer_descends_quadratic(kind):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"lin": {"w": torch.zeros(3)}}
    cfg = OptConfig(kind=kind, lr=0.1, warmup_steps=0, total_steps=200,
                    grad_clip=None)
    state = init_opt_state(params)

    def loss(p):
        return torch.sum((p["lin"]["w"] - target) ** 2)

    l0 = float(loss(params))
    for _ in range(100):
        g = {"lin": {"w": 2 * (params["lin"]["w"] - target)}}
        params, state, _ = opt_update(params, g, state, cfg)
    assert float(loss(params)) < 0.05 * l0


def test_lamb_trust_ratio_scale_invariance():
    """LAMB normalizes per leaf: the step is ||w|| * lr, whatever ||g||."""
    cfg = OptConfig(kind="lamb", lr=0.1, warmup_steps=0, grad_clip=None)
    for scale in (1.0, 1000.0):
        params = {"a": {"w": torch.ones(4) * 2.0}}
        before = params["a"]["w"].clone()
        state = init_opt_state(params)
        new, _, _ = opt_update(params, {"a": {"w": torch.ones(4) * scale}},
                               state, cfg)
        delta = float(torch.linalg.vector_norm(new["a"]["w"] - before))
        np.testing.assert_allclose(delta, 0.1 * 4.0, rtol=1e-4)


def test_grad_clip_and_f32_state():
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = init_opt_state(params)
    assert state["mu"]["w"].dtype == torch.float32   # master stats in f32
    assert state["step"].dtype == torch.int32 and state["step"].ndim == 0
    cfg = OptConfig(kind="adamw", lr=0.0, grad_clip=1.0, warmup_steps=0)
    _, _, m = opt_update(params, {"w": torch.full((4,), 100.0)}, state, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

DCFG_DATA = DataConfig(vocab=1000, seq_len=64, global_batch=8)


def test_data_deterministic_and_distinct():
    a, b = lm_batch(DCFG_DATA, 5), lm_batch(DCFG_DATA, 5)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int32
    assert not torch.equal(lm_batch(DCFG_DATA, 1)["tokens"],
                           lm_batch(DCFG_DATA, 2)["tokens"])
    s0 = lm_batch(DCFG_DATA, 3, shard=0, n_shards=4)
    s1 = lm_batch(DCFG_DATA, 3, shard=1, n_shards=4)
    assert s0["tokens"].shape == (2, 64)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    # tokens[t+1] == labels[t] by construction
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 1000


def test_data_iterator_restart_replays():
    it1 = host_shard_iterator(DCFG_DATA, 10)
    it2 = host_shard_iterator(DCFG_DATA, 10)
    for step in range(10, 13):
        a, b = next(it1), next(it2)
        assert torch.equal(a["tokens"], b["tokens"])
        assert torch.equal(a["tokens"], lm_batch(DCFG_DATA, step)["tokens"])


def test_image_batch_learnable_structure():
    a = image_batch(0, batch=64, img=16)
    assert a["images"].shape == (64, 16, 16, 3)
    assert float(a["images"].abs().max()) <= 1.0
    imgs, labels = a["images"].numpy(), a["labels"].numpy()
    same, diff = [], []
    for i in range(20):
        for j in range(i + 1, 20):
            d = np.mean((imgs[i] - imgs[j]) ** 2)
            (same if labels[i] == labels[j] else diff).append(d)
    assert same and diff and np.mean(same) < np.mean(diff)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"lin": {"w": torch.randn(8, 4, generator=g),
                               "b": torch.zeros(4),
                               "h": torch.randn(3, generator=g).to(
                                   torch.bfloat16)}},
            "opt": {"mu": {"lin": {"w": torch.ones(8, 4)}},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_bit_exact(tmp_path):
    d = str(tmp_path)
    tree = _ckpt_tree()
    checkpoint.save(d, 10, tree)
    restored, step = checkpoint.restore(d, tree)
    assert step == 10
    _equal_trees(tree, restored)
    assert restored["opt"]["step"].ndim == 0


def test_checkpoint_empty_keep_partial_latest_specific(tmp_path):
    assert checkpoint.restore(str(tmp_path / "none"), _ckpt_tree()) == \
        (None, -1)
    d = str(tmp_path / "k")
    for s in range(6):
        checkpoint.save(d, s, _ckpt_tree(s), keep=2)
    assert checkpoint.available_steps(d) == [4, 5]
    # a .tmp dir (a crash mid-write) is not a checkpoint
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    with open(os.path.join(d, "step_00000009.tmp", "proc_0.npz"), "w") as f:
        f.write("garbage")
    restored, step = checkpoint.restore(d, _ckpt_tree())
    assert step == 5
    _equal_trees(restored, _ckpt_tree(5))
    t4, s4 = checkpoint.restore(d, _ckpt_tree(), step=4)
    assert s4 == 4
    _equal_trees(t4, _ckpt_tree(4))


def test_checkpoint_written_by_jax_restores_bitwise(tmp_path):
    d = str(tmp_path)
    k = jax.random.PRNGKey(3)
    jtree = {"params": {"lin": {"w": jax.random.normal(k, (8, 4)),
                                "h": jax.random.normal(k, (5, 3)).astype(
                                    jnp.bfloat16)},
                        "emb": {"emb": jnp.arange(6, dtype=jnp.float32)}},
             "opt": {"step": jnp.asarray(11, jnp.int32)}}
    jcheckpoint.save(d, 11, jtree, keep=3)
    like = to_port(jtree)
    restored, step = checkpoint.restore(d, like)
    assert step == 11
    assert restored["params"]["lin"]["h"].dtype == torch.bfloat16
    _equal_trees(like, restored)
    # and back: the port writes the reference's names, dtypes and layout
    checkpoint.save(str(tmp_path / "port"), 11, restored)
    again, _ = checkpoint.restore(str(tmp_path / "port"), like)
    _equal_trees(like, again)


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

FQ = dict(w_bits=4, a_bits=8, attn_bits=7, mode="fake")
CFG = lm.LMConfig(name="tiny", n_layers=2, d_model=32, n_heads=2, kv_heads=2,
                  d_ff=64, vocab=64, dtype="float32", q_chunk=16, remat=False,
                  quant=QuantConfig(**FQ))
DCFG = DataConfig(vocab=64, seq_len=32, global_batch=4)
OCFG = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60, kind="lamb")
TRAIN_SEEDS = tuple(range(8))


def test_qat_loss_descends():
    params = lm.init_params(CFG, seed=0, device="cpu")
    step = make_train_step(CFG, OCFG)
    opt = init_opt_state(params)
    losses = []
    for i in range(40):
        params, opt, m = step(params, opt, lm_batch(DCFG, i))
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_restart_bit_exact(tmp_path):
    """Interrupt at step 20 of 30 and resume: the final params equal the
    uninterrupted run's exactly (checkpoint + deterministic data)."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    p_full, _, _, _ = train(
        CFG, TrainConfig(steps=30, ckpt_every=10, ckpt_dir=d1), OCFG, DCFG,
        verbose=False, device="cpu")
    train(CFG, TrainConfig(steps=20, ckpt_every=10, ckpt_dir=d2), OCFG, DCFG,
          verbose=False, device="cpu")
    p_resumed, opt, _, last = train(
        CFG, TrainConfig(steps=30, ckpt_every=10, ckpt_dir=d2), OCFG, DCFG,
        verbose=False, device="cpu")
    assert last == 29 and int(opt["step"]) == 30
    _equal_trees(p_full, p_resumed)


def test_preemption_checkpoints_and_exits(tmp_path):
    d = str(tmp_path)
    preemption.reset()
    preemption._FLAG["stop"] = True      # simulate SIGTERM delivery
    try:
        with pytest.raises(SystemExit) as e:
            train(CFG, TrainConfig(steps=30, ckpt_every=100, ckpt_dir=d),
                  OCFG, DCFG, verbose=False, device="cpu")
    finally:
        preemption.reset()
    assert e.value.code == preemption.PREEMPTED_EXIT_CODE == 42
    assert checkpoint.available_steps(d) == [0]   # saved before exiting


def test_two_phase_last_layer_freeze():
    """Paper phase 1: only the lm_head moves; every other leaf is bitwise
    unchanged."""
    params = lm.init_params(CFG, seed=0, device="cpu")
    before = tree_lib.tree_map(torch.clone, params)
    step = make_train_step(CFG, OCFG, last_layer_only=True)
    new, _, _ = step(params, init_opt_state(params), lm_batch(DCFG, 0))
    for path, leaf in tree_lib.leaves_with_paths(new):
        old = dict(tree_lib.leaves_with_paths(before))[path]
        if "lm_head" in path:
            assert float((leaf - old).abs().max()) > 0, path
        else:
            assert torch.equal(leaf, old), path


def test_train_step_matches_jax_two_steps(monkeypatch):
    for seed in TRAIN_SEEDS:
        flips, kinks = _two_steps_against_jax(seed, monkeypatch)
        print(f"seed {seed}: {flips} fake-quant flips, {kinks} exp2 kinks "
              f"at edges")


@functools.lru_cache(maxsize=None)
def _jax_train_step(jcfg, jocfg):
    """The reference's step, compiled once for every seed."""
    return jax.jit(jtrain.make_train_step(jcfg, jocfg))


def _two_steps_against_jax(seed, monkeypatch):
    jcfg = jlm.LMConfig(name="tiny", n_layers=2, d_model=32, n_heads=2,
                        kv_heads=2, d_ff=64, vocab=64, dtype="float32",
                        q_chunk=16, remat=False, quant=JQuantConfig(**FQ))
    jocfg = joptim.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                             kind="lamb")
    jdcfg = jsynthetic.DataConfig(vocab=64, seq_len=32, global_batch=4,
                                  seed=seed)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = to_port(jp)
    jopt, topt = joptim.init_opt_state(jp), init_opt_state(tp)
    jfull = _jax_train_step(jcfg, jocfg)
    tfull = make_train_step(CFG, OCFG)
    flips = kinks = 0
    for i in range(2):
        jb = jsynthetic.lm_batch(jdcfg, i)          # JAX's batch, via numpy
        tb = to_port(jb)
        with jax_fake_quant_records(monkeypatch) as jrec:
            jp, jopt, jm = jfull(jp, jopt, jb)
            jax.block_until_ready(jp)
        with JaxReplay(jrec) as rep:
            tp, topt, tm = tfull(tp, topt, tb)
        flips += edge_flips(rep.matched, rep.calls)
        kinks += rep.kinks
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-6 * abs(float(jm["loss"])), seed
    want = dict(tree_lib.leaves_with_paths(jax.tree.map(f32, jp)))
    for path, got in tree_lib.leaves_with_paths(tp):
        assert rel(got, want[path]) <= 1e-5, (seed, path)
    return flips, kinks


def test_train_cifar_qat_example_runs_small(capsys):
    out = train_cifar_qat.main(["--steps", "2", "--last-layer-steps", "1",
                                "--batch", "16", "--device", "cpu"])
    text = capsys.readouterr().out
    for line in ("float inference of QAT weights", "fake-quant (QAT graph)",
                 "integerized (int-only graph)", "|int - qat| ="):
        assert line in text
    assert set(out) == {"acc_float", "acc_qat", "acc_int"}
    assert all(0.0 <= v <= 1.0 for v in out.values())
