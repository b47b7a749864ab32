"""Training entry point: QAT fine-tuning loop with fault tolerance, in PyTorch.

Counterpart of ``repro/launch/train.py``.  The paper's two-phase recipe
(§V-A): a last-layer phase (only the head trains), then full fine-tuning,
LAMB + cosine, on the fake-quantized graph (``QuantConfig(mode="fake")``:
STE and LSQ gradients through autograd, float matmuls; no Pallas kernel
runs in the reference's training graph, so none runs here).  The loop
restores the newest checkpoint and replays the data from there, saves
every ``ckpt_every`` steps, times steps with the straggler watchdog, and on
SIGTERM / SIGUSR1 saves and exits with ``PREEMPTED_EXIT_CODE`` (42).

Determinism: a training step runs under
``torch.use_deterministic_algorithms(True)`` (:func:`deterministic`), with
``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts where the caller has
not set it.  On the card the backward of an index or a gather (the
embedding lookup, the loss's gold logits, MoE's slot writes) would
otherwise accumulate with atomics in any order, and a resumed run would
differ from an uninterrupted one in the last bit; in this mode torch takes
its sorted, ordered kernels for them, so a restart is bitwise.  The mode's
fill of every new allocation with NaN
(``torch.utils.deterministic.fill_uninitialized_memory``) is turned off
for the step: no op of the step reads memory it has not written, so the
fill would only cost a launch per allocation.

    python -m repro_torch.launch.train [--arch qwen2.5-32b] [--device cpu]

runs on the card unless ``--device cpu`` is given; with no card it
raises.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.registry import is_encdec
from repro_torch.core.api import QuantConfig
from repro_torch.data.synthetic import DataConfig, lm_batch
from repro_torch.models import encdec, lm
from repro_torch.optim import OptConfig, init_opt_state, opt_update
from repro_torch.runtime import checkpoint, preemption
from repro_torch.runtime.watchdog import Watchdog


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep: int = 3
    last_layer_frac: float = 0.0   # phase 1 fraction (paper: separate phase)
    log_every: int = 10


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises
    (the entry points never carry on on the CPU unless asked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return dev


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the block, without the NaN fill of new
    allocations (both restored after)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(prev, warn_only=warn_only)


def value_and_grad(loss_fn, params, batch, *, only: str | None = None,
                   shards=None):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``; with ``only``, every gradient but those whose leaf path
    holds ``only`` is zero (autograd computes only the others).

    ``shards`` (``distributed/partition.py::opt_shards``, under
    partitioned rules): ``params`` is this rank's tree, and each rank's
    part of each gradient (from its own rows) is summed over the batch
    axes (``partition.reduce_grads``), so every rank holds the gradient
    of its leaves' blocks."""
    named = tree_lib.leaves_with_paths(params)
    want = [i for i, (path, _) in enumerate(named)
            if only is None or only in path]
    for i in want:
        named[i][1].requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, batch)
        got = dict(zip(want, torch.autograd.grad(
            loss, [named[i][1] for i in want], allow_unused=True)))
    finally:
        for i in want:
            named[i][1].requires_grad_(False)
    grads = tree_lib.unflatten(params, [
        torch.zeros_like(leaf) if got.get(i) is None else got[i]
        for i, (_, leaf) in enumerate(named)])
    del got
    if shards is not None:
        from repro_torch.distributed import partition
        grads = partition.reduce_grads(grads, shards)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_step(loss_fn, ocfg: OptConfig, *, only: str | None = None,
              cfg=None):
    """A training step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for ``loss_fn(params, batch) -> (loss, metrics)``.  With
    ``only``, every gradient but those whose leaf path holds ``only`` is
    zero (the paper's phase 1; the zero gradients still go through the
    optimizer, as the reference's do).  The params and state are updated
    in place.  Under partitioned rules (``cfg``: the model's config, which
    says how its tree splits) the params are the rank's tree and the state
    its ZeRO-1 moments (``optim.init_opt_state(params,
    partition.opt_shards(params, cfg))``), as the reference's train cell
    shards them (``launch/dryrun.py``)."""
    def train_step(params, opt_state, batch):
        from repro_torch.distributed import partition
        shards = partition.opt_shards(params, cfg) if cfg is not None \
            else None
        with deterministic():
            loss, metrics, grads = value_and_grad(loss_fn, params, batch,
                                                  only=only, shards=shards)
            params, opt_state, om = opt_update(params, grads, opt_state,
                                               ocfg, shards=shards)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def model_loss(cfg):
    """The loss the reference's train cell takes for ``cfg``'s model
    (``launch/dryrun.py``), as ``(params, batch) -> (loss, metrics)``:
    :func:`repro_torch.models.encdec.loss_fn` for the encoder-decoder
    family (``configs/registry.py::is_encdec``), else
    :func:`repro_torch.models.lm.lm_loss`."""
    fn = encdec.loss_fn if is_encdec(cfg) else lm.lm_loss
    return lambda params, batch: fn(params, batch, cfg)


def make_train_step(cfg, ocfg: OptConfig, *, last_layer_only: bool = False):
    """The training step of ``cfg``'s model on :func:`model_loss`;
    ``last_layer_only`` keeps only the gradients whose path holds
    ``lm_head``.  Runs partitioned under ``Rules(partitioned=True)``
    (modes "float" and "fake"; :func:`make_step`)."""
    return make_step(model_loss(cfg), ocfg,
                     only="lm_head" if last_layer_only else None, cfg=cfg)


def train(cfg: lm.LMConfig, tcfg: TrainConfig, ocfg: OptConfig,
          dcfg: DataConfig, *, params=None, verbose: bool = True,
          device="cuda"):
    """Returns (params, opt_state, last_metrics, last step).  ``params``
    default to ``lm.init_params(cfg, seed=dcfg.seed)`` on ``device``."""
    previous = preemption.install()
    try:
        return _train(cfg, tcfg, ocfg, dcfg, params, verbose,
                      require_device(device))
    finally:
        preemption.restore(previous)


def _train(cfg, tcfg, ocfg, dcfg, params, verbose, device):
    wd = Watchdog()
    if params is None:
        params = lm.init_params(cfg, seed=dcfg.seed, device=device)
    device = tree_lib.leaves(params)[0].device
    state = {"params": params, "opt": init_opt_state(params)}
    restored, step0 = checkpoint.restore(tcfg.ckpt_dir, state)
    if restored is not None:
        state = restored
        if verbose:
            print(f"[train] resumed from step {step0}")
    start = step0 + 1 if step0 >= 0 else 0

    n_last = int(tcfg.steps * tcfg.last_layer_frac)
    step_last = make_train_step(cfg, ocfg, last_layer_only=True)
    step_full = make_train_step(cfg, ocfg)

    metrics = {}
    step = start
    for step in range(start, tcfg.steps):
        wd.start()
        batch = lm_batch(dcfg, step, device=device)
        fn = step_last if step < n_last else step_full
        params, opt_state, metrics = fn(state["params"], state["opt"], batch)
        state = {"params": params, "opt": opt_state}
        wd.stop()

        if verbose and step % tcfg.log_every == 0:
            print(f"[train] step {step} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e}")
        if (step + 1) % tcfg.ckpt_every == 0 or step == tcfg.steps - 1:
            checkpoint.save(tcfg.ckpt_dir, step, state, keep=tcfg.keep)
        if preemption.should_stop():
            checkpoint.save(tcfg.ckpt_dir, step, state, keep=tcfg.keep)
            if verbose:
                print(f"[train] preempted at step {step}; checkpointed")
            sys.exit(preemption.PREEMPTED_EXIT_CODE)

    return state["params"], state["opt"], metrics, step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="registry arch (its SMOKE config; default "
                         "qwen2.5-32b)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--wbits", type=int, default=4)
    ap.add_argument("--abits", type=int, default=8)
    ap.add_argument("--ckpt", default=_default_ckpt_dir())
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import smoke_config
    cfg = smoke_config(args.arch or "qwen2.5-32b")
    cfg = cfg.replace(quant=QuantConfig(w_bits=args.wbits, a_bits=args.abits,
                                        mode="fake"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    ocfg = OptConfig(total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt)
    return train(cfg, tcfg, ocfg, dcfg, device=args.device)


if __name__ == "__main__":
    main()
