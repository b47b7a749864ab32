"""LAMB (the paper's optimizer) and AdamW, plus the cosine-annealing
schedule of the paper's two-phase QAT recipe — in PyTorch.

Counterpart of ``repro/optim/optimizers.py``: plain functions over the
parameter tree, leaves in sorted key order (:mod:`repro_torch.tree`), as
``jax.tree_util`` walks them.  The optimizer state is f32 ``mu`` / ``nu``
shaped like the params and a 0-d int32 ``step``.  One step: the global
gradient norm (an f32 sum of per-leaf sums), the global-norm clip, then
per leaf the Adam moments, AdamW's decay and LAMB's whole-tensor trust
ratio, the update in f32 cast back to the param's dtype.

Where JAX returns new trees, :func:`opt_update` writes the params and the
state in place under ``torch.no_grad()`` (and returns them), one leaf at a
time, so the card's memory holds a few leaf-sized temporaries beyond the
params, grads and moments.  Each in-place operation rounds as the
reference's expression does (one product or sum a step; no fused
multiply-add).  A bf16 gradient times the 0-d f32 clip scale is f32, as
in JAX (torch would keep bf16 for a 0-d operand).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "lamb"            # "lamb" | "adamw"
    lr: float = 5e-4              # paper: base LR 5e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.0     # paper: LAMB without weight decay
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.01


def cosine_schedule(step, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int tensor): linear
    warm-up, then cosine down to ``min_lr_frac`` of ``lr``; f32."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(params, shards=None) -> dict:
    """Zero moments shaped like ``params``; with ``shards`` (this rank's
    ``distributed/partition.py::opt_shards``) each leaf's ZeRO-1 block."""
    flat = tree_lib.leaves(params)
    if shards is not None:
        flat = [sh.part(p) for p, sh in zip(flat, shards)]

    def zeros():
        return tree_lib.unflatten(params, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in flat])

    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}


def _global_norm(flat, squared: bool = False) -> torch.Tensor:
    """The f32 norm of every leaf of ``flat`` (``squared``: each leaf's
    sum of squares given), summed leaf by leaf in order."""
    total = 0
    for g in flat:
        total = total + (g if squared else _sq(g.to(torch.float32)))
    return torch.sqrt(total)


def _moments(g32, mu, nu, cfg: OptConfig):
    mu.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    t = g32 * (1 - cfg.b2)
    nu.mul_(cfg.b2).add_(t.mul_(g32))


def _direction(p32, mu, nu, c1, c2, cfg: OptConfig):
    den = (nu / c2).sqrt_().add_(cfg.eps)
    u = (mu / c1).div_(den)
    del den
    if cfg.weight_decay:
        u.add_(p32 * cfg.weight_decay)
    return u


def _sq(t):
    return torch.sum(torch.square(t))


def _apply(p, p32, u, wn2, un2, lr, cfg: OptConfig):
    """The update of ``p`` (in place; returns it), LAMB's trust ratio from
    the squared norms ``wn2`` / ``un2`` of the whole leaf."""
    if cfg.kind == "lamb":
        wn, un = torch.sqrt(wn2), torch.sqrt(un2)
        trust = torch.where((wn > 0) & (un > 0), wn / un, 1.0)
        u.mul_(trust)
    return p.copy_((p32 - u.mul_(lr)).to(p.dtype))


def _update_leaf(p, g32, mu, nu, lr, c1, c2, cfg: OptConfig):
    _moments(g32, mu, nu, cfg)
    p32 = p.to(torch.float32)
    u = _direction(p32, mu, nu, c1, c2, cfg)
    _apply(p, p32, u, _sq(p32), _sq(u), lr, cfg)


def _update_shards(flat_p, flat_g, flat_mu, flat_nu, shards, scale, lr, c1,
                   c2, cfg: OptConfig):
    """The per-leaf updates on this rank's ZeRO-1 blocks: moments and
    direction on the block, LAMB's norms summed over the ranks holding the
    rest of the leaf, then each block's update gathered back over
    "data"."""
    from repro_torch.distributed import partition
    norms = []
    for p, g, mu, nu, sh in zip(flat_p, flat_g, flat_mu, flat_nu, shards):
        g32 = sh.part(g).to(torch.float32)
        if scale is not None:
            g32 = g32 * scale
        _moments(g32, mu, nu, cfg)
        del g32
        p32 = sh.part(p).to(torch.float32)
        norms.append(torch.stack([_sq(p32), _sq(_direction(
            p32, mu, nu, c1, c2, cfg))]))
    norms = partition.leaf_sums(norms, shards)
    for p, mu, nu, sh, n2 in zip(flat_p, flat_mu, flat_nu, shards, norms):
        blk = sh.part(p)
        p32 = blk.to(torch.float32)
        # the block's update, recomputed as the norms saw it
        new = _apply(torch.empty_like(blk), p32,
                     _direction(p32, mu, nu, c1, c2, cfg), n2[0], n2[1],
                     lr, cfg)
        p.copy_(partition.gather_slice(new, sh))


def opt_update(params, grads, state, cfg: OptConfig, *, shards=None):
    """One optimizer step; returns (params, state, metrics), the params and
    the state updated in place.

    ``shards`` (``distributed/partition.py::opt_shards``, under partitioned
    rules): ``params`` and ``grads`` are this rank's leaves and ``state``
    its ZeRO-1 moments (:func:`init_opt_state`).  Each rank updates its
    block of each leaf and gathers the leaf back over "data"; the global
    gradient norm and LAMB's two norms sum over the ranks that hold the
    rest of each leaf, so each element counts once."""
    flat_p = tree_lib.leaves(params)
    flat_g = tree_lib.leaves(grads)
    flat_mu = tree_lib.leaves(state["mu"])
    flat_nu = tree_lib.leaves(state["nu"])
    with torch.no_grad():
        step = state["step"] + 1
        lr = cosine_schedule(step, cfg)
        if shards is None:
            gnorm = _global_norm(flat_g)
        else:
            from repro_torch.distributed import partition
            gnorm = _global_norm(partition.leaf_sums(
                [_sq(sh.part(g).to(torch.float32))
                 for g, sh in zip(flat_g, shards)], shards), squared=True)
        scale = None
        if cfg.grad_clip is not None:
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        stepf = step.to(torch.float32)
        c1 = 1 - cfg.b1 ** stepf
        c2 = 1 - cfg.b2 ** stepf
        if shards is not None:
            _update_shards(flat_p, flat_g, flat_mu, flat_nu, shards, scale,
                           lr, c1, c2, cfg)
        else:
            for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu):
                g32 = g.to(torch.float32)
                if scale is not None:
                    g32 = g32 * scale
                _update_leaf(p, g32, mu, nu, lr, c1, c2, cfg)
        state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
