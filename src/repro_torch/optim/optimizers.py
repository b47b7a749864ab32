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


def init_opt_state(params) -> dict:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    first = tree_lib.leaves(params)[0]
    return {"mu": tree_lib.tree_map(zeros, params),
            "nu": tree_lib.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _global_norm(flat) -> torch.Tensor:
    total = 0
    for g in flat:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _update_leaf(p, g32, mu, nu, lr, c1, c2, cfg: OptConfig):
    mu.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    t = g32 * (1 - cfg.b2)
    nu.mul_(cfg.b2).add_(t.mul_(g32))
    del t
    den = (nu / c2).sqrt_().add_(cfg.eps)
    u = (mu / c1).div_(den)
    del den
    p32 = p.to(torch.float32)
    if cfg.weight_decay:
        u.add_(p32 * cfg.weight_decay)
    if cfg.kind == "lamb":
        wn = torch.sqrt(torch.sum(torch.square(p32)))
        un = torch.sqrt(torch.sum(torch.square(u)))
        trust = torch.where((wn > 0) & (un > 0), wn / un, 1.0)
        u.mul_(trust)
    p.copy_((p32 - u.mul_(lr)).to(p.dtype))


def opt_update(params, grads, state, cfg: OptConfig):
    """One optimizer step; returns (params, state, metrics), the params and
    the state updated in place."""
    flat_p = tree_lib.leaves(params)
    flat_g = tree_lib.leaves(grads)
    flat_mu = tree_lib.leaves(state["mu"])
    flat_nu = tree_lib.leaves(state["nu"])
    with torch.no_grad():
        step = state["step"] + 1
        lr = cosine_schedule(step, cfg)
        gnorm = _global_norm(flat_g)
        scale = None
        if cfg.grad_clip is not None:
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        stepf = step.to(torch.float32)
        c1 = 1 - cfg.b1 ** stepf
        c2 = 1 - cfg.b2 ** stepf
        for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu):
            g32 = g.to(torch.float32)
            if scale is not None:
                g32 = g32 * scale
            _update_leaf(p, g32, mu, nu, lr, c1, c2, cfg)
        state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
