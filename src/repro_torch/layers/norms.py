"""Norm layers (float path), in PyTorch.  Counterpart of
``repro/layers/norms.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ROWS = 16     # torch's CUDA row reduction keeps one block shape from here up


def _mean(t):
    """``t.mean(-1, keepdim=True)``, each row the same bits whatever the
    number of rows.  Below 16 rows torch's CUDA reduction widens its
    thread block as the rows get fewer, so a row sums in another order at
    4 rows than at 8 (a partitioned rank's rows against the one-rank
    batch); from 16 rows up its block stays 32 x 16 (rows of up to 32768
    elements).  So fewer rows are zero-padded to 16 on the card."""
    rows = t.numel() // t.shape[-1]
    if t.device.type != "cuda" or rows >= ROWS:
        return t.mean(dim=-1, keepdim=True)
    flat = F.pad(t.reshape(rows, t.shape[-1]), (0, 0, 0, ROWS - rows))
    return flat.mean(dim=-1, keepdim=True)[:rows].reshape(*t.shape[:-1], 1)


def layernorm(x, gamma, beta, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    mean = _mean(xf)
    var = _mean((xf - mean).square())
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def rmsnorm(x, gamma, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    ms = _mean(xf.square())
    return (xf * torch.rsqrt(ms + eps) * gamma).to(x.dtype)


def apply_norm(x, p: dict, kind: str, *, eps: float = 1e-6):
    if kind == "layernorm":
        return layernorm(x, p["gamma"], p["beta"], eps=eps)
    if kind == "rmsnorm":
        return rmsnorm(x, p["gamma"], eps=eps)
    raise ValueError(kind)


def init_norm(d: int, kind: str, *, device="cuda") -> dict:
    p = {"gamma": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["beta"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p
