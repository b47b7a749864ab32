"""Norm layers (float path), in PyTorch.  Counterpart of
``repro/layers/norms.py``."""
from __future__ import annotations

import torch


def layernorm(x, gamma, beta, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def rmsnorm(x, gamma, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    ms = xf.square().mean(dim=-1, keepdim=True)
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
