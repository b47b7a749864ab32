"""Rotary position embeddings (interleaved-pair layout), in PyTorch.

Counterpart of ``repro/layers/rope.py``.
"""
from __future__ import annotations

import torch


def _rope_angles(positions, dim: int, theta: float):
    """positions (..., S) -> cos/sin of shape (..., S, dim//2), f32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def _rotate_half_pairs(x, cos, sin):
    """Rotate interleaved pairs (x0,x1),(x2,x3),..."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def apply_rope(x, positions, *, theta: float = 10000.0,
               rotary_frac: float = 1.0):
    """Apply RoPE to ``x`` (B, H, S, D) at ``positions`` (B, S)."""
    d = x.shape[-1]
    rd = int(d * rotary_frac)
    rd -= rd % 2
    cos, sin = _rope_angles(positions, rd, theta)          # (B, S, rd/2)
    cos = cos[:, None].to(x.dtype)                         # (B, 1, S, rd/2)
    sin = sin[:, None].to(x.dtype)
    xr = _rotate_half_pairs(x[..., :rd], cos, sin)
    if rd == d:
        return xr
    return torch.cat([xr, x[..., rd:]], dim=-1)
