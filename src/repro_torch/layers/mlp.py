"""Feed-forward blocks (SwiGLU / GELU) over the quantized dense entry
point, in PyTorch.  Counterpart of ``repro/layers/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.api import QuantConfig, dense


def silu(x):
    """``jax.nn.silu`` as XLA computes it on the CPU: ``x * logistic(x)``,
    the logistic expanded to ``1 / (1 + exp(-x))`` and rounded op by op in
    bf16 (bit-equal there; ``F.silu`` rounds once and differs in 39% of
    bf16 values), ``x * sigmoid(x)`` in f32 (99.7% bit-equal)."""
    if x.dtype == torch.bfloat16:
        return x * (1 / (1 + torch.exp(-x)))
    return x * torch.sigmoid(x)


def mlp(x, p: dict, cfg: QuantConfig | None, *, act: str = "swiglu"):
    if act == "swiglu":
        h = silu(dense(x, p["gate"], cfg)) * dense(x, p["up"], cfg)
    elif act == "gelu":
        h = F.gelu(dense(x, p["up"], cfg), approximate="tanh")
    else:
        raise ValueError(act)
    return dense(h.to(x.dtype), p["down"], cfg)
