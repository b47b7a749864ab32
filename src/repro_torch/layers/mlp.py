"""Feed-forward blocks (SwiGLU / GELU) over the quantized dense entry
point, in PyTorch.  Counterpart of ``repro/layers/mlp.py``.

The activations round as XLA rounds them on the CPU: a bf16 expression is
evaluated op by op, each result rounded to bf16 (``jax.nn.gelu``'s tanh
formula, ``jax.nn.sigmoid`` expanded to ``1 / (1 + exp(-x))``), where
torch's fused bf16 kernels compute in f32 and round once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.api import QuantConfig, dense
from repro_torch.distributed import partition

_BF16 = torch.bfloat16
_VEC = 64     # elements: a whole number of torch's CPU vectors, unrolled


def whole_vectors(fn, x):
    """``fn(x)`` elementwise, each element the same bits whatever the size
    of ``x``.  Torch's CPU kernels for sigmoid and logaddexp run whole
    vectors on one path and the tail on a scalar one, and the two differ
    in the last bit; so on the CPU x is padded to whole vectors (a
    partitioned rank's slice of a tensor then gives the whole tensor's
    bits).  The card's kernels compute every element alike.  Used where a
    rank's slice reaches these functions: the RG-LRU's gates and
    ``softplus`` (its ``lam``, SSD's ``dt``)."""
    if x.device.type != "cpu":
        return fn(x)
    n = x.numel()
    flat = F.pad(x.reshape(-1), (0, (-n) % _VEC))
    return fn(flat)[:n].reshape(x.shape)


def logistic(x):
    """``jax.nn.sigmoid``: ``1 / (1 + exp(-x))`` rounded op by op in bf16
    (bit-equal there; ``torch.sigmoid`` differs in 34% of bf16 values),
    ``torch.sigmoid`` in f32."""
    if x.dtype == _BF16:
        return 1 / (1 + torch.exp(-x))
    return torch.sigmoid(x)


def silu(x):
    """``jax.nn.silu``: ``x * logistic(x)`` (``F.silu`` rounds once and
    differs in 39% of bf16 values; ``x * sigmoid(x)`` in f32 is 99.7%
    bit-equal)."""
    return x * logistic(x)


def gelu(x):
    """``jax.nn.gelu`` (tanh form).  bf16: JAX's own formula
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3))))`` with its constants
    rounded to bf16 and each op rounded (``F.gelu`` differs in 43% of bf16
    values); f32: ``F.gelu(approximate="tanh")``."""
    if x.dtype != _BF16:
        return F.gelu(x, approximate="tanh")
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=_BF16, device=x.device)
    k = torch.tensor(0.044715, dtype=_BF16, device=x.device)
    inner = c * (x + k * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def softplus(x):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: ``torch.logaddexp``
    differs from XLA's in the last bit of 9% of f32 values (``F.softplus``
    in 15%, JAX's own ``max + log1p(exp(-|x|))`` in torch's ops in 13%)."""
    return whole_vectors(lambda t: torch.logaddexp(t, torch.zeros_like(t)),
                          x)


def mlp(x, p: dict, cfg: QuantConfig | None, *, act: str = "swiglu",
        k_split: bool = False, seq: bool = False):
    """The feed-forward on x (..., d); ``k_split``: under partitioned rules,
    gate and up hold this rank's columns and down its slice of K.
    ``seq`` (``partition.seq_split``): x (B, S, d) holds this rank's chunk
    of the sequence, gathered before gate and up, and the result is the
    rank's chunk again (down reduce-scattered)."""
    x = partition.model_input(x, k_split, seq)
    if act == "swiglu":
        h = silu(dense(x, p["gate"], cfg)) * dense(x, p["up"], cfg)
    elif act == "gelu":
        h = gelu(dense(x, p["up"], cfg))
    else:
        raise ValueError(act)
    return dense(h.to(x.dtype), p["down"], cfg, tp="row", k_split=k_split,
                 seq=seq)
