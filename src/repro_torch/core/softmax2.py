"""Base-2 shift softmax (paper Eq. 3-4), in PyTorch.

Counterpart of ``repro/core/softmax2.py``::

    exp(s * qk) = 2^(s * log2(e) * qk) ~= (1 + r) * 2^floor(x)

Powers of two are built from exponent bits (:func:`exp2i`), never with a
library ``exp2``/``pow`` on the host or the card: the CUDA kernels build
them with ``ldexpf``, and both must give the same bits.  Results below
2^-126 stay exact denormals here and in the kernels, where XLA on the CPU
(and the TPU) flushes them to zero; such an ``e`` rounds to prob code 0 and
is absorbed by any Sigma >= 1, so no code and no served token can differ.
"""
from __future__ import annotations

import torch

LOG2E = 1.4426950408889634


def exp2i(f: torch.Tensor) -> torch.Tensor:
    """Exact f32 ``2^f`` for integer-valued ``f`` (any float/int dtype).

    Matches ``ldexp(1, f)``: normal powers come straight from the exponent
    field, ``2^-127 .. 2^-149`` come out as the exact denormal (one more
    exact multiply), anything smaller is 0 and anything above 127 is inf.
    """
    fi = f.to(torch.int32)
    hi = fi.clamp(-126, 127)
    p = ((hi + 127) << 23).view(torch.float32)
    lo = (fi - hi).clamp(-127, 0)            # < 0 only below 2^-126
    q = ((lo + 127) << 23).view(torch.float32)
    p = torch.where(fi > 127, torch.full_like(p, float("inf")), p)
    return torch.where(fi < -126, p * q, p).masked_fill(fi < -252, 0.0)


def exp2_shift(x: torch.Tensor) -> torch.Tensor:
    """(1 + r) * 2^floor(x): the paper's shift-exp approximation of 2^x."""
    f = torch.floor(x)
    r = x - f
    return (1.0 + r) * exp2i(f)


def exp_shift(x: torch.Tensor) -> torch.Tensor:
    """Approximate e^x via exp2_shift(x * log2 e) (Eq. 4)."""
    return exp2_shift(x * LOG2E)


def softmax2(logits: torch.Tensor, *, dim: int = -1, scale=1.0,
             stable: bool = True) -> torch.Tensor:
    """softmax(scale * logits) with the base-2 shift-exp (Eq. 3-4)."""
    x = logits * (scale * LOG2E)
    if stable:
        m = torch.floor(x.amax(dim=dim, keepdim=True))
        x = x - m
    e = exp2_shift(x)
    return e / e.sum(dim=dim, keepdim=True)


def softmax_ref(logits: torch.Tensor, *, dim: int = -1,
                scale=1.0) -> torch.Tensor:
    """Exact softmax oracle."""
    return torch.softmax(logits * scale, dim=dim)


def quantize_probs(e: torch.Tensor, sigma: torch.Tensor, bits: int,
                   delta_attn) -> torch.Tensor:
    """Paper §IV-B quantizer with Sigma-scaled thresholds (division form)."""
    qmax = (1 << bits) - 1
    q = torch.clamp(torch.round(e / (sigma * delta_attn)), 0, qmax)
    return q.to(torch.uint8)


def quantize_probs_comparator(e: torch.Tensor, sigma: torch.Tensor,
                              bits: int, delta_attn) -> torch.Tensor:
    """Threshold-comparator form of :func:`quantize_probs` (Fig. 4).

    ``p_q = sum_k [e > (k - 1/2) * delta * Sigma]`` over k = 1 .. 2^bits - 1:
    the paper's parallel comparator array, O(2^bits) comparisons an
    element.  ``sigma`` has one entry per row of ``e`` (no trailing axis).
    At an exact tie the division form rounds half to even and the strict
    comparison does not, as in the reference.
    """
    qmax = (1 << bits) - 1
    ks = torch.arange(1, qmax + 1, dtype=e.dtype, device=e.device)
    thr = (ks - 0.5) * delta_attn * sigma[..., None, None]   # (..., 1, K)
    q = (e[..., None] > thr).sum(dim=-1)
    return q.to(torch.uint8)
