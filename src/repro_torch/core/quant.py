"""Uniform low-bit quantization primitives (paper §III), in PyTorch.

Counterpart of ``repro/core/quant.py``.  Symmetric uniform grid with step
``delta``::

    q = clip(round(x / delta), qmin, qmax),   qmin = -2^(b-1), qmax = 2^(b-1)-1

``torch.round`` rounds half to even, like ``jnp.round``, so codes match the
reference bit for bit given the same float inputs.  Attention probabilities
use the unsigned grid ``[0, 2^b - 1]``.

Codes are stored in int8 (uint8 for unsigned grids); 4-bit codes may pack
two nibbles per byte (:func:`pack_int4` / :func:`unpack_int4`, low nibble =
even index).

:func:`fake_quant` is the QAT path: quantize-dequantize with the
straight-through estimator for ``x`` and the LSQ gradient for the step
``delta``.  ``x / delta`` runs in the promoted dtype of the two, as JAX
computes it: a bf16 ``x`` over a 0-d f32 ``delta`` divides in f32 (torch
would treat the 0-d tensor as a scalar and stay in bf16), and only the
result is cast back to ``x``'s dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

STORAGE_DTYPE = torch.int8
ACC_DTYPE = torch.int32


def qrange(bits: int, *, unsigned: bool = False) -> tuple[int, int]:
    """(qmin, qmax) of the b-bit grid."""
    if unsigned:
        return 0, (1 << bits) - 1
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def absmax_scale(x: torch.Tensor, bits: int, *, axis=None,
                 unsigned: bool = False, eps: float = 1e-8,
                 group=None) -> torch.Tensor:
    """Calibrate step size from the abs-max of ``x`` (keepdims over ``axis``).

    ``group(|x|, axis)``: the grid's abs-max where ``x`` is one rank's part
    of what the grid spans (``distributed/partition.py``'s ``grid_max``,
    differentiable); None for a grid over ``x`` alone."""
    _, qmax = qrange(bits, unsigned=unsigned)
    if group is not None:
        amax = group(x.abs(), axis)
    elif axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp(amax, min=eps) / qmax


def quantize(x: torch.Tensor, delta, bits: int, *,
             unsigned: bool = False) -> torch.Tensor:
    """Float -> int8-stored b-bit code (uint8 for unsigned grids)."""
    qmin, qmax = qrange(bits, unsigned=unsigned)
    q = torch.clamp(torch.round(x / delta), qmin, qmax)
    return q.to(torch.uint8 if unsigned else STORAGE_DTYPE)


def dequantize(q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return q.to(delta.dtype) * delta


# ---------------------------------------------------------------------------
# Fake quantization for QAT (straight-through estimator, LSQ-style step grad)
# ---------------------------------------------------------------------------

def _reduce_to_shape(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``x`` onto the shape ``delta`` was broadcast from."""
    if len(shape) == 0:
        return x.sum()
    ndiff = x.ndim - len(shape)
    dims = list(range(ndiff)) + [ndiff + i for i, s in enumerate(shape)
                                 if s == 1 and x.shape[ndiff + i] != 1]
    # torch sums every axis for an empty dim list: guard it
    out = x.sum(dim=dims) if dims else x
    return out.reshape(shape)


def _codes(x, delta, qmin, qmax):
    """(x / delta in the promoted dtype, its clipped rounded codes)."""
    dt = torch.promote_types(x.dtype, delta.dtype)
    scaled = x.to(dt) / delta.to(dt)
    return scaled, torch.clamp(torch.round(scaled), qmin, qmax)


class _FakeQuant(torch.autograd.Function):
    """Keeps ``x`` and ``delta`` for the backward, which recomputes the
    quotient and codes (the same ops, so the same values): a bf16 weight
    then costs no f32 copies between the passes."""
    @staticmethod
    def forward(ctx, x, delta, bits, unsigned):
        qmin, qmax = qrange(bits, unsigned=unsigned)
        scaled, q = _codes(x, delta, qmin, qmax)
        ctx.save_for_backward(x, delta)
        ctx.delta_shape, ctx.delta_dtype = delta.shape, delta.dtype
        ctx.qrange = (qmin, qmax)
        return (q * delta.to(q.dtype)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        qmin, qmax = ctx.qrange
        scaled, q = _codes(*ctx.saved_tensors, qmin, qmax)
        return _lsq_grads(ctx, g, scaled, q)


def _lsq_grads(ctx, g, scaled, q):
    """STE and LSQ gradients of (x, delta) from the quotient and codes."""
    qmin, qmax = ctx.qrange
    inside = (scaled >= qmin) & (scaled <= qmax)
    gx = torch.where(inside, g, 0.0)
    # LSQ: d(q*delta)/d(delta) = (q - x/delta) inside, the clip code
    # outside.
    gdelta = torch.where(inside, q - scaled, q) * g
    gdelta = _reduce_to_shape(gdelta, ctx.delta_shape)
    return gx, gdelta.to(ctx.delta_dtype), None, None


def fake_quant(x: torch.Tensor, delta: torch.Tensor, bits: int,
               unsigned: bool = False) -> torch.Tensor:
    """Quantize-dequantize with STE wrt ``x`` and LSQ gradient wrt
    ``delta`` (any shape that broadcasts against ``x``: ``()`` per tensor,
    ``(1, out)`` per column, ``(..., out, 1)`` per row, ``(E, 1, dout)``
    per expert).  Keeps ``x``'s dtype: the f32 step must not upcast bf16
    weights or activations."""
    return _FakeQuant.apply(x, delta, bits, unsigned)


@dataclasses.dataclass
class QTensor:
    """int8-coded tensor plus its dequantization step size."""
    q: torch.Tensor             # int8 codes (uint8 nibbles when packed)
    scale: torch.Tensor         # f32 (or compute-dtype) step size
    bits: int = 8
    unsigned: bool = False

    def dequant(self) -> torch.Tensor:
        return dequantize(self.unpacked().q, self.scale)

    @property
    def is_packed(self) -> bool:
        """Signed uint8 storage marks 2x4-bit nibble packing."""
        return self.q.dtype == torch.uint8 and not self.unsigned

    def unpacked(self) -> "QTensor":
        if self.is_packed:
            return QTensor(unpack_int4(self.q), self.scale, self.bits,
                           self.unsigned)
        return self

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype


def quantize_tensor(x: torch.Tensor, bits: int, *,
                    scale: Optional[torch.Tensor] = None,
                    unsigned: bool = False, group=None) -> QTensor:
    """Quantize an activation (calibrates a per-tensor scale if none;
    ``group`` as in :func:`absmax_scale`)."""
    if scale is None:
        scale = absmax_scale(x, bits, unsigned=unsigned, group=group)
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    return QTensor(quantize(x, scale, bits, unsigned=unsigned), scale, bits,
                   unsigned)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8-stored 4-bit codes pairwise along the last axis."""
    if q.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even trailing dim")
    lo = q[..., 0::2].to(torch.uint8) & 0xF
    hi = (q[..., 1::2].to(torch.uint8) & 0xF) << 4
    return lo | hi


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extends nibbles back to int8)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def storage_bits(bits: int) -> int:
    """Physical bits per value as stored (4-bit packs; 2/3-bit live in int8)."""
    return 4 if bits == 4 else 8


def int_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` -> int32 on any device.

    CUDA has no integer GEMM in PyTorch, so the plain versions contract
    integer codes in float64: every product and partial sum is an integer
    below 2^53, hence exact, and the cast back to int32 is lossless.
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        ACC_DTYPE)
