"""Operand-reordered integer linear algebra (paper Eq. 1-2), in PyTorch.

Counterpart of ``repro/core/integerize.py``::

    Y = [Xq Wq^T + b / (dx_bar * dw)] * dx_bar * diag(dw)      (Eq. 2)

The contraction runs on integer codes (exact int32 accumulators) and only
the per-output-channel scale and bias remain as an f32 epilogue.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import quant
from repro_torch.core.quant import QTensor, int_matmul_exact


class QLinearParams(NamedTuple):
    """Serving-time parameters of one integerized linear layer."""
    w_q: torch.Tensor               # (out, in) int8 codes: y = x @ w_q.T
    w_scale: torch.Tensor           # (out,) per-output-channel dw
    bias: Optional[torch.Tensor]    # (out,) float bias, or None
    w_bits: int = 8


def quantize_weight(w: torch.Tensor, bits: int):
    """Per-output-channel symmetric quantization of a (out, in) weight."""
    dw = quant.absmax_scale(w, bits, axis=1)          # (out, 1)
    wq = quant.quantize(w, dw, bits)
    return wq, dw[:, 0]


def make_qlinear(w: torch.Tensor, bias: Optional[torch.Tensor],
                 bits: int) -> QLinearParams:
    wq, dw = quantize_weight(w, bits)
    return QLinearParams(w_q=wq, w_scale=dw, bias=bias, w_bits=bits)


def int_linear(x: QTensor, p: QLinearParams, *,
               apply_input_scale: bool = True) -> torch.Tensor:
    """Eq. 2: integer contraction then the dequant epilogue."""
    acc = int_matmul_exact(x.q, p.w_q.T)
    post = p.w_scale * (x.scale if apply_input_scale else 1.0)
    y = acc.to(post.dtype) * post
    if p.bias is not None:
        b = p.bias if apply_input_scale else p.bias / x.scale
        y = y + b
    return y


def int_linear_requant(x: QTensor, p: QLinearParams, out_bits: int,
                       out_scale: torch.Tensor) -> QTensor:
    """Integer linear, then re-quantization to the next block's grid:
    Fig. 2's activation-to-activation path."""
    y = int_linear(x, p)
    return quant.quantize_tensor(y, out_bits, scale=out_scale)


def int_matmul(a: QTensor, b: QTensor) -> torch.Tensor:
    """Integer A @ B with both per-tensor scales applied post-hoc."""
    acc = int_matmul_exact(a.q, b.q)
    return acc.to(a.scale.dtype) * (a.scale * b.scale)


def int_matmul_transposed(a: QTensor, b: QTensor) -> torch.Tensor:
    """Integer A @ B^T (QK^T form), scales applied post-hoc."""
    acc = int_matmul_exact(a.q, b.q.transpose(-1, -2))
    return acc.to(a.scale.dtype) * (a.scale * b.scale)


def dequant_linear_ref(x: QTensor, p: QLinearParams) -> torch.Tensor:
    """Eq. 1 oracle on the same integer codes: dequantize both operands."""
    xf = x.dequant()
    wf = p.w_q.to(torch.float32) * p.w_scale[:, None]
    y = xf @ wf.T
    if p.bias is not None:
        y = y + p.bias
    return y
