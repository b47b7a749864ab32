"""The kernels' direct entry points, typed on the port's QTensor and
QLinearParams.  Counterpart of ``repro/kernels/ops.py``.

Model graphs reach the kernels through :mod:`repro_torch.kernels.dispatch`;
these wrappers are the entry points for tests, benchmarks and callers that
hold quantized operands already.  There is no ``interpret`` argument: the
device comes from the tensors (CUDA tensors launch the kernels, CPU
tensors run their plain versions).  Defaults are the reference kernels'.
"""
from __future__ import annotations

import torch

from repro_torch.core.integerize import QLinearParams
from repro_torch.core.quant import QTensor
from repro_torch.core.softmax2 import LOG2E
from repro_torch.kernels.int_attention import (int_attention,
                                               int_attention_fused)
from repro_torch.kernels.pq_layernorm import pq_layernorm
from repro_torch.kernels.qmatmul import qmatmul


def qlinear_op(x: QTensor, p: QLinearParams, **kw):
    """Kernel-backed ``core.integerize.int_linear`` on a 2-D QTensor:
    ``(x.q @ w_q.T) * (w_scale * x.scale) + bias``.  Nibble-packed (uint8)
    weights pass ``packed=True``."""
    scale = (p.w_scale * x.scale).to(torch.float32).contiguous()
    bias = None if p.bias is None else p.bias.to(torch.float32).contiguous()
    return qmatmul(x.q, p.w_q, scale, bias, **kw)


def int_attention_op(q: QTensor, k: QTensor, v: QTensor, *, softmax_scale,
                     attn_bits=7, causal=True, window=None, fused=True,
                     bq=128, bk=128, **kw):
    """Integer attention on (H, S, D) QTensors: ``fused=True`` the
    single-pass kernel, ``fused=False`` the two-pass baseline — the same
    output.  ``bq``/``bk`` are the reference kernel's defaults."""
    sc = softmax_scale * q.scale * k.scale * LOG2E
    kern = int_attention_fused if fused else int_attention
    return kern(q.q, k.q, v.q, sc, v.scale, attn_bits=attn_bits,
                causal=causal, window=window, bq=bq, bk=bk, **kw)


def pq_layernorm_op(x, gamma, beta, delta, **kw):
    """Fused LayerNorm (or RMS) -> quantizer: int8 codes."""
    return pq_layernorm(x, gamma, beta, delta, **kw)
