"""Post-quantized LayerNorm (paper §IV-C): CUDA kernel + plain version.

    codes = clip(round(((x - mean) / sqrt(var + eps) * gamma + beta) / delta))

on the signed ``bits`` grid (RMS with ``rms_only``: ``x / sqrt(mean(x^2) +
eps)``).  Replaces the Pallas TPU kernel
``repro/kernels/pq_layernorm.py::pq_layernorm`` (``:35``, ``pl.pallas_call``
at ``:48``).  The kernel is ``csrc/pq_layernorm.cu``: each row read once
from device memory into registers by 16-byte loads, by a warp (narrow rows)
or by 128-1024 threads (wide rows), as :func:`plan` says from ``d`` and the
dtype alone; the moments, the normalization, the affine step and the
quantizer in registers, int8 codes out packed — the normalized activations
never reach device memory in float.  Bound: bytes.  The plain version is
:func:`repro_torch.kernels.ref.pq_layernorm_ref`, which takes the row sums
in the kernel's order under the same plan and rounds every step as the
kernel does, so the two agree code for code.

:func:`pq_layernorm` runs the kernel on CUDA tensors and the plain version
on CPU tensors, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ref import pq_layernorm_plan as plan

# Kernel launches (one per launch, bumped nowhere else).
LAUNCHES = {"pq_layernorm": 0}


def pq_layernorm(x, gamma, beta, delta, *, bits=8, eps=1e-6,
                 rms_only=False, br=256):
    """(rows, d) f32 or bf16 -> (rows, d) int8 codes on the signed b-bit
    grid.  ``gamma``/``beta`` (d,) (``beta`` may be None); ``delta`` the
    quantizer's step, a number (a 0-d tensor is read on the host).  ``br``
    is the reference's row tile; the CUDA kernel's threads per row come
    from :func:`plan`, and neither changes the codes."""
    del br
    rows, d = x.shape
    if x.device.type == "cpu":
        return ref.pq_layernorm_ref(x, gamma, beta, delta, bits=bits,
                                    eps=eps, rms_only=rms_only)
    if x.device.type != "cuda" or x.dtype not in (torch.float32,
                                                   torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"pq_layernorm: x must be a contiguous f32 or bf16 "
                         f"CUDA tensor; got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    g = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    b = None if beta is None else \
        beta.to(device=x.device, dtype=torch.float32).contiguous()
    if g.shape != (d,) or (b is not None and b.shape != (d,)):
        raise ValueError(f"pq_layernorm: gamma/beta must be ({d},)")
    out = torch.empty((rows, d), dtype=torch.int8, device=x.device)
    _launch(x, g, b, out, plan(d, x.dtype), bits=bits, eps=eps,
            delta=delta, rms_only=rms_only)
    LAUNCHES["pq_layernorm"] += 1
    return out


def _launch(x, g, b, out, blocks, *, bits, eps, delta, rms_only):
    """Call ``pq_layernorm_launch`` with the plan ``blocks`` (argument
    types set once); raises if the launcher refuses or the launch fails."""
    lib = build.load("pq_layernorm")
    fn = lib.pq_layernorm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rows, d = x.shape
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    rc = fn(x.data_ptr(), g.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), rows, d, int(x.dtype == torch.bfloat16),
            *blocks, ref.f32(eps), ref.f32(delta), float(qmin), float(qmax),
            int(rms_only), build.stream_ptr(x))
    build.check(lib, rc, f"pq_layernorm (rows={rows}, d={d}, plan {blocks})")
