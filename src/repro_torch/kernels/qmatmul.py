"""Operand-reordered integer matmul (paper Eq. 2): CUDA kernel + plain version.

    out[m, n] = f32(sum_k Xq[m, k] * Wq[n, k]) * (scale[n] * row_scale[m]) + bias[n]

Replaces the Pallas TPU kernel ``repro/kernels/qmatmul.py::qmatmul``
(``:80``, bodies ``_qmatmul_kernel`` and ``_qmatmul_packed_kernel``).  The
kernel is ``csrc/qmatmul.cu``: dp4a over 64-byte K slabs in shared memory,
int32 accumulators in registers, the f32 epilogue rounded op by op.  In
decode M is the batch (4 rows), so reading W bounds it (packed int4 halves
those bytes); prefill is bound by operations.

:func:`qmatmul` runs the kernel on CUDA tensors and the plain version
(:func:`repro_torch.kernels.ref.qmatmul_ref`) on CPU tensors, and nowhere
else: there is no fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref

# Kernel launches (one per launch, bumped nowhere else).
LAUNCHES = {"qmatmul": 0}


def tile(m: int) -> tuple[int, int]:
    """(bm, bn) output tile for M rows.  The tile lives in registers (a
    16x16 thread grid, each thread a bm/16 x bn/16 int32 accumulator
    block).  Decode (M <= 16 rows) takes the 16 x 64 tile so enough blocks
    stream W; prefill the 64 x 128 tile for operand reuse."""
    return (16, 64) if m <= 16 else (64, 128)


def qmatmul(x_q, w_q, scale, bias=None, row_scale=None, *, bm=None, bn=None,
            packed=False):
    """x_q (M, K) int8 @ w_q (N, K) int8 -> (M, N) f32, fused epilogue.

    ``scale`` (N,) f32; ``row_scale`` (M,) f32 refines the input step per
    row (``scale[n] * row_scale[m]``); ``bias`` (N,) f32.  ``packed=True``
    takes w_q as (N, K/2) uint8 nibbles (low nibble = even k).  ``(bm, bn)``
    is the output tile, :func:`tile` of M unless given.
    """
    m, k = x_q.shape
    if bm is None:
        bm, bn = tile(m)
    n = w_q.shape[0]
    if w_q.shape[1] * (2 if packed else 1) != k:
        raise ValueError(f"qmatmul: x {tuple(x_q.shape)} vs w "
                         f"{tuple(w_q.shape)} (packed={packed})")
    if x_q.device.type == "cpu":
        return ref.qmatmul_ref(x_q, w_q, scale, bias, row_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"qmatmul: unsupported device {x_q.device}")
    _check(x_q, torch.int8, (m, k), "x_q")
    _check(w_q, torch.uint8 if packed else torch.int8,
           (n, k // 2 if packed else k), "w_q")
    _check(scale, torch.float32, (n,), "scale")
    if bias is not None:
        _check(bias, torch.float32, (n,), "bias")
    if row_scale is not None:
        _check(row_scale, torch.float32, (m,), "row_scale")
    if k % 4:
        # The kernel reads K in int8 words (K % 4 == 0, also the C
        # launcher's check): pad with zero codes, exact for the int32 sums.
        k4 = -(-k // 4) * 4
        x_q = F.pad(x_q, (0, k4 - k))
        w_q = F.pad(w_q, (0, (k4 - k) // 2 if packed else k4 - k))
        k = k4
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    lib = build.load("qmatmul")
    fn = lib.qmatmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if row_scale is None else row_scale.data_ptr(),
            out.data_ptr(), m, n, k, int(packed), bm, bn,
            build.stream_ptr(x_q))
    build.check(lib, rc, "qmatmul")
    LAUNCHES["qmatmul"] += 1
    return out


def _check(t, dtype, shape, name):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous() or \
            t.data_ptr() % 4:
        raise ValueError(f"qmatmul: {name} must be a contiguous, 4-byte "
                         f"aligned CUDA {dtype} tensor of shape {shape}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
