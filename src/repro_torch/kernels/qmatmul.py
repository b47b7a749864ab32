"""Operand-reordered integer matmul (paper Eq. 2): CUDA kernel + plain version.

    out[m, n] = f32(sum_k Xq[m, k] * Wq[n, k]) * (scale[n] * row_scale[m]) + bias[n]

Replaces the Pallas TPU kernel ``repro/kernels/qmatmul.py::qmatmul``
(``:119``, bodies ``_qmatmul_kernel`` and ``_qmatmul_packed_kernel``).  The
kernel is ``csrc/qmatmul.cu``, with two bodies that :func:`plan` picks
from the shape, both on the int8 tensor cores (``mma.sync``): decode
(M <= 16 rows, bound by reading W) streams W from device memory straight
into registers as the wide operand, the eight warps of a block taking
contiguous K ranges of the same rows of W; prefill and DeiT-S (M > 16) run
128 x 128 or 64 x 128 tiles fed by a ``cp.async`` ring, splitting K across
blocks where the tiles alone leave SMs idle.  Both keep the int32 sums
exact and round the f32 epilogue op by op, so every output bit equals the
plain version's.

:func:`qmatmul` runs the kernel on CUDA tensors and the plain version
(:func:`repro_torch.kernels.ref.qmatmul_ref`) on CPU tensors, and nowhere
else: there is no fallback from a CUDA tensor to the plain version.
:func:`qmatmul_acc` is the same kernel in its accumulator mode: the exact
int32 sums, no epilogue (plain version
:func:`repro_torch.kernels.ref.qmatmul_acc_ref`), for a row-parallel
linear whose ranks add their K slices' sums before one epilogue.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref

# Kernel launches (one per call that launches, bumped nowhere else): every
# call of the kernel counts under "qmatmul", and those in accumulator mode
# also under "qmatmul_acc".
LAUNCHES = {"qmatmul": 0, "qmatmul_acc": 0}

SMS = 132             # H100 SXM streaming multiprocessors
MIN_SPLIT_K = 1024    # least K bytes a split of K


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, n: int, k: int) -> tuple[str, int, int, int]:
    """``(body, bm, bn, splits)`` of the kernel for an (m, k) x (n, k)^T
    product: a pure function of the shape, and the one place where the
    tiles are chosen.  The packed body takes the same plan as the int8 one
    (its slab holds the same K in half the bytes).

    - M <= 16 rows (decode): ``("stream", bm, bn, 1)``.  Reading W once
      bounds it.  ``bm`` is the x rows the tensor cores take, 8 for
      M <= 8 and 16 above, so no product multiplies more padding than the
      n8 tile's.  ``bn`` is the rows of W a block streams, all of K
      between its warps: 32 where that still gives every SM a block
      (:data:`SMS`), as a warp then reads 128 contiguous bytes of each row
      a step and each x chunk serves twice the rows; else 16, twice the
      blocks (N 1024).  ``qmatmul_split_ab.py`` times each decode shape's
      width against the other.  One launch: K is split only between a
      block's warps.
    - M > 16: ``"mma"`` over tiles of 128 columns.  The first of these
      that gives at least one block an SM (:data:`SMS`):
      1. 128-row tiles (M > 64 only: a 128-row tile over fewer rows
         multiplies rows of zeros), so each byte of W brought into shared
         memory serves 128 rows and two blocks fit an SM;
      2. the same tiles with K split into the fewest splits that make
         :data:`SMS` blocks, each at least :data:`MIN_SPLIT_K` bytes of K
         deep: a split writes its int32 sums and the second launch reads
         them back (8 bytes an output), at 1 KB of K at most half the
         bytes of x and W the split streams;
      3. and 4. the same with 64-row tiles, twice the blocks;
      else, with K too short to split, the 64-row tiles alone (the most
      blocks).  Blocks walk M tiles fastest, so those that share a column
      slab of W run together and W is read from device memory once.
    """
    if m <= 16:
        bn = 32 if _cdiv(n, 32) >= SMS else 16
        return "stream", 8 if m <= 8 else 16, bn, 1
    rows = (128, 64) if m > 64 else (64,)
    for bm in rows:
        tiles = _cdiv(m, bm) * _cdiv(n, 128)
        if tiles >= SMS:
            return "mma", bm, 128, 1
        splits = _cdiv(SMS, tiles)
        if k >= splits * MIN_SPLIT_K:
            return "mma", bm, 128, splits
    return "mma", rows[-1], 128, 1


def qmatmul(x_q, w_q, scale, bias=None, row_scale=None, *, blocks=None,
            packed=False):
    """x_q (M, K) int8 @ w_q (N, K) int8 -> (M, N) f32, fused epilogue.

    ``scale`` (N,) f32; ``row_scale`` (M,) f32 refines the input step per
    row (``scale[n] * row_scale[m]``); ``bias`` (N,) f32.  ``packed=True``
    takes w_q as (N, K/2) uint8 nibbles (low nibble = even k).  ``blocks``
    is the plan, :func:`plan` of the shape unless given; a plan the kernel
    was not built for raises.  One call counts one launch in
    :data:`LAUNCHES`, though a plan that splits K is two kernel launches
    (the partial sums, then their sum and the epilogue).
    """
    m, k = x_q.shape
    n = w_q.shape[0]
    if w_q.shape[1] * (2 if packed else 1) != k:
        raise ValueError(f"qmatmul: x {tuple(x_q.shape)} vs w "
                         f"{tuple(w_q.shape)} (packed={packed})")
    if x_q.device.type == "cpu":
        return ref.qmatmul_ref(x_q, w_q, scale, bias, row_scale)
    _check(scale, torch.float32, (n,), "scale")
    if bias is not None:
        _check(bias, torch.float32, (n,), "bias")
    if row_scale is not None:
        _check(row_scale, torch.float32, (m,), "row_scale")
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    _launch(x_q, w_q, blocks, packed, out=out, scale=scale, bias=bias,
            row_scale=row_scale)
    return out


def qmatmul_acc(x_q, w_q, *, blocks=None, packed=False):
    """x_q (M, K) int8 @ w_q (N, K) int8 -> (M, N) int32: the kernel's
    exact sums with the epilogue skipped (``packed`` and ``blocks`` as in
    :func:`qmatmul`; a split of K adds its splits' sums in the second
    launch).  One call counts one launch under "qmatmul" and under
    "qmatmul_acc"."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if w_q.shape[1] * (2 if packed else 1) != k:
        raise ValueError(f"qmatmul_acc: x {tuple(x_q.shape)} vs w "
                         f"{tuple(w_q.shape)} (packed={packed})")
    if x_q.device.type == "cpu":
        return ref.qmatmul_acc_ref(x_q, w_q)
    acc = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    _launch(x_q, w_q, blocks, packed, acc=acc)
    LAUNCHES["qmatmul_acc"] += 1
    return acc


def _launch(x_q, w_q, blocks, packed, *, out=None, acc=None, scale=None,
            bias=None, row_scale=None):
    """One call of ``qmatmul_launch``: the epilogue into ``out`` or, with
    ``acc``, the int32 sums into it."""
    if x_q.device.type != "cuda":
        raise ValueError(f"qmatmul: unsupported device {x_q.device}")
    m, k = x_q.shape
    n = w_q.shape[0]
    body, bm, bn, splits = blocks or plan(m, n, k)
    # Both bodies read 16-byte runs of x and of W (nibbles: 32 codes).
    unit = 32 if packed else 16
    _check(x_q, torch.int8, (m, k), "x_q", 16)
    _check(w_q, torch.uint8 if packed else torch.int8,
           (n, k // 2 if packed else k), "w_q", 16)
    if acc is not None:
        _check(acc, torch.int32, (m, n), "acc", 16)
    if k % unit:
        # Pad K with zero codes (exact for the int32 sums); the main-path
        # shapes never need it.
        ku = _cdiv(k, unit) * unit
        x_q = F.pad(x_q, (0, ku - k))
        w_q = F.pad(w_q, (0, (ku - k) // 2 if packed else ku - k))
        k = ku
    part = torch.empty((splits, m, n), dtype=torch.int32,
                       device=x_q.device) if splits > 1 else None
    lib = build.load("qmatmul")
    fn = lib.qmatmul_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = fn(x_q.data_ptr(), w_q.data_ptr(), ptr(scale), ptr(bias),
            ptr(row_scale), ptr(out), ptr(part), ptr(acc), m, n, k,
            int(packed), {"stream": 0, "mma": 1}.get(body, -1), bm, bn,
            splits, build.stream_ptr(x_q))
    build.check(lib, rc, f"qmatmul (plan {(body, bm, bn, splits)})")
    LAUNCHES["qmatmul"] += 1


def _check(t, dtype, shape, name, align=4):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous() or \
            t.data_ptr() % align:
        raise ValueError(f"qmatmul: {name} must be a contiguous, "
                         f"{align}-byte aligned CUDA {dtype} tensor of shape "
                         f"{shape}; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
