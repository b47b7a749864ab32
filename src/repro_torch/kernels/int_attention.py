"""Integer attention with the embedded base-2 softmax: CUDA kernels + plain
versions.

The three kernels live in ``csrc/int_attention.cu`` and share the online
quantizer of ``kernels/ref.py`` (running integer ``m``, codes on the
power-of-two Sigma grid, PV carries rescaled by exact powers of two):

- :func:`int_attention_fused` replaces the Pallas TPU kernel
  ``repro/kernels/int_attention.py::int_attention_fused`` (``:522``): the
  prompt-prefill kernel.  One CUDA block per (head-fold, query block)
  loops over its own live key tiles (the TPU walked them as a sequential
  grid axis through a scalar-prefetched block map).  ``bk`` is part of the
  semantics: codes are quantized against the running max one key block at
  a time, so the plain version runs at the same ``bk``
  (:func:`repro_torch.kernels.ref.int_attention_ref_streamed`).  Bound:
  int8 operations.
- :func:`int_paged_decode_attention` replaces
  ``repro/kernels/int_attention.py::int_paged_decode_attention``
  (``:661``): every engine decode step.  One block per (kv head, sequence)
  walks that sequence's live pages in logical order; pages are never
  split across blocks (a split would quantize against a partial running
  max).  Plain version: the paged oracle at ``bk = page_size``.  Bound:
  the live KV bytes.
- :func:`int_decode_attention` replaces
  ``repro/kernels/int_attention.py::int_decode_attention`` (``:582``,
  ``pl.pallas_call`` at ``:649``): every decode step over the ring KV
  cache.  One block per head-fold walks the ring's ``bk``-blocks in slot
  order, decides from ``k_positions`` and the device-resident ``pos``
  which hold a live key, and skips the rest (the TPU's scalar-prefetched
  live-block map).  Plain version: :func:`int_decode_attention_plain`, the
  ring oracle at the same ``bk``.  Bound: the live KV bytes.

Each wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors, and nowhere else.  ``return_codes`` also returns the prob codes,
which is how the kernels are held against the plain versions exactly.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import build, ref

MAX_PROB_BITS = 8
RING_MAX_GD = 2048        # ring decode: G * D output accumulators a block
# Kernel launches (one per launch, bumped nowhere else).
LAUNCHES = {"int_attention_fused": 0, "int_paged_decode_attention": 0,
            "int_decode_attention": 0}


def _f32(x):
    """A Python float as the f32 the reference's weak-typed constants use."""
    return float(np.float32(x))


def grid_scales(sc, v_scale, h, nq, device):
    """Broadcast the epilogue scales to their grid shapes: ``sc`` (scalar,
    (nq,) or (h, nq)) -> (h, nq) f32; ``v_scale`` (scalar or (h,)) -> (h,)."""
    sc = torch.as_tensor(sc, dtype=torch.float32, device=device)
    if sc.ndim == 1:
        sc = sc[None, :]
    sc = sc.expand(h, nq).contiguous()
    vs = torch.as_tensor(v_scale, dtype=torch.float32,
                         device=device).reshape(-1).expand(h).contiguous()
    return sc, vs


def int_attention_fused_plain(q_q, k_q, v_q, sc, v_scale, *, attn_bits=7,
                              causal=True, window=None, bq, bk, sq_mod=None,
                              return_codes=False):
    """Plain version of the fused kernel: the streamed oracle at the
    kernel's ``bk``, with the per-(head-fold, query-block) scales expanded
    to rows."""
    h, sq, _ = q_q.shape
    nq = -(-sq // bq)
    sc2, vs = grid_scales(sc, v_scale, h, nq, q_q.device)
    rows = torch.repeat_interleave(sc2, bq, dim=1)[:, :sq]
    return ref.int_attention_ref_streamed(
        q_q, k_q, v_q, rows, vs, bk=bk, attn_bits=attn_bits, causal=causal,
        window=window, sq_mod=sq_mod, return_codes=return_codes)


def int_attention_fused(q_q, k_q, v_q, sc, v_scale, *, attn_bits=7,
                        causal=True, window=None, bq, bk, sq_mod=None,
                        return_codes=False):
    """Single-pass fused integer attention (the prefill kernel).

    q_q (H, Sq, D) int8 with G GQA groups stacked along Sq (row r at
    position ``r % sq_mod``); k_q, v_q (H, Sk, D) int8; ``sc`` =
    softmax_scale * log2(e) * dq * dk — scalar, (nq,) or (H, nq) per
    (head-fold, query block of ``bq`` rows); ``v_scale`` scalar or (H,).
    Returns (H, Sq, D) f32 (and (H, Sq, Sk) uint8 codes).
    """
    if attn_bits > MAX_PROB_BITS:
        raise ValueError(f"prob codes are <= {MAX_PROB_BITS}-bit")
    if q_q.device.type == "cpu":
        return int_attention_fused_plain(
            q_q, k_q, v_q, sc, v_scale, attn_bits=attn_bits, causal=causal,
            window=window, bq=bq, bk=bk, sq_mod=sq_mod,
            return_codes=return_codes)
    h, sq, d = q_q.shape
    sk = k_q.shape[1]
    nq = -(-sq // bq)
    sc2, vs = grid_scales(sc, v_scale, h, nq, q_q.device)
    for name, t, shape in (("q_q", q_q, (h, sq, d)), ("k_q", k_q, (h, sk, d)),
                           ("v_q", v_q, (h, sk, d))):
        _check(t, torch.int8, shape, name)
    if d % 4 or bk % 4 or bq * d > 8192:
        raise ValueError(f"fused attention kernel: needs D % 4 == 0, "
                         f"bk % 4 == 0, bq * D <= 8192 (D={d}, bq={bq}, "
                         f"bk={bk})")
    qmax = (1 << attn_bits) - 1
    out = torch.empty((h, sq, d), dtype=torch.float32, device=q_q.device)
    codes = torch.zeros((h, sq, sk), dtype=torch.uint8, device=q_q.device) \
        if return_codes else None
    lib = build.load("int_attention")
    fn = lib.fused_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q_q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), sc2.data_ptr(),
            vs.data_ptr(), out.data_ptr(),
            None if codes is None else codes.data_ptr(),
            h, sq, sk, d, bq, bk, sq_mod or sq, int(causal),
            -1 if window is None else int(window), float(qmax),
            _f32(2.0 / qmax), build.stream_ptr(q_q))
    build.check(lib, rc, "int_attention_fused")
    LAUNCHES["int_attention_fused"] += 1
    return (out, codes) if return_codes else out


def int_paged_decode_attention(q_q, k_pages, v_pages, sc, v_scale,
                               page_table, pos, *, k_page_scale=None,
                               v_page_scale=None, attn_bits=7, window=None,
                               packed=False, return_codes=False):
    """Single-query integer decode attention over a paged KV cache.

    q_q (B, Hkv, G, D) int8; pools (num_pages, Hkv, page_size, D) int8 or
    (..., D/2) uint8 nibbles (``packed``); ``page_table`` (B, max_pages)
    int32 (negative = unallocated); ``pos`` (B,) int32 (negative =
    inactive row -> zero output); ``sc``/``v_scale`` per sequence (B,);
    ``k_page_scale``/``v_page_scale`` (num_pages,) per physical page, both
    or neither.  Returns (B, Hkv, G, D) f32 (and the (B, Hkv, G,
    max_pages * page_size) uint8 codes).
    """
    if attn_bits > MAX_PROB_BITS:
        raise ValueError(f"prob codes are <= {MAX_PROB_BITS}-bit")
    if (k_page_scale is None) != (v_page_scale is None):
        raise ValueError("k_page_scale and v_page_scale must be given "
                         "together")
    b, hkv, g, d = q_q.shape
    num_phys, _, ps, dk = k_pages.shape
    if dk * (2 if packed else 1) != d:
        raise ValueError(f"paged decode: q {tuple(q_q.shape)} vs pools "
                         f"{tuple(k_pages.shape)} (packed={packed})")
    dev = q_q.device
    sc = torch.as_tensor(sc, dtype=torch.float32, device=dev).reshape(-1)
    sc = sc.expand(b).contiguous()
    vs = torch.as_tensor(v_scale, dtype=torch.float32,
                         device=dev).reshape(-1).expand(b).contiguous()
    if dev.type == "cpu":
        return ref.int_paged_decode_attention_ref(
            q_q, k_pages, v_pages, sc, vs, page_table, pos,
            attn_bits=attn_bits, window=window, bk=ps,
            k_page_scale=k_page_scale, v_page_scale=v_page_scale,
            return_codes=return_codes)
    maxp = page_table.shape[1]
    _check(q_q, torch.int8, (b, hkv, g, d), "q_q")
    pool_dt = torch.uint8 if packed else torch.int8
    _check(k_pages, pool_dt, (num_phys, hkv, ps, dk), "k_pages")
    _check(v_pages, pool_dt, (num_phys, hkv, ps, dk), "v_pages")
    _check(page_table, torch.int32, (b, maxp), "page_table")
    _check(pos, torch.int32, (b,), "pos")
    if k_page_scale is not None:
        _check(k_page_scale, torch.float32, (num_phys,), "k_page_scale")
        _check(v_page_scale, torch.float32, (num_phys,), "v_page_scale")
    if d % 4 or ps % 4 or g * d > 2048:
        raise ValueError(f"paged decode kernel: needs D % 4 == 0, "
                         f"page_size % 4 == 0, G * D <= 2048 (D={d}, "
                         f"ps={ps}, G={g})")
    qmax = (1 << attn_bits) - 1
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=dev)
    codes = torch.zeros((b, hkv, g, maxp * ps), dtype=torch.uint8,
                        device=dev) if return_codes else None
    lib = build.load("int_attention")
    fn = lib.paged_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q_q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            sc.data_ptr(), vs.data_ptr(),
            None if k_page_scale is None else k_page_scale.data_ptr(),
            None if v_page_scale is None else v_page_scale.data_ptr(),
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            None if codes is None else codes.data_ptr(),
            b, hkv, g, d, ps, maxp, num_phys,
            -1 if window is None else int(window), int(packed), float(qmax),
            _f32(2.0 / qmax), build.stream_ptr(q_q))
    build.check(lib, rc, "int_paged_decode_attention")
    LAUNCHES["int_paged_decode_attention"] += 1
    return (out, codes) if return_codes else out


def int_decode_attention_plain(q_q, k_q, v_q, sc, v_scale, k_positions,
                               pos, *, attn_bits=7, causal=True, window=None,
                               bk, packed=False, return_codes=False):
    """Plain version of the ring decode kernel: nibbles unpacked to int8
    codes (never to floats), then the ring oracle at the kernel's ``bk``."""
    if packed:
        k_q, v_q = unpack_int4(k_q), unpack_int4(v_q)
    return ref.int_decode_attention_ref(
        q_q, k_q, v_q, sc, v_scale, k_positions, pos, attn_bits=attn_bits,
        causal=causal, window=window, bk=bk, return_codes=return_codes)


def int_decode_attention(q_q, k_q, v_q, sc, v_scale, k_positions, pos, *,
                         attn_bits=7, causal=True, window=None, bk,
                         packed=False, return_codes=False):
    """Single-query integer decode attention over a KV ring cache, in place.

    q_q (H, G, D) int8 — the G GQA rows of one decode step, all at query
    position ``pos``; k_q, v_q the ring as stored: (H, span, D) int8, or
    (H, span, D/2) uint8 nibbles with ``packed``; ``k_positions`` (span,)
    int32, ring slot -> absolute position (negative = unwritten);
    ``pos`` a 0-d or (1,) int32 tensor on the device, read by the kernel
    (no host sync); ``sc`` = softmax_scale * log2(e) * dq * dk and
    ``v_scale`` scalars or (H,).  Returns (H, G, D) f32 (and the
    (H, G, span) uint8 codes).
    """
    if attn_bits > MAX_PROB_BITS:
        raise ValueError(f"prob codes are <= {MAX_PROB_BITS}-bit")
    h, g, d = q_q.shape
    span, dk = k_q.shape[1], k_q.shape[2]
    if dk * (2 if packed else 1) != d:
        raise ValueError(f"ring decode: q {tuple(q_q.shape)} vs ring "
                         f"{tuple(k_q.shape)} (packed={packed})")
    if q_q.device.type == "cpu":
        return int_decode_attention_plain(
            q_q, k_q, v_q, sc, v_scale, k_positions, pos,
            attn_bits=attn_bits, causal=causal, window=window, bk=bk,
            packed=packed, return_codes=return_codes)
    dev = q_q.device
    sc = torch.as_tensor(sc, dtype=torch.float32, device=dev).reshape(-1)
    sc = sc.expand(h).contiguous()
    vs = torch.as_tensor(v_scale, dtype=torch.float32,
                         device=dev).reshape(-1).expand(h).contiguous()
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(1)
    _check(q_q, torch.int8, (h, g, d), "q_q")
    ring_dt = torch.uint8 if packed else torch.int8
    _check(k_q, ring_dt, (h, span, dk), "k_q")
    _check(v_q, ring_dt, (h, span, dk), "v_q")
    _check(k_positions, torch.int32, (span,), "k_positions")
    _check(pos, torch.int32, (1,), "pos")
    if d % 8 or bk % 128 or g * d > RING_MAX_GD:
        raise ValueError(f"ring decode kernel: needs D % 8 == 0, "
                         f"bk % 128 == 0, G * D <= {RING_MAX_GD} (D={d}, "
                         f"bk={bk}, G={g})")
    qmax = (1 << attn_bits) - 1
    out = torch.empty((h, g, d), dtype=torch.float32, device=dev)
    codes = torch.zeros((h, g, span), dtype=torch.uint8, device=dev) \
        if return_codes else None
    lib = build.load("int_attention")
    fn = lib.ring_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q_q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(),
            k_positions.data_ptr(), pos.data_ptr(), sc.data_ptr(),
            vs.data_ptr(), out.data_ptr(),
            None if codes is None else codes.data_ptr(),
            h, g, d, span, bk, int(causal),
            -1 if window is None else int(window), int(packed), float(qmax),
            _f32(2.0 / qmax), build.stream_ptr(q_q))
    build.check(lib, rc, "int_decode_attention")
    LAUNCHES["int_decode_attention"] += 1
    return (out, codes) if return_codes else out


def _check(t, dtype, shape, name):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous() or \
            t.data_ptr() % 4:
        raise ValueError(f"int attention: {name} must be a contiguous, "
                         f"4-byte aligned CUDA {dtype} tensor of shape "
                         f"{shape}; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
