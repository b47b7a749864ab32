"""Integer attention with the embedded base-2 softmax: CUDA kernels + plain
versions.

The four kernels live in ``csrc/int_attention.cu`` and share the online
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
- :func:`int_attention` replaces the two-pass baseline
  ``repro/kernels/int_attention.py::int_attention`` (``:469``, calls at
  ``:496`` and ``:506``): a Sigma pass, then a PV pass that recomputes the
  codes — the fused kernel's device code run twice, so it equals the
  fused kernel bit for bit.
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

import torch
import torch.nn.functional as F

from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import build, ref

MAX_PROB_BITS = 8
# What the kernels take, stated here and in the C launchers' error returns
# (``csrc/int_attention.cu``); dispatch picks its blocks from these.
SMEM_BUDGET = 232_448     # dynamic shared memory a block may use (227 KB)
FUSED_MAX_BQD = 8192      # fused / two-pass: bq * D output accumulators
PAGED_MAX_GD = 2048       # paged decode: G * D output accumulators a block
RING_MAX_GD = 2048        # ring decode: G * D output accumulators a block
# Kernel launches (one per wrapper call that launches, bumped nowhere else).
LAUNCHES = {"int_attention_fused": 0, "int_attention": 0,
            "int_paged_decode_attention": 0, "int_decode_attention": 0}


def fused_smem(bq: int, bk: int, d: int) -> int:
    """Dynamic shared memory of the fused and two-pass kernels (bytes): q
    and k tiles, transposed v tile, f32 logits, u8 codes (word-padded
    rows), and three f32 row vectors."""
    qs, ps = d // 4 + 1, bk // 4 + 1
    return 4 * (bq * qs + bk * qs + d * ps + bq * bk + bq * ps + 3 * bq)


def paged_smem(g: int, page_size: int, d: int) -> int:
    """Dynamic shared memory of the paged decode kernel (bytes)."""
    qs, ps = d // 4 + 1, page_size // 4 + 1
    return 4 * (g * qs + page_size * qs + d * ps + g * page_size + g * ps
                + 3 * g)


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
    out, codes = _launch_prefill("int_attention_fused", q_q, k_q, v_q, sc,
                                 v_scale, attn_bits, causal, window, bq, bk,
                                 sq_mod, return_codes)
    return (out, codes) if return_codes else out


# The two-pass kernel's plain version is the fused kernel's: both passes
# make the running-m code sequence of ``ref.int_attention_ref_streamed``.
int_attention_plain = int_attention_fused_plain


def int_attention(q_q, k_q, v_q, sc, v_scale, *, attn_bits=7, causal=True,
                  window=None, bq, bk, sq_mod=None, return_codes=False):
    """Two-pass integer attention (the reference's baseline design), same
    contract as :func:`int_attention_fused`.

    Replaces ``repro/kernels/int_attention.py::int_attention`` (``:469``;
    ``_stats_kernel`` at ``:496``, ``_pv_kernel`` at ``:506``).  Pass 1
    sweeps K once for Sigma per row and writes ``max(Sigma, 1e-30)`` to an
    (H, nq * bq) f32 buffer; pass 2 re-sweeps K, recomputes QK^T and the
    same running-m codes, accumulates integer PV and writes
    ``acc * ((2/qmax) / Sigma * dv)``.  Both are the fused kernel's device
    code (``csrc/int_attention.cu``, one template), so the codes, Sigma's
    summation order and the output equal the fused kernel's bit for bit.
    QK^T runs twice: 3/2 of the fused kernel's int8 operations.  One
    launch is counted per call (its two kernels).
    """
    if attn_bits > MAX_PROB_BITS:
        raise ValueError(f"prob codes are <= {MAX_PROB_BITS}-bit")
    if q_q.device.type == "cpu":
        return int_attention_plain(
            q_q, k_q, v_q, sc, v_scale, attn_bits=attn_bits, causal=causal,
            window=window, bq=bq, bk=bk, sq_mod=sq_mod,
            return_codes=return_codes)
    out, codes = _launch_prefill("int_attention", q_q, k_q, v_q, sc, v_scale,
                                 attn_bits, causal, window, bq, bk, sq_mod,
                                 return_codes)
    return (out, codes) if return_codes else out


def _tile_rows(bq: int, d: int) -> int:
    """Rows of one kernel tile for a requested q block of ``bq`` rows at
    head dim ``d`` (already a multiple of 4): the largest divisor of ``bq``
    with ``rows * d <= FUSED_MAX_BQD``.  ``bq`` is not semantics — each
    kernel tile takes its q block's scale — so a block too tall for the
    kernel's accumulators runs as several tiles; 0 when even one row is
    too wide (D > FUSED_MAX_BQD)."""
    return next((x for x in range(min(bq, FUSED_MAX_BQD // d), 0, -1)
                 if bq % x == 0), 0)


def _launch_prefill(name, q_q, k_q, v_q, sc, v_scale, attn_bits, causal,
                    window, bq, bk, sq_mod, return_codes):
    """Launch the fused kernel, or the two passes, on CUDA tensors.

    Handled exactly here: D not a multiple of 4 is padded with zero codes
    (exact for the int32 dot products; the padded output columns are
    dropped) and a q block taller than the accumulators allow runs as
    several kernel tiles.  What remains that the kernel cannot take
    (``bk % 4``, D > FUSED_MAX_BQD, tiles over shared memory) raises."""
    h, sq, d = q_q.shape
    sk = k_q.shape[1]
    nq = -(-sq // bq)
    sc2, vs = grid_scales(sc, v_scale, h, nq, q_q.device)
    for nm, t, shape in (("q_q", q_q, (h, sq, d)), ("k_q", k_q, (h, sk, d)),
                         ("v_q", v_q, (h, sk, d))):
        _check(t, torch.int8, shape, nm)
    d4 = -(-d // 4) * 4
    rows = _tile_rows(bq, d4)
    smem = fused_smem(rows, bk, d4) if rows else 0
    if bk % 4 or not rows or smem > SMEM_BUDGET:
        raise ValueError(
            f"{name} kernel: needs bk % 4 == 0, D <= {FUSED_MAX_BQD} and "
            f"tiles within {SMEM_BUDGET} bytes of shared memory (H={h}, "
            f"Sq={sq}, Sk={sk}, D={d}, bq={bq}, bk={bk}: {smem} bytes)")
    if d4 != d:
        pad = (0, d4 - d)
        q_q, k_q, v_q = (F.pad(t, pad) for t in (q_q, k_q, v_q))
    if rows != bq:
        nk_t = -(-sq // rows)
        sc2 = torch.repeat_interleave(sc2, bq // rows,
                                      dim=1)[:, :nk_t].contiguous()
    qmax = (1 << attn_bits) - 1
    out = torch.empty((h, sq, d4), dtype=torch.float32, device=q_q.device)
    codes = torch.zeros((h, sq, sk), dtype=torch.uint8, device=q_q.device) \
        if return_codes else None
    lib = build.load("int_attention")
    ptrs = [q_q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), sc2.data_ptr(),
            vs.data_ptr(), out.data_ptr(),
            None if codes is None else codes.data_ptr()]
    tail = [h, sq, sk, d4, rows, bk, sq_mod or sq, int(causal),
            -1 if window is None else int(window), float(qmax),
            ref.f32(2.0 / qmax), build.stream_ptr(q_q)]
    if name == "int_attention":
        sums = torch.empty((h, sc2.shape[1] * rows), dtype=torch.float32,
                           device=q_q.device)
        fn = lib.two_pass_attention_launch
        ptrs.append(sums.data_ptr())
    else:
        fn = lib.fused_attention_launch
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 9 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(*ptrs, *tail)
    build.check(lib, rc, f"{name} (H={h}, Sq={sq}, Sk={sk}, D={d}, "
                         f"bq={bq} as {rows}-row tiles, bk={bk})")
    LAUNCHES[name] += 1
    if d4 != d:
        out = out[..., :d].contiguous()
    return out, codes


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
    smem = paged_smem(g, ps, d)
    if d % 4 or ps % 4 or g * d > PAGED_MAX_GD or smem > SMEM_BUDGET:
        raise ValueError(f"paged decode kernel: needs D % 4 == 0, "
                         f"page_size % 4 == 0, G * D <= {PAGED_MAX_GD} and "
                         f"a page within {SMEM_BUDGET} bytes of shared "
                         f"memory (D={d}, page_size={ps}, G={g}: {smem} "
                         f"bytes)")
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
            ref.f32(2.0 / qmax), build.stream_ptr(q_q))
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
            ref.f32(2.0 / qmax), build.stream_ptr(q_q))
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
