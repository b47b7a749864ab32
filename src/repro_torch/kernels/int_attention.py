"""Integer attention with the embedded base-2 softmax: CUDA kernels + plain
versions.

The four kernels live in ``csrc/int_attention.cu`` and share the online
quantizer of ``kernels/ref.py`` (running integer ``m``, codes on the
power-of-two Sigma grid, PV carries rescaled by exact powers of two):

- :func:`int_attention_fused` replaces the Pallas TPU kernel
  ``repro/kernels/int_attention.py::int_attention_fused`` (``:522``): the
  prompt-prefill kernel.  One CUDA block per (head-fold, tile of query
  rows) loops over its own live key blocks (the TPU walked them as a
  sequential grid axis through a scalar-prefetched block map), with QK^T
  and PV on the int8 tensor cores (``mma.sync``).  ``bk`` is part of the
  semantics: codes are quantized against the running max one key block at
  a time, so the plain version runs at the same ``bk``
  (:func:`repro_torch.kernels.ref.int_attention_ref_streamed`).  ``bq``
  is not: it only says which scale each row takes, and the kernel's row
  tile is its own (:func:`attention_plan`).  Bound: int8 operations.
- :func:`int_attention` replaces the two-pass baseline
  ``repro/kernels/int_attention.py::int_attention`` (``:469``, calls at
  ``:496`` and ``:506``): a Sigma pass, then a PV pass that recomputes the
  codes — the fused kernel's device code run twice, so it equals the
  fused kernel bit for bit.
- :func:`int_paged_decode_attention` replaces
  ``repro/kernels/int_attention.py::int_paged_decode_attention``
  (``:661``, ``pl.pallas_call`` at ``:752``): every engine decode step.  A
  sequence's pages are split across the card in chunks of
  :func:`paged_plan` whole pages, one block per (chunk, kv head,
  sequence), and the codes stay exact: a page's running max is the floor
  of a maximum over page maxima, the same in any order.  Three launches:
  each chunk's logits and maxima; each live chunk's codes, and its Sigma
  and PV with each page's sums rescaled exactly to the chunk's last max;
  a merge of the chunks in order by the exact power-of-two rescale.  A
  table of one chunk takes one launch that does all three in a block and
  gives the same bits.  Pages without a live key are never read.  Plain
  version: the paged oracle at ``bk = page_size``.  Bound: the live KV
  bytes.
- :func:`int_decode_attention` replaces
  ``repro/kernels/int_attention.py::int_decode_attention`` (``:582``,
  ``pl.pallas_call`` at ``:649``): every decode step over the ring KV
  cache.  The ring is split into chunks of up to 256 keys across the card
  (:func:`ring_plan`), in three launches: chunk logits and maxima, then
  each live chunk's codes, Sigma and int32 PV against its ``bk`` block's
  running max, then a merge of the chunks block by block in slot order.
  Chunks without a live key (from ``k_positions`` and the device-resident
  ``pos``) read nothing, as the TPU's live-block map skipped them.  Plain
  version: :func:`int_decode_attention_plain`, the ring oracle at the same
  ``bk``.  Bound: the live KV bytes.
  :func:`int_decode_attention_staged` runs the same three passes on a ring
  split by slot range over the model ranks of a partitioned program, as
  stages with the ranks' exchanges between them, bit for bit the unsplit
  kernel's output (plain version: the ring's codes gathered, then
  :func:`int_decode_attention_plain`).

Each wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors, and nowhere else.  ``return_codes`` also returns the prob codes,
which is how the kernels are held against the plain versions exactly.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.quant import unpack_int4
from repro_torch.kernels import build, ref

MAX_PROB_BITS = 8
# What the kernels take, stated here and in the C launchers' error returns
# (``csrc/int_attention.cu``); dispatch picks its blocks independently.
SMEM_BUDGET = 232_448     # dynamic shared memory a block may use (227 KB)
CUDA_INVALID_VALUE = 1     # cudaErrorInvalidValue: a launcher's refusal
# Kernel launches (one per wrapper call that launches, bumped nowhere else).
LAUNCHES = {"int_attention_fused": 0, "int_attention": 0,
            "int_paged_decode_attention": 0, "int_decode_attention": 0}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _launch(name: str, n_ptr: int, n_int: int, what: str, *args,
            refused: str | None = None) -> None:
    """Call the C launch function ``name`` of ``csrc/int_attention.cu``
    (argument types, set once: ``n_ptr`` pointers, ``n_int`` ints, qmax and
    2/qmax, the stream) and raise with ``what`` if it returns an error;
    with ``refused``, a shape the launcher refuses raises ValueError."""
    lib = build.load("int_attention")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
            [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(*args)
    if refused is not None and rc == CUDA_INVALID_VALUE:
        raise ValueError(refused)
    build.check(lib, rc, what)


def attention_smem(bm: int, kt: int, bk: int, d: int) -> int:
    """Dynamic shared memory of the fused and two-pass kernels (bytes;
    ``AttnLayout`` in the source) for a tile of ``bm`` query rows, key
    sub-tiles of ``kt`` keys, key block ``bk`` and head dim ``d`` (a
    multiple of 16): the q tile, two sub-tile buffers and the transposed v
    sub-tile at 16-byte-skewed strides, the block's f32 logits and u8
    codes, and five row vectors."""
    dp, bkp = _round_up(d, 32), _round_up(bk, 32)
    return (bm * (dp + 16) + 2 * kt * (dp + 16) + dp * (kt + 16)
            + 4 * bm * (bkp + 8) + bm * (bkp + 16) + 20 * bm)


@functools.lru_cache(maxsize=None)
def attention_plan(bk: int, d: int):
    """(bm, kt) of the fused and two-pass kernels at key block ``bk`` and
    head dim ``d`` (a multiple of 16), or None when no tile fits: the
    tallest row tile (64, 32, 16) with at most 8 PV column pairs a warp
    (256 threads as bm/16 row warps by 128/bm column warps) and key
    sub-tiles of up to 128 keys within shared memory.  Neither is
    semantics: each row keeps its own scale and position."""
    bkp = _round_up(bk, 32)
    for bm in (64, 32, 16):
        if -(-(_round_up(d, 32) // 16) // (128 // bm)) > 8:
            continue
        for kt in (min(bkp, 128), 64, 32):
            if kt <= bkp and attention_smem(bm, kt, bk, d) <= SMEM_BUDGET:
                return bm, kt
    return None


@functools.lru_cache(maxsize=None)
def paged_plan(g: int, d: int, page_size: int, packed: bool) -> int:
    """Pages a chunk of the paged decode kernel: as many whole pages as
    keep a chunk within 256 keys, 64 KB of staged key rows and 64 KB of f32
    logits, and at least one.  It depends on these four values only, never
    on the batch, the table's width or a row's length, so a row is cut into
    the same chunks, merged in the same order, whatever else is in the
    batch (the kernel's launcher checks that the chunk fits the card)."""
    dk = d // 2 if packed else d
    return max(1, min(256 // page_size, 65536 // (page_size * dk),
                      16384 // (g * page_size)))


def ring_smem(g: int, chunk: int, ds: int) -> int:
    """Dynamic shared memory of the ring decode kernels (bytes): the larger
    of the logits pass (q slice, key rows, int32 logits, warp maxima) and
    the PV pass (m, codes, e, transposed value slice) for ``g`` query rows,
    chunks of ``chunk`` keys and D-slices of ``ds`` values."""
    dsw, pw = ds // 4, chunk // 4 + 1
    logits = 4 * (g * dsw + chunk * (dsw + 1) + g * chunk + chunk // 32 * g)
    pv = 4 * (g + g * pw + g * chunk + ds * pw)
    return max(logits, pv)


@functools.lru_cache(maxsize=None)
def ring_plan(g: int, d: int, bk: int):
    """(chunk, ds) of the ring decode kernels, or None when nothing fits:
    the largest chunk of 256, 128, 64 or 32 keys dividing ``bk`` (a chunk
    never straddles two key blocks) and D-slices of up to 256 values, within
    shared memory."""
    ds = min(_round_up(d, 16), 256)
    for chunk in (256, 128, 64, 32):
        if bk % chunk == 0 and ring_smem(g, chunk, ds) <= SMEM_BUDGET:
            return chunk, ds
    return None


def _on(x, dtype, shape, device):
    """``x`` (a number or a tensor that broadcasts to ``shape``) as a
    contiguous ``dtype`` tensor of ``shape`` on ``device``; a tensor that
    already is one is returned as it is (this runs on every launch)."""
    if isinstance(x, torch.Tensor) and x.dtype == dtype and \
            x.device == device and x.shape == shape and x.is_contiguous():
        return x
    x = torch.as_tensor(x, dtype=dtype, device=device)
    if len(shape) == 1:
        x = x.reshape(-1)
    elif x.ndim == 1:
        x = x[None, :]
    return x.expand(shape).contiguous()


def grid_scales(sc, v_scale, h, nq, device):
    """Broadcast the epilogue scales to their grid shapes: ``sc`` (scalar,
    (nq,) or (h, nq)) -> (h, nq) f32; ``v_scale`` (scalar or (h,)) -> (h,)."""
    return (_on(sc, torch.float32, (h, nq), device),
            _on(v_scale, torch.float32, (h,), device))


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


def _launch_prefill(name, q_q, k_q, v_q, sc, v_scale, attn_bits, causal,
                    window, bq, bk, sq_mod, return_codes):
    """Launch the fused kernel, or the two passes, on CUDA tensors.

    Handled exactly here: D not a multiple of 16 is padded with zero codes
    (exact for the int32 dot products; the padded output columns are
    dropped).  What remains that the kernel cannot take (a head dim or key
    block whose tiles exceed shared memory) raises with the shape."""
    h, sq, d = q_q.shape
    sk = k_q.shape[1]
    nq = -(-sq // bq)
    sc2, vs = grid_scales(sc, v_scale, h, nq, q_q.device)
    d16 = _round_up(d, 16)
    for nm, t, shape in (("q_q", q_q, (h, sq, d)), ("k_q", k_q, (h, sk, d)),
                         ("v_q", v_q, (h, sk, d))):
        # 16-byte rows for cp.async; padded operands are fresh copies
        _check(t, torch.int8, shape, nm, 16 if d16 == d else 1)
    plan = attention_plan(bk, d16) if bk > 0 else None
    if plan is None:
        raise ValueError(
            f"{name} kernel: no tile of its rows fits {SMEM_BUDGET} bytes of "
            f"shared memory (H={h}, Sq={sq}, Sk={sk}, D={d}, bq={bq}, "
            f"bk={bk})")
    bm, kt = plan
    if d16 != d:
        pad = (0, d16 - d)
        q_q, k_q, v_q = (F.pad(t, pad) for t in (q_q, k_q, v_q))
    qmax = (1 << attn_bits) - 1
    out = torch.empty((h, sq, d16), dtype=torch.float32, device=q_q.device)
    codes = torch.zeros((h, sq, sk), dtype=torch.uint8, device=q_q.device) \
        if return_codes else None
    ptrs = [q_q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), sc2.data_ptr(),
            vs.data_ptr(), out.data_ptr(),
            None if codes is None else codes.data_ptr()]
    tail = [h, sq, sk, d16, bq, bk, sq_mod or sq, int(causal),
            -1 if window is None else int(window), bm, kt, float(qmax),
            ref.f32(2.0 / qmax), build.stream_ptr(q_q)]
    what = (f"{name} (H={h}, Sq={sq}, Sk={sk}, D={d}, bq={bq}, bk={bk}, "
            f"{bm}-row tiles)")
    if name == "int_attention":
        sums = torch.empty((h, sq), dtype=torch.float32, device=q_q.device)
        _launch("two_pass_attention_launch", 8, 11, what, *ptrs,
                sums.data_ptr(), *tail)
    else:
        _launch("fused_attention_launch", 7, 11, what, *ptrs, *tail)
    LAUNCHES[name] += 1
    if d16 != d:
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
    sc = _on(sc, torch.float32, (b,), dev)
    vs = _on(v_scale, torch.float32, (b,), dev)
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
    p = paged_plan(g, d, ps, packed)
    nch = -(-maxp // p)
    qmax = (1 << attn_bits) - 1
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=dev)
    codes = torch.zeros((b, hkv, g, maxp * ps), dtype=torch.uint8,
                        device=dev) if return_codes else None
    scratch = [None] * 4
    if nch > 1:
        # one buffer of f32 words: the logits (B, Hkv, G, maxp * ps), chunk
        # maxima and Sigma partials (B, Hkv, nch, G), PV partials
        # (B, Hkv, nch, G, D)
        n_x, n_c = b * hkv * g * maxp * ps, b * hkv * nch * g
        sizes = [n_x, n_c, n_c, n_c * d]
        buf = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
        scratch = [buf.data_ptr() + 4 * sum(sizes[:i]) for i in range(4)]
    shape = f"B={b}, Hkv={hkv}, G={g}, D={d}, page_size={ps}, maxp={maxp}"
    _launch(
        "paged_decode_launch", 15, 10, f"int_paged_decode_attention ({shape})",
        q_q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        sc.data_ptr(), vs.data_ptr(),
        None if k_page_scale is None else k_page_scale.data_ptr(),
        None if v_page_scale is None else v_page_scale.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if codes is None else codes.data_ptr(), *scratch,
        b, hkv, g, d, ps, p, maxp, num_phys,
        -1 if window is None else int(window), int(packed), float(qmax),
        ref.f32(2.0 / qmax), build.stream_ptr(q_q),
        refused=f"paged decode kernel: a chunk of {p} pages does not fit "
                f"{SMEM_BUDGET} bytes of shared memory ({shape})")
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
    sc = _on(sc, torch.float32, (h,), dev)
    vs = _on(v_scale, torch.float32, (h,), dev)
    pos = _on(pos, torch.int32, (1,), dev)
    _check(q_q, torch.int8, (h, g, d), "q_q")
    ring_dt = torch.uint8 if packed else torch.int8
    _check(k_q, ring_dt, (h, span, dk), "k_q")
    _check(v_q, ring_dt, (h, span, dk), "v_q")
    _check(k_positions, torch.int32, (span,), "k_positions")
    _check(pos, torch.int32, (1,), "pos")
    plan = ring_plan(g, d, bk) if bk > 0 else None
    if plan is None:
        raise ValueError(f"ring decode kernel: needs bk % 32 == 0 and a "
                         f"chunk within {SMEM_BUDGET} bytes of shared memory "
                         f"(H={h}, G={g}, D={d}, span={span}, bk={bk})")
    chunk, ds = plan
    nch = -(-span // chunk)
    qmax = (1 << attn_bits) - 1
    out = torch.empty((h, g, d), dtype=torch.float32, device=dev)
    codes = torch.zeros((h, g, span), dtype=torch.uint8, device=dev) \
        if return_codes else None
    # one scratch buffer of 4-byte words: the logits xs (H, G, span) f32,
    # chunk maxima and Sigma partials (H, nch, G) f32, int32 PV partials
    # (H, nch, G, D)
    n_x, n_c = h * g * span, h * nch * g
    scratch = torch.empty((n_x + 2 * n_c + n_c * d,), dtype=torch.int32,
                          device=dev)
    base = scratch.data_ptr()
    _launch(
        "ring_decode_launch", 13, 10, "int_decode_attention",
        q_q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(),
        k_positions.data_ptr(), pos.data_ptr(), sc.data_ptr(),
        vs.data_ptr(), out.data_ptr(),
        None if codes is None else codes.data_ptr(), base,
        base + 4 * n_x, base + 4 * (n_x + n_c), base + 4 * (n_x + 2 * n_c),
        h, g, d, span, bk, chunk, ds, int(causal),
        -1 if window is None else int(window), int(packed), float(qmax),
        ref.f32(2.0 / qmax), build.stream_ptr(q_q))
    LAUNCHES["int_decode_attention"] += 1
    return (out, codes) if return_codes else out


def staged_ring_plan(g: int, d: int, bk: int, span: int, parts: int):
    """(chunk, ds) of the staged ring (:func:`int_decode_attention_staged`)
    where each of ``parts`` slot ranges of ``span`` slots is a whole number
    of the one-rank kernel's chunks, else None (the caller gathers the
    ring)."""
    plan = ring_plan(g, d, bk) if bk > 0 and bk % 32 == 0 else None
    if plan is None or span % parts or (span // parts) % plan[0]:
        return None
    return plan


def int_decode_attention_staged(q_q, k_q, v_q, sc, v_scale, k_positions,
                                pos, *, parts, index, gather, reduce,
                                attn_bits=7, causal=True, window=None, bk,
                                packed=False, return_codes=False):
    """The ring decode kernel on a ring split by slot range over ``parts``
    ranks: this rank holds slots ``[index * n, (index + 1) * n)`` of the
    ``parts * n``-slot ring (``k_q``, ``v_q`` (H, n, D) int8 or (H, n, D/2)
    nibbles, ``k_positions`` (n,) their positions), ``q_q`` (H, G, D) and
    the scales as :func:`int_decode_attention`.  Its three launches run as
    stages with the exchanges of the model ranks between them
    (``gather(t)``: all-gather along dim 1 in rank order; ``reduce(t)``:
    the int32 sum over the ranks): the chunk maxima gathered, the Sigma
    partials gathered and the per-block int32 PV summed, and every rank
    merges the whole ring.  Each value is the one the unsplit kernel makes,
    so the output equals :func:`int_decode_attention` on the whole ring
    bit for bit.  On CPU tensors its plain version gathers the ring's
    codes and slot map and runs :func:`int_decode_attention_plain`, the
    oracle, whose Sigma sums whole blocks.  Needs :func:`staged_ring_plan`.
    Returns (H, G, D) f32 (and the rank's (H, G, n) codes); one launch
    counted a call."""
    if attn_bits > MAX_PROB_BITS:
        raise ValueError(f"prob codes are <= {MAX_PROB_BITS}-bit")
    h, g, d = q_q.shape
    n, dk = k_q.shape[1], k_q.shape[2]
    if dk * (2 if packed else 1) != d:
        raise ValueError(f"ring decode: q {tuple(q_q.shape)} vs ring "
                         f"{tuple(k_q.shape)} (packed={packed})")
    plan = staged_ring_plan(g, d, bk, n * parts, parts)
    if plan is None:
        raise ValueError(f"staged ring decode: a slot range of {n} is not "
                         f"whole chunks at bk={bk} (G={g}, D={d})")
    chunk, ds = plan
    if q_q.device.type == "cpu":
        out = int_decode_attention_plain(
            q_q, gather(k_q), gather(v_q), sc, v_scale,
            gather(k_positions[None])[0], pos, attn_bits=attn_bits,
            causal=causal, window=window, bk=bk, packed=packed,
            return_codes=return_codes)
        if not return_codes:
            return out
        return out[0], out[1][..., index * n:(index + 1) * n].contiguous()
    c0 = index * (n // chunk)
    xs, cm = ring_stage_logits(q_q, k_q, k_positions, pos, sc, chunk=chunk,
                               ds=ds, causal=causal, window=window,
                               packed=packed)
    cm = gather(cm)
    sp, pvb, codes = ring_stage_pv(v_q, xs, cm, c0=c0, bk=bk, chunk=chunk,
                                   ds=ds, attn_bits=attn_bits, packed=packed,
                                   return_codes=return_codes)
    out = ring_stage_merge(gather(sp), reduce(pvb), cm, v_scale, bk=bk,
                           chunk=chunk, attn_bits=attn_bits)
    return (out, codes) if return_codes else out


def ring_stage_logits(q_q, k_q, k_positions, pos, sc, *, chunk, ds,
                      causal=True, window=None, packed=False):
    """Stage 1 of the staged ring on a rank's slots (CUDA tensors): the
    logits (H, G, n) f32 and the rank's chunk maxima (H, n / chunk, G)."""
    h, g, d = q_q.shape
    n, dk = k_q.shape[1], k_q.shape[2]
    dev = q_q.device
    sc = _on(sc, torch.float32, (h,), dev)
    pos = _on(pos, torch.int32, (1,), dev)
    _check(q_q, torch.int8, (h, g, d), "q_q")
    _check(k_q, torch.uint8 if packed else torch.int8, (h, n, dk), "k_q")
    _check(k_positions, torch.int32, (n,), "k_positions")
    xs = torch.empty((h, g, n), dtype=torch.float32, device=dev)
    cm = torch.empty((h, n // chunk, g), dtype=torch.float32, device=dev)
    _launch("ring_stage_logits_launch", 7, 9, "ring stage 1 (logits)",
            q_q.data_ptr(), k_q.data_ptr(), k_positions.data_ptr(),
            pos.data_ptr(), sc.data_ptr(), xs.data_ptr(), cm.data_ptr(),
            h, g, d, n, chunk, ds, int(causal),
            -1 if window is None else int(window), int(packed), 0.0, 0.0,
            build.stream_ptr(q_q))
    return xs, cm


def ring_stage_pv(v_q, xs, cm, *, c0, bk, chunk, ds, attn_bits=7,
                  packed=False, return_codes=False):
    """Stage 2 of the staged ring on a rank's slots (chunks ``c0 ..`` of
    the ring whose maxima ``cm`` (H, nch, G) holds): the Sigma partials
    (H, n / chunk, G) f32, the rank's int32 PV of each ``bk`` block (H,
    nblk, G, D) and its codes (H, G, n) (or None)."""
    h, g, n = xs.shape
    d = v_q.shape[2] * (2 if packed else 1)
    nloc, nch = n // chunk, cm.shape[1]
    nblk = -(-nch // (bk // chunk))
    dev = xs.device
    _check(v_q, torch.uint8 if packed else torch.int8,
           (h, n, v_q.shape[2]), "v_q")
    _check(cm, torch.float32, (h, nch, g), "cm")
    qmax = (1 << attn_bits) - 1
    sp = torch.empty((h, nloc, g), dtype=torch.float32, device=dev)
    pvp = torch.empty((h, nloc, g, d), dtype=torch.int32, device=dev)
    pvb = torch.empty((h, nblk, g, d), dtype=torch.int32, device=dev)
    codes = torch.zeros((h, g, n), dtype=torch.uint8, device=dev) \
        if return_codes else None
    _launch("ring_stage_pv_launch", 7, 10, "ring stage 2 (codes, PV)",
            v_q.data_ptr(), xs.data_ptr(), cm.data_ptr(),
            None if codes is None else codes.data_ptr(), sp.data_ptr(),
            pvp.data_ptr(), pvb.data_ptr(), h, g, d, n, bk, chunk, ds, c0,
            nch, int(packed), float(qmax), ref.f32(2.0 / qmax),
            build.stream_ptr(xs))
    return sp, pvb, codes


def ring_stage_merge(sp, pvb, cm, v_scale, *, bk, chunk, attn_bits=7):
    """Stage 3 of the staged ring, on every rank alike: the whole ring's
    maxima ``cm`` and Sigma partials ``sp`` (H, nch, G) and per-block
    int32 PV ``pvb`` merged in slot order (H, G, D) f32.  Counts the
    staged call's launch."""
    h, nch, g = cm.shape
    d = pvb.shape[-1]
    dev = cm.device
    vs = _on(v_scale, torch.float32, (h,), dev)
    _check(sp, torch.float32, (h, nch, g), "sp")
    _check(pvb, torch.int32, (h, pvb.shape[1], g, d), "pvb")
    qmax = (1 << attn_bits) - 1
    out = torch.empty((h, g, d), dtype=torch.float32, device=dev)
    _launch("ring_stage_merge_launch", 5, 6, "ring stage 3 (merge)",
            cm.data_ptr(), sp.data_ptr(), pvb.data_ptr(), vs.data_ptr(),
            out.data_ptr(), h, g, d, nch, bk, chunk, float(qmax),
            ref.f32(2.0 / qmax), build.stream_ptr(cm))
    LAUNCHES["int_decode_attention"] += 1
    return out


def _check(t, dtype, shape, name, align=4):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous() or \
            t.data_ptr() % align:
        raise ValueError(f"int attention: {name} must be a contiguous, "
                         f"{align}-byte aligned CUDA {dtype} tensor of shape "
                         f"{shape}; got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
