"""Kernel backend dispatch: route the ``mode="int"`` serving graph onto the
hand-written CUDA kernels.

Counterpart of ``repro/kernels/dispatch.py``.  The model graph calls
:func:`maybe_qlinear`, :func:`maybe_qexpert` (the MoE expert products),
:func:`maybe_attention` (prompt prefill, and ring decode steps) and
:func:`maybe_paged_attention`; each either lowers onto a kernel wrapper
(ND->2D flattening, packed int4 weights, GQA/batch folding, per-sequence
activation grids, block choices) or returns ``None``, and the caller runs
the plain PyTorch path.

Backends (the reference's ``"pallas"`` / ``"xla"``):

- ``"cuda"`` (default): the kernel route.  The wrappers launch the CUDA
  kernels on CUDA tensors and run the kernels' plain versions on CPU
  tensors — the CPU counterpart of the reference's interpret mode.
- ``"torch"``: the plain PyTorch path of the model graph (the reference's
  XLA path).  On CUDA tensors it runs only when selected explicitly.

Selection: ``QuantConfig.backend`` per model, else the process default
(``"cuda"``; :func:`use_backend` scopes another); then the shape policy
(``*_supported``) sends shapes no kernel takes to the plain path, counted
as such.

:data:`STATS` keeps the reference's counters with ``pallas`` -> ``cuda``
and ``xla`` -> ``torch`` in the backend keys; the engine's counters
(preemptions, prefill accounting, ...) keep their names.  It counts
dispatches; the kernels' own launch counts are ``LAUNCHES`` in
``kernels/qmatmul.py``, ``kernels/int_attention.py`` and
``kernels/pq_layernorm.py`` (:func:`launch_counts`).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.softmax2 import LOG2E
from repro_torch.distributed.partition import (heads_max, rows_max,
                                               tensor_max)
from repro_torch.kernels import int_attention as _attn_mod
from repro_torch.kernels import pq_layernorm as _pqln_mod
from repro_torch.kernels import qmatmul as _qmm_mod
from repro_torch.kernels import ref
from repro_torch.kernels.int_attention import (
    MAX_PROB_BITS, SMEM_BUDGET, int_attention_fused, int_decode_attention,
    int_decode_attention_staged, int_paged_decode_attention,
    staged_ring_plan)
from repro_torch.kernels.qmatmul import plan as qmatmul_plan
from repro_torch.kernels.qmatmul import qmatmul, qmatmul_acc

_VALID = ("cuda", "torch")


def _checked(name: str, source: str) -> str:
    if name not in _VALID:
        raise ValueError(f"unknown kernel backend {name!r} from {source}; "
                         f"expected one of {_VALID}")
    return name


_backend = ["cuda"]

STATS = {"qlinear_cuda": 0, "qlinear_torch": 0,
         # the rank's product of a row-parallel shard body
         "qlinear_row_cuda": 0, "qlinear_row_torch": 0,
         # a partitioned row-parallel linear's int32 sums
         "qlinear_acc_cuda": 0, "qlinear_acc_torch": 0,
         "qexpert_cuda": 0, "qexpert_torch": 0,
         "attention_cuda": 0, "attention_paged_cuda": 0,
         "attention_paged_torch": 0, "attention_torch": 0,
         "attention_decode_cuda": 0, "attention_decode_torch": 0,
         "cow_page_copies": 0,
         # failure-handling counters, bumped by launch/engine.py
         "preemptions": 0, "resumes": 0, "cancelled": 0, "expired": 0,
         "watchdog_fires": 0, "audit_failures": 0, "forced_xla_steps": 0,
         "quarantined": 0,
         # admission-prefill accounting, bumped by launch/engine.py
         "prefill_calls": 0, "prefill_chunks": 0, "prefill_tokens": 0,
         # chosen tile sizes per (op, shape)
         "blocks": {}}


def reset_stats():
    for k in STATS:
        STATS[k] = {} if k == "blocks" else 0


def snapshot() -> dict:
    """JSON-serializable copy of STATS (the blocks dict copied)."""
    return {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in STATS.items()}


def launch_counts() -> dict:
    """Every CUDA kernel's launch count (the wrappers' own counters)."""
    return {**_qmm_mod.LAUNCHES, **_attn_mod.LAUNCHES, **_pqln_mod.LAUNCHES}


def reset_launches():
    for counts in (_qmm_mod.LAUNCHES, _attn_mod.LAUNCHES,
                   _pqln_mod.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _record_blocks(op: str, key: str, *choice):
    STATS["blocks"][f"{op}:{key}"] = list(choice)


def get_backend() -> str:
    return _backend[-1]


@contextlib.contextmanager
def use_backend(name: str):
    _backend.append(_checked(name, "use_backend"))
    try:
        yield
    finally:
        _backend.pop()


def resolve_backend(cfg) -> str:
    b = getattr(cfg, "backend", None)
    if b is None:
        return get_backend()
    return _checked(b, "QuantConfig.backend")


# ---------------------------------------------------------------------------
# Block choices for the H100 (the kernels' own limits live in their modules:
# ``int_attention.attention_plan``, ``ring_plan``, ``SMEM_BUDGET``)
# ---------------------------------------------------------------------------

# The reference's tile budget (TPU VMEM) and lane width.  ``bk`` of the
# decode kernels is semantics (each block quantizes at the running max), so
# the port keeps the reference's choices and budget checks rather than ones
# derived from shared memory, and matches them block for block.
VMEM_BUDGET = 6 * 2 ** 20
_LANE = 128


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def qmatmul_blocks(m: int, n: int, k: int) -> tuple[str, int, int, int]:
    """``(body, bm, bn, splits)``: the kernel's own
    :func:`repro_torch.kernels.qmatmul.plan`, recorded in ``STATS``."""
    choice = qmatmul_plan(m, n, k)
    _record_blocks("qmatmul", f"m{m}_n{n}_k{k}", *choice)
    return choice


def block_rule_bytes(bq: int, bk: int, d: int) -> int:
    """The byte count that fixes the prefill blocks (the first fused
    kernel's tiles: q, k and transposed v words, f32 logits, code words,
    three row vectors).  ``bk`` is semantics, so the rule stays as it was
    set; the kernel's own tiles (``int_attention.attention_plan``) fit
    every choice it makes."""
    qs, ps = d // 4 + 1, bk // 4 + 1
    return 4 * (bq * qs + bk * qs + d * ps + bq * bk + bq * ps + 3 * bq)


def attention_blocks(sq: int, sk: int, d: int, *,
                     window: Optional[int] = None,
                     chunk: Optional[int] = None) -> tuple[int, int]:
    """(bq, bk) for the fused attention kernel.

    ``bq * d <= 8192``, at most 64 rows.  ``bk`` prefers covering the whole
    key row (then the online grid equals the full-row grid of the plain
    ``torch`` path) up to 512 keys, and halves until
    :func:`block_rule_bytes` is within the card's shared memory (256 keys at
    d = 128).  Narrow local windows over long keys cap ``bk`` near the
    ``bq + window`` live span.  ``chunk`` caps ``bq`` to a divisor of the
    query-recalibration chunk so one scale tile never straddles two
    activation grids.  ``d`` is taken rounded up to int8 words.
    """
    dw = _round_up(d, 4)
    bq = min(_round_up(sq, 16), 64, max(1, 8192 // dw))
    narrow = window is not None and sk > 2 * window
    cap = 512
    if narrow:
        cap = min(cap, _round_up(bq + window, 32))
    bk = min(_round_up(sk, 32), cap)
    while block_rule_bytes(bq, bk, dw) > SMEM_BUDGET and bk > 32:
        bk = max(32, _round_up(bk // 2, 32))
    while block_rule_bytes(bq, bk, dw) > SMEM_BUDGET and bq > 16:
        bq //= 2
    if chunk is not None:
        bq = next(x for x in range(min(bq, chunk), 0, -1) if chunk % x == 0)
    _record_blocks("attention", f"sq{sq}_sk{sk}_d{d}_w{window}_c{chunk}",
                   bq, bk)
    return bq, bk


def paged_decode_blocks(page_size: int, d: int) -> int:
    """Key-block size of the paged decode kernel: one page per block (pages
    are physically scattered), as the reference chooses it — 0 (plain path)
    only when a page overflows the reference's tile budget.  A page the
    card's kernel cannot take is the wrapper's error, not a plain-path
    route."""
    bk = 0 if 2 * page_size * d + 17 * 8 * d > VMEM_BUDGET else page_size
    _record_blocks("paged_decode", f"ps{page_size}_d{d}", bk)
    return bk


def decode_blocks(span: int, d: int) -> int:
    """``bk`` of the ring decode kernel over a ``span``-slot ring, as the
    reference chooses it: one block over the whole ring (then the running
    grid is the full-row grid of the plain path, bit for bit) up to 4096
    keys; longer rings stream in 4096-key blocks."""
    bk = min(_round_up(span, _LANE), 4096)
    while 2 * bk * d + 4 * bk + 17 * 8 * d > VMEM_BUDGET and bk > _LANE:
        bk = max(_LANE, _round_up(bk // 2, _LANE))
    _record_blocks("decode", f"span{span}_d{d}", bk)
    return bk


# ---------------------------------------------------------------------------
# Linear: ND activation x integerized weight -> qmatmul
# ---------------------------------------------------------------------------

def qlinear_supported(x, p) -> bool:
    """Shape policy: can this dense() call lower onto the qmatmul kernel?
    The reference's; a K the kernel's int8 words do not divide is padded
    by the wrapper."""
    w_q = p.get("w_q")
    if w_q is None or w_q.ndim != 2:
        return False
    if x.ndim < 1 or x.shape[-1] == 0 or x.numel() == 0:
        return False
    if w_q.dtype == torch.uint8 and x.shape[-1] % 2:
        return False                          # packed nibbles need even K
    return True


def maybe_qlinear(x, p: dict, cfg):
    """Kernel-backed dense() body; ``None`` -> caller's plain path.

    Flattens leading dims to 2D, quantizes the activation on the plain
    path's grid — per sequence for (B, S, K) through the kernel's per-row
    epilogue scale, per tensor (over every rank's rows when partitioned)
    for (T, K) — keeps nibble-packed weights packed, and folds ``dx * dw``
    plus bias into the epilogue.
    """
    if resolve_backend(cfg) != "cuda" or not qlinear_supported(x, p):
        STATS["qlinear_torch"] += 1
        return None
    STATS["qlinear_cuda"] += 1
    w_q = p["w_q"]
    packed = w_q.dtype == torch.uint8
    kdim = x.shape[-1]
    n = w_q.shape[0]
    if x.ndim == 3:
        codes, row_scale = quantize_rows(x, cfg.a_bits)
        x2 = codes.reshape(-1, kdim)
        scale = p["w_scale"].to(torch.float32)
        row_scale = torch.repeat_interleave(row_scale.to(torch.float32),
                                            x.shape[1])
    else:
        xq = quant.quantize_tensor(x, cfg.a_bits, group=tensor_max)
        x2 = xq.q.reshape(-1, kdim)
        scale = (p["w_scale"] * xq.scale).to(torch.float32)
        row_scale = None
    bias = p.get("b")
    blocks = qmatmul_blocks(x2.shape[0], n, kdim)
    out = qmatmul(x2.contiguous(), w_q, scale.contiguous(),
                  None if bias is None else bias.to(torch.float32),
                  row_scale, blocks=blocks, packed=packed)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


def maybe_qlinear_acc(codes, w_q, cfg):
    """The rank's exact int32 sums of a partitioned row-parallel linear
    (``distributed/partition.py::row_parallel_linear``): ``codes`` (M, K)
    int8 against ``w_q`` (N, K) int8 or (N, K/2) nibbles on qmatmul's
    accumulator output; ``None`` -> the caller's plain path.  Counted as
    ``qlinear_acc_*``."""
    if resolve_backend(cfg) != "cuda":
        STATS["qlinear_acc_torch"] += 1
        return None
    STATS["qlinear_acc_cuda"] += 1
    blocks = qmatmul_blocks(codes.shape[0], w_q.shape[0], codes.shape[1])
    return qmatmul_acc(codes.contiguous(), w_q, blocks=blocks,
                       packed=w_q.dtype == torch.uint8)


def row_codes(w_q, j: int, m: int):
    """Rank ``j`` of ``m``'s contiguous K slice of a global ``w_q`` (N, K)
    int8 or (N, K/2) nibbles (sliced as stored: ``K/m`` is even), as
    qmatmul takes W, for the row-parallel shard body on global tensors
    (``core/api.py::_int_row_parallel`` without partitioned rules; a
    partitioned tree holds its slice already).  Made once per parameter
    tree and kept on the tensor that owns the codes, as
    :func:`expert_codes_t` keeps its copies: together the slices double
    the bytes the row-parallel codes take on the device."""
    owner = w_q if w_q._base is None else w_q._base
    memo = owner.__dict__.setdefault("_row_codes", {})
    key = (w_q.storage_offset(), tuple(w_q.shape), w_q.stride(), j, m)
    if key not in memo:
        unit = w_q.shape[1] // m
        memo[key] = w_q[:, j * unit:(j + 1) * unit].contiguous()
    return memo[key]


def maybe_qlinear_row(codes, w, scale, cfg):
    """The rank's product in the row-parallel shard body
    (``core/api.py::_row_body``): ``codes`` (M, K/m) int8 on the rank's
    per-tensor grid against ``w``, its contiguous K slice (N, K/m) int8 or
    (N, K/2m) nibbles, epilogue ``f32(acc) * scale[n]`` with no bias ->
    f32 (M, N); ``None`` -> the caller's plain path.  Counted as
    ``qlinear_row_*``."""
    if resolve_backend(cfg) != "cuda":
        STATS["qlinear_row_torch"] += 1
        return None
    STATS["qlinear_row_cuda"] += 1
    blocks = qmatmul_blocks(codes.shape[0], w.shape[0], codes.shape[1])
    return qmatmul(codes.contiguous(), w, scale.contiguous(), blocks=blocks,
                   packed=w.dtype == torch.uint8)


# ---------------------------------------------------------------------------
# Expert product: (E, C, din) activations x (E, din, dout) codes -> qmatmul
# ---------------------------------------------------------------------------

def qexpert_supported(x, p) -> bool:
    """Shape policy: can this dense_expert() call lower onto qmatmul?
    int8 expert codes (never nibble-packed) and a non-empty buffer."""
    w_q = p.get("w_q")
    return (w_q is not None and w_q.ndim == 3 and w_q.dtype == torch.int8
            and x.ndim == 3 and x.numel() > 0)


def expert_codes_t(w_q):
    """The ``(E, dout, din)`` contiguous copy of expert codes ``w_q``
    ``(E, din, dout)``, as qmatmul takes W (rows of K).  Made once per
    parameter tree: kept on the tensor that owns the codes (a
    layer-stacked tree's per-layer views share it, one copy a layer), and
    freed with it.  Serving never writes the codes, so the copy stays
    theirs; it doubles the bytes the expert codes take on the device."""
    owner = w_q if w_q._base is None else w_q._base
    memo = owner.__dict__.setdefault("_codes_t", {})
    key = (w_q.storage_offset(), tuple(w_q.shape), w_q.stride())
    if key not in memo:
        memo[key] = w_q.transpose(-1, -2).contiguous()
    return memo[key]


def _aligned(t):
    """``t`` as qmatmul takes an operand: contiguous, 16-byte aligned (an
    expert's slice of a buffer whose layout a reshape kept strided, as
    the all-to-all body's is at one slot a source, gets a copy)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def maybe_qexpert(x, p: dict, cfg, group=heads_max):
    """Kernel-backed int dense_expert() body; ``None`` -> caller's plain
    path.

    Quantizes the whole (E, C, din) buffer on one per-tensor grid, as the
    plain path does (``group``: over every rank's experts when partitioned
    and the dense dispatch splits them; None for the rank's buffer alone,
    as in the all-to-all body), then
    runs each expert's slice through the qmatmul kernel (one launch an
    expert) against :func:`expert_codes_t`, with the epilogue scale
    ``(xq.scale * w_scale)[e, 0]`` in the reference's order:
    ``f32(acc) * scale[n]``, the plain path's product bit for bit.
    """
    if resolve_backend(cfg) != "cuda" or not qexpert_supported(x, p):
        STATS["qexpert_torch"] += 1
        return None
    STATS["qexpert_cuda"] += 1
    xq = quant.quantize_tensor(x, cfg.a_bits, group=group)
    w_t = expert_codes_t(p["w_q"])
    scale = (xq.scale * p["w_scale"]).to(torch.float32)     # (E, 1, dout)
    e, c, din = x.shape
    dout = w_t.shape[1]
    blocks = qmatmul_blocks(c, dout, din)
    out = torch.stack([qmatmul(_aligned(xq.q[i]), _aligned(w_t[i]),
                               scale[i, 0], blocks=blocks)
                       for i in range(e)])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: (B, H, S, D) GQA -> folded (B*Hkv, ...) kernels
# ---------------------------------------------------------------------------

def attention_supported(q, k, spec, cfg, q_offset, k_offset,
                        k_positions) -> bool:
    """Shape policy for the fused (prefill) attention kernel, the
    reference's: keys from position 0 (ring caches go to the decode
    kernel or the plain path), base-2 softmax, <= 8-bit prob codes, no
    nibble-packed q/k.  A D that is not a multiple of 16 is padded by the
    wrapper."""
    if cfg.attn_bits > MAX_PROB_BITS:
        return False
    if getattr(cfg, "softmax", "base2") != "base2":
        return False
    if k_positions is not None:
        return False
    if not (isinstance(q_offset, int) and q_offset == 0
            and isinstance(k_offset, int) and k_offset == 0):
        return False
    if _is_packed(q) or _is_packed(k):
        return False
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    return sq > 0 and k.shape[2] > 0 and hq % hkv == 0 and d > 0


def _is_packed(x) -> bool:
    return isinstance(x, quant.QTensor) and x.is_packed


def decode_supported(q, k, spec, cfg, k_positions) -> bool:
    """Shape policy for the ring decode kernel, the reference's: Sq == 1
    (the G GQA groups become the kernel's rows), one shared (span,) slot ->
    position map, int4 only as nibble pairs.  The kernel takes any G and D
    this accepts at the reference's ``bk``; a shape it could not take would
    raise in its wrapper, never reach the plain path."""
    if cfg.attn_bits > MAX_PROB_BITS:
        return False
    if getattr(cfg, "softmax", "base2") != "base2":
        return False
    if k_positions is None or getattr(k_positions, "ndim", None) != 1:
        return False
    b, hq, sq, d = q.shape
    if sq != 1 or d == 0 or k.shape[2] == 0:
        return False
    hkv = k.shape[1]
    if hq % hkv:
        return False
    if _is_packed(k) and (k.bits != 4 or d % 2):
        return False
    return True


def maybe_attention(q, k, v, spec, cfg, *, q_offset=0, k_offset=0,
                    k_positions=None):
    """Kernel-backed attention() body; ``None`` -> caller's plain path.

    Decode steps over the ring cache (Sq == 1 with ``k_positions``) go to
    the ring decode kernel, prompt prefill to the fused kernel."""
    if resolve_backend(cfg) == "cuda":
        if decode_supported(q, k, spec, cfg, k_positions):
            STATS["attention_decode_cuda"] += 1
            return _decode_call(q, k, v, spec, cfg, q_offset, k_positions)
        if attention_supported(q, k, spec, cfg, q_offset, k_offset,
                               k_positions):
            STATS["attention_cuda"] += 1
            return _fused_call(q, k, v, spec, cfg)
    if k_positions is not None and q.shape[2] == 1:
        STATS["attention_decode_torch"] += 1
    else:
        STATS["attention_torch"] += 1
    return None


def chunk_len(sq: int, q_chunk: int) -> int:
    """The plain path's query-recalibration chunk: largest c <= q_chunk
    dividing Sq."""
    if sq <= q_chunk:
        return sq
    return next(c for c in range(q_chunk, 0, -1) if sq % c == 0)


def _fused_call(q, k, v, spec, cfg):
    """Fold batch into the kernel's head axis and GQA groups along the query
    rows (row r at position ``r % Sq`` via ``sq_mod``).

    Float inputs quantize on per-sequence grids exactly like the plain
    path — k/v per batch row, q per (batch row, query chunk), each over
    every rank's heads when partitioned by head — and the
    resulting (B*Hkv, nq) logit-scale matrix gives each bq tile its own
    scale.  Pre-quantized QTensor operands keep their own single grid, with
    the plain path's association ``scale*LOG2E*dq*dk``.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    out_dtype = q.dtype if not isinstance(q, quant.QTensor) \
        else torch.float32
    scale = spec.softmax_scale or (1.0 / d ** 0.5)
    if any(isinstance(x, quant.QTensor) for x in (q, k, v)):
        qq, kq, vq = (_as_q(x, cfg.a_bits, spec.split_heads)
                      for x in (q, k, v))
        sc = scale * LOG2E * qq.scale * kq.scale
        vs = vq.scale
        qf = qq.q.reshape(b * hkv, g * sq, d)
        kf, vf = kq.q, vq.q
        bq, bk = attention_blocks(g * sq, sk, d, window=spec.window)
    else:
        c = chunk_len(sq, spec.q_chunk)
        n_ch = sq // c
        qr = q.reshape(b, hkv, g, n_ch, c, d)
        grp = heads_max if spec.split_heads else None
        qsc = quant.absmax_scale(qr, cfg.a_bits, axis=(1, 2, 4, 5),
                                 group=grp)
        qf = quant.quantize(qr, qsc, cfg.a_bits).reshape(b * hkv, g * sq, d)
        ksc = quant.absmax_scale(k, cfg.a_bits, axis=(1, 2, 3), group=grp)
        vsc = quant.absmax_scale(v, cfg.a_bits, axis=(1, 2, 3), group=grp)
        kf = quant.quantize(k, ksc, cfg.a_bits)
        vf = quant.quantize(v, vsc, cfg.a_bits)
        bq, bk = attention_blocks(g * sq, sk, d, window=spec.window, chunk=c)
        nq = (g * sq) // bq
        # Tile i covers positions [(i*bq) % sq, +bq) of group (i*bq) // sq
        # — inside one chunk because bq divides c.
        tile_chunk = torch.as_tensor((np.arange(nq) * bq % sq) // c,
                                     device=q.device)
        qs_b = qsc.reshape(b, n_ch)
        sc = scale * LOG2E * qs_b[:, tile_chunk] * ksc.reshape(b, 1)
        sc = torch.repeat_interleave(sc, hkv, dim=0)         # (b*hkv, nq)
        vs = torch.repeat_interleave(vsc.reshape(b), hkv)    # (b*hkv,)
    kf = kf.reshape(b * hkv, sk, d)
    vf = vf.reshape(b * hkv, sk, d)
    out = int_attention_fused(qf.contiguous(), kf.contiguous(),
                              vf.contiguous(), sc, vs,
                              attn_bits=cfg.attn_bits, causal=spec.causal,
                              window=spec.window, bq=bq, bk=bk, sq_mod=sq)
    return out.reshape(b, hq, sq, d).to(out_dtype)


def _as_q(x, bits, split_heads=True):
    """Per-tensor codes of ``x`` (QTensors pass through on their grid):
    the grid over every rank's rows and, where the ranks hold some heads
    each, their heads."""
    return x if isinstance(x, quant.QTensor) \
        else quant.quantize_tensor(x, bits, group=tensor_max if split_heads
                                   else rows_max)


def _decode_operands(q, k, v, spec, cfg):
    """The ring kernel's operands: the query on the plain path's
    PER-TENSOR grid (the whole batch shares one ring and one scale; over
    every rank's rows, and heads where the ranks split them, when
    partitioned), folded to (B*Hkv, G, D), the cache's codes as stored
    (int8, or int4 nibbles read in place) folded to (B*Hkv, span, dk), and
    the plain path's association ``scale*LOG2E*dq*dk``: (qf, kq, vq, kf,
    vf, sc)."""
    b, hq, _, d = q.shape
    hkv, span = k.shape[1], k.shape[2]
    qq, kq, vq = (_as_q(x, cfg.a_bits, spec.split_heads) for x in (q, k, v))
    scale = spec.softmax_scale or (1.0 / d ** 0.5)
    sc = scale * LOG2E * qq.scale * kq.scale
    qf = qq.q.reshape(b * hkv, hq // hkv, d).contiguous()
    return (qf, kq, vq, kq.q.reshape(b * hkv, span, -1),
            vq.q.reshape(b * hkv, span, -1), sc)


def _decode_call(q, k, v, spec, cfg, q_offset, k_positions):
    """One decode step on the ring kernel (:func:`_decode_operands`).
    ``q_offset`` is the query position as a device tensor."""
    b, hq, _, d = q.shape
    out_dtype = q.dtype if not isinstance(q, quant.QTensor) \
        else torch.float32
    qf, kq, vq, kf, vf, sc = _decode_operands(q, k, v, spec, cfg)
    out = int_decode_attention(
        qf, kf, vf, sc, vq.scale,
        torch.as_tensor(k_positions, dtype=torch.int32, device=q.device),
        q_offset, attn_bits=cfg.attn_bits, causal=spec.causal,
        window=spec.window, bk=decode_blocks(k.shape[2], d),
        packed=_is_packed(kq))
    return out.reshape(b, hq, 1, d).to(out_dtype)


def maybe_staged_decode(q, k, v, spec, cfg, q_offset, k_positions, *,
                        parts, index, gather, reduce):
    """A decode step over a ring split by slot range over ``parts`` ranks,
    run by stages; ``None`` -> the caller gathers the ring.  This rank
    holds slots ``[index * n, (index + 1) * n)`` of ``k``, ``v`` (QTensors
    on the ring's per-tensor grids), ``k_positions`` their positions; ``q``
    holds every head.  ``gather(t)`` all-gathers ``t`` along dim 1 in rank
    order and ``reduce(t)`` sums int32 over the ranks: the chunk maxima and
    Sigma partials gathered, the per-block PV summed.

    Runs where each rank's range is whole chunks of the ring kernel's
    (``int_attention.staged_ring_plan``): on the ``cuda`` backend the
    kernel's stages (``int_decode_attention_staged``), bit for bit the
    one-launch kernel; on meta tensors the ``torch`` backend's plain stages
    (``ref.int_decode_attention_staged_ref``), so a dry run counts the
    card's exchanges.  On real tensors the ``torch`` backend returns
    ``None``: its one-rank path sums Sigma over whole rows where the stages
    sum it by chunks, so only the gathered ring is bitwise that path."""
    if cfg is None or cfg.mode != "int" or \
            not decode_supported(q, k, spec, cfg, k_positions):
        return None
    b, hq, _, d = q.shape
    span = k.shape[2] * parts
    bk = decode_blocks(span, d)
    plan = staged_ring_plan(hq // k.shape[1], d, bk, span, parts)
    backend = resolve_backend(cfg)
    if plan is None or (backend == "torch" and not q.is_meta):
        return None
    STATS[f"attention_decode_{backend}"] += 1
    qf, kq, vq, kf, vf, sc = _decode_operands(q, k, v, spec, cfg)
    fn = int_decode_attention_staged if backend == "cuda" else \
        functools.partial(ref.int_decode_attention_staged_ref, chunk=plan[0])
    out = fn(qf, kf, vf, sc, vq.scale,
             torch.as_tensor(k_positions, dtype=torch.int32,
                             device=q.device), q_offset,
             parts=parts, index=index, gather=gather, reduce=reduce,
             attn_bits=cfg.attn_bits, causal=spec.causal,
             window=spec.window, bk=bk, packed=_is_packed(kq))
    out_dtype = q.dtype if not isinstance(q, quant.QTensor) \
        else torch.float32
    return out.reshape(b, hq, 1, d).to(out_dtype)


# ---------------------------------------------------------------------------
# Paged attention: shared page pools + per-sequence page tables
# ---------------------------------------------------------------------------

def quantize_rows(x, bits):
    """Per-sequence (leading-axis) activation quantization -> (codes int8,
    scale (B,))."""
    scale = quant.absmax_scale(x, bits, axis=tuple(range(1, x.ndim)))
    return quant.quantize(x, scale, bits), scale.reshape(x.shape[0])


def paged_query_grid(q, spec, cfg, k_scale=None):
    """Per-sequence query codes + folded per-row softmax scale: the ONE
    derivation both backends consume, so their codes agree by
    construction.  ``k_scale=None`` leaves the key step out of the fold
    (per-physical-page scale pools)."""
    qq, qscale = quantize_rows(q, cfg.a_bits)
    scale = spec.softmax_scale or (1.0 / q.shape[-1] ** 0.5)
    sc = scale * LOG2E * qscale.to(torch.float32)
    if k_scale is not None:
        sc = sc * torch.as_tensor(k_scale, dtype=torch.float32,
                                  device=q.device).reshape(-1)
    return qq, sc


def paged_read_grid(q, spec, cfg, k_scale, v_scale, page_scaled: bool):
    """(query codes, per-row logit scale, per-row v scale) for a paged
    read, for both scale layouts."""
    if page_scaled:
        qq, sc = paged_query_grid(q, spec, cfg)
        return qq, sc, torch.ones((q.shape[0],), dtype=torch.float32,
                                  device=q.device)
    qq, sc = paged_query_grid(q, spec, cfg, k_scale)
    return qq, sc, v_scale


def paged_decode_supported(q, k_pages, spec, cfg, page_table, pos) -> bool:
    """Shape policy for the paged decode kernel, the reference's: one page
    per block within the reference's tile budget."""
    if cfg.attn_bits > MAX_PROB_BITS:
        return False
    if getattr(cfg, "softmax", "base2") != "base2":
        return False
    if k_pages.ndim != 4 or page_table.ndim != 2:
        return False
    b, hq, sq, d = q.shape
    num_phys, hkv, page_size, dk = k_pages.shape
    if sq != 1 or d == 0 or hq % hkv:
        return False
    if k_pages.dtype == torch.uint8 and (dk * 2 != d or d % 2):
        return False
    if k_pages.dtype != torch.uint8 and dk != d:
        return False
    return paged_decode_blocks(page_size, d) > 0


def maybe_paged_attention(q, k_pages, v_pages, k_scale, v_scale, spec, cfg,
                          *, page_table, pos, k_page_scale=None,
                          v_page_scale=None):
    """Kernel-backed paged decode; ``None`` -> caller's plain gather path."""
    if resolve_backend(cfg) == "cuda" and \
            paged_decode_supported(q, k_pages, spec, cfg, page_table, pos):
        STATS["attention_paged_cuda"] += 1
        return _paged_call(q, k_pages, v_pages, k_scale, v_scale, spec, cfg,
                           page_table, pos, k_page_scale, v_page_scale)
    STATS["attention_paged_torch"] += 1
    return None


def _paged_call(q, k_pages, v_pages, k_scale, v_scale, spec, cfg,
                page_table, pos, k_page_scale=None, v_page_scale=None):
    """One continuous-batching decode step on the paged kernel: pools as
    stored (int8 codes or int4 nibbles), every sequence on its own grid;
    with per-physical-page scale pools each page dequantizes on the grid
    it was prefilled with."""
    b, hq, _, d = q.shape
    hkv = k_pages.shape[1]
    g = hq // hkv
    qq, sc, vs = paged_read_grid(q, spec, cfg, k_scale, v_scale,
                                 k_page_scale is not None)
    out = int_paged_decode_attention(
        qq.reshape(b, hkv, g, d), k_pages, v_pages, sc, vs,
        page_table, pos, k_page_scale=k_page_scale,
        v_page_scale=v_page_scale, attn_bits=cfg.attn_bits,
        window=spec.window, packed=k_pages.dtype == torch.uint8)
    return out.reshape(b, hq, 1, d).to(q.dtype)
