"""Plain PyTorch oracles for the kernels: exact intended semantics, no tiling.

Counterpart of ``repro/kernels/ref.py``.  Probability codes live on the
power-of-two Sigma-scaled grid::

    e    = (1+r) * 2^(x - m),  m = floor(row max)  =>  e in [0, 2)
    p_q  = clip(round(e * qmax / 2), 0, qmax)
    out  = (sum_j p_q[j] v[j]) * dattn * dv,   dattn = (2/qmax) / Sigma

- :func:`int_attention_ref` — full-row semantics (``m`` is the final row
  max): what the plain ``torch`` backend serves for prefill.
- :func:`int_attention_ref_streamed` — keys consumed in ``bk`` blocks,
  each block's codes on the running ``m``: the fused kernel's semantics.
- :func:`int_decode_attention_ref` — one query position against a KV ring
  with a slot -> position map; ``bk=None`` is the full-row grid, integer
  ``bk`` the ring decode kernel's streamed grid.
- :func:`int_paged_decode_attention_ref` — one query position against a
  paged KV cache; ``bk=None`` is the full-row grid, ``bk = page_size`` the
  paged kernel's streamed grid.  Both decode oracles share one streamed
  core (:func:`_decode_stream`).
- :func:`pq_layernorm_ref` — LayerNorm (or RMS) -> affine -> quantizer,
  every step correctly rounded and the row sums in the pq_layernorm
  kernel's order.

Integer contractions run through ``quant.int_matmul_exact`` (float64,
exact), so these run unchanged on CPU and CUDA tensors.  ``return_codes``
additionally returns the prob codes (uint8, one per (row, key)), which is
how the kernels' codes are held against these oracles exactly.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quant import int_matmul_exact, unpack_int4
from repro_torch.core.softmax2 import exp2_shift, exp2i

NEG = -1e30


def qmatmul_acc_ref(x_q, w_q):
    """int8 (M,K) @ int8 (N,K)^T -> exact int32 (M, N); ``w_q`` may be
    (N, K/2) uint8 nibbles (low nibble = even k), unpacked as
    ``core/api.py::as_qlinear`` unpacks them."""
    if w_q.dtype == torch.uint8:
        w_q = unpack_int4(w_q)
    return int_matmul_exact(x_q, w_q.T)


def qmatmul_epilogue(acc, scale, bias=None, row_scale=None):
    """``f32(acc) * (scale[n] * row_scale[m]) + bias[n]``, each product and
    sum rounded on its own, in the kernel's order."""
    s = scale.to(torch.float32)[None, :]
    if row_scale is not None:
        s = s * row_scale.to(torch.float32)[:, None]
    out = acc.to(torch.float32) * s
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out


def qmatmul_ref(x_q, w_q, scale, bias=None, row_scale=None):
    """int8 (M,K) @ int8 (N,K)^T * (scale[n] * row_scale[m]) + bias[n].

    ``w_q`` may be (N, K/2) uint8 nibbles (low nibble = even k).  Returns
    f32 (M, N), with the epilogue's products in the kernel's order.
    """
    return qmatmul_epilogue(qmatmul_acc_ref(x_q, w_q), scale, bias,
                            row_scale)


def _row_sc(sc, h, sq):
    """Broadcast a logit scale (scalar, (sq,) or (h, sq)) to (h, sq, 1)."""
    sc = torch.as_tensor(sc, dtype=torch.float32)
    if sc.ndim == 0:
        return sc
    if sc.ndim == 1:
        return sc[None, :, None].expand(h, sq, 1)
    return sc[:, :, None].expand(h, sq, 1)


def _head_sc(s, h, device=None):
    """Broadcast a per-head-fold scale (scalar or (h,)) to (h, 1, 1)."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.ndim == 0:
        return s
    return s.reshape(h, 1, 1)


def _attn_mask(sq, sk, sq_mod, causal, window, device):
    q_pos = (torch.arange(sq, device=device) % sq_mod)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _codes(e, qmax):
    return torch.clamp(torch.round(e * (qmax / 2.0)), 0, qmax)


def int_attention_ref(q_q, k_q, v_q, sc, v_scale, *, attn_bits=7,
                      causal=True, window=None, sq_mod=None):
    """Full-row integer attention with base-2 softmax (paper semantics).

    q_q (H, Sq, D) int8 (GQA groups stacked along Sq: row r has position
    ``r % sq_mod``), k_q, v_q (H, Sk, D) int8; ``sc`` scalar, (sq,) or
    (h, sq); ``v_scale`` scalar or (h,).  Returns (H, Sq, D) f32.
    """
    h, sq, d = q_q.shape
    sk = k_q.shape[1]
    dev = q_q.device
    qmax = (1 << attn_bits) - 1
    acc = int_matmul_exact(q_q, k_q.transpose(1, 2))
    x = acc.to(torch.float32) * _row_sc(sc, h, sq).to(dev)
    mask = _attn_mask(sq, sk, sq_mod or sq, causal, window, dev)
    x = torch.clamp(torch.where(mask, x, NEG), min=-120.0)
    m = torch.floor(x.amax(dim=-1, keepdim=True))
    e = torch.where(x <= -120.0, 0.0, exp2_shift(x - m))
    s = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    dattn = (2.0 / qmax) / s
    pv = int_matmul_exact(_codes(e, qmax), v_q)
    return pv.to(torch.float32) * (dattn * _head_sc(v_scale, h, dev))


def int_attention_ref_streamed(q_q, k_q, v_q, sc, v_scale, *, bk,
                               attn_bits=7, causal=True, window=None,
                               sq_mod=None, return_codes=False):
    """Block-streamed oracle: each ``bk`` key block quantized on the
    running grid, the PV carry rescaled by the exact ``2^(m_old - m_new)``.
    Same contract as :func:`int_attention_ref`; with ``return_codes`` also
    returns the (H, Sq, Sk) uint8 prob codes."""
    h, sq, d = q_q.shape
    sk = k_q.shape[1]
    dev = q_q.device
    qmax = (1 << attn_bits) - 1
    mask = _attn_mask(sq, sk, sq_mod or sq, causal, window, dev)
    acc_all = int_matmul_exact(q_q, k_q.transpose(1, 2))
    x_all = acc_all.to(torch.float32) * _row_sc(sc, h, sq).to(dev)
    x_all = torch.clamp(torch.where(mask[None], x_all, NEG), min=-120.0)
    m = torch.full((h, sq, 1), NEG, device=dev)
    s = torch.zeros((h, sq, 1), device=dev)
    pv = torch.zeros((h, sq, d), device=dev)
    codes = []
    for t in range(0, sk, bk):
        x = x_all[:, :, t:t + bk]
        m_new = torch.maximum(m, torch.floor(x.amax(dim=-1, keepdim=True)))
        e = torch.where(x <= -120.0, 0.0, exp2_shift(x - m_new))
        p = _codes(e, qmax)
        r = torch.where(m <= NEG, 0.0, exp2i(m - m_new))
        blk = int_matmul_exact(p, v_q[:, t:t + bk]).to(torch.float32)
        s = s * r + e.sum(dim=-1, keepdim=True)
        pv = pv * r + blk
        m = m_new
        codes.append(p)
    dattn = (2.0 / qmax) / torch.clamp(s, min=1e-30)
    out = pv * (dattn * _head_sc(v_scale, h, dev))
    if return_codes:
        return out, torch.cat(codes, dim=-1).to(torch.uint8)
    return out


def gather_pages(pages, page_table):
    """(num_pages, H, ps, d) pool + (B, max_pages) table -> (B, H,
    max_pages * ps, d) rows in position order (negative ids clamp; callers
    mask them through positions)."""
    num_phys = pages.shape[0]
    g = pages[page_table.long().clamp(0, num_phys - 1)]   # (B, P, H, ps, d)
    b, p, h, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, p * ps, d)


def _decode_stream(x, v, qmax, bk, vf_blk=None, v_scale=None,
                   return_codes=False):
    """Shared streamed core of the decode oracles, batched over leading
    dims: x (..., G, T) masked+clamped logits, v (..., T, D) int codes.
    With ``vf_blk`` (..., nblk) per-block v factors (page scales), each
    block's integer PV is scaled by ``v_scale * vf`` before accumulation."""
    *lead, g, span = x.shape
    d = v.shape[-1]
    dev = x.device
    m = torch.full((*lead, g, 1), NEG, device=dev)
    s = torch.zeros((*lead, g, 1), device=dev)
    pv = torch.zeros((*lead, g, d), device=dev)
    codes = []
    for i, t in enumerate(range(0, span, bk)):
        xb = x[..., t:t + bk]
        m_new = torch.maximum(m, torch.floor(xb.amax(dim=-1, keepdim=True)))
        e = torch.where(xb <= -120.0, 0.0, exp2_shift(xb - m_new))
        p = _codes(e, qmax)
        r = torch.where(m <= NEG, 0.0, exp2i(m - m_new))
        blk = int_matmul_exact(p, v[..., t:t + bk, :]).to(torch.float32)
        if vf_blk is not None:
            blk = blk * (v_scale * vf_blk[..., i])[..., None, None]
        s = s * r + e.sum(dim=-1, keepdim=True)
        pv = pv * r + blk
        m = m_new
        codes.append(p)
    s = torch.clamp(s, min=1e-30)
    return pv, s, (torch.cat(codes, dim=-1) if return_codes else None)


def int_decode_attention_ref(q_q, k_q, v_q, sc, v_scale, k_positions, pos,
                             *, attn_bits=7, causal=True, window=None,
                             bk=None, return_codes=False):
    """Ring decode oracle: (H, G, D) query rows vs an (H, span, D) ring.

    ``k_positions`` (span,) maps ring slot -> absolute position (negative =
    unwritten, masked); all G rows share query position ``pos`` (a 0-d or
    (1,) tensor, never read on the host).  ``bk=None``: full-row grid (the
    plain ``torch`` backend's).  Integer ``bk``: ring blocks stream in slot
    order on the running grid — the ring decode kernel's semantics (a
    block with no live key is bit-neutral, so the kernel may skip it).
    ``sc``/``v_scale`` scalars or (H,).  Returns (H, G, D) f32 (and the
    (H, G, span) uint8 codes with ``return_codes``).
    """
    h, g, d = q_q.shape
    dev = q_q.device
    qmax = (1 << attn_bits) - 1
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(())
    kp = k_positions.to(torch.int32)
    mask = kp >= 0
    if causal:
        mask &= kp <= pos
    if window is not None:
        mask &= kp > pos - window
    acc = int_matmul_exact(q_q, k_q.transpose(1, 2))          # (H, G, span)
    x = acc.to(torch.float32) * _head_sc(sc, h, dev)
    x = torch.clamp(torch.where(mask[None, None, :], x, NEG), min=-120.0)
    vs = _head_sc(v_scale, h, dev)
    if bk is None:
        m = torch.floor(x.amax(dim=-1, keepdim=True))
        e = torch.where(x <= -120.0, 0.0, exp2_shift(x - m))
        s = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
        p = _codes(e, qmax)
        pv = int_matmul_exact(p, v_q).to(torch.float32)
        out = pv * ((2.0 / qmax) / s * vs)
    else:
        pv, s, p = _decode_stream(x, v_q, qmax, bk, return_codes=True)
        out = pv * ((2.0 / qmax) / s * vs)
    if return_codes:
        return out, p.to(torch.uint8)
    return out


def ring_positions(pos, span: int, start: int = 0, count=None):
    """The slot -> position map of a ring of ``span`` slots after position
    ``pos`` (a 0-d device tensor) was written: ``pos - ((pos % span - j)
    mod span)`` for slots j in ``[start, start + count)`` (negative:
    unwritten)."""
    n = span - start if count is None else count
    j = start + torch.arange(n, dtype=torch.int32, device=pos.device)
    return pos - torch.remainder(torch.remainder(pos, span) - j, span)


# The ring decode kernel's three passes in plain PyTorch, each on a slot
# range of whole chunks of the ring (all of it on one rank), in the
# association of ``csrc/int_attention.cu``'s ring kernels, unsplit or
# staged over the model ranks of a partitioned program.  Every value a
# pass returns is the same, bit for bit, whether it ran on the whole ring
# or on a rank's slots, so a staged run equals the unsplit one.

def ring_logits_ref(q_q, k_q, k_positions, pos, sc, *, chunk, causal=True,
                    window=None):
    """Pass 1 on slots ``k_q`` (H, span, D) int8 (span need not be whole
    chunks: the last is padded): the masked, clamped logits (H, G,
    nloc * chunk) f32 (dead slots and pads at -120) and each chunk's
    per-row maxima (H, nloc, G) (``NEG`` for a chunk with no live key)."""
    h, g, d = q_q.shape
    span = k_q.shape[1]
    dev = q_q.device
    nloc = -(-span // chunk)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(())
    kp = k_positions.to(torch.int32)
    live = kp >= 0
    if causal:
        live &= kp <= pos
    if window is not None:
        live &= kp > pos - window
    acc = int_matmul_exact(q_q, k_q.transpose(1, 2))          # (H, G, span)
    x = acc.to(torch.float32) * _head_sc(sc, h, dev)
    x = torch.clamp(torch.where(live[None, None, :], x, NEG), min=-120.0)
    x = F.pad(x, (0, nloc * chunk - span), value=-120.0)
    live = F.pad(live, (0, nloc * chunk - span))
    cm = x.view(h, g, nloc, chunk).amax(-1).transpose(1, 2)   # (H, nloc, G)
    cm = torch.where(live.view(nloc, chunk).any(-1)[None, :, None], cm, NEG)
    return x, cm.contiguous()


def ring_pv_ref(v_q, x, cm, *, c0: int = 0, bk, chunk, attn_bits=7):
    """Pass 2 on the same slots: ``v_q`` (H, span, D) int8, ``x`` and the
    ring's chunk maxima ``cm`` (H, nch, G), of which the slots are chunks
    ``c0 ..``.  Each chunk's codes against its ``bk`` block's running m
    (the floor of the maxima of every chunk up to the block's end),
    Sigma partials (H, nloc, G) f32 (a sum over the chunk), and the int32
    PV of each block over these chunks (H, nblk, G, D) (0 where they hold
    none of it); dead chunks give 0.  Returns (sp, pvb, codes (H, G,
    span) uint8)."""
    h, g, nslots = x.shape
    span, d = v_q.shape[1], v_q.shape[2]
    nloc, nch = nslots // chunk, cm.shape[1]
    cpb = bk // chunk
    nblk = -(-nch // cpb)
    qmax = (1 << attn_bits) - 1
    # the running maximum at each block's end
    run, mx = [], torch.full((h, g), NEG, device=x.device)
    for b in range(nblk):
        mx = torch.maximum(mx, cm[:, b * cpb:(b + 1) * cpb].amax(1))
        run.append(mx)
    blk = (c0 + torch.arange(nloc, device=x.device)) // cpb
    # a dead chunk's m is never used (its e are 0): held above -120
    m = torch.floor(torch.stack(run, 1)[:, blk].clamp(min=-120.0))
    xc = x.view(h, g, nloc, chunk)
    e = torch.where(xc <= -120.0, 0.0,
                    exp2_shift(xc - m.transpose(1, 2)[..., None]))
    p = _codes(e, qmax)
    live = (cm[:, c0:c0 + nloc] > NEG).transpose(1, 2)        # (H, G, nloc)
    sp = torch.where(live, e.sum(-1), 0.0).transpose(1, 2)
    v = F.pad(v_q, (0, 0, 0, nslots - span)).view(h, nloc, chunk, d)
    pv = int_matmul_exact(p.transpose(1, 2), v)                # (H,nloc,G,D)
    pv = torch.where(live.transpose(1, 2)[..., None], pv, 0)
    pvb = torch.zeros((h, nblk, g, d), dtype=pv.dtype, device=x.device)
    pvb.index_add_(1, blk, pv)
    codes = p.reshape(h, g, nslots)[..., :span].to(torch.uint8)
    return sp.contiguous(), pvb, codes


def ring_merge_ref(cm, sp, pvb, v_scale, *, bk, chunk, attn_bits=7):
    """Pass 3 over the whole ring: the chunks block by block in slot
    order, each block's Sigma the sum of its live chunks' partials in
    chunk order, the f32 carries rescaled by the exact power of two.
    ``cm``, ``sp`` (H, nch, G), ``pvb`` (H, nblk, G, D) int32.  Returns
    (H, G, D) f32."""
    h, nch, g = cm.shape
    d = pvb.shape[-1]
    cpb = bk // chunk
    qmax = (1 << attn_bits) - 1
    dev = cm.device
    m = torch.full((h, g), NEG, device=dev)
    s = torch.zeros((h, g), device=dev)
    pv = torch.zeros((h, g, d), device=dev)
    for b in range(pvb.shape[1]):
        cs = cm[:, b * cpb:(b + 1) * cpb]
        bm = cs.amax(1)
        on = bm > NEG                                # a live key in the block
        mn = torch.maximum(m, torch.floor(bm))
        r = torch.where(m <= NEG, 0.0, exp2i((m - mn).clamp(min=-300.0)))
        st = torch.zeros((h, g), device=dev)
        for c in range(cs.shape[1]):
            st = st + sp[:, b * cpb + c]
        s = torch.where(on, s * r + st, s)
        pv = torch.where(on[..., None],
                         pv * r[..., None] + pvb[:, b].to(torch.float32), pv)
        m = torch.where(on, mn, m)
    out = pv * ((2.0 / qmax) / torch.clamp(s, min=1e-30)
                * _head_sc(v_scale, h, dev).reshape(-1, 1))[..., None]
    return out


def int_decode_attention_staged_ref(q_q, k_q, v_q, sc, v_scale, k_positions,
                                    pos, *, parts, index, gather, reduce,
                                    chunk, attn_bits=7, causal=True,
                                    window=None, bk, packed=False,
                                    return_codes=False):
    """The staged ring decode kernel (``int_attention.
    int_decode_attention_staged``: the same contract, ``chunk`` its
    ``staged_ring_plan``) in plain PyTorch on any device, the three passes
    above on the rank's chunks with the kernel's exchanges between them:
    what the ``torch`` backend serves over a ring split by slot range.  It
    equals :func:`int_decode_attention_chunked_ref` on the whole ring bit
    for bit."""
    n = k_q.shape[1]
    if packed:
        k_q, v_q = unpack_int4(k_q), unpack_int4(v_q)
    x, cm = ring_logits_ref(q_q, k_q, k_positions, pos, sc, chunk=chunk,
                            causal=causal, window=window)
    cm = gather(cm)
    sp, pvb, codes = ring_pv_ref(v_q, x, cm, c0=index * (n // chunk), bk=bk,
                                 chunk=chunk, attn_bits=attn_bits)
    out = ring_merge_ref(cm, gather(sp), reduce(pvb), v_scale, bk=bk,
                         chunk=chunk, attn_bits=attn_bits)
    return (out, codes) if return_codes else out


def int_decode_attention_chunked_ref(q_q, k_q, v_q, sc, v_scale, k_positions,
                                     pos, *, attn_bits=7, causal=True,
                                     window=None, bk, chunk,
                                     return_codes=False):
    """The ring decode kernel's three passes in plain PyTorch over the
    whole ring (int8 codes), ``chunk`` from ``int_attention.ring_plan``:
    the kernel's association.  Codes and the int32 sums equal
    :func:`int_decode_attention_ref` at the same ``bk``; Sigma sums by
    chunks, then the chunks in order.  Returns (H, G, D) f32 (and the
    (H, G, span) uint8 codes)."""
    x, cm = ring_logits_ref(q_q, k_q, k_positions, pos, sc, chunk=chunk,
                            causal=causal, window=window)
    sp, pvb, codes = ring_pv_ref(v_q, x, cm, bk=bk, chunk=chunk,
                                 attn_bits=attn_bits)
    out = ring_merge_ref(cm, sp, pvb, v_scale, bk=bk, chunk=chunk,
                         attn_bits=attn_bits)
    return (out, codes) if return_codes else out


def int_paged_decode_attention_ref(q_q, k_pages, v_pages, sc, v_scale,
                                   page_table, pos, *, attn_bits=7,
                                   window=None, bk=None, k_page_scale=None,
                                   v_page_scale=None, return_codes=False):
    """Paged decode oracle: (B, Hkv, G, D) queries vs shared page pools.

    uint8 pools are nibble-packed and unpack to int8 codes (never float).
    Each row gathers its pages into a position-contiguous key row
    (unallocated pages masked) and attends at its own ``pos``/``sc``/
    ``v_scale``.  ``bk=None``: full-row grid.  ``bk = page_size``: pages
    stream in logical order on the running grid — the paged kernel's
    semantics.  ``k_page_scale``/``v_page_scale`` (num_pages,) resolve
    scales per PHYSICAL page: logit scale ``sc[b] * kps[phys]``, and each
    page's integer PV scaled by ``v_scale[b] * vps[phys]``.  Returns
    (B, Hkv, G, D) f32 (and the (B, Hkv, G, max_pages * ps) uint8 codes
    with ``return_codes``; streamed grid only).
    """
    b, hkv, g, d = q_q.shape
    dev = q_q.device
    num_phys = k_pages.shape[0]
    ps = k_pages.shape[2]
    qmax = (1 << attn_bits) - 1
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    if k.dtype == torch.uint8:
        k, v = unpack_int4(k), unpack_int4(v)
    total = page_table.shape[1] * ps
    alloc = torch.repeat_interleave(page_table >= 0, ps, dim=1)
    kpos = torch.where(alloc, torch.arange(total, device=dev)[None, :], -1)
    sc = torch.as_tensor(sc, dtype=torch.float32, device=dev).reshape(-1)
    sc = sc.expand(b) if sc.numel() == 1 else sc
    vs = torch.as_tensor(v_scale, dtype=torch.float32,
                         device=dev).reshape(-1)
    vs = vs.expand(b) if vs.numel() == 1 else vs
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(b)
    mask = (kpos >= 0) & (kpos <= pos[:, None])
    if window is not None:
        mask &= kpos > pos[:, None] - window
    acc = int_matmul_exact(q_q, k.transpose(-1, -2))        # (B,H,G,T)
    page_scaled = k_page_scale is not None
    if page_scaled:
        phys = page_table.long().clamp(0, num_phys - 1)
        kfac = torch.repeat_interleave(
            k_page_scale.to(torch.float32)[phys], ps, dim=1)   # (B, T)
        vf_blk = v_page_scale.to(torch.float32)[phys]          # (B, P)
        x = acc.to(torch.float32) * (sc[:, None] * kfac)[:, None, None, :]
    else:
        x = acc.to(torch.float32) * sc[:, None, None, None]
    x = torch.clamp(torch.where(mask[:, None, None, :], x, NEG), min=-120.0)
    if bk is None:
        m = torch.floor(x.amax(dim=-1, keepdim=True))
        e = torch.where(x <= -120.0, 0.0, exp2_shift(x - m))
        s = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
        p = _codes(e, qmax)
        if page_scaled:
            vfac = torch.repeat_interleave(vf_blk, ps, dim=1)
            pv = torch.matmul(p * vfac[:, None, None, :], v.to(torch.float32))
            return pv * ((2.0 / qmax) / s * vs[:, None, None, None])
        pv = int_matmul_exact(p, v).to(torch.float32)
        return pv * ((2.0 / qmax) / s * vs[:, None, None, None])
    if page_scaled:
        pv, s, codes = _decode_stream(x, v, qmax, bk, vf_blk[:, None, :],
                                      vs[:, None], return_codes)
        out = pv * ((2.0 / qmax) / s)
    else:
        pv, s, codes = _decode_stream(x, v, qmax, bk,
                                      return_codes=return_codes)
        out = pv * ((2.0 / qmax) / s * vs[:, None, None, None])
    if return_codes:
        return out, codes.to(torch.uint8)
    return out


def ragged_write_ref(pages, codes, lengths, page_table):
    """Loop oracle for the ragged paged-prefill scatter (models.lm).

    pages (num_pages + 1, H, ps, d) as stored (last = TRASH); codes
    (B, H, S, d); lengths (B,); page_table (B, max_pages).  Row b's
    position p < lengths[b] lands at ``pages[page_table[b, p // ps], :,
    p % ps]``; pad / unallocated positions land in the trash page.
    """
    out = np.array(pages)
    b, _, s, _ = codes.shape
    ps = out.shape[2]
    trash = out.shape[0] - 1
    pt = np.asarray(page_table)
    codes_np = np.asarray(codes)
    lens = np.asarray(lengths)
    for i in range(b):
        for p in range(s):
            phys = pt[i, min(p // ps, pt.shape[1] - 1)]
            if p >= lens[i] or phys < 0:
                phys = trash
            out[phys, :, p % ps] = codes_np[i, :, p]
    return out


# pq_layernorm's plan (``csrc/pq_layernorm.cu::plan``, which refuses any
# other): a warp per row while a lane holds at most PQLN_WARP_VECS 16-byte
# vectors, else the fewest of 128 .. 1024 threads that leave a lane at most
# PQLN_ROW_VECS; the kernel re-reads rows past 1024 x PQLN_ROW_VECS vectors
# from global, in the same order.
PQLN_WARP_VECS = 8
PQLN_ROW_VECS = 4
PQLN_MAX_TPR = 1024


def pq_layernorm_plan(d: int, dtype) -> tuple[int, int, int]:
    """``(threads per row, vector width, elements per thread)`` of the
    pq_layernorm kernel for rows of ``d`` elements of ``dtype`` (f32:
    vectors of 4, bf16: 8): a function of ``(d, dtype)`` alone, so a row's
    codes are the same whatever the rows beside it.  Thread ``t`` of a row
    takes vectors ``j * tpr + t`` for ``j`` below ``ept / vec``."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    chunks = -(-d // vec)
    if chunks <= 32 * PQLN_WARP_VECS:
        tpr = 32
    else:
        tpr = 128
        while tpr < PQLN_MAX_TPR and -(-chunks // tpr) > PQLN_ROW_VECS:
            tpr *= 2
    return tpr, vec, -(-chunks // tpr) * vec


def _plan_sums(v, tpr, vec):
    """Row sums of ``v`` (rows, d) f32 in the pq_layernorm kernel's order
    under the plan ``(tpr, vec, ...)``: thread t of a row adds the elements
    of its vectors t, t + tpr, ... in element order (a zero-padded (rows,
    nv, tpr, vec) view; +0 adds nothing to a sum that starts at +0), each
    warp adds its 32 lanes in five halving steps (the kernel's xor tree),
    then the row's warps add in warp order.  Returns (rows, 1)."""
    rows, d = v.shape
    chunks = -(-d // vec)
    nv = -(-chunks // tpr)
    vp = F.pad(v, (0, nv * tpr * vec - d)).reshape(rows, nv, tpr, vec)
    s = torch.zeros((rows, tpr), dtype=torch.float32, device=v.device)
    for j in range(nv):
        for i in range(vec):
            s = s + vp[:, j, :, i]
    s = s.reshape(rows, tpr // 32, 32)
    w = 16
    while w:
        s = s[..., :w] + s[..., w:2 * w]
        w //= 2
    s = s[..., 0]                                # (rows, warps)
    total = s[:, 0]
    for k in range(1, tpr // 32):
        total = total + s[:, k]
    return total[:, None]


def pq_layernorm_ref(x, gamma, beta, delta, *, bits=8, eps=1e-6,
                     rms_only=False):
    """Plain version of the pq_layernorm kernel: (rows, d) f32/bf16 ->
    (rows, d) int8 codes on the signed ``bits`` grid.

    The reference's ``ref.pq_layernorm_ref`` with every step correctly
    rounded in f32 and the row sums in the kernel's order under
    :func:`pq_layernorm_plan` (:func:`_plan_sums`), so the kernel's codes
    equal these exactly:
    ``inv = 1 / sqrt(var + eps)`` (not rsqrt), ``y = (x - mean) * inv *
    gamma + beta`` rounded step by step, ``clip(round(y / delta))``.
    ``delta`` is a number (or a 0-d tensor).  Every division is by a
    tensor on ``x``'s device: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal instead."""
    xf = x.to(torch.float32)

    def dev(v):
        return torch.tensor(f32(v), dtype=torch.float32, device=xf.device)

    tpr, vec, _ = pq_layernorm_plan(xf.shape[-1], x.dtype)
    d = dev(xf.shape[-1])
    t = xf if rms_only else xf - _plan_sums(xf, tpr, vec) / d
    var = _plan_sums(t * t, tpr, vec) / d
    inv = dev(1.0) / torch.sqrt(var + f32(eps))
    y = t * inv * gamma.to(torch.float32)
    if beta is not None:
        y = y + beta.to(torch.float32)
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return torch.clamp(torch.round(y / dev(delta)), qmin,
                       qmax).to(torch.int8)


def f32(v) -> float:
    """A number (or 0-d tensor) as the f32 value a kernel receives (and the
    reference's weak-typed constants round to)."""
    return float(np.float32(float(v)))
