"""Attention core: GQA, causal / local window, paged decode — in PyTorch.

Counterpart of ``repro/layers/attention.py``, in three modes: ``float``
(exact softmax), ``fake`` (QAT: fake-quantized q, k, v and probabilities on
the serving grid, float matmuls; the training graph) and ``int``.  The
integer path per query row:

    int QK^T -> x = s*dq*dk*log2(e)*acc -> e = (1+r)*2^floor(x - m)
    Sigma = sum_j e -> p_q on the power-of-two Sigma grid -> int PV -> dequant

Activation grids are per sequence on both backends — k/v per batch row, q
per (batch row, query chunk) — so a batched ragged prefill is
bit-identical per row to running each prompt alone.  With the ``cuda``
backend, :func:`attention` runs prompt prefill on the fused kernel and
:func:`paged_attention` every decode step on the paged kernel (see
:mod:`repro_torch.kernels.dispatch`); the ``torch`` backend runs the
plain paths below.  :func:`prefix_prefill_attention` (a tail chunk over a
cached prefix) has no kernel in the reference either and stays plain
PyTorch on both backends, so toggling the backend never changes it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.core.api import QuantConfig
from repro_torch.core.quant import int_matmul_exact
from repro_torch.core.softmax2 import LOG2E, exp2_shift
from repro_torch.distributed.partition import (heads_max, rows_max,
                                               tensor_max)

NEG_BIG = -1e9


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    causal: bool = True
    window: Optional[int] = None      # local attention: keys in (i-window, i]
    softmax_scale: Optional[float] = None
    q_chunk: int = 128
    split_heads: bool = False         # partitioned: the rank holds some heads


def _mask(q_pos, k_pos, spec: AttnSpec):
    """(bq, Sk) validity mask. Negative k_pos = unwritten slot."""
    m = (k_pos >= 0)[None, :]
    if spec.causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if spec.window is not None:
        m = m & (k_pos[None, :] > (q_pos[:, None] - spec.window))
    return m


def _as_q(x, bits, split_heads=True):
    """Per-tensor quantization (over every rank's rows, and heads where the
    ranks hold some each, when partitioned; QTensors pass through on their
    grid)."""
    if isinstance(x, quant.QTensor):
        return x
    return quant.quantize_tensor(x, bits, group=tensor_max if split_heads
                                 else rows_max)


def _as_q_rows(x, bits, split_heads=True):
    """Per-batch-row quantization (over every rank's heads where the ranks
    hold some each, when partitioned; QTensors pass through on their
    grid)."""
    if isinstance(x, quant.QTensor):
        return x
    scale = quant.absmax_scale(x, bits, axis=tuple(range(1, x.ndim)),
                               group=heads_max if split_heads else None)
    return quant.quantize_tensor(x, bits, scale=scale)


def _sc5(s):
    """Broadcast a per-row (or scalar) scale over (B, Hkv, G, q, k) axes."""
    s = torch.as_tensor(s)
    return s if s.ndim == 0 else s.reshape(s.shape[0], 1, 1, 1, 1)


def _as_f(x, dtype):
    return x.dequant().to(dtype) if isinstance(x, quant.QTensor) else x


def _row_attention(q, k, v, q_pos, k_pos, spec: AttnSpec,
                   cfg: Optional[QuantConfig]):
    """Full-key-row attention for one query chunk.

    q: (B, Hkv, G, bq, D); k, v: (B, Hkv, Sk, D).  Returns (B, Hkv, G, bq, D).
    """
    scale = spec.softmax_scale or (1.0 / q.shape[-1] ** 0.5)
    mode = cfg.mode if cfg is not None else "float"
    mask = _mask(q_pos, k_pos, spec)                       # (bq, Sk)

    if mode == "int":
        fresh = not isinstance(k, quant.QTensor)
        sh = spec.split_heads
        qq = _as_q_rows(q, cfg.a_bits, sh) if fresh else \
            _as_q(q, cfg.a_bits, sh)
        kq = _as_q_rows(k, cfg.a_bits, sh)
        vq = _as_q_rows(v, cfg.a_bits, sh)
        acc = int_matmul_exact(qq.q, kq.q[:, :, None].transpose(-1, -2))
        x = acc.to(torch.float32) * (scale * LOG2E * _sc5(qq.scale)
                                     * _sc5(kq.scale))
        x = torch.where(mask, x, NEG_BIG)
        x = torch.clamp(x, min=-120.0)
        m = torch.floor(x.amax(dim=-1, keepdim=True))
        e = exp2_shift(x - m) if cfg.softmax == "base2" \
            else torch.exp2(x - m)
        e = torch.where(mask & (x > -120.0), e, 0.0)
        sigma = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
        qmax = (1 << cfg.attn_bits) - 1
        dattn = (2.0 / qmax) / sigma
        p_q = torch.clamp(torch.round(e * (qmax / 2.0)), 0, qmax)
        pv = int_matmul_exact(p_q, vq.q[:, :, None])
        out = pv.to(torch.float32) * (dattn * _sc5(vq.scale))
        return out.to(q.dtype)

    k = _as_f(k, q.dtype)
    v = _as_f(v, q.dtype)
    if mode == "fake":
        # per tensor: over every rank's rows, and heads where they split
        grp = tensor_max if spec.split_heads else rows_max
        q = quant.fake_quant(q, quant.absmax_scale(q, cfg.a_bits, group=grp),
                             cfg.a_bits)
        k = quant.fake_quant(k, quant.absmax_scale(k, cfg.a_bits, group=grp),
                             cfg.a_bits)
        v = quant.fake_quant(v, quant.absmax_scale(v, cfg.a_bits, group=grp),
                             cfg.a_bits)
    elif mode != "float":
        raise ValueError(f"unknown attention mode {mode!r}")

    x = torch.einsum("bhgqd,bhkd->bhgqk", q, k).to(torch.float32) * scale
    x = torch.where(mask, x, NEG_BIG)
    if mode == "fake":
        # QAT trains through the pipeline the int path serves: the shift
        # exp (or exact 2^x for the ablation), the floor-max shift and the
        # power-of-two Sigma-scaled prob grid, so the fake-quantized probs
        # land on the codes mode="int" emits.  torch.maximum splits a tie's
        # gradient as jnp.maximum does.
        xl = torch.maximum(x * LOG2E, x.new_tensor(-120.0))
        m = torch.floor(xl.amax(dim=-1, keepdim=True))
        e = exp2_shift(xl - m) if cfg.softmax == "base2" \
            else torch.exp2(xl - m)
        e = torch.where(mask & (xl > -120.0), e, 0.0)
        sigma = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
        p = e / sigma
        qmaxp = (1 << cfg.attn_bits) - 1
        dp = (2.0 / qmaxp) / sigma                  # serving-grid step
        p = quant.fake_quant(p, dp, cfg.attn_bits, True)
    else:
        p = torch.softmax(x, dim=-1)
    p = p.to(q.dtype)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v)


def paged_attention(q, k_pages, v_pages, k_scale, v_scale, page_table, pos,
                    spec: AttnSpec, cfg: Optional[QuantConfig] = None, *,
                    k_page_scale=None, v_page_scale=None):
    """One decode step of multi-head attention over a PAGED KV cache.

    q (B, Hq, 1, D) float; pools as stored — (num_pages, Hkv, page_size,
    D) int8 codes / floats, or (..., D//2) uint8 nibbles; ``page_table``
    (B, max_pages) int32 (negative = unallocated); ``pos`` (B,) int32
    (negative = inactive row); ``k_scale``/``v_scale`` (B,) per sequence,
    or per physical page through ``k_page_scale``/``v_page_scale``.
    Returns (B, Hq, 1, D).

    int mode runs the paged kernel (``cuda`` backend) or gathers each
    sequence's pages as codes — never as floats — and evaluates the same
    page-streamed running grid (``bk = page_size``): both backends emit
    the same codes.
    """
    b, hq, _, d = q.shape
    hkv = k_pages.shape[1]
    g = hq // hkv
    mode = cfg.mode if cfg is not None else "float"
    if mode == "int":
        from repro_torch.kernels import ref as kref
        from repro_torch.kernels.dispatch import (maybe_paged_attention,
                                                  paged_read_grid)
        out = maybe_paged_attention(q, k_pages, v_pages, k_scale, v_scale,
                                    spec, cfg, page_table=page_table,
                                    pos=pos, k_page_scale=k_page_scale,
                                    v_page_scale=v_page_scale)
        if out is not None:                    # kernel path
            return out
        qq, sc, vs = paged_read_grid(q, spec, cfg, k_scale, v_scale,
                                     k_page_scale is not None)
        out = kref.int_paged_decode_attention_ref(
            qq.reshape(b, hkv, g, d), k_pages, v_pages, sc, vs,
            page_table, pos, attn_bits=cfg.attn_bits, window=spec.window,
            bk=k_pages.shape[2], k_page_scale=k_page_scale,
            v_page_scale=v_page_scale)
        return out.reshape(b, hq, 1, d).to(q.dtype)

    from repro_torch.kernels.ref import gather_pages
    k = gather_pages(k_pages, page_table)              # (B, Hkv, total, D)
    v = gather_pages(v_pages, page_table)
    ps = k_pages.shape[2]
    total = page_table.shape[1] * ps
    kpos = torch.where(torch.repeat_interleave(page_table >= 0, ps, dim=1),
                       torch.arange(total, device=q.device)[None, :], -1)
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if spec.window is not None:
        valid &= kpos > (pos[:, None] - spec.window)
    scale = spec.softmax_scale or (1.0 / d ** 0.5)
    x = torch.einsum("bhgd,bhkd->bhgk", q.reshape(b, hkv, g, d),
                     k.to(q.dtype)).to(torch.float32) * scale
    x = torch.where(valid[:, None, None, :], x, NEG_BIG)
    p = torch.softmax(x, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.to(q.dtype))
    return out.reshape(b, hq, 1, d)


def prefix_prefill_attention(q, k, v, k_pre, v_pre, pre_k_scale, pre_v_scale,
                             prefix_len: int, lengths, spec: AttnSpec,
                             cfg: Optional[QuantConfig] = None):
    """Tail-chunk prefill attention over a cached (possibly shared) prefix.

    q (B, Hq, St, D) fresh tail queries at positions ``prefix_len + i``;
    k, v (B, Hkv, St, D) fresh tail keys/values (right-padded, ``lengths``
    (B,) true tail lengths); k_pre, v_pre (B, Hkv, Kp, D) the prefix KV
    gathered from the pools — int8 codes in int mode (nibbles unpacked by
    the caller), stored floats otherwise; positions ``>= prefix_len`` are
    masked.  pre_k_scale / pre_v_scale (B, Kp // page_size): per-page
    dequant steps of the prefix owner.  Returns (B, Hq, St, D).
    """
    b, hq, st, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kp = k_pre.shape[2]
    dev = q.device
    mode = cfg.mode if cfg is not None else "float"
    scale = spec.softmax_scale or (1.0 / d ** 0.5)
    lens = torch.full((b,), st, dtype=torch.int32, device=dev) \
        if lengths is None else torch.as_tensor(lengths, dtype=torch.int32,
                                                device=dev)
    pre_pos = torch.arange(kp, device=dev)
    tail_pos = prefix_len + torch.arange(st, device=dev)
    qg = q.reshape(b, hkv, g, st, d)

    def masks(q_pos, bq):
        m_pre = (pre_pos[None, :] < prefix_len) & \
                (pre_pos[None, :] <= q_pos[:, None])
        m_tail = (tail_pos[None, None, :] <= q_pos[None, :, None]) & \
                 (tail_pos[None, None, :] <
                  (prefix_len + lens)[:, None, None])
        if spec.window is not None:
            m_pre = m_pre & (pre_pos[None, :] > q_pos[:, None] - spec.window)
            m_tail = m_tail & (tail_pos[None, None, :] >
                               q_pos[None, :, None] - spec.window)
        m_pre = m_pre[None, None, None].expand(b, hkv, g, bq, kp)
        m_tail = m_tail[:, None, None].expand(b, hkv, g, bq, st)
        return torch.cat([m_pre, m_tail], dim=-1)

    if mode == "int":
        npg = pre_k_scale.shape[1]
        ps = kp // npg
        kq = _as_q_rows(k, cfg.a_bits)
        vq = _as_q_rows(v, cfg.a_bits)
        qmaxp = (1 << cfg.attn_bits) - 1
        kfac = torch.repeat_interleave(pre_k_scale.to(torch.float32), ps,
                                       dim=1)

        def one_chunk(ci, qc):
            bq = qc.shape[3]
            q_pos = prefix_len + ci * bq + torch.arange(bq, device=dev)
            mask = masks(q_pos, bq)
            qq = _as_q_rows(qc, cfg.a_bits)
            base = scale * LOG2E * _sc5(qq.scale)
            acc_pre = int_matmul_exact(qq.q, k_pre[:, :, None]
                                       .transpose(-1, -2))
            x_pre = acc_pre.to(torch.float32) * \
                (base * kfac[:, None, None, None, :])
            acc_t = int_matmul_exact(qq.q, kq.q[:, :, None].transpose(-1, -2))
            x_t = acc_t.to(torch.float32) * (base * _sc5(kq.scale))
            x = torch.cat([x_pre, x_t], dim=-1)
            x = torch.clamp(torch.where(mask, x, NEG_BIG), min=-120.0)
            m = torch.floor(x.amax(dim=-1, keepdim=True))
            e = exp2_shift(x - m) if cfg.softmax == "base2" \
                else torch.exp2(x - m)
            e = torch.where(mask & (x > -120.0), e, 0.0)
            sigma = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
            dattn = (2.0 / qmaxp) / sigma
            p_q = torch.clamp(torch.round(e * (qmaxp / 2.0)), 0, qmaxp)
            # Prefix PV: integer contraction PER PAGE, each page's int32
            # partial scaled by its own stored dv before the f32 sum.
            pp = p_q[..., :kp].reshape(b, hkv, g, bq, npg, ps)
            vpre = v_pre.reshape(b, hkv, npg, ps, d)
            pv_pre = int_matmul_exact(pp.permute(0, 1, 4, 2, 3, 5),
                                      vpre[:, :, :, None])  # (b,h,n,g,q,d)
            pv_pre = pv_pre.permute(0, 1, 3, 4, 2, 5).to(torch.float32)
            pv_pre = torch.sum(
                pv_pre * pre_v_scale[:, None, None, None, :, None], dim=4)
            pv_t = int_matmul_exact(p_q[..., kp:], vq.q[:, :, None])
            pv = pv_pre + pv_t.to(torch.float32) * _sc5(vq.scale)
            return (pv * dattn).to(q.dtype)
    else:                              # float pools (the reference's else)
        kpre_f = k_pre.to(q.dtype)
        vpre_f = v_pre.to(q.dtype)

        def one_chunk(ci, qc):
            bq = qc.shape[3]
            q_pos = prefix_len + ci * bq + torch.arange(bq, device=dev)
            mask = masks(q_pos, bq)
            x = torch.cat(
                [torch.einsum("bhgqd,bhkd->bhgqk", qc, kpre_f),
                 torch.einsum("bhgqd,bhkd->bhgqk", qc, k.to(q.dtype))],
                dim=-1).to(torch.float32) * scale
            x = torch.where(mask, x, NEG_BIG)
            p = torch.softmax(x, dim=-1).to(q.dtype)
            vcat = torch.cat([vpre_f, v.to(q.dtype)], dim=2)
            return torch.einsum("bhgqk,bhkd->bhgqd", p, vcat)

    from repro_torch.kernels.dispatch import chunk_len
    bq = chunk_len(st, spec.q_chunk)
    n_chunks = st // bq
    outs = [one_chunk(ci, qg[:, :, :, ci * bq:(ci + 1) * bq])
            for ci in range(n_chunks)]
    return torch.cat(outs, dim=3).reshape(b, hq, st, d)


def attention(q, k, v, spec: AttnSpec, cfg: Optional[QuantConfig] = None, *,
              q_offset=0, k_offset=0, k_positions=None):
    """Multi-head attention with GQA, chunked over queries.

    q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) floats or QTensors; Hq % Hkv ==
    0.  ``q_offset`` gives absolute query positions; ``k_positions`` (Sk,)
    overrides key positions (negative = unwritten, masked).  Returns
    (B, Hq, Sq, D).  The plain path re-quantizes q once per query chunk
    (:func:`repro_torch.kernels.dispatch.chunk_len`); the fused kernel
    matches that with one scale per query tile.
    """
    if cfg is not None and cfg.mode == "int":
        from repro_torch.kernels.dispatch import maybe_attention
        out = maybe_attention(q, k, v, spec, cfg, q_offset=q_offset,
                              k_offset=k_offset, k_positions=k_positions)
        if out is not None:                    # kernel path
            return out
    if isinstance(k, quant.QTensor):
        k = k.unpacked()
    if isinstance(v, quant.QTensor):
        v = v.unpacked()
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    sk = k.shape[2]
    dev = q.device
    qg = q.reshape(b, hkv, g, sq, d)
    k_pos = k_positions if k_positions is not None \
        else k_offset + torch.arange(sk, device=dev)

    if sq <= spec.q_chunk:
        q_pos = q_offset + torch.arange(sq, device=dev)
        out = _row_attention(qg, k, v, q_pos, k_pos, spec, cfg)
        return out.reshape(b, hq, sq, d)

    from repro_torch.kernels.dispatch import chunk_len
    bq = chunk_len(sq, spec.q_chunk)
    window = spec.window
    outs = []
    for ci in range(sq // bq):
        qc = qg[:, :, :, ci * bq:(ci + 1) * bq]
        q_pos = q_offset + ci * bq + torch.arange(bq, device=dev)
        if window is not None and sk > 2 * window:
            # Local attention: slice just the (bq + window) keys that matter.
            span = bq + window
            start = min(max(ci * bq + bq - span, 0), sk - span)
            ks = k[:, :, start:start + span]
            vs = v[:, :, start:start + span]
            kp = k_offset + start + torch.arange(span, device=dev)
            outs.append(_row_attention(qc, ks, vs, q_pos, kp, spec, cfg))
        else:
            outs.append(_row_attention(qc, k, v, q_pos, k_pos, spec, cfg))
    return torch.cat(outs, dim=3).reshape(b, hq, sq, d)
