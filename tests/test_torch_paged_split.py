"""The paged decode kernel's split across the card, as an algorithm, held
against the paged oracles.

The CUDA paged kernel (``csrc/int_attention.cu``) cuts each sequence's
page table into chunks of ``int_attention.paged_plan`` whole pages and runs
three launches: each chunk's logits and per-row maxima; each live chunk's
codes against m_t (the floor of the maximum over the earlier chunks' maxima
and this chunk's page maxima up to page t), with each page's Sigma and PV
rescaled exactly to the chunk's last m; a merge of the chunks in order.  A
table of one chunk takes one launch that folds its only chunk into the
empty state.
:func:`split_paged` below does the same steps in plain PyTorch, so the
design is checked here on the CPU where the kernel cannot run: codes
EXACTLY equal to ``ref.int_paged_decode_attention_ref(bk=page_size)`` (the
kernel's plain version), outputs to 2e-6 of their max against it and the
reference's own ``repro.kernels.ref`` oracle (Sigma and the PV carries are
f32 sums in another association: pages within a chunk, then the chunks);
a batch row bit-equal to the same row run solo, at any table width; and
the merge of a single chunk the identity, so the one-launch path gives the
split path's bits.  On the card the kernel is held against the same plain
version (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro_torch.core.quant import int_matmul_exact, unpack_int4
from repro_torch.core.softmax2 import exp2_shift, exp2i
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import int_attention as ia

torch.set_num_threads(1)

ATTN_TOL = 2e-6
NEG = -1e30


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def _carry(m_old, m_new):
    """Exact 2^(m_old - m_new); 0 out of the empty state."""
    return torch.where(m_old <= NEG, torch.tensor(0.0), exp2i(m_old - m_new))


def _live_pages(pt_row, pos_b, window, ps):
    """Physical page of each logical page with a live key, else -1."""
    wlo = max(pos_b - window + 1, 0) if window is not None else 0
    return [int(raw) if pos_b >= 0 and raw >= 0 and
            max(t * ps, wlo) <= min(t * ps + ps - 1, pos_b) else -1
            for t, raw in enumerate(pt_row.tolist())]


def chunk_passes(q, k, v, sc, vs, pt, pos, *, p, kps=None, vps=None,
                 window=None, attn_bits=7):
    """Passes 1 and 2 of one sequence: q (H, G, D) int8, k and v the pools
    unpacked to int8 codes (num, H, ps, D), pt (maxp,) its page table,
    pos, sc, vs its scalars.  Returns the codes (H, G, maxp * ps) and, per
    chunk, None when it is dead, else (chunk max (H, G), Sigma (H, G),
    PV (H, G, D)), the partials relative to the chunk's last m: each
    page's sums rescaled exactly to it, added in page order."""
    h, g, d = q.shape
    ps = k.shape[2]
    maxp = pt.shape[0]
    qmax = (1 << attn_bits) - 1
    phys = _live_pages(pt, int(pos), window, ps)
    wlo = max(int(pos) - window + 1, 0) if window is not None else 0
    codes = torch.zeros((h, g, maxp * ps), dtype=torch.uint8)
    # pass 1: every live page's logits and maxima, each chunk's maximum
    x, pm = {}, {}
    for t, ph in enumerate(phys):
        if ph < 0:
            continue
        xscale = sc * kps[ph] if kps is not None else sc
        acc = int_matmul_exact(q, k[ph].transpose(1, 2)).to(torch.float32)
        kpos = torch.arange(t * ps, t * ps + ps)
        valid = (kpos <= int(pos)) & (kpos >= wlo)
        x[t] = torch.clamp(torch.where(valid, acc * xscale, NEG), min=-120.0)
        pm[t] = x[t].amax(-1)
    nch = -(-maxp // p)
    cm = [None] * nch
    for c in range(nch):
        live = [pm[t] for t in range(c * p, min(c * p + p, maxp)) if t in pm]
        if live:
            cm[c] = torch.stack(live).amax(0)
    # pass 2: each live chunk against the global m_t
    parts = [None] * nch
    for c in range(nch):
        if cm[c] is None:
            continue
        m = torch.full((h, g), NEG)
        for c2 in range(c):
            if cm[c2] is not None:
                m = torch.maximum(m, cm[c2])
        m = torch.floor(m)
        pages = [t for t in range(c * p, min(c * p + p, maxp)) if t in x]
        m_c = torch.maximum(m, torch.floor(cm[c]))
        s = torch.zeros((h, g))
        pv = torch.zeros((h, g, d))
        for t in pages:
            m = torch.maximum(m, torch.floor(pm[t]))
            e = torch.where(x[t] <= -120.0, 0.0,
                            exp2_shift(x[t] - m[..., None]))
            pc = torch.clamp(torch.round(e * (qmax / 2.0)), 0, qmax)
            codes[..., t * ps:(t + 1) * ps] = pc.to(torch.uint8)
            blk = int_matmul_exact(pc, v[phys[t]]).to(torch.float32)
            if vps is not None:
                blk = blk * (vs * vps[phys[t]])
            r = exp2i(m - m_c)                 # exact, m <= m_c
            s = s + e.sum(-1) * r
            pv = pv + blk * r[..., None]
        parts[c] = (cm[c], s, pv)
    return codes, parts


def direct_out(s, pv, vs, *, page_scaled, attn_bits=7):
    """The output from a row's final (Sigma, PV)."""
    qmax = (1 << attn_bits) - 1
    f = (2.0 / qmax) / torch.clamp(s, min=1e-30)
    if not page_scaled:
        f = f * vs
    return pv * f[..., None]


def merge(parts, vs, *, page_scaled, attn_bits=7):
    """Pass 3: the live chunks folded in order by the exact rescale."""
    m, s, acc = None, None, None
    for part in parts:
        if part is None:
            continue
        cmax, cs, cpv = part
        if m is None:
            m, s, acc = (torch.full_like(cs, NEG), torch.zeros_like(cs),
                         torch.zeros_like(cpv))
        mn = torch.maximum(m, torch.floor(cmax))
        r = _carry(m, mn)
        s = s * r + cs
        acc = acc * r[..., None] + cpv
        m = mn
    if m is None:
        return None
    return direct_out(s, acc, vs, page_scaled=page_scaled,
                      attn_bits=attn_bits)


def split_paged(q, kp, vp, sc, vs, pt, pos, *, kps=None, vps=None,
                window=None, packed=False, attn_bits=7, short=False):
    """The kernel's launches in plain PyTorch over a batch: q (B, Hkv, G,
    D) int8, pools as stored.  ``short``: the one-launch path (the table
    must be one chunk), which writes its only chunk's output directly.
    Returns (out, codes)."""
    b, h, g, d = q.shape
    ps = kp.shape[2]
    p = ia.paged_plan(g, d, ps, packed)
    k, v = (unpack_int4(kp), unpack_int4(vp)) if packed else (kp, vp)
    outs, codes = [], []
    for i in range(b):
        cd, parts = chunk_passes(q[i], k, v, sc[i], vs[i],
                                 pt[i], pos[i], p=p, kps=kps, vps=vps,
                                 window=window, attn_bits=attn_bits)
        if short:
            assert len(parts) <= 1
            part = parts[0] if parts else None
            o = None if part is None else direct_out(
                part[1], part[2], vs[i], page_scaled=kps is not None,
                attn_bits=attn_bits)
        else:
            o = merge(parts, vs[i], page_scaled=kps is not None,
                      attn_bits=attn_bits)
        outs.append(torch.zeros((h, g, d)) if o is None else o)
        codes.append(cd)
    return torch.stack(outs), torch.stack(codes)


def _pack(a):
    return np.array(jquant.pack_int4(jnp.asarray(a)))


def _case(g, d, ps, kv_bits, maxp, pos, seed):
    """B = len(pos), Hkv = 2; a random page permutation with an unallocated
    page in the middle of rows 0 and 1; per-page and per-sequence scales."""
    b, h = len(pos), 2
    rng = np.random.RandomState(seed)
    num = b * maxp + 1
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    kp = rng.randint(lo, hi, (num, h, ps, d)).astype(np.int8)
    vp = rng.randint(lo, hi, (num, h, ps, d)).astype(np.int8)
    if kv_bits == 4:
        kp, vp = _pack(kp), _pack(vp)
    q = rng.randint(-127, 128, (b, h, g, d)).astype(np.int8)
    pt = rng.permutation(b * maxp).reshape(b, maxp).astype(np.int32)
    pt[0, maxp // 3] = -1
    pt[1, 1] = -1
    sc = rng.uniform(2e-3, 1e-2, b).astype(np.float32)
    vs = rng.uniform(5e-3, 2e-2, b).astype(np.float32)
    kps = rng.uniform(0.5, 1.5, num).astype(np.float32)
    vps = rng.uniform(0.005, 0.02, num).astype(np.float32)
    return [torch.from_numpy(a) for a in
            (q, kp, vp, sc, vs, pt, np.asarray(pos, np.int32), kps, vps)]


# (G, D, page size, kv_bits, page-scaled, window, maxp, pos): the serve
# shape's G 5 at D 128 and G 16 (chatglm3-6b, RecurrentGemma-9B's local
# layers) over pages of 16; pages of 6 and 10 keys at D 12 and 20 (rows
# that are not whole words; P 21 and 12).  Rows: the whole table live
# (several chunks), two chunks, inactive, one chunk.
PAGED_SPLIT_CASES = [
    (5, 128, 16, 8, True, None, 40, [639, 300, -1, 60]),
    (5, 128, 16, 4, False, None, 40, [639, 400, -1, 20]),
    (16, 128, 16, 8, True, 500, 40, [639, 300, -1, 60]),
    (16, 128, 16, 4, True, None, 36, [575, 260, -1, 255]),
    (5, 12, 6, 8, True, None, 100, [599, 260, -1, 20]),
    (5, 12, 6, 4, False, 400, 100, [599, 400, -1, 200]),
    (5, 20, 10, 4, True, 400, 60, [599, 300, -1, 5]),
    (16, 20, 10, 8, False, None, 60, [599, 300, -1, 239]),
]


def _run(case, seed):
    g, d, ps, kv_bits, scaled, window, maxp, pos = case
    q, kp, vp, sc, vs, pt, posv, kps, vps = _case(g, d, ps, kv_bits, maxp,
                                                  pos, seed)
    kw = dict(window=window)
    if scaled:
        kw.update(kps=kps, vps=vps)
    return (q, kp, vp, sc, vs, pt, posv), kw, kv_bits == 4


@pytest.mark.parametrize("case", PAGED_SPLIT_CASES)
def test_split_paged_equals_the_oracles(case):
    args, kw, packed = _run(case, seed=PAGED_SPLIT_CASES.index(case))
    q, kp, vp, sc, vs, pt, pos = args
    g, d, ps = case[0], case[1], case[2]
    p = ia.paged_plan(g, d, ps, packed)
    # the rows span several chunks, two, none and one
    spans = []
    for i in range(q.shape[0]):
        live = [t for t, ph in enumerate(_live_pages(pt[i], int(pos[i]),
                                                     kw["window"], ps))
                if ph >= 0]
        spans.append(len({t // p for t in live}))
    assert spans[0] >= 3 and spans[2] == 0 and spans[3] == 1 and \
        spans[1] >= 1, spans
    got, codes = split_paged(*args, packed=packed, **kw)
    want, wcodes = ref.int_paged_decode_attention_ref(
        *args, bk=ps, window=kw["window"], k_page_scale=kw.get("kps"),
        v_page_scale=kw.get("vps"), return_codes=True)
    assert torch.equal(codes, wcodes)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= ATTN_TOL * scale
    assert torch.equal(got[2], torch.zeros_like(got[2]))   # inactive row
    J = lambda a: jnp.asarray(a.numpy())
    scaled = "kps" in kw
    jwant = np.asarray(jref.int_paged_decode_attention_ref(
        J(q), J(kp), J(vp), J(sc), J(vs), J(pt), J(pos), bk=ps,
        window=kw["window"], k_page_scale=J(kw["kps"]) if scaled else None,
        v_page_scale=J(kw["vps"]) if scaled else None))
    assert np.abs(got.numpy() - jwant).max() <= ATTN_TOL * scale


@pytest.mark.parametrize("case", [PAGED_SPLIT_CASES[0], PAGED_SPLIT_CASES[5]])
def test_split_paged_row_equals_the_row_solo(case):
    """A batch row's bits do not depend on the other rows or on the table's
    width: P is the plan's, chunks start at logical page 0, dead chunks
    drop out of the merge."""
    args, kw, packed = _run(case, seed=7)
    q, kp, vp, sc, vs, pt, pos = args
    p = ia.paged_plan(case[0], case[1], case[2], packed)
    got, codes = split_paged(*args, packed=packed, **kw)
    for i in range(q.shape[0]):
        for extra in (0, 2 * p + 1):                 # a wider table
            pti = torch.cat([pt[i:i + 1], torch.full((1, extra), -1,
                                                     dtype=torch.int32)], 1)
            one, ocodes = split_paged(q[i:i + 1], kp, vp, sc[i:i + 1],
                                      vs[i:i + 1], pti, pos[i:i + 1],
                                      packed=packed, **kw)
            assert torch.equal(one[0], got[i])
            assert torch.equal(ocodes[0, ..., :codes.shape[-1]], codes[i])


@pytest.mark.parametrize("case", [PAGED_SPLIT_CASES[0], PAGED_SPLIT_CASES[4],
                                  PAGED_SPLIT_CASES[6]])
def test_one_chunk_path_equals_the_split_path(case):
    """Every row that lives in one chunk: the merge of that chunk is the
    identity, so the one-launch path (its table cut to one chunk) and the
    split path over the whole table give the same bits."""
    args, kw, packed = _run(case, seed=11)
    q, kp, vp, sc, vs, pt, pos = args
    g, d, ps = case[0], case[1], case[2]
    p = ia.paged_plan(g, d, ps, packed)
    got, _ = split_paged(*args, packed=packed, **kw)
    # row 3 lives in chunk 0: the short path over the first P pages
    short, _ = split_paged(q, kp, vp, sc, vs, pt[:, :p].contiguous(),
                           torch.minimum(pos, torch.tensor(p * ps - 1)),
                           packed=packed, short=True, **kw)
    assert torch.equal(short[3], got[3])
    assert torch.equal(short[2], got[2])             # inactive
    # a row whose one live chunk is not the first (a window at its end)
    k, v = (unpack_int4(kp), unpack_int4(vp)) if packed else (kp, vp)
    scaled = "kps" in kw
    win = ps + 1
    codes, parts = chunk_passes(q[0], k, v, sc[0], vs[0], pt[0], pos[0],
                                p=p, kps=kw.get("kps"), vps=kw.get("vps"),
                                window=win)
    live = [c for c, part in enumerate(parts) if part is not None]
    assert len(live) == 1 and live[0] > 0, live
    part = parts[live[0]]
    assert torch.equal(merge(parts, vs[0], page_scaled=scaled),
                       direct_out(part[1], part[2], vs[0],
                                  page_scaled=scaled))


def test_paged_plan_depends_on_g_d_page_and_packing_only():
    """No batch size, table width or row length reaches the plan, so the
    same row is cut into the same chunks in any batch."""
    assert list(inspect.signature(ia.paged_plan).parameters) == \
        ["g", "d", "page_size", "packed"]
    for g, d, ps, packed in ((5, 128, 16, False), (5, 128, 16, True),
                             (16, 256, 16, False), (5, 12, 6, False),
                             (5, 20, 10, True), (64, 128, 16, False),
                             (1, 1024, 16, False), (3, 16, 8192, False)):
        p = ia.paged_plan(g, d, ps, packed)
        dk = d // 2 if packed else d
        assert p >= 1
        assert p == 1 or (p * ps <= 256 and p * ps * dk <= 65536 and
                          4 * g * p * ps <= 65536)
