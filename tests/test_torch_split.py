"""The ring decode kernel's split across the card, as an algorithm, held
against the ring oracles.

The CUDA ring kernel (``csrc/int_attention.cu``) splits a head-fold's ring
into chunks of ``chunk`` keys (``int_attention.ring_plan``) and runs three
launches: each chunk's logits and per-row maxima; each live chunk's codes,
Sigma and int32 PV against its ``bk`` block's running max; a merge of the
chunks block by block.  :func:`split_ring` below does the same steps in
plain PyTorch, so the design is checked here on the CPU where the kernel
cannot run: codes EXACTLY equal to ``ref.int_decode_attention_ref(bk=...)``
(the kernel's plain version), outputs to 2e-6 of their max against it and
against the reference's own ``repro.kernels.ref`` oracle (Sigma is an f32
sum over a block taken in another order: chunk sums, then the chunks in
order).  On the card the kernel is held against the same plain version
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro_torch.core.quant import int_matmul_exact, pack_int4, unpack_int4
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


def split_ring(q, k, v, sc, vs, kpos, pos, *, bk, chunk, attn_bits=7,
               causal=True, window=None):
    """The ring kernel's three launches in plain PyTorch: q (H, G, D) int8,
    k and v (H, span, D) int8 codes, sc and vs (H,).  Returns (out, codes)."""
    h, g, d = q.shape
    span = k.shape[1]
    qmax = (1 << attn_bits) - 1
    nch = -(-span // chunk)
    live = kpos >= 0
    if causal:
        live &= kpos <= pos
    if window is not None:
        live &= kpos > pos - window
    # 1. logits, each chunk's maxima (NEG for a chunk with no live key)
    acc = int_matmul_exact(q, k.transpose(1, 2)).to(torch.float32)
    x = torch.where(live, torch.clamp(acc * sc[:, None, None], min=-120.0),
                    torch.tensor(-120.0))
    cm = torch.full((h, nch, g), NEG)
    chunk_live = [bool(live[c * chunk:(c + 1) * chunk].any())
                  for c in range(nch)]
    for c in range(nch):
        if chunk_live[c]:
            cm[:, c] = x[:, :, c * chunk:(c + 1) * chunk].amax(-1)
    # 2. codes, Sigma and int32 PV of each live chunk against m_t
    codes = torch.zeros((h, g, span), dtype=torch.uint8)
    sp = torch.zeros((h, nch, g))
    pvp = torch.zeros((h, nch, g, d), dtype=torch.int64)
    for c in range(nch):
        if not chunk_live[c]:
            continue
        cend = min((c * chunk // bk + 1) * (bk // chunk), nch)
        m = torch.floor(cm[:, :cend].amax(1))                 # (h, g)
        xc = x[:, :, c * chunk:(c + 1) * chunk]
        e = torch.where(xc <= -120.0, 0.0, exp2_shift(xc - m[..., None]))
        p = torch.clamp(torch.round(e * (qmax / 2.0)), 0, qmax)
        codes[:, :, c * chunk:(c + 1) * chunk] = p.to(torch.uint8)
        sp[:, c] = e.sum(-1)
        pvp[:, c] = int_matmul_exact(p, v[:, c * chunk:(c + 1) * chunk])
    # 3. merge, block by block in slot order
    m = torch.full((h, g), NEG)
    s = torch.zeros((h, g))
    pv = torch.zeros((h, g, d))
    cpb = bk // chunk
    for c0 in range(0, nch, cpb):
        blk = [c for c in range(c0, min(c0 + cpb, nch)) if chunk_live[c]]
        if not blk:
            continue
        mn = torch.maximum(m, torch.floor(cm[:, blk].amax(1)))
        r = torch.where(m <= NEG, 0.0, exp2i(m - mn))
        st = torch.zeros((h, g))
        for c in blk:
            st = st + sp[:, c]
        s = s * r + st
        pv = pv * r[..., None] + sum(pvp[:, c] for c in blk).to(torch.float32)
        m = mn
    dattn = (2.0 / qmax) / torch.clamp(s, min=1e-30)
    return pv * (dattn * vs[:, None])[..., None], codes


# (G, D, span, bk, pos, kv_bits, window): chatglm3-6b's G 16, the main
# path's G 5 and an odd G 11; D 12 (neither 8- nor 16-byte rows), 128 and
# RecurrentGemma-9B's 256; spans of one (partly written), two and three
# 512-key blocks of two 256-key chunks, the last block short; wrapped rings,
# kv8 and kv4, windows that leave dead chunks inside live blocks.
SPLIT_CASES = [(g, d, span, 512, pos, kv, win)
               for g in (5, 11, 16) for d in (12, 128, 256)
               for span, pos, kv, win in ((1000, 2999, 8, None),
                                          (1400, 1777, 4, 600))] + \
    [(5, 128, 300, 512, 150, 8, None), (16, 256, 300, 512, 299, 4, 40),
     (11, 12, 1024, 1024, 5000, 8, 300)]


@pytest.mark.parametrize("g,d,span,bk,pos,kv_bits,window", SPLIT_CASES)
def test_split_ring_equals_the_oracle(g, d, span, bk, pos, kv_bits, window):
    h = 2
    rng = np.random.RandomState(g * 1000 + d + span)
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    q = torch.from_numpy(rng.randint(-127, 128, (h, g, d)).astype(np.int8))
    k = torch.from_numpy(rng.randint(lo, hi, (h, span, d)).astype(np.int8))
    v = torch.from_numpy(rng.randint(lo, hi, (h, span, d)).astype(np.int8))
    if kv_bits == 4:                       # as the ring stores them
        k, v = unpack_int4(pack_int4(k)), unpack_int4(pack_int4(v))
    slot = pos % span
    kpos = (pos - np.mod(slot - np.arange(span), span)).astype(np.int32)
    kpos[rng.rand(span) < 0.05] = -1       # a few unwritten slots
    kpos = torch.from_numpy(kpos)
    sc = torch.from_numpy(rng.uniform(2e-4, 2e-3, h).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(5e-3, 2e-2, h).astype(np.float32))
    chunk, ds = ia.ring_plan(g, d, bk)
    assert bk % chunk == 0 and ds % 16 == 0
    assert ia.ring_smem(g, chunk, ds) <= ia.SMEM_BUDGET
    got, codes = split_ring(q, k, v, sc, vs, kpos, torch.tensor(pos), bk=bk,
                            chunk=chunk, window=window)
    want, wcodes = ref.int_decode_attention_ref(
        q, k, v, sc, vs, kpos, torch.tensor(pos, dtype=torch.int32),
        window=window, bk=bk, return_codes=True)
    assert torch.equal(codes, wcodes)
    scale = want.abs().max().item() + 1e-30
    assert (got - want).abs().max().item() <= ATTN_TOL * scale
    jwant = np.asarray(jref.int_decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(sc.numpy()), jnp.asarray(vs.numpy()),
        jnp.asarray(kpos.numpy()), jnp.int32(pos), window=window, bk=bk))
    assert np.abs(got.numpy() - jwant).max() <= ATTN_TOL * scale
