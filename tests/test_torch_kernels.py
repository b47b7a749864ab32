"""The port's kernel modules held against the JAX package's Pallas kernels
(interpret mode) and ``repro.kernels.ref`` oracles, and the dispatch seam
(folding, block choices, STATS) against the JAX dispatch.

On the CPU every wrapper runs its kernel's plain version (it never
launches, and never counts a launch); the CUDA kernels themselves are held
against these same plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  Tolerances: integer artefacts exact; attention
outputs to 2e-6 of the output's max (Sigma is an f32 sum over a key block
taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.kernels.int_attention import (int_attention_fused as j_fused,
                                         int_paged_decode_attention as j_paged)
from repro.kernels.qmatmul import qmatmul as j_qmatmul
from repro.layers import attention as jattn
from repro.core.api import QuantConfig as JQuantConfig
from repro_torch.core.api import QuantConfig
from repro_torch.core import quant
from repro_torch.core.quant import pack_int4
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import int_attention as ia
from repro_torch.kernels import qmatmul as qm
from repro_torch.layers import attention as tattn

torch.set_num_threads(1)

ATTN_TOL = 2e-6


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=ATTN_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("m,n,k,packed", [(4, 40, 64, False),
                                          (37, 24, 96, True)])
def test_qmatmul_plain_equals_pallas(m, n, k, packed):
    rng = np.random.RandomState(m + n)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-8, 8, (n, k)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    rs = rng.uniform(0.01, 0.1, m).astype(np.float32)
    wj = jquant.pack_int4(jnp.asarray(w)) if packed else jnp.asarray(w)
    wt = pack_int4(t(w)) if packed else t(w)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    want = j_qmatmul(jnp.asarray(x), wj, jnp.asarray(scale),
                     jnp.asarray(bias), jnp.asarray(rs), bm=128, bn=128,
                     bk=128, packed=packed)
    before = qm.LAUNCHES["qmatmul"]
    got = qm.qmatmul(t(x), wt, t(scale), t(bias), t(rs), packed=packed)
    assert qm.LAUNCHES["qmatmul"] == before          # CPU: plain version
    # Exact against the epilogue rounded op by op (what the CUDA kernel
    # does); XLA on the CPU contracts ``acc * s + b`` into one FMA, so the
    # JAX kernel differs by at most one rounding of the product.
    acc = (x.astype(np.int64) @ w.astype(np.int64).T).astype(np.float32)
    two_step = acc * (scale[None, :] * rs[:, None]) + bias[None, :]
    np.testing.assert_array_equal(got.numpy(), two_step)
    close(got.numpy(), want, tol=1e-6)
    close(ref.qmatmul_ref(t(x), wt, t(scale), t(bias)).numpy(),
          jref.qmatmul_ref(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(scale), jnp.asarray(bias)), tol=1e-6)


def _attn_case(h, g, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, (h, g * sq, d)).astype(np.int8)
    k = rng.randint(-127, 128, (h, sk, d)).astype(np.int8)
    v = rng.randint(-127, 128, (h, sk, d)).astype(np.int8)
    return rng, q, k, v


def test_fused_attention_plain_matches_pallas():
    """Keys streamed in blocks of 8 on the running max (bk < Sk), a local
    window and 8-bit codes: the case where bk is part of the semantics."""
    sq, sk, bq, bk, window, bits = 24, 24, 16, 8, 6, 8
    h, g, d = 3, 2, 16
    rng, q, k, v = _attn_case(h, g, sq, sk, d, sq + bk)
    nq = -(-(g * sq) // bq)
    sc = rng.uniform(2e-4, 6e-4, (h, nq)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, h).astype(np.float32)
    kw = dict(attn_bits=bits, causal=True, window=window, bq=bq, bk=bk,
              sq_mod=sq)
    want = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(sc), jnp.asarray(vs), **kw)
    before = dict(ia.LAUNCHES)
    got, codes = ia.int_attention_fused(t(q), t(k), t(v), t(sc), t(vs),
                                        return_codes=True, **kw)
    assert ia.LAUNCHES == before
    close(got.numpy(), want)
    rows = np.repeat(sc, bq, axis=1)[:, :g * sq]
    close(got.numpy(), jref.int_attention_ref_streamed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(rows),
        jnp.asarray(vs), bk=bk, attn_bits=bits, window=window, sq_mod=sq))
    assert codes.dtype == torch.uint8 and int(codes.max()) <= (1 << bits) - 1
    # one block covering the row: the streamed grid IS the full-row grid
    one, _ = ia.int_attention_fused(t(q), t(k), t(v), t(sc), t(vs),
                                    return_codes=True, **{**kw, "bk": 32})
    full = ref.int_attention_ref(t(q), t(k), t(v), t(rows), t(vs),
                                 attn_bits=bits, window=window, sq_mod=sq)
    close(one.numpy(), full.numpy())


def _paged_case(kv_bits, seed=0):
    b, hkv, g, d, ps, maxp = 4, 2, 3, 16, 4, 5
    rng = np.random.RandomState(seed + kv_bits)
    num = b * maxp + 1
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    kp = rng.randint(lo, hi, (num, hkv, ps, d)).astype(np.int8)
    vp = rng.randint(lo, hi, (num, hkv, ps, d)).astype(np.int8)
    if kv_bits == 4:
        kp = np.asarray(jquant.pack_int4(jnp.asarray(kp)))
        vp = np.asarray(jquant.pack_int4(jnp.asarray(vp)))
    q = rng.randint(-127, 128, (b, hkv, g, d)).astype(np.int8)
    pt = rng.permutation(b * maxp).reshape(b, maxp).astype(np.int32)
    pt[1, 3:] = -1                                  # unallocated tail
    pos = np.array([19, 9, -1, 4], np.int32)        # row 2 inactive
    sc = rng.uniform(0.004, 0.01, b).astype(np.float32)
    vs = np.ones(b, np.float32)
    kps = rng.uniform(0.5, 1.5, num).astype(np.float32)
    vps = rng.uniform(0.005, 0.02, num).astype(np.float32)
    return q, kp, vp, sc, vs, pt, pos, kps, vps


@pytest.mark.parametrize("kv_bits,window", [(8, None), (4, 7)])
def test_paged_decode_plain_matches_pallas_and_ref(kv_bits, window):
    q, kp, vp, sc, vs, pt, pos, kps, vps = _paged_case(kv_bits)
    packed = kv_bits == 4
    J = lambda a: jnp.asarray(a)
    want = j_paged(J(q), J(kp), J(vp), J(sc), J(vs), J(pt), J(pos),
                   k_page_scale=J(kps), v_page_scale=J(vps), window=window,
                   packed=packed)
    oracle = jref.int_paged_decode_attention_ref(
        J(q), J(kp), J(vp), J(sc), J(vs), J(pt), J(pos), window=window,
        bk=kp.shape[2], k_page_scale=J(kps), v_page_scale=J(vps))
    before = dict(ia.LAUNCHES)
    got, codes = ia.int_paged_decode_attention(
        t(q), t(kp), t(vp), t(sc), t(vs), t(pt), t(pos),
        k_page_scale=t(kps), v_page_scale=t(vps), window=window,
        packed=packed, return_codes=True)
    assert ia.LAUNCHES == before
    close(got.numpy(), oracle)
    close(got.numpy(), want)
    assert np.all(got.numpy()[2] == 0)             # inactive row
    assert int(codes[2].max()) == 0
    # without page scales: per-sequence scales only
    got2 = ia.int_paged_decode_attention(t(q), t(kp), t(vp), t(sc),
                                         t(vs * 0.01), t(pt), t(pos),
                                         window=window, packed=packed)
    close(got2.numpy(), jref.int_paged_decode_attention_ref(
        J(q), J(kp), J(vp), J(sc), J(vs * 0.01), J(pt), J(pos),
        window=window, bk=kp.shape[2]))


def test_paged_attention_kv4_against_xla_and_pallas_paths():
    """kv_bits=4: the reference's two paged paths (layers.attention.
    paged_attention under "xla", which is ref.int_paged_decode_attention_ref
    at bk = page_size, and under "pallas") held separately against the
    port's paged_attention on both of its backends, which agree bitwise."""
    q, kp, vp, sc, vs, pt, pos, kps, vps = _paged_case(4, seed=3)
    b, hkv, g, d = q.shape
    qf = np.random.RandomState(9).randn(b, hkv * g, 1, d).astype(np.float32)
    spec_j, spec_t = jattn.AttnSpec(), tattn.AttnSpec()
    qj = JQuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=4, mode="int")
    J = lambda a: jnp.asarray(a)
    outs = {}
    for jb in ("xla", "pallas"):
        with jdispatch.use_backend(jb):
            outs[jb] = np.asarray(jattn.paged_attention(
                J(qf), J(kp), J(vp), J(sc), J(vs), J(pt), J(pos), spec_j, qj,
                k_page_scale=J(kps), v_page_scale=J(vps)))
    got = {}
    for backend in ("cuda", "torch"):
        qt = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=4,
                         mode="int", backend=backend)
        got[backend] = tattn.paged_attention(
            t(qf), t(kp), t(vp), t(sc), t(vs), t(pt), t(pos), spec_t, qt,
            k_page_scale=t(kps), v_page_scale=t(vps)).numpy()
        close(got[backend], outs["xla"])
        close(got[backend], outs["pallas"])
    np.testing.assert_array_equal(got["cuda"], got["torch"])


def test_attention_dispatch_folds_like_jax():
    """attention() on the cuda route (fused kernel's plain version via the
    GQA/batch fold, per-(sequence, chunk) q grids) against the JAX pallas
    route and the JAX xla route; the port's torch route against JAX xla."""
    rng = np.random.RandomState(11)
    b, hq, hkv, s, d = 2, 4, 2, 32, 16
    q = rng.randn(b, hq, s, d).astype(np.float32)
    k = rng.randn(b, hkv, s, d).astype(np.float32)
    v = rng.randn(b, hkv, s, d).astype(np.float32)
    spec_j = jattn.AttnSpec(q_chunk=16)
    spec_t = tattn.AttnSpec(q_chunk=16)
    qj = JQuantConfig(a_bits=8, attn_bits=7, mode="int")
    J = lambda a: jnp.asarray(a)
    jdispatch.reset_stats()
    with jdispatch.use_backend("pallas"):
        want_p = np.asarray(jattn.attention(J(q), J(k), J(v), spec_j, qj))
    with jdispatch.use_backend("xla"):
        want_x = np.asarray(jattn.attention(J(q), J(k), J(v), spec_j, qj))
    assert jdispatch.STATS["attention_pallas"] == 1
    dispatch.reset_stats()
    for backend, want in (("cuda", want_p), ("torch", want_x)):
        qt = QuantConfig(a_bits=8, attn_bits=7, mode="int", backend=backend)
        got = tattn.attention(t(q), t(k), t(v), spec_t, qt).numpy()
        close(got, want)
        close(got, want_x)        # bk >= Sk: the fused grid is the full row
    assert dispatch.STATS["attention_cuda"] == 1
    assert dispatch.STATS["attention_torch"] == 1
    blocks = dispatch.STATS["blocks"]
    assert blocks["attention:sq64_sk32_d16_wNone_c16"] == [16, 32]


def test_block_choices_fit_the_card():
    # main-path prefill: Qwen2.5-32B head dim 128, G = 5, prompt bucket 64
    assert dispatch.attention_blocks(5 * 64, 64, 128, chunk=64) == (64, 64)
    bq, bk = dispatch.attention_blocks(5 * 1024, 1024, 128, chunk=128)
    assert (bq, bk) == (64, 256)
    assert dispatch.block_rule_bytes(bq, bk, 128) <= dispatch.SMEM_BUDGET
    assert dispatch.block_rule_bytes(64, 512, 128) > dispatch.SMEM_BUDGET
    # the kernel's own tiles fit every block choice the rule makes: head
    # dims padded to 16, key rows up to 4096, windows, recalibration chunks
    for d in (12, 16, 30, 64, 80, 128, 256):
        for sq, sk in ((1, 1), (198, 198), (320, 64), (5 * 1024, 1024),
                       (64, 4096), (4096, 4096)):
            for window in (None, 100):
                for chunk in (None, 64):
                    _, bk = dispatch.attention_blocks(sq, sk, d, window=window,
                                                      chunk=chunk)
                    d16 = -(-d // 16) * 16
                    bm, kt = ia.attention_plan(bk, d16)
                    assert ia.attention_smem(bm, kt, bk, d16) <= \
                        ia.SMEM_BUDGET, (d, sq, sk, window, chunk)
    # DeiT-S through dispatch keeps 64-row tiles and 128-key sub-tiles
    assert ia.attention_plan(224, 64) == (64, 128)
    # ring decode at the reference's bk, every registry width up to G 16
    # (chatglm3-6b, RecurrentGemma-9B's local layers) and beyond
    for g in (1, 4, 5, 7, 8, 11, 16, 64):
        for d in (12, 64, 80, 128, 256, 1024):
            for span in (1, 80, 1024, 2560, 4097, 8192, 32768):
                bk = dispatch.decode_blocks(span, d)
                chunk, ds = ia.ring_plan(g, d, bk)
                assert bk % chunk == 0 and ds % 16 == 0
                assert ia.ring_smem(g, chunk, ds) <= ia.SMEM_BUDGET
    assert ia.ring_plan(5, 128, 4096) == (256, 128)
    # paged decode: chunks of 256 keys at the serve shape and at G 16,
    # D 256 (the launcher checks the fit); small pages take more of them
    assert ia.paged_plan(5, 128, 16, False) == 16 == \
        ia.paged_plan(16, 256, 16, False) == ia.paged_plan(5, 128, 16, True)
    assert ia.paged_plan(5, 12, 6, False) == 42
    # one page per block, the reference's choice, any page size (a page
    # over the card's shared memory is the wrapper's error, not a plain
    # route)
    assert dispatch.paged_decode_blocks(16, 128) == 16
    assert dispatch.paged_decode_blocks(6, 128) == 6 == \
        jdispatch.paged_decode_blocks(6, 128)
    assert dispatch.qmatmul_blocks(4, 5120, 5120) == ("stream", 8, 32, 1)
    assert dispatch.qmatmul_blocks(256, 27648, 5120) == ("mma", 128, 128, 1)
    assert dispatch.chunk_len(48, 16) == jdispatch.chunk_len(48, 16) == 16
    assert dispatch.chunk_len(40, 16) == jdispatch.chunk_len(40, 16)


def test_paged_read_grid_and_quantize_rows_match_jax():
    rng = np.random.RandomState(12)
    qf = rng.randn(3, 4, 1, 16).astype(np.float32) * \
        rng.uniform(0.1, 5, (3, 1, 1, 1)).astype(np.float32)
    ks = rng.uniform(0.01, 0.1, 3).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, 3).astype(np.float32)
    qj = JQuantConfig(a_bits=8, mode="int")
    qt = QuantConfig(a_bits=8, mode="int")
    for page_scaled in (False, True):
        cj, sj, vj = jdispatch.paged_read_grid(
            jnp.asarray(qf), jattn.AttnSpec(), qj, jnp.asarray(ks),
            jnp.asarray(vs), page_scaled)
        ct, st, vt = dispatch.paged_read_grid(
            t(qf), tattn.AttnSpec(), qt, t(ks), t(vs), page_scaled)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(np.asarray(vt), np.asarray(vj))


def test_cuda_tensor_never_falls_back_to_plain(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    'meta' tensor stands in for one the plain path must not take."""
    x = torch.empty((4, 8), dtype=torch.int8, device="meta")
    w = torch.empty((4, 8), dtype=torch.int8, device="meta")
    s = torch.empty((4,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        qm.qmatmul(x, w, s)
    assert qm.LAUNCHES["qmatmul"] == 0


def _policy_grid():
    """(name, numpy inputs) for the three shape policies: K and D that are
    2 mod 4, packed and odd-K weights, stacked weights, fresh and
    pre-quantized (int8 and packed) q/k, ring positions, offsets, GQA
    misfits, page sizes 6 and 16, int8 and packed pools, a page over the
    reference's tile budget."""
    z = lambda *s, dt=np.float32: np.zeros(s, dt)
    lin = []
    for k in (6, 8, 10, 7):
        for packed in (False, True):
            w = z(12, -(-k // 2), dt=np.uint8) if packed else \
                z(12, k, dt=np.int8)
            lin.append((z(3, k), w))
            lin.append((z(2, 5, k), w))
    lin.append((z(2, 8), z(4, 12, 8, dt=np.int8)))          # stacked
    lin.append((z(0, 8), z(12, 8, dt=np.int8)))             # empty
    att = []
    for d in (6, 8, 10):
        for kind in ("float", "q8", "k8", "k4"):
            att.append((kind, (1, 4, 5, d), (1, 2, 5, d), None, 0))
    att += [("float", (1, 4, 5, 8), (1, 2, 5, 8), np.arange(5), 0),
            ("float", (1, 4, 5, 8), (1, 2, 5, 8), None, 3),
            ("float", (1, 3, 5, 8), (1, 2, 5, 8), None, 0),
            ("float", (1, 4, 0, 8), (1, 2, 5, 8), None, 0)]
    paged = []
    for ps in (6, 16):
        for d in (10, 128):
            paged.append((ps, d, np.int8, d))
            paged.append((ps, d, np.uint8, d // 2))
    paged += [(16, 128, np.uint8, 128), (32768, 128, np.int8, 128),
              (16, 5, np.uint8, 2)]
    return lin, att, paged


def test_shape_policies_are_the_references():
    """qlinear_supported, attention_supported and paged_decode_supported
    give the reference's answer on one grid of shapes (the card's limits
    are the wrappers' business: they pad K and D, or raise)."""
    lin, att, paged = _policy_grid()
    J = jnp.asarray
    for x, w in lin:
        assert dispatch.qlinear_supported(t(x), {"w_q": t(w)}) == \
            jdispatch.qlinear_supported(J(x), {"w_q": J(w)}), \
            (x.shape, w.shape, w.dtype)
    spec_j, spec_t = jattn.AttnSpec(), tattn.AttnSpec()
    qj = JQuantConfig(a_bits=8, attn_bits=7, mode="int")
    qt = QuantConfig(a_bits=8, attn_bits=7, mode="int")
    for kind, qs, ks, kpos, off in att:
        q, k = np.zeros(qs, np.float32), np.zeros(ks, np.float32)
        jq_, jk_, tq_, tk_ = J(q), J(k), t(q), t(k)
        if kind == "q8":
            jq_ = jquant.QTensor(J(q.astype(np.int8)), jnp.float32(0.1))
            tq_ = quant.QTensor(t(q.astype(np.int8)), torch.tensor(0.1))
        if kind in ("k8", "k4"):
            kk = k.astype(np.int8) if kind == "k8" else \
                np.zeros(ks[:-1] + (ks[-1] // 2,), np.uint8)
            jk_ = jquant.QTensor(J(kk), jnp.float32(0.1), 8 if kind ==
                                 "k8" else 4)
            tk_ = quant.QTensor(t(kk), torch.tensor(0.1), 8 if kind ==
                                "k8" else 4)
        kp = None if kpos is None else (J(kpos), t(kpos))
        assert dispatch.attention_supported(
            tq_, tk_, spec_t, qt, off, 0, None if kp is None else kp[1]) == \
            jdispatch.attention_supported(
                jq_, jk_, spec_j, qj, off, 0, None if kp is None else kp[0]), \
            (kind, qs, ks, kpos is not None, off)
    for ps, d, dt, dk in paged:
        q = np.zeros((2, 4, 1, d), np.float32)
        pool = np.zeros((5, 2, ps, dk), dt)
        pt = np.zeros((2, 3), np.int32)
        pos = np.zeros((2,), np.int32)
        assert dispatch.paged_decode_supported(
            t(q), t(pool), spec_t, qt, t(pt), t(pos)) == \
            jdispatch.paged_decode_supported(
                J(q), J(pool), spec_j, qj, J(pt), J(pos)), (ps, d, dt, dk)
