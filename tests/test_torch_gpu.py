"""The CUDA kernels held against their plain versions on the card.

Needs an NVIDIA GPU with the CUDA toolkit (``nvcc``): every test carries
the ``gpu`` marker and skips, from a fixture, when
``torch.cuda.is_available()`` is false.  On the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

``python3 chip_smoke.py`` runs the same comparisons at the main path's
full widths, plus serving and timing.
"""
import pytest
import torch

from repro_torch.core.quant import pack_int4
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import int_attention as ia
from repro_torch.kernels import qmatmul as qm

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _qmm_inputs(gen, m, n, k, packed):
    x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-8, 8, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = pack_int4(w) if packed else w
    s = torch.rand((n,), generator=gen, device="cuda") * 1e-3
    b = torch.randn((n,), generator=gen, device="cuda")
    rs = torch.rand((m,), generator=gen, device="cuda")
    return x, w, s, b, rs


# decode rows (the stream body: one n8 tile of x rows up to M 8, two up
# to 16), then the tensor-core body at 64- and 128-row tiles with rows,
# columns and K off the tile (K 1028: padded to 16 or 32)
@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17, 77, 129, 256])
@pytest.mark.parametrize("n,k", [(1000, 512), (300, 1028)])
@pytest.mark.parametrize("packed", [False, True])
def test_qmatmul_kernel_equals_plain(gen, m, n, k, packed):
    x, w, s, b, rs = _qmm_inputs(gen, m, n, k, packed)
    blocks = dispatch.qmatmul_blocks(m, n, k)
    assert blocks[0] == ("stream" if m <= 16 else "mma")
    before = qm.LAUNCHES["qmatmul"]
    got = qm.qmatmul(x, w, s, b, rs, blocks=blocks, packed=packed)
    torch.cuda.synchronize()
    assert qm.LAUNCHES["qmatmul"] == before + 1
    assert torch.equal(got, ref.qmatmul_ref(x, w, s, b, rs))


# K split across blocks (the Qwen wq and wk/wv shapes at 256 rows, on
# 128- and 64-row tiles; 200 rows and 1001 columns, whose output rows are
# not 16-byte aligned; 71 slabs in six uneven splits), each epilogue
@pytest.mark.parametrize("m,n,k", [(256, 5120, 5120), (256, 1024, 5120),
                                   (200, 1001, 8320), (300, 1000, 9000)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("epilogue", ["scale", "row_scale", "bias", "both"])
def test_qmatmul_split_k_equals_plain(gen, m, n, k, packed, epilogue):
    x, w, s, b, rs = _qmm_inputs(gen, m, n, k, packed)
    b = b if epilogue in ("bias", "both") else None
    rs = rs if epilogue in ("row_scale", "both") else None
    blocks = qm.plan(m, n, k)
    assert blocks[0] == "mma" and blocks[3] > 1
    before = qm.LAUNCHES["qmatmul"]
    got = qm.qmatmul(x, w, s, b, rs, packed=packed)
    torch.cuda.synchronize()
    assert qm.LAUNCHES["qmatmul"] == before + 1     # two kernels, one call
    assert torch.equal(got, ref.qmatmul_ref(x, w, s, b, rs))


# The accumulator output (a partitioned row-parallel linear's int32 sums,
# no epilogue): the stream body at M 1, 4, 9 and 16, the tensor-core body
# at M 17, 129 and 256, ragged N (1001, 300) and K (1028, padded), K split
# across blocks (K 6912, 8320), and Qwen2.5-32B's wo and down on one of 4
# ranks (N 5120, K 1280 and 6912); int8 and packed.  The epilogue applied
# to the sums is the fused output bit for bit.
@pytest.mark.parametrize("m,n,k", [(1, 1000, 512), (4, 1001, 1280),
                                   (9, 300, 1028), (16, 5120, 6912),
                                   (17, 1000, 512), (129, 1001, 6912),
                                   (200, 1001, 8320), (4, 5120, 1280),
                                   (256, 5120, 1280), (256, 5120, 6912)])
@pytest.mark.parametrize("packed", [False, True])
def test_qmatmul_acc_equals_plain(gen, m, n, k, packed):
    x, w, s, b, rs = _qmm_inputs(gen, m, n, k, packed)
    blocks = dispatch.qmatmul_blocks(m, n, k)
    before = dict(qm.LAUNCHES)
    got = qm.qmatmul_acc(x, w, blocks=blocks, packed=packed)
    torch.cuda.synchronize()
    assert qm.LAUNCHES["qmatmul"] == before["qmatmul"] + 1
    assert qm.LAUNCHES["qmatmul_acc"] == before["qmatmul_acc"] + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.qmatmul_acc_ref(x, w))
    fused = qm.qmatmul(x, w, s, b, rs, blocks=blocks, packed=packed)
    assert torch.equal(ref.qmatmul_epilogue(got, s, b, rs), fused)


# (at 64 rows, where the stream body takes none; the last: five splits
# of K 512, which has four 128-byte slabs)
@pytest.mark.parametrize("blocks", [("mma", 32, 128, 1), ("mma", 64, 64, 1),
                                    ("dp4a", 64, 128, 1), ("dp4a", 16, 64, 2),
                                    ("dp4a", 16, 64, 1),
                                    ("stream", 16, 64, 1),
                                    ("wgmma", 128, 128, 1),
                                    ("mma", 128, 128, 0),
                                    ("mma", 128, 128, 5)])
def test_qmatmul_refuses_a_plan_it_was_not_built_for(gen, blocks):
    x, w, s, b, rs = _qmm_inputs(gen, 64, 256, 512, False)
    before = qm.LAUNCHES["qmatmul"]
    with pytest.raises(RuntimeError, match="qmatmul"):
        qm.qmatmul(x, w, s, b, rs, blocks=blocks)
    assert qm.LAUNCHES["qmatmul"] == before


@pytest.mark.parametrize("sq,sk,window,bits", [(64, 64, None, 7),
                                               (100, 100, 24, 8)])
def test_fused_attention_kernel_codes_exact(gen, sq, sk, window, bits):
    h, g, d = 6, 5, 128
    bq, bk = dispatch.attention_blocks(g * sq, sk, d, window=window)
    nq = -(-(g * sq) // bq)
    mk = lambda *shape: torch.randint(-127, 128, shape, generator=gen,
                                      device="cuda", dtype=torch.int8)
    q, k, v = mk(h, g * sq, d), mk(h, sk, d), mk(h, sk, d)
    sc = (torch.rand((h, nq), generator=gen, device="cuda") + 0.5) * 1e-4
    vs = torch.rand((h,), generator=gen, device="cuda") + 0.5
    kw = dict(attn_bits=bits, causal=True, window=window, bq=bq, bk=bk,
              sq_mod=sq, return_codes=True)
    out, codes = ia.int_attention_fused(q, k, v, sc, vs, **kw)
    torch.cuda.synchronize()
    want, wcodes = ia.int_attention_fused_plain(q, k, v, sc, vs, **kw)
    assert torch.equal(codes, wcodes)
    assert _rel(out, want) <= 1e-5        # Sigma: f32 sum in another order


def _paged_case(gen, kv_bits, g, d, ps, maxp):
    """B 5, Hkv 8, a random page permutation, row 2 inactive; at tables
    wider than 6 pages, rows that span several chunks and a hole in row 0."""
    b, hkv = 5, 8
    num = b * maxp + 1
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    mk = lambda *shape: torch.randint(lo, hi, shape, generator=gen,
                                      device="cuda", dtype=torch.int8)
    kp, vp = mk(num, hkv, ps, d), mk(num, hkv, ps, d)
    if kv_bits == 4:
        kp, vp = pack_int4(kp), pack_int4(vp)
    q = torch.randint(-127, 128, (b, hkv, g, d), generator=gen,
                      device="cuda", dtype=torch.int8)
    pt = torch.randperm(b * maxp, generator=gen, device="cuda") \
        .reshape(b, maxp).to(torch.int32)
    pt[1, 4:] = -1
    if maxp > 6:
        pt[0, maxp // 2] = -1
    pos = torch.tensor([95, 50, -1, 0, 17], dtype=torch.int32,
                       device="cuda") * ps // 16 * maxp // 6
    sc = torch.rand((b,), generator=gen, device="cuda") * 1e-2
    vs = torch.ones((b,), device="cuda")
    kps = torch.rand((num,), generator=gen, device="cuda") + 0.5
    vps = torch.rand((num,), generator=gen, device="cuda") * 1e-2
    return q, kp, vp, sc, vs, pt, pos, kps, vps


# (kv_bits, G, D, page size, table width): the Qwen serve shape (one chunk,
# one launch), RecurrentGemma-9B's local layers, G 16 at D 256, and pages
# of 6 and 10 keys at D 12 and 20 (rows and code words that are not whole
# int8 words); then tables of 40 pages, whose rows span up to five chunks
# (the three launches), at pages of 16 and 10
@pytest.mark.parametrize("kv_bits,g,d,ps,maxp", [
    (8, 5, 128, 16, 6), (4, 5, 128, 16, 6), (8, 16, 256, 16, 6),
    (4, 16, 256, 16, 6), (8, 3, 12, 6, 6), (4, 3, 12, 6, 6),
    (8, 4, 20, 10, 6), (8, 5, 128, 16, 40), (4, 5, 128, 16, 40),
    (8, 16, 256, 16, 40), (8, 4, 20, 10, 60), (4, 5, 128, 10, 60)])
def test_paged_decode_kernel_codes_exact(gen, kv_bits, g, d, ps, maxp):
    q, kp, vp, sc, vs, pt, pos, kps, vps = _paged_case(gen, kv_bits, g, d,
                                                       ps, maxp)
    for window in (None, 40 * ps // 16 * maxp // 6):
        before = ia.LAUNCHES["int_paged_decode_attention"]
        out, codes = ia.int_paged_decode_attention(
            q, kp, vp, sc, vs, pt, pos, k_page_scale=kps, v_page_scale=vps,
            window=window, packed=kv_bits == 4, return_codes=True)
        torch.cuda.synchronize()
        assert ia.LAUNCHES["int_paged_decode_attention"] == before + 1
        want, wcodes = ref.int_paged_decode_attention_ref(
            q, kp, vp, sc, vs, pt, pos, window=window, bk=ps,
            k_page_scale=kps, v_page_scale=vps, return_codes=True)
        assert torch.equal(codes, wcodes.to(torch.uint8))
        assert _rel(out, want) <= 1e-5
        assert out[2].abs().max().item() == 0


# A batch row equals the same sequence run solo, bit for bit, at the
# table's width and at a wider one (the one-launch path of a 6-page table
# against the split path of a 30-page one).
@pytest.mark.parametrize("kv_bits,g,d,ps,maxp", [
    (8, 5, 128, 16, 6), (8, 5, 128, 16, 40), (4, 16, 256, 16, 40),
    (4, 4, 20, 10, 60)])
def test_paged_decode_kernel_row_equals_the_row_solo(gen, kv_bits, g, d, ps,
                                                     maxp):
    q, kp, vp, sc, vs, pt, pos, kps, vps = _paged_case(gen, kv_bits, g, d,
                                                       ps, maxp)
    kw = dict(k_page_scale=kps, v_page_scale=vps, packed=kv_bits == 4,
              return_codes=True)
    out, codes = ia.int_paged_decode_attention(q, kp, vp, sc, vs, pt, pos,
                                               **kw)
    for i in range(q.shape[0]):
        for extra in (0, 24):
            pti = torch.cat([pt[i:i + 1], torch.full(
                (1, extra), -1, dtype=torch.int32, device="cuda")], 1)
            one, ocodes = ia.int_paged_decode_attention(
                q[i:i + 1], kp, vp, sc[i:i + 1], vs[i:i + 1], pti,
                pos[i:i + 1], **kw)
            torch.cuda.synchronize()
            assert torch.equal(one[0], out[i])
            assert torch.equal(ocodes[0, ..., :codes.shape[-1]], codes[i])


def test_serve_on_the_card_runs_every_kernel(gen):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig, integerize_params
    from repro_torch.launch.serve import serve, staggered_prompts
    from repro_torch.models import lm
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int",
                     backend="cuda")
    cfg = smoke_config("qwen2.5-32b").replace(quant=qc)
    params = integerize_params(lm.init_params(cfg, seed=0, device="cuda"), qc)
    dispatch.reset_stats()
    dispatch.reset_launches()
    gen_toks, stats = serve(cfg, params, staggered_prompts(6, 24, cfg.vocab),
                            gen_tokens=6, page_size=8, batch_size=3,
                            audit_every=1)
    assert [s["status"] for s in stats["per_seq"]] == ["done"] * 6
    assert stats["audit_violations"] == []
    launches = dispatch.launch_counts()
    for name in ("qmatmul", "int_attention_fused",
                 "int_paged_decode_attention"):          # the serve path's
        assert launches[name] > 0, launches
    assert stats["dispatch"]["qlinear_torch"] == 0


# (kv_bits, span, pos, window): partly written, wrapped over two 4096-key
# blocks, windowed.
RING_GPU_CASES = [(8, 1024, 100, None), (4, 1024, 100, None),
                  (8, 8192, 20000, None), (4, 8192, 5000, None),
                  (8, 1024, 3000, 200)]


def _ring_case(gen, h, g, d, kv_bits, span, pos):
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    mk = lambda *shape: torch.randint(lo, hi, shape, generator=gen,
                                      device="cuda", dtype=torch.int8)
    k, v = mk(h, span, d), mk(h, span, d)
    if kv_bits == 4:
        k, v = pack_int4(k), pack_int4(v)
    q = torch.randint(-127, 128, (h, g, d), generator=gen, device="cuda",
                      dtype=torch.int8)
    slot = pos % span
    kpos = (pos - torch.remainder(slot - torch.arange(span, device="cuda"),
                                  span)).to(torch.int32)
    sc = (torch.rand((h,), generator=gen, device="cuda") + 0.5) * 1e-3
    vs = (torch.rand((h,), generator=gen, device="cuda") + 0.5) * 1e-2
    posd = torch.tensor([pos], dtype=torch.int32, device="cuda")
    return q, k, v, sc, vs, kpos, posd


def _ring_exact(args, **kw):
    before = ia.LAUNCHES["int_decode_attention"]
    out, codes = ia.int_decode_attention(*args, return_codes=True, **kw)
    torch.cuda.synchronize()
    assert ia.LAUNCHES["int_decode_attention"] == before + 1
    want, wcodes = ia.int_decode_attention_plain(*args, return_codes=True,
                                                 **kw)
    assert torch.equal(codes, wcodes)
    assert _rel(out, want) <= 1e-5        # Sigma: f32 sum in another order


@pytest.mark.parametrize("kv_bits,span,pos,window", RING_GPU_CASES)
def test_ring_decode_kernel_codes_exact(gen, kv_bits, span, pos, window):
    args = _ring_case(gen, 32, 5, 128, kv_bits, span, pos)
    _ring_exact(args, attn_bits=7, window=window,
                bk=dispatch.decode_blocks(span, 128), packed=kv_bits == 4)


def test_ring_generation_on_the_card_runs_the_ring_kernel(gen):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig, integerize_params
    from repro_torch.models import lm
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=4, mode="int",
                     backend="cuda")
    cfg = smoke_config("qwen2.5-32b").replace(quant=qc)
    params = integerize_params(lm.init_params(cfg, seed=0, device="cuda"), qc)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen, device="cuda",
                         dtype=torch.int32)
    dispatch.reset_stats()
    before = ia.LAUNCHES["int_decode_attention"]
    logits, cache = lm.prefill(params, {"tokens": toks}, cfg, max_len=16)
    for _ in range(6):                                  # wraps the ring
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)[:, None]
        logits, cache = lm.decode_step(params, tok, cache, cfg)
    torch.cuda.synchronize()
    assert ia.LAUNCHES["int_decode_attention"] == before + 6 * cfg.n_layers
    assert dispatch.STATS["attention_decode_torch"] == 0
    assert int(cache["pos"]) == 18 and bool(torch.isfinite(logits).all())


# (G, D, span, kv_bits, pos, window): the shapes the ring kernel refused
# before it was split across the card, now code-exact at the reference's
# bk — G 11 and 16 (chatglm3-6b) at D 128 over two 4096-key blocks, G 16 at
# D 256 (RecurrentGemma-9B's local layers), D 12 (byte loads, and nibbles
# at an odd word count), an 8-bit grid and a window
RING_WIDE_CASES = [(11, 128, 8192, 8, 20000, None),
                   (16, 128, 8192, 8, 8191, None),
                   (16, 128, 8192, 4, 9000, 3000),
                   (16, 256, 2048, 8, 5000, None),
                   (16, 256, 2048, 4, 1500, None),
                   (5, 12, 1024, 8, 3000, None),
                   (5, 12, 1024, 4, 700, 200)]


@pytest.mark.parametrize("g,d,span,kv_bits,pos,window", RING_WIDE_CASES)
def test_ring_decode_kernel_takes_every_supported_shape(gen, g, d, span,
                                                        kv_bits, pos, window):
    args = _ring_case(gen, 4, g, d, kv_bits, span, pos)
    _ring_exact(args, attn_bits=8 if d == 12 else 7, window=window,
                bk=dispatch.decode_blocks(span, d), packed=kv_bits == 4)


# (G, D, span, bk): a key block no chunk divides, and G query rows whose
# logits exceed shared memory at any chunk
RING_REFUSED_CASES = [(5, 128, 1024, 100), (4000, 16, 256, 256)]


@pytest.mark.parametrize("g,d,span,bk", RING_REFUSED_CASES)
def test_ring_decode_kernel_refuses_what_it_cannot_take(gen, g, d, span, bk):
    h, pos = 2, 100
    q = torch.zeros((h, g, d), dtype=torch.int8, device="cuda")
    k = torch.zeros((h, span, d), dtype=torch.int8, device="cuda")
    kpos = torch.full((span,), -1, dtype=torch.int32, device="cuda")
    kpos[:pos] = torch.arange(pos, dtype=torch.int32, device="cuda")
    posd = torch.tensor([pos - 1], dtype=torch.int32, device="cuda")
    before = ia.LAUNCHES["int_decode_attention"]
    with pytest.raises(ValueError, match="D="):
        ia.int_decode_attention(q, k, k, 1e-3, 1e-2, kpos, posd, bk=bk)
    assert ia.LAUNCHES["int_decode_attention"] == before


# (rows, d, dtype, bits, rms_only, beta, offset): the DeiT-S block,
# Qwen2.5-32B's width (64 rows and 4), ragged widths (100 f32, 77 bf16:
# tail vectors, bf16 rows off 16 bytes), x starting ``offset`` elements
# into its buffer (4 bytes f32, 2 bytes bf16: every row takes element
# loads), LayerNorm without beta, and the first rows above the register
# plan (16385 f32, 32769 bf16: re-read from global)
PQLN_GPU_CASES = [(2000, 384, torch.float32, 8, False, True, 0),
                  (64, 5120, torch.bfloat16, 8, True, False, 0),
                  (33, 100, torch.float32, 3, False, True, 0),
                  (45, 77, torch.bfloat16, 4, False, True, 0),
                  (300, 384, torch.float32, 8, False, True, 1),
                  (40, 5120, torch.bfloat16, 8, False, True, 1),
                  (300, 384, torch.float32, 8, False, False, 0),
                  (4, 5120, torch.bfloat16, 8, True, False, 0),
                  (5, 16385, torch.float32, 8, False, True, 0),
                  (3, 32769, torch.bfloat16, 8, True, False, 0)]


@pytest.mark.parametrize("rows,d,dtype,bits,rms_only,beta,offset",
                         PQLN_GPU_CASES)
def test_pq_layernorm_kernel_codes_exact(gen, rows, d, dtype, bits,
                                         rms_only, beta, offset):
    from repro_torch.kernels import pq_layernorm as kpl
    buf = (torch.randn((rows * d + offset,), generator=gen, device="cuda")
           * 3 + 0.5).to(dtype)
    x = buf[offset:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16 == \
        offset * buf.element_size()
    g = torch.rand((d,), generator=gen, device="cuda") + 0.5
    b = torch.randn((d,), generator=gen, device="cuda") * 0.1 if beta \
        else None
    before = kpl.LAUNCHES["pq_layernorm"]
    got = kpl.pq_layernorm(x, g, b, 0.05, bits=bits, rms_only=rms_only)
    torch.cuda.synchronize()
    assert kpl.LAUNCHES["pq_layernorm"] == before + 1
    assert torch.equal(got, ref.pq_layernorm_ref(x, g, b, 0.05, bits=bits,
                                                 rms_only=rms_only))


@pytest.mark.parametrize("d,dtype,blocks", [
    (384, torch.float32, (64, 4, 8)), (384, torch.float32, (32, 8, 16)),
    (5120, torch.bfloat16, (128, 8, 40)), (5120, torch.bfloat16,
                                           (256, 8, 32))])
def test_pq_layernorm_refuses_a_plan_it_was_not_built_for(gen, d, dtype,
                                                          blocks):
    from repro_torch.kernels import pq_layernorm as kpl
    x = torch.randn((4, d), generator=gen, device="cuda").to(dtype)
    g = torch.ones((d,), device="cuda")
    out = torch.zeros((4, d), dtype=torch.int8, device="cuda")
    assert blocks != kpl.plan(d, dtype)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        kpl._launch(x, g, None, out, blocks, bits=8, eps=1e-6, delta=0.05,
                    rms_only=False)
    kpl._launch(x, g, None, out, kpl.plan(d, dtype), bits=8, eps=1e-6,
                delta=0.05, rms_only=False)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.pq_layernorm_ref(x, g, None, 0.05, bits=8))


# (H, Sq, Sk, D, causal, window, bq, bk, attn_bits): DeiT-S through ops, a
# windowed causal case at D 128, D 30 padded to 32, and cases for the
# tensor-core tiles: bq 1, 17, 33, 64 and 128 against the kernel's own row
# tiles, D 12 (padded to 16), 64 and 128, key blocks that are not a
# multiple of 32 (40, 100), two and three key blocks, 64-row tiles that do
# not fit beside a 256-key block (32-row tiles), and 2-, 7- and 8-bit
# grids (8-bit codes above 127 go through the u8 x s8 products)
TWO_PASS_GPU_CASES = [(384, 198, 198, 64, False, None, 128, 128, 7),
                      (8, 100, 100, 128, True, 24, 128, 128, 7),
                      (6, 50, 50, 30, True, None, 16, 32, 7),
                      (4, 100, 100, 64, True, None, 1, 64, 7),
                      (4, 70, 90, 12, True, 24, 17, 40, 2),
                      (6, 198, 198, 64, False, None, 33, 224, 8),
                      (3, 300, 300, 128, True, None, 64, 256, 8),
                      (5, 130, 130, 12, False, None, 64, 100, 8),
                      (2, 96, 96, 128, False, 40, 128, 32, 2)]


@pytest.mark.parametrize("h,sq,sk,d,causal,window,bq,bk,bits",
                         TWO_PASS_GPU_CASES)
def test_two_pass_kernel_equals_fused_and_plain(gen, h, sq, sk, d, causal,
                                                window, bq, bk, bits):
    mk = lambda *shape: torch.randint(-127, 128, shape, generator=gen,
                                      device="cuda", dtype=torch.int8)
    q, k, v = mk(h, sq, d), mk(h, sk, d), mk(h, sk, d)
    nq = -(-sq // bq)
    sc = (torch.rand((h, nq), generator=gen, device="cuda") + 0.5) * 2e-4
    vs = torch.rand((h,), generator=gen, device="cuda") + 0.5
    kw = dict(attn_bits=bits, causal=causal, window=window, bq=bq, bk=bk,
              return_codes=True)
    before = dict(ia.LAUNCHES)
    two, codes = ia.int_attention(q, k, v, sc, vs, **kw)
    one, fcodes = ia.int_attention_fused(q, k, v, sc, vs, **kw)
    torch.cuda.synchronize()
    assert ia.LAUNCHES["int_attention"] == before["int_attention"] + 1
    want, wcodes = ia.int_attention_plain(q, k, v, sc, vs, **kw)
    assert torch.equal(codes, wcodes) and torch.equal(fcodes, wcodes)
    if bits == 8:     # each row's top key codes >= 128: the u8 operand
        assert int(wcodes.max()) >= 128
    assert torch.equal(two, one)          # the same sums in the same order
    assert _rel(two, want) <= 1e-5        # Sigma: f32 sum in another order


def test_qmatmul_pads_k_exactly(gen):
    x = torch.randint(-128, 128, (70, 130), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = pack_int4(torch.randint(-8, 8, (33, 130), generator=gen,
                                device="cuda", dtype=torch.int8))
    s = torch.rand((33,), generator=gen, device="cuda") * 1e-3
    got = qm.qmatmul(x, w, s, packed=True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.qmatmul_ref(x, w, s))


# What no padding can fix raises from the wrapper, with the shape, and
# never runs a plain version: a page of 8192 keys (over shared memory), a
# key block whose logits exceed shared memory at any row tile, and a head
# dim above the PV column pairs a warp can hold.
def _paged_refused(g):
    q = torch.zeros((2, 2, 3, 16), dtype=torch.int8, device="cuda")
    pool = torch.zeros((5, 2, 8192, 16), dtype=torch.int8, device="cuda")
    pt = torch.zeros((2, 2), dtype=torch.int32, device="cuda")
    pos = torch.zeros((2,), dtype=torch.int32, device="cuda")
    return lambda: ia.int_paged_decode_attention(q, pool, pool, 0.1, 1.0,
                                                 pt, pos)


def _fused_refused(d, bk):
    def run():
        q = torch.zeros((2, 8, d), dtype=torch.int8, device="cuda")
        return ia.int_attention_fused(q, q, q, 0.1, 1.0, bq=8, bk=bk)
    return lambda g: run


@pytest.mark.parametrize("make", [_paged_refused, _fused_refused(16, 8192),
                                  _fused_refused(8200, 8)])
def test_kernels_refuse_what_they_cannot_take(gen, make):
    before = dict(ia.LAUNCHES)
    with pytest.raises(ValueError, match="D="):
        make(gen)()
    assert ia.LAUNCHES == before


def test_vit_on_the_card_runs_every_kernel(gen):
    from repro_torch.configs.deit_s import SMOKE
    from repro_torch.core.api import QuantConfig, integerize_params
    from repro_torch.models import vit
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, mode="int",
                     pack_weights=True, backend="cuda")
    cfg = SMOKE.replace(quant=qc)
    params = integerize_params(vit.init_params(cfg, seed=0, device="cuda"),
                               qc)
    imgs = torch.randn((4, 32, 32, 3), generator=gen, device="cuda")
    dispatch.reset_stats()
    dispatch.reset_launches()
    got = vit.forward(params, imgs, cfg)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    assert launches["qmatmul"] == 1 + 6 * cfg.n_layers
    assert launches["int_attention_fused"] == cfg.n_layers
    assert dispatch.STATS["qlinear_torch"] == 0
    assert dispatch.STATS["attention_torch"] == 0
    want = vit.forward(params, imgs, cfg.replace(
        quant=qc.replace(backend="torch")))
    assert _rel(got, want) <= 5e-2        # the model gate of chip_smoke.py


# The paper's 2-, 3- and 4-bit prob grids (Table II's models, and 4) on
# the fused, ring and paged kernels: codes exact against the plain versions.
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_fused_kernel_low_bit_grids_codes_exact(gen, bits):
    h, g, d, sq, sk = 6, 5, 128, 64, 90
    for window in (None, 24):
        bq, bk = dispatch.attention_blocks(g * sq, sk, d, window=window)
        nq = -(-(g * sq) // bq)
        mk = lambda *shape: torch.randint(-127, 128, shape, generator=gen,
                                          device="cuda", dtype=torch.int8)
        q, k, v = mk(h, g * sq, d), mk(h, sk, d), mk(h, sk, d)
        sc = (torch.rand((h, nq), generator=gen, device="cuda") + 0.5) * 1e-4
        vs = torch.rand((h,), generator=gen, device="cuda") + 0.5
        kw = dict(attn_bits=bits, causal=True, window=window, bq=bq, bk=bk,
                  sq_mod=sq, return_codes=True)
        out, codes = ia.int_attention_fused(q, k, v, sc, vs, **kw)
        torch.cuda.synchronize()
        want, wcodes = ia.int_attention_fused_plain(q, k, v, sc, vs, **kw)
        assert torch.equal(codes, wcodes)
        assert _rel(out, want) <= 1e-5    # Sigma: f32 sum in another order


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_ring_kernel_low_bit_grids_codes_exact(gen, bits, kv_bits):
    for span, pos, window in ((1024, 100, None), (8192, 20000, 3000)):
        args = _ring_case(gen, 32, 5, 128, kv_bits, span, pos)
        _ring_exact(args, attn_bits=bits, window=window,
                    bk=dispatch.decode_blocks(span, 128),
                    packed=kv_bits == 4)


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("kv_bits,maxp", [(8, 6), (4, 6), (8, 40)])
def test_paged_kernel_low_bit_grids_codes_exact(gen, bits, kv_bits, maxp):
    q, kp, vp, sc, vs, pt, pos, kps, vps = _paged_case(gen, kv_bits, 5, 128,
                                                       16, maxp)
    out, codes = ia.int_paged_decode_attention(
        q, kp, vp, sc, vs, pt, pos, k_page_scale=kps, v_page_scale=vps,
        attn_bits=bits, packed=kv_bits == 4, return_codes=True)
    torch.cuda.synchronize()
    want, wcodes = ref.int_paged_decode_attention_ref(
        q, kp, vp, sc, vs, pt, pos, attn_bits=bits, bk=16, k_page_scale=kps,
        v_page_scale=vps, return_codes=True)
    assert torch.equal(codes, wcodes.to(torch.uint8))
    assert _rel(out, want) <= 1e-5
    assert out[2].abs().max().item() == 0


def test_fault_drill_on_the_card(gen):
    """The SMOKE model on the card through ``chip_smoke.py``'s fault script
    (six staggered requests on 4 rows over a pool that holds four) with a
    page steal that forces a victim, a NaN row and one forced fallback
    step: every request DONE, the audit clean after every step, and every
    request the forced step did not touch (the steal victim and the
    quarantined request among them) bitwise equal to the fault-free run."""
    from chip_smoke import fault_script
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig, integerize_params
    from repro_torch.models import lm
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int")
    cfg = smoke_config("qwen2.5-32b").replace(quant=qc)
    params = integerize_params(lm.init_params(cfg, seed=0, device="cuda"), qc)
    forced = 24                       # late: only request 5 still runs
    with dispatch.use_backend("cuda"):
        _, base = fault_script(cfg, params)
        dispatch.reset_stats()
        dispatch.reset_launches()
        eng, reqs = fault_script(cfg, params, FaultPlan(at=[
            FaultEvent(step=3, steal_pages=3, steal_hold=3),
            FaultEvent(step=9, nan_row=1),
            FaultEvent(step=forced, force_xla=True)]))
    torch.cuda.synchronize()
    assert all(r.status == "done" for r in reqs)
    assert eng.violations == [] and eng.audit() == []
    assert eng.preempt_count >= 2 and eng.resume_count >= 2
    assert dispatch.STATS["quarantined"] == 1
    assert dispatch.STATS["forced_xla_steps"] == 1
    assert dispatch.STATS["attention_paged_torch"] == cfg.n_layers
    assert dispatch.launch_counts()["int_paged_decode_attention"] > 0
    untouched = [r.rid for r in reqs
                 if not r.admitted_step <= forced < r.finished_step]
    assert {r.rid for r in reqs if r.preemptions} <= set(untouched)
    for i in untouched:
        assert reqs[i].tokens == base[i].tokens, i
    eng.shutdown()
    while eng._reclaim_one():
        pass
    assert eng._fault_held == [] and eng.alloc.free_count == eng.num_pages


# The expert product through qmatmul, one launch an expert: Llama-4's
# prefill and decode capacities at reduced widths, and a buffer whose
# expert slices are not 16-byte aligned (K 40, padded by the wrapper).
@pytest.mark.parametrize("e,cap,din,dout", [(16, 20, 512, 1024),
                                            (16, 1, 1024, 512),
                                            (3, 7, 40, 24)])
def test_expert_product_kernel_route_equals_plain(gen, e, cap, din, dout):
    from repro_torch.core.api import QuantConfig
    from repro_torch.layers.moe import dense_expert
    p = {"w_q": torch.randint(-8, 8, (e, din, dout), generator=gen,
                              device="cuda", dtype=torch.int8),
         "w_scale": torch.rand((e, 1, dout), generator=gen, device="cuda")}
    x = torch.randn((e, cap, din), generator=gen, device="cuda").to(
        torch.bfloat16)
    qc = QuantConfig(w_bits=4, mode="int", backend="cuda")
    dispatch.reset_stats()
    before = qm.LAUNCHES["qmatmul"]
    got = dense_expert(x, p, qc)
    torch.cuda.synchronize()
    assert qm.LAUNCHES["qmatmul"] == before + e
    assert dispatch.STATS["qexpert_cuda"] == 1
    assert torch.equal(got, dense_expert(x, p, qc.replace(backend="torch")))


# The head groups of the dense GQA and MoE families: Phi-3-medium and
# Phi-3.5-MoE (G 4), InternVL2-26B (G 6), Yi-34B (G 7), ChatGLM3-6B (G 16)
@pytest.mark.parametrize("g", [4, 6, 7, 16])
def test_paged_decode_kernel_head_groups(gen, g):
    q, kp, vp, sc, vs, pt, pos, kps, vps = _paged_case(gen, 8, g, 128, 16, 6)
    out, codes = ia.int_paged_decode_attention(
        q, kp, vp, sc, vs, pt, pos, k_page_scale=kps, v_page_scale=vps,
        return_codes=True)
    torch.cuda.synchronize()
    want, wcodes = ref.int_paged_decode_attention_ref(
        q, kp, vp, sc, vs, pt, pos, bk=16, k_page_scale=kps,
        v_page_scale=vps, return_codes=True)
    assert torch.equal(codes, wcodes.to(torch.uint8))
    assert _rel(out, want) <= 1e-5


@pytest.mark.parametrize("g", [4, 6, 7, 16])
def test_fused_kernel_head_groups(gen, g):
    h, sq, d = 8, 64, 128
    bq, bk = dispatch.attention_blocks(g * sq, sq, d, chunk=sq)
    mk = lambda *shape: torch.randint(-127, 128, shape, generator=gen,
                                      device="cuda", dtype=torch.int8)
    q, k, v = mk(h, g * sq, d), mk(h, sq, d), mk(h, sq, d)
    sc = (torch.rand((h, -(-(g * sq) // bq)), generator=gen,
                     device="cuda") + 0.5) * 1e-4
    vs = torch.rand((h,), generator=gen, device="cuda") + 0.5
    kw = dict(attn_bits=7, causal=True, bq=bq, bk=bk, sq_mod=sq,
              return_codes=True)
    out, codes = ia.int_attention_fused(q, k, v, sc, vs, **kw)
    torch.cuda.synchronize()
    want, wcodes = ia.int_attention_fused_plain(q, k, v, sc, vs, **kw)
    assert torch.equal(codes, wcodes)
    assert _rel(out, want) <= 1e-5


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_serve_on_the_card_takes_no_plain_path(gen, arch):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig, integerize_params
    from repro_torch.launch.serve import serve, staggered_prompts
    from repro_torch.models import lm
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int",
                     backend="cuda")
    cfg = smoke_config(arch).replace(quant=qc)
    params = integerize_params(lm.init_params(cfg, seed=0, device="cuda"), qc)
    dispatch.reset_stats()
    dispatch.reset_launches()
    _, stats = serve(cfg, params, staggered_prompts(4, 24, cfg.vocab),
                     gen_tokens=6, page_size=8, batch_size=4, audit_every=1)
    assert [s["status"] for s in stats["per_seq"]] == ["done"] * 4
    assert stats["audit_violations"] == []
    launches = dispatch.launch_counts()
    for name in ("qmatmul", "int_attention_fused",
                 "int_paged_decode_attention"):
        assert launches[name] > 0, launches
    snap = stats["dispatch"]
    assert snap["qexpert_cuda"] > 0
    for key in ("qlinear_torch", "qexpert_torch", "attention_torch",
                "attention_paged_torch"):
        assert snap[key] == 0, (key, snap)


# The recurrent and encoder-decoder families' new shapes (chip_smoke.py's
# QMM_FAMILIES, ATTN_FAMILIES, RING_FAMILIES): RecurrentGemma-9B's lm_head
# (N 256000, K 4096), Whisper-large-v3's (N 51866, K 1280), Mamba2-130M's
# in_proj (N 3352, K 768)
@pytest.mark.parametrize("m,n,k", [(2, 256000, 4096), (256, 256000, 4096),
                                   (4, 51866, 1280), (256, 51866, 1280),
                                   (4, 3352, 768), (2048, 3352, 768)])
def test_qmatmul_family_shapes_equal_plain(gen, m, n, k):
    x, w, s, b, rs = _qmm_inputs(gen, m, n, k, False)
    blocks = dispatch.qmatmul_blocks(m, n, k)
    got = qm.qmatmul(x, w, s, b, rs, blocks=blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.qmatmul_ref(x, w, s, b, rs))


# (H, G * Sq, Sk, D, causal, window, sq_mod, chunk): RecurrentGemma-9B's
# local prefill (D 256, window 2048 under 2304 keys), Whisper's encoder,
# cross attention at prefill, and a decode step's one query row over 1500
# pre-quantized keys
FUSED_FAMILY_CASES = [(2, 16 * 2304, 2304, 256, True, 2048, 2304, 128),
                      (8, 1500, 1500, 64, False, None, None, 125),
                      (8, 32, 1500, 64, False, None, None, 32),
                      (8, 1, 1500, 64, False, None, None, None)]


@pytest.mark.parametrize("h,sq,sk,d,causal,window,sq_mod,chunk",
                         FUSED_FAMILY_CASES)
def test_fused_kernel_family_shapes_codes_exact(gen, h, sq, sk, d, causal,
                                                window, sq_mod, chunk):
    bq, bk = dispatch.attention_blocks(sq, sk, d, window=window, chunk=chunk)
    nq = -(-sq // bq)
    mk = lambda *shape: torch.randint(-127, 128, shape, generator=gen,
                                      device="cuda", dtype=torch.int8)
    q, k, v = mk(h, sq, d), mk(h, sk, d), mk(h, sk, d)
    sc = (torch.rand((h, nq), generator=gen, device="cuda") + 0.5) * 1e-4
    vs = torch.rand((h,), generator=gen, device="cuda") + 0.5
    kw = dict(attn_bits=7, causal=causal, window=window, bq=bq, bk=bk,
              sq_mod=sq_mod, return_codes=True)
    out, codes = ia.int_attention_fused(q, k, v, sc, vs, **kw)
    torch.cuda.synchronize()
    want, wcodes = ia.int_attention_fused_plain(q, k, v, sc, vs, **kw)
    assert torch.equal(codes, wcodes)
    assert _rel(out, want) <= 1e-5


# (head-folds, G, D, span, pos, window): RecurrentGemma-9B's local ring of
# 2176 slots over its 2048 window, Whisper's self-attention ring of 64
@pytest.mark.parametrize("h,g,d,span,pos,window",
                         [(2, 16, 256, 2176, 2319, 2048),
                          (2, 16, 256, 2176, 2304, 2048),
                          (80, 1, 64, 64, 47, None)])
def test_ring_kernel_family_shapes_codes_exact(gen, h, g, d, span, pos,
                                               window):
    args = _ring_case(gen, h, g, d, 8, span, pos)
    _ring_exact(args, attn_bits=7, window=window,
                bk=dispatch.decode_blocks(span, d))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m",
                                  "whisper-large-v3"])
def test_family_smoke_on_the_card_takes_no_plain_path(gen, arch):
    from repro_torch.configs.registry import is_encdec, smoke_config
    from repro_torch.core.api import QuantConfig, integerize_params
    from repro_torch.models import encdec, lm
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int",
                     backend="cuda")
    cfg = smoke_config(arch).replace(quant=qc)
    model = encdec if is_encdec(cfg) else lm
    params = integerize_params(model.init_params(cfg, seed=0, device="cuda"),
                               qc)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 24), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    if model is encdec:
        batch["frames"] = torch.randn((2, cfg.n_audio_ctx, cfg.d_model),
                                      generator=gen, device="cuda")
    dispatch.reset_stats()
    dispatch.reset_launches()
    logits, cache = model.prefill(params, batch, cfg, max_len=32)
    for _ in range(4):
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)[:, None]
        logits, cache = model.decode_step(params, tok, cache, cfg)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    assert launches["qmatmul"] > 0, launches
    if arch != "mamba2-130m":
        assert launches["int_attention_fused"] > 0, launches
        assert launches["int_decode_attention"] > 0, launches
    for key in ("qlinear_torch", "attention_torch", "attention_decode_torch"):
        assert dispatch.STATS[key] == 0, (key, dispatch.snapshot())
    assert int(cache["pos"]) == 28 and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_recurrent_serve_on_the_card_both_backends(gen, arch):
    """The two SMOKE models through the paged engine (4 requests of up to
    40 tokens past RecurrentGemma's 16-token window, on 2 rows, pages of
    8): every request DONE with a clean audit on each backend; the cuda
    run launches every kernel of its path and dispatches nothing to the
    plain path, the torch run launches nothing; the first step (prefill,
    then one decode step from the cuda run's tokens) within 5e-2."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig, integerize_params
    from repro_torch.launch.serve import serve, staggered_prompts
    from repro_torch.models import lm
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int",
                     backend="cuda")
    cfgs = {b: smoke_config(arch).replace(quant=qc.replace(backend=b))
            for b in ("cuda", "torch")}
    params = integerize_params(lm.init_params(cfgs["cuda"], seed=0,
                                              device="cuda"), qc)
    ran = ("qmatmul",) if arch == "mamba2-130m" else \
        ("qmatmul", "int_attention_fused", "int_paged_decode_attention")
    prompts = staggered_prompts(4, 40, cfgs["cuda"].vocab)
    for backend, cfg in cfgs.items():
        dispatch.reset_stats()
        dispatch.reset_launches()
        _, stats = serve(cfg, params, prompts, gen_tokens=6, page_size=8,
                         batch_size=2, audit_every=1)
        torch.cuda.synchronize()
        assert [s["status"] for s in stats["per_seq"]] == ["done"] * 4
        assert stats["audit_violations"] == []
        launches, snap = dispatch.launch_counts(), stats["dispatch"]
        other = "torch" if backend == "cuda" else "cuda"
        for key in ("qlinear", "attention", "attention_paged"):
            assert snap[f"{key}_{other}"] == 0, (backend, key, snap)
        if backend == "cuda":
            for name in ran:
                assert launches[name] > 0, launches
        else:
            assert sum(launches.values()) == 0, launches
    lens = [len(p) for p in prompts]
    toks = torch.zeros((4, max(lens)), dtype=torch.int32, device="cuda")
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p, device="cuda")
    batch = {"tokens": toks, "lengths": torch.tensor(lens, dtype=torch.int32,
                                                     device="cuda")}
    out, nxt = {}, None
    for backend, cfg in cfgs.items():
        cache = lm.init_paged_cache(cfg, 4, 48, page_size=8, device="cuda")
        cache["page_table"].copy_(torch.arange(
            24, dtype=torch.int32, device="cuda").reshape(4, 6))
        lg, cache = lm.paged_prefill(params, batch, cfg, cache)
        if nxt is None:
            nxt = torch.argmax(lg[:, 0], -1).to(torch.int32)[:, None]
        lg2, _ = lm.decode_step(params, nxt, cache, cfg)
        out[backend] = (lg.float(), lg2.float())
    for i in range(2):
        assert _rel(out["cuda"][i], out["torch"][i]) <= 5e-2, i


# ---------------------------------------------------------------------------
# QAT training on the card (the fake graph is plain PyTorch; the int
# forward after it runs the kernels)
# ---------------------------------------------------------------------------

def _train_smoke_cfg():
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig
    return smoke_config("qwen2.5-32b").replace(quant=QuantConfig(
        w_bits=4, a_bits=8, attn_bits=7, mode="fake"))


def test_smoke_train_step_card_against_cpu(gen):
    """One SMOKE step on the card and on the CPU, same params and batch:
    the loss within 1e-3 (a fake-quant code at a rounding edge flips
    between the devices; 2.2e-5 seen on the H100).  With the CPU's
    fake-quant values replayed on the card, every code the card computes
    itself is its op's own on its x / delta and any that differs from the
    CPU's sits at a rounding edge (or in a prob row whose floor-max shift
    moved: ``chip_smoke.code_flips``); the loss within 1e-5 and the
    gradients' global norm within 1e-4 (f32 sums in other orders alone),
    each gradient within 1e-3 of its leaf's max: the backward's LSQ term
    still takes the card's own codes, which differ where a code flipped,
    and sums that onto the step's absmax element (1.1e-4 seen on the
    H100).  The params after the update are not compared leaf by leaf:
    Adam's first step divides g by |g| + 1e-6, so a gradient element near
    1e-6 magnifies the sum order's gap (4.4e-3 seen on a zero-initialized
    bias)."""
    from chip_smoke import FakeQuantTap, code_flips
    from repro_torch import tree as tree_lib
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = _train_smoke_cfg()
    start = lm.init_params(cfg, seed=0, device="cpu")
    batch = lm_batch(DataConfig(vocab=cfg.vocab, seq_len=32,
                                global_batch=4), 0)
    batch_card = {k: v.cuda() for k, v in batch.items()}
    step = make_train_step(cfg, OptConfig(lr=3e-3, warmup_steps=1,
                                          total_steps=10))
    cpu = tree_lib.tree_map(torch.clone, start)
    _, _, mc = step(cpu, init_opt_state(cpu), batch)
    card = tree_lib.tree_map(lambda t: t.to("cuda"), start)
    _, _, mg = step(card, init_opt_state(card), batch_card)
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        1e-3 * abs(float(mc["loss"]))

    def grads(params, batch, replay=None):
        named = tree_lib.leaves_with_paths(params)
        for _, leaf in named:
            leaf.requires_grad_(True)
        with FakeQuantTap(replay) as tap:
            loss, _ = lm.lm_loss(params, batch, cfg)
            got = torch.autograd.grad(loss, [leaf for _, leaf in named])
        return loss.detach(), tap.calls, dict(zip((p for p, _ in named), got))

    lc, calls, gc = grads(tree_lib.tree_map(torch.clone, start), batch)
    lg, card_calls, gg = grads(tree_lib.tree_map(lambda t: t.to("cuda"),
                                                 start),
                               batch_card, replay=calls)
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    # the card's own codes on the replayed stream: each the op's own on its
    # x / delta, and any that differs from the CPU's at a rounding edge or
    # in a prob row whose floor-max shift moved
    total, primary, shifted = code_flips(calls, card_calls)
    assert total == primary + shifted

    def norm(gs):
        return float(sum(torch.sum(g.double().cpu() ** 2)
                         for g in gs.values()) ** 0.5)

    assert abs(norm(gg) - norm(gc)) <= 1e-4 * norm(gc)
    for path, g in gc.items():
        assert _rel(gg[path].cpu(), g) <= 1e-3, path


def test_train_restart_bitwise_on_the_card(gen, tmp_path):
    from repro_torch import tree as tree_lib
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.optim import OptConfig
    cfg = _train_smoke_cfg()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    ocfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)

    def run(steps, d):
        return train(cfg, TrainConfig(steps=steps, ckpt_every=10,
                                      ckpt_dir=str(tmp_path / d)),
                     ocfg, dcfg, verbose=False, device="cuda")

    full = run(30, "a")[0]
    run(20, "b")
    resumed = run(30, "b")[0]
    for (path, a), (_, b) in zip(tree_lib.leaves_with_paths(full),
                                 tree_lib.leaves_with_paths(resumed)):
        assert a.is_cuda and torch.equal(a, b), path


def test_smoke_deit_recipe_int_forward_on_the_kernels(gen):
    """The recipe on DeiT SMOKE (head-only steps, then full QAT steps),
    integerized: its int forward launches qmatmul for every linear and the
    fused kernel for every layer, with no plain dispatch."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.api import QuantConfig, integerize_params
    from repro_torch.data.synthetic import image_batch
    from repro_torch.examples.train_cifar_qat import make_vit_step
    from repro_torch.models import vit
    from repro_torch.optim import OptConfig, init_opt_state
    qc = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, mode="fake")
    cfg = smoke_config("deit-s").replace(quant=qc)
    ocfg = OptConfig(kind="lamb", lr=5e-4, warmup_steps=2, total_steps=6)
    params = vit.init_params(cfg, seed=0, device="cuda")
    opt = init_opt_state(params)
    for i in range(6):
        step = make_vit_step(cfg, ocfg, head_only=i < 2)
        batch = image_batch(i, batch=16, img=cfg.img_size, device="cuda")
        params, opt, m = step(params, opt, batch)
        assert bool(torch.isfinite(m["loss"]))
    qi = qc.replace(mode="int", backend="cuda")
    iparams = integerize_params(params, qi)
    imgs = image_batch(99, batch=16, img=cfg.img_size, device="cuda")
    dispatch.reset_stats()
    dispatch.reset_launches()
    with torch.no_grad():
        logits = vit.forward(iparams, imgs["images"], cfg.replace(quant=qi))
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    assert launches["qmatmul"] == 1 + 6 * cfg.n_layers, launches
    assert launches["int_attention_fused"] == cfg.n_layers, launches
    for key in ("qlinear_torch", "attention_torch"):
        assert dispatch.STATS[key] == 0, (key, dispatch.snapshot())
    assert bool(torch.isfinite(logits).all())


def _one_rank(tmp_path, backend):
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)


def test_gloo_mesh_refuses_cuda_tensors(gen, tmp_path):
    """No copy through the host: a gloo mesh handed the card's tensors
    raises rather than moving them."""
    import torch.distributed as dist
    from repro_torch.core.api import QuantConfig, dense
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.launch.mesh import make_test_mesh
    _one_rank(tmp_path, "gloo")
    try:
        mesh = make_test_mesh((1, 1), device_type="cpu")
        x = torch.randn((4, 64), generator=gen, device="cuda")
        with pytest.raises(ValueError, match="through the host"):
            col.gather0(x, col.group(mesh, "model"))
        p = {"w_q": torch.zeros((32, 64), dtype=torch.int8, device="cuda"),
             "w_scale": torch.ones((32,), device="cuda")}
        with use_rules(Rules(batch=("data",), mesh=mesh,
                             int_bf16_reduce=True)):
            with pytest.raises(ValueError, match="through the host"):
                dense(x, p, QuantConfig(mode="int"), tp="row")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("packed", [False, True])
def test_row_parallel_one_rank_nccl_equals_per_tensor_dense(gen, tmp_path,
                                                            packed):
    """One NCCL rank: the shard body runs qmatmul (one launch, counted as
    ``qlinear_row_cuda``) and equals the per-tensor integer product
    rounded to bf16, bias after, bit for bit; the torch backend too."""
    import torch.distributed as dist
    from repro_torch.core import integerize, quant
    from repro_torch.core.api import QuantConfig, as_qlinear, dense
    from repro_torch.distributed.sharding import Rules, use_rules
    from repro_torch.launch.mesh import make_test_mesh
    _one_rank(tmp_path, "nccl")
    try:
        mesh = make_test_mesh((1, 1))
        w = torch.randint(-8, 8, (512, 1024), generator=gen, device="cuda",
                          dtype=torch.int8)
        p = {"w_q": pack_int4(w) if packed else w,
             "w_scale": torch.rand((512,), generator=gen, device="cuda"),
             "b": torch.randn((512,), generator=gen,
                              device="cuda").to(torch.bfloat16)}
        x = torch.randn((4, 33, 1024), generator=gen, device="cuda").to(
            torch.bfloat16)
        qc = QuantConfig(w_bits=4, mode="int")
        xq = quant.quantize_tensor(x, qc.a_bits)
        want = integerize.int_linear(xq, as_qlinear(
            {"w_q": w, "w_scale": p["w_scale"]}, qc)).to(torch.bfloat16)
        want = want + p["b"]
        rules = Rules(batch=("data",), mesh=mesh, int_bf16_reduce=True)
        dispatch.reset_stats()
        before = qm.LAUNCHES["qmatmul"]
        with use_rules(rules):
            got = dense(x, p, qc, tp="row")
            plain = dense(x, p, qc.replace(backend="torch"), tp="row")
        torch.cuda.synchronize()
        assert qm.LAUNCHES["qmatmul"] == before + 1
        assert dispatch.STATS["qlinear_row_cuda"] == 1
        assert dispatch.STATS["qlinear_row_torch"] == 1
        assert torch.equal(got, want) and torch.equal(plain, want)
    finally:
        dist.destroy_process_group()
