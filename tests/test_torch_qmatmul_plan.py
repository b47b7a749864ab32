"""qmatmul's plan and its two bodies' arithmetic, as algorithms, held
against the reference.

``kernels/qmatmul.py::plan`` picks the CUDA kernel's body, output tile and
split count from the shape; the tests below hold it, at every shape the
main paths give it and at ragged ones, to what the kernel takes: the
stream body for every M <= 16 rows (8 or 16 x rows, 16 or 32 rows of W a
block, one launch), the ``mma`` body's tiles, splits of at least
``MIN_SPLIT_K`` bytes of K each (no more splits than the kernel's slabs,
which the launcher refuses), and at least one block per SM wherever K is
split.  The bodies' fit in shared memory is asserted where their layouts
are written, at compile time (``MmaLayout``, ``StreamLayout`` in
``csrc/qmatmul.cu``).

:func:`split_k` does the ``mma`` body's arithmetic in plain PyTorch (the
wrapper's K padding, the nibble unpacking written as the kernel's bit
operations, K cut into contiguous ranges, the int32 partial sums added in
split order, the epilogue rounded op by op).  :func:`stream` does the
stream body's lane by lane: each lane's 16-byte loads of W and x, the
words they give each ``mma.sync.m16n8k32`` fragment register, the product
as the PTX ISA lays the fragments out (:func:`mma_m16n8k32`), the warps'
K ranges and their partials added in warp order through the kernel's
shared-memory layout.  So the designs are checked here where the kernel
cannot run: bit for bit against ``ref.qmatmul_ref`` (the kernel's plain
version) and against JAX's Pallas kernel (interpret mode) without a bias;
with a bias to 1e-6 of the output's max, as XLA on the CPU contracts
``acc * s + b`` into one FMA.  On the card the kernel is held against the
same plain version (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import dispatch as jdispatch
from repro.kernels.qmatmul import qmatmul as j_qmatmul
from repro_torch.core.quant import int_matmul_exact, pack_int4, unpack_int4
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import qmatmul as qm

torch.set_num_threads(1)

@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def cdiv(a, b):
    return -(-a // b)


# Qwen2.5-32B's linears (wq, wk/wv, MLP up, MLP down, lm_head), at the
# serve and ring phases' decode (4 rows) and prefill rows (a batch of 4
# 64-token prompts: 256); DeiT-S's at batch 64 (patch embedding over 196
# patches, then wq/wk/wv/wo, MLP up and down over 198 tokens).
QWEN_NK = [(5120, 5120), (1024, 5120), (27648, 5120), (5120, 27648),
           (152064, 5120)]
DEIT = [(12544, 384, 768), (12672, 384, 384), (12672, 1536, 384),
        (12672, 384, 1536)]
MAIN = [(m, n, k) for m in (4, 256) for n, k in QWEN_NK] + DEIT
RAGGED = [(1, 300, 1028), (16, 1000, 512), (17, 300, 1028),
          (129, 300, 1028), (17, 1000, 512), (129, 1000, 512),
          (64, 5120, 5120), (65, 5120, 5120), (200, 1001, 8320),
          (300, 7, 100000), (12672, 1, 8)]


@pytest.mark.parametrize("m,n,k", MAIN + RAGGED)
def test_plan_fits_the_kernel(m, n, k):
    body, bm, bn, splits = choice = qm.plan(m, n, k)
    assert dispatch.qmatmul_blocks(m, n, k) == choice
    assert dispatch.STATS["blocks"][f"qmatmul:m{m}_n{n}_k{k}"] == \
        list(choice)
    if m <= 16:
        # x rows as the n8 tiles take them; 32 rows of W a block where
        # that leaves no SM without a block, else 16 (the most blocks)
        assert body == "stream" and splits == 1
        assert bm == (8 if m <= 8 else 16)
        assert bn == (32 if cdiv(n, 32) >= qm.SMS else 16)
        return
    assert body == "mma" and (bm, bn) in ((128, 128), (64, 128))
    assert m > 64 or bm == 64            # no 128-row tile over <= 64 rows
    blocks = cdiv(m, bm) * cdiv(n, bn)
    if splits > 1:
        assert blocks < qm.SMS <= blocks * splits
        assert k >= splits * qm.MIN_SPLIT_K
        assert blocks * (splits - 1) < qm.SMS     # the fewest splits
    elif blocks < qm.SMS:                # K too short to split: most blocks
        assert bm == 64 and k < cdiv(qm.SMS, blocks) * qm.MIN_SPLIT_K


def test_plan_main_path_choices():
    """The plans the main paths run: decode on the stream body, one n8
    tile of x rows (two at 16 rows), 32 rows of W a block (160 to 4752
    blocks), but 16 at N 1024 (64 blocks, where 32 would leave 100 SMs
    idle); prefill and DeiT-S on
    128 x 128 tensor-core tiles, K split where 80 tiles leave SMs idle
    (the Qwen wq and MLP down at 256 rows), and 64 x 128 tiles with K split
    for the wk/wv shape (16 tiles of 128 rows, K too short for 9 splits
    of 1 KB)."""
    rows = {5120: 32, 1024: 16, 27648: 32, 152064: 32}
    for n, k in QWEN_NK:
        assert qm.plan(4, n, k) == ("stream", 8, rows[n], 1)
        assert qm.plan(16, n, k) == ("stream", 16, rows[n], 1)
    assert qm.plan(256, 27648, 5120) == ("mma", 128, 128, 1)
    assert qm.plan(256, 152064, 5120) == ("mma", 128, 128, 1)
    assert qm.plan(256, 5120, 5120) == ("mma", 128, 128, 2)
    assert qm.plan(256, 5120, 27648) == ("mma", 128, 128, 2)
    assert qm.plan(256, 1024, 5120) == ("mma", 64, 128, 5)
    for shape in DEIT:
        assert qm.plan(*shape) == ("mma", 128, 128, 1)


def byte_perm(x, y, sel):
    """CUDA's ``__byte_perm``: byte i of the result is byte (sel >> 4i) & 7
    of the eight bytes y:x (x the low four)."""
    both = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        byte = (both >> np.uint64(8 * b)) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * i)
    return out


def unpack8(p):
    """``unpack8`` of ``csrc/qmatmul.cu`` on uint32 words of four packed
    bytes: two words of four sign-extended codes each, in k order."""
    lo = p & np.uint32(0x0F0F0F0F)
    hi = (p >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    w0, w1 = byte_perm(lo, hi, 0x5140), byte_perm(lo, hi, 0x7362)
    ext = lambda w: w | (((w >> np.uint32(3)) & np.uint32(0x01010101)) *
                         np.uint32(0xF0))
    return ext(w0), ext(w1)


def unpack_as_kernel(w_packed: torch.Tensor) -> torch.Tensor:
    """(N, K/2) nibbles -> (N, K) int8 through :func:`unpack8` (K/2 % 4 ==
    0, as the wrapper pads packed K to a multiple of 32)."""
    n, kb = w_packed.shape
    words = np.ascontiguousarray(w_packed.numpy()).view("<u4")
    w0, w1 = unpack8(words)
    out = np.stack([w0, w1], axis=-1).reshape(n, kb // 4 * 2)
    return torch.from_numpy(np.ascontiguousarray(out).view(np.int8)
                            .reshape(n, 2 * kb).copy())


def test_unpack8_equals_unpack_int4_on_every_byte():
    """Every byte value in every position of a word, and random words."""
    rng = np.random.RandomState(0)
    b = np.arange(256, dtype=np.uint32)
    words = np.concatenate([b * np.uint32(0x01010101), b, b << np.uint32(8),
                            b << np.uint32(16), b << np.uint32(24),
                            rng.randint(0, 2 ** 32, 4096, dtype=np.uint64)
                            .astype(np.uint32)])
    packed = torch.from_numpy(words.view(np.uint8).reshape(-1, 4).copy())
    assert torch.equal(unpack_as_kernel(packed), unpack_int4(packed))


def split_k(x, w, scale, bias, row_scale, splits, packed):
    """The ``mma`` body's arithmetic in plain PyTorch (``csrc/qmatmul.cu``:
    ``qmatmul_mma_kernel`` writing int32 partials, then
    ``qmatmul_splitk_kernel``).  K is cut as evenly as whole 16-byte
    copies allow; int32 sums are exact, so any contiguous cut, the
    kernel's whole slabs included, gives these bits."""
    m, k = x.shape
    unit = 32 if packed else 16                   # the wrapper's K padding
    ku = cdiv(k, unit) * unit
    x = torch.nn.functional.pad(x, (0, ku - k))
    w = torch.nn.functional.pad(w, (0, (ku - k) // 2 if packed else ku - k))
    if packed:
        w = unpack_as_kernel(w)
    units = ku // 16
    acc = torch.zeros((m, w.shape[0]), dtype=torch.int32)
    for z in range(splits):                       # partials in split order
        lo, hi = 16 * (z * units // splits), 16 * ((z + 1) * units // splits)
        acc = acc + int_matmul_exact(x[:, lo:hi], w[:, lo:hi].T)
    return epilogue(acc, scale, bias, row_scale)


def epilogue(acc, scale, bias, row_scale):
    """The kernel's f32 epilogue on int32 sums, rounded op by op."""
    s = scale[None, :]
    if row_scale is not None:
        s = s * row_scale[:, None]
    out = acc.to(torch.float32) * s
    return out if bias is None else out + bias[None, :]


LANE = np.arange(32)
G, T = LANE // 4, LANE % 4            # a lane's group and thread in group
SK = 64                               # bytes of a W row a chunk
WARPS = 8


def fragments(a, b):
    """The A (16 x 32) and B (32 x 8) bytes that a warp's fragment words
    of ``mma.sync.m16n8k32`` s8 hold, as the PTX ISA lays them out: lane
    (g, t) holds A[g, 4t:4t+4] in a0, A[g+8, 4t:4t+4] in a1,
    A[g, 16+4t:20+4t] in a2, A[g+8, 16+4t:20+4t] in a3, B[4t:4t+4, g] in b0
    and B[16+4t:20+4t, g] in b1, the lowest byte of a word first.  ``a``:
    four (32,) uint32 words, ``b``: two."""
    by = lambda word: np.ascontiguousarray(word, dtype="<u4") \
        .view(np.uint8).reshape(32, 4)
    A, B = np.zeros((16, 32), np.uint8), np.zeros((32, 8), np.uint8)
    for q in range(4):
        A[G, 4 * T + q] = by(a[0])[:, q]
        A[G + 8, 4 * T + q] = by(a[1])[:, q]
        A[G, 16 + 4 * T + q] = by(a[2])[:, q]
        A[G + 8, 16 + 4 * T + q] = by(a[3])[:, q]
        B[4 * T + q, G] = by(b[0])[:, q]
        B[16 + 4 * T + q, G] = by(b[1])[:, q]
    return A, B


def mma_m16n8k32(d, a, b):
    """``mma.sync.m16n8k32.row.col.s32.s8.s8.s32``: D (16 x 8) += A B on
    :func:`fragments`; lane (g, t) holds D[g, 2t], D[g, 2t+1], D[g+8, 2t],
    D[g+8, 2t+1] in d0..d3.  ``d``: (32, 4) int32, added to."""
    A, B = fragments(a, b)
    D = (A.view(np.int8).astype(np.int64) @
         B.view(np.int8).astype(np.int64)).astype(np.int32)
    d += np.stack([D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T],
                   D[G + 8, 2 * T + 1]], axis=1)


def load16(mem, rows, offs, ok, nbytes=16):
    """Each lane's ``nbytes`` of ``mem`` (rows, bytes) from its row and byte
    offset, as uint32 words; zeros where ``ok`` is false (nothing read)."""
    out = np.zeros((32, nbytes), np.uint8)
    for lane in np.flatnonzero(ok):
        out[lane] = mem[rows[lane], offs[lane]:offs[lane] + nbytes]
    return out.view("<u4")


def w_words(words, packed):
    """A lane's W words in k order: as loaded, or eight words of codes
    unpacked from four words of nibbles by :func:`unpack8`."""
    if not packed:
        return words
    lo, hi = unpack8(words)
    return np.stack([lo, hi], axis=-1).reshape(32, -1)


def stream(x, w, scale, bias, row_scale, plan, packed):
    """The stream body's arithmetic lane by lane (``csrc/qmatmul.cu``:
    ``qmatmul_stream_kernel``).  A block streams ``bn`` rows of W (``bn //
    16`` groups of 16, the mma's wide side) against x^T (``bm // 8`` n8
    tiles); its eight warps take contiguous ranges of K's 64-byte chunks.
    Lane (g, t) loads 16 bytes of W rows g and g + 8 at byte 16t of a chunk
    (32 nibble codes when packed, unpacked in registers) and the same k of
    x row g; words 2s and 2s + 1 feed the fragments of the chunk's s-th
    mma.  The partials go to shared memory as the kernel lays them out
    (an x row of ``bn + 4`` words) and are added in warp order."""
    _, bm, bn, _ = plan
    m, k = x.shape
    n = w.shape[0]
    unit = 32 if packed else 16                   # the wrapper's K padding
    ku = cdiv(k, unit) * unit
    kb = ku // 2 if packed else ku                # bytes of a W row
    xm = np.zeros((m, ku), np.int8)
    xm[:, :k] = x.numpy()
    wm = np.zeros((n, kb), np.uint8)
    wm[:, :w.shape[1]] = w.numpy().view(np.uint8)
    xm = xm.view(np.uint8)
    xl = 2 if packed else 1                       # 16-byte x loads a chunk
    t8, groups, cs = bm // 8, bn // 16, bn + 4
    chunks = cdiv(kb, SK)
    acc = torch.zeros((m, n), dtype=torch.int32)
    for n0 in range(0, n, bn):
        red = np.zeros((WARPS, 8 * t8, cs), np.int32)
        for warp in range(WARPS):
            d = np.zeros((groups, t8, 32, 4), np.int32)
            for c in range(warp * chunks // WARPS,
                           (warp + 1) * chunks // WARPS):
                off = c * SK + 16 * T
                ok = off < kb
                xw = []
                for j in range(t8):
                    xrow = 8 * j + G
                    xw.append(load16(xm, np.minimum(xrow, m - 1), xl * off,
                                     ok & (xrow < m), 16 * xl))
                for i in range(groups):
                    wrow = [n0 + 16 * i + 8 * h + G for h in (0, 1)]
                    lo, hi = (w_words(load16(wm, np.minimum(r, n - 1), off,
                                             ok & (r < n)), packed)
                              for r in wrow)
                    for s in range(2 * xl):
                        a = (lo[:, 2 * s], hi[:, 2 * s], lo[:, 2 * s + 1],
                             hi[:, 2 * s + 1])
                        for j in range(t8):
                            mma_m16n8k32(d[i, j], a, (xw[j][:, 2 * s],
                                                      xw[j][:, 2 * s + 1]))
            for i in range(groups):
                for j in range(t8):
                    for h in (0, 1):
                        for e in (0, 1):
                            red[warp, 8 * j + 2 * T + e, 16 * i + 8 * h + G] \
                                = d[i, j, :, 2 * h + e]
        total = np.zeros((8 * t8, cs), np.int32)
        for warp in range(WARPS):                 # partials in warp order
            total += red[warp]
        cols = min(bn, n - n0)
        acc[:, n0:n0 + cols] = torch.from_numpy(total[:m, :cols].copy())
    return epilogue(acc, scale, bias, row_scale)


def test_stream_fragment_k_is_one_bijection_for_w_and_x():
    """Each mma of a chunk takes, at every logical k of its fragments, the
    same byte of the chunk for every row of W (A) and every row of x (B),
    and the chunk's mmas together take each byte once: int8, 64 bytes in
    two mmas; packed, 128 codes in four.  Each code a lane loads (16 bytes
    at 16t, or 32 codes at 32t) is written as its own k in the chunk, in
    the words :func:`stream` feeds the fragments (W rows g and g + 8 and x
    row g alike)."""
    for packed in (False, True):
        per = 32 if packed else 16                # codes a lane loads
        words = (per * T[:, None] + np.arange(per)).astype(np.uint8) \
            .view("<u4")
        seen = []
        for s in range(per // 8):
            lo, hi = words[:, 2 * s], words[:, 2 * s + 1]
            A, B = fragments((lo, lo, hi, hi), (lo, hi))
            assert (A == A[:1]).all() and (B == B[:, :1]).all()
            assert (A[0] == B[:, 0]).all()        # A's k is B's k
            seen.extend(A[0].tolist())
        assert sorted(seen) == list(range(4 * per))


# (m, n, k, bn): every x tile (m <= 8: one n8 tile, else two) at M 1, 4, 8,
# 9 and 16 against every block width; W rows off the block, K off the
# 64-byte chunk (1000: padded to 1008 or 1024; 4160 packed: 32.5 chunks),
# warps with no chunk (640 packed: five chunks; 16: one, three of four
# lanes zero-filled)
STREAM_CASES = [(1, 40, 1000, 16), (4, 150, 640, 32), (4, 20, 16, 16),
                (8, 72, 2080, 32), (9, 40, 1000, 32), (16, 72, 640, 32),
                (16, 33, 4160, 16)]


@pytest.mark.parametrize("m,n,k,bn", STREAM_CASES)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("epilogue_kind", ["scale", "row_scale", "bias"])
def test_stream_equals_ref_and_pallas(m, n, k, bn, packed, epilogue_kind):
    rng = np.random.RandomState(m * 13 + n + k)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-128 if not packed else -8, 128 if not packed else 8,
                    (n, k)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    rs = rng.uniform(0.01, 0.1, m).astype(np.float32) \
        if epilogue_kind != "scale" else None
    bias = rng.randn(n).astype(np.float32) \
        if epilogue_kind == "bias" else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    wt = pack_int4(t(w)) if packed else t(w)
    plan = ("stream", 8 if m <= 8 else 16, bn, 1)
    got = stream(t(x), wt, t(scale), t(bias), t(rs), plan, packed)
    assert torch.equal(got, ref.qmatmul_ref(t(x), wt, t(scale), t(bias),
                                            t(rs)))
    j = lambda a: None if a is None else jnp.asarray(a)
    wj = jquant.pack_int4(jnp.asarray(w)) if packed else jnp.asarray(w)
    want = np.asarray(j_qmatmul(jnp.asarray(x), wj, j(scale), j(bias), j(rs),
                                bm=128, bn=128, bk=128, packed=packed))
    if bias is None:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        top = np.abs(want).max()
        np.testing.assert_allclose(got.numpy() / top, want / top, rtol=0,
                                   atol=1e-6)


# (m, n, k, splits): one to nine splits, cuts that do and do not divide K
# evenly, K that is not a multiple of 128 (a slab, zero-filled) or of 32
# (the wrapper pads), rows and columns off the tile
SPLIT_CASES = [(37, 24, 640, 1), (37, 24, 640, 3), (20, 9, 1028, 2),
               (70, 33, 1000, 4), (5, 16, 4160, 9), (129, 40, 512, 8)]


@pytest.mark.parametrize("m,n,k,splits", SPLIT_CASES)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("epilogue", ["scale", "row_scale", "bias"])
def test_split_k_equals_ref_and_pallas(m, n, k, splits, packed, epilogue):
    rng = np.random.RandomState(m * 7 + k + splits)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-8, 8, (n, k)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    rs = rng.uniform(0.01, 0.1, m).astype(np.float32) \
        if epilogue != "scale" else None
    bias = rng.randn(n).astype(np.float32) if epilogue == "bias" else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    wt = pack_int4(t(w)) if packed else t(w)
    got = split_k(t(x), wt, t(scale), t(bias), t(rs), splits, packed)
    assert torch.equal(got, ref.qmatmul_ref(t(x), wt, t(scale), t(bias),
                                            t(rs)))
    j = lambda a: None if a is None else jnp.asarray(a)
    wj = jquant.pack_int4(jnp.asarray(w)) if packed else jnp.asarray(w)
    want = np.asarray(j_qmatmul(jnp.asarray(x), wj, j(scale), j(bias), j(rs),
                                bm=128, bn=128, bk=128, packed=packed))
    if bias is None:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        top = np.abs(want).max()
        np.testing.assert_allclose(got.numpy() / top, want / top, rtol=0,
                                   atol=1e-6)
