"""qmatmul's plan and its tensor-core body's split of K, as algorithms, held
against the reference.

``kernels/qmatmul.py::plan`` picks the CUDA kernel's body, output tile and
split count from the shape; the tests below hold it, at every shape the
main paths give it and at ragged ones, to what the kernel takes: the dp4a
body exactly for M <= 16 rows, the ``mma`` body's tiles, splits of at
least ``MIN_SPLIT_K`` bytes of K each (no more splits than the kernel's
slabs, which the launcher refuses), and at least one block per SM wherever
K is split.  The ``mma`` body's fit in shared memory is asserted where its
layout is written, at compile time (``MmaLayout`` in ``csrc/qmatmul.cu``).

:func:`split_k` does the ``mma`` body's arithmetic in plain PyTorch (the
wrapper's K padding, the nibble unpacking written as the kernel's bit
operations, K cut into contiguous ranges, the int32 partial sums added in
split order, the epilogue rounded op by op), so the design is checked here
where the kernel cannot run: bit for bit against ``ref.qmatmul_ref`` (the
kernel's plain version) and against JAX's Pallas kernel (interpret mode)
without a bias; with a bias to 1e-6 of the output's max, as XLA on the CPU
contracts ``acc * s + b`` into one FMA.  On the card the kernel is held
against the same plain version (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
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
        assert choice == ("dp4a", 16, 64, 1)      # the decode body as it was
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
    """The plans the main paths run: decode on dp4a; prefill and DeiT-S on
    128 x 128 tensor-core tiles, K split where 80 tiles leave SMs idle
    (the Qwen wq and MLP down at 256 rows), and 64 x 128 tiles with K split
    for the wk/wv shape (16 tiles of 128 rows, K too short for 9 splits
    of 1 KB)."""
    for n, k in QWEN_NK:
        assert qm.plan(4, n, k) == ("dp4a", 16, 64, 1)
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
    s = scale[None, :]
    if row_scale is not None:
        s = s * row_scale[:, None]
    out = acc.to(torch.float32) * s
    return out if bias is None else out + bias[None, :]


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
