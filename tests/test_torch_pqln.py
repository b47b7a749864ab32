"""PQ-LayerNorm in the port held against the JAX package.

- Kernel 5's plain version (``repro_torch.kernels.ref.pq_layernorm_ref``,
  what the wrapper runs on CPU tensors) against the reference's Pallas
  kernel in interpret mode and its ``ref.pq_layernorm_ref``: f32 and bf16
  inputs, LayerNorm and RMS, bits 3, 4 and 8.  Codes are held flip-aware
  by the reference's own criterion (``tests/test_kernels.py``): |diff| <= 1
  and under 0.1% of codes differ — JAX computes ``rsqrt`` and sums in
  XLA's order, the port ``1 / sqrt`` with the row sums in the CUDA
  kernel's order, so a code at a rounding edge may move by one step.
- The plain version's row sums are the kernel's order under
  ``pq_layernorm_plan`` (each thread's elements in order, a warp's lanes
  in a halving tree, a row's warps in warp order), modelled thread by
  thread and checked against a float64 sum; the plan is a function of
  ``(d, dtype)`` alone, so a row's codes do not depend on the rows beside
  it.
- ``core/pqln`` against the reference's module: the comparator (Fig. 5b)
  equals the rsqrt form away from ties, Welford moments match the
  two-pass moments, ``rmsnorm``/``pq_rmsnorm`` match JAX's, and a
  per-tensor scale cancels at fixed seeds up to rounding edges.
"""
import inspect

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import pqln as jpqln
from repro.kernels import ref as jref
from repro.kernels.pq_layernorm import pq_layernorm as j_pqln
from repro_torch.core import pqln
from repro_torch.kernels import pq_layernorm as kpl
from repro_torch.kernels import ref

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def flip_aware(got, want, frac=1e-3):
    """The reference's criterion for codes computed two ways."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < frac, (diff > 0).mean()


def _case(rows, d, seed, bf16):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, d) * 3 + rng.randn(rows, 1)).astype(np.float32)
    g = (np.abs(rng.randn(d)) + 0.5).astype(np.float32)
    b = (rng.randn(d) * 0.1).astype(np.float32)
    if bf16:
        x = x.astype(ml_dtypes.bfloat16)
    return x, g, b


def _xt(x):
    if x.dtype == ml_dtypes.bfloat16:
        return t(x.view(np.int16)).view(torch.bfloat16)
    return t(x)


# One width per regime of the kernel's plan: a warp per row (160, 384,
# 1024 f32), several warps per row (5120), and rows above the register
# plan (32769, re-read from global).
@pytest.mark.parametrize("rows,d", [(40, 160), (16, 384), (8, 1024),
                                    (4, 5120), (2, 32769)])
@pytest.mark.parametrize("bf16,rms_only", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_kernel_plain_version_matches_pallas_and_ref(bf16, rms_only, rows,
                                                     d):
    x, g, b = _case(rows, d, 3 + 2 * bf16 + rms_only, bf16)
    beta = None if rms_only else b
    for bits, delta in ((3, 0.5), (4, 0.25), (8, 0.02)):
        want = np.asarray(j_pqln(jnp.asarray(x), jnp.asarray(g),
                                 None if beta is None else jnp.asarray(beta),
                                 delta, bits=bits, rms_only=rms_only, br=16))
        oracle = np.asarray(jref.pq_layernorm_ref(
            jnp.asarray(x), jnp.asarray(g),
            None if beta is None else jnp.asarray(beta), delta, bits=bits,
            rms_only=rms_only))
        before = kpl.LAUNCHES["pq_layernorm"]
        got = kpl.pq_layernorm(_xt(x), t(g), None if beta is None else t(b),
                               delta, bits=bits, rms_only=rms_only)
        assert kpl.LAUNCHES["pq_layernorm"] == before      # CPU: plain
        assert got.dtype == torch.int8 and got.shape == x.shape
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        assert int(got.min()) >= lo and int(got.max()) <= hi
        flip_aware(got.numpy(), want)
        flip_aware(got.numpy(), oracle)


def _thread_model_sums(v, tpr, vec):
    """The kernel's row sums, thread by thread: thread t adds the elements
    of its vectors t, t + tpr, ... (``vec`` elements each, cut at d) in
    order; each warp's lanes add by the xor butterfly (lane i takes lane
    i ^ o's value, o = 16 .. 1), read at lane 0; the row's warps add in
    warp order.  f32 throughout."""
    rows, d = v.shape
    lanes = np.zeros((rows, tpr), np.float32)
    for th in range(tpr):
        for c in range(th, -(-d // vec), tpr):
            for e in range(c * vec, min(c * vec + vec, d)):
                lanes[:, th] = lanes[:, th] + v[:, e]
    total = None
    for w in range(tpr // 32):
        lane = lanes[:, 32 * w:32 * w + 32]
        for o in (16, 8, 4, 2, 1):
            lane = lane + lane[:, [i ^ o for i in range(32)]]
        total = lane[:, 0] if total is None else total + lane[:, 0]
    return total


# (d, dtype): ragged widths (77 bf16, 100 f32), DeiT-S's 384, the
# reference's 1024 (a warp per row), Qwen2.5-32B's 5120 (256 threads a row
# in bf16, 512 in f32), and the first widths above the register plan
# (16385 f32, 32769 bf16: 1024 threads re-reading the row)
@pytest.mark.parametrize("d,dtype", [(77, torch.bfloat16),
                                     (100, torch.float32),
                                     (384, torch.float32),
                                     (1024, torch.float32),
                                     (5120, torch.bfloat16),
                                     (5120, torch.float32),
                                     (16385, torch.float32),
                                     (32769, torch.bfloat16)])
def test_plain_version_sums_in_the_kernel_order(d, dtype):
    """The plain version's row sums equal the thread-by-thread model of the
    kernel's plan bit for bit, and a float64 sum within rtol 1e-5 (the
    rows' mean of 0.5 keeps their sums near 0.5 d; no f32 chain here is
    longer than 40 + 5 + 31 adds)."""
    rng = np.random.RandomState(d)
    v = (rng.randn(3, d) + 0.5).astype(np.float32)
    tpr, vec, ept = ref.pq_layernorm_plan(d, dtype)
    assert ept % vec == 0 and tpr * ept >= d > tpr * (ept - vec)
    got = ref._plan_sums(t(v), tpr, vec).numpy()[:, 0]
    np.testing.assert_array_equal(got, _thread_model_sums(v, tpr, vec))
    np.testing.assert_allclose(got, v.astype(np.float64).sum(1), rtol=1e-5)


def test_plan_depends_on_d_and_dtype_only():
    """``pq_layernorm_plan`` takes ``(d, dtype)`` and nothing else: a warp
    per row while a lane holds at most 8 16-byte vectors, else the fewest
    of 128 .. 1024 threads that leave a lane at most 4, and above 1024 x 4
    vectors 1024 threads (the kernel re-reads such rows)."""
    assert list(inspect.signature(ref.pq_layernorm_plan).parameters) == \
        ["d", "dtype"]
    assert kpl.plan is ref.pq_layernorm_plan
    f32, bf16 = torch.float32, torch.bfloat16
    assert ref.pq_layernorm_plan(384, f32) == (32, 4, 12)
    assert ref.pq_layernorm_plan(1024, f32) == (32, 4, 32)
    assert ref.pq_layernorm_plan(1025, f32) == (128, 4, 12)
    assert ref.pq_layernorm_plan(5120, bf16) == (256, 8, 24)
    assert ref.pq_layernorm_plan(7168, bf16) == (256, 8, 32)
    assert ref.pq_layernorm_plan(16384, f32) == (1024, 4, 16)
    assert ref.pq_layernorm_plan(16385, f32) == (1024, 4, 20)
    assert ref.pq_layernorm_plan(32769, bf16) == (1024, 8, 40)
    for dtype, vec in ((f32, 4), (bf16, 8)):
        for d in list(range(1, 2100)) + list(range(2100, 70000, 97)):
            tpr, v, ept = ref.pq_layernorm_plan(d, dtype)
            nv, chunks = ept // vec, -(-d // vec)
            assert v == vec and nv == -(-chunks // tpr)
            if tpr == 32:
                assert nv <= 8
            else:
                assert chunks > 32 * 8 and tpr in (128, 256, 512, 1024)
                assert nv <= 4 or tpr == 1024
                assert tpr == 128 or -(-chunks // (tpr // 2)) > 4


@pytest.mark.parametrize("d,bf16,rms_only", [(384, False, False),
                                             (5120, True, True),
                                             (1100, False, False)])
def test_plain_version_row_codes_do_not_depend_on_the_batch(d, bf16,
                                                            rms_only):
    """A row's codes are the same alone and inside a 1000-row batch (the
    plan and the order of every sum depend on (d, dtype) only)."""
    x, g, b = _case(1000, d, 17, bf16)
    beta = None if rms_only else t(b)
    whole = ref.pq_layernorm_ref(_xt(x), t(g), beta, 0.02, bits=8,
                                 rms_only=rms_only)
    for r in (0, 517, 999):
        alone = ref.pq_layernorm_ref(_xt(x[r:r + 1]), t(g), beta, 0.02,
                                     bits=8, rms_only=rms_only)
        assert torch.equal(alone[0], whole[r])


def test_kernel_plain_version_against_core_rsqrt_form():
    """The kernel's plain version and ``core.pqln.pq_layernorm`` (rsqrt,
    torch's own sums) make the same codes but at rounding edges."""
    x, g, b = _case(64, 96, 7, False)
    got = ref.pq_layernorm_ref(t(x), t(g), t(b), 0.05, bits=8)
    want = pqln.pq_layernorm(t(x), t(g), t(b), 8, torch.tensor(0.05))
    flip_aware(got.numpy(), want.numpy())


@pytest.mark.parametrize("seed,bits", [(0, 2), (11, 4), (29, 6)])
def test_comparator_equals_rsqrt_form_and_jax(seed, bits):
    """Fig. 5(b): the division- and sqrt-free comparator equals the rsqrt
    form but at threshold ties (<= 1 step, < 1% of codes: the reference's
    bound), and equals JAX's comparator on the same inputs (the squared
    comparisons are exact but at the same ties)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(6, 32) * 2).astype(np.float32)
    gamma = (np.abs(rng.randn(32)) + 0.3).astype(np.float32)
    beta = (rng.randn(32) * 0.2).astype(np.float32)
    delta = np.float32(0.3)
    a = pqln.pq_layernorm(t(x), t(gamma), t(beta), bits, t(delta))
    c = pqln.pq_layernorm_comparator(t(x), t(gamma), t(beta), bits,
                                     t(delta))
    flip_aware(a.numpy(), c.numpy(), frac=1e-2)
    jc = jpqln.pq_layernorm_comparator(jnp.asarray(x), jnp.asarray(gamma),
                                       jnp.asarray(beta), bits,
                                       jnp.asarray(delta))
    ja = jpqln.pq_layernorm(jnp.asarray(x), jnp.asarray(gamma),
                            jnp.asarray(beta), bits, jnp.asarray(delta))
    flip_aware(c.numpy(), np.asarray(jc), frac=1e-2)
    flip_aware(a.numpy(), np.asarray(ja), frac=1e-2)


@pytest.mark.parametrize("n", [4, 37, 64])
def test_welford_equals_twopass_and_jax(n):
    """Eq. 5 incremental moments against the two-pass moments (rtol 1e-4
    on the variance: the reference's bound, one f32 rounding per step)
    and against JAX's Welford scan (same steps, 1e-6)."""
    x = (np.random.RandomState(n).randn(3, n) * 5).astype(np.float32)
    m1 = pqln.moments_twopass(t(x))
    m2 = pqln.moments_welford(t(x))
    np.testing.assert_allclose(m1.mean.numpy(), m2.mean.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(m1.var.numpy(), m2.var.numpy(), rtol=1e-4,
                               atol=1e-5)
    jm = jpqln.moments_welford(jnp.asarray(x))
    np.testing.assert_allclose(m2.mean.numpy(), np.asarray(jm.mean),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m2.var.numpy(), np.asarray(jm.var),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,c", [(0, 0.1015625), (5374, 0.1015625),
                                    (3, 7.5), (42, 100.0)])
def test_per_tensor_scale_cancels(seed, c):
    """The absorption trick, LN(c * x) == LN(x), at fixed seeds (the
    reference's property test draws them with hypothesis; its (5374,
    0.1015625) example lands on a rounding edge there).  Each side equals
    JAX's codes flip-aware, and the two sides agree but at rounding edges
    (<= 1 step, < 10% of these 64 codes)."""
    x = np.random.RandomState(seed).randn(4, 16).astype(np.float32)
    g, b = np.ones(16, np.float32), np.zeros(16, np.float32)
    d = np.float32(0.25)
    a = pqln.pq_layernorm(t(x), t(g), t(b), 4, t(d))
    ac = pqln.pq_layernorm(t(x) * c, t(g), t(b), 4, t(d))
    flip_aware(a.numpy(), ac.numpy(), frac=0.1)
    for xs, got in ((x, a), (x * np.float32(c), ac)):
        want = jpqln.pq_layernorm(jnp.asarray(xs), jnp.asarray(g),
                                  jnp.asarray(b), 4, jnp.asarray(d))
        flip_aware(got.numpy(), np.asarray(want), frac=0.1)


def test_rmsnorm_and_pq_rmsnorm_match_jax():
    """Floats within 1e-6 of the output's max (rsqrt and the mean's order
    differ in the last bit); codes flip-aware and in range."""
    rng = np.random.RandomState(5)
    x = (rng.randn(8, 64) * 10).astype(np.float32)
    g = (np.abs(rng.randn(64)) + 0.1).astype(np.float32)
    got = pqln.rmsnorm(t(x), t(g)).numpy()
    want = np.asarray(jpqln.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    np.testing.assert_allclose(got / np.abs(want).max(),
                               want / np.abs(want).max(), atol=1e-6)
    q = pqln.pq_rmsnorm(t(x), t(g), 3, torch.tensor(0.5))
    jq = jpqln.pq_rmsnorm(jnp.asarray(x), jnp.asarray(g), 3,
                          jnp.float32(0.5))
    assert int(q.min()) >= -4 and int(q.max()) <= 3
    flip_aware(q.numpy(), np.asarray(jq), frac=1e-2)
