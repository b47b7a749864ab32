"""The PyTorch port's core (quant, softmax2, integerize, api) held against
the JAX package on the same numpy inputs.

Integer artefacts (codes, int32 accumulators, packed nibbles, weight and
embedding codes) must be EQUAL; float outputs agree within stated
tolerances.  Also: no file of the port (nor ``chip_smoke.py``) imports
JAX or the JAX package.
"""
import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import integerize as jint
from repro.core import quant as jquant
from repro.kernels import dispatch as jdispatch
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.core import api, integerize, quant, softmax2
from repro_torch.kernels import dispatch
from repro_torch.models import lm

torch.set_num_threads(1)
# repro.core re-exports a *function* named softmax2 over the module name.
jsm = importlib.import_module("repro.core.softmax2")

ROOT = Path(__file__).resolve().parent.parent


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


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 7, 8])
def test_quantize_codes_equal_jax(bits):
    rng = np.random.RandomState(bits)
    for unsigned in (False, True):
        assert quant.qrange(bits, unsigned=unsigned) == \
            jquant.qrange(bits, unsigned=unsigned)
    for trial in range(4):
        x = (rng.randn(6, 33) * rng.uniform(0.01, 40)).astype(np.float32)
        x[0, 0] = 0.0
        for axis in (None, 1):
            d_j = jquant.absmax_scale(jnp.asarray(x), bits, axis=axis)
            d_t = quant.absmax_scale(t(x), bits, axis=axis)
            np.testing.assert_array_equal(n(d_t), np.asarray(d_j))
            q_j = jquant.quantize(jnp.asarray(x), d_j, bits)
            q_t = quant.quantize(t(x), d_t, bits)
            assert q_t.dtype == torch.int8
            np.testing.assert_array_equal(n(q_t), np.asarray(q_j))
        xu = np.abs(x)
        d = jquant.absmax_scale(jnp.asarray(xu), bits, unsigned=True)
        np.testing.assert_array_equal(
            n(quant.quantize(t(xu), t(d), bits, unsigned=True)),
            np.asarray(jquant.quantize(jnp.asarray(xu), d, bits,
                                       unsigned=True)))


def test_round_half_to_even_like_jnp_round():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    q = quant.quantize(t(x), torch.tensor(1.0), 8)
    np.testing.assert_array_equal(
        n(q), np.asarray(jquant.quantize(jnp.asarray(x), 1.0, 8)))


def test_quantize_tensor_and_dequant_match():
    x = np.random.RandomState(1).randn(4, 9, 16).astype(np.float32)
    qj = jquant.quantize_tensor(jnp.asarray(x), 8)
    qt = quant.quantize_tensor(t(x), 8)
    np.testing.assert_array_equal(n(qt.q), np.asarray(qj.q))
    np.testing.assert_array_equal(n(qt.scale), np.asarray(qj.scale))
    np.testing.assert_array_equal(n(qt.dequant()), np.asarray(qj.dequant()))


def test_pack_unpack_int4_equal_jax():
    rng = np.random.RandomState(2)
    codes = rng.randint(-8, 8, (5, 3, 12)).astype(np.int8)
    pj = jquant.pack_int4(jnp.asarray(codes))
    pt = quant.pack_int4(t(codes))
    assert pt.dtype == torch.uint8
    np.testing.assert_array_equal(n(pt), np.asarray(pj))
    np.testing.assert_array_equal(n(quant.unpack_int4(pt)), codes)
    # low nibble = even index
    assert int(pt[0, 0, 0]) & 0xF == int(codes[0, 0, 0]) & 0xF
    with pytest.raises(ValueError):
        quant.pack_int4(t(codes[..., :3]))
    assert [quant.storage_bits(b) for b in (2, 4, 8)] == \
        [jquant.storage_bits(b) for b in (2, 4, 8)]


def test_exp2_shift_bitwise_equal():
    """Bitwise equal wherever the result is a normal float.  Below 2^-126
    XLA on the CPU flushes to zero while the port (and the CUDA kernels)
    keep the exact denormal: such an e is < 2^-125, rounds to code 0 and
    vanishes in any Sigma >= 1 (the row max alone contributes e >= 1)."""
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.uniform(-160, 3, 4000),
                        np.arange(-155, 4, 0.25),
                        [0.0, -0.0, -126.0, -126.5, -149.0, -150.0, -200.0]])
    x = x.astype(np.float32)
    got = n(softmax2.exp2_shift(t(x)))
    want = np.asarray(jsm.exp2_shift(jnp.asarray(x)))
    normal = np.floor(x) >= -126
    np.testing.assert_array_equal(got[normal].view(np.uint32),
                                  want[normal].view(np.uint32))
    assert np.all(got[~normal] < 2.0 ** -125) and np.all(want[~normal] == 0)
    assert (got[~normal] > 0).any()             # denormals really kept
    i = np.arange(-160, 128)
    np.testing.assert_array_equal(
        n(softmax2.exp2i(torch.from_numpy(i))),
        np.ldexp(np.float32(1), i).astype(np.float32))


def test_softmax2_and_quantize_probs():
    rng = np.random.RandomState(4)
    logits = (rng.randn(3, 7, 29) * 4).astype(np.float32)
    got = n(softmax2.softmax2(t(logits), scale=0.7))
    want = np.asarray(jsm.softmax2(jnp.asarray(logits), scale=0.7))
    # Sigma is an f32 sum taken in another order: ~1 ulp of the sum.
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    e = rng.uniform(0, 2, (3, 7, 29)).astype(np.float32)
    sigma = e.sum(-1, keepdims=True)
    for bits in (4, 7, 8):
        qj = jsm.quantize_probs(jnp.asarray(e), jnp.asarray(sigma), bits,
                                2.0 / ((1 << bits) - 1))
        qt = softmax2.quantize_probs(t(e), t(sigma), bits,
                                     2.0 / ((1 << bits) - 1))
        np.testing.assert_array_equal(n(qt), np.asarray(qj))


@pytest.mark.parametrize("bits", [4, 8])
def test_integerize_weight_and_int_linear(bits):
    rng = np.random.RandomState(bits)
    w = rng.randn(24, 40).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    pj = jint.make_qlinear(jnp.asarray(w), jnp.asarray(b), bits)
    pt = integerize.make_qlinear(t(w), t(b), bits)
    np.testing.assert_array_equal(n(pt.w_q), np.asarray(pj.w_q))
    np.testing.assert_array_equal(n(pt.w_scale), np.asarray(pj.w_scale))
    x = rng.randn(5, 40).astype(np.float32)
    xj = jquant.quantize_tensor(jnp.asarray(x), 8)
    xt = quant.quantize_tensor(t(x), 8)
    np.testing.assert_array_equal(n(xt.q), np.asarray(xj.q))
    acc_t = quant.int_matmul_exact(xt.q, pt.w_q.T)
    acc_j = np.asarray(xj.q, np.int64) @ np.asarray(pj.w_q, np.int64).T
    np.testing.assert_array_equal(n(acc_t), acc_j)
    for ais in (True, False):
        yj = jint.int_linear(xj, pj, apply_input_scale=ais)
        yt = integerize.int_linear(xt, pt, apply_input_scale=ais)
        # Same int32 accumulators and the same f32 epilogue ops.
        np.testing.assert_allclose(n(yt), np.asarray(yj), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(n(integerize.dequant_linear_ref(xt, pt)),
                               np.asarray(jint.dequant_linear_ref(xj, pj)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        n(integerize.int_matmul_transposed(xt, xt)),
        np.asarray(jint.int_matmul_transposed(xj, xj)), rtol=1e-6)


# One square width keeps JAX's eager op-by-op compiles few (the reference
# integerizes eagerly; see the test).
SMOKE = jlm.LMConfig(name="t", n_layers=1, d_model=32, n_heads=4,
                     kv_heads=4, d_ff=32, vocab=32, dtype="float32",
                     q_chunk=8, remat=False, qkv_bias=True)


def test_integerize_params_tree_equal_jax():
    """Every leaf of the integerized tree (layer-stacked weight codes,
    scales, int8 embeddings, the quantized lm_head), plain and packed."""
    import jax
    fparams = jax.tree.map(np.asarray, jax.jit(
        lambda key: jlm.init_params(key, SMOKE))(jax.random.PRNGKey(0)))
    for pack in (False, True):
        qj = japi.QuantConfig(w_bits=4, a_bits=8, mode="int",
                              pack_weights=pack)
        qt = api.QuantConfig(w_bits=4, a_bits=8, mode="int",
                             pack_weights=pack)
        # eager, as the reference's serve runs it: under jit XLA rewrites
        # the division by qmax into a multiplication by its reciprocal
        ij = jax.tree.map(np.asarray, japi.integerize_params(fparams, qj))
        it = interop.to_numpy(api.integerize_params(
            interop.to_torch(fparams, "cpu"), qt))
        flat_j = jax.tree_util.tree_flatten_with_path(ij)[0]
        assert len(flat_j) == len(jax.tree_util.tree_leaves(it))
        for path, leaf in flat_j:
            got = it
            for p in path:
                got = got[p.key]
            assert got.dtype == leaf.dtype, path
            np.testing.assert_array_equal(got, leaf, err_msg=str(path))
        assert ij["lm_head"]["w_q"].dtype == (np.uint8 if pack else np.int8)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_dense_int_codes_exact_floats_close(backend):
    """dense(mode="int"): per-sequence activation codes equal the JAX
    codes; outputs agree to f32 epilogue rounding.  On the CPU the cuda
    route runs qmatmul's plain version, bit-identical to the torch route."""
    import jax
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 5, 32) * rng.uniform(0.1, 3, (3, 1, 1))) \
        .astype(np.float32)
    w = rng.randn(32, 24).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    qj = japi.QuantConfig(w_bits=4, a_bits=8, mode="int")
    qt = api.QuantConfig(w_bits=4, a_bits=8, mode="int", backend=backend)
    pj = japi.integerize_params({"l": {"w": jnp.asarray(w),
                                       "b": jnp.asarray(b)}}, qj)["l"]
    pt = interop.to_torch(jax.tree.map(np.asarray, pj), "cpu")
    dx_j = jquant.absmax_scale(jnp.asarray(x), 8, axis=(1, 2))
    dx_t = quant.absmax_scale(t(x), 8, axis=(1, 2))
    np.testing.assert_array_equal(n(dx_t), np.asarray(dx_j))
    np.testing.assert_array_equal(
        n(quant.quantize(t(x), dx_t, 8)),
        np.asarray(jquant.quantize(jnp.asarray(x), dx_j, 8)))
    dispatch.reset_stats()
    yt = api.dense(t(x), pt, qt)
    yj = japi.dense(jnp.asarray(x), pj, qj)
    np.testing.assert_allclose(n(yt), np.asarray(yj), rtol=1e-6, atol=1e-6)
    assert dispatch.STATS[f"qlinear_{backend}"] == 1
    other = api.dense(t(x), pt, qt.replace(
        backend="cuda" if backend == "torch" else "torch"))
    assert torch.equal(yt, other)           # the routes agree bitwise
    x2 = x[0]                               # 2-D: per-tensor grid
    np.testing.assert_allclose(n(api.dense(t(x2), pt, qt)),
                               np.asarray(japi.dense(jnp.asarray(x2), pj, qj)),
                               rtol=1e-6, atol=1e-6)
    # float mode and dense_q
    np.testing.assert_allclose(
        n(api.dense(t(x), {"w": t(w), "b": t(b)}, None)),
        np.asarray(japi.dense(jnp.asarray(x), {"w": jnp.asarray(w),
                                               "b": jnp.asarray(b)}, None)),
        rtol=1e-5, atol=1e-5)
    xq_j = jquant.quantize_tensor(jnp.asarray(x2), 8)
    xq_t = quant.quantize_tensor(t(x2), 8)
    np.testing.assert_allclose(n(api.dense_q(xq_t, pt, qt)),
                               np.asarray(japi.dense_q(xq_j, pj, qj)),
                               rtol=1e-6, atol=1e-6)


def test_dense_packed_weights_match_unpacked():
    rng = np.random.RandomState(6)
    w = t(rng.randn(16, 8).astype(np.float32))
    x = t(rng.randn(2, 3, 16).astype(np.float32))
    qc = api.QuantConfig(w_bits=4, mode="int")
    plain = api.integerize_params({"l": {"w": w}}, qc)["l"]
    packed = api.integerize_params({"l": {"w": w}},
                                   qc.replace(pack_weights=True))["l"]
    assert packed["w_q"].dtype == torch.uint8
    assert torch.equal(api.as_qlinear(packed, qc).w_q, plain["w_q"])
    for backend in ("cuda", "torch"):
        c = qc.replace(backend=backend)
        assert torch.equal(api.dense(x, packed, c), api.dense(x, plain, c))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value
                elif isinstance(arg, ast.JoinedStr):
                    yield "".join(v.value for v in arg.values
                                  if isinstance(v, ast.Constant))


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(ast.parse(f.read_text(), str(f))):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                f"{f.relative_to(ROOT)} imports {mod}"


def test_entry_points_default_to_cuda():
    import inspect
    from repro_torch.launch import serve as tserve
    assert inspect.signature(lm.init_params).parameters["device"].default \
        == "cuda"
    assert inspect.signature(
        lm.init_paged_cache).parameters["device"].default == "cuda"
    assert "--device" in inspect.getsource(tserve.main)
    assert dispatch.get_backend() in ("cuda", "torch")
    with pytest.raises(ValueError):
        with dispatch.use_backend("pallas"):
            pass
