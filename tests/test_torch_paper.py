"""The paper's remaining pieces in the port, held against the JAX package.

- ``core/softmax2.py``: ``softmax_ref`` and the Fig. 4 comparator form
  ``quantize_probs_comparator``, each against its JAX counterpart, and the
  comparator against the port's division form ``quantize_probs``.
- ``core/integerize.py::int_linear_requant`` (Fig. 2's activation to
  activation path) against JAX's.
- ``benchmarks/fig_softmax_error.py``'s attention-output error against the
  prob grid's bits (2, 3, 4, 7) through the port's ``attention``, on the
  kernel route (the fused kernel's plain version on the CPU) and the plain
  route, against JAX's on the same inputs.
- ``benchmarks/table2_comparison.py``'s parameter count and model size on
  the port's DeiT-S tree, against JAX's and the paper's Table II bounds of
  ``tests/test_paper_tables.py``.

Inputs are made with numpy from seeds.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integerize as jint
from repro.core import quant as jquant
from repro.core.api import QuantConfig as JQuantConfig
from repro.kernels import dispatch as jdispatch
from repro.layers import attention as jattn
from repro_torch.core import integerize as tint
from repro_torch.core import quant as tquant
from repro_torch.core import softmax2 as tsm
from repro_torch.core.api import QuantConfig
from repro_torch.kernels import dispatch
from repro_torch.layers import attention as tattn

torch.set_num_threads(1)
# ``repro.core`` re-exports a function named ``softmax2``: take the module
jsm = importlib.import_module("repro.core.softmax2")


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


# ---------------------------------------------------------------------------
# softmax2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dim,scale", [((8, 128), -1, 1.0),
                                             ((3, 5, 64), 1, 0.125),
                                             ((2, 4, 16, 16), -1, 3.0)])
def test_softmax_ref_equals_reference(shape, dim, scale):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32) * 4
    want = np.asarray(jsm.softmax_ref(jnp.asarray(x), axis=dim, scale=scale))
    got = tsm.softmax_ref(torch.from_numpy(x), dim=dim, scale=scale).numpy()
    # exp and the row sum: f32, another library's order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.sum(axis=dim), 1.0, rtol=1e-5)


def _probs(seed, rows=8, cols=32):
    """``tests/test_softmax2.py``'s comparator inputs: |N(0, 1)| * 3 a row,
    Sigma the row sum, delta 1 / (2^bits - 1)."""
    e = np.abs(np.random.RandomState(seed).randn(rows, cols)) \
        .astype(np.float32) * 3
    return e, e.sum(-1, keepdims=True)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_comparator_equals_reference_comparator(bits):
    delta = np.float32(1.0 / ((1 << bits) - 1))
    for seed in range(6):
        e, sigma = _probs(seed)
        want = np.asarray(jsm.quantize_probs_comparator(
            jnp.asarray(e), jnp.asarray(sigma[..., 0]), bits,
            jnp.float32(delta)))
        got = tsm.quantize_probs_comparator(
            torch.from_numpy(e), torch.from_numpy(sigma[..., 0]), bits,
            torch.tensor(delta))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(want.max()) <= (1 << bits) - 1


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7])
def test_comparator_equals_division_form(bits):
    """Sigma-scaled comparator thresholds == the division form, up to the
    reference's tie rule: at an exact .5 the division rounds half to even
    and the strict comparison does not (<= 1 code on < 1% of entries)."""
    delta = torch.tensor(1.0 / ((1 << bits) - 1))
    for seed in range(0, 10_000, 997):
        e, sigma = _probs(seed)
        et, st = torch.from_numpy(e), torch.from_numpy(sigma)
        div = tsm.quantize_probs(et, st, bits, delta).int()
        cmp = tsm.quantize_probs_comparator(et, st[..., 0], bits, delta).int()
        diff = (div - cmp).abs()
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) < 0.01


def test_comparator_tie_is_strict_as_in_the_reference():
    """At e exactly on a threshold the comparator stays below it; the
    division form rounds half to even.  Both ports keep their reference's
    rule."""
    e = np.array([[0.5, 1.5, 2.5, 0.0]], np.float32)
    sigma = np.ones((1, 1), np.float32)
    for mod, arr in ((jsm, jnp.asarray), (tsm, torch.from_numpy)):
        cmp = mod.quantize_probs_comparator(arr(e), arr(sigma[..., 0]), 3,
                                            1.0)
        div = mod.quantize_probs(arr(e), arr(sigma), 3, 1.0)
        assert np.asarray(cmp).tolist() == [[0, 1, 2, 0]]
        assert np.asarray(div).tolist() == [[0, 2, 2, 0]]


# ---------------------------------------------------------------------------
# int_linear_requant
# ---------------------------------------------------------------------------

def _linear(seed, m, n, k, bias):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wq = rng.randint(-7, 8, (n, k)).astype(np.int8)
    xs = np.float32(rng.rand() * 0.05 + 0.01)
    ws = (rng.rand(n).astype(np.float32) * 1e-2 + 1e-3)
    b = rng.randn(n).astype(np.float32) if bias else None
    return xq, wq, xs, ws, b


@pytest.mark.parametrize("out_bits", [2, 3, 4, 8])
@pytest.mark.parametrize("bias", [False, True])
def test_int_linear_requant_equals_reference(out_bits, bias):
    flips = total = 0
    for seed in range(4):
        xq, wq, xs, ws, b = _linear(seed, 33, 70, 96, bias)
        jp = jint.QLinearParams(jnp.asarray(wq), jnp.asarray(ws),
                                None if b is None else jnp.asarray(b), 4)
        tp = tint.QLinearParams(torch.from_numpy(wq), torch.from_numpy(ws),
                                None if b is None else torch.from_numpy(b), 4)
        y = np.asarray(jint.int_linear(
            jquant.QTensor(jnp.asarray(xq), jnp.float32(xs), 8), jp))
        out_scale = np.float32(np.abs(y).max() / ((1 << (out_bits - 1)) - 1)
                               * 0.7)                     # some clipping
        want = jint.int_linear_requant(
            jquant.QTensor(jnp.asarray(xq), jnp.float32(xs), 8), jp, out_bits,
            jnp.float32(out_scale))
        got = tint.int_linear_requant(
            tquant.QTensor(torch.from_numpy(xq), torch.tensor(xs), 8), tp,
            out_bits, torch.tensor(out_scale))
        assert got.bits == want.bits == out_bits
        assert float(got.scale) == float(want.scale)
        wc = np.asarray(want.q).astype(np.int32)
        gc = got.q.numpy().astype(np.int32)
        qmin, qmax = tquant.qrange(out_bits)
        assert gc.min() >= qmin and gc.max() <= qmax
        assert gc.min() == qmin or gc.max() == qmax           # it clips
        if not bias:
            np.testing.assert_array_equal(gc, wc)
        else:
            # XLA contracts acc*s + b into an FMA; the port rounds twice
            # (ROADMAP queue 3): a code may move by one at a rounding edge
            d = np.abs(gc - wc)
            assert d.max() <= 1
            flips += int((d > 0).sum())
        total += wc.size
    assert flips / total < 1e-3


# ---------------------------------------------------------------------------
# Eq. 4: attention-output error against the prob grid's bits
# ---------------------------------------------------------------------------

SWEEP_BITS = (2, 3, 4, 7)


def _sweep_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 4, 64, 32).astype(np.float32) for _ in range(3)]


def _jax_sweep(qkv):
    q, k, v = map(jnp.asarray, qkv)
    spec = jattn.AttnSpec(q_chunk=64)
    ref = jattn.attention(q, k, v, spec)
    scale = float(jnp.max(jnp.abs(ref)))
    errs = []
    with jdispatch.use_backend("xla"):
        for bits in SWEEP_BITS:
            qc = JQuantConfig(w_bits=8, a_bits=8, attn_bits=bits, mode="int")
            out = jattn.attention(q, k, v, spec, qc)
            errs.append(float(jnp.max(jnp.abs(out - ref))) / scale)
    return errs


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eq4_sweep_equals_reference_and_falls_with_bits(seed, backend):
    qkv = _sweep_inputs(seed)
    want = _jax_sweep(qkv)
    q, k, v = map(torch.from_numpy, qkv)
    spec = tattn.AttnSpec(q_chunk=64)
    ref = tattn.attention(q, k, v, spec)
    scale = float(ref.abs().max())
    got = []
    for bits in SWEEP_BITS:
        qc = QuantConfig(w_bits=8, a_bits=8, attn_bits=bits, mode="int")
        dispatch.reset_stats()
        with dispatch.use_backend(backend):
            out = tattn.attention(q, k, v, spec, qc)
        assert dispatch.STATS[f"attention_{backend}"] == 1
        got.append(float((out - ref).abs().max()) / scale)
    # the same codes; Sigma, the dequantized output and the float reference
    # are f32 sums in another order (measured: within 1.4e-6 relative)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got == sorted(got, reverse=True), got
    assert want == sorted(want, reverse=True), want


def test_exp2_shift_error_bound_of_eq4():
    x = torch.linspace(-30, 30, 200_001, dtype=torch.float64).float()
    rel = (tsm.exp2_shift(x) - torch.exp2(x)).abs() / torch.exp2(x)
    assert float(rel.max()) < 0.0615


# ---------------------------------------------------------------------------
# Table II on the port's DeiT-S tree
# ---------------------------------------------------------------------------

def test_table2_sizes_on_the_port_equal_reference_and_paper():
    from benchmarks import table2_comparison
    from repro_torch.configs.deit_s import CONFIG
    from repro_torch.core.api import count_params, model_bytes
    from repro_torch.models import vit
    rows = {r["model"]: r for r in table2_comparison.rows()}
    params = vit.init_params(CONFIG, seed=0, device="cpu")
    n = count_params(params)
    assert n / 1e6 == rows["Ours 2-bit"]["params_m"]
    assert abs(n / 1e6 - 21.8) / 21.8 < 0.03
    for bits, paper, rtol in ((2, 5.8, 0.05), (3, 8.3, 0.06)):
        qc = QuantConfig(w_bits=bits, mode="int", quantize_embeddings=False)
        size_mb = model_bytes(params, qc) / 1e6
        assert round(size_mb, 1) == rows[f"Ours {bits}-bit"]["size_mb"]
        assert abs(round(size_mb, 1) - paper) / paper < rtol


# ---------------------------------------------------------------------------
# Table II's 3- and 2-bit points on DeiT (SMOKE width)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w_bits,attn_bits", [(3, 3), (2, 2)])
def test_deit_low_bit_points_equal_reference_on_both_backends(w_bits,
                                                              attn_bits):
    """DeiT at the paper's "Ours 3-bit" / "Ours 2-bit" weights and prob
    grids: the port's logits within 1e-5 of JAX's (as
    ``tests/test_torch_vit.py`` holds the 4-bit point), its two backends
    bit-equal on the CPU, and the layer-by-layer pieces ``embed``,
    ``block`` and ``head`` (which ``chip_smoke.py`` teacher-forces) equal
    to ``forward``."""
    import jax
    from repro.configs import deit_s as jdeit
    from repro.core.api import integerize_params as j_integerize
    from repro.models import vit as jvit
    from repro_torch import interop
    from repro_torch.configs import deit_s
    from repro_torch.models import vit
    jq = JQuantConfig(w_bits=w_bits, a_bits=8, attn_bits=attn_bits,
                      mode="int")
    jcfg = jdeit.SMOKE.replace(quant=jq)
    ip = j_integerize(jvit.init_params(jax.random.PRNGKey(0), jdeit.SMOKE),
                      jq)
    imgs = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    with jdispatch.use_backend("xla"):
        want = np.asarray(jvit.forward(ip, jnp.asarray(imgs), jcfg))
    params = interop.to_torch(jax.tree.map(np.asarray, ip), device="cpu")
    x = torch.from_numpy(imgs)
    got = {}
    for backend in ("cuda", "torch"):
        cfg = deit_s.SMOKE.replace(quant=QuantConfig(
            w_bits=w_bits, a_bits=8, attn_bits=attn_bits, mode="int",
            backend=backend))
        dispatch.reset_stats()
        got[backend] = vit.forward(params, x, cfg)
        assert dispatch.STATS[f"attention_{backend}"] == cfg.n_layers
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[backend].numpy() / scale,
                                   want / scale, rtol=0, atol=1e-5)
        h = vit.embed(params, x, cfg)
        for i in range(cfg.n_layers):
            h = vit.block(h, {k: _layer(v, i) for k, v in
                              params["layers"].items()}, cfg)
        assert torch.equal(vit.head(params, h, cfg), got[backend])
    assert torch.equal(got["cuda"], got["torch"])


def _layer(tree, i):
    return {k: _layer(v, i) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree[i]
