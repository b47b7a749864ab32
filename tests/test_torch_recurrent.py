"""The recurrent families of the port (RecurrentGemma-9B: RG-LRU blocks and
local MQA attention; Mamba2-130M: SSD blocks) held against the JAX package,
with JAX's weights carried over by ``interop`` and the JAX side on its XLA
route.

Tolerances, and why:

- The activations on bf16: ``gelu`` and ``logistic`` (and ``silu``) bit-equal
  to JAX's over every finite bf16 value (XLA rounds a bf16 expression op by
  op, and so does the port), but where XLA flushes a subnormal to zero.
  f32 ``softplus`` within 4 ulp (JAX's log1p / exp are its own:
  ``torch.logaddexp`` differs in 5% of values, by up to 3 ulp).
- ``rglru_scan``, ``ssd_chunked``, ``ssd_step``, ``rglru_step``: within
  1e-6 of the output's max (XLA contracts ``a2*b1 + b2`` into an FMA and sums
  einsums in another order; measured up to 1.5e-7).
- ``temporal_conv``: bit-equal to eager JAX (the taps sum in the reference's
  order, each product rounded), within 1e-6 of jitted JAX (FMA); its state
  bit-equal.
- The blocks and the SMOKE models: logits within FLIP_TOL of their max at
  every step and within TOL at half of them, greedy tokens equal, as
  ``tests/test_torch_archs.py`` holds them (an activation code can flip at
  a rounding edge where XLA contracts FMAs); recurrent states within
  STATE_TOL of their max (the same flips).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.kernels import dispatch as jdispatch
from repro.layers import mlp as jmlp
from repro.layers import rglru as jrglru
from repro.layers import ssd as jssd
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.core.api import QuantConfig, integerize_params
from repro_torch.kernels import dispatch
from repro_torch.layers import mlp, rglru, ssd
from repro_torch.models import lm

torch.set_num_threads(1)

ARCHS = ["recurrentgemma-9b", "mamba2-130m"]
TOL = 1e-6
FLIP_TOL = 0.1
STATE_TOL = 5e-2
FN_TOL = 1e-6
STEPS = 3


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


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _all_bf16():
    x = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(
        ml_dtypes.bfloat16)
    return x[np.isfinite(x.astype(np.float32))]


@pytest.mark.parametrize("name", ["gelu", "logistic", "silu"])
def test_bf16_activations_bit_equal_to_jax(name):
    jf = {"gelu": jax.nn.gelu, "logistic": jax.nn.sigmoid,
          "silu": jax.nn.silu}[name]
    x = _all_bf16()
    want = np.asarray(jax.jit(jf)(jnp.asarray(x))).astype(np.float32)
    xt = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    got = getattr(mlp, name)(xt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    # XLA flushes subnormals to zero (inputs, intermediates and results):
    # where one arises JAX gives 0 and the port a value below 1e-36, the
    # only differences allowed (0.8% of the bf16 grid for gelu and silu)
    flushed = (want == 0) & (np.abs(got) < 1e-36)
    assert (same | flushed).all(), (name, int((~same & ~flushed).sum()))
    assert np.mean(~same) <= 0.008, np.mean(~same)


def test_f32_softplus_within_four_ulp():
    x = (np.random.RandomState(0).randn(100_000) * 6).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    got = mlp.softplus(t(x)).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= 4 * ulp).all()      # measured: 3 ulp


def test_gelu_mlp_branch_rounds_as_jax_in_bf16():
    """``mlp``'s gelu branch on bf16 activations (float weights): equal to
    JAX's but for the matmul's sum order."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 32).astype(ml_dtypes.bfloat16)
    p = {"up": {"w": (rng.randn(32, 64) * 0.2).astype(ml_dtypes.bfloat16)},
         "down": {"w": (rng.randn(64, 32) * 0.2).astype(ml_dtypes.bfloat16)}}
    want = jmlp.mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, p), None,
                    act="gelu")
    got = mlp.mlp(interop.to_torch(x, "cpu"), interop.to_torch(p, "cpu"),
                  None, act="gelu")
    assert got.dtype == torch.bfloat16
    assert rel(got.float(), np.asarray(want, np.float32)) <= 1e-2


# ---------------------------------------------------------------------------
# RG-LRU and SSD functions
# ---------------------------------------------------------------------------

def _gates(rng, *shape):
    return (1 / (1 + np.exp(-rng.randn(*shape)))).astype(np.float32)


@pytest.mark.parametrize("s", [1, 2, 7, 24, 33])
def test_rglru_scan_matches_jax(s):
    rng = np.random.RandomState(s)
    x = rng.randn(2, s, 16).astype(np.float32)
    r, i = _gates(rng, 2, s, 16), _gates(rng, 2, s, 16)
    lam = np.linspace(0.5, 4.0, 16).astype(np.float32)
    wh, wlast = jax.jit(jrglru.rglru_scan)(*map(jnp.asarray, (x, r, i, lam)))
    gh, glast = rglru.rglru_scan(*map(t, (x, r, i, lam)))
    assert gh.shape == (2, s, 16) and glast.dtype == torch.float32
    assert rel(gh, wh) <= FN_TOL and rel(glast, wlast) <= FN_TOL


def test_rglru_scan_keeps_bf16_inputs_in_f32():
    rng = np.random.RandomState(3)
    x = rng.randn(1, 9, 8).astype(ml_dtypes.bfloat16)
    r, i = _gates(rng, 1, 9, 8), _gates(rng, 1, 9, 8)
    lam = np.linspace(0.5, 4.0, 8).astype(np.float32)
    wh, wlast = jax.jit(jrglru.rglru_scan)(*map(jnp.asarray, (x, r, i, lam)))
    gh, glast = rglru.rglru_scan(interop.to_torch(x, "cpu"), t(r), t(i),
                                 t(lam))
    assert gh.dtype == torch.bfloat16 and glast.dtype == torch.float32
    assert rel(glast, wlast) <= FN_TOL
    assert rel(gh.float(), np.asarray(wh, np.float32)) <= 1e-2   # bf16 ulp


def test_rglru_step_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 16).astype(np.float32)
    r, i = _gates(rng, 3, 16), _gates(rng, 3, 16)
    lam = np.linspace(0.5, 4.0, 16).astype(np.float32)
    h0 = rng.randn(3, 16).astype(np.float32)
    wy, wh = jax.jit(jrglru.rglru_step)(*map(jnp.asarray,
                                             (x, r, i, lam, h0)))
    gy, gh = rglru.rglru_step(*map(t, (x, r, i, lam, h0)))
    assert rel(gy, wy) <= FN_TOL and rel(gh, wh) <= FN_TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_temporal_conv_matches_jax(with_state):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 16).astype(np.float32)
    w = rng.randn(rglru.CONV_WIDTH, 16).astype(np.float32)
    args = [x, w] + ([rng.randn(2, 3, 16).astype(np.float32)]
                     if with_state else [])
    eager = jrglru.temporal_conv(*map(jnp.asarray, args))
    jitted = jax.jit(jrglru.temporal_conv)(*map(jnp.asarray, args))
    y, st = rglru.temporal_conv(*map(t, args))
    np.testing.assert_array_equal(y.numpy(), np.asarray(eager[0]))
    assert rel(y, jitted[0]) <= FN_TOL
    assert st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(jitted[1]))


def _ssd_inputs(rng, s, b=2, h=4, p=8, g=2, n=6):
    return (rng.randn(b, s, h, p).astype(np.float32),
            (np.abs(rng.randn(b, s, h)) * 0.5).astype(np.float32),
            -np.exp(rng.randn(h)).astype(np.float32),
            rng.randn(b, s, g, n).astype(np.float32),
            rng.randn(b, s, g, n).astype(np.float32))


# S 16 in two chunks of 8; S 12 and 7 are not multiples of 8 (chunks of 6
# and 7); with and without a carried-in state
@pytest.mark.parametrize("s", [16, 12, 7])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(s, with_h0):
    rng = np.random.RandomState(s + 10 * with_h0)
    args = _ssd_inputs(rng, s)
    h0 = rng.randn(2, 4, 8, 6).astype(np.float32) if with_h0 else None

    def jf(*a):
        return jssd.ssd_chunked(*a, jssd.SSDConfig(chunk=8),
                                h0=None if h0 is None else jnp.asarray(h0))

    wy, wh = jax.jit(jf)(*map(jnp.asarray, args))
    gy, gh = ssd.ssd_chunked(*map(t, args), ssd.SSDConfig(chunk=8),
                             h0=None if h0 is None else t(h0))
    assert gy.shape == (2, s, 4, 8) and gh.shape == (2, 4, 8, 6)
    assert rel(gy, wy) <= FN_TOL and rel(gh, wh) <= FN_TOL


def test_ssd_step_matches_jax():
    rng = np.random.RandomState(6)
    x, dt, A, B, C = (a[:, 0] if a.ndim > 1 else a
                      for a in _ssd_inputs(rng, 1))
    h0 = rng.randn(2, 4, 8, 6).astype(np.float32)
    wy, wh = jax.jit(jssd.ssd_step)(*map(jnp.asarray, (x, dt, A, B, C, h0)))
    gy, gh = ssd.ssd_step(*map(t, (x, dt, A, B, C, h0)))
    assert rel(gy, wy) <= FN_TOL and rel(gh, wh) <= FN_TOL


def _jq(w_bits, kv_bits=8):
    return JQuantConfig(w_bits=w_bits, a_bits=8, attn_bits=7,
                        kv_bits=kv_bits, mode="int")


def _q(w_bits, backend, kv_bits=8):
    return QuantConfig(w_bits=w_bits, a_bits=8, attn_bits=7, kv_bits=kv_bits,
                       mode="int", backend=backend)


@pytest.mark.parametrize("kind", ["rglru", "ssd"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_block_prefill_then_decode_tracks_jax(kind, backend):
    """One int block (w4): prefill from no state, then two decode steps on
    the carried state, outputs and states against JAX's."""
    rng = np.random.RandomState(7)
    d = 32
    key = jax.random.PRNGKey(1)
    scfg = jssd.SSDConfig(d_state=8, head_dim=8, expand=2, chunk=4)
    if kind == "rglru":
        fp = jrglru.init_rglru(key, d, 48, jnp.float32)
        jblock = lambda x, p, st: jrglru.rglru_block(x, p, _jq(4), state=st)
        tblock = lambda x, p, st: rglru.rglru_block(x, p, _q(4, backend),
                                                    state=st)
    else:
        fp = jssd.init_ssd(key, d, scfg, jnp.float32)
        jblock = lambda x, p, st: jssd.ssd_block(x, p, scfg, _jq(4), state=st)
        tcfg = ssd.SSDConfig(**dataclasses.asdict(scfg))
        tblock = lambda x, p, st: ssd.ssd_block(x, p, tcfg, _q(4, backend),
                                                state=st)
    jp = j_integerize(fp, _jq(4))
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    xs = [rng.randn(2, 12, d).astype(np.float32)] + \
        [rng.randn(2, 1, d).astype(np.float32) for _ in range(2)]
    jstate = tstate = None
    with jdispatch.use_backend("xla"), dispatch.use_backend(backend):
        for x in xs:
            wy, jstate = jax.jit(jblock)(jnp.asarray(x), jp, jstate)
            gy, tstate = tblock(t(x), tp, tstate)
            assert rel(gy, wy) <= FLIP_TOL
            for k, v in jstate.items():
                assert tstate[k].shape == v.shape, k
                assert rel(tstate[k], v) <= STATE_TOL, k
    assert dispatch.STATS[f"qlinear_{backend}"] > 0


# ---------------------------------------------------------------------------
# The SMOKE models
# ---------------------------------------------------------------------------

_FLOAT, _INT, _JAX_FNS = {}, {}, {}


def _float_params(arch):
    if arch not in _FLOAT:
        cfg = jreg.smoke_config(arch)
        _FLOAT[arch] = jax.jit(lambda k: jlm.init_params(k, cfg))(
            jax.random.PRNGKey(0))
    return _FLOAT[arch]


def _models(arch, w_bits):
    if (arch, w_bits) not in _INT:
        jp = j_integerize(_float_params(arch), _jq(w_bits))
        _INT[arch, w_bits] = (jp, interop.to_torch(jax.tree.map(np.asarray,
                                                                jp), "cpu"))
    jp, tp = _INT[arch, w_bits]
    jcfg = jreg.smoke_config(arch).replace(quant=_jq(w_bits))
    ports = {b: registry.smoke_config(arch).replace(quant=_q(w_bits, b))
             for b in ("torch", "cuda")}
    return jcfg, jp, ports, tp


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_is_the_reference_s(arch):
    for want, got in ((jreg.smoke_config(arch), registry.smoke_config(arch)),
                      (jreg.get_config(arch), registry.get_config(arch))):
        for f in dataclasses.fields(got):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if f.name in ("moe", "ssd") and w is not None:
                w, g = dataclasses.asdict(w), dataclasses.asdict(g)
            assert g == w, f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_integerized_tree_leaf_for_leaf(arch):
    fp = _float_params(arch)
    want = dict(_leaves(jax.tree.map(np.asarray, j_integerize(fp, _jq(4)))))
    tree = integerize_params(interop.to_torch(jax.tree.map(np.asarray, fp),
                                              "cpu"),
                             QuantConfig(w_bits=4, mode="int"))
    got = dict(_leaves(interop.to_numpy(tree)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_array_equal(got[path], w.astype(got[path].dtype),
                                      err_msg=path)
    if arch == "recurrentgemma-9b":       # the gates stay float
        assert got["/units/b0/rglru/w_a/w"].dtype == np.float32
        assert got["/units/b0/rglru/w_in/w_q"].dtype == np.int8


def _jax_ring(jcfg, jp, toks):
    """JAX ring prefill (max_len 20: the local ring wraps) + STEPS greedy
    decode steps on the XLA path: logits per step, the tokens fed, the
    final cache."""
    if jcfg not in _JAX_FNS:
        _JAX_FNS[jcfg] = (
            jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, max_len=20)),
            jax.jit(lambda p, t_, c: jlm.decode_step(p, t_, c, jcfg)))
    prefill, decode = _JAX_FNS[jcfg]
    with jdispatch.use_backend("xla"):
        lj, jc = prefill(jp, {"tokens": jnp.asarray(toks)})
        logits, fed = [np.asarray(lj)], []
        for _ in range(STEPS):
            fed.append(np.asarray(jnp.argmax(lj, -1), np.int32))
            lj, jc = decode(jp, jnp.asarray(fed[-1]), jc)
            logits.append(np.asarray(lj))
    return logits, fed, jax.tree.map(np.asarray, jc)


@pytest.mark.parametrize("arch,w_bits", [("recurrentgemma-9b", 4),
                                         ("mamba2-130m", 4),
                                         ("mamba2-130m", 8)])
def test_ring_prefill_and_decode_track_jax(arch, w_bits):
    """24-token prompts (three SSD chunks of 8; RecurrentGemma's 20-slot
    local ring wraps at prefill), then STEPS decode steps teacher-forced
    with JAX's tokens, on both port backends; the cache's recurrent states
    and ring codes against JAX's after the last step."""
    jcfg, jp, ports, tp = _models(arch, w_bits)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab,
                                            (2, 24)).astype(np.int32)
    want, fed, jcache = _jax_ring(jcfg, jp, toks)
    tight = steps = 0
    for backend, cfg in ports.items():
        dispatch.reset_stats()
        with dispatch.use_backend(backend):
            lt, cache = lm.prefill(tp, {"tokens": t(toks)}, cfg, max_len=20)
            got = [lt.numpy()]
            for tok in fed:
                lt, cache = lm.decode_step(tp, t(tok), cache, cfg)
                got.append(lt.numpy())
        assert dispatch.STATS[f"qlinear_{backend}"] > 0
        other = "torch" if backend == "cuda" else "cuda"
        assert dispatch.STATS[f"qlinear_{other}"] == 0
        assert int(cache["pos"]) == 24 + STEPS
        for g, w in zip(got, want):
            r = rel(g, w)
            assert r <= FLIP_TOL, (backend, r)
            tight += int(r <= TOL)
            steps += 1
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
        gcache = dict(_leaves(interop.to_numpy(cache)))
        for path, w in _leaves(jcache):
            g = gcache[path]
            assert g.shape == w.shape and g.dtype == w.dtype, path
            if g.dtype == np.int8:          # ring codes: a flip is 1 step
                assert np.mean(g != w) <= 0.01, path
                assert np.abs(g.astype(int) - w).max() <= 1, path
            else:
                assert rel(g, w) <= STATE_TOL, path
    assert tight >= steps / 2, (tight, steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_route_equals_torch_backend_on_the_cpu(arch):
    """On CPU tensors the kernel route runs the kernels' plain versions:
    the two backends give the same bits."""
    _, _, ports, tp = _models(arch, 4)
    toks = t(np.random.RandomState(1).randint(0, 512, (2, 17)).astype(
        np.int32))
    out = {}
    for backend, cfg in ports.items():
        lt, cache = lm.prefill(tp, {"tokens": toks}, cfg, max_len=20)
        l2, cache = lm.decode_step(tp, torch.argmax(lt, -1).to(torch.int32),
                                   cache, cfg)
        out[backend] = (lt, l2, interop.to_numpy(cache))
    assert torch.equal(out["torch"][0], out["cuda"][0])
    assert torch.equal(out["torch"][1], out["cuda"][1])
    want = dict(_leaves(out["torch"][2]))
    for path, g in _leaves(out["cuda"][2]):
        np.testing.assert_array_equal(g, want[path], err_msg=path)


def test_local_attention_ring_span_and_recurrent_state_shapes():
    """RecurrentGemma's cache: the local ring holds min(max_len, window +
    q_chunk) slots; the RG-LRU layers keep (B, d_rnn) and (B, 3, d_rnn) f32
    states, Mamba's (B, H, P, N) and (B, 3, d_conv); all like JAX's."""
    for arch, max_len in (("recurrentgemma-9b", 64), ("mamba2-130m", 64)):
        jcfg, _, ports, _ = _models(arch, 4)
        want = dict(_leaves(jax.eval_shape(
            lambda: jlm.init_cache(jcfg, 3, max_len))))
        got = dict(_leaves(lm.init_cache(ports["torch"], 3, max_len,
                                         device="cpu")))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            assert tuple(got[path].shape) == w.shape, path
            assert str(got[path].dtype).split(".")[1] == str(w.dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_ring_cache_carried_over_decodes_like_jax(arch):
    """JAX's prefill cache, recurrent states and the local ring included,
    carried over by ``interop`` (shapes kept) decodes in the port as in
    JAX; the states it writes track JAX's."""
    jcfg, jp, ports, tp = _models(arch, 4)
    toks = np.random.RandomState(2).randint(0, jcfg.vocab,
                                            (2, 24)).astype(np.int32)
    if jcfg not in _JAX_FNS:
        _jax_ring(jcfg, jp, toks)
    prefill, decode = _JAX_FNS[jcfg]
    with jdispatch.use_backend("xla"):
        lj, jc = prefill(jp, {"tokens": jnp.asarray(toks)})
        tok = jnp.argmax(lj, -1).astype(jnp.int32)
        start = jax.tree.map(np.asarray, jc)
        lj2, jc2 = decode(jp, tok, jc)
    cache = interop.to_torch(start, "cpu")
    with dispatch.use_backend("torch"):
        lt, cache = lm.decode_step(tp, t(np.asarray(tok)), cache,
                                   ports["torch"])
    assert rel(lt.numpy(), lj2) <= FLIP_TOL
    np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                  np.asarray(lj2).argmax(-1))
    got = dict(_leaves(interop.to_numpy(cache)))
    for path, w in _leaves(jax.tree.map(np.asarray, jc2)):
        assert got[path].shape == w.shape, path
        if w.dtype == np.float32:
            assert rel(got[path], w) <= STATE_TOL, path
