"""The port's ring-cache generation path held against the JAX package.

- The ring decode kernel's plain version against the reference's Pallas
  kernel (interpret mode) and its ``ref.int_decode_attention_ref`` oracle,
  on streamed (bk < span) and one-block grids, kv8 and packed kv4, partly
  written, wrapped and windowed rings.  Outputs to 2e-6 of their max
  (Sigma is an f32 sum over a block taken in another order).
- ``decode_blocks`` / ``decode_supported``: the reference's decisions.
- The ring writes on the SAME bf16 keys/values, with decode keys beyond
  the prefill scale: codes and scales EQUAL to the reference's arithmetic
  (XLA divides bf16 by a 0-d f32 scale in f32 and saturates its int8
  conversion; torch would divide in bf16 and wrap).
- ``prefill`` + 8 ``decode_step``s at SMOKE width (f32) with a wrapped
  ring and a ``local`` layer, kv 8 and 4, both port backends, against the
  JAX model's XLA path under the flip-aware rules of
  ``tests/test_torch_lm.py`` (its docstring): logits within FLIP_TOL every
  step and within 1e-6 in most, greedy tokens equal where JAX's top-2
  margin is clear, ring codes equal but for 1%, scales within 1e-2.
- The ``cuda`` route (the kernels' plain versions on the CPU) equals the
  ``torch`` backend bitwise on the ring path (bk >= span), a JAX ring
  cache carried over by ``interop`` decodes like JAX, ``count_params`` /
  ``model_bytes`` equal the reference's, and the quickstart runs on the
  CPU.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import count_params as j_count_params
from repro.core.api import integerize_params as j_integerize
from repro.core.api import model_bytes as j_model_bytes
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.kernels.int_attention import int_decode_attention as j_decode
from repro.layers import attention as jattn
from repro.models import lm as jlm
from repro_torch import interop
from repro_torch.core import api, quant
from repro_torch.core.api import QuantConfig
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import int_attention as ia
from repro_torch.layers import attention as tattn
from repro_torch.models import lm

torch.set_num_threads(1)

TOL = 1e-6
ATTN_TOL = 2e-6
FLIP_TOL = 0.1          # a few one-step code flips at SMOKE width (FMA)


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


def ring_positions(pos, span):
    """The reference's slot -> position map of a ring written up to pos."""
    slot = pos % span
    return (pos - np.mod(slot - np.arange(span), span)).astype(np.int32)


# ---------------------------------------------------------------------------
# The kernel's plain version
# ---------------------------------------------------------------------------

# (kv_bits, span, bk, pos, window, attn_bits): bk >= span is one block
# (= the full-row grid); bk < span streams 3 blocks, some of them dead.
RING_CASES = [(8, 100, 128, 40, None, 7),        # partly written
              (4, 100, 128, 250, None, 7),       # wrapped
              (8, 300, 128, 170, None, 7),       # streamed, dead last block
              (4, 300, 128, 1000, None, 8),      # streamed, wrapped
              (8, 300, 128, 700, 90, 7),         # streamed, windowed
              (4, 256, 256, 500, 40, 7)]         # windowed, one block


@pytest.mark.parametrize("kv_bits,span,bk,pos,window,bits", RING_CASES)
def test_ring_decode_plain_matches_pallas_and_ref(kv_bits, span, bk, pos,
                                                  window, bits):
    h, g, d = 4, 3, 16
    rng = np.random.RandomState(span + pos)
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    q = rng.randint(-127, 128, (h, g, d)).astype(np.int8)
    k = rng.randint(lo, hi, (h, span, d)).astype(np.int8)
    v = rng.randint(lo, hi, (h, span, d)).astype(np.int8)
    kpos = ring_positions(pos, span)
    sc = rng.uniform(0.002, 0.01, h).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, h).astype(np.float32)
    packed = kv_bits == 4
    J = jnp.asarray
    kj = jquant.pack_int4(J(k)) if packed else J(k)
    vj = jquant.pack_int4(J(v)) if packed else J(v)
    kw = dict(attn_bits=bits, causal=True, window=window)
    want = j_decode(J(q), kj, vj, J(sc), J(vs), J(kpos), J(np.int32(pos)),
                    bk=bk, packed=packed, interpret=True, **kw)
    oracle = jref.int_decode_attention_ref(J(q), J(k), J(v), J(sc), J(vs),
                                           J(kpos), pos, bk=bk, **kw)
    before = dict(ia.LAUNCHES)
    got, codes = ia.int_decode_attention(
        t(q), t(np.asarray(kj)), t(np.asarray(vj)), t(sc), t(vs), t(kpos),
        torch.tensor(pos, dtype=torch.int32), bk=bk, packed=packed,
        return_codes=True, **kw)
    assert ia.LAUNCHES == before                     # CPU: plain version
    close(got.numpy(), want)
    close(got.numpy(), oracle)
    live = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        live &= kpos > pos - window
    assert codes.shape == (h, g, span) and codes.dtype == torch.uint8
    assert codes.numpy()[:, :, ~live].max(initial=0) == 0   # dead: code 0
    assert int(codes.max()) <= (1 << bits) - 1
    # the full-row grid, against the reference's full-row oracle
    full = ref.int_decode_attention_ref(t(q), t(k), t(v), t(sc), t(vs),
                                        t(kpos), pos, bk=None, **kw)
    close(full.numpy(), jref.int_decode_attention_ref(
        J(q), J(k), J(v), J(sc), J(vs), J(kpos), pos, bk=None, **kw))
    if bk >= span:                                   # one block IS the row
        close(got.numpy(), full.numpy(), tol=TOL)


def test_decode_blocks_match_the_reference():
    for span in (1, 100, 128, 129, 1000, 1024, 4096, 4097, 8192, 20000):
        for d in (16, 128, 1024):
            assert dispatch.decode_blocks(span, d) == \
                jdispatch.decode_blocks(span, d), (span, d)
    assert dispatch.decode_blocks(1024, 128) == 1024
    assert dispatch.decode_blocks(8192, 128) == 4096


# (name, q shape (B, Hq, Sq, D), k heads, k_positions ndim, packed, cfg kw)
SUPPORT_CASES = [
    ("decode", (2, 4, 1, 16), 2, 1, None, {}),
    ("packed int4", (2, 4, 1, 16), 2, 1, 4, {}),
    ("packed, not 4-bit", (2, 4, 1, 16), 2, 1, 8, {}),
    ("no k_positions", (2, 4, 1, 16), 2, None, None, {}),
    ("2-D k_positions", (2, 4, 1, 16), 2, 2, None, {}),
    ("Sq > 1", (2, 4, 2, 16), 2, 1, None, {}),
    ("Hq % Hkv", (2, 3, 1, 16), 2, 1, None, {}),
    # D 12: rows neither 8- nor 16-byte aligned; the card's kernel takes
    # it with byte loads
    ("D % 8 != 0", (2, 4, 1, 12), 2, 1, None, {}),
    ("9-bit probs", (2, 4, 1, 16), 2, 1, None, {"attn_bits": 9}),
    ("exact softmax", (2, 4, 1, 16), 2, 1, None, {"softmax": "exact"}),
]


@pytest.mark.parametrize("name,qshape,hkv,kp_ndim,packed_bits,cfg_kw",
                         SUPPORT_CASES, ids=[c[0] for c in SUPPORT_CASES])
def test_decode_supported_matches_the_reference(name, qshape, hkv, kp_ndim,
                                                packed_bits, cfg_kw):
    b, _, _, d = qshape
    span = 40
    q = np.zeros(qshape, np.float32)
    if packed_bits:
        codes = np.zeros((b, hkv, span, d // 2), np.uint8)
        kj = jquant.QTensor(jnp.asarray(codes), jnp.float32(1), packed_bits)
        kt = quant.QTensor(t(codes), torch.tensor(1.0), packed_bits)
    else:
        kj = kt = None
        k = np.zeros((b, hkv, span, d), np.float32)
    kpos = None if kp_ndim is None else \
        np.zeros((span,) if kp_ndim == 1 else (1, span), np.int32)
    want = jdispatch.decode_supported(
        jnp.asarray(q), kj if packed_bits else jnp.asarray(k),
        jattn.AttnSpec(), JQuantConfig(mode="int", **cfg_kw),
        None if kpos is None else jnp.asarray(kpos))
    got = dispatch.decode_supported(
        t(q), kt if packed_bits else t(k), tattn.AttnSpec(),
        QuantConfig(mode="int", **cfg_kw), None if kpos is None else t(kpos))
    assert got == want


# ---------------------------------------------------------------------------
# Ring writes: the two numeric traps
# ---------------------------------------------------------------------------

def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _to_t(a_bf16):
    return interop.to_torch(a_bf16, "cpu")


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("s_in", [13, 6])            # rolled / zero-padded
def test_ring_writes_match_reference_arithmetic_on_bf16(kv_bits, s_in):
    """Prefill write then decode writes, on the same bf16 k/v as the
    reference's expressions (models/lm.py ring branches), with decode keys
    up to 4x beyond the prefill-calibrated scale: codes, scales and slot
    positions EQUAL."""
    b, h, span, d = 2, 2, 10, 16
    rng = np.random.RandomState(kv_bits * 100 + s_in)
    k = _bf16(rng.randn(b, h, s_in, d) * 3)
    v = _bf16(rng.randn(b, h, s_in, d))
    kv4 = kv_bits == 4
    qt = QuantConfig(kv_bits=kv_bits, mode="int")
    cache = lm._attn_cache(lm.LMConfig(name="t", n_layers=1, d_model=32,
                                       n_heads=2, kv_heads=h, d_ff=0,
                                       vocab=8, head_dim=d, quant=qt),
                           b, span, (), "cpu")
    lm._ring_write_prefill(cache, _to_t(k), _to_t(v), "int", qt)

    # the reference's prefill arithmetic (models/lm.py:533-566)
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    if s_in >= span:
        shift = (s_in - span) % span
        ks_ = jnp.roll(kj[:, :, -span:], shift, axis=2)
        vs_ = jnp.roll(vj[:, :, -span:], shift, axis=2)
    else:
        pad = [(0, 0), (0, 0), (0, span - s_in), (0, 0)]
        ks_, vs_ = jnp.pad(kj, pad), jnp.pad(vj, pad)
    qmax = 7. if kv4 else 127.
    ksc = jnp.max(jnp.abs(ks_)).astype(jnp.float32) / qmax
    vsc = jnp.max(jnp.abs(vs_)).astype(jnp.float32) / qmax
    if kv4:
        ring_k = jquant.pack_int4(
            jnp.clip(jnp.round(ks_ / ksc), -8, 7).astype(jnp.int8))
        ring_v = jquant.pack_int4(
            jnp.clip(jnp.round(vs_ / vsc), -8, 7).astype(jnp.int8))
    else:
        ring_k = jnp.round(ks_ / ksc).astype(jnp.int8)
        ring_v = jnp.round(vs_ / vsc).astype(jnp.int8)
    np.testing.assert_array_equal(cache["k"].numpy(), np.asarray(ring_k))
    np.testing.assert_array_equal(cache["v"].numpy(), np.asarray(ring_v))
    assert cache["k_scale"].shape == () and \
        cache["k_scale"].item() == float(ksc)
    assert cache["v_scale"].item() == float(vsc)

    # decode writes (models/lm.py:492-532), keys beyond the prefill scale
    for step, pos in enumerate((s_in, s_in + 7, 3 * span + 1)):
        k1 = _bf16(rng.randn(b, h, 1, d) * (1 + step) * 4)
        v1 = _bf16(rng.randn(b, h, 1, d) * 4)
        if not kv4:
            assert (np.abs(np.asarray(k1, np.float32) / float(ksc))
                    > 127.5).any()                   # saturation is tested
        kpos = lm._ring_write_decode(cache, _to_t(k1[:, :, 0]),
                                     _to_t(v1[:, :, 0]),
                                     torch.tensor(pos, dtype=torch.int32),
                                     "int")
        slot = pos % span
        k1j, v1j = jnp.asarray(k1), jnp.asarray(v1)
        if kv4:
            kq = jquant.pack_int4(jnp.squeeze(jnp.clip(
                jnp.round(k1j / ksc), -8, 7).astype(jnp.int8), 2))
            vq = jquant.pack_int4(jnp.squeeze(jnp.clip(
                jnp.round(v1j / vsc), -8, 7).astype(jnp.int8), 2))
        else:
            kq = jnp.squeeze(jnp.round(k1j / ksc).astype(jnp.int8), 2)
            vq = jnp.squeeze(jnp.round(v1j / vsc).astype(jnp.int8), 2)
        ring_k = jax.lax.dynamic_update_index_in_dim(ring_k, kq, slot, 2)
        ring_v = jax.lax.dynamic_update_index_in_dim(ring_v, vq, slot, 2)
        np.testing.assert_array_equal(cache["k"].numpy(), np.asarray(ring_k))
        np.testing.assert_array_equal(cache["v"].numpy(), np.asarray(ring_v))
        jpos = jnp.int32(pos)
        want_kpos = jpos - jnp.mod(jnp.int32(slot) - jnp.arange(span), span)
        np.testing.assert_array_equal(kpos.numpy(), np.asarray(want_kpos))


# ---------------------------------------------------------------------------
# The model: prefill + decode_step over wrapped and windowed rings
# ---------------------------------------------------------------------------

DIMS = dict(n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=96,
            vocab=64, dtype="float32", q_chunk=4, qkv_bias=True,
            block_pattern=("attn", "local"), attn_window=6)
PROMPT, MAX_LEN, STEPS = 12, 16, 8     # global ring 16 wraps; local ring 10


_JAX = {}


def _jax_params():
    """Float and integerized JAX parameters (the same for any kv_bits)."""
    if "params" not in _JAX:
        jcfg = jlm.LMConfig(name="t", remat=False, **DIMS)
        qj = JQuantConfig(w_bits=4, a_bits=8, attn_bits=7, mode="int")
        fp = jax.jit(lambda key: jlm.init_params(key, jcfg))(
            jax.random.PRNGKey(0))
        _JAX["params"] = (fp, j_integerize(fp, qj))
    return _JAX["params"]


def _jax_model(kv_bits):
    qj = JQuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=kv_bits,
                      mode="int")
    return jlm.LMConfig(name="t", remat=False, quant=qj, **DIMS), \
        _jax_params()[1]


def _port(jp, kv_bits, backend):
    qt = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=kv_bits,
                     mode="int", backend=backend)
    return (lm.LMConfig(name="t", quant=qt, **DIMS),
            interop.to_torch(jax.tree.map(np.asarray, jp), "cpu"))


def _jax_fns(jcfg):
    """Jitted JAX ring prefill / decode for one config (traced once)."""
    if jcfg not in _JAX:
        _JAX[jcfg] = (
            jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, max_len=MAX_LEN)),
            jax.jit(lambda p, tk, c: jlm.decode_step(p, tk, c, jcfg)))
    return _JAX[jcfg]


def _run_jax(jcfg, jp, toks, steps):
    """JAX prefill + ``steps`` greedy decode steps on the XLA path: logits
    per step, the tokens fed, the prefill cache and the final cache."""
    prefill, decode = _jax_fns(jcfg)
    with jdispatch.use_backend("xla"):
        lj, jc = prefill(jp, {"tokens": jnp.asarray(toks)})
        first = jax.tree.map(np.asarray, jc)
        logits, fed = [np.asarray(lj)], []
        for _ in range(steps):
            fed.append(np.asarray(jnp.argmax(logits[-1], -1), np.int32))
            lj, jc = decode(jp, jnp.asarray(fed[-1]), jc)
            logits.append(np.asarray(lj))
    return logits, fed, first, jax.tree.map(np.asarray, jc)


def _run_port(cfg, params, toks, fed, cache=None):
    """Prefill (unless a cache is given), then teacher-forced decode."""
    logits = []
    if cache is None:
        lt, cache = lm.prefill(params, {"tokens": torch.from_numpy(toks)},
                               cfg, max_len=MAX_LEN)
        logits.append(lt.numpy())
    for tok in fed:
        lt, cache = lm.decode_step(params, torch.from_numpy(tok.copy()),
                                   cache, cfg)
        logits.append(lt.numpy())
    return logits, interop.to_numpy(cache)


def _hold(got_logits, want_logits, got_cache, want_cache, stats):
    """Flip-aware rules of tests/test_torch_lm.py, on a ring cache."""
    for gl, wl in zip(got_logits, want_logits):
        err = np.abs(gl - wl).max(axis=-1)                  # per row
        rel = err.max() / np.abs(wl).max()
        assert rel <= FLIP_TOL, rel
        stats["tight"] += int(rel <= TOL)
        stats["steps"] += 1
        top2 = np.sort(wl[:, 0], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * err[:, 0]
        np.testing.assert_array_equal(gl[:, 0].argmax(-1)[clear],
                                      wl[:, 0].argmax(-1)[clear])
    np.testing.assert_array_equal(got_cache["pos"], want_cache["pos"])
    assert got_cache["pos"].shape == ()
    for blk in ("b0", "b1"):
        g, w = got_cache["units"][blk], want_cache["units"][blk]
        for key in ("k", "v"):
            assert g[key].shape == w[key].shape
            assert g[key].dtype == w[key].dtype
            assert (g[key] != w[key]).mean() <= 1e-2
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-2)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_ring_prefill_and_decode_track_jax(kv_bits):
    """Two seeds, both port backends, against the JAX model's XLA path.
    The cuda route decodes on the ring kernel's plain version (counted as
    such, no launch on the CPU) and equals the torch backend bitwise."""
    jcfg, jp = _jax_model(kv_bits)
    ports = {b: _port(jp, kv_bits, b) for b in ("torch", "cuda")}
    stats = dict(tight=0, steps=0)
    for seed in range(2):
        toks = np.random.RandomState(seed).randint(0, 64, (3, PROMPT)) \
            .astype(np.int32)
        want, fed, _, wcache = _run_jax(jcfg, jp, toks, STEPS)
        got = {}
        for backend, (cfg, params) in ports.items():
            dispatch.reset_stats()
            before = dict(ia.LAUNCHES)
            got[backend], gcache = _run_port(cfg, params, toks, fed)
            _hold(got[backend], want, gcache, wcache, stats)
            assert int(gcache["pos"]) == PROMPT + STEPS
            assert ia.LAUNCHES == before
            n_dec = cfg.n_layers * STEPS
            if backend == "cuda":
                assert dispatch.STATS["attention_decode_cuda"] == n_dec
                assert dispatch.STATS["attention_decode_torch"] == 0
                assert dispatch.STATS["attention_cuda"] == cfg.n_layers
            else:
                assert dispatch.STATS["attention_decode_torch"] == n_dec
                assert dispatch.STATS["attention_decode_cuda"] == 0
        for a, b in zip(got["cuda"], got["torch"]):
            np.testing.assert_array_equal(a, b)
    assert stats["tight"] >= 0.5 * stats["steps"], stats


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_cuda_route_equals_torch_backend_on_ring_decode(kv_bits):
    """attention() on a ring QTensor (packed at kv 4): the cuda route (the
    kernel's plain version at bk = decode_blocks >= span) and the plain
    torch path give the same bits; both against JAX's XLA path."""
    rng = np.random.RandomState(kv_bits)
    b, hq, hkv, span, d, pos = 2, 4, 2, 200, 16, 350
    lo, hi = (-8, 8) if kv_bits == 4 else (-127, 128)
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    kc = rng.randint(lo, hi, (b, hkv, span, d)).astype(np.int8)
    vc = rng.randint(lo, hi, (b, hkv, span, d)).astype(np.int8)
    if kv_bits == 4:
        kc = np.asarray(jquant.pack_int4(jnp.asarray(kc)))
        vc = np.asarray(jquant.pack_int4(jnp.asarray(vc)))
    kpos = ring_positions(pos, span)
    ks, vs = np.float32(0.031), np.float32(0.017)
    spec_t = tattn.AttnSpec(window=120)
    outs = {}
    for backend in ("cuda", "torch"):
        qt = QuantConfig(a_bits=8, attn_bits=7, kv_bits=kv_bits, mode="int",
                         backend=backend)
        outs[backend] = tattn.attention(
            t(q), quant.QTensor(t(kc), torch.tensor(ks), kv_bits),
            quant.QTensor(t(vc), torch.tensor(vs), kv_bits), spec_t, qt,
            q_offset=torch.tensor(pos, dtype=torch.int32),
            k_positions=t(kpos)).numpy()
    assert dispatch.STATS["attention_decode_cuda"] >= 1
    np.testing.assert_array_equal(outs["cuda"], outs["torch"])
    qj = JQuantConfig(a_bits=8, attn_bits=7, kv_bits=kv_bits, mode="int")
    with jdispatch.use_backend("xla"):
        want = jattn.attention(
            jnp.asarray(q), jquant.QTensor(jnp.asarray(kc), jnp.float32(ks),
                                           kv_bits),
            jquant.QTensor(jnp.asarray(vc), jnp.float32(vs), kv_bits),
            jattn.AttnSpec(window=120), qj, q_offset=jnp.int32(pos),
            k_positions=jnp.asarray(kpos))
    close(outs["cuda"], np.asarray(want))


def test_interop_carries_a_jax_ring_cache():
    """A ring cache made by JAX's prefill (kv4: packed codes, 0-d scales
    and pos) crosses over as numpy and decodes in the port like in JAX."""
    jcfg, jp = _jax_model(4)
    cfg, params = _port(jp, 4, "cuda")
    toks = np.random.RandomState(7).randint(0, 64, (2, PROMPT)) \
        .astype(np.int32)
    want, fed, first, wcache = _run_jax(jcfg, jp, toks, 3)
    cache = interop.to_torch(first, "cpu")
    assert cache["pos"].shape == () and cache["pos"].dtype == torch.int32
    assert cache["units"]["b0"]["k"].dtype == torch.uint8
    assert cache["units"]["b0"]["k_scale"].shape == (1,)   # one unit
    got, gcache = _run_port(cfg, params, toks, fed, cache=cache)
    _hold(got, want[1:], gcache, wcache, dict(tight=0, steps=0))


def test_count_params_and_model_bytes_match_the_reference():
    qj = JQuantConfig(w_bits=4, a_bits=8, attn_bits=7, mode="int")
    fp, ip = _jax_params()
    qt = QuantConfig(w_bits=4, a_bits=8, attn_bits=7, mode="int")
    for tree, jc, tc in ((fp, None, None), (ip, qj, qt)):
        ttree = interop.to_torch(jax.tree.map(np.asarray, tree), "cpu")
        assert api.count_params(ttree) == j_count_params(tree)
        assert api.model_bytes(ttree, tc) == j_model_bytes(tree, jc)


def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for tag in ("[1]", "[2]", "[3]", "[4]"):
        assert tag in text
    assert out["eq_err"] < 1e-5
    assert out["mb_int"] < out["mb_float"] / 3
    assert out["corr"] > 0.95
    assert len(out["tokens_int"]) == len(out["tokens_float"]) == 8
    assert out["kv_dtype"] == "torch.int8"
    assert not any(out["launches"].values())          # CPU: plain versions
