"""Whisper-large-v3's encoder-decoder in the port held against the JAX
package at its SMOKE widths (JAX's weights carried over by ``interop``,
the JAX side on its XLA route), and the port's registry against the
reference's.

Tolerances, and why:

- Logits within FLIP_TOL of their max at every step and within TOL at half
  of them, greedy tokens equal, as ``tests/test_torch_archs.py`` holds them
  (XLA contracts FMAs where the port rounds twice, so an activation code
  can flip at a rounding edge); measured about 2e-7.
- The cache: every int8 code equal (the self-attention ring, the cross
  K/V, decode writes past the prefill scale that saturate); the 0-d scales
  within 2 ulp (under ``jax.jit`` XLA divides by 127 as a multiply by the
  reciprocal, the port divides).
- The encoder states and the sinusoid rows within 1e-6 of their max
  (XLA's sin / cos / pow are its own).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.kernels import dispatch as jdispatch
from repro.models import encdec as jed
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.core.api import QuantConfig, integerize_params
from repro_torch.kernels import dispatch
from repro_torch.layers.embed import embed_lookup
from repro_torch.models import encdec

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
TOL = 1e-6
FLIP_TOL = 0.1
STEPS = 4
PROMPT = 12


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


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


_JQ = JQuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8, mode="int")
_STATE = {}


def _q(backend):
    return QuantConfig(w_bits=4, a_bits=8, attn_bits=7, kv_bits=8,
                       mode="int", backend=backend)


def _models():
    if not _STATE:
        cfg = jreg.smoke_config(ARCH)
        fp = jax.jit(lambda k: jed.init_params(k, cfg))(jax.random.PRNGKey(0))
        jp = j_integerize(fp, _JQ)
        _STATE.update(fp=fp, jp=jp, tp=interop.to_torch(
            jax.tree.map(np.asarray, jp), "cpu"))
    jcfg = jreg.smoke_config(ARCH).replace(quant=_JQ)
    ports = {b: registry.smoke_config(ARCH).replace(quant=_q(b))
             for b in ("torch", "cuda")}
    return jcfg, _STATE["jp"], ports, _STATE["tp"]


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"frames": rng.randn(2, cfg.n_audio_ctx,
                                cfg.d_model).astype(np.float32),
            "tokens": rng.randint(0, cfg.vocab, (2, PROMPT)).astype(np.int32)}


_JAX_FNS = {}


def _jax_run(jcfg, jp, batch, max_len):
    """JAX prefill into a ``max_len``-slot ring + STEPS greedy decode steps
    (XLA path): logits per step, the tokens fed, the cache after prefill
    and after the last step."""
    if max_len not in _JAX_FNS:
        _JAX_FNS[max_len] = (
            jax.jit(lambda p, b: jed.prefill(p, b, jcfg, max_len=max_len)),
            jax.jit(lambda p, t_, c: jed.decode_step(p, t_, c, jcfg)))
    prefill, decode = _JAX_FNS[max_len]
    with jdispatch.use_backend("xla"):
        lj, jc = prefill(jp, jax.tree.map(jnp.asarray, batch))
        caches = [jax.tree.map(np.asarray, jc)]
        logits, fed = [np.asarray(lj)], []
        for _ in range(STEPS):
            fed.append(np.asarray(jnp.argmax(lj, -1), np.int32))
            lj, jc = decode(jp, jnp.asarray(fed[-1]), jc)
            logits.append(np.asarray(lj))
    caches.append(jax.tree.map(np.asarray, jc))
    return logits, fed, caches


def _check_cache(got, want):
    """Codes equal, scales within 2 ulp, ``pos`` equal, shapes and dtypes
    the reference's."""
    got = dict(_leaves(interop.to_numpy(got)))
    want = dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path.endswith("_scale"):
            np.testing.assert_allclose(g, w, rtol=2.5e-7, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def test_smoke_config_is_the_reference_s():
    for want, got in ((jreg.smoke_config(ARCH), registry.smoke_config(ARCH)),
                      (jreg.get_config(ARCH), registry.get_config(ARCH))):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.hd == want.hd


def test_integerized_tree_leaf_for_leaf():
    _models()
    fp = _STATE["fp"]
    want = dict(_leaves(jax.tree.map(np.asarray, j_integerize(fp, _JQ))))
    tree = integerize_params(interop.to_torch(jax.tree.map(np.asarray, fp),
                                              "cpu"), _q("torch"))
    got = dict(_leaves(interop.to_numpy(tree)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_array_equal(got[path], w.astype(got[path].dtype),
                                      err_msg=path)
    assert "/dec_layers/cross_attn/wk/b" not in got      # k unbiased
    assert got["/dec_layers/cross_attn/wv/b"].shape == (2, 64)


def test_init_params_has_the_reference_s_tree():
    cfg = registry.smoke_config(ARCH)
    want = dict(_leaves(jax.eval_shape(
        lambda: jed.init_params(jax.random.PRNGKey(0),
                                jreg.smoke_config(ARCH)))))
    got = dict(_leaves(encdec.init_params(cfg, seed=0, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path


def test_encode_tracks_jax():
    jcfg, jp, ports, tp = _models()
    frames = _batch(jcfg)["frames"]
    with jdispatch.use_backend("xla"):
        want = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(
            jp, jnp.asarray(frames))
    for backend, cfg in ports.items():
        with dispatch.use_backend(backend):
            got = encdec.encode(tp, t(frames), cfg)
        assert rel(got, want) <= FLIP_TOL, backend


def test_decoder_embed_rows_equal_the_table():
    """Only the rows at ``pos`` are computed, each as the reference's table
    row; against JAX's table within 1e-6 (XLA's sin / cos)."""
    jcfg, jp, ports, tp = _models()
    cfg = ports["torch"]
    toks = t(np.array([[3, 5, 7]], np.int32))
    pos0 = torch.tensor(37, dtype=torch.int32)
    got = encdec.decoder_embed(tp, toks, cfg, pos0)
    table = encdec._sinusoid(100, cfg.d_model, "cpu")
    emb = embed_lookup(toks, tp["embed"], cfg.tdtype)
    assert torch.equal(got, emb + table[37:40])
    want = jed.decoder_embed(jp, jnp.asarray(toks.numpy()), jcfg, 37)
    assert rel(got, want) <= TOL
    assert rel(table, jed._sinusoid(100, cfg.d_model)) <= TOL


# max_len 16 above the 12-token prompt (the reference's own smoke test), and
# max_len 12 equal to it, where the first decode step overwrites position 0
# (slot = pos % span), as the reference does
@pytest.mark.parametrize("max_len", [16, PROMPT])
def test_prefill_and_decode_track_jax(max_len):
    jcfg, jp, ports, tp = _models()
    batch = _batch(jcfg)
    want, fed, jcaches = _jax_run(jcfg, jp, batch, max_len)
    tight = steps = 0
    for backend, cfg in ports.items():
        dispatch.reset_stats()
        with dispatch.use_backend(backend):
            lt, cache = encdec.prefill(tp, interop.to_torch(batch, "cpu"),
                                       cfg, max_len=max_len)
            _check_cache(cache, jcaches[0])
            got = [lt.numpy()]
            for tok in fed:
                lt, cache = encdec.decode_step(tp, t(tok), cache, cfg)
                got.append(lt.numpy())
        _check_cache(cache, jcaches[1])
        assert int(cache["pos"]) == PROMPT + STEPS
        assert dispatch.STATS[f"qlinear_{backend}"] > 0
        assert dispatch.STATS[f"attention_decode_{backend}"] == \
            STEPS * cfg.n_dec_layers
        for g, w in zip(got, want):
            r = rel(g, w)
            assert r <= FLIP_TOL, (backend, r)
            tight += int(r <= TOL)
            steps += 1
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    assert tight >= steps / 2, (tight, steps)


def test_decode_writes_saturate_as_jax():
    """JAX's prefill cache carried over by ``interop`` with its ring scales
    shrunk 20x, so a decoded key / value lands far past the int8 range: XLA
    saturates, and the port's codes equal JAX's (torch's cast would wrap);
    the step's logits track JAX's."""
    jcfg, jp, ports, tp = _models()
    batch = _batch(jcfg, seed=1)
    with jdispatch.use_backend("xla"):
        lj, jc = jax.jit(lambda p, b: jed.prefill(p, b, jcfg, max_len=16))(
            jp, jax.tree.map(jnp.asarray, batch))
        lay = dict(jc["layers"])
        for k in ("k_scale", "v_scale"):
            lay[k] = lay[k] / 20
        jc = dict(jc, layers=lay)
        tok = jnp.argmax(lj, -1).astype(jnp.int32)
        start = jax.tree.map(np.asarray, jc)
        lj2, jc2 = jax.jit(lambda p, t_, c: jed.decode_step(p, t_, c, jcfg))(
            jp, tok, jc)
    want = jax.tree.map(np.asarray, jc2)
    slot = PROMPT
    written = want["layers"]["k"][:, :, :, slot]
    assert (np.abs(written) == 127).mean() > 0.2          # saturated codes
    for backend, cfg in ports.items():
        cache = interop.to_torch(start, "cpu")
        with dispatch.use_backend(backend):
            lt, cache = encdec.decode_step(tp, t(np.asarray(tok)), cache, cfg)
        got = interop.to_numpy(cache)
        for k in ("k", "v"):
            np.testing.assert_array_equal(got["layers"][k],
                                          want["layers"][k], err_msg=k)
        assert rel(lt.numpy(), lj2) <= FLIP_TOL


def test_cuda_route_equals_torch_backend_on_the_cpu():
    jcfg, _, ports, tp = _models()
    batch = interop.to_torch(_batch(jcfg, seed=2), "cpu")
    out = {}
    for backend, cfg in ports.items():
        lt, cache = encdec.prefill(tp, batch, cfg, max_len=16)
        l2, cache = encdec.decode_step(
            tp, torch.argmax(lt, -1).to(torch.int32), cache, cfg)
        out[backend] = (lt, l2, dict(_leaves(interop.to_numpy(cache))))
    assert torch.equal(out["torch"][0], out["cuda"][0])
    assert torch.equal(out["torch"][1], out["cuda"][1])
    for path, g in out["cuda"][2].items():
        np.testing.assert_array_equal(g, out["torch"][2][path], err_msg=path)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_registry_lists_the_reference_s_archs_and_shapes():
    assert list(registry.ARCHS) == list(jreg.ARCHS)
    assert registry.SHAPES == jreg.SHAPES
    assert registry.LONG_OK == jreg.LONG_OK
    for arch in jreg.ARCHS:
        assert registry.is_encdec(registry.get_config(arch)) == \
            jreg.is_encdec(jreg.get_config(arch)), arch
        for shape in jreg.SHAPES:
            assert registry.cell_supported(arch, shape) == \
                jreg.cell_supported(arch, shape), (arch, shape)


@pytest.mark.parametrize("shape", list(jreg.SHAPES))
@pytest.mark.parametrize("arch", list(jreg.ARCHS))
def test_input_specs_equal_the_reference_s(arch, shape):
    try:
        want_kind, want = jreg.input_specs(arch, shape)
    except AttributeError:                  # DeiT-S has no LM frontend
        with pytest.raises(AttributeError):
            registry.input_specs(arch, shape)
        return
    kind, got = registry.input_specs(arch, shape)
    assert kind == want_kind
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[1] == str(w.dtype), name
