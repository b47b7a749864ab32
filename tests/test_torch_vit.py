"""DeiT (``models/vit.py``) in the port held against the JAX package.

The JAX package makes the parameters (``init_params`` +
``integerize_params``); they reach torch through numpy
(``repro_torch.interop``), layer-stacked ``layers`` and nibble-packed
``w_q`` as they are.  ``vit.forward`` on the DeiT SMOKE config, integer
mode at ``pack_weights`` False and True, on both port backends, against
the reference's XLA route (and its Pallas route once): logits within
1e-5 of their max — f32 sums in another order and XLA's FMA contraction
move floats in the last bits, and an activation code that flipped at a
rounding edge would move the logits by about 1e-2, far above this.
``STATS`` show every linear and attention on the ``cuda`` route and none
on ``torch``, as ``tests/test_dispatch.py`` asserts for the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deit_s as jdeit
from repro.configs import registry as jregistry
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.kernels import dispatch as jdispatch
from repro.models import vit as jvit
from repro_torch import interop
from repro_torch.configs import deit_s, registry
from repro_torch.core.api import QuantConfig
from repro_torch.kernels import dispatch
from repro_torch.models import vit

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _images(n=2, size=32):
    return np.random.RandomState(5).randn(n, size, size, 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_params():
    return jvit.init_params(jax.random.PRNGKey(0), jdeit.SMOKE)


@pytest.mark.parametrize("pack", [False, True])
def test_int_forward_matches_jax_on_both_backends(jax_params, pack):
    jq = JQuantConfig(w_bits=4, a_bits=8, attn_bits=7, mode="int",
                      pack_weights=pack)
    jcfg = jdeit.SMOKE.replace(quant=jq)
    ip = j_integerize(jax_params, jq)
    imgs = _images()
    want = np.asarray(jvit.forward(ip, jnp.asarray(imgs), jcfg))
    params = interop.to_torch(jax.tree.map(np.asarray, ip), device="cpu")
    packed_leaf = params["layers"]["attn"]["wq"]["w_q"]
    assert packed_leaf.dtype == (torch.uint8 if pack else torch.int8)
    assert packed_leaf.shape[0] == jdeit.SMOKE.n_layers
    n_lin = 1 + 6 * jcfg.n_layers                   # patch + 6 a layer
    for backend in ("cuda", "torch"):
        cfg = deit_s.SMOKE.replace(quant=QuantConfig(
            w_bits=4, a_bits=8, attn_bits=7, mode="int", pack_weights=pack,
            backend=backend))
        dispatch.reset_stats()
        got = vit.forward(params, torch.from_numpy(imgs), cfg)
        assert got.dtype == torch.float32 and got.shape == (2, 10)
        close(got.numpy(), want)
        other = "torch" if backend == "cuda" else "cuda"
        assert dispatch.STATS[f"qlinear_{backend}"] == n_lin
        assert dispatch.STATS[f"attention_{backend}"] == jcfg.n_layers
        assert dispatch.STATS[f"qlinear_{other}"] == 0
        assert dispatch.STATS[f"attention_{other}"] == 0
        if backend == "cuda" and pack:
            with jdispatch.use_backend("pallas"):
                close(got.numpy(), jvit.forward(ip, jnp.asarray(imgs),
                                                jcfg))


def test_float_forward_and_loss_match_jax(jax_params):
    imgs = _images()
    labels = np.array([3, 7], np.int32)
    want = np.asarray(jvit.forward(jax_params, jnp.asarray(imgs),
                                   jdeit.SMOKE))
    params = interop.to_torch(jax.tree.map(np.asarray, jax_params),
                              device="cpu")
    got = vit.forward(params, torch.from_numpy(imgs), deit_s.SMOKE)
    close(got.numpy(), want)
    jl, jm = jvit.loss_fn(jax_params, {"images": jnp.asarray(imgs),
                                       "labels": jnp.asarray(labels)},
                          jdeit.SMOKE)
    tl, tm = vit.loss_fn(params, {"images": torch.from_numpy(imgs),
                                  "labels": torch.from_numpy(labels)},
                         deit_s.SMOKE)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tm["acc"]) == float(jm["acc"])


def test_init_params_tree_and_patchify_match_jax(jax_params):
    """The port's own init (a torch generator, weights on the device)
    makes the reference's tree: same keys, shapes and dtypes; patchify is
    the same permutation."""
    got = vit.init_params(deit_s.SMOKE, seed=0, device="cpu")
    flat_t = {k: v for k, v in _flat(got)}
    flat_j = {k: v for k, v in _flat(jax.tree.map(np.asarray, jax_params))}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(flat_j[k].dtype), k
    imgs = _images()
    np.testing.assert_array_equal(
        vit.patchify(torch.from_numpy(imgs), deit_s.SMOKE).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(imgs), jdeit.SMOKE)))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_configs_and_deit_s_dispatch_shape():
    """The registry serves DeiT-S at the reference's widths, and at
    N = 198 tokens dispatch gives the fused kernel one query chunk of 198
    with bq = 33 (its largest divisor <= 64) and bk = 224 (198 rounded up
    to 32): the shape chip_smoke.py checks on the card."""
    for name in ("CONFIG", "CIFAR", "SMOKE"):
        a, b = getattr(deit_s, name), getattr(jdeit, name)
        for f in ("name", "n_layers", "d_model", "n_heads", "d_ff",
                  "img_size", "patch", "n_classes", "q_chunk"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert a.n_tokens == b.n_tokens
    assert registry.get_config("deit-s") == deit_s.CONFIG
    assert jregistry.ARCHS["deit-s"] == registry.ARCHS["deit-s"]
    cfg = deit_s.CONFIG
    c = dispatch.chunk_len(cfg.n_tokens, cfg.q_chunk)
    assert c == 198 == jdispatch.chunk_len(198, 256)
    assert dispatch.attention_blocks(198, 198, cfg.hd, chunk=c) == (33, 224)
