"""The port's QAT graph (``mode="fake"``) held against the JAX package on
numpy inputs: forward values and gradients.

The ops' tests run the reference without a ``jax.jit`` around it (under
jit, XLA turns ``/ delta`` into a multiply by the reciprocal, and codes
would move).  The models' losses run it under ``jax.jit``, compiled once
for four seeds, and take that into account: every fake_quant call and
every ``exp2_shift`` input of JAX's run is recorded, and the port runs on
JAX's fake-quant values and JAX's side of each ``floor`` kink
(``_torch_qat_util.JaxReplay``).  A code the port's own forward would have
taken otherwise must sit at a rounding edge, its ``x / delta`` within
1e-3 of a grid step of JAX's (a half-integer between them, or JAX's own
quotient that close to one where XLA multiplied by 1 / delta): the float
sums' order alone.  Without the replay, one such code (or a score of
exactly 0, where ``exp2_shift``'s slope halves) moves a gradient by 3e-3
to 3e-1 of its max at some seeds.

- ``fake_quant``: the forward and the STE gradient ``gx`` bit for bit, the
  LSQ gradient ``g_delta`` within 1e-5 of its max (an f32 sum onto delta's
  shape, in another order), for f32 and bf16 x over an f32 delta (the
  division runs in f32 as JAX promotes it), every delta shape (per tensor,
  per column, per row, per expert), bits 2, 3, 4 and 8, signed and
  unsigned, with values inside the grid, outside it, and on qmin / qmax
  exactly (delta a power of two, so ``k * delta`` is exact).
- ``dense`` and ``dense_expert`` fake: forward within 1e-6 and gradients
  within 1e-5 of their max (float matmuls summing in another order).
- fake attention, causal or not, chunked (Sq > q_chunk), windowed (keys
  sliced per chunk), base-2 and exact softmax, attn_bits 2-8: forward and
  gradients within 1e-5 of their max (Sigma is an f32 sum in another
  order; the prob codes themselves are checked equal).
- the models' losses: ``vit.loss_fn`` (DeiT SMOKE, 2 layers, d 64) and
  ``encdec.loss_fn`` on Whisper SMOKE (``lm_loss``:
  ``tests/test_torch_qat_lm.py``), at four seeds each: loss within 1e-6
  and every gradient within 1e-5 of its leaf's max (f32 sums in other
  orders), on JAX's codes as above.
- ``cfg.remat``: the port's DeiT loss and gradients are bitwise the same
  with recompute on and off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import quant as jquant
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import dense as j_dense
from repro.kernels import dispatch as jdispatch
from repro.layers import attention as jattn
from repro.layers import moe as jmoe
from repro.models import encdec as jencdec
from repro.models import vit as jvit
from _torch_qat_util import (FQ, f32, forward_flips, hold_loss, rel,
                             to_port, torch_grads)
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.core import quant
from repro_torch.core.api import QuantConfig, dense
from repro_torch.kernels import dispatch
from repro_torch.layers import attention, moe
from repro_torch.models import encdec, vit

torch.set_num_threads(1)

# the model-loss tests' seeds (params, images / frames and tokens)
LOSS_SEEDS = (0, 1, 2, 3)

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
# fake_quant
# ---------------------------------------------------------------------------

DELTA_SHAPES = {"tensor": ((5, 6), ()), "column": ((5, 6), (1, 6)),
                "row": ((5, 6), (5, 1)), "expert": ((3, 5, 6), (3, 1, 6))}


def _fq_case(xshape, dshape, bits, unsigned, seed):
    rs = np.random.RandomState(seed)
    qmin, qmax = jquant.qrange(bits, unsigned=unsigned)
    delta = (2.0 ** rs.randint(-4, 0, size=dshape)).astype(np.float32)
    dfull = np.broadcast_to(delta, xshape)
    # codes from below qmin to past qmax, fractional parts included
    x = (rs.uniform(qmin - 3, qmax + 3, size=xshape) * dfull).astype(
        np.float32)
    flat = x.reshape(-1)
    flat[0] = qmin * dfull.reshape(-1)[0]          # on the clip edges,
    flat[1] = qmax * dfull.reshape(-1)[1]          # exactly
    flat[2] = (qmax + 0.5) * dfull.reshape(-1)[2]
    g = rs.randn(*xshape).astype(np.float32)
    return x, delta, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("where", list(DELTA_SHAPES))
def test_fake_quant_forward_and_gradients(dtype, bits, unsigned, where):
    xshape, dshape = DELTA_SHAPES[where]
    x, delta, g = _fq_case(xshape, dshape, bits, unsigned, seed=bits)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    want, vjp = jax.vjp(lambda a, d: jquant.fake_quant(a, d, bits, unsigned),
                        jx, jnp.asarray(delta))
    want_gx, want_gd = vjp(jg)

    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    td = torch.tensor(delta).requires_grad_(True)
    got = quant.fake_quant(tx, td, bits, unsigned)
    got.backward(torch.tensor(g).to(tdt))
    assert got.dtype == tdt and tx.grad.dtype == tdt
    assert td.grad.dtype == torch.float32 and td.grad.shape == dshape
    np.testing.assert_array_equal(f32(got), f32(want))
    np.testing.assert_array_equal(f32(tx.grad), f32(want_gx))
    assert rel(td.grad, want_gd) <= 1e-5
    # the edges: qmin and qmax pass the gradient, past qmax it stops
    assert f32(tx.grad).reshape(-1)[:2].tolist() == \
        f32(jg).reshape(-1)[:2].tolist()
    assert f32(tx.grad).reshape(-1)[2] == 0.0


def test_fake_quant_bf16_divides_inf32():
    """bf16 x over a 0-d f32 delta: the quotient is f32, as in JAX (torch
    alone would divide in bf16 and round codes differently)."""
    x = np.linspace(-3, 3, 997).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = interop.to_torch(np.asarray(jx), "cpu")
    delta = np.float32(3.0 / 127 * 1.0001)
    want = jquant.fake_quant(jx, jnp.asarray(delta), 8)
    got = quant.fake_quant(tx, torch.tensor(delta), 8)
    np.testing.assert_array_equal(f32(got), f32(want))
    in_bf16 = (torch.round(tx / torch.tensor(delta)).clamp(-128, 127)
               * torch.tensor(delta)).to(torch.bfloat16)
    assert not torch.equal(in_bf16, got)            # the trap is real here


# ---------------------------------------------------------------------------
# dense, dense_expert, attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("w_bits", [4, 8])
def test_dense_fake_forward_and_gradients(bias, w_bits):
    rs = np.random.RandomState(w_bits)
    x = rs.randn(2, 5, 16).astype(np.float32)
    p = {"w": (rs.randn(16, 12) * 0.25).astype(np.float32)}
    if bias:
        p["b"] = rs.randn(12).astype(np.float32)
    g = rs.randn(2, 5, 12).astype(np.float32)
    jq = JQuantConfig(w_bits=w_bits, a_bits=8, mode="fake")
    want, vjp = jax.vjp(lambda xx, pp: j_dense(xx, pp, jq), jnp.asarray(x),
                        jax.tree.map(jnp.asarray, p))
    wgx, wgp = vjp(jnp.asarray(g))
    tx = torch.tensor(x).requires_grad_(True)
    tp = {k: torch.tensor(v).requires_grad_(True) for k, v in p.items()}
    got = dense(tx, tp, QuantConfig(w_bits=w_bits, a_bits=8, mode="fake"))
    got.backward(torch.tensor(g))
    assert rel(got, want) <= 1e-6
    assert rel(tx.grad, wgx) <= 1e-5
    for k in p:
        assert rel(tp[k].grad, wgp[k]) <= 1e-5, k


@pytest.mark.parametrize("mode", ["float", "fake"])
def test_dense_mixed_operands_promote_as_jnp_matmul(mode):
    """An f32 activation into a bf16 weight (the SSD's normed output into
    its ``out_proj`` in a bf16 model) runs in f32, as ``jnp.matmul``
    promotes: the output within 1e-6 of JAX's, x's gradient within 1e-5,
    the bf16 weight's within one bf16 spacing (2^-8) of its max."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 5, 16).astype(np.float32)
    w = jnp.asarray(rs.randn(16, 12) * 0.25, jnp.bfloat16)
    g = rs.randn(2, 5, 12).astype(np.float32)
    jq = JQuantConfig(w_bits=4, a_bits=8, mode=mode)
    want, vjp = jax.vjp(lambda xx, ww: j_dense(xx, {"w": ww}, jq),
                        jnp.asarray(x), w)
    wgx, wgw = vjp(jnp.asarray(g))
    assert want.dtype == jnp.float32
    tx = torch.tensor(x).requires_grad_(True)
    tw = torch.tensor(np.asarray(w, np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    got = dense(tx, {"w": tw}, QuantConfig(w_bits=4, a_bits=8, mode=mode))
    got.backward(torch.tensor(g))
    assert got.dtype == torch.float32 and tw.grad.dtype == torch.bfloat16
    assert rel(got, want) <= 1e-6
    assert rel(tx.grad, wgx) <= 1e-5
    assert rel(tw.grad, wgw) <= 2.0 ** -8


def test_dense_expert_fake_forward_and_gradients():
    rs = np.random.RandomState(3)
    x = rs.randn(3, 5, 16).astype(np.float32)
    w = (rs.randn(3, 16, 12) * 0.25).astype(np.float32)
    g = rs.randn(3, 5, 12).astype(np.float32)
    jq = JQuantConfig(w_bits=4, a_bits=8, mode="fake")
    want, vjp = jax.vjp(lambda xx, ww: jmoe.dense_expert(xx, {"w": ww}, jq),
                        jnp.asarray(x), jnp.asarray(w))
    wgx, wgw = vjp(jnp.asarray(g))
    tx = torch.tensor(x).requires_grad_(True)
    tw = torch.tensor(w).requires_grad_(True)
    got = moe.dense_expert(tx, {"w": tw}, QuantConfig(w_bits=4, a_bits=8,
                                                      mode="fake"))
    got.backward(torch.tensor(g))
    assert rel(got, want) <= 1e-6
    assert rel(tx.grad, wgx) <= 1e-5
    assert rel(tw.grad, wgw) <= 1e-5


ATTN_CASES = [  # (causal, sq, q_chunk, window, softmax, attn_bits)
    (True, 16, 16, None, "base2", 8),
    (False, 16, 16, None, "base2", 7),
    (True, 32, 8, None, "base2", 4),          # chunked
    (True, 32, 8, 6, "base2", 3),             # windowed, keys sliced
    (False, 24, 8, None, "exact", 2),
    (True, 16, 16, None, "exact", 5),
    (True, 16, 16, None, "base2", 6),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_fake_attention_forward_and_gradients(case, monkeypatch):
    causal, sq, qc, window, softmax, bits = case
    rs = np.random.RandomState(bits)
    q, k, v = (rs.randn(2, h, sq, 8).astype(np.float32) for h in (4, 2, 2))
    g = rs.randn(2, 4, sq, 8).astype(np.float32)
    jq = JQuantConfig(a_bits=8, attn_bits=bits, mode="fake", softmax=softmax)
    tq = QuantConfig(a_bits=8, attn_bits=bits, mode="fake", softmax=softmax)
    jspec = jattn.AttnSpec(causal=causal, window=window, q_chunk=qc)
    tspec = attention.AttnSpec(causal=causal, window=window, q_chunk=qc)
    assert forward_flips(
        monkeypatch, lambda: jattn.attention(*map(jnp.asarray, (q, k, v)),
                                             jspec, jq),
        lambda: attention.attention(*map(torch.tensor, (q, k, v)), tspec,
                                    tq)) == 0
    want, vjp = jax.vjp(lambda a, b, c: jattn.attention(a, b, c, jspec, jq),
                        *map(jnp.asarray, (q, k, v)))
    wg = vjp(jnp.asarray(g))
    tt = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    got = attention.attention(*tt, tspec, tq)
    got.backward(torch.tensor(g))
    assert rel(got, want) <= 1e-5
    for t, w in zip(tt, wg):
        assert rel(t.grad, w) <= 1e-5


# ---------------------------------------------------------------------------
# the models' losses
# ---------------------------------------------------------------------------

def _vit_case(seed=0):
    jcfg = jregistry.smoke_config("deit-s").replace(quant=JQuantConfig(**FQ))
    tcfg = registry.smoke_config("deit-s").replace(quant=QuantConfig(**FQ))
    rs = np.random.RandomState(seed)
    imgs = np.tanh(rs.randn(4, 32, 32, 3)).astype(np.float32)
    labels = rs.randint(0, 10, 4).astype(np.int32)
    jb = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
    tb = {"images": torch.tensor(imgs), "labels": torch.tensor(labels)}
    return jcfg, tcfg, jb, tb, jvit.init_params(jax.random.PRNGKey(seed),
                                                jcfg)


def test_vit_loss_and_gradients(monkeypatch):
    jcfg, tcfg, *_ = _vit_case()
    cases = [_vit_case(seed) for seed in LOSS_SEEDS]
    print(hold_loss(monkeypatch, lambda p, b: jvit.loss_fn(p, b, jcfg),
                    lambda p, b: vit.loss_fn(p, b, tcfg),
                    [(jp, jb, tb) for *_, jb, tb, jp in cases]))


def _encdec_case(jcfg, seed):
    rs = np.random.RandomState(seed)
    frames = rs.randn(2, jcfg.n_audio_ctx, jcfg.d_model).astype(np.float32)
    toks = rs.randint(0, jcfg.vocab, (2, 8)).astype(np.int32)
    labels = rs.randint(0, jcfg.vocab, (2, 8)).astype(np.int32)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    tb = {"frames": torch.tensor(frames), "tokens": torch.tensor(toks),
          "labels": torch.tensor(labels)}
    return jencdec.init_params(jax.random.PRNGKey(seed), jcfg), jb, tb


def test_encdec_loss_and_gradients(monkeypatch):
    jcfg = jregistry.smoke_config("whisper-large-v3").replace(
        quant=JQuantConfig(**FQ))
    tcfg = registry.smoke_config("whisper-large-v3").replace(
        quant=QuantConfig(**FQ))
    print(hold_loss(monkeypatch, lambda p, b: jencdec.loss_fn(p, b, jcfg),
                    lambda p, b: encdec.loss_fn(p, b, tcfg),
                    [_encdec_case(jcfg, seed) for seed in LOSS_SEEDS]))


def test_vit_remat_changes_no_number():
    """Recompute in the backward pass gives the same loss and gradients,
    bit for bit."""
    _, tcfg, _, tb, jp = _vit_case()
    params = to_port(jp)
    off, on = (torch_grads(lambda p: vit.loss_fn(p, tb, tcfg.replace(
        remat=remat)), params) for remat in (False, True))
    assert torch.equal(off[0], on[0])
    for path, g in off[2].items():
        assert torch.equal(g, on[2][path]), path
