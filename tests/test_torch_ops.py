"""The port's kernel entry points (``kernels/ops.py``) and the two-pass
attention kernel held against the JAX package.

- The two-pass kernel's plain version against the reference's two-pass
  Pallas kernel (interpret mode) and its fused kernel, causal,
  non-causal and windowed: outputs within 1e-5 of their max (the
  reference's own bound for two-pass vs fused; Sigma is an f32 sum in
  another order).  Inside the port the two-pass and fused paths give the
  same codes and outputs bit for bit.
- Each entry point (``qlinear_op``, ``int_attention_op`` fused and
  two-pass, ``pq_layernorm_op``) against ``repro.kernels.ops`` on the same
  numpy inputs.
- The paper's integerized self-attention module through the entry points
  at DeiT SMOKE width (the chain ``chip_smoke.py`` runs at DeiT-S widths):
  each stage against JAX's on the same inputs, and the whole chain run
  separately in both packages.
- Pre-quantized (QTensor) k/v through ``attention()``: the ``cuda``
  route's ``quantized_in`` branch against the reference's Pallas and XLA
  routes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deit_s as jdeit
from repro.core import quant as jquant
from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import integerize_params as j_integerize
from repro.core.integerize import QLinearParams as JQLinear
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels.int_attention import int_attention as j_two_pass
from repro.kernels.int_attention import int_attention_fused as j_fused
from repro.layers import attention as jattn
from repro.layers import norms as jnorms
from repro.models import vit as jvit
from repro_torch.core import quant
from repro_torch.core.api import QuantConfig
from repro_torch.core.integerize import QLinearParams
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels import int_attention as ia
from repro_torch.layers import attention as tattn
from repro_torch.layers import norms

torch.set_num_threads(1)

ATTN_TOL = 1e-5


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


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def flip_aware(got, want, frac):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= frac, \
        (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("causal,window,bits", [(True, None, 7),
                                                (False, None, 8),
                                                (True, 5, 7)])
def test_two_pass_plain_matches_pallas(causal, window, bits):
    rng = np.random.RandomState(3 + bits + (window or 0))
    h, sq, sk, d, bq, bk = 2, 20, 24, 16, 8, 8
    q, k, v = (rng.randint(-127, 128, (h, s, d)).astype(np.int8)
               for s in (sq, sk, sk))
    nq = -(-sq // bq)
    sc = rng.uniform(2e-3, 5e-3, (h, nq)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, h).astype(np.float32)
    kw = dict(attn_bits=bits, causal=causal, window=window, bq=bq, bk=bk)
    J = jnp.asarray
    want = np.asarray(j_two_pass(J(q), J(k), J(v), J(sc), J(vs), **kw))
    want_f = np.asarray(j_fused(J(q), J(k), J(v), J(sc), J(vs), **kw))
    before = dict(ia.LAUNCHES)
    got, codes = ia.int_attention(t(q), t(k), t(v), t(sc), t(vs),
                                  return_codes=True, **kw)
    assert ia.LAUNCHES == before                     # CPU: plain version
    close(got.numpy(), want, ATTN_TOL)
    close(got.numpy(), want_f, ATTN_TOL)
    one, one_codes = ia.int_attention_fused(t(q), t(k), t(v), t(sc), t(vs),
                                            return_codes=True, **kw)
    assert torch.equal(codes, one_codes) and torch.equal(got, one)
    assert int(codes.max()) <= (1 << bits) - 1


def _qt(x, bits=8):
    """The same activation quantized in both packages (per-tensor)."""
    jq = jquant.quantize_tensor(jnp.asarray(x), bits)
    tq = quant.QTensor(t(np.asarray(jq.q)), t(np.asarray(jq.scale)), bits)
    return jq, tq


@pytest.mark.parametrize("packed,k", [(False, 64), (True, 66)])
def test_qlinear_op_matches_jax(packed, k):
    """int8 and nibble-packed weights, K = 66 (2 mod 4: the kernel's
    padding case).  Within 1e-6 of the output's max: XLA contracts the
    epilogue's ``acc * s + b`` into one FMA, the port rounds twice."""
    rng = np.random.RandomState(k)
    x = rng.randn(7, k).astype(np.float32)
    w = rng.randint(-8, 8, (12, k)).astype(np.int8)
    ws = rng.uniform(0.01, 0.05, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    jq, tq = _qt(x)
    wj = jquant.pack_int4(jnp.asarray(w)) if packed else jnp.asarray(w)
    want = jops.qlinear_op(jq, JQLinear(wj, jnp.asarray(ws), jnp.asarray(b)),
                           packed=packed, bm=128, bn=128, bk=128)
    got = ops.qlinear_op(tq, QLinearParams(t(np.asarray(wj)), t(ws), t(b)),
                         packed=packed)
    close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_int_attention_op_matches_jax(fused):
    rng = np.random.RandomState(int(fused))
    h, s, d = 3, 40, 16
    qkv = [rng.randn(h, s, d).astype(np.float32) for _ in range(3)]
    (jq, tq), (jk, tk), (jv, tv) = (_qt(a) for a in qkv)
    kw = dict(softmax_scale=d ** -0.5, attn_bits=7, causal=False, bq=16,
              bk=16, fused=fused)
    want = jops.int_attention_op(jq, jk, jv, **kw)
    got = ops.int_attention_op(tq, tk, tv, **kw)
    close(got.numpy(), want, ATTN_TOL)


def test_pq_layernorm_op_matches_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(20, 48) * 2).astype(np.float32)
    g = (np.abs(rng.randn(48)) + 0.5).astype(np.float32)
    b = (rng.randn(48) * 0.1).astype(np.float32)
    want = jops.pq_layernorm_op(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b), 0.04, bits=8, br=8)
    got = ops.pq_layernorm_op(t(x), t(g), t(b), 0.04, bits=8)
    flip_aware(got.numpy(), want, 1e-3)


def _layer0():
    """Layer 0 of the integerized DeiT SMOKE model (JAX init), both trees,
    and a residual stream of B * N rows."""
    qc = JQuantConfig(w_bits=4, a_bits=8, attn_bits=7, mode="int")
    cfg = jdeit.SMOKE
    params = jax.tree.map(np.asarray, j_integerize(
        jvit.init_params(jax.random.PRNGKey(0), cfg), qc))
    lay = jax.tree.map(lambda a: a[0], params["layers"])
    x = np.random.RandomState(2).randn(2 * cfg.n_tokens, cfg.d_model) \
        .astype(np.float32)
    return cfg, lay, x


def _chain(pkg, lay, x, cfg, delta, n_seq):
    """LayerNorm -> codes -> q/k/v -> per-tensor 8-bit -> attention (fused
    and two-pass) -> wo, through one package's entry points.  Returns
    every stage."""
    jx = pkg == "jax"
    qz = jquant if jx else quant
    mod = jops if jx else ops
    arr = jnp.asarray if jx else t
    QL = JQLinear if jx else QLinearParams
    ln = lay["ln1"]
    codes = mod.pq_layernorm_op(arr(x), arr(ln["gamma"]), arr(ln["beta"]),
                                delta, bits=8)
    xq = qz.QTensor(codes, arr(np.float32(delta)), 8)
    heads, hd = cfg.n_heads, cfg.hd

    def lin(name, a):
        p = lay["attn"][name]
        return mod.qlinear_op(a, QL(arr(p["w_q"]), arr(p["w_scale"]),
                                    arr(p["b"])))

    def fold(y):                           # (B*N, d) -> (B*H, N, hd)
        y = y.reshape(n_seq, -1, heads, hd)
        y = y.transpose(0, 2, 1, 3) if jx else y.permute(0, 2, 1, 3)
        return qz.quantize_tensor(y.reshape(n_seq * heads, -1, hd), 8)

    q, k, v = (lin(n, xq) for n in ("wq", "wk", "wv"))
    qq, kq, vq = fold(q), fold(k), fold(v)
    kw = dict(softmax_scale=hd ** -0.5, attn_bits=7, causal=False)
    att = {f: mod.int_attention_op(qq, kq, vq, fused=f, **kw)
           for f in (True, False)}
    o = att[True].reshape(n_seq, heads, -1, hd)
    o = o.transpose(0, 2, 1, 3) if jx else o.permute(0, 2, 1, 3)
    oq = qz.quantize_tensor(o.reshape(x.shape[0], -1), 8)
    out = lin("wo", oq)
    return dict(codes=codes, q=q, qq=qq.q, att=att[True], att2=att[False],
                oq=oq.q, out=out)


def test_attention_module_chain_matches_jax():
    """The [ops] chain at SMOKE width.  Stage by stage on the same inputs:
    LayerNorm codes flip-aware, q/k/v within 1e-6 (FMA), attention within
    1e-5.  Whole chains run apart: activation codes flip-aware (one step,
    <= 1%) and the module's output within 2e-2 of its max (a one-step
    flip of an 8-bit code moves it by about 1%).  Fused == two-pass
    bitwise inside the port."""
    cfg, lay, x = _layer0()
    ln = lay["ln1"]
    y = norms.layernorm(t(x), t(ln["gamma"]), t(ln["beta"]))
    delta = float(quant.absmax_scale(y, 8))
    wj = np.asarray(jnorms.layernorm(jnp.asarray(x), jnp.asarray(ln["gamma"]),
                                     jnp.asarray(ln["beta"])))
    close(y.numpy(), wj, 1e-6)
    got = _chain("torch", lay, x, cfg, delta, 2)
    want = _chain("jax", lay, x, cfg, delta, 2)
    assert torch.equal(got["att"], got["att2"])
    flip_aware(got["codes"].numpy(), want["codes"], 1e-3)
    for name in ("qq", "oq"):
        flip_aware(got[name].numpy(), want[name], 1e-2)
    close(got["out"].numpy(), want["out"], 2e-2)
    # stage by stage, each package fed the port's previous stage
    p = lay["attn"]["wq"]
    xq = jquant.QTensor(jnp.asarray(got["codes"].numpy()),
                        jnp.float32(delta), 8)
    jq = jops.qlinear_op(xq, JQLinear(jnp.asarray(p["w_q"]),
                                      jnp.asarray(p["w_scale"]),
                                      jnp.asarray(p["b"])))
    close(got["q"].numpy(), jq, 1e-6)
    tqq = quant.quantize_tensor(
        got["q"].reshape(2, -1, cfg.n_heads, cfg.hd).permute(0, 2, 1, 3)
        .reshape(2 * cfg.n_heads, -1, cfg.hd), 8)
    jqq = jquant.QTensor(jnp.asarray(tqq.q.numpy()),
                         jnp.asarray(tqq.scale.numpy()), 8)
    kw = dict(softmax_scale=cfg.hd ** -0.5, attn_bits=7, causal=False)
    close(ops.int_attention_op(tqq, tqq, tqq, fused=False, **kw).numpy(),
          jops.int_attention_op(jqq, jqq, jqq, **kw), ATTN_TOL)


def test_quantized_kv_dispatch_matches_reference_routes():
    """Float q with pre-quantized (int8 QTensor) k/v from position 0: the
    reference's ``_fused_call`` ``quantized_in`` branch (one grid per
    operand, ``scale*LOG2E*dq*dk``).  The port's cuda route against JAX's
    pallas and xla routes; its torch route against JAX's xla route."""
    rng = np.random.RandomState(21)
    b, hq, hkv, s, d = 2, 4, 2, 24, 16
    q = rng.randn(b, hq, s, d).astype(np.float32)
    kf, vf = (rng.randn(b, hkv, s, d).astype(np.float32) for _ in range(2))
    (jk, tk), (jv, tv) = _qt(kf), _qt(vf)
    spec_j, spec_t = jattn.AttnSpec(q_chunk=32), tattn.AttnSpec(q_chunk=32)
    qj = JQuantConfig(a_bits=8, attn_bits=7, mode="int")
    out = {}
    for jb in ("pallas", "xla"):
        with jdispatch.use_backend(jb):
            out[jb] = np.asarray(jattn.attention(jnp.asarray(q), jk, jv,
                                                 spec_j, qj))
    dispatch.reset_stats()
    for backend in ("cuda", "torch"):
        qt = QuantConfig(a_bits=8, attn_bits=7, mode="int", backend=backend)
        got = tattn.attention(t(q), tk, tv, spec_t, qt).numpy()
        close(got, out["xla"], ATTN_TOL)
        if backend == "cuda":
            close(got, out["pallas"], ATTN_TOL)
    assert dispatch.STATS["attention_cuda"] == 1
    assert dispatch.STATS["attention_torch"] == 1
