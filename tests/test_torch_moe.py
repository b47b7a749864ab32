"""The port's MoE FFN (``layers/moe.py``) and expert integerization held
against the JAX package, on numpy inputs.

- ``integerize_params`` on an expert tree (layer-stacked and not; bf16 and
  f32 weights; w8 and w4): leaf for leaf equal to JAX's, codes and scales
  exact, expert codes in their ``(…, E, din, dout)`` layout with scales
  ``(…, E, 1, dout)``, never nibble-packed.
- ``dense_expert`` float (within 1e-6 of the output's max: an f32
  contraction in another order) and int: activation codes, int32 sums and
  the f32 epilogue exact, on both port backends (the ``cuda`` route runs
  one qmatmul an expert, here its plain version).  At bf16 the epilogue's
  step is the 0-d bf16 activation scale times the f32 weight scales, which
  both packages promote to f32.
- ``moe_ffn`` at top-1 with a shared expert and at top-2, float and int
  (w8, w4), f32 and bf16, and a capacity that drops tokens: the route
  (``idx``, ``slot``, ``keep``) EXACTLY JAX's; outputs within 1e-6 of
  their max; ``lb_loss`` within 1e-6.  Near-ties (an expert taken and the
  best one left within 1e-6) are named: none in the f32 inputs; in bf16
  the router's logits are bf16 and tie outright now and then, and such a
  token takes the lower expert id in both packages (``jax.lax.top_k``,
  the port's stable sort).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import QuantConfig as JQuantConfig
from repro.core.api import dense as j_dense
from repro.core.api import integerize_params as j_integerize
from repro.kernels import dispatch as jdispatch
from repro.layers import moe as jmoe
from repro_torch import interop
from repro_torch.core.api import QuantConfig, integerize_params
from repro_torch.kernels import dispatch
from repro_torch.layers import moe

torch.set_num_threads(1)

TOL = 1e-6
D, FF, T = 32, 48, 40


@pytest.fixture(autouse=True)
def _restore_stats():
    """Both packages' dispatch STATS are process-global: put them back."""
    jsnap, snap = jdispatch.snapshot(), dispatch.snapshot()
    yield
    jdispatch.STATS.clear()
    jdispatch.STATS.update(jsnap)
    dispatch.STATS.clear()
    dispatch.STATS.update(snap)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return interop.to_torch(_np(tree), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _moe_params(n_experts, top_k, shared, dtype, lead=None, cf=1.25):
    jcfg = jmoe.MoEConfig(n_experts=n_experts, top_k=top_k,
                          capacity_factor=cf, shared_expert=shared)
    init = lambda key: jmoe.init_moe(key, D, FF, jcfg, dtype=_jdt(dtype))
    if lead:
        jp = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(0), lead))
    else:
        jp = init(jax.random.PRNGKey(0))
    tcfg = moe.MoEConfig(n_experts=n_experts, top_k=top_k,
                         capacity_factor=cf, shared_expert=shared)
    return jcfg, tcfg, jp


def _x(dtype, t=T, seed=0):
    x = np.random.RandomState(seed).randn(t, D).astype(np.float32)
    jx = jnp.asarray(x, _jdt(dtype))
    return jx, _t(jx)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("lead", [None, 3])
def test_integerize_expert_tree_leaf_for_leaf(dtype, w_bits, lead):
    _, _, jp = _moe_params(4, 1, True, dtype, lead)
    jq = JQuantConfig(w_bits=w_bits, mode="int", pack_weights=True)
    want = dict(_leaves(_np(j_integerize(jp, jq))))
    tree = integerize_params(_t(jp), QuantConfig(w_bits=w_bits, mode="int",
                                                 pack_weights=True))
    dtypes = {k: v.dtype for k, v in _leaves(tree)}
    got = dict(_leaves(interop.to_numpy(tree)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if w.dtype.name == "bfloat16":      # to_numpy widens bf16, exactly
            assert dtypes[path] == torch.bfloat16, path
            w = w.astype(np.float32)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)
    e_shape = ((lead,) if lead else ()) + (4, D, FF)
    assert got["/experts_up/w_q"].shape == e_shape
    assert got["/experts_up/w_q"].dtype == np.int8           # never packed
    assert got["/experts_up/w_scale"].shape == e_shape[:-2] + (1, FF)
    assert got["/router/w"].dtype.kind == "f"                 # stays float


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits", [8, 4])
def test_dense_expert_float_and_int_match_jax(dtype, w_bits):
    _, _, jp = _moe_params(4, 1, False, dtype)
    x = np.random.RandomState(1).randn(4, 6, D).astype(np.float32)
    jx = jnp.asarray(x, _jdt(dtype))
    p = jp["experts_up"]
    tx = _t(jx)
    assert _rel(moe.dense_expert(tx, _t(p), None),
                jmoe.dense_expert(jx, p, None)) <= TOL
    jq = JQuantConfig(w_bits=w_bits, mode="int")
    jpq = j_integerize(jp, jq)["experts_up"]
    want = np.asarray(jmoe.dense_expert(jx, jpq, jq).astype(jnp.float32))
    # the reference's int body, step by step
    from repro.core import quant as jquant
    jxq = jquant.quantize_tensor(jx, 8)
    jacc = jnp.einsum("ecd,edf->ecf", jxq.q, jpq["w_q"],
                      preferred_element_type=jnp.int32)
    jscale = jxq.scale * jpq["w_scale"]
    assert jscale.dtype == jnp.float32
    from repro_torch.core import quant
    xq = quant.quantize_tensor(tx, 8)
    np.testing.assert_array_equal(xq.q.numpy(), np.asarray(jxq.q))
    tp = _t(jpq)
    acc = quant.int_matmul_exact(xq.q, tp["w_q"])
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    scale = xq.scale * tp["w_scale"]
    assert scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    for backend in ("torch", "cuda"):
        dispatch.reset_stats()
        qc = QuantConfig(w_bits=w_bits, mode="int", backend=backend)
        got = moe.dense_expert(tx, tp, qc)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert dispatch.STATS[f"qexpert_{backend}"] == 1
    with pytest.raises(ValueError):                 # an unknown mode
        moe.dense_expert(tx, tp, QuantConfig(mode="fakeint"))


def _j_route(jx, jp, jcfg, t):
    """The reference's routing, with its own expressions and slot
    assignment (``repro/layers/moe.py:236-246``)."""
    e, k = jcfg.n_experts, jcfg.top_k
    cap = max(int(t * k * jcfg.capacity_factor / e), 1)
    logits = j_dense(jx, jp["router"], None).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, k)
    gate = gate / jnp.sum(gate, axis=-1, keepdims=True)
    buf, eid, slot, keepw = jmoe._assign_slots(jx, gate, idx, e, cap)
    return _np((probs, idx, buf, eid, slot, keepw))


def _near_ties(probs, k, tol=1e-6):
    """(token, k-th expert taken, best expert left) wherever their
    probabilities lie within ``tol``."""
    order = np.argsort(-probs, axis=-1, kind="stable")
    srt = np.take_along_axis(probs, order, axis=-1)
    near = np.nonzero(srt[:, k - 1] - srt[:, k] <= tol)[0]
    return [(int(i), int(order[i, k - 1]), int(order[i, k])) for i in near]


CASES = [(4, 1, True, 1.25), (4, 2, False, 1.25), (8, 2, True, 1.25),
         (4, 2, False, 0.5)]               # the last drops tokens


@pytest.mark.parametrize("n_experts,top_k,shared,cf", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_route_exact_and_outputs_match_jax(n_experts, top_k, shared,
                                                   cf, dtype):
    jcfg, tcfg, jp = _moe_params(n_experts, top_k, shared, dtype, cf=cf)
    jx, tx = _x(dtype)
    probs, idx, buf, eid, slot, keepw = _j_route(jx, jp, jcfg, T)
    tprobs, tgate, tidx = moe.route(tx, _t(jp), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    ties = _near_ties(probs, top_k)
    if dtype == "float32":
        assert not ties, ties
    else:
        # bf16 router logits tie outright now and then: such a token takes
        # the lower expert id in both packages
        print(f"near-ties (token, expert taken, expert left): {ties}")
        assert all(taken < left for _, taken, left in ties)
    cap = buf.shape[1]
    tbuf, teid, tslot, tkeepw = moe._assign_slots(tx, tgate, tidx,
                                                  n_experts, cap)
    np.testing.assert_array_equal(teid.numpy(), eid)
    np.testing.assert_array_equal(tslot.numpy(), slot)
    np.testing.assert_array_equal(tkeepw.numpy() != 0, keepw != 0)
    assert _rel(tkeepw, keepw) <= TOL
    assert _rel(tbuf.float(), buf) <= TOL
    dropped = int((keepw == 0).sum())
    assert dropped > 0 or cf >= 1, dropped
    for mode, w_bits in (("float", 8), ("int", 8), ("int", 4)):
        if mode == "float":
            jq, params, qcs = None, jp, [None]
        else:
            jq = JQuantConfig(w_bits=w_bits, mode="int")
            params = j_integerize(jp, jq)
            qcs = [QuantConfig(w_bits=w_bits, mode="int", backend=b)
                   for b in ("torch", "cuda")]
        wy, waux = jmoe.moe_ffn(jx, params, jcfg, jq)
        tp = _t(params)
        for qc in qcs:
            dispatch.reset_stats()
            ty, taux = moe.moe_ffn(tx, tp, tcfg, qc)
            assert ty.dtype == torch.float32 and wy.dtype == jnp.float32
            assert _rel(ty, wy) <= TOL, (mode, w_bits, qc)
            assert abs(float(taux["lb_loss"]) - float(waux["lb_loss"])) \
                <= TOL
            if qc is not None:
                assert dispatch.STATS[f"qexpert_{qc.backend}"] == 3


def test_moe_ffn_repeats_each_token_in_place():
    """The k choices of a token are that token (``jnp.repeat``), not the
    buffer tiled (``Tensor.repeat``): each kept slot holds its own token."""
    _, tcfg, jp = _moe_params(4, 2, False, "float32")
    _, tx = _x("float32")
    _, gate, idx = moe.route(tx, _t(jp), tcfg)
    buf, eid, slot, keepw = moe._assign_slots(tx, gate, idx, 4, 40)
    tok = torch.arange(T).repeat_interleave(2)
    for i in range(2 * T):
        assert torch.equal(buf[eid[i], slot[i]], tx[tok[i]])


def test_expert_codes_transposed_once_per_tree():
    _, _, jp = _moe_params(4, 1, False, "float32", lead=3)
    qc = QuantConfig(w_bits=4, mode="int")
    tp = integerize_params(_t(jp), qc)
    w = tp["experts_up"]["w_q"]                       # (3, E, din, dout)
    for u in range(3):
        a = dispatch.expert_codes_t(w[u])
        assert dispatch.expert_codes_t(w[u]) is a     # a new view, the memo
        assert a.is_contiguous()
        assert torch.equal(a, w[u].transpose(-1, -2))
    assert len(w.__dict__["_codes_t"]) == 3
