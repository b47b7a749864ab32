"""Helpers shared by the QAT tests (``test_torch_qat*.py``): numpy views,
relative gaps, autograd gradients over a parameter tree, the JAX
package's fake-quant recorder (the port's is ``chip_smoke.FakeQuantTap``)
and the loss-and-gradient comparison against the JAX package."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import FLIP_NEAR, FakeQuantTap, code_flips
from repro.core import quant as jquant
from repro.layers import attention as jattn
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.core import quant, softmax2
from repro_torch.layers import attention

FQ = dict(w_bits=4, a_bits=8, attn_bits=7, mode="fake")


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def rel(got, want):
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def to_port(tree):
    return interop.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def torch_grads(loss_fn, params, wrt=None):
    """(loss, metrics, {path: grad}) through autograd; ``wrt`` names the
    leaves (default: every leaf of ``params``)."""
    named = wrt if wrt is not None else tree_lib.leaves_with_paths(params)
    for _, leaf in named:
        leaf.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params)
        got = torch.autograd.grad(loss, [leaf for _, leaf in named],
                                  allow_unused=True)
    finally:
        for _, leaf in named:
            leaf.requires_grad_(False)
    return loss.detach(), metrics, {
        path: torch.zeros_like(leaf) if g is None else g
        for (path, leaf), g in zip(named, got)}


def _from_jax(a) -> torch.Tensor:
    """A JAX value seen by a host callback, as a torch tensor of its dtype."""
    return torch.tensor(np.asarray(a, np.float32)).to(
        getattr(torch, str(a.dtype)))


@contextlib.contextmanager
def jax_fake_quant_records(monkeypatch):
    """Within ``with``: every ``repro``'s fake_quant call records its (x,
    delta, bits, unsigned, output) as torch tensors, in call order, through
    an ordered debug callback (which fires on each ``lax.scan``
    iteration), in ``chip_smoke.FakeQuantTap``'s layout; the fake
    attention's ``exp2_shift`` calls record their input in
    ``records.exp2``.  The callbacks are the same objects in every use, so
    JAX's compiled scans are reused."""
    rec = _Records()
    _FILLING.append(rec)
    try:
        with monkeypatch.context() as m:
            m.setattr(jquant, "fake_quant", _jax_fake_quant)
            m.setattr(jattn, "exp2_shift", _jax_exp2_shift)
            yield rec
            jax.effects_barrier()
    finally:
        _FILLING.pop()


_FILLING = []                      # the records being filled, innermost last
_JAX_FAKE_QUANT, _JAX_EXP2_SHIFT = jquant.fake_quant, jattn.exp2_shift


def _record_fake_quant(bits, unsigned, a, d, o):
    _FILLING[-1].append((_from_jax(a), _from_jax(d), bits, unsigned,
                         _from_jax(o)))


def _record_exp2(a):
    _FILLING[-1].exp2.append(_from_jax(a))


@functools.lru_cache(maxsize=None)
def _fake_quant_callback(bits, unsigned):
    return functools.partial(_record_fake_quant, bits, unsigned)


def _jax_fake_quant(x, delta, bits, unsigned=False):
    y = _JAX_FAKE_QUANT(x, delta, bits, unsigned)
    jax.debug.callback(_fake_quant_callback(bits, unsigned), x, delta, y,
                       ordered=True)
    return y


def _jax_exp2_shift(t):
    jax.debug.callback(_record_exp2, t, ordered=True)
    return _JAX_EXP2_SHIFT(t)


class _Records(list):
    """fake_quant records, with the exp2_shift inputs beside them."""

    def __init__(self):
        super().__init__()
        self.exp2 = []


def edge_flips(jrec, trec) -> int:
    """Codes that differ between the packages (``chip_smoke.code_flips``,
    which also holds each output to its own x / delta; JAX's may divide by
    a multiply with the reciprocal where XLA compiles it); every one must
    be primary, at a rounding edge within the float sums' reach."""
    total, primary, _ = code_flips(jrec, trec, a_exact=False)
    assert total == primary, f"{total - primary} of {total} flips off an edge"
    return total


def forward_flips(monkeypatch, jrun, trun) -> int:
    """Run both forwards (no gradient) recording every fake_quant call and
    count the codes that differ (:func:`edge_flips`)."""
    with jax_fake_quant_records(monkeypatch) as jrec:
        jax.block_until_ready(jrun())
    with torch.no_grad(), FakeQuantTap() as tap:
        trun()
    return edge_flips(jrec, tap.calls)


class _Replayed(torch.autograd.Function):
    """fake_quant on another run's call: the forward returns that run's
    output, the backward is the port's own STE / LSQ
    (``quant._lsq_grads``) on this run's ``x / delta`` and that
    run's codes."""

    @staticmethod
    def forward(ctx, x, delta, bits, unsigned, rec):
        _, rdelta, _, _, value = rec
        dt = torch.promote_types(x.dtype, delta.dtype)
        ctx.save_for_backward(x.to(dt) / delta.to(dt),
                              torch.round(value.to(dt) / rdelta.to(dt)))
        ctx.delta_shape, ctx.delta_dtype = delta.shape, delta.dtype
        ctx.qrange = quant.qrange(bits, unsigned=unsigned)
        return value.to(x.dtype).clone()

    @staticmethod
    def backward(ctx, g):
        return (*quant._lsq_grads(ctx, g, *ctx.saved_tensors), None)


class JaxReplay:
    """Within ``with``: each of the port's fake_quant calls takes the output
    of the JAX call (:func:`jax_fake_quant_records`) nearest in x among
    those of the same bits, signedness and shape (under ``jax.grad`` JAX
    hoists a scan's loop-invariant calls, so the two orders differ), its
    gradient the port's own on JAX's codes (:class:`_Replayed`); each of
    the fake attention's ``exp2_shift`` calls takes JAX's side of every
    kink of ``floor`` (an input within float reach of an integer, where
    the slope halves), JAX's and its calls in the same order.  Records the
    port's own fake_quant calls in ``calls``, the JAX calls matched in
    ``matched`` (:func:`edge_flips` of the two shows where the port's own
    codes would have differed) and counts the kinks taken in ``kinks``."""

    def __init__(self, jrec):
        self.jrec, self.calls, self.matched, self.kinks = jrec, [], [], 0
        self.n_exp2 = 0

    def __enter__(self):
        self.orig = quant.fake_quant
        quant.fake_quant = self
        self.orig_exp2 = attention.exp2_shift
        attention.exp2_shift = self.exp2_shift
        return self

    def __exit__(self, *exc):
        quant.fake_quant = self.orig
        attention.exp2_shift = self.orig_exp2

    def __call__(self, x, delta, bits, unsigned=False):
        with torch.no_grad():
            own = self.orig(x, delta, bits, unsigned)
            xd = x.detach().clone()    # a training step updates in place
            gaps = [(float((r[0] - xd).abs().max()
                           / (r[0].abs().max() + 1e-30)), i)
                    for i, r in enumerate(self.jrec)
                    if r[2:4] == (bits, unsigned) and r[0].shape == x.shape]
        gap, i = min(gaps, default=(float("inf"), None))
        assert gap <= 1e-4, f"no JAX fake_quant call matches ({gap})"
        self.calls.append((xd, delta.detach().clone(), bits, unsigned, own))
        self.matched.append(self.jrec[i])
        return _Replayed.apply(x, delta, bits, unsigned, self.jrec[i])

    def exp2_shift(self, x):
        tj = self.jrec.exp2[self.n_exp2]
        self.n_exp2 += 1
        assert tj.shape == x.shape
        with torch.no_grad():
            # the row's floor-max shift between the packages (an integer),
            # then JAX's floor in the port's frame
            shift = torch.round(x - tj)
            f = torch.floor(tj) + shift
            kink = f != torch.floor(x)
            assert bool(((x - tj - shift).abs()[kink] <= FLIP_NEAR).all())
            self.kinks += int(kink.sum())
        return (1.0 + (x - f)) * softmax2.exp2i(f)


def hold_loss(monkeypatch, jloss, tloss, cases, *, aux=False):
    """JAX's loss and gradients against the port's on the same params and
    batch, for each ``(jparams, jbatch, tbatch)`` of ``cases``: the port on
    JAX's fake-quant codes and exp2_shift kinks (:class:`JaxReplay`), every
    code the port would have taken otherwise at a rounding edge.  JAX's
    ``value_and_grad(jloss)`` is compiled once for all cases.  Returns the
    (fake-quant flips, exp2 kinks) at edges over the cases."""
    jvg = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    flips = kinks = 0
    for jparams, jb, tb in cases:
        params = to_port(jparams)
        with jax_fake_quant_records(monkeypatch) as jrec:
            (jl, jm), jg = jvg(jparams, jb)
            jax.block_until_ready(jg)
        with JaxReplay(jrec) as rep:
            tl, tm, tg = torch_grads(lambda p: tloss(p, tb), params)
        flips += edge_flips(rep.matched, rep.calls)
        kinks += rep.kinks
        assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
        if aux:
            assert abs(float(tm["aux"].detach()) - float(jm["aux"])) <= \
                1e-6 * abs(float(jm["aux"]))
            assert float(jm["aux"]) > 0
        want = dict(tree_lib.leaves_with_paths(jax.tree.map(f32, jg)))
        assert sorted(want) == sorted(tg)
        for path, g in tg.items():
            assert g.shape == want[path].shape, path
            assert rel(g, want[path]) <= 1e-5, path
    return flips, kinks
