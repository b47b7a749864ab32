"""``scan`` over a layer-stacked parameter tree, as a Python loop, and
``remat``.

Counterpart of ``repro/models/scan_util.py``: ``jax.lax.scan`` becomes a
loop over the leading axis of ``xs`` (each leaf sliced as a view), so a
model reads like the reference.  The reference's ``full_unroll`` switch
exists for XLA's cost analysis and has no counterpart here.
:func:`remat` stands for the models' ``jax.checkpoint``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _length(tree) -> int:
    if isinstance(tree, dict):
        return _length(next(iter(tree.values())))
    return tree.shape[0]


def remat(f, enabled: bool):
    """``f``, recomputed in the backward pass instead of keeping its
    activations (``torch.utils.checkpoint``), when ``enabled`` and grad is
    on; ``f`` itself otherwise.  Recompute changes no number."""
    if not (enabled and torch.is_grad_enabled()):
        return f
    return functools.partial(checkpoint, f, use_reentrant=False)


def scan(body, carry, xs):
    """``carry, y_i = body(carry, xs[i])`` for i along the leading axis;
    returns ``(carry, [y_i])``."""
    ys = []
    for i in range(_length(xs)):
        carry, y = body(carry, _index(xs, i))
        ys.append(y)
    return carry, ys
