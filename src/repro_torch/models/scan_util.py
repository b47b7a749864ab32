"""``scan`` over a layer-stacked parameter tree, as a Python loop.

Counterpart of ``repro/models/scan_util.py``: ``jax.lax.scan`` becomes a
loop over the leading axis of ``xs`` (each leaf sliced as a view), so a
model reads like the reference.  The reference's ``full_unroll`` switch
exists for XLA's cost analysis and has no counterpart here.
"""
from __future__ import annotations


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _length(tree) -> int:
    if isinstance(tree, dict):
        return _length(next(iter(tree.values())))
    return tree.shape[0]


def scan(body, carry, xs):
    """``carry, y_i = body(carry, xs[i])`` for i along the leading axis;
    returns ``(carry, [y_i])``."""
    ys = []
    for i in range(_length(xs)):
        carry, y = body(carry, _index(xs, i))
        ys.append(y)
    return carry, ys
