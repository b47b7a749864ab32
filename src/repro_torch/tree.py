"""Parameter trees (nested dicts of tensors) walked as JAX walks pytrees.

``jax.tree_util`` flattens a dict in sorted key order and names a leaf by
its path, ``jax.tree_util.keystr`` style: ``['params']['units']['w']``.
The optimizer's global norm (a sum over leaves), its update loop and the
checkpoint's leaf names all depend on that order, so the port walks its
trees the same way here (Python dicts keep insertion order instead).
"""
from __future__ import annotations

from typing import Callable

import torch


def leaves_with_keys(tree, keys: tuple = ()) -> list[tuple[tuple, object]]:
    """(keys from the root, leaf) for every non-dict leaf, in sorted key
    order: the ``key`` of each entry of a ``tree_flatten_with_path`` path."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_keys(tree[k], keys + (k,)))
        return out
    return [(keys, tree)]


def leaves_with_paths(tree) -> list[tuple[str, torch.Tensor]]:
    """(keystr path, leaf) for every non-dict leaf, in sorted key order."""
    return [("".join(f"[{k!r}]" for k in keys), leaf)
            for keys, leaf in leaves_with_keys(tree)]


def leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, flat: list):
    """A tree shaped like ``like`` holding ``flat`` (in sorted key order)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
