"""Logical-axis sharding rules on a ``torch.distributed`` device mesh.

Counterpart of ``repro/distributed/sharding.py``.  The active
:class:`Rules` maps logical names to mesh axes and switches on the two
explicit shard bodies of the serving graph: the row-parallel integer
linear with its bf16 reduce (``core/api.py::_int_row_parallel``) and the
MoE all-to-all (``layers/moe.py::moe_ffn_a2a``).  ``Rules.mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are the
mesh axes ("pod", "data", "model", ...).

Parameter specs are derived from the tree's key paths exactly as the
reference derives them (column- vs row-parallel linears, expert-parallel
3-D weights, vocab-sharded embeddings); :class:`P` is a tuple of
per-dimension entries, equal entry for entry to JAX's ``PartitionSpec``
on the same tree.  :func:`named_shardings` turns specs into DTensor
placements on a mesh.

The port has no automatic partitioner.  ``Rules(partitioned=True)``
switches on the partitioned program of ``distributed/partition.py``,
where each rank holds only its shard of the weights and caches and the
cross-rank steps are written out (``Rules.seq_tp`` there splits the
residual's sequence over "model"); otherwise every rank runs the model on
global tensors, replicated, outside the two shard bodies, and ``seq_tp``
does nothing.  :func:`shard` is the identity either way (the reference's
is a GSPMD layout constraint, which never changes a value either).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

from repro_torch import tree as tree_lib

# Parent-key classification for linear weights ("w": (in, out)).
COL_PARALLEL = {"wq", "wk", "wv", "up", "gate", "w_gate", "w_in",
                "w_a", "w_i", "lm_head", "head", "patch"}
ROW_PARALLEL = {"wo", "down", "w_down", "w_out"}
REPLICATED = {"router", "in_proj", "out_proj"}  # ssd mixer + routers stay local


class P(tuple):
    """A partition spec: one entry per tensor dimension, each None
    (replicated), a mesh-axis name, or a tuple of names (major first).
    Entries are canonical as in JAX's ``PartitionSpec``: an empty tuple is
    None, a 1-tuple its one name."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, map(canon, entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    batch: tuple = ("pod", "data")
    seq: tuple = ()                # sequence parallelism axis, when used
    seq_tp: tuple = ()             # Megatron-SP: residual seq over TP axis
    model: tuple = ("model",)
    expert: tuple = ("model",)
    expert_cap: tuple = ("data",)  # expert-buffer capacity dim (EPxDP grid)
    mesh: object = None            # a DeviceMesh (enables the shard bodies)
    int_bf16_reduce: bool = False  # row-parallel int linears reduce in bf16
    moe_a2a: bool = False          # explicit all-to-all expert dispatch
    expert_fsdp: bool = False      # expert weights' dout sharded over "data"
    partitioned: bool = False      # rank-local trees (distributed/partition)

    def axes(self, name: str):
        ax = getattr(self, name, ())
        return ax if len(ax) != 1 else ax[0]

    @functools.cached_property
    def partition(self):
        """This rank's ``distributed/partition.py::Partition`` on
        ``mesh``, made once per rules object."""
        from repro_torch.distributed.partition import Partition
        return Partition(self)


_ACTIVE: list = []


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    _ACTIVE.append(rules)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_rules() -> Optional[Rules]:
    return _ACTIVE[-1] if _ACTIVE else None


def shard(x, *logical_axes):
    """The reference's activation layout constraint by logical axis names.

    Under GSPMD it tells the partitioner how to lay ``x`` out and never
    changes a value; the port has no partitioner, so it returns ``x``.  It
    stays at the reference's call sites, so the two graphs read alike.
    The layouts it would constrain are written out where the port runs
    partitioned: ``"seq_tp"`` (the residual's sequence over "model",
    ``Rules(partitioned=True, seq_tp=("model",))``) is
    ``distributed/partition.py::seq_split`` and the take, gathers and
    reduce-scatters of ``models/lm.py``'s blocks.
    """
    return x


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh (a ``DeviceMesh``, or any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


# ---------------------------------------------------------------------------
# Parameter shardings from tree structure
# ---------------------------------------------------------------------------

def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def _spec_for(path_keys: list[str], leaf) -> P:
    ndim = _ndim(leaf)
    name = path_keys[-1] if path_keys else ""
    parent = path_keys[-2] if len(path_keys) > 1 else ""
    # Scan-stacked leading dim ("units", "layers", "enc_layers", ...).
    stacked = 1 if any(k == "units" or k.endswith("layers")
                       for k in path_keys) else 0
    pad = (None,) * stacked

    def spec(*s):
        if stacked + len(s) != ndim:
            raise ValueError(f"{path_keys}: {ndim}-d leaf, spec {s}")
        return P(*pad, *s)

    if ndim == 0:
        return P()
    # Embeddings: vocab-sharded rows.
    if name in ("emb", "emb_q"):
        return spec("model", None)
    if name == "emb_scale":
        return spec("model")
    if name in ("pos_emb", "cls"):
        return P(*((None,) * ndim))
    # Expert-parallel 3D weights.
    if ndim - stacked == 3 and name in ("w", "w_q", "w_scale"):
        return spec("model", None, None)
    if parent in REPLICATED:
        return P(*((None,) * ndim))
    if parent in COL_PARALLEL:
        if name == "w":
            return spec(None, "model")
        if name == "w_q":
            return spec("model", None)
        if name in ("b", "w_scale"):
            return spec("model")
    if parent in ROW_PARALLEL:
        if name == "w":
            return spec("model", None)
        if name == "w_q":
            return spec(None, "model")
        if name in ("b", "w_scale"):     # out-dim params: replicated
            return spec(None)
    # Elementwise params living on a model-sharded feature dim.
    if name == "lam":
        return spec("model")
    if name == "conv_w" and "rglru" in path_keys:
        return spec(None, "model")      # (width, d_rnn), d_rnn is TP-sharded
    return P(*((None,) * ndim))


def _specs_by_keys(tree, fn):
    return tree_lib.unflatten(
        tree, [fn(list(keys), leaf)
               for keys, leaf in tree_lib.leaves_with_keys(tree)])


def _map_specs(fn, spec_tree, tree):
    """fn(spec, leaf) over a spec tree and the tree it mirrors."""
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v, tree[k]) for k, v in spec_tree.items()}
    return fn(spec_tree, tree)


def param_specs(params, *, expert_fsdp: bool = False):
    """A :class:`P` tree mirroring ``params`` (tensors, or anything with
    ``ndim`` / ``shape``, e.g. meta tensors).

    ``expert_fsdp``: additionally shard MoE expert weights' output dim over
    "data" (FSDP-style), as the reference does to fit training states.
    """
    def one(keys, leaf):
        spec = _spec_for(keys, leaf)
        if (expert_fsdp and keys and keys[-1] in ("w", "w_q", "w_scale")
                and len(keys) > 1 and keys[-2].startswith("experts_")):
            entries = list(spec)
            entries[-1] = "data"          # (.., E, din, dout): dout over data
            spec = P(*entries)
        return spec
    return _specs_by_keys(params, one)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def zero1_specs(state, spec_tree, *, data_size: int, axis: str = "data"):
    """ZeRO-1: extend each optimizer-state spec with ``axis`` on the best
    unsharded dim (the largest of those ``data_size`` divides)."""
    def extend(spec, leaf):
        if not hasattr(leaf, "shape") or _ndim(leaf) == 0:
            return spec
        entries = list(spec)
        if any(axis in _names(e) for e in entries):
            return spec                # already data-sharded (e.g. FSDP)
        div = [i for i, e in enumerate(entries) if e is None
               and leaf.shape[i] % data_size == 0
               and leaf.shape[i] >= data_size]
        if not div:
            return spec
        i = max(div, key=lambda j: leaf.shape[j])
        entries[i] = axis
        return P(*entries)

    return _map_specs(extend, spec_tree, state)


def batch_specs(batch_abs, batch_axes):
    """Input batch specs: leading (batch) dim over ``batch_axes``."""
    ax = batch_axes if len(batch_axes) != 1 else batch_axes[0]

    def f(leaf):
        nd = _ndim(leaf)
        if nd == 0 or not batch_axes:
            return P(*((None,) * nd))
        return P(ax, *((None,) * (nd - 1)))

    return tree_lib.tree_map(f, batch_abs)


def cache_specs(cache_abs, batch_axes):
    """KV / recurrent-cache specs: batch over ``batch_axes``, the cache
    sequence over "model" (kv heads rarely divide the TP degree), states'
    feature dim over "model" where their projections are TP-sharded."""
    bax = batch_axes if len(batch_axes) != 1 else (
        batch_axes[0] if batch_axes else None)

    def one(keys, leaf):
        name = keys[-1]
        nd = _ndim(leaf)
        stacked = 1 if ("units" in keys or "layers" in keys) else 0
        pad = (None,) * stacked
        if name in ("k", "v", "ek", "ev") and nd - stacked == 4:
            return P(*pad, bax, None, "model", None)
        if name == "h" and nd - stacked == 2:          # rglru state
            return P(*pad, bax, "model")
        if name == "conv" and nd - stacked == 3:
            return P(*pad, bax, None, "model")
        if name == "h" and nd - stacked == 4:          # ssd state
            return P(*pad, bax, None, None, None)
        return P(*((None,) * nd))
    return _specs_by_keys(cache_abs, one)


def enforce_divisible(spec_tree, abs_tree, mesh):
    """Drop sharding on any dim whose size the axis size does not divide
    (e.g. vocab 50280 over 16)."""
    sizes = axis_sizes(mesh)

    def fix(spec, leaf):
        shape = getattr(leaf, "shape", None)
        if shape is None or not isinstance(spec, P):
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, entry in zip(shape, entries):
            n = 1
            for a in _names(entry):
                n *= sizes[a]
            out.append(entry if n == 1 or dim % n == 0 else None)
        return P(*out)

    return _map_specs(fix, spec_tree, abs_tree)


def filter_mesh_axes(spec_tree, mesh):
    """Drop mesh-axis names that the mesh does not have (e.g. no "pod")."""
    names = set(mesh.mesh_dim_names)

    def fix(spec: P) -> P:
        out = []
        for entry in spec:
            if isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a in names)
                out.append(kept if kept else None)
            else:
                out.append(entry if entry in names else None)
        return P(*out)

    return tree_lib.tree_map(fix, spec_tree)


def placements(spec: P, mesh) -> list:
    """DTensor placements of one spec: for each mesh dimension, ``Shard``
    of the tensor dim it splits, else ``Replicate``.  A dim split over
    several axes takes them major first, as the mesh orders them."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _names(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def named_shardings(tree_specs, mesh):
    """Spec tree -> tree of DTensor placement lists on ``mesh``."""
    return tree_lib.tree_map(lambda s: placements(s, mesh), tree_specs)
