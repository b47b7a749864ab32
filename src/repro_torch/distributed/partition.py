"""Partitioned execution of the ring serving steps: each rank holds only
its shard of the weights and of the caches.

The port's counterpart of the reference's ``jax.jit(prefill / decode_step,
in_shardings=...)`` (``repro/launch/dryrun.py``), where GSPMD partitions
the program from its shardings.  Here every rank runs the model code on
its local tensors, and the few steps that cross ranks are written out.

**The switch.**  ``Rules(partitioned=True, mesh=...)`` under
``sharding.use_rules``; the model reads it only through :func:`active`,
which returns this rank's :class:`Partition` (None when off).  Under it
``models/lm.py``'s :func:`~repro_torch.models.lm.prefill` and
:func:`~repro_torch.models.lm.decode_step`, and ``models/encdec.py``'s
:func:`~repro_torch.models.encdec.prefill` and
:func:`~repro_torch.models.encdec.decode_step`, take the same global
inputs as on one card, run on the rank's batch rows, and return the same
global logits on every rank; only the parameters (:func:`partition_params`
or :func:`build_params`) and the ring cache, recurrent states included,
are rank-local.  :func:`check_tree` refuses a global tree under
partitioned rules and a partitioned tree without them (``ValueError``).
The paged engine and the losses in int mode (``lm.lm_loss``,
``encdec.loss_fn``) raise ``NotImplementedError`` under them; each
message names its ROADMAP item.  The rules' two communication options
run on the rank's operands: ``int_bf16_reduce`` takes every
``dense(tp="row")`` in int mode through the shard body
``core/api.py::_int_row_parallel`` (a per-tensor grid of the rank's own,
an f32 reduce-scatter and a bf16 all-gather over "model"), and
``moe_a2a`` every MoE FFN whose rank's tokens split over "model" through
``layers/moe.py::moe_ffn_a2a`` (two all-to-alls), as the reference's
``shard_map`` bodies compute them; neither is then bitwise one rank's
run, as in the reference.  ``mode="int"`` serves partitioned, every
family; modes "float" and "fake" train every family partitioned
(``lm.lm_loss`` for the decoder LMs, attention, RG-LRU and SSD stacks
alike, and ``encdec.loss_fn`` for Whisper, through
``launch/train.py::make_train_step``, with gradients through every
exchange: :class:`Partition`), and ``core/api.py::integerize_params``
turns a trained local tree into the local int tree that serves.

**Layout.**  Each leaf splits as ``sharding.param_specs`` says, after
``filter_mesh_axes`` and ``enforce_divisible``: column-parallel weights
(wq, wk, wv, gate, up, lm_head; the RG-LRU's w_gate, w_in, w_a, w_i) and
their biases by output rows, row-parallel ones (wo, down, w_out) by K as
stored (nibble bytes kept whole, so K/m is even), the RG-LRU's ``conv_w``
and ``lam`` by d_rnn, experts by E, the embedding by vocabulary rows;
norms, the router, the SSD mixer (``in_proj``, ``out_proj``, ``conv_w``,
``dt_bias``, ``A_log``, ``D``, ``norm_gamma``) and row-parallel biases
stay whole.  Local shapes equal the reference's shard shapes.  A decoder
LM's attention splits in one of two ways (:func:`split_plan`): by whole
KV groups where the model ranks divide the KV heads ("heads": the port's
GQA layout, ``q.reshape(b, hkv, g, ...)``, maps a contiguous range of
query heads onto a contiguous range of KV heads, so a rank attends its
own heads and exchanges nothing until wo), else by flat columns
("columns", where the reference's cut divides ``n_heads * hd``, ``kv_heads
* hd`` and, packed, wo's K in bytes): a rank's wq, wk and wv columns may
end inside a head (ChatGLM3's wk has 256 columns, 64 a rank at m = 4;
RecurrentGemma's one KV head of 256 splits at every m > 1), so the ranks
all-gather q, k and v after their column products (bytes: exact), every
rank attends every head, and feeds its K slice of the output to wo.
Whisper's attention (MHA: ``EncDecConfig`` has no ``kv_heads``) splits by
whole heads of ``n_heads`` or stays whole.  The other groups (a
feed-forward's up, gate and down, Whisper's ``mlp`` too; the RG-LRU; the
experts; the embedding and lm_head) likewise split only as a whole.  The
batch splits over ``Rules.batch``.  The caches split by row over the
batch axes and, over "model", a ring by KV head where attention splits by
head (Whisper's self-attention ring and cross K/V by head), by slot where
it splits by column, as the reference's ``cache_specs`` (kept as it is in
``sharding.py``), whole where the ranks do not divide its span (a rank's
whole ring is marked :data:`RING_WHOLE`); the RG-LRU's ``h`` and ``conv``
by d_rnn; the SSD state stays whole over "model"
(:func:`local_cache_specs`).  A decode step over a ring split by slot runs
the ring kernel's three launches as stages with an exact cross-rank merge
between them (``models/lm.py::_ring_split_decode``, ``kernels/dispatch.py::
maybe_staged_decode``: the chunk maxima and the f32 Sigma partials
all-gathered, per chunk, the per-block int32 PV all-reduced), where each
rank's slots are whole chunks of the kernel's; elsewhere, and on the
``torch`` backend's real tensors, the ranks all-gather the ring's codes.

With ``Rules.seq_tp = ("model",)`` (the reference's ``sp`` variant,
Megatron-SP; :func:`seq_split`) the residual stream splits too: from the
embedding (:meth:`Partition.take`) to the final norm (gathered, so
``lm.forward`` still returns whole hidden states), a rank holds the
contiguous chunk j of the sequence of its batch rows, j its index on
"model".  Each half-block normalizes the rank's rows, all-gathers the
normed stream along S (bf16 as bytes: :func:`model_input`), runs its mixer
or feed-forward on the whole sequence as without the split (ring writes,
recurrent states, MoE capacity unchanged), and keeps the rank's chunk of
the output: a row-parallel product with a split K (wo, by head or by
column) reduce-scatters its sums along S where it would all-reduce them,
and an output every rank holds whole (attention kept whole, the SSD
mixer, the MoE FFN) is narrowed.
Where m does not divide S the residual stays whole for the call: every
decode step, and a prompt length m does not divide (the reference's GSPMD
pads or replicates there).  ``seq_tp`` with ``int_bf16_reduce`` or
``moe_a2a``, which the reference never runs together, raises
``NotImplementedError`` when the rank's :class:`Partition` is made;
without partitioned rules ``seq_tp`` does nothing, as ``sharding.shard``.
Whisper's stacks (``models/encdec.py``) do not split.

**Exactness.**  A partitioned int-mode run without the two options is
bitwise equal to one rank's run of the same tree wherever it was
checked: meshes (1, 4), (2, 2) and (4, 1) at SMOKE size on the CPU, and
``chip_smoke.py``'s ``[tp]`` and ``[tp-families]`` runs on the card.  Every cross-rank step
is exact, and a rank's float arithmetic is made independent of the slice
it holds where it was not (modes "float" and "fake" sum f32 partial
products and gradients over ranks, so past one rank they part as the
reference's sharded train cell parts from its one-device run):

- a quantizer grid that spans a split dimension takes its max over the
  mesh (:func:`grid_max`): over "model" where it spans heads or a
  row-parallel K (the RG-LRU's ``h * gate`` over d_rnn), and also over
  the batch axes where it is per tensor;
- a row-parallel linear (:func:`row_parallel_linear`; without
  ``int_bf16_reduce``) all-reduces its int32 sums over "model" (the
  qmatmul kernel's accumulator output) and applies the f32 epilogue,
  bias included, once, to the full sum;
- attention split by column gathers q, k and v as bytes, so every rank
  attends the same tensors as one rank; a ring split by slot merges the
  ranks' stages exactly: the chunk maxima and Sigma partials gathered in
  slot order (the kernel's merge adds the same partials in the same
  order), the per-block PV summed as int32; the ``torch`` backend, whose
  one-rank path sums Sigma over whole rows, gathers the ring's codes;
- the RG-LRU's scan, step, temporal conv and float gates act per
  feature, and the SSD mixer per row, so neither exchanges anything;
  a decode step's gates run as matmuls of one shape
  (``layers/rglru.py::gate_step``), and the norms' row means pad a few
  rows to 16 on the card (``layers/norms.py``), since cuBLAS and torch's
  row reductions pick their order by the shape of a call; other float
  products (the prefill's gates) keep cuBLAS, bitwise at the checked
  shapes but not by construction;
- the vocabulary-split embedding sums one non-zero term per element; the
  logits (along the vocabulary), the expert outputs (along E) and the
  batch rows are gathered.

Under ``seq_tp`` an int-mode run is bitwise the same partitioned run
without it, on every mesh: a reduce-scatter of int32 sums is exact
(``collectives.reduce_scatter_dim`` keeps int32), and the norms, grids and
epilogues act per row.  In modes "float" and "fake" the forward is the
same arithmetic but for the order in which an f32 reduce-scatter adds the
ranks' partial products (the same sum as the all-reduce's at m = 2), and a
norm's gain, used on the rank's rows, sums its gradient over "model" in
another order than one sum over all rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.registry import is_encdec
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (P, _names, current_rules,
                                              enforce_divisible,
                                              filter_mesh_axes, param_specs,
                                              zero1_specs)

ROADMAP_ITEM = "ROADMAP.md queue 1, item 6c (partitioned execution)"
# what is still to do: the paged engine, which the reference never
# shards, stays whole
PAGED = "ROADMAP.md queue 1, item 6c.4 (the paged engine)"
# the sequence split with the shard bodies, which the reference never
# runs together (its dry run takes one variant a cell)
SP_BODIES = ("ROADMAP.md section 3, recorded differences: 'sp' with "
             "int_bf16_reduce or moe_a2a")


@dataclasses.dataclass(frozen=True)
class Layout:
    """A mesh's axis sizes and one rank's coordinates on it, in mesh order,
    and the batch axes it has.  Stands in for a ``DeviceMesh`` in
    ``sharding``'s functions (``mesh_dim_names``, ``shape``), so a tree can
    be sliced for any rank without a process group."""
    sizes: tuple                  # ((axis, size), ...)
    coords: tuple                 # ((axis, index), ...)
    batch: tuple = ()             # the batch axes present, major first
    fsdp: bool = False            # experts' dout split over "data"

    @classmethod
    def make(cls, sizes: dict, coords: Optional[dict] = None,
             batch=("pod", "data"), fsdp: bool = False) -> "Layout":
        coords = coords or {}
        return cls(tuple(sizes.items()),
                   tuple((a, coords.get(a, 0)) for a in sizes),
                   tuple(a for a in batch if a in sizes), fsdp)

    @classmethod
    def of(cls, mesh, batch=("pod", "data"), fsdp: bool = False) -> "Layout":
        """This rank's layout on a ``DeviceMesh``."""
        names = tuple(mesh.mesh_dim_names)
        return cls.make(dict(zip(names, tuple(mesh.shape))),
                        {a: mesh.get_local_rank(a) for a in names}, batch,
                        fsdp)

    @property
    def mesh_dim_names(self) -> tuple:
        return tuple(a for a, _ in self.sizes)

    @property
    def shape(self) -> tuple:
        return tuple(n for _, n in self.sizes)

    def size(self, axes) -> int:
        sizes = dict(self.sizes)
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
        return n

    def index(self, axes) -> int:
        """The linear index over ``axes``, major first."""
        sizes, coords = dict(self.sizes), dict(self.coords)
        i = 0
        for a in axes:
            i = i * sizes.get(a, 1) + coords.get(a, 0)
        return i

    @property
    def m(self) -> int:
        return self.size(("model",))


def _packed(cfg) -> bool:
    q = cfg.quant
    return q is not None and q.pack_weights and q.w_bits == 4


def _kv_heads(cfg) -> int:
    return cfg.n_heads if is_encdec(cfg) else cfg.kv_heads


def d_rnn(cfg) -> int:
    """The RG-LRU's width (``models/lm.py::_init_block``'s default)."""
    return getattr(cfg, "d_rnn", None) or cfg.d_model


def split_plan(cfg, m: int) -> dict:
    """Which groups of the tree split over ``m`` model ranks, and how
    attention does: "heads" (by whole KV groups, and each rank keeps its
    KV heads' ring; Whisper's attention by whole heads), "columns" (a
    decoder LM whose KV heads ``m`` does not divide: wq, wk and wv by flat
    output columns and wo by K, as the reference's ``param_specs`` cut
    them, a cut falling inside a head, and the ring by slot) or False
    (whole); a feed-forward ("ffn": an LM's, the shared expert's,
    Whisper's ``mlp``), the RG-LRU by d_rnn, the experts, the vocabulary.
    A row-parallel K stored as nibbles must split into whole bytes."""
    def ok(n, stored=None):
        return m > 1 and n % m == 0 and \
            (not _packed(cfg) or stored is None or stored % m == 0)
    moe = getattr(cfg, "moe", None)
    q_cols, kv_cols = cfg.n_heads * cfg.hd, _kv_heads(cfg) * cfg.hd
    lm_attn = not is_encdec(cfg) and any(k in ("attn", "local")
                                         for k in cfg.block_pattern)
    heads = "heads" if ok(_kv_heads(cfg), q_cols // 2) else \
        "columns" if lm_attn and ok(q_cols, q_cols // 2) and ok(kv_cols) \
        else False
    return {"heads": heads,
            "ffn": cfg.d_ff > 0 and ok(cfg.d_ff, cfg.d_ff // 2),
            "rglru": ok(d_rnn(cfg), d_rnn(cfg) // 2),
            "experts": moe is not None and ok(moe.n_experts),
            "vocab": ok(cfg.vocab)}


ATTN_KEYS = ("attn", "self_attn", "cross_attn")


def _group(keys) -> Optional[str]:
    if "embed" in keys or "lm_head" in keys:
        return "vocab"
    if any(k in ATTN_KEYS for k in keys):
        return "heads"
    if "rglru" in keys:
        return "rglru"
    if len(keys) > 1 and keys[-2].startswith("experts_"):
        return "experts"
    if ("ffn" in keys or "mlp" in keys) and len(keys) > 1 and \
            keys[-2] in ("up", "gate", "down"):
        return "ffn"
    return None


def _whole_groups(specs, cfg, layout):
    """``specs`` with "model" dropped from every leaf of a group that
    :func:`split_plan` keeps whole."""
    plan = split_plan(cfg, layout.m)

    def fix(keys, spec):
        g = _group(keys)
        if g is None or plan[g]:
            return spec
        return P(*(None if "model" in _names(e) else e for e in spec))

    flat = tree_lib.leaves_with_keys(specs)
    return tree_lib.unflatten(specs, [fix(list(k), s) for k, s in flat])


def _plan_specs(params, cfg, layout):
    """``param_specs`` on ``layout``'s axes (the experts' dout over "data"
    with ``layout.fsdp``), each group whole unless :func:`split_plan`
    splits it.  Depends on the tree's keys and leaf ranks only, so a local
    tree gives its global tree's specs."""
    return _whole_groups(filter_mesh_axes(
        param_specs(params, expert_fsdp=layout.fsdp), layout), cfg, layout)


def local_param_specs(params, cfg, layout):
    """The specs :func:`partition_params` slices the global ``params`` by;
    raises where ``enforce_divisible`` would drop a split the plan keeps
    (a group must split as a whole)."""
    specs = _plan_specs(params, cfg, layout)
    kept = enforce_divisible(specs, params, layout)
    for (keys, s), (_, k) in zip(tree_lib.leaves_with_keys(specs),
                                 tree_lib.leaves_with_keys(kept)):
        if s != k:
            raise ValueError(f"{'/'.join(keys)}: spec {s} does not divide "
                             f"the leaf on {dict(layout.sizes)}")
    return specs


def _region(spec, shape, layout):
    """(dim, start, size) of this rank's block of a leaf of ``shape``
    (the local shape when ``shape`` is global)."""
    out = []
    for dim, entry in enumerate(spec):
        axes = _names(entry)
        if axes:
            size = shape[dim] // layout.size(axes)
            out.append((dim, layout.index(axes) * size, size))
    return out


def _slice(t, spec, layout):
    region = _region(spec, t.shape, layout)
    if not region:
        return t
    for dim, start, size in region:
        t = t.narrow(dim, start, size)
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def partition_params(params, cfg, layout: Layout):
    """The rank's local tree of the global ``params``: each split leaf a
    contiguous copy of its block, the whole ones shared.  An integerized
    tree is sliced as stored (a row-parallel ``w_q`` over its nibble
    bytes).  ``layout``: :meth:`Layout.of` a mesh, or :meth:`Layout.make`
    for any rank without a process group."""
    specs = local_param_specs(params, cfg, layout)
    return _map2(lambda t, s: _slice(t, s, layout), params, specs)


def _assemble(parts, specs):
    """The global tree of ``parts`` [(layout, local tree)], which hold
    every block of every leaf; replicas must agree."""
    layout0, tree0 = parts[0]
    flat_specs = tree_lib.leaves(specs)
    locals_ = [tree_lib.leaves(t) for _, t in parts]
    out = []
    for i, spec in enumerate(flat_specs):
        leaf = locals_[0][i]
        shape = list(leaf.shape)
        for dim, entry in enumerate(spec):
            shape[dim] *= layout0.size(_names(entry))
        full = torch.empty(shape, dtype=leaf.dtype, device=leaf.device)
        filled = torch.zeros(shape, dtype=torch.bool, device=leaf.device)
        for (layout, _), loc in zip(parts, locals_):
            idx = [slice(None)] * len(shape)
            for dim, start, size in _region(spec, shape, layout):
                idx[dim] = slice(start, start + size)
            idx = tuple(idx)
            seen = filled[idx]
            if bool(seen.any()) and not torch.equal(full[idx][seen],
                                                    loc[i][seen]):
                raise ValueError(f"replicas of leaf {i} disagree")
            full[idx] = loc[i]
            filled[idx] = True
        if not bool(filled.all()):
            raise ValueError(f"leaf {i}: the parts do not cover it")
        out.append(full)
    return tree_lib.unflatten(tree0, out)


def gather_params(parts, cfg):
    """The inverse of :func:`partition_params`: the global tree from every
    rank's ``(layout, local tree)``."""
    return _assemble(parts, _plan_specs(parts[0][1], cfg, parts[0][0]))


# A layer's ring kept whole on a rank where attention splits by column
# (its span is not a multiple of the model ranks, as the reference's
# enforce_divisible keeps it) carries this key, a leaf of no elements: a
# rank's ring is a slot range of the whole ring unless it does.
RING_WHOLE = "ring_whole"


def local_cache_specs(cache, cfg, layout: Layout, *, local: bool = False):
    """Specs of a ring cache (the global one, or with ``local`` a rank's):
    every per-row leaf by row over the batch axes; over "model", attention
    codes ``(B, Hkv, span, hd[/2])`` (and Whisper's ``k``, ``v``, ``ek``,
    ``ev``) by KV head where attention splits by head, by slot where it
    splits by column and the model ranks divide the span (the reference's
    ``cache_specs``; else whole, marked :data:`RING_WHOLE` on a rank), the
    RG-LRU's ``h (B, d_rnn)`` and ``conv (B, 3, d_rnn)`` by d_rnn where it
    splits; the SSD's ``h (B, H, P, N)`` and ``convs (B, 3, d_conv)`` by
    row only; scales and ``pos`` whole."""
    plan = split_plan(cfg, layout.m)
    b = layout.batch if len(layout.batch) != 1 else layout.batch[0]
    b = b or None
    rnn = "model" if plan["rglru"] else None
    # (KV head, slot) of a ring
    ring = {"heads": ("model", None), "columns": (None, "model")}.get(
        plan["heads"], (None, None))
    whole = _whole_rings(cache, layout, local) \
        if plan["heads"] == "columns" else set()

    def one(keys, leaf):
        pad = (None,) * (1 if "units" in keys or "layers" in keys else 0)
        nd, name = leaf.ndim - len(pad), keys[-1]
        if name in ("k", "v", "ek", "ev") and nd == 4:
            return P(*pad, b, *((None, None) if tuple(keys[:-1]) in whole
                                else ring), None)
        if name == "h" and nd == 2:                       # RG-LRU
            return P(*pad, b, rnn)
        if name == "conv" and nd == 3:
            return P(*pad, b, None, rnn)
        if (name, nd) in (("h", 4), ("convs", 3)):        # SSD
            return P(*pad, b, *((None,) * (nd - 1)))
        return P(*((None,) * leaf.ndim))
    return tree_lib.unflatten(cache, [one(list(k), v) for k, v in
                                      tree_lib.leaves_with_keys(cache)])


def _whole_rings(cache, layout, local):
    """The layers (key paths) whose ring stays whole where attention splits
    by column: a global ring whose span the model ranks do not divide, a
    rank's ring marked :data:`RING_WHOLE`."""
    whole = set()
    for keys, leaf in tree_lib.leaves_with_keys(cache):
        if keys[-1] == RING_WHOLE or (keys[-1] == "k" and not local and
                                      leaf.shape[-2] % layout.m):
            whole.add(tuple(keys[:-1]))
    return whole


def _mark_whole(local, cache, cfg, layout):
    """A rank's cache ``local`` of the global ``cache`` (or its shapes)
    with :data:`RING_WHOLE` in each layer whose ring stays whole."""
    if split_plan(cfg, layout.m)["heads"] != "columns":
        return local
    for layer in _whole_rings(cache, layout, False):
        d = local
        for k in layer:
            d = d[k]
        d[RING_WHOLE] = d["k"].new_zeros((*d["k"].shape[:-4], 0))
    return local


def partition_cache(cache, cfg, layout: Layout):
    """The rank's shard of a global ring cache (the inverse of
    :func:`gather_cache`)."""
    specs = local_cache_specs(cache, cfg, layout)
    return _mark_whole(_map2(lambda t, s: _slice(t, s, layout), cache,
                             specs), cache, cfg, layout)


def gather_cache(parts, cfg):
    """The global ring cache from every rank's ``(layout, local cache)``
    (:data:`RING_WHOLE` markers dropped)."""
    whole = _assemble(parts, local_cache_specs(parts[0][1], cfg,
                                               parts[0][0], local=True))

    def drop(d):
        return {k: drop(v) if isinstance(v, dict) else v
                for k, v in d.items() if k != RING_WHOLE}
    return drop(whole)


def local_kv_heads(cfg, m: int) -> int:
    kv = _kv_heads(cfg)
    return kv // m if split_plan(cfg, m)["heads"] == "heads" else kv


def attn_columns(cfg) -> bool:
    """Whether the active partitioned program splits ``cfg``'s attention
    by column (:func:`split_plan`): every model rank then holds every head
    of q, k and v after its column products, and a ring by slot."""
    part = active()
    return part is not None and split_plan(cfg, part.m)["heads"] == \
        "columns"


def init_cache(cfg, batch: int, max_len: int, layout: Layout, *,
               device="cuda"):
    """The rank's ring cache for a global ``batch``: its rows over the
    batch axes, its KV heads (Whisper's heads) or its slots of each ring,
    its RG-LRU features (:func:`local_cache_specs`), allocated at the
    local shapes only."""
    n_dp = layout.size(layout.batch)
    if batch % n_dp:
        raise ValueError(f"batch {batch} over {n_dp} batch ranks")
    if is_encdec(cfg):
        from repro_torch.models import encdec
        whole = encdec.init_cache(cfg, batch, max_len, device="meta")
    else:
        from repro_torch.models import lm
        whole = lm.init_cache(cfg, batch, max_len, device="meta")
    specs = local_cache_specs(whole, cfg, layout)

    def local(keys, t, spec):
        shape = list(t.shape)
        for dim, _, size in _region(spec, shape, layout):
            shape[dim] = size
        # scales start at 1; codes, states and positions at 0
        return torch.full(shape, 1 if keys[-1].endswith("_scale") else 0,
                          dtype=t.dtype, device=device)
    return _mark_whole(tree_lib.unflatten(whole, [
        local(keys, t, spec) for (keys, t), spec in zip(
            tree_lib.leaves_with_keys(whole), tree_lib.leaves(specs))]),
        whole, cfg, layout)


# ---------------------------------------------------------------------------
# The rank's state under partitioned rules
# ---------------------------------------------------------------------------

class _Sum(torch.autograd.Function):
    """Forward a sum over ranks, backward the identity: the ranks hold
    parts of one value, which every rank then uses alike."""
    @staticmethod
    def forward(ctx, t, groups):
        return col.reduce_sum(t, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    """Forward a reduce-scatter along ``dim``: the sum over ranks of
    their parts, of which each rank keeps its chunk (int32 exact, floats
    in f32, cast back); backward the all-gather of the chunks' gradients,
    since every rank's part entered the whole sum."""
    @staticmethod
    def forward(ctx, t, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        return col.reduce_scatter_dim(t, groups, dim)

    @staticmethod
    def backward(ctx, g):
        return col.gather_dim(g, ctx.groups, ctx.dim), None, None


class _Counted(torch.autograd.Function):
    """Forward the identity, backward a division by ``n``: a value every
    rank of a sum of the loss holds alike, counted once in that sum."""
    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Take(torch.autograd.Function):
    """This rank's chunk of a value every rank holds alike; the backward
    gathers the chunks' gradients back into the whole."""
    @staticmethod
    def forward(ctx, t, groups, dim, index, n):
        ctx.groups, ctx.dim = groups, dim
        return t.narrow(dim, index * n, n)

    @staticmethod
    def backward(ctx, g):
        return col.gather_dim(g, ctx.groups, ctx.dim), None, None, None, None


class _Mean(torch.autograd.Function):
    """The mean of the ranks' values over ``groups``, which every rank
    then holds alike.  The backward sums the incoming gradient over
    ``parts`` (the batch groups, whose ranks each hold a part of it) and
    divides by the count: each rank's value enters the mean once."""
    @staticmethod
    def forward(ctx, t, groups, parts, n):
        ctx.parts, ctx.n = parts, n
        return col.reduce_sum(t, groups) / n

    @staticmethod
    def backward(ctx, g):
        if ctx.parts:
            g = col.reduce_sum(g, ctx.parts)
        return g / ctx.n, None, None, None


class _Max(torch.autograd.Function):
    """The max of ``xa`` over ``dims`` (kept, size 1) and over the ranks of
    ``groups``.  The backward first sums the incoming gradient over those
    ranks (each holds the part of it from its own share of the work), then
    hands it to every element, on any rank, equal to the max, divided by
    their count over all ranks: what ``jnp.max``'s gradient gives each
    element of the whole tensor (``ct / count``, then the 0/1 mask)."""
    @staticmethod
    def forward(ctx, xa, dims, groups):
        out = xa.amax(dim=dims, keepdim=True).to(torch.float32).clone()
        for grp in groups:                    # exact for bf16 and f32
            col.all_reduce(out, grp, op=torch.distributed.ReduceOp.MAX)
        out = out.to(xa.dtype)
        ctx.save_for_backward(xa, out)
        ctx.dims, ctx.groups = dims, groups
        return out

    @staticmethod
    def backward(ctx, g):
        xa, out = ctx.saved_tensors
        hit = xa == out
        count = col.reduce_sum(hit.sum(dim=ctx.dims, keepdim=True,
                                       dtype=torch.float32), ctx.groups)
        ct = col.reduce_sum(g, ctx.groups)
        return (ct / count.to(xa.dtype)) * hit.to(xa.dtype), None, None


class Partition:
    """This rank on the mesh of partitioned rules: its layout and the
    exchanges of the partitioned program (NCCL for CUDA tensors, gloo for
    CPU ones; bf16 travels as its bytes where it is moved, and is
    widened, exactly, where it is summed).

    Every exchange carries gradients.  A rank's backward gives, for a
    tensor that the model ranks hold alike, its whole gradient (the same
    on every model rank), and for one that they split, the gradient of its
    own part; over the batch axes it gives each rank's part of the
    gradient, from its own rows, which the train step sums
    (``launch/train.py``).  So: a sum over "model" (a row-parallel linear,
    the vocabulary-split embedding) has the identity backward; a value
    entering work split over "model" (:meth:`shared`) sums its gradient
    over "model"; a gather whose result the ranks use alike (:meth:`gather`)
    hands each rank its chunk of the gradient, and one of shards each rank
    uses on its own rows (``shards``) reduce-scatters it; a quantizer
    grid's max (:meth:`max`) sums its gradient over the ranks it spans and
    splits it among the elements that hold the max, on any rank."""

    def __init__(self, rules):
        self.mesh = rules.mesh
        self.layout = Layout.of(rules.mesh, rules.batch, rules.expert_fsdp)
        self.m = self.layout.m
        if rules.seq_tp and tuple(rules.seq_tp) != ("model",):
            raise ValueError(f"seq_tp {rules.seq_tp}: the residual's "
                             f"sequence splits over ('model',) only")
        if rules.seq_tp and (rules.int_bf16_reduce or rules.moe_a2a):
            raise NotImplementedError(
                f"the sequence split (seq_tp) with int_bf16_reduce or "
                f"moe_a2a does not run partitioned: {SP_BODIES}")
        # Megatron-SP: the residual's sequence over "model" (seq_split)
        self.seq = bool(rules.seq_tp) and self.m > 1
        self.j = self.layout.index(("model",))
        self.batch = tuple(a for a in self.layout.batch
                           if self.layout.size((a,)) > 1)
        self.n_dp = self.layout.size(self.batch)
        self.bi = self.layout.index(self.batch)

    def _groups(self, axes):
        return [col.group(self.mesh, a) for a in axes
                if self.layout.size((a,)) > 1]

    def max(self, xa, axis, axes):
        """The max of ``xa`` over ``axis`` (all dims when None: 0-d; else
        kept) and over the ranks of ``axes``."""
        groups = self._groups(axes)
        if not groups:
            return xa.amax() if axis is None else \
                xa.amax(dim=axis, keepdim=True)
        dims = tuple(range(xa.ndim)) if axis is None else axis
        out = _Max.apply(xa, dims, groups)
        return out.reshape(()) if axis is None else out

    def sum(self, t, axes=("model",)):
        """The sum over the ranks of ``axes`` of their parts (int32 sums
        exact; floats in f32, cast back); the backward is the identity."""
        groups = self._groups(axes)
        return _Sum.apply(t, groups) if groups else t

    def mean(self, t, axes):
        """``pmean`` over the ranks of ``axes`` (the reference's
        ``lb_loss`` of the all-to-all body); the backward gives each rank's
        value its share of the whole gradient, summed over the batch
        axes."""
        groups = self._groups(axes)
        if not groups:
            return t
        parts = self._groups(tuple(a for a in axes if a in self.batch))
        return _Mean.apply(t, groups, parts, self.layout.size(axes))

    def shared(self, t, axes=("model",)):
        """``t``, which the ranks of ``axes`` hold alike, entering work
        split over them: its backward sums the gradient over them."""
        groups = self._groups(axes)
        return col.shared(t, groups) if groups else t

    def counted(self, t):
        """``t``, which every batch rank holds alike, as a term of the
        loss that the train step sums over the batch axes: counted once."""
        return _Counted.apply(t, self.n_dp) if self.n_dp > 1 else t

    def gather(self, t, axes, dim: int = 0, *, shards: bool = False):
        """All-gather along ``dim`` over ``axes`` (major first).  The
        backward hands this rank its chunk of the gradient, or with
        ``shards`` (each rank uses the result on its own rows) the sum of
        every rank's gradient of its chunk."""
        groups = self._groups(axes)
        if not groups:
            return t
        return col.gather(t, groups, dim, shards=shards)

    def scatter(self, t, axes, dim: int = 0):
        """The reduce-scatter along ``dim`` over ``axes`` of the ranks'
        parts of one sum: this rank's chunk of the sum (int32 exact,
        floats in f32, cast back); the backward all-gathers."""
        groups = self._groups(axes)
        return _Scatter.apply(t, groups, dim) if groups else t

    def take(self, t, axes, dim: int = 0):
        """This rank's chunk along ``dim`` of ``t`` split over ``axes``,
        which every rank holds whole; the backward gathers the gradient."""
        groups = self._groups(axes)
        if not groups:
            return t
        n = t.shape[dim] // self.layout.size(axes)
        return _Take.apply(t, groups, dim, self.layout.index(axes), n)

    def batch_rows(self, t):
        """The rank's rows of a global batch tensor (dim 0)."""
        if t.shape[0] % self.n_dp:
            raise ValueError(f"batch {t.shape[0]} over {self.n_dp} batch "
                             f"ranks")
        n = t.shape[0] // self.n_dp
        return t[self.bi * n:(self.bi + 1) * n]


def active() -> Optional[Partition]:
    """The one place the model reads whether it runs partitioned: this
    rank's :class:`Partition` under ``Rules(partitioned=True)``, else
    None."""
    rules = current_rules()
    if rules is None or not getattr(rules, "partitioned", False):
        return None
    if rules.mesh is None:
        raise ValueError("partitioned rules need a mesh")
    return rules.partition


def refuse(what: str, item: str):
    """``NotImplementedError`` naming the ROADMAP item when partitioned."""
    if active() is not None:
        raise NotImplementedError(f"{what} does not run partitioned yet: "
                                  f"{item}")


def grid_max(xa, axis=None, *, model: bool = True, batch: bool = False):
    """A quantizer grid's abs-max of ``xa`` (|x|) over ``axis`` (as
    ``quant.absmax_scale`` takes it), maxed over the ranks that hold the
    rest of what the grid spans: "model" (heads, a row-parallel K,
    experts) and, for a per-tensor grid over batch rows, the batch axes.
    Differentiable (:class:`Partition`); the plain max when not
    partitioned.  A max is exact in any order."""
    part = active()
    if part is None:
        return xa.amax() if axis is None else xa.amax(dim=axis, keepdim=True)
    return part.max(xa, axis, (("model",) if model else ())
                    + (part.batch if batch else ()))


def heads_max(xa, axis=None):
    """:func:`grid_max` of a grid over heads (or a split K) of one row."""
    return grid_max(xa, axis)


def tensor_max(xa, axis=None):
    """:func:`grid_max` of a per-tensor grid over heads and batch rows."""
    return grid_max(xa, axis, batch=True)


def rows_max(xa, axis=None):
    """:func:`grid_max` of a per-tensor grid over batch rows of a tensor
    the model ranks hold alike."""
    return grid_max(xa, axis, model=False, batch=True)


def seq_split(s: int) -> bool:
    """Whether a call's residual of ``s`` positions splits its sequence
    over "model" (``Rules.seq_tp``, Megatron-SP): under partitioned rules
    with ``seq_tp``, more than one model rank and ``s`` a multiple of
    their number.  Elsewhere the residual stays whole for the call: every
    decode step (S = 1) and a prompt whose length m does not divide (the
    reference's GSPMD pads or replicates there)."""
    part = active()
    return part is not None and part.seq and s % part.m == 0


def model_input(x, split: bool, seq: bool = False):
    """``x`` entering a layer whose work ``split`` over "model" (its
    column-parallel products): its gradient sums over "model".  With
    ``seq`` (:func:`seq_split`) ``x`` holds this rank's chunk of the
    sequence (dim 1) and is all-gathered here, bf16 as bytes; the gather's
    backward reduce-scatters the gradient where the work splits, and
    hands the rank its chunk where every rank does all of it."""
    part = active()
    if part is None:
        return x
    if seq:
        return part.gather(x, ("model",), dim=1, shards=split)
    return part.shared(x) if split else x


def seq_rows(t, seq: bool):
    """This rank's chunk of the sequence (dim 1) of ``t``, which every
    model rank holds whole, where ``seq`` (:func:`seq_split`); the
    backward gathers the gradient."""
    return active().take(t, ("model",), dim=1) if seq else t


def row_parallel_linear(x, p, cfg, k_split: bool, seq: bool = False):
    """A row-parallel integer linear (wo, down) under partitioned rules.

    ``x`` (B, S, K) or (T, K) and ``p["w_q"]`` hold this rank's K slice
    when ``k_split``.  The activation is quantized on the global grid
    (per sequence for 3-D x, per tensor for 2-D, maxed over the ranks),
    the rank's exact int32 sums come from the qmatmul kernel's accumulator
    output (``dispatch.maybe_qlinear_acc``; plain: ``int_matmul_exact``),
    are all-reduced over "model" when K is split, and the epilogue
    ``f32(acc) * (w_scale * x_scale [* row_scale]) + b`` is applied once,
    rounded op by op as the kernel's.  So the result equals one rank's
    product bit for bit, split or not.

    ``seq`` (:func:`seq_split`; 3-D x, whole in S): the result is this
    rank's chunk of the sequence: the int32 sums are reduce-scattered
    along S instead (exact), and the epilogue runs on the rank's rows with
    each row's scale; an unsplit K's output is narrowed to the chunk.
    """
    from repro_torch.core import quant
    from repro_torch.core.api import as_qlinear
    from repro_torch.kernels.dispatch import maybe_qlinear_acc
    from repro_torch.kernels.ref import qmatmul_epilogue
    part = active()
    kdim = x.shape[-1]
    w_scale = p["w_scale"].to(torch.float32)
    if x.ndim == 3:
        dx = quant.absmax_scale(x, cfg.a_bits, axis=(1, 2),
                                group=heads_max if k_split else None)
        codes = quant.quantize(x, dx, cfg.a_bits)
        scale = w_scale
    else:
        xq = quant.quantize_tensor(x, cfg.a_bits,
                                   group=tensor_max if k_split else rows_max)
        codes = xq.q
        scale = (p["w_scale"] * xq.scale).to(torch.float32)
        row_scale = None
    codes = codes.reshape(-1, kdim)
    acc = maybe_qlinear_acc(codes, p["w_q"], cfg)
    if acc is None:
        acc = quant.int_matmul_exact(codes, as_qlinear(p, cfg).w_q.T)
    shape = x.shape[:-1]
    if seq and k_split:
        acc = part.scatter(acc.view(*shape, -1), ("model",), dim=1)
        shape = acc.shape[:-1]
        acc = acc.reshape(-1, acc.shape[-1])
    elif k_split:
        acc = part.sum(acc)
    if x.ndim == 3:                  # each row its sequence's scale
        row_scale = torch.repeat_interleave(
            dx.reshape(x.shape[0]).to(torch.float32), shape[1])
    b = p.get("b")
    y = qmatmul_epilogue(acc, scale, None if b is None else b, row_scale)
    y = y.reshape(*shape, -1).to(x.dtype)
    return seq_rows(y, seq and not k_split)


# ---------------------------------------------------------------------------
# The tree a rank holds
# ---------------------------------------------------------------------------

def out_features(lin) -> Optional[int]:
    """Output features of a linear as stored (int ``w_q`` (.., N, K),
    float ``w`` (.., K, N)): this rank's where they split."""
    if "w_q" in lin:
        return lin["w_q"].shape[-2]
    return lin["w"].shape[-1] if "w" in lin else None


def _blocks(params):
    """Each layer (stack) of an LM's or Whisper's tree."""
    for key, sub in params.items():
        if key == "units":
            yield from sub.values()
        elif key.startswith("rem") or key.endswith("_layers"):
            yield sub


def tree_dims(params, cfg) -> dict:
    """The dims of ``params`` that partitioning splits, as stored: vocab
    rows, the query and KV projections' output columns, feed-forward
    width, the RG-LRU's d_rnn, experts; and the SSD mixer's ``in_proj``
    width, which stays whole."""
    out = {}
    emb = params.get("embed", {})
    if emb:
        out["vocab"] = (emb.get("emb_q", emb.get("emb"))).shape[0]
    if "lm_head" in params:
        out["lm_head"] = out_features(params["lm_head"])
    for blk in _blocks(params):
        attn = next((blk[k] for k in ATTN_KEYS if k in blk), None)
        if attn is not None and "q_cols" not in out:
            out["q_cols"] = out_features(attn["wq"])
            out["kv_cols"] = out_features(attn["wk"])
        if "rglru" in blk and "d_rnn" not in out:
            out["d_rnn"] = out_features(blk["rglru"]["w_in"])
        if "ssd" in blk and "ssd" not in out:
            out["ssd"] = out_features(blk["ssd"]["in_proj"])
        ffn = blk.get("ffn", blk.get("mlp", {}))
        dense_ff = ffn.get("shared", ffn) if "up" in ffn.get(
            "shared", ffn) else None
        if dense_ff is not None and "ffn" not in out:
            out["ffn"] = out_features(dense_ff["up"])
        if "experts_up" in ffn and "experts" not in out:
            w = ffn["experts_up"]
            w = w.get("w_q", w.get("w"))
            out["experts"], out["expert_dout"] = w.shape[-3], w.shape[-1]
    return out


def expected_dims(cfg, m: int, n_fsdp: int = 1) -> dict:
    """:func:`tree_dims` of the tree a rank holds on ``m`` model ranks,
    the experts' dout split over ``n_fsdp`` data ranks."""
    plan = split_plan(cfg, m)

    def d(n, key):
        return n // m if plan[key] else n
    out = {"vocab": d(cfg.vocab, "vocab"), "lm_head": d(cfg.vocab, "vocab"),
           "q_cols": d(cfg.n_heads * cfg.hd, "heads"),
           "kv_cols": d(_kv_heads(cfg) * cfg.hd, "heads"),
           "ffn": d(cfg.d_ff, "ffn")}
    if is_encdec(cfg):
        return out
    if "rglru" in cfg.block_pattern:
        out["d_rnn"] = d(d_rnn(cfg), "rglru")
    if cfg.ssd is not None:
        from repro_torch.layers.ssd import in_proj_width
        out["ssd"] = in_proj_width(cfg.d_model, cfg.ssd)
    if cfg.moe is not None:
        out["experts"] = d(cfg.moe.n_experts, "experts")
        out["expert_dout"] = cfg.d_ff // n_fsdp
    return out


def check_tree(params, cfg):
    """Raise ``ValueError`` unless ``params`` is the tree this rank must
    hold: the local one under partitioned rules, the global one without."""
    part = active()
    want = expected_dims(cfg, 1) if part is None else expected_dims(
        cfg, part.m, part.layout.size(("data",)) if part.layout.fsdp else 1)
    got = tree_dims(params, cfg)
    bad = {k: (n, want[k]) for k, n in got.items() if n != want[k]}
    if bad:
        what = "this rank's shard" if part is not None else "a global tree"
        raise ValueError(f"the parameter tree is not {what} "
                         f"({'partitioned' if part else 'unpartitioned'} "
                         f"rules): (held, expected) {bad}")


def global_shapes(params, cfg, layout: Layout):
    """Meta tensors of the global tree that ``params`` (this rank's shard
    on ``layout``) is part of: its shapes and dtypes, nothing allocated."""
    def one(t, spec):
        shape = list(t.shape)
        for dim, entry in enumerate(spec):
            shape[dim] *= layout.size(_names(entry))
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return _map2(one, params, _plan_specs(params, cfg, layout))


def _stack_into(dst: dict, key: str, i: int, n: int, layer):
    """Copy ``layer`` into slot ``i`` of ``dst[key]``, the stack of ``n``
    such layers (allocated at the first)."""
    if key not in dst:
        dst[key] = tree_lib.tree_map(
            lambda t: t.new_empty((n, *t.shape)), layer)
    _map2(lambda a, b: a[i].copy_(b), dst[key], layer)


def build_params(cfg, *, seed: int = 0, layout: Optional[Layout] = None,
                 device="cuda"):
    """The tree of ``cfg`` (an LM's or Whisper's) sliced for ``layout``,
    built one layer at a time, so no device holds the global tree: each
    layer's global float weights are drawn on ``device`` from a generator
    seeded by (``seed``, layer), integerized whole where ``cfg.quant`` is
    int mode (a weight's per-column scales span its K; kept float in modes
    "float" and "fake", to train), and only the rank's slice is kept.
    With ``layout`` None (or one rank) it is the unpartitioned tree of the
    same values.  The embedding and lm_head draw from their own
    generators; the layout is the reference's (``units``, ``enc_layers``
    and ``dec_layers`` stacked).  On ``device="meta"`` nothing is drawn:
    the rank's tree as shapes and dtypes only (``launch/dryrun.py``)."""
    from repro_torch.core.api import integerize_params
    from repro_torch.layers.embed import init_embed
    from repro_torch.layers.norms import init_norm
    from repro_torch.models import encdec, lm
    layout = layout or Layout.make({})
    d, dt = cfg.d_model, cfg.tdtype

    def gen(i):
        if torch.device(device).type == "meta":
            return None               # a meta device has no generator
        return torch.Generator(device=device).manual_seed(
            seed * 100_003 + i)

    def own(tree):
        if cfg.quant is not None and cfg.quant.mode == "int":
            tree = integerize_params(tree, cfg.quant)
        return partition_params(tree, cfg, layout)

    def layer(i, init):
        # one layer under a key no spec reads as stacked
        return own({"layer": init(gen(i))})["layer"]

    params = own({"embed": init_embed(gen(0), cfg.vocab, d, dt,
                                      device=device),
                  "lm_head": lm._lin(gen(1), (), d, cfg.vocab, dt, device)})
    if is_encdec(cfg):
        params["enc_ln"] = init_norm(d, "layernorm", device=device)
        params["dec_ln"] = init_norm(d, "layernorm", device=device)
        n_enc, n_dec = cfg.n_enc_layers, cfg.n_dec_layers
        for i in range(n_enc + n_dec):
            kind, n, j = ("enc", n_enc, i) if i < n_enc else \
                ("dec", n_dec, i - n_enc)
            _stack_into(params, f"{kind}_layers", j, n, layer(
                2 + i, lambda g: encdec.init_layer(g, cfg, kind,
                                                   device=device)))
        return params
    params["final_norm"] = init_norm(d, cfg.norm, device=device)
    unit, n_units, rem = lm.unit_structure(cfg)
    if n_units:
        params["units"] = {}
    for u in range(n_units):
        for j, kind in enumerate(unit):
            _stack_into(params["units"], f"b{j}", u, n_units, layer(
                2 + u * len(unit) + j,
                lambda g: lm._init_block(g, cfg, kind, (), device)))
    for i, kind in enumerate(rem):
        params[f"rem{i}"] = layer(
            2 + n_units * len(unit) + i,
            lambda g: lm._init_block(g, cfg, kind, (), device))
    return params


# ---------------------------------------------------------------------------
# Training on the rank's tree: gradients and ZeRO-1 optimizer moments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafShard:
    """How this rank holds one leaf of the tree and its optimizer moments
    under partitioned rules."""
    axes: tuple                   # mesh axes the leaf is split over
    dim: Optional[int] = None     # the moments' dim split over "data"
    n: int = 1                    # ranks of "data" (ZeRO-1)
    i: int = 0                    # this rank's index on "data"

    def part(self, t):
        """The rank's ZeRO-1 slice of a local leaf (its moments' block)."""
        if self.dim is None:
            return t
        size = t.shape[self.dim] // self.n
        return t.narrow(self.dim, self.i * size, size)

    @property
    def norm_axes(self) -> tuple:
        """The axes whose ranks hold the rest of what :meth:`part` is a
        block of: a sum over the leaf sums over them."""
        return self.axes + (("data",) if self.dim is not None else ())


def opt_shards(params, cfg):
    """Each leaf's :class:`LeafShard` (sorted key order) of the rank's tree
    ``params`` under the active partitioned rules; None without them.  The
    moments are split as the reference's train cell splits them
    (``launch/dryrun.py``): ``zero1_specs`` over "data" on
    ``param_specs(expert_fsdp=...)`` of the global shapes, on the mesh's
    axes where they divide, with the groups :func:`split_plan` keeps whole
    left whole."""
    part = active()
    if part is None:
        return None
    layout = part.layout
    glob = global_shapes(params, cfg, layout)
    n = layout.size(("data",))
    zspecs = _whole_groups(enforce_divisible(filter_mesh_axes(zero1_specs(
        glob, param_specs(glob, expert_fsdp=layout.fsdp), data_size=n),
        layout), glob, layout), cfg, layout)
    out = []
    for (keys, pspec), zspec in zip(
            tree_lib.leaves_with_keys(_plan_specs(params, cfg, layout)),
            tree_lib.leaves(zspecs)):
        axes = tuple(a for e in pspec for a in _names(e))
        z, q = ([set(_names(e)) for e in sp] for sp in (zspec, pspec))
        extra = [d for d in range(len(z)) if z[d] - q[d]]
        if any(not q[d] <= z[d] or z[d] - q[d] - {"data"}
               for d in range(len(z))) or len(extra) > 1:
            raise ValueError(f"{'/'.join(keys)}: moments {zspec} are not "
                             f"the leaf's {pspec} split over data")
        dim = extra[0] if extra and n > 1 else None
        out.append(LeafShard(axes, dim, n if dim is not None else 1,
                             layout.index(("data",)) if dim is not None
                             else 0))
    return out


def reduce_grads(grads, shards):
    """Each rank's part of each gradient (``lm.lm_loss``) summed over the
    batch axes it is not split over: the gradient of the leaf's block,
    the same on every batch rank (f32 sums, cast back)."""
    part = active()
    out = []
    for g, sh in zip(tree_lib.leaves(grads), shards):
        groups = part._groups(tuple(a for a in part.batch
                                    if a not in sh.axes))
        out.append(col.reduce_sum(g, groups) if groups else g)
    return tree_lib.unflatten(grads, out)


def leaf_sums(sums, shards):
    """Per leaf, f32 sums over what the rank holds of it (``sums[i]``,
    any shape) summed over the ranks that hold the rest of the leaf
    (:attr:`LeafShard.norm_axes`): one all-reduce for each set of axes."""
    part = active()
    out, by = list(sums), {}
    for i, sh in enumerate(shards):
        axes = tuple(a for a in sh.norm_axes if part.layout.size((a,)) > 1)
        if axes:
            by.setdefault(axes, []).append(i)
    for axes, idx in by.items():
        total = col.reduce_sum(torch.stack([sums[i] for i in idx]),
                               part._groups(axes))
        for j, i in enumerate(idx):
            out[i] = total[j]
    return out


def gather_slice(t, sh: LeafShard):
    """The leaf from every data rank's :meth:`LeafShard.part` (exact)."""
    if sh.dim is None:
        return t
    return col.gather_dim(t, active()._groups(("data",)), sh.dim)
