"""Partitioned execution of the decoder LMs' ring serving steps: each rank
holds only its shard of the weights and of the caches.

The port's counterpart of the reference's ``jax.jit(prefill / decode_step,
in_shardings=...)`` (``repro/launch/dryrun.py``), where GSPMD partitions
the program from its shardings.  Here every rank runs the model code on
its local tensors, and the few steps that cross ranks are written out.

**The switch.**  ``Rules(partitioned=True, mesh=...)`` under
``sharding.use_rules``; the model reads it only through :func:`active`,
which returns this rank's :class:`Partition` (None when off).  Under it
``models/lm.py``'s :func:`~repro_torch.models.lm.prefill` and
:func:`~repro_torch.models.lm.decode_step` take the same global tokens as
on one card, run on the rank's batch rows, and return the same global
logits on every rank; only the parameters (:func:`partition_params` or
:func:`build_params`) and the ring cache are rank-local.
:func:`check_tree` refuses a global tree under partitioned rules and a
partitioned tree without them (``ValueError``).  Partitioned rules do not
combine with ``int_bf16_reduce`` or ``moe_a2a`` (the shard bodies on
global tensors, ``core/api.py::_int_row_parallel`` and
``layers/moe.py::moe_ffn_a2a``), and the recurrent blocks, Whisper, the
paged engine and training raise ``NotImplementedError`` under them; each
message names :data:`ROADMAP_ITEM`.  Only ``mode="int"`` serves
partitioned.

**Layout.**  Each leaf splits as ``sharding.param_specs`` says, after
``filter_mesh_axes`` and ``enforce_divisible``: column-parallel weights
(wq, wk, wv, gate, up, lm_head) by output rows, row-parallel ones (wo,
down) by K as stored (nibble bytes kept whole, so K/m is even), experts by
E, the embedding by vocabulary rows; norms, the router and row-parallel
biases stay whole.  Local shapes equal the reference's shard shapes, with
one departure: attention splits by whole KV groups.  The port's GQA layout
(``q.reshape(b, hkv, g, ...)``) maps a contiguous range of query heads
onto a contiguous range of KV heads, so where ``kv_heads % m != 0`` a
layer's wq, wk, wv and wo stay whole on every rank (``enforce_divisible``
alone would cut inside a head: ChatGLM3's wk has 256 columns).  The other
groups (a feed-forward's up, gate and down; the experts; the embedding and
lm_head) likewise split only as a whole (:func:`split_plan`).  The batch
splits over ``Rules.batch``.  The ring caches split by KV head over
"model" and by row over the batch axes (:func:`local_cache_specs`); the
reference's ``cache_specs`` (kept as it is in ``sharding.py``) splits the
ring's sequence instead, which would need a cross-rank merge of the
softmax's f32 sum, not an exact step.

**Exactness.**  A partitioned run on any mesh is bitwise equal to one
rank's run of the same tree, since every cross-rank step is exact:

- a quantizer grid that spans a split dimension takes its max over the
  mesh (:func:`group_max`): over "model" where it spans heads or a
  row-parallel K, and also over the batch axes where it is per tensor;
- a row-parallel linear (:func:`row_parallel_linear`) all-reduces its
  int32 sums over "model" (the qmatmul kernel's accumulator output) and
  applies the f32 epilogue once, to the full sum;
- the vocabulary-split embedding sums one non-zero term per element; the
  logits (along the vocabulary), the expert outputs (along E) and the
  batch rows are gathered.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed.sharding import (P, _names, current_rules,
                                              enforce_divisible,
                                              filter_mesh_axes, param_specs)

ROADMAP_ITEM = "ROADMAP.md queue 1, item 6c (partitioned execution)"


@dataclasses.dataclass(frozen=True)
class Layout:
    """A mesh's axis sizes and one rank's coordinates on it, in mesh order,
    and the batch axes it has.  Stands in for a ``DeviceMesh`` in
    ``sharding``'s functions (``mesh_dim_names``, ``shape``), so a tree can
    be sliced for any rank without a process group."""
    sizes: tuple                  # ((axis, size), ...)
    coords: tuple                 # ((axis, index), ...)
    batch: tuple = ()             # the batch axes present, major first

    @classmethod
    def make(cls, sizes: dict, coords: Optional[dict] = None,
             batch=("pod", "data")) -> "Layout":
        coords = coords or {}
        return cls(tuple(sizes.items()),
                   tuple((a, coords.get(a, 0)) for a in sizes),
                   tuple(a for a in batch if a in sizes))

    @classmethod
    def of(cls, mesh, batch=("pod", "data")) -> "Layout":
        """This rank's layout on a ``DeviceMesh``."""
        names = tuple(mesh.mesh_dim_names)
        return cls.make(dict(zip(names, tuple(mesh.shape))),
                        {a: mesh.get_local_rank(a) for a in names}, batch)

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


def split_plan(cfg, m: int) -> dict:
    """Which groups of the tree split over ``m`` model ranks: attention by
    whole KV groups ("heads"), a feed-forward ("ffn", the shared expert's
    too), the experts, the vocabulary.  A row-parallel K stored as nibbles
    must split into whole bytes."""
    def ok(n, stored=None):
        return m > 1 and n % m == 0 and \
            (not _packed(cfg) or stored is None or stored % m == 0)
    return {"heads": ok(cfg.kv_heads, cfg.n_heads * cfg.hd // 2),
            "ffn": cfg.d_ff > 0 and ok(cfg.d_ff, cfg.d_ff // 2),
            "experts": cfg.moe is not None and ok(cfg.moe.n_experts),
            "vocab": ok(cfg.vocab)}


def _group(keys) -> Optional[str]:
    if "embed" in keys or "lm_head" in keys:
        return "vocab"
    if "attn" in keys:
        return "heads"
    if len(keys) > 1 and keys[-2].startswith("experts_"):
        return "experts"
    if "ffn" in keys and len(keys) > 1 and keys[-2] in ("up", "gate",
                                                          "down"):
        return "ffn"
    return None


def _plan_specs(params, cfg, layout):
    """``param_specs`` on ``layout``'s axes, each group whole unless
    :func:`split_plan` splits it.  Depends on the tree's keys and leaf
    ranks only, so a local tree gives its global tree's specs."""
    plan = split_plan(cfg, layout.m)
    specs = filter_mesh_axes(param_specs(params), layout)

    def fix(keys, spec):
        g = _group(keys)
        if g is None or plan[g]:
            return spec
        return P(*(None if "model" in _names(e) else e for e in spec))

    flat = tree_lib.leaves_with_keys(specs)
    return tree_lib.unflatten(specs, [fix(list(k), s) for k, s in flat])


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


def local_cache_specs(cache, cfg, layout: Layout):
    """Specs of a ring cache: codes ``(B, Hkv, span, hd[/2])`` by row over
    the batch axes and by KV head over "model" where attention splits;
    scales and ``pos`` whole."""
    heads = split_plan(cfg, layout.m)["heads"]
    b = layout.batch if len(layout.batch) != 1 else layout.batch[0]
    b = b or None

    def one(keys, leaf):
        nd = leaf.ndim
        pad = (None,) * (1 if "units" in keys else 0)
        if keys[-1] in ("k", "v") and nd - len(pad) == 4:
            return P(*pad, b, "model" if heads else None, None, None)
        return P(*((None,) * nd))
    return tree_lib.unflatten(cache, [one(list(k), v) for k, v in
                                      tree_lib.leaves_with_keys(cache)])


def partition_cache(cache, cfg, layout: Layout):
    """The rank's shard of a global ring cache (the inverse of
    :func:`gather_cache`)."""
    specs = local_cache_specs(cache, cfg, layout)
    return _map2(lambda t, s: _slice(t, s, layout), cache, specs)


def gather_cache(parts, cfg):
    """The global ring cache from every rank's ``(layout, local cache)``."""
    return _assemble(parts, local_cache_specs(parts[0][1], cfg,
                                              parts[0][0]))


def local_kv_heads(cfg, m: int) -> int:
    return cfg.kv_heads // m if split_plan(cfg, m)["heads"] else cfg.kv_heads


def init_cache(cfg, batch: int, max_len: int, layout: Layout, *,
               device="cuda"):
    """The rank's ring cache for a global ``batch``: its rows over the
    batch axes, its KV heads."""
    from repro_torch.models import lm
    n_dp = layout.size(layout.batch)
    if batch % n_dp:
        raise ValueError(f"batch {batch} over {n_dp} batch ranks")
    return lm.init_cache(cfg.replace(kv_heads=local_kv_heads(cfg, layout.m)),
                         batch // n_dp, max_len, device=device)


# ---------------------------------------------------------------------------
# The rank's state under partitioned rules
# ---------------------------------------------------------------------------

class Partition:
    """This rank on the mesh of partitioned rules: its layout and the
    exchanges of the partitioned program (NCCL for CUDA tensors, gloo for
    CPU ones; bf16 travels as its bytes where it is moved, and is
    widened, exactly, where it is reduced)."""

    def __init__(self, rules):
        self.mesh = rules.mesh
        self.layout = Layout.of(rules.mesh, rules.batch)
        self.m = self.layout.m
        self.j = self.layout.index(("model",))
        self.batch = tuple(a for a in self.layout.batch
                           if self.layout.size((a,)) > 1)
        self.n_dp = self.layout.size(self.batch)
        self.bi = self.layout.index(self.batch)

    def _groups(self, axes):
        from repro_torch.distributed import collectives as col
        return [col.group(self.mesh, a) for a in axes
                if self.layout.size((a,)) > 1]

    def max(self, t, axes):
        groups = self._groups(axes)
        if not groups:
            return t
        from repro_torch.distributed import collectives as col
        out = t.to(torch.float32).clone()      # exact for bf16 and f32
        for grp in groups:
            col.all_reduce(out, grp, op=torch.distributed.ReduceOp.MAX)
        return out.to(t.dtype)

    def sum_model(self, t):
        """Sum over "model": int32 sums in place; a float tensor (one
        non-zero term per element) summed in f32 and cast back."""
        groups = self._groups(("model",))
        if not groups:
            return t
        from repro_torch.distributed import collectives as col
        if t.dtype == torch.int32:
            return col.all_reduce(t.contiguous(), groups[0])
        out = t.to(torch.float32).clone()
        return col.all_reduce(out, groups[0]).to(t.dtype)

    def gather(self, t, axes, dim: int = 0):
        """All-gather along ``dim`` over ``axes`` (major first); bf16 moves
        as byte pairs, which NCCL and gloo both carry."""
        from repro_torch.distributed import collectives as col
        bf16 = t.dtype == torch.bfloat16
        out = t.contiguous().view(torch.uint8) if bf16 else t
        out = out.movedim(dim, 0)
        for grp in reversed(self._groups(axes)):
            out = col.gather0(out, grp)
        out = out.movedim(0, dim)
        return out.contiguous().view(torch.bfloat16) if bf16 else out

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
    if rules.int_bf16_reduce or rules.moe_a2a:
        raise ValueError("partitioned trees do not combine with "
                         "int_bf16_reduce or moe_a2a (their shard bodies "
                         f"take global tensors): {ROADMAP_ITEM}")
    return rules.partition


def refuse(what: str):
    """``NotImplementedError`` naming the ROADMAP item when partitioned."""
    if active() is not None:
        raise NotImplementedError(f"{what} does not run partitioned yet: "
                                  f"{ROADMAP_ITEM}")


def group_max(amax, *, model: bool = True, batch: bool = False):
    """The max of a quantizer grid's local abs-max over the ranks that
    hold the rest of what it spans: over "model" (heads, a row-parallel K,
    experts) and, for a per-tensor grid, the batch axes.  The identity
    when not partitioned.  A max is exact in any order."""
    part = active()
    if part is None:
        return amax
    return part.max(amax, (("model",) if model else ())
                    + (part.batch if batch else ()))


def heads_max(amax):
    """:func:`group_max` of a grid over heads (or a split K) of one row."""
    return group_max(amax)


def tensor_max(amax):
    """:func:`group_max` of a per-tensor grid."""
    return group_max(amax, batch=True)


def row_parallel_linear(x, p, cfg, k_split: bool):
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
        row_scale = torch.repeat_interleave(
            dx.reshape(x.shape[0]).to(torch.float32), x.shape[1])
    else:
        xq = quant.quantize_tensor(
            x, cfg.a_bits,
            group=tensor_max if k_split else
            lambda a: group_max(a, model=False, batch=True))
        codes = xq.q
        scale = (p["w_scale"] * xq.scale).to(torch.float32)
        row_scale = None
    codes = codes.reshape(-1, kdim)
    acc = maybe_qlinear_acc(codes, p["w_q"], cfg)
    if acc is None:
        acc = quant.int_matmul_exact(codes, as_qlinear(p, cfg).w_q.T)
    if k_split:
        acc = part.sum_model(acc)
    b = p.get("b")
    y = qmatmul_epilogue(acc, scale, None if b is None else b, row_scale)
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


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
    for key, sub in params.items():
        if key == "units":
            yield from sub.values()
        elif key.startswith("rem"):
            yield sub


def tree_dims(params, cfg) -> dict:
    """The dims of ``params`` that partitioning splits, as stored: vocab
    rows, query and KV heads, feed-forward width, experts."""
    out = {}
    emb = params.get("embed", {})
    if emb:
        out["vocab"] = (emb.get("emb_q", emb.get("emb"))).shape[0]
    if "lm_head" in params:
        out["lm_head"] = out_features(params["lm_head"])
    for blk in _blocks(params):
        if "attn" in blk and "heads" not in out:
            out["heads"] = out_features(blk["attn"]["wq"]) // cfg.hd
            out["kv_heads"] = out_features(blk["attn"]["wk"]) // cfg.hd
        ffn = blk.get("ffn", {})
        dense_ff = ffn.get("shared", ffn) if "up" in ffn.get(
            "shared", ffn) else None
        if dense_ff is not None and "ffn" not in out:
            out["ffn"] = out_features(dense_ff["up"])
        if "experts_up" in ffn and "experts" not in out:
            w = ffn["experts_up"]
            out["experts"] = w.get("w_q", w.get("w")).shape[-3]
    return out


def expected_dims(cfg, m: int) -> dict:
    plan = split_plan(cfg, m)

    def d(n, key):
        return n // m if plan[key] else n
    out = {"vocab": d(cfg.vocab, "vocab"), "lm_head": d(cfg.vocab, "vocab"),
           "heads": d(cfg.n_heads, "heads"),
           "kv_heads": d(cfg.kv_heads, "heads"), "ffn": d(cfg.d_ff, "ffn")}
    if cfg.moe is not None:
        out["experts"] = d(cfg.moe.n_experts, "experts")
    return out


def check_tree(params, cfg):
    """Raise ``ValueError`` unless ``params`` is the tree this rank must
    hold: the local one under partitioned rules, the global one without."""
    part = active()
    want = expected_dims(cfg, part.m if part is not None else 1)
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


def build_params(cfg, *, seed: int = 0, layout: Optional[Layout] = None,
                 device="cuda"):
    """The integerized tree of ``cfg`` (``cfg.quant``) sliced for
    ``layout``, built one layer at a time, so no device holds the global
    tree: each layer's global float weights are drawn on ``device`` from a
    generator seeded by (``seed``, layer), integerized whole (a weight's
    per-column scales span its K), and only the rank's slice is kept.
    With ``layout`` None (or one model rank) it is the unpartitioned tree of
    the same values.  The embedding and lm_head draw from their own
    generators; the layout is the reference's (``units`` stacked)."""
    from repro_torch.core.api import integerize_params
    from repro_torch.layers.embed import init_embed
    from repro_torch.layers.norms import init_norm
    from repro_torch.models import lm
    layout = layout or Layout.make({})
    d, dt = cfg.d_model, cfg.tdtype

    def gen(i):
        return torch.Generator(device=device).manual_seed(
            seed * 100_003 + i)

    def own(tree):
        return partition_params(integerize_params(tree, cfg.quant), cfg,
                                layout)

    params = own({"embed": init_embed(gen(0), cfg.vocab, d, dt,
                                      device=device),
                  "lm_head": lm._lin(gen(1), (), d, cfg.vocab, dt, device)})
    params["final_norm"] = init_norm(d, cfg.norm, device=device)
    unit, n_units, rem = lm.unit_structure(cfg)
    if n_units:
        params["units"] = {}
    for u in range(n_units):
        for j, kind in enumerate(unit):
            blk = own({"rem0": lm._init_block(gen(2 + u * len(unit) + j),
                                              cfg, kind, (), device)})
            if u == 0:
                params["units"][f"b{j}"] = tree_lib.tree_map(
                    lambda t: t.new_empty((n_units, *t.shape)), blk["rem0"])
            _map2(lambda dst, src: dst[u].copy_(src),
                  params["units"][f"b{j}"], blk["rem0"])
            del blk
    for i, kind in enumerate(rem):
        layer = 2 + n_units * len(unit) + i
        params[f"rem{i}"] = own({"rem0": lm._init_block(
            gen(layer), cfg, kind, (), device)})["rem0"]
    return params
