"""The exchanges of the explicit shard bodies, on ``torch.distributed``.

The reference writes its shard bodies with ``shard_map`` and JAX's named
collectives (``all_gather(..., tiled=True)``, ``all_to_all``,
``psum_scatter``, ``pmean``).  Here each rank of a ``DeviceMesh`` runs the
body on its slice of global tensors, and these helpers are its
collectives over one mesh axis (the axis's process group).  A group's
backend is "nccl" for CUDA tensors or "gloo" for CPU ones; a group handed
a tensor its backend would move through the host raises instead.  The
third backend is torch's "fake" (``torch.testing._internal.distributed.
fake_pg``), which carries a tensor of any device, meta included, and
moves nothing: the dry run (``launch/dryrun.py``) sizes one rank of a
production mesh under it, and every count below is made alike.

Gradients follow the global view of the model code, where every rank
holds the same global tensors and, after a backward pass, the same full
gradients (what ``shard_map``'s transpose gives the reference): a global
tensor enters a shard body through :func:`shared_input`, whose backward
sums the ranks' partial gradients; a gather whose result every rank uses
alike hands each rank its own chunk of the (full) output gradient, and a
gather of shards that each rank uses on its own data reduce-scatters it;
an all-to-all's backward is the reverse exchange, and a mean over ranks
scales by 1/n.

Every exchange adds the bytes this rank sends in it to :data:`WIRE`, by
kind, as the bandwidth-optimal algorithms on n ranks send them: an
all-reduce of B bytes 2 (n - 1) / n B, a reduce-scatter of B bytes
(n - 1) / n B, an all-gather of a B-byte chunk (n - 1) B, an all-to-all
of B bytes (n - 1) / n B (``reset_wire`` zeroes the counts).  Beside
it, :data:`RESULT` adds the bytes of each exchange's result, by the
reference's hyphenated kinds, as ``repro/launch/hlo_analysis.py``'s
``collective_bytes`` sums the result shapes of the compiled program's
collectives (an all-reduce's result is its operand, an all-gather's the
gathered tensor, a reduce-scatter's the rank's chunk).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# torch 2.13 renamed the tensor forms of all-gather / reduce-scatter
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


WIRE = {"all_reduce": 0.0, "reduce_scatter": 0.0, "all_gather": 0.0,
        "all_to_all": 0.0}
RESULT = {"all-reduce": 0, "reduce-scatter": 0, "all-gather": 0,
          "all-to-all": 0}
_SHARE = {"all_reduce": lambda n: 2 * (n - 1) / n,
          "reduce_scatter": lambda n: (n - 1) / n,
          "all_gather": lambda n: n - 1, "all_to_all": lambda n: (n - 1) / n}


def reset_wire():
    for k in WIRE:
        WIRE[k] = 0.0
    for k in RESULT:
        RESULT[k] = 0


def _sent(kind: str, t: torch.Tensor, grp, out: torch.Tensor):
    WIRE[kind] += _SHARE[kind](dist.get_world_size(grp)) * \
        t.numel() * t.element_size()
    RESULT[kind.replace("_", "-")] += out.numel() * out.element_size()


def group(mesh, axis: str):
    return mesh.get_group(axis)


def axes_index(mesh, axes) -> int:
    """This rank's linear index over ``axes`` (major first)."""
    i = 0
    for a in axes:
        i = i * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return i


def axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def check_device(t: torch.Tensor, grp):
    """A collective's tensor must be one its backend carries in place:
    NCCL for CUDA tensors, gloo for CPU ones (gloo would copy a CUDA
    tensor through the host); the fake backend takes any."""
    backend = str(dist.get_backend(grp))
    if backend == "fake":
        return
    if ("nccl" if t.is_cuda else "gloo") not in backend:
        raise ValueError(f"a {backend} group cannot carry a {t.device} "
                         f"tensor without a copy through the host; build "
                         f"the mesh on the tensors' device type")


def _gather0(t, grp):
    check_device(t, grp)
    t = t.contiguous()
    out = torch.empty((dist.get_world_size(grp) * t.shape[0], *t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _sent("all_gather", t, grp, out)
    _all_gather(out, t, group=grp)
    return out


def group_index(groups) -> int:
    """This rank's linear index over ``groups`` (major first)."""
    i = 0
    for grp in groups:
        i = i * dist.get_world_size(grp) + dist.get_rank(grp)
    return i


def reduce_sum(t: torch.Tensor, groups) -> torch.Tensor:
    """The sum of ``t`` over ``groups``: int32 in place, floats in f32
    (an exact widening of bf16) and cast back."""
    if t.dtype == torch.int32:
        out = t.contiguous()                         # in place
    else:
        out = t.to(torch.float32).contiguous().clone()
    for grp in groups:
        all_reduce(out, grp)
    return out.to(t.dtype)


def gather_dim(t: torch.Tensor, groups, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim`` over ``groups`` (major first: the
    innermost group gathers first), contiguous; bf16 moves as byte pairs,
    which NCCL and gloo both carry."""
    bf16 = t.dtype == torch.bfloat16
    out = t.contiguous().view(torch.uint8) if bf16 else t
    out = out.movedim(dim, 0)
    for grp in reversed(tuple(groups)):
        out = _gather0(out, grp)
    out = out.movedim(0, dim).contiguous()
    if not bf16:
        return out
    # a contiguous tensor's size-1 dims may keep any stride (one row of
    # logits gathered along the vocabulary), which a view as bf16 refuses:
    # view it flat
    return out.reshape(-1).view(torch.bfloat16).view(*out.shape[:-1],
                                                     out.shape[-1] // 2)


def reduce_scatter_dim(g: torch.Tensor, groups, dim: int = 0) -> torch.Tensor:
    """The reverse of :func:`gather_dim` for shards each rank uses on its
    own data: the sum over ``groups`` of each rank's chunk along ``dim``;
    int32 as it is (exact: an f32 sum would round sums past 2^24), floats
    in f32 (an exact widening of bf16), cast back."""
    out = (g if g.dtype == torch.int32 else g.to(torch.float32)).movedim(
        dim, 0)
    for grp in groups:                               # major first
        n = dist.get_world_size(grp)
        out = reduce_scatter0(
            out.reshape(n, out.shape[0] // n, *out.shape[1:]).contiguous(),
            grp)
    return out.movedim(0, dim).to(g.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, dim, shards):
        ctx.groups, ctx.dim, ctx.shards = groups, dim, shards
        ctx.n = t.shape[dim]
        return gather_dim(t, groups, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.shards:
            g = reduce_scatter_dim(g, ctx.groups, ctx.dim)
        else:
            g = g.narrow(ctx.dim, group_index(ctx.groups) * ctx.n, ctx.n)
        return g, None, None, None


class _SharedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.groups), None


def _a2a0(t, grp):
    check_device(t, grp)
    t = t.contiguous()
    out = torch.empty_like(t)
    _sent("all_to_all", t, grp, out)
    dist.all_to_all_single(out, t, group=grp)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        return _a2a0(t, grp)

    @staticmethod
    def backward(ctx, g):
        return _a2a0(g, ctx.grp), None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp):
        check_device(t, grp)
        ctx.n = dist.get_world_size(grp)
        return all_reduce(t.clone(), grp) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def gather(t: torch.Tensor, groups, dim: int = 0, *,
           shards: bool = False) -> torch.Tensor:
    """All-gather along ``dim`` over ``groups``, major first (JAX's
    ``all_gather(tiled=True)``): the ranks' chunks in rank order.
    ``shards``: the result is used by each rank on its own data (FSDP
    weights), so the backward sums the ranks' gradients of each chunk
    (in f32); else every rank uses it alike and takes its chunk of the
    gradient."""
    return _Gather.apply(t, tuple(groups), dim, shards)


def gather0(t: torch.Tensor, grp, *, shards: bool = False) -> torch.Tensor:
    """:func:`gather` along dim 0 over one group."""
    return gather(t, (grp,), shards=shards)


def shared(t: torch.Tensor, groups) -> torch.Tensor:
    """A tensor the ranks of ``groups`` hold alike entering work they
    split: the identity, whose backward sums the ranks' gradients (in
    f32)."""
    return _SharedInput.apply(t, tuple(groups))


def shared_input(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """:func:`shared` over the groups of mesh ``axes``."""
    return shared(t, [group(mesh, a) for a in axes])


def gather_axes(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """:func:`gather` along dim 0 over several mesh axes, major first."""
    return gather(t, [group(mesh, a) for a in axes])


def all_to_all0(t: torch.Tensor, grp) -> torch.Tensor:
    """Chunk r of dim 0 goes to rank r; the result holds, in dim 0, the
    chunks received, in source-rank order."""
    return _AllToAll.apply(t, grp)


def mean(t: torch.Tensor, grp) -> torch.Tensor:
    """``pmean`` of a value over one mesh axis."""
    return _Mean.apply(t, grp)


def reduce_scatter0(t: torch.Tensor, grp) -> torch.Tensor:
    """Sum over the ranks of ``t`` (m, ...); rank r keeps chunk r, (...)."""
    check_device(t, grp)
    out = torch.empty(t.shape[1:], dtype=t.dtype, device=t.device)
    _sent("reduce_scatter", t, grp, out)
    _reduce_scatter(out, t.reshape(-1, *t.shape[2:]), group=grp)
    return out


def all_reduce(t: torch.Tensor, grp, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over one group."""
    check_device(t, grp)
    _sent("all_reduce", t, grp, t)
    dist.all_reduce(t, op=op, group=grp)
    return t
