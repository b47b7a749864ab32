"""The exchanges of the explicit shard bodies, on ``torch.distributed``.

The reference writes its shard bodies with ``shard_map`` and JAX's named
collectives (``all_gather(..., tiled=True)``, ``all_to_all``,
``psum_scatter``, ``pmean``).  Here each rank of a ``DeviceMesh`` runs the
body on its slice of global tensors, and these helpers are its
collectives over one mesh axis (the axis's process group).  NCCL carries
CUDA tensors, gloo CPU tensors; a group handed a tensor its backend would
move through the host raises instead.

Gradients follow the global view of the model code, where every rank
holds the same global tensors and, after a backward pass, the same full
gradients (what ``shard_map``'s transpose gives the reference): a global
tensor enters a shard body through :func:`shared_input`, whose backward
sums the ranks' partial gradients; a gather whose result every rank uses
alike hands each rank its own chunk of the (full) output gradient, and a
gather of shards that each rank uses on its own data reduce-scatters it;
an all-to-all's backward is the reverse exchange, and a mean over ranks
scales by 1/n.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# torch 2.13 renamed the tensor forms of all-gather / reduce-scatter
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


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
    tensor through the host)."""
    backend = str(dist.get_backend(grp))
    if ("nccl" if t.is_cuda else "gloo") not in backend:
        raise ValueError(f"a {backend} group cannot carry a {t.device} "
                         f"tensor without a copy through the host; build "
                         f"the mesh on the tensors' device type")


def _gather0(t, grp):
    check_device(t, grp)
    t = t.contiguous()
    out = torch.empty((dist.get_world_size(grp) * t.shape[0], *t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _all_gather(out, t, group=grp)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, grp, shards):
        ctx.grp, ctx.n, ctx.shards = grp, t.shape[0], shards
        return _gather0(t, grp)

    @staticmethod
    def backward(ctx, g):
        if ctx.shards:
            m = dist.get_world_size(ctx.grp)
            return reduce_scatter0(g.reshape(m, ctx.n, *g.shape[1:]),
                                   ctx.grp), None, None
        i = dist.get_rank(ctx.grp)
        return g[i * ctx.n:(i + 1) * ctx.n], None, None


class _SharedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for grp in ctx.groups:
            all_reduce(g, grp)
        return g, None


def _a2a0(t, grp):
    check_device(t, grp)
    t = t.contiguous()
    out = torch.empty_like(t)
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
        out = t.clone()
        dist.all_reduce(out, group=grp)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def gather0(t: torch.Tensor, grp, *, shards: bool = False) -> torch.Tensor:
    """All-gather along dim 0 (JAX's ``all_gather(axis=0, tiled=True)``):
    the ranks' chunks in rank order.  ``shards``: the result is used by
    each rank on its own data (FSDP weights), so the backward sums the
    ranks' gradients of each chunk; else every rank uses it alike and
    takes its chunk of the gradient."""
    return _Gather.apply(t, grp, shards)


def shared_input(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A global tensor entering a shard body whose ranks over ``axes`` use
    it on different data: the identity, whose backward sums the ranks'
    gradients over those axes."""
    return _SharedInput.apply(t, tuple(group(mesh, a) for a in axes))


def gather_axes(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """All-gather along dim 0 over several mesh axes, major first (the
    innermost axis gathers first)."""
    for a in reversed(tuple(axes)):
        t = gather0(t, group(mesh, a))
    return t


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
    _reduce_scatter(out, t.reshape(-1, *t.shape[2:]), group=grp)
    return out


def all_reduce(t: torch.Tensor, grp, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over one group."""
    check_device(t, grp)
    dist.all_reduce(t, op=op, group=grp)
    return t
