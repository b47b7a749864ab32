"""int8-quantized gradient all-reduce with error feedback.

Counterpart of ``repro/distributed/compression.py``: the paper's
quantize-then-integer-op idea applied to the collective layer.  Each
rank's gradients are quantized to int8 codes on a per-leaf grid shared by
every rank (the absmax all-reduced with MAX), the codes are summed in
int32 (exact for up to 2^23 ranks), and the sum is dequantized to the
mean.  The all-reduce carries the codes widened to int32, 4 bytes an
element: as many bytes as an f32 all-reduce of the gradients (plus one f32
max a leaf), not fewer; the reference sums its codes in int32 the same
way.  The quantization residual is carried in an error-feedback buffer so
the compression bias does not accumulate (EF-SGD).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.distributed import collectives as col


def init_error_buffer(grads):
    return tree_lib.tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def compress_psum(grads, err, axis_names, *, mesh, bits: int = 8):
    """This rank's (grads, err) -> (mean-reduced grads, new err).

    Every rank of ``mesh`` calls it with its own gradients; the mean is
    over the ranks of the mesh axes ``axis_names``.  Leaves are reduced
    one after another in sorted key order (the same on every rank).
    """
    qmax = (1 << (bits - 1)) - 1
    groups = [col.group(mesh, a) for a in axis_names]
    n = col.axes_size(mesh, axis_names)

    def one(g, e):
        gf = g.to(torch.float32) + e
        amax = torch.max(torch.abs(gf))
        for grp in groups:
            col.all_reduce(amax, grp, dist.ReduceOp.MAX)
        scale = torch.clamp(amax, min=1e-12) / qmax
        q = torch.clamp(torch.round(gf / scale), -qmax - 1, qmax).to(
            torch.int8)
        new_err = gf - q.to(torch.float32) * scale        # error feedback
        acc = q.to(torch.int32)
        for grp in groups:
            col.all_reduce(acc, grp)
        mean = acc.to(torch.float32) * (scale / n)
        return mean.to(g.dtype), new_err

    outs = [one(g, e) for g, e in zip(tree_lib.leaves(grads),
                                      tree_lib.leaves(err))]
    return (tree_lib.unflatten(grads, [o[0] for o in outs]),
            tree_lib.unflatten(grads, [o[1] for o in outs]))
