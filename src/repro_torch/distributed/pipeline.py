"""Pipeline parallelism: GPipe over a "stage" mesh axis.

Counterpart of ``repro/distributed/pipeline.py``.  Each rank of the
"stage" axis holds one stage's slice of layers; microbatches stream
through, stage s handing its activation to stage s + 1 after every step
(``batch_isend_irecv``), in the classic fill-drain loop of
``n_micro + n_stages - 1`` steps.  The last stage's outputs are shared
with every stage by a masked all-reduce.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.distributed import collectives as col


def pipeline_forward(stage_fn: Callable, params_stacked, x_microbatches,
                     mesh, *, axis: str = "stage"):
    """Run microbatches through pipeline stages.

    stage_fn(stage_params, x) -> x: one stage's computation.
    params_stacked: tree with leading dim = n_stages (every rank may hold
    all of it; stage s reads slice s).  x_microbatches: (n_micro, mb, ...),
    the same on every rank.  Returns (n_micro, mb, ...), the last stage's
    outputs, on every rank.
    """
    grp = col.group(mesh, axis)
    n_stages = col.axes_size(mesh, (axis,))
    stage = col.axes_index(mesh, (axis,))
    n_micro = x_microbatches.shape[0]
    params = tree_lib.tree_map(lambda w: w[stage], params_stacked)
    buf = torch.zeros_like(x_microbatches[0])          # current activation
    outs = torch.zeros_like(x_microbatches)
    for i in range(n_micro + n_stages - 1):
        mb = i - stage
        cur = x_microbatches[min(i, n_micro - 1)] if stage == 0 else buf
        y = stage_fn(params, cur) if 0 <= mb < n_micro else cur
        if stage == n_stages - 1 and 0 <= mb < n_micro:
            outs[mb] = y
        # shift activations stage -> stage + 1
        ops = []
        if stage < n_stages - 1:
            col.check_device(y, grp)
            ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                  dist.get_global_rank(grp, stage + 1), grp))
        if stage > 0:
            buf = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(grp, stage - 1), grp))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    if stage != n_stages - 1:
        outs.zero_()
    return col.all_reduce(outs, grp)
