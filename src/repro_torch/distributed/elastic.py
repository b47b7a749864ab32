"""Elastic scaling: rebuild the mesh after membership changes and reshard.

Counterpart of ``repro/distributed/elastic.py``.  Recovery path on node
failure / straggler eviction:
  1. the launcher restarts the surviving processes with the new world
     size;
  2. :func:`best_mesh` re-carves (data, model) for that count, keeping the
     model axis (weight shards must still fit) and shrinking / growing
     data;
  3. params and optimizer state reload from the latest checkpoint under
     the new mesh (checkpoints hold global tensors, so resharding is just
     placement: :func:`reshard_to`);
  4. the data pipeline continues from the checkpointed step.
"""
from __future__ import annotations

from repro_torch import tree as tree_lib
from repro_torch.distributed.sharding import (filter_mesh_axes,
                                              named_shardings, param_specs)


def best_mesh(n_devices: int, *, model_parallel: int = None,
              axes=("data", "model"), device_type: str = "cuda"):
    """The largest (data, model) ``DeviceMesh`` over the ``n_devices``
    ranks of the (restarted) process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if dist.get_world_size() != n_devices:
        raise ValueError(f"best_mesh({n_devices}) in a world of "
                         f"{dist.get_world_size()} ranks")
    if model_parallel is None:
        # Keep the model axis as large as possible but <= sqrt(n).
        model_parallel = 1
        for m in range(1, int(n_devices ** 0.5) + 1):
            if n_devices % m == 0:
                model_parallel = m
    return init_device_mesh(device_type,
                            (n_devices // model_parallel, model_parallel),
                            mesh_dim_names=tuple(axes))


def reshard_to(tree, mesh):
    """Place a host-global tree onto ``mesh`` per the standard rules: each
    leaf becomes a DTensor sharded by :func:`param_specs` (every rank
    passes the same global tree)."""
    from torch.distributed.tensor import distribute_tensor
    specs = filter_mesh_axes(param_specs(tree), mesh)
    placements = named_shardings(specs, mesh)
    leaves = [distribute_tensor(x.to(mesh.device_type), mesh, pl)
              for x, pl in zip(tree_lib.leaves(tree),
                               tree_lib.leaves(placements))]
    return tree_lib.unflatten(tree, leaves)
