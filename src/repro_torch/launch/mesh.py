"""Production and test meshes as ``torch.distributed`` device meshes.

Counterpart of ``repro/launch/mesh.py``.  Functions, not module-level
constants: importing this module touches no process group.  Each needs
an initialised default process group of exactly the mesh's size, and
builds its groups on ``device_type``: "cuda" (NCCL) where the tensors
live on the card, "cpu" (gloo) where they live on the host.
"""
from __future__ import annotations


def _mesh(shape, axes, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *,
                   device_type: str = "cuda"):
    """A small mesh (the tests' and ``chip_smoke.py``'s)."""
    return _mesh(shape, axes, device_type)
