"""numpy bridge between the JAX package's trees and this port's tensors.

The reference's parameter and paged-cache trees, handed over as numpy
arrays (``jax.tree.map(np.asarray, tree)`` on the JAX side), become the
port's dicts of tensors with the same keys and layouts (``w_q (out, in)``,
pools ``(num_pages + 1, Hkv, page_size, hd[/2])``, ``page_table
(B, max_pages)``, layer-stacked ``units``, and a recurrent layer's
per-row f32 states beside the pools), and so does a ring cache
(codes ``(B, Hkv, span, hd[/2])``, 0-d per-layer scales and the 0-d
``pos``, shapes kept; :func:`to_torch_shard` gives one rank's shard of
it under partitioned rules), with its recurrent layers' f32 states
(RG-LRU ``h`` / ``conv``, SSD ``h`` / ``convs``), and Whisper's cache
(``layers`` stacked along the decoder layers: rings, cross K/V codes,
scales and ``pos`` of shape (L,); a 0-d ``pos``), so both packages can
start from one cache;
:func:`to_numpy` carries tensors back for comparison.  Weights therefore
cross over as they are and are never re-initialised with torch's
generator.  bfloat16 crosses as its raw 16-bit pattern, so no value is
rounded on the way.
"""
from __future__ import annotations

import numpy as np
import torch


def _array_to_tensor(a, device) -> torch.Tensor:
    # np.array(..., order="C") copies and keeps 0-d arrays 0-d (a 0-d
    # scale or ring position must not become shape (1,)).
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_torch(tree, device="cuda"):
    """Nested dicts / lists / tuples of array-likes -> tensors on ``device``
    (scalars and None pass through)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return _array_to_tensor(tree, device)


def to_torch_shard(cache, cfg, layout, device="cuda"):
    """A ring cache of the JAX package (array-likes), an LM's or
    Whisper's, as one rank's shard of it under partitioned rules
    (``distributed/partition.py::local_cache_specs``: every per-row leaf
    by row over the batch axes; over "model" the rings, and Whisper's
    ``ek`` / ``ev``, by KV head where attention splits, the RG-LRU's ``h``
    and ``conv`` by d_rnn where it splits, the SSD's states whole)."""
    from repro_torch.distributed.partition import partition_cache
    return partition_cache(to_torch(cache, device), cfg, layout)


def to_numpy(tree):
    """Tensors -> numpy (bfloat16 widens to float32, exactly)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree
