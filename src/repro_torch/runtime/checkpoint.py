"""Atomic, restartable checkpoints (no external deps), in PyTorch.

Counterpart of ``repro/runtime/checkpoint.py``, with its layout and leaf
names, so a checkpoint the reference wrote restores here:

    <dir>/step_<N>/proc_<r>.npz  +  <dir>/step_<N>/MANIFEST.json

Leaves are named by their ``jax.tree_util.keystr`` path and stored in
sorted order (:mod:`repro_torch.tree`).  Commit protocol: write into
``step_<N>.tmp``, fsync, then an atomic rename, so a crash mid-write never
corrupts the newest complete checkpoint; ``keep`` bounds disk use.

bfloat16 has no numpy dtype without ``ml_dtypes``: JAX's ``savez`` stores
it as 2-byte voids (``|V2``).  :func:`save` writes the same 16-bit
patterns the same way and records ``"bfloat16"`` in the manifest;
:func:`restore` reads the manifest's dtype and views the raw 16 bits as
``torch.bfloat16``, so every value crosses bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.array(arr, order="C")         # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         process_index: int = 0, n_procs: int = 1) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    arrays, meta = {}, {}
    for i, (name, leaf) in enumerate(tree_lib.leaves_with_paths(tree)):
        arr, dtype = _to_numpy(leaf)
        arrays[f"a{i}"] = arr
        meta[name] = {"idx": i, "dtype": dtype, "shape": list(arr.shape)}
    path = os.path.join(tmp, f"proc_{process_index}.npz")
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump({"step": step, "n_procs": n_procs, "leaves": meta}, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit

    for old in available_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{old:08d}"),
                      ignore_errors=True)
    return final


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "MANIFEST.json")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def restore(ckpt_dir: str, like_tree, *, step: int | None = None,
            process_index: int = 0):
    """Restore into the structure of ``like_tree`` (each leaf on its like
    leaf's device, in the stored dtype); returns (tree, step), or
    (None, -1) when no checkpoint exists (cold start)."""
    steps = available_steps(ckpt_dir)
    if not steps:
        return None, -1
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, f"proc_{process_index}.npz")) as data:
        flat = []
        for name, like in tree_lib.leaves_with_paths(like_tree):
            info = manifest["leaves"][name]
            flat.append(_from_numpy(data[f"a{info['idx']}"], info["dtype"],
                                    like.device))
    return tree_lib.unflatten(like_tree, flat), step
