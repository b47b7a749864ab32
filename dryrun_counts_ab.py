"""Time the dry run's own counter against torch's tools, on the CPU.

    python3 dryrun_counts_ab.py      # from the repository root, no card

``repro_torch.launch.dryrun`` counts a step's FLOPs and its temp peak with
``StepCounts`` (``flop_counter``'s formulas and an op-by-op storage tally
in one dispatch mode over ``MetaResults``).  This script runs the whole
sweep (every arch, shape and mesh, as ``--all --mesh both``) twice, once
with ``StepCounts`` and once with ``FlopCounterMode`` and ``MemTracker``
stacked over the same ``MetaResults``, each in a spawn pool of one process
a core, and holds every cell's counts equal between the two.  Prints one
line per sweep and a last JSON line with both sweeps' seconds.
"""
from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))


def torch_counts():
    """A drop-in for ``dryrun.StepCounts`` built from torch's own tools."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun

    class MetaMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.results = dryrun.MetaResults()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return self.results(func, args, kwargs or {})

    class TorchCounts:
        def __init__(self, external=(), memory=True):
            self.external = [t for t in pytree.tree_leaves(external)
                             if isinstance(t, torch.Tensor)]
            self.flop_mode = FlopCounterMode(display=False)
            self.tracker = MemTracker() if memory else None
            self.flops = self.peak = 0

        def __enter__(self):
            self.stack = contextlib.ExitStack()
            self.stack.enter_context(MetaMode())
            self.stack.enter_context(self.flop_mode)
            if self.tracker is not None:
                self.tracker.track_external(*self.external)
                self.stack.enter_context(self.tracker)
            return self

        def __exit__(self, *exc):
            self.stack.close()
            self.flops = self.flop_mode.get_total_flops()
            if self.tracker is not None:
                peak = self.tracker.get_tracker_snapshot("peak")
                peak = peak.get(torch.device("meta"), {})
                self.peak = peak.get("Total", 0) - \
                    peak.get(_MemRefType.OTH, 0)
            return False

    return TorchCounts


def run_one(job):
    import torch
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    arch, shape, mesh_kind, tools = job
    if tools == "torch":
        dryrun.StepCounts = torch_counts()
    rec = dryrun.run_cell(arch, shape, mesh_kind, verbose=False)
    return (arch, shape, mesh_kind), rec


def sweep(tools, cells, jobs):
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(jobs, maxtasksperchild=1) as pool:
        recs = dict(pool.imap_unordered(
            run_one, [c + (tools,) for c in cells]))
    return time.perf_counter() - t0, recs


def main():
    from repro_torch.configs.registry import ARCHS, SHAPES
    cells = [(a, s, m) for a in ARCHS if a != "deit-s" for s in SHAPES
             for m in ("single", "multi")]
    jobs = min(len(os.sched_getaffinity(0)), len(cells))
    out, recs = {}, {}
    for tools in ("step", "torch"):
        wall, recs[tools] = sweep(tools, cells, jobs)
        ok = [r for r in recs[tools].values() if r["status"] == "ok"]
        cell_s = sum(r["seconds"] for r in ok)
        out[tools] = {"wall_s": round(wall, 1), "cell_s": round(cell_s, 1),
                      "ok": len(ok)}
        print(f"[ab] {tools}: {len(cells)} cells ({len(ok)} ok) in "
              f"{wall:.1f} s on {jobs} processes, cells' own "
              f"{cell_s:.1f} s", flush=True)
    differ = []
    for key, a in recs["step"].items():
        b = recs["torch"][key]
        if a["status"] != b["status"] or a.get("cost") != b.get("cost") or \
                a.get("cost_unrolled") != b.get("cost_unrolled") or \
                a.get("memory") != b.get("memory"):
            differ.append("|".join(key))
    print(f"[ab] counts differ in {len(differ)} cells: {differ}")
    print(json.dumps({"sweeps": out, "jobs": jobs, "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
