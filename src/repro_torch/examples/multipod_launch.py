"""Production-mesh launch walk-through: rank 0's step of one cell on the
2 x 16 x 16 multi-pod mesh (512 ranks), on meta tensors under torch's
fake process group, and its memory, cost and collective counts printed.

Counterpart of ``examples/multipod_launch.py``.  It is the dry run of
``repro_torch.launch.dryrun`` for one cell: the rank runs the same
partitioned program a real launcher would start on each card, with
nothing allocated and nothing sent.  It needs no card.

Run:  PYTHONPATH=src python -m repro_torch.examples.multipod_launch \\
          [--arch chatglm3-6b] [--shape train_4k] [--mesh multi]
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell
    rec = run_cell(args.arch, args.shape, args.mesh)
    rec.pop("trace", None)
    print(json.dumps(rec, indent=2, default=str))
    return rec


if __name__ == "__main__":
    main()
