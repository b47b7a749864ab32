"""Time qmatmul's plans against the plans they rule out, on one NVIDIA GPU.

    python3 qmatmul_split_ab.py      # from the repository root, one card

Two choices of ``qmatmul.plan`` are held against the same body without
them, int8 and packed:

- split K: for every (N, K) of one Qwen2.5-32B layer where the plan splits
  K at the prefill's 256 rows, the plan against the unsplit plans
  ``("mma", 128, 128, 1)`` and ``("mma", 64, 128, 1)``;
- the decode body's block width: at every (N, K) of the layer and its
  lm_head at the decode's 4 rows, the plan against the other width of W
  rows a block (``("stream", 8, 16, 1)`` or ``("stream", 8, 32, 1)``).

Each shape runs the plans in the order plan, others, others reversed,
plan, each held exactly against the plain version and timed with
``chip_smoke.py``'s CUDA-event and profiler helpers.  Prints the card's
name and power limit, one line per timing, and a last JSON line with the
medians (device ms) per shape and plan.
"""
from __future__ import annotations

import json
import statistics
import sys

import chip_smoke as cs


def compare(g, m, n, k, packed, plans, result):
    """Time ``plans`` (the plan first) at one shape into ``result``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import qmatmul as qm
    x, w, s, b, rs = cs.qmatmul_inputs(g, m, n, k, packed)
    want = ref.qmatmul_ref(x, w, s, b, rs)
    order = plans + plans[1:][::-1] + plans[:1]
    times = {p: [] for p in plans}
    for p in order:
        call = lambda: qm.qmatmul(x, w, s, b, rs, blocks=p, packed=packed)
        if not torch.equal(call(), want):
            raise AssertionError(f"plan {p} differs from the plain version")
        ms, dms = cs.cuda_ms(call), cs.device_ms(call)
        times[p].append(dms)
        cs.log(f"[ab] M={m} N={n} K={k} packed={packed} plan {p}: "
               f"{ms:.4f} ms (device {dms:.4f} ms)")
    result[f"{m}x{n}x{k}{'p' if packed else ''}"] = {
        str(p): statistics.median(t) for p, t in times.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("qmatmul_split_ab.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import qmatmul as qm
    cs.log(f"[device] {cs.card_line()}")
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for n, k in cs.QMM_NK:
        split = qm.plan(256, n, k)
        if split[3] == 1:
            continue
        for packed in (False, True):
            compare(g, 256, n, k, packed,
                    [split, ("mma", 128, 128, 1), ("mma", 64, 128, 1)],
                    result)
    for n, k in cs.QMM_NK:
        plan = qm.plan(4, n, k)
        other = ("stream", plan[1], 16 if plan[2] == 32 else 32, 1)
        for packed in (False, True):
            compare(g, 4, n, k, packed, [plan, other], result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
