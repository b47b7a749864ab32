"""Time qmatmul's split-K plans against the same tensor-core body unsplit,
on one NVIDIA GPU.

    python3 qmatmul_split_ab.py      # from the repository root, one card

For every (N, K) of one Qwen2.5-32B layer where ``qmatmul.plan`` splits K
at the prefill's 256 rows, int8 and packed, runs the plan and the unsplit
plans ``("mma", 128, 128, 1)`` and ``("mma", 64, 128, 1)`` in the order
plan, unsplit, unsplit, plan, each held exactly against the plain version
and timed with ``chip_smoke.py``'s CUDA-event and profiler helpers.
Prints the card's name and power limit, one line per timing, and a last
JSON line with the medians (device ms) per shape and plan.
"""
from __future__ import annotations

import json
import statistics
import sys

import chip_smoke as cs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("qmatmul_split_ab.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import ref
    from repro_torch.kernels import qmatmul as qm
    cs.log(f"[device] {cs.card_line()}")
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for n, k in cs.QMM_NK:
        split = qm.plan(256, n, k)
        if split[3] == 1:
            continue
        for packed in (False, True):
            x, w, s, b, rs = cs.qmatmul_inputs(g, 256, n, k, packed)
            want = ref.qmatmul_ref(x, w, s, b, rs)
            plans = [split, ("mma", 128, 128, 1), ("mma", 64, 128, 1)]
            order = plans + plans[1:][::-1] + [split]
            times = {p: [] for p in plans}
            for p in order:
                call = lambda: qm.qmatmul(x, w, s, b, rs, blocks=p,
                                          packed=packed)
                if not torch.equal(call(), want):
                    raise AssertionError(f"plan {p} differs from the plain "
                                         "version")
                ms, dms = cs.cuda_ms(call), cs.device_ms(call)
                times[p].append(dms)
                cs.log(f"[split] M=256 N={n} K={k} packed={packed} plan {p}: "
                       f"{ms:.4f} ms (device {dms:.4f} ms)")
            result[f"256x{n}x{k}{'p' if packed else ''}"] = {
                str(p): statistics.median(t) for p, t in times.items()}
            del x, w, s, b, rs, want
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
