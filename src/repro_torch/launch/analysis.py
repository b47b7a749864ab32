"""Roofline terms of one rank's step, on the H100's hardware model.

Counterpart of ``repro/launch/hlo_analysis.py``.  The reference reads a
compiled program: ``cost_analysis`` gives per-device FLOPs and bytes, and
its HLO text parsers (``collective_bytes``, ``collective_bytes_scaled``,
``collective_report``) sum the result shapes of every collective in the
partitioned program.  The port has no HLO and so no counterpart of those
parsers: every exchange is a call of ``distributed/collectives.py``, which
counts the bytes it sends (``WIRE``) and the bytes of its result
(``RESULT``, by the reference's hyphenated kinds) as it makes them, and
``torch.utils.flop_counter`` counts the products of the step as it runs
(``launch/dryrun.py``).

Hardware model (one NVIDIA H100 SXM, dense rates at 700 W, the data
sheet's): 989e12 bf16 FLOP/s and 1979e12 int8 OP/s on the tensor cores,
3.35e12 B/s of HBM3, and NVLink at 900 GB/s to the host's other cards,
450e9 B/s each way.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12
PEAK_OPS_INT8 = 1979e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9          # bytes/s one way, to the other cards of the host


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float, *, int8_frac: float = 0.0) -> dict:
    """Three roofline terms in seconds per step, per card.

    ``int8_frac``: the fraction of ``flops`` on the int8 tensor cores; the
    compute term divides by the peaks blended in that proportion, as the
    reference blends its two.  ``coll_bytes``: the bytes the card sends,
    over one direction of NVLink.
    """
    eff_peak = PEAK_FLOPS_BF16 + int8_frac * (PEAK_OPS_INT8 -
                                              PEAK_FLOPS_BF16)
    t_compute = flops / eff_peak
    t_memory = bytes_accessed / HBM_BW
    t_coll = coll_bytes / NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom
    total = max(t_compute, t_memory, t_coll)
    terms["step_time_lb_s"] = total
    terms["roofline_fraction"] = (t_compute / total) if total > 0 else 0.0
    return terms


def model_flops_estimate(n_params_active: float, tokens: float) -> float:
    """MODEL_FLOPS = 6 * N * D (training); callers pass 2*N*D for inference."""
    return 6.0 * n_params_active * tokens
