"""Deterministic fault injection for the serving engine (PyTorch).

Counterpart of ``repro/runtime/faults.py``.  A :class:`FaultPlan` turns
the serving engine's failure modes into a seeded, replayable event stream,
so its recovery paths (victim preemption with bit-exact resume, the
watchdog, per-row NaN quarantine; see :mod:`repro_torch.launch.engine`)
run the same way every time.  The plan precomputes its whole schedule at
construction from one ``numpy.random.RandomState(seed)``, with the
reference's draw order, so a seed gives the reference's events, step for
step.  Four fault kinds:

``steal``
    Allocator exhaustion: ``steal_pages`` physical pages are allocated out
    of the engine's :class:`~repro_torch.launch.engine.PageAllocator` and
    held for ``steal_hold`` steps, which is the pressure that triggers
    registry reclaim and then victim preemption.
``stall``
    A straggler: the engine sleeps ``stall_s`` inside the watchdog's
    timing window.
``force_xla``
    A forced fallback for one step.  The name is the reference's (its
    fallback is the XLA path); here the step runs the plain ``torch``
    backend, selected explicitly, in place of the CUDA kernels, and the
    engine counts it in ``dispatch.STATS["forced_xla_steps"]``.
``nan_row``
    NaN escaping the dequantization epilogue of one batch row:
    :func:`corrupt_rows` overwrites that row's logits after the step, and
    the engine must quarantine the row (preempt and recompute).

Tests pin events with ``at=[FaultEvent(step=3, ...)]`` or
:meth:`FaultPlan.schedule`; a pinned event merges field-wise into any
seeded event at the same step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class FaultEvent:
    """Faults injected at one engine step (fields combine freely)."""
    step: int
    steal_pages: int = 0          # pages taken from the allocator ...
    steal_hold: int = 0           # ... and held for this many steps
    stall_s: float = 0.0          # sleep inside the watchdog window
    force_xla: bool = False       # run the step on the plain backend
    nan_row: Optional[int] = None  # corrupt this (mod active) row's logits

    def merge(self, other: "FaultEvent") -> "FaultEvent":
        """Field-wise union of two events at the same step."""
        return FaultEvent(
            step=self.step,
            steal_pages=max(self.steal_pages, other.steal_pages),
            steal_hold=max(self.steal_hold, other.steal_hold),
            stall_s=max(self.stall_s, other.stall_s),
            force_xla=self.force_xla or other.force_xla,
            nan_row=self.nan_row if other.nan_row is None else other.nan_row)


class FaultPlan:
    """Seeded, precomputed fault schedule (a pure function of its
    arguments, never of engine timing)."""

    def __init__(self, seed: int = 0, horizon: int = 2048, *,
                 p_steal: float = 0.0, steal_pages: int = 2,
                 steal_hold: int = 4,
                 p_stall: float = 0.0, stall_s: float = 0.02,
                 p_fallback: float = 0.0,
                 p_nan: float = 0.0,
                 at: Iterable[FaultEvent] = ()):
        self.seed, self.horizon = seed, horizon
        self._events: dict[int, FaultEvent] = {}
        rng = np.random.RandomState(seed)
        for step in range(horizon):
            # A fixed draw count per step: the schedule at step s never
            # depends on which probabilities are enabled before it.
            u = rng.rand(4)
            row_draw = int(rng.randint(0, 1 << 30))
            ev = FaultEvent(step=step)
            if u[0] < p_steal:
                ev.steal_pages, ev.steal_hold = steal_pages, steal_hold
            if u[1] < p_stall:
                ev.stall_s = stall_s
            if u[2] < p_fallback:
                ev.force_xla = True
            if u[3] < p_nan:
                ev.nan_row = row_draw
            if (ev.steal_pages or ev.stall_s or ev.force_xla
                    or ev.nan_row is not None):
                self._events[step] = ev
        for ev in at:
            self.schedule(ev)

    def schedule(self, event: FaultEvent):
        """Pin an exact event (merges into any seeded event at that step)."""
        cur = self._events.get(event.step)
        self._events[event.step] = event if cur is None else cur.merge(event)

    def at_step(self, step: int) -> Optional[FaultEvent]:
        return self._events.get(step)

    def summary(self) -> dict:
        """Schedule census for reports: events per fault kind."""
        evs = self._events.values()
        return {
            "seed": self.seed,
            "events": len(self._events),
            "steals": sum(1 for e in evs if e.steal_pages),
            "stalls": sum(1 for e in evs if e.stall_s),
            "forced_xla": sum(1 for e in evs if e.force_xla),
            "nan_rows": sum(1 for e in evs if e.nan_row is not None),
        }


def corrupt_rows(logits: torch.Tensor, rows) -> torch.Tensor:
    """``logits`` (B, 1, V) with ``rows`` overwritten by NaN, out of place.

    Models NaN escaping the dequantization epilogue of those rows'
    matmuls, injected after the step and before token selection, where the
    engine's per-row finite check sits.  The input is left unchanged.
    """
    idx = torch.as_tensor(list(rows), dtype=torch.long, device=logits.device)
    return logits.index_fill(0, idx, float("nan"))
