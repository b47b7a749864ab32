"""Straggler detection: per-step wall-time EMA watchdog.

Counterpart of ``repro/runtime/watchdog.py``.  The watchdog tracks an EMA
of step time and flags steps slower than ``threshold`` x EMA; after
``patience`` consecutive flags it fires ``on_straggler``.  The serving
engine (``launch/engine.py``) runs every decode step inside
``start()``/``stop()`` and routes ``on_straggler`` into
``dispatch.STATS["watchdog_fires"]``.  ``flags`` counts every flagged-slow
step, ``fired`` only sustained ones.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class Watchdog:
    threshold: float = 2.0
    patience: int = 3
    decay: float = 0.9
    on_straggler: Optional[Callable[[float, float], None]] = None

    ema: float = 0.0
    _n: int = 0
    _consecutive: int = 0
    _t0: float = 0.0
    fired: int = 0
    flags: int = 0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Record one step; returns True if this step was flagged slow."""
        dt = time.monotonic() - self._t0
        if self._n < 3:                       # warmup: first (build) steps
            self.ema = dt if self._n == 0 else self.ema
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
            self._n += 1
            return False
        slow = dt > self.threshold * self.ema
        if slow:
            self.flags += 1
            self._consecutive += 1
            if self._consecutive >= self.patience:
                self.fired += 1
                self._consecutive = 0
                if self.on_straggler:
                    self.on_straggler(dt, self.ema)
        else:
            self._consecutive = 0
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        self._n += 1
        return slow
