"""Preemption handling: SIGTERM/SIGUSR1 -> graceful drain-and-exit.

Counterpart of ``repro/runtime/preemption.py``.  The serving loop
(``launch/serve.py``) polls :func:`should_stop` each step; on True it stops
admitting, releases in-flight rows via ``PagedEngine.shutdown()`` (partial
outputs kept, ``preempted: true`` in the report) and exits with
:data:`PREEMPTED_EXIT_CODE`.  :func:`install` returns the handlers it
replaced so a caller can put them back (:func:`restore`).
"""
from __future__ import annotations

import signal
from typing import Optional

PREEMPTED_EXIT_CODE = 42
SIGNALS = (signal.SIGTERM, signal.SIGUSR1)
_FLAG = {"stop": False, "signum": None}


def _handler(signum, frame):
    _FLAG["stop"] = True
    _FLAG["signum"] = signum


def install() -> dict:
    """Install the handlers; returns ``{signum: previous handler}``."""
    return {s: signal.signal(s, _handler) for s in SIGNALS}


def restore(previous: dict):
    for s, h in previous.items():
        signal.signal(s, h)


def should_stop() -> bool:
    return _FLAG["stop"]


def last_signal() -> Optional[int]:
    """The signal number that tripped the flag (None if never tripped)."""
    return _FLAG["signum"]


def reset():
    _FLAG["stop"] = False
    _FLAG["signum"] = None
