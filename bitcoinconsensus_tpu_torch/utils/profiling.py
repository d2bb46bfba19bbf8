"""Per-phase wall-clock timers: the port's one sanctioned clock reader.

A port of `Phases` from `bitcoinconsensus_tpu/utils/profiling.py` without
its telemetry spans (the port has no `obs/` yet): each phase accumulates
its seconds and calls on the instance, under a lock, because the batch
drivers' phases may be entered from more than one thread. `accumulate`
adds a block's seconds to one key of a stats dict, and `monotonic()` is
the clock the in-flight queue's deadlines read (`resilience/`). Host code
of `core/`, `models/`, `crypto/` and `resilience/` reads no clock of its
own (`analysis/host_lint.py`, the `time` rule).

    ph = Phases()
    with ph("host_prep"):
        ...
    ph.report()  # {"host_prep": {"secs": ..., "calls": ...}, ...}
    with accumulate(stats, "lane_prep_s"):
        ...

`Phases(enabled=False)` turns them into no-ops.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict

__all__ = ["Phases", "accumulate", "monotonic"]


def monotonic() -> float:
    """Seconds on the host's monotonic clock (deadlines and retry budgets)."""
    return time.monotonic()


@contextmanager
def accumulate(stats, key: str):
    """Add the block's wall-clock seconds to `stats[key]` when it exits
    normally (a block that raises adds nothing)."""
    t0 = time.perf_counter()
    yield
    stats[key] += time.perf_counter() - t0


class Phases:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._secs: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}

    @contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._secs[name] = self._secs.get(name, 0.0) + dt
                self._calls[name] = self._calls.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._secs.clear()
            self._calls.clear()

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"secs": self._secs[k], "calls": self._calls[k]}
                    for k in self._secs}

    def total(self) -> float:
        with self._lock:
            return sum(self._secs.values())
