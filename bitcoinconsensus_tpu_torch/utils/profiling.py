"""Per-phase wall-clock timers over the obs spans.

The port of `bitcoinconsensus_tpu/utils/profiling.py`. `Phases` keeps the
per-instance accumulation its users read (`report()`, `total()`; the
verifier's phases and stats keys), under a lock because the batch drivers'
phases may be entered from more than one thread, and each phase runs inside
the obs span ``<scope>.<name>``: every `Phases` user feeds
`consensus_span_duration_seconds{span="verifier.dispatch"}` and any
attached sink. `accumulate` adds a block's seconds to one key of a stats
dict, and `monotonic()` is the obs clock the in-flight queue's deadlines
read (`resilience/`). With `obs/spans.py`, this is the port's sanctioned
clock reader: host code of `core/`, `models/`, `crypto/` and `resilience/`
reads no clock of its own (`analysis/host_lint.py`, the `time` rule).

    ph = Phases()
    with ph("host_prep"):
        ...
    ph.report()  # {"host_prep": {"secs": ..., "calls": ...}, ...}
    with accumulate(stats, "lane_prep_s"):
        ...

`Phases(enabled=False)` turns them into no-ops. `reset()` clears only the
instance's dicts; the registry's metrics are process-wide
(`obs.get_registry().reset()`). `torch_trace(log_dir)` is the counterpart of
the reference's `xla_trace`: a thin adapter over `obs.xprof.trace_session`.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict

from ..obs import spans as _spans

__all__ = ["Phases", "accumulate", "monotonic", "torch_trace"]


def monotonic() -> float:
    """Seconds on the host's monotonic clock (the obs clock)."""
    return _spans.monotonic()


@contextmanager
def accumulate(stats, key: str):
    """Add the block's wall-clock seconds to `stats[key]` when it exits
    normally (a block that raises adds nothing)."""
    t0 = _spans.monotonic()
    yield
    stats[key] += _spans.monotonic() - t0


class Phases:
    def __init__(self, enabled: bool = True, scope: str = "verifier"):
        self.enabled = enabled
        self.scope = scope
        self._lock = threading.Lock()
        self._secs: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}

    @contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        sp = None
        try:
            with _spans.span(f"{self.scope}.{name}") as sp:
                yield
        finally:
            if sp is not None and sp.duration_s is not None:
                with self._lock:
                    self._secs[name] = self._secs.get(name, 0.0) + sp.duration_s
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


@contextmanager
def torch_trace(log_dir: str = "build/torch_trace"):
    """A torch.profiler capture of the block into `log_dir` (a chrome trace
    per capture): a thin adapter over `obs.xprof.trace_session`, which also
    parses such traces into per-region device time."""
    from ..obs.xprof import trace_session

    with trace_session(log_dir) as prof:
        yield prof
    print(f"torch trace written to {log_dir}")
