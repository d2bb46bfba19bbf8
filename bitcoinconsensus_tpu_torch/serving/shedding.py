"""SLO-driven load shedding: settle-latency quantiles → admission.

Port of `bitcoinconsensus_tpu/serving/shedding.py`.

The shed decision is a queueing estimate, not a vibe: the server
observes every coalesced batch's settle latency into `SloTracker`,
which keeps a bounded sliding window of the most recent samples and
derives exact p50/p99 order statistics from it (published as gauges;
each observation also feeds the exported
``consensus_serving_batch_seconds`` histogram, which is a metrics sink
only — admission never reads it). `AdmissionController` then asks, for
each arriving request: *if admitted, how long until its batch settles?*
— `ceil((backlog + 1) / batch_capacity)` batches ahead of it (queued
AND in flight), each costing ~p99. When that projected wait exceeds the
deadline budget, the request is shed with an explicit
`Error.ERR_OVERLOADED` (fail-closed reject, never a hang; the
bounded-retry client in serving/client.py is the recovery path).

Shedding must be recoverable as well as fail-closed, so two rules keep
the controller from latching shut: an **empty backlog always admits**
(with nothing ahead of it the request cannot miss its deadline by
queueing, and its settle is the probe that refreshes the latency
window), and the window **ages out** old samples — a cold-compile tail
or a since-quarantined slow rung stops dominating p99 after `window`
further batches instead of poisoning a lifetime-cumulative estimate
forever. The window is also per-`SloTracker` (per server), so one slow
or defunct server instance in the process cannot contaminate another's
admission decisions through the shared exported histogram.

Ladder coupling, kept duck-typed: `AdmissionController(ladder=...)`
takes any object with `levels` (an ordered list) and `current` (one of
them), the reference's `resilience/degrade.Ladder` contract, and divides
the deadline budget by ``1 + rung``: a dispatch path running on a slower
rung sheds earlier, and re-promotion restores the budget. The port has no
ladder (`resilience/degrade.py`: a dispatch whose retries are spent raises
`DispatchFailed`), so its `VerifyServer` passes none and admission reads
rung 0; a caller with a ladder of its own, or a test holding this
controller against the reference's at each rung, passes one.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Optional

from ..obs import flight as _flight
from ..obs import gauge as _obs_gauge
from ..obs import histogram as _obs_histogram

__all__ = [
    "AdmissionController",
    "SloTracker",
    "SHED_CLOSED",
    "SHED_SLO",
    "SHED_TENANT_FULL",
]

# Shed reasons (the `reason` label on consensus_serving_shed_total).
SHED_CLOSED = "closed"            # server draining / shut down
SHED_TENANT_FULL = "tenant_full"  # bounded per-tenant queue depth hit
SHED_SLO = "slo"                  # projected queue wait blows the deadline

# Batch settle latencies: 1 ms (warm cached replay) .. 10 s (a cold
# start, or the plain version on the CPU). Export-only: admission reads the exact
# sliding-window samples, not these bucket edges.
_BATCH_LATENCY_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_BATCH_SECONDS = _obs_histogram(
    "consensus_serving_batch_seconds",
    "coalesced batch settle latency (flush to verdict delivery)",
    buckets=_BATCH_LATENCY_BUCKETS,
)
_SLO_GAUGE = _obs_gauge(
    "consensus_serving_slo_seconds",
    "batch settle-latency quantile estimates driving admission",
    ("q",),
)
# Exposition-friendly plain-gauge aliases of the same two quantiles:
# dashboards and the stats gate's REQUIRED_METRICS want stable unlabeled
# names (`obs/stats.py`).
_SLO_P50 = _obs_gauge(
    "consensus_serving_slo_p50_seconds",
    "sliding-window p50 batch settle latency (admission estimator)",
)
_SLO_P99 = _obs_gauge(
    "consensus_serving_slo_p99_seconds",
    "sliding-window p99 batch settle latency (admission estimator)",
)

DEFAULT_SLO_WINDOW = 128


class SloTracker:
    """Sliding window of settle latencies + derived p50/p99 gauges.

    Quantiles are exact order statistics over the last `window`
    observations, so the estimate both tracks the current regime and
    forgets old tails — the property the admission controller needs to
    recover after a slow burst. The process-global export histogram is
    fed on every observe but never read back.
    """

    def __init__(self, histogram=None, window: int = DEFAULT_SLO_WINDOW):
        if window < 1:
            raise ValueError("window must be >= 1")
        self._hist = histogram if histogram is not None else _BATCH_SECONDS
        self._window: deque = deque(maxlen=window)
        self._lock = threading.Lock()
        self._p50 = _SLO_GAUGE.labels(q="p50")
        self._p99 = _SLO_GAUGE.labels(q="p99")

    def observe(self, seconds: float) -> None:
        self._hist.observe(seconds)
        with self._lock:
            self._window.append(float(seconds))
        p50, p99 = self.quantile(0.5), self.quantile(0.99)
        self._p50.set(p50)
        self._p99.set(p99)
        _SLO_P50.set(p50)
        _SLO_P99.set(p99)

    def quantile(self, q: float) -> Optional[float]:
        """Upper sample quantile of the window: the smallest observed
        latency with at least a ``q`` fraction of samples at or below
        it. None with no observations yet (cold start)."""
        if not 0.0 < q <= 1.0:
            raise ValueError("q must be in (0, 1]")
        with self._lock:
            if not self._window:
                return None
            samples = sorted(self._window)
        rank = max(0, min(len(samples) - 1, math.ceil(q * len(samples)) - 1))
        return samples[rank]


class AdmissionController:
    """Reject work whose projected queue wait blows the SLO deadline."""

    def __init__(
        self,
        slo_deadline_s: float,
        batch_capacity: int,
        slo: SloTracker,
        ladder=None,
    ):
        if slo_deadline_s <= 0:
            raise ValueError("slo_deadline_s must be > 0")
        if batch_capacity < 1:
            raise ValueError("batch_capacity must be >= 1")
        self.slo_deadline_s = slo_deadline_s
        self.batch_capacity = batch_capacity
        self.slo = slo
        self._ladder = ladder

    def ladder_rung(self) -> int:
        """0 at full health (and with no ladder); grows as the ladder's
        current level moves down its `levels`."""
        if self._ladder is None:
            return 0
        try:
            return self._ladder.levels.index(self._ladder.current)
        except ValueError:  # defensive: unknown level reads as healthy
            return 0

    def deadline_budget_s(self) -> float:
        return self.slo_deadline_s / (1 + self.ladder_rung())

    def admit(self, backlog: int) -> Optional[str]:
        """None to admit, else the shed reason.

        `backlog` is everything ahead of the arriving request — queued
        in the coalescer AND in flight on the device. Two unconditional
        admits keep the controller recoverable: **cold start** (no
        latency evidence to shed on; the per-tenant depth bound still
        caps a thundering herd) and an **empty backlog** — with nothing
        ahead, queueing cannot blow the deadline, and that request's
        settle is the probe that refreshes the latency window, so a
        slow tail can never latch the server into shedding forever.
        """
        if backlog <= 0:
            return None
        p99 = self.slo.quantile(0.99)
        if p99 is None:
            return None
        batches_ahead = backlog // self.batch_capacity + 1
        if batches_ahead * p99 > self.deadline_budget_s():
            _flight.record("shed", reason=SHED_SLO, backlog=backlog,
                           p99=p99, budget_s=self.deadline_budget_s())
            return SHED_SLO
        return None
