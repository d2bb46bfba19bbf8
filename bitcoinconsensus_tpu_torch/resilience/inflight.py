"""In-flight dispatch tickets, settled through the guards.

Port of `bitcoinconsensus_tpu/resilience/inflight.py` with one device level.
A dispatch returns a `Ticket` without waiting for the device; a ticket's
verdicts are believed only after they pass the guards (`guards.py`) at
settle. Ticket lifecycle::

    dispatch(args, n)                     settle(ticket)
      | backpressure: settle the oldest    | materialize: one wait, then
      |   while depth >= max_depth         |   validate, sentinels, checksum
      | prepare(args, n) -> staged, sset   | clean -> (ok, needs), cached
      | launch(staged, n, sset)            | failure -> retry on the same
      |   (an exception is kept on the     |   kernel from the staged
      |   ticket, settled as a failure)    |   buffers, within the budget
      | deadline = now + deadline_s        |   and the ticket's deadline
      + queued ---------------------------> | spent -> DispatchFailed, cached

Where the reference hands a failed ticket's lanes to the host-exact oracle,
the port raises `DispatchFailed` with the last failure as its cause: by the
port's rule a failed guard is not demoted to a slower backend. A CUDA error
that leaves the device context unusable (an illegal address, a launch
failure) is not retried: it raises at once.

On a clean settle the optional `on_device` hook runs once (the verifier's
verdict accounting, so a retried ticket never counts twice); `drain()`
settles every ticket still in flight, oldest first.

Settling is idempotent and order-independent: a ticket resolves once, and
settling it again returns the same outcome or raises the same
`DispatchFailed`. Backpressure resolves the oldest ticket before its owner
asks for it, and keeps a failure for the owner. The queue holds at most
`max_depth` unresolved tickets, so a stalled device turns the pipeline
synchronous instead of piling up host buffers. One lock guards the queue
and each resolution, so threads that share a verifier neither lose a
ticket nor settle one twice.

`settle_array` is the one sanctioned place outside the verifier's settle
seam that copies a device tensor to the host (`analysis/host_lint.py`, the
`sync` rule over this module); it runs inside `region_scope("settle")`.

Telemetry, as in the reference: every ticket carries a `PhaseTimeline`
(`obs/perf.py`), stamped at submit, prepare, launch (again on a relaunch),
first poll, settle start and settle end, and finalized at settle into
`consensus_pipeline_phase_seconds{phase}` and the overlap gauge; the queue
keeps `consensus_inflight_depth{site}`, `_tickets_total{site}`,
`_settle_seconds`, `_deadline_expired_total{site}` and
`_backpressure_total{site}`, and counts retries in
`consensus_resilience_retries_total{site}`. `_redispatch_total{site}` is
registered with the reference's name and stays at zero: it counts tickets
re-dispatched after a ladder quarantine, and the port has no ladder. An
expired deadline is recorded in the flight ring. The `stats` dict it is
given (the verifier's) keeps its own counts. Host-side policy only; time is
read through the obs clock (`utils/profiling.monotonic`).
"""

from __future__ import annotations

import re
import threading
import time
from collections import defaultdict
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from ..obs import counter as _obs_counter
from ..obs import current_trace as _current_trace
from ..obs import flight as _flight
from ..obs import gauge as _obs_gauge
from ..obs import histogram as _obs_histogram
from ..obs import perf as _perf
from ..ops.regions import region_scope
from ..utils.profiling import monotonic
from .degrade import RETRIES, DispatchFailed, DispatchResilience
from .guards import VerdictAnomaly

__all__ = ["InflightQueue", "Ticket", "settle_array", "unrecoverable"]

_DEPTH = _obs_gauge(
    "consensus_inflight_depth",
    "unsettled tickets currently in the dispatch queue, by site",
    ("site",),
)
_TICKETS = _obs_counter(
    "consensus_inflight_tickets_total",
    "tickets dispatched through the in-flight queue, by site",
    ("site",),
)
_SETTLE_SECONDS = _obs_histogram(
    "consensus_inflight_settle_seconds",
    "wall-clock time from dispatch to settled verdict per ticket",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0),
)
_DEADLINE_EXPIRED = _obs_counter(
    "consensus_inflight_deadline_expired_total",
    "tickets whose wall-clock deadline expired before a clean settle, by site",
    ("site",),
)
_REDISPATCH = _obs_counter(
    "consensus_inflight_redispatch_total",
    "queued tickets cancelled and re-dispatched after a ladder "
    "quarantine invalidated their level, by site",
    ("site",),
)
_BACKPRESSURE = _obs_counter(
    "consensus_inflight_backpressure_total",
    "dispatches that had to settle the oldest ticket first because the "
    "queue was at max depth, by site",
    ("site",),
)


def settle_array(x) -> np.ndarray:
    """A device tensor (or anything array-like) as a host numpy array,
    waiting for it: the sanctioned device->host copy outside the settle
    seam."""
    with region_scope("settle"):
        if hasattr(x, "cpu"):
            return x.cpu().numpy()
        return np.asarray(x)


# CUDA errors after which the context is unusable: retrying the launch
# cannot succeed (cudaErrorIllegalAddress 700, Assert 710, HardwareStack
# 714, IllegalInstruction 715, MisalignedAddress 716, InvalidAddressSpace
# 717, InvalidPc 718, LaunchFailure 719, ECCUncorrectable 214, Unknown 999),
# as `ops/launch.py` reports them and as torch words them.
_STICKY_CODES = frozenset({214, 700, 710, 714, 715, 716, 717, 718, 719, 999})
_STICKY_TEXT = ("illegal memory access", "device-side assert",
                "hardware stack error", "illegal instruction",
                "misaligned address", "invalid address space",
                "invalid program counter", "unspecified launch failure",
                "uncorrectable ECC")


def unrecoverable(exc: BaseException) -> bool:
    """Whether `exc` is a CUDA error that leaves the device context unusable."""
    msg = str(exc)
    if "CUDA error" not in msg:
        return False
    code = re.search(r"CUDA error (\d+)", msg)
    return (code is not None and int(code.group(1)) in _STICKY_CODES) or \
        any(t in msg for t in _STICKY_TEXT)


class Ticket:
    """One in-flight dispatch: its staged buffers, the unsynchronised
    result and the settle context."""

    __slots__ = (
        "args", "n", "attempts", "born", "deadline", "sset", "result", "aux",
        "error", "settled", "outcome", "failure", "timeline",
    )

    def __init__(self, args, n: int, deadline: float, born: float = 0.0,
                 timeline=None):
        self.args = args            # staged buffers a relaunch reads
        self.n = n                  # real lanes of the dispatch
        self.attempts = 1
        self.born = born            # when it was dispatched
        self.deadline = deadline    # wall-clock settle deadline
        self.sset = None            # what `prepare` returned (the sentinels)
        self.result = None          # unsynchronised device result
        self.aux = None             # the in-flight checksum, or None
        self.error = None           # the launch's exception, if any
        self.settled = False
        self.outcome = None         # (ok, needs) after a clean settle
        self.failure = None         # DispatchFailed after a failed one
        # PhaseTimeline (or the disarmed no-op): phase stamps feeding
        # consensus_pipeline_phase_seconds at settle.
        self.timeline = _perf.NULL_TIMELINE if timeline is None else timeline


class InflightQueue:
    """A bounded queue of in-flight tickets settling through the guards.

    The queue owns the policy (deadlines, retries, backpressure); the
    verifier supplies the mechanism:

    - `prepare(args, n) -> (staged, sset)`, once per ticket at dispatch:
      stage the buffers, install the sentinel lanes;
    - `launch(staged, n, sset) -> (result, aux)`: start the device work and
      return unsynchronised tensors and the in-flight checksum (or None).
      It must not wait. An exception is kept on the ticket and settled as a
      failure;
    - `materialize(ticket) -> (ok, needs[, all_ok])`: the settle seam:
      wait, run the fault hooks and the guards; raises on a buffer they
      reject. `all_ok` is the sharded step's verdict over the device's lanes
      (None, or left out, off the mesh);
    - `on_device(ticket, ok, needs, all_ok)`, optional: the verdict
      accounting hook, called exactly once per ticket that settles clean,
      so a retried ticket is never counted twice.
    """

    def __init__(
        self,
        resilience: DispatchResilience,
        site: str,
        launch: Callable[[Any, int, Any], Tuple[Any, Any]],
        materialize: Callable[[Ticket], Tuple],
        prepare: Optional[Callable[[Any, int], Tuple[Any, Any]]] = None,
        on_device: Optional[Callable[..., None]] = None,
        stats=None,
        max_depth: int = 4,
        deadline_s: float = 8.0,
        backoff_s: float = 0.002,
    ):
        self._res = resilience
        self.site = site
        self._launch_cb = launch
        self._materialize = materialize
        self._prepare = prepare
        self._on_device = on_device
        self.stats = stats if stats is not None else defaultdict(float)
        self.max_depth = max(1, int(max_depth))
        self.deadline_s = float(deadline_s)
        self.backoff_s = float(backoff_s)
        self._pending: List[Ticket] = []
        self._lock = threading.RLock()

    # -- dispatch side -------------------------------------------------

    def dispatch(self, args, n: int) -> Ticket:
        """Launch one batch; return its ticket without waiting."""
        with self._lock:
            while len(self._pending) >= self.max_depth:
                self.stats["backpressure"] += 1
                _BACKPRESSURE.inc(site=self.site)
                self._resolve(self._pending[0])
            # The timeline starts before prepare, so the staging and the
            # sentinels are attributed; it adopts the caller's trace id.
            timeline = _perf.new_timeline(trace=_current_trace())
            timeline.stamp("submit")
            sset = None
            if self._prepare is not None:
                args, sset = self._prepare(args, n)
            timeline.stamp("prepare")
            now = monotonic()
            ticket = Ticket(args, n, deadline=now + self.deadline_s, born=now,
                            timeline=timeline)
            ticket.sset = sset
            self.stats["tickets"] += 1
            _TICKETS.inc(site=self.site)
            self._launch(ticket)
            self._pending.append(ticket)
            _DEPTH.set(len(self._pending), site=self.site)
            return ticket

    def _launch(self, ticket: Ticket) -> None:
        """Launch (or relaunch) a ticket's device work from its staged buffers."""
        ticket.result = ticket.aux = ticket.error = None
        try:
            ticket.result, ticket.aux = self._launch_cb(
                ticket.args, ticket.n, ticket.sset)
        except Exception as exc:  # settled as a failure; nothing runs instead
            ticket.error = exc
        # Re-stamped on a relaunch: the settled attempt owns the edge.
        ticket.timeline.stamp("launch")

    # -- settle side ---------------------------------------------------

    def settle(self, ticket: Ticket) -> Tuple[np.ndarray, np.ndarray]:
        """`(ok, needs)` of a ticket, padded, having passed every guard;
        raises `DispatchFailed` where no attempt within the budget did.
        Idempotent and order-independent."""
        with self._lock:
            self._resolve(ticket)
        if ticket.failure is not None:
            raise ticket.failure
        return ticket.outcome

    def _resolve(self, ticket: Ticket) -> None:
        """Settle a ticket, retrying within the budget, and keep its
        outcome or its failure on it. Never raises."""
        if ticket.settled:
            return
        # First host touch after the launch: the time since is the overlap
        # window, device time the host did not wait on.
        ticket.timeline.stamp_once("first_poll")
        if ticket in self._pending:
            self._pending.remove(ticket)
        _DEPTH.set(len(self._pending), site=self.site)
        stats = self.stats
        while True:
            failure = ticket.error
            if failure is None:
                ticket.timeline.stamp("settle_start")
                try:
                    got = self._materialize(ticket)
                except Exception as exc:
                    failure = exc
                else:
                    ok, needs = got[0], got[1]
                    _SETTLE_SECONDS.observe(monotonic() - ticket.born)
                    if self._on_device is not None:
                        self._on_device(ticket, ok, needs,
                                        got[2] if len(got) > 2 else None)
                    ticket.outcome = (ok, needs)
                    break
            stats["settle_failures"] += 1
            if isinstance(failure, VerdictAnomaly):
                stats["guard_anomalies"] += 1
            if unrecoverable(failure):
                break
            if monotonic() >= ticket.deadline:
                stats["deadline_expired"] += 1
                _DEADLINE_EXPIRED.inc(site=self.site)
                _flight.record("inflight.deadline_expired", site=self.site,
                               attempts=ticket.attempts)
                break
            if not self._res.may_retry(ticket.attempts, ticket.deadline):
                break
            stats["retries"] += 1
            RETRIES.inc(site=self.site)
            ticket.attempts += 1
            if self.backoff_s > 0.0:
                time.sleep(min(self.backoff_s * (1 << min(ticket.attempts, 8)),
                               0.05))
            self._launch(ticket)
        if ticket.outcome is None:
            err = DispatchFailed(
                f"{self.site}: dispatch of {ticket.n} lanes failed after "
                f"{ticket.attempts} attempt(s): {failure}")
            err.__cause__ = failure
            ticket.failure = err
        ticket.settled = True
        ticket.args = ticket.result = ticket.aux = ticket.error = None
        ticket.timeline.stamp("settle_end")
        ticket.timeline.finalize()

    # -- introspection -------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self._pending)

    def drain(self) -> None:
        """Settle everything still in flight, oldest first; a failure stays
        on its ticket for its owner."""
        with self._lock:
            while self._pending:
                self._resolve(self._pending[0])
