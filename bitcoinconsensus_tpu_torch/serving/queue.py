"""Fair coalescing admission queue for the serving front end.

Port of `bitcoinconsensus_tpu/serving/queue.py`, pure Python, unchanged in
behaviour.

Many small concurrent `verify*` requests arrive here and leave as full
device batches: `CoalescingQueue.take` blocks until either enough work
has accumulated to fill a `lane_capacity` batch (size trigger) or the
oldest queued request has waited `flush_s` (time trigger), then pops up
to `max_n` entries. The pop is *fair*: one entry per tenant per
rotation turn (round-robin over per-tenant FIFOs), so a tenant flooding
the queue cannot starve a light one — its surplus simply waits more
turns. Per-tenant depth is bounded; a full tenant queue rejects at
`put` time (`TenantQueueFull`), which the server above turns into an
explicit fail-closed shed, never a silent drop.

Entries are opaque to the queue except for two attributes the server's
request objects carry: ``tenant`` (fairness key) and ``enqueued``
(obs.monotonic stamp, drives the time trigger and the queue-wait
histogram). All clock reads go through `obs.monotonic` — the one
sanctioned clock (analysis/host_lint.py timing rules cover serving/).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional

from ..obs import gauge as _obs_gauge
from ..obs import monotonic as _monotonic

__all__ = ["CoalescingQueue", "QueueClosed", "TenantQueueFull"]

_QUEUE_DEPTH = _obs_gauge(
    "consensus_serving_queue_depth",
    "requests currently queued in the serving coalescer, by tenant",
    ("tenant",),
)


class TenantQueueFull(Exception):
    """The tenant's bounded queue slice is full (backpressure boundary)."""


class QueueClosed(Exception):
    """put() after close(): the server is draining or shut down."""


class CoalescingQueue:
    """Per-tenant bounded FIFOs drained round-robin into device batches."""

    def __init__(self, tenant_depth: int, clock=_monotonic):
        if tenant_depth < 1:
            raise ValueError("tenant_depth must be >= 1")
        self.tenant_depth = tenant_depth
        self._clock = clock
        self._cond = threading.Condition()
        self._tenants: Dict[str, Deque] = {}
        # Rotation order: tenants with queued work, advanced one entry
        # per turn by _pop_fair. A tenant re-enters at the back.
        self._rr: List[str] = []
        self._total = 0
        self._closed = False

    @property
    def total(self) -> int:
        with self._cond:
            return self._total

    def depth(self, tenant: str) -> int:
        with self._cond:
            dq = self._tenants.get(tenant)
            return len(dq) if dq else 0

    def put(self, entry) -> None:
        """Enqueue one request; raises instead of blocking when the
        tenant slice is full (the caller sheds explicitly) or the queue
        is closed."""
        tenant = entry.tenant
        with self._cond:
            if self._closed:
                raise QueueClosed(tenant)
            dq = self._tenants.get(tenant)
            if dq is None:
                dq = self._tenants[tenant] = deque()
                self._rr.append(tenant)
            if len(dq) >= self.tenant_depth:
                raise TenantQueueFull(tenant)
            dq.append(entry)
            self._total += 1
            _QUEUE_DEPTH.set(len(dq), tenant=tenant)
            self._cond.notify_all()

    def take(self, max_n: int, flush_s: float,
             block: bool = True) -> Optional[list]:
        """Pop up to `max_n` entries once a flush trigger fires.

        Triggers: total queued >= max_n (size), oldest entry older than
        `flush_s` (time), or the queue is closed (drain — whatever is
        queued flushes immediately). Returns None when the queue is
        empty and closed, or empty with ``block=False`` (the stream
        driver uses that as its end-of-burst signal).
        """
        with self._cond:
            while True:
                if self._total == 0:
                    if self._closed or not block:
                        return None
                    self._cond.wait()
                    continue
                if self._total >= max_n or self._closed:
                    return self._pop_fair(max_n)
                oldest = min(
                    dq[0].enqueued for dq in self._tenants.values() if dq
                )
                remaining = flush_s - (self._clock() - oldest)
                if remaining <= 0:
                    return self._pop_fair(max_n)
                self._cond.wait(remaining)

    def _pop_fair(self, max_n: int) -> list:
        out = []
        while self._total and len(out) < max_n:
            tenant = self._rr.pop(0)
            dq = self._tenants[tenant]
            out.append(dq.popleft())
            self._total -= 1
            _QUEUE_DEPTH.set(len(dq), tenant=tenant)
            if dq:
                self._rr.append(tenant)
            else:
                del self._tenants[tenant]
        return out

    def close(self) -> None:
        """Stop accepting work and wake blocked takers; queued entries
        remain takeable (graceful drain) unless cancel_all() pops them."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def cancel_all(self) -> list:
        """Pop every queued entry (non-drain shutdown); the caller must
        settle each one explicitly — nothing is silently dropped."""
        with self._cond:
            out = []
            for tenant in list(self._rr):
                dq = self._tenants.pop(tenant)
                out.extend(dq)
                _QUEUE_DEPTH.set(0, tenant=tenant)
            self._rr.clear()
            self._total = 0
            self._cond.notify_all()
            return out
