"""Overload-safe serving front end over the port's verify path.

Port of `bitcoinconsensus_tpu/serving/`. The guards and the in-flight
queue (`resilience/`) make *faults* fail closed; this package makes
*overload* fail closed too. The pieces, bottom up:

- `queue.CoalescingQueue` — per-tenant bounded FIFOs drained
  round-robin into `lane_capacity`-sized device batches (time-or-size
  flush); a full tenant slice rejects at put time.
- `shedding.SloTracker` / `shedding.AdmissionController` — p50/p99 over
  a per-server sliding window of settle latencies drive a
  queueing-estimate admission check over the full backlog (queued +
  in flight); an empty backlog always admits (the probe that lets the
  estimate recover). The controller takes a duck-typed dispatch ladder;
  the port has none, so its servers admit at rung 0.
- `server.VerifyServer` — the context-managed front end: submit() →
  admit-or-`OverloadError`, one worker thread drives bursts through
  `models/batch.verify_batch_stream` (on cuda:0 by default: every batch
  is one checked `verify_tiles` launch carrying the verdict checksum's
  partials), close() drains
  (or explicitly cancels) everything admitted and leaves no unsettled
  ticket. A `DispatchFailed` fails its burst's requests explicitly and
  the worker serves on.
- `client.verify_with_retry` — bounded retries with jittered
  exponential backoff for shed requests.
- `ingress.IngressServer` / `client.IngressClient` — the network edge:
  length-prefixed binary framing over persistent TCP sessions (the
  reference's format, byte for byte), read deadlines reaping slow-loris
  peers, sheds as explicit `ERR_OVERLOADED` frames, protocol errors typed
  and never retried.

The port has no `consensus_chaos.py`: `chip_smoke.py`'s `[serve]` and
`[ingress]` phases are the gates on the card, `obs/stats.py` requires the
`consensus_serving_*` and `consensus_ingress_*` metrics, and README "The
port's serving front end, sigstore and cell" documents the knobs.
"""

from .client import IngressClient, IngressProtocolError, verify_with_retry
from .ingress import IngressServer
from .queue import CoalescingQueue, QueueClosed, TenantQueueFull
from .server import OverloadError, PendingVerify, VerifyServer
from .shedding import (
    SHED_CLOSED,
    SHED_SLO,
    SHED_TENANT_FULL,
    AdmissionController,
    SloTracker,
)

__all__ = [
    "AdmissionController",
    "CoalescingQueue",
    "IngressClient",
    "IngressProtocolError",
    "IngressServer",
    "OverloadError",
    "PendingVerify",
    "QueueClosed",
    "SloTracker",
    "TenantQueueFull",
    "VerifyServer",
    "verify_with_retry",
    "SHED_CLOSED",
    "SHED_SLO",
    "SHED_TENANT_FULL",
]
