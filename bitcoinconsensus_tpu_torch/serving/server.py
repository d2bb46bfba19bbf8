"""Context-managed verification server: admit → coalesce → settle.

Port of `bitcoinconsensus_tpu/serving/server.py`, over the port's
`models/batch.verify_batch_stream`. `VerifyServer()` with no verifier
takes the port's `default_verifier()` (the native engine on cuda:0, which
raises where CUDA is not available); a caller that wants the plain torch
version passes `TorchSecpVerifier(device="cpu")`. Every coalesced batch a
server on the card settles runs `verify_tiles` and the verdict checksum
kernel through the stream's guarded dispatches; nothing here gives way to
the CPU.

`VerifyServer` is the long-running front end of the service: many
small concurrent `submit()` calls coalesce into full `lane_capacity`
device batches (time-or-size flush, per-tenant fair ordering, bounded
per-tenant depth — serving/queue.py), an SLO admission controller sheds
work that could not settle in time (serving/shedding.py), and a single
worker thread drives the coalesced batches through
`models/batch.verify_batch_stream` — the same pipelined driver block
replay uses, so bursts overlap batch N+1's host prep with batch N's
time on the card and every dispatch still settles through the resilience
guards.

Fail-closed overload semantics, mirroring the fault-containment layer:

- a shed request raises `OverloadError` (transport code
  `Error.ERR_OVERLOADED`) at submit time — never a hang, never a
  silent drop; the bounded-retry client (serving/client.py) is the
  recovery path;
- a batch-driver exception fails every request in that burst with the
  exception — explicitly, not by leaving futures unresolved — and the
  worker goes on to the next burst. In the port that is how a dispatch
  fault surfaces: a dispatch whose retries are spent raises
  `DispatchFailed` out of the stream (the reference lands it on its host
  rung instead; the port has no rung below the kernel);
- `close(drain=True)` (the context-manager exit) flushes and settles
  everything already admitted, then joins the worker; in-flight device
  tickets settle through `verify_batch_stream`'s close path, so
  shutdown leaks no device buffers or backpressure slots;
- `close(drain=False)` cancels queued requests with an explicit
  `OverloadError` instead of verifying them.

Env knobs (all optional): ``BITCOINCONSENSUS_TPU_SERVE_MAX_BATCH``
(coalesce target, default = verifier lane_capacity),
``..._SERVE_FLUSH_S`` (time-trigger flush, default 0.005),
``..._SERVE_TENANT_DEPTH`` (per-tenant queue bound, default 1024),
``..._SERVE_SLO_S`` (settle-deadline SLO, default 2.0),
``..._SERVE_SLO_WINDOW`` (latency samples kept for the shed estimate,
default 128), ``..._SERVE_DEPTH`` (stream pipeline depth, default 2).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Optional

from ..api import ConsensusError, Error, _record_reject
from ..models.batch import (
    BatchItem,
    BatchResult,
    verify_batch_stream,
)
from ..obs import counter as _obs_counter
from ..obs import histogram as _obs_histogram
from ..obs import monotonic as _monotonic
from ..obs import span as _span
from ..obs import trace_context as _trace_context
from .queue import CoalescingQueue, QueueClosed, TenantQueueFull
from .shedding import (
    SHED_CLOSED,
    SHED_SLO,
    SHED_TENANT_FULL,
    AdmissionController,
    SloTracker,
)

__all__ = ["OverloadError", "PendingVerify", "VerifyServer"]

_ADMITTED = _obs_counter(
    "consensus_serving_admitted_total",
    "requests admitted into the serving coalescer, by tenant",
    ("tenant",),
)
_SHED = _obs_counter(
    "consensus_serving_shed_total",
    "requests shed with an explicit ERR_OVERLOADED, by reason",
    ("reason",),
)
_QUEUE_WAIT = _obs_histogram(
    "consensus_serving_queue_wait_seconds",
    "time an admitted request spent queued before its batch flushed",
)
_BATCH_FILL = _obs_histogram(
    "consensus_serving_batch_fill",
    "coalesced batch size as a fraction of the flush target",
    buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
)
_BATCHES = _obs_counter(
    "consensus_serving_batches_total",
    "coalesced batches flushed to the verify driver",
)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


class OverloadError(ConsensusError):
    """Explicit fail-closed shed: carries `Error.ERR_OVERLOADED` plus the
    shed reason (`closed` / `tenant_full` / `slo`). The request was never
    partially evaluated — retrying with backoff is always safe."""

    def __init__(self, reason: str):
        super().__init__(Error.ERR_OVERLOADED)
        self.reason = reason


class PendingVerify:
    """Future for one admitted request; resolved by the worker thread."""

    __slots__ = ("item", "tenant", "enqueued", "trace", "submit_span",
                 "_event", "_result", "_error", "_cb_lock", "_callbacks")

    def __init__(self, item: BatchItem, tenant: str, enqueued: float):
        self.item = item
        self.tenant = tenant
        self.enqueued = enqueued
        # Captured at submit: the request's trace id and submit span id.
        # The worker thread re-enters them (obs.trace_context) at settle,
        # so the settle span parents back to the submit span across the
        # thread boundary instead of starting an orphan tree.
        self.trace: Optional[int] = None
        self.submit_span: Optional[int] = None
        self._event = threading.Event()
        self._result: Optional[BatchResult] = None
        self._error: Optional[BaseException] = None
        self._cb_lock = threading.Lock()
        self._callbacks: list = []

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> BatchResult:
        """The settled `BatchResult`; raises the stored exception when the
        request was cancelled or its batch failed, and `TimeoutError`
        when not settled within `timeout` (the caller's hang guard)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"verify request (tenant={self.tenant!r}) not settled "
                f"within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    def add_done_callback(self, fn) -> None:
        """Run `fn(self)` once settled — immediately when already
        settled, else on the settling thread. The network ingress uses
        this to hop responses back onto its event loop instead of
        parking a thread per request. Callback exceptions are contained:
        a broken observer must not fail the worker's settle sweep."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_cb(fn)

    def _run_cb(self, fn) -> None:
        try:
            fn(self)
        except Exception:
            pass

    def _resolve(self, result: BatchResult) -> None:
        self._settle(result, None)

    def _fail(self, exc: BaseException) -> None:
        self._settle(None, exc)

    def _settle(
        self, result: Optional[BatchResult], exc: Optional[BaseException]
    ) -> None:
        # First settlement wins; the check and the flip share the
        # callback lock so a racing add_done_callback either registers
        # before the flip (and is drained here) or observes it set (and
        # self-runs) — never neither.
        with self._cb_lock:
            if self._event.is_set():
                return
            self._result = result
            self._error = exc
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_cb(fn)


class VerifyServer:
    """Overload-safe coalescing front end over `verify_batch_stream`."""

    def __init__(
        self,
        verifier=None,
        sig_cache=None,
        script_cache=None,
        max_batch: Optional[int] = None,
        flush_s: Optional[float] = None,
        tenant_depth: Optional[int] = None,
        slo_deadline_s: Optional[float] = None,
        depth: Optional[int] = None,
        join_timeout_s: float = 60.0,
    ):
        if verifier is None:
            from ..crypto.torch_backend import default_verifier

            verifier = default_verifier()
        self._verifier = verifier
        self._sig_cache = sig_cache
        self._script_cache = script_cache
        self.max_batch = max_batch or _env_int(
            "BITCOINCONSENSUS_TPU_SERVE_MAX_BATCH", verifier.lane_capacity
        )
        self.flush_s = (
            flush_s
            if flush_s is not None
            else _env_float("BITCOINCONSENSUS_TPU_SERVE_FLUSH_S", 0.005)
        )
        self.depth = depth or _env_int("BITCOINCONSENSUS_TPU_SERVE_DEPTH", 2)
        self._join_timeout_s = join_timeout_s
        self._queue = CoalescingQueue(
            tenant_depth
            or _env_int("BITCOINCONSENSUS_TPU_SERVE_TENANT_DEPTH", 1024)
        )
        # Per-server latency window: admission decisions stay isolated
        # from other (possibly slow or defunct) server instances even
        # though all of them feed the shared export histogram.
        self.slo = SloTracker(
            window=_env_int("BITCOINCONSENSUS_TPU_SERVE_SLO_WINDOW", 128)
        )
        self.admission = AdmissionController(
            slo_deadline_s
            or _env_float("BITCOINCONSENSUS_TPU_SERVE_SLO_S", 2.0),
            batch_capacity=self.max_batch,
            slo=self.slo,
            # Duck-typed, as the reference reads it: the port's verifiers
            # have no ladder, so admission reads rung 0.
            ladder=getattr(
                getattr(verifier, "_resilience", None), "ladder", None
            ),
        )
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        self._closed = False
        self._inflight_reqs = 0  # worker-thread-only writes

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "VerifyServer":
        with self._lock:
            if self._closing or self._closed:
                raise RuntimeError("server already closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name="serving-worker", daemon=True
                )
                self._thread.start()
        return self

    def __enter__(self) -> "VerifyServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    def close(self, drain: bool = True) -> None:
        """Stop admitting; settle (drain=True) or explicitly cancel
        (drain=False) everything queued; join the worker. Idempotent,
        including against a concurrently-crashing worker."""
        with self._lock:
            self._closing = True
            already = self._closed
            thread = self._thread
        if already:
            # Second close still backstops: the first may have raced a
            # worker crash, and cancel_all below is itself idempotent.
            thread = None
        if not drain:
            for req in self._queue.cancel_all():
                self._shed_count(SHED_CLOSED)
                req._fail(OverloadError(SHED_CLOSED))
        self._queue.close()
        if thread is not None:
            thread.join(self._join_timeout_s)
            if thread.is_alive():  # never hang shutdown silently
                raise RuntimeError("serving worker failed to drain in time")
        # Backstop drain AFTER the join: if the worker died (batch-driver
        # crash) while a racing submit() was still putting, that request
        # landed in the queue after the worker's own finally-drain swept
        # it — without this sweep it would hang its caller forever.
        for req in self._queue.cancel_all():
            self._shed_count(SHED_CLOSED)
            req._fail(OverloadError(SHED_CLOSED))
        with self._lock:
            self._closed = True

    @property
    def pending(self) -> int:
        """Requests admitted but not yet settled (queued + in flight)."""
        return self._queue.total + self._inflight_reqs

    # -- request path -------------------------------------------------

    def submit(self, item: BatchItem, tenant: str = "default") -> PendingVerify:
        """Admit one request or raise `OverloadError` immediately."""
        if self._closing or self._closed or self._thread is None:
            raise self._shed(SHED_CLOSED)
        # The submit span roots (or joins) this request's trace; its
        # (trace, span_id) ride the PendingVerify across the coalescing
        # queue so the worker-thread settle span stitches back to it.
        # Sheds raise inside the span and are recorded on it as errors.
        with _span("serving.submit", tenant=tenant) as sp:
            # Admission projects wait over the FULL backlog — queued plus
            # the batches already in flight in the stream window; queued
            # count alone would undersell the wait by up to depth * p99.
            reason = self.admission.admit(self.pending)
            if reason is not None:
                raise self._shed(reason)
            req = PendingVerify(item, tenant, _monotonic())
            req.trace = sp.trace
            req.submit_span = sp.span_id
            try:
                self._queue.put(req)
            except TenantQueueFull:
                raise self._shed(SHED_TENANT_FULL) from None
            except QueueClosed:
                raise self._shed(SHED_CLOSED) from None
            _ADMITTED.inc(tenant=tenant)
        return req

    def verify(
        self,
        item: BatchItem,
        tenant: str = "default",
        timeout: Optional[float] = None,
    ) -> BatchResult:
        """Blocking convenience: submit + result."""
        return self.submit(item, tenant).result(timeout)

    def _shed(self, reason: str) -> OverloadError:
        self._shed_count(reason)
        return OverloadError(reason)

    def _shed_count(self, reason: str) -> None:
        _SHED.inc(reason=reason)
        # Unified view with the api/batch reject-reason counters.
        _record_reject(ConsensusError(Error.ERR_OVERLOADED))

    # -- worker -------------------------------------------------------

    def _worker(self) -> None:
        try:
            while True:
                first = self._queue.take(
                    self.max_batch, self.flush_s, block=True
                )
                if first is None:  # closed and drained
                    return
                self._run_burst(first)
        finally:
            # Fail-closed backstop: if the worker dies (or close() raced
            # a final put), no admitted request may be left unresolved —
            # and no new ones admitted into a worker-less queue.
            self._closing = True
            while True:
                rest = self._queue.take(self.max_batch, 0.0, block=False)
                if not rest:
                    return
                for req in rest:
                    self._shed_count(SHED_CLOSED)
                    req._fail(OverloadError(SHED_CLOSED))

    def _run_burst(self, first: list) -> None:
        """Drive one traffic burst through the pipelined stream driver.

        The generator hands the worker's coalesced batches to
        `verify_batch_stream`; within a burst, batch N+1's host prep
        overlaps batch N's wire time. The burst ends when the queue goes
        idle (take(block=False) -> None), which also makes the stream
        drain its window — a lone batch never waits for successor
        traffic to settle.
        """
        inflight: deque = deque()
        # In-flight from the moment of the queue pop (here and after
        # every take below), so `pending` never transiently undercounts
        # a popped-but-not-yet-streamed batch.
        self._inflight_reqs += len(first)
        # The popped-but-not-yet-streamed batch: batches() consumes it on
        # first pull; if the driver crashes before pulling anything, the
        # except arm below still owns these requests and fails them.
        unconsumed = [first]

        def batches():
            reqs = unconsumed.pop() if unconsumed else None
            while reqs is not None:
                inflight.append((reqs, self._note_flush(reqs)))
                yield [r.item for r in reqs]
                reqs = self._queue.take(
                    self.max_batch, self.flush_s, block=False
                )
                if reqs is not None:
                    self._inflight_reqs += len(reqs)

        current: Optional[list] = None
        # The burst leader's trace contexts the driver's own spans (and
        # the dispatch tickets' timelines) on this worker thread; each
        # request additionally gets a settle span inside its OWN trace,
        # parented to its submit span — the cross-thread stitch.
        leader = first[0]
        try:
            with _trace_context(leader.trace, leader.submit_span):
                for out in verify_batch_stream(
                    batches(),
                    self._verifier,
                    self._sig_cache,
                    self._script_cache,
                    depth=self.depth,
                ):
                    current, flushed = inflight.popleft()
                    self.slo.observe(_monotonic() - flushed)
                    for req, res in zip(current, out, strict=True):
                        self._settle_one(req, res)
                    self._inflight_reqs -= len(current)
                    current = None
        except BaseException as exc:
            # Explicit failure, never a hang: the popped batch (partially
            # resolved at most) and every batch still windowed.
            if current is not None:
                for req in current:
                    req._fail(exc)
                self._inflight_reqs -= len(current)
            while inflight:
                reqs, _ = inflight.popleft()
                for req in reqs:
                    req._fail(exc)
                self._inflight_reqs -= len(reqs)
            if unconsumed:  # driver died before streaming the first batch
                reqs = unconsumed.pop()
                for req in reqs:
                    req._fail(exc)
                self._inflight_reqs -= len(reqs)

    def _settle_one(self, req: PendingVerify, res) -> None:
        """Resolve one request under its own trace: the settle span
        parents to the request's submit span (captured on the submitting
        thread), so JSONL trees survive the worker-thread hop."""
        with _trace_context(req.trace, req.submit_span):
            with _span("serving.settle", tenant=req.tenant):
                req._resolve(res)

    def _note_flush(self, reqs: list) -> float:
        now = _monotonic()
        for req in reqs:
            _QUEUE_WAIT.observe(now - req.enqueued)
        _BATCH_FILL.observe(len(reqs) / self.max_batch)
        _BATCHES.inc()
        return now
