"""Nestable tracing spans over the port's host path.

The port's copy of `bitcoinconsensus_tpu/obs/spans.py`. A span is a context
manager timing one named region with monotonic timestamps
(`time.perf_counter`). Spans nest per thread; each records its parent, so a
JSONL sink reconstructs the call tree of a verify:

    block.connect
      block.script_keys
      batch.interpret
      batch.resolve
        verifier.host_prep
        verifier.dispatch
        verifier.sync
      block.results

Every span aggregates into the process-global metrics registry:
`consensus_span_duration_seconds{span=...}` (histogram; its `_count` is the
call count) and `consensus_span_errors_total{span=...}` when the body
raised. With no sink attached that aggregation is the only exit-path work,
so instrumentation stays on by default. Attach a `JsonlSink` (or anything
with a `write(record: dict)` method) to stream one JSON line per span.

Traces cross threads explicitly: every span carries a `trace` id (the root
span's id, inherited down the per-thread stack), and
`trace_context(trace, parent_span_id)` adopts a trace begun elsewhere.

What the port adds: `set_annotator(fn)`. While a device capture runs
(`obs/xprof.trace_session`) every span also enters `fn(name)`, a
`torch.profiler.record_function`, so the capture's host track carries the
span tree on the profiler's own clock and an idle gap of the device can be
labelled with the span that was open over it. With no capture the cost is
one module-global read.

This module (with `utils/profiling.py`, which times through it) is the one
sanctioned clock reader of the port: the host lint
(`analysis/host_lint.py`) rejects direct `time.perf_counter()` timing in
`core/`, `models/`, `crypto/` and `resilience/`. Nothing here runs on the
device, and it imports no torch.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import IO, Optional, Tuple, Union

from .metrics import counter, histogram

__all__ = [
    "Span",
    "JsonlSink",
    "add_sink",
    "current_span_id",
    "current_trace",
    "monotonic",
    "remove_sink",
    "set_annotator",
    "span",
    "trace_context",
]

_SPAN_SECONDS = histogram(
    "consensus_span_duration_seconds",
    "wall-clock duration of pipeline spans (see README span taxonomy)",
    ("span",),
)
_SPAN_ERRORS = counter(
    "consensus_span_errors_total",
    "spans whose body raised",
    ("span",),
)
_SINK_ERRORS = counter(
    "consensus_obs_sink_errors_total",
    "span records dropped because a sink's write() raised",
    ("sink",),
)


def monotonic() -> float:
    """Sanctioned monotonic clock for host-side policy code: the in-flight
    queue's deadlines and retry budgets (`resilience/`) read it here, since
    the clock rule bans direct `time.*` reads there; consensus code
    (`core/`, `models/`) still may not read a clock at all."""
    return time.perf_counter()

_ids = itertools.count(1)  # next() is atomic under the GIL
_tls = threading.local()

# Sinks are kept in an immutable tuple swapped under a lock: the span exit
# fast path reads one module global, no lock.
_sinks: Tuple[object, ...] = ()
_sinks_lock = threading.Lock()

# While a device capture runs: a callable returning a context manager per
# span name (torch.profiler.record_function); None otherwise.
_annotator = None


def set_annotator(fn) -> None:
    """Enter `fn(name)` around every span from now on (None: stop).
    `obs/xprof.trace_session` sets it for the length of a capture."""
    global _annotator
    _annotator = fn


class Span:
    """One timed region. `duration_s` is set when the region exits."""

    __slots__ = ("name", "span_id", "parent_id", "trace", "t0", "duration_s",
                 "attrs", "error")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 attrs: Optional[dict], trace: Optional[int] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        # Root spans define their own trace; children inherit it, and
        # trace_context() lets another thread adopt it.
        self.trace = span_id if trace is None else trace
        self.t0 = 0.0
        self.duration_s: Optional[float] = None
        self.attrs = attrs
        self.error: Optional[str] = None


class _TraceMarker:
    """Stack entry standing in for a parent span that lives on another
    thread: carries only the identity a child needs (parent id + trace).
    Never timed, never written to sinks."""

    __slots__ = ("span_id", "trace")

    def __init__(self, span_id: Optional[int], trace: Optional[int]):
        self.span_id = span_id
        self.trace = trace


class JsonlSink:
    """Append-mode JSON-lines span sink (one dict per line), thread-safe.

    Flush behavior is bounded: at most `flush_every` records are ever
    buffered (perf workloads stream tens of thousands of spans; an
    unbounded libc buffer loses an arbitrary tail on a crash). `close()`
    is idempotent; a `write()` after close raises — the span exit path
    counts it in `consensus_obs_sink_errors_total` instead of crashing
    the verify, so a sink removed late shows up in triage, not as data
    silently appended to a dead handle.
    """

    def __init__(self, path_or_file: Union[str, IO[str]],
                 flush_every: int = 512):
        if isinstance(path_or_file, str):
            self._fh = open(path_or_file, "a", encoding="utf-8")
            self._owns = True
        else:
            self._fh = path_or_file
            self._owns = False
        self._flush_every = max(1, int(flush_every))
        self._unflushed = 0
        self._closed = False
        self._lock = threading.Lock()

    def write(self, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":"), sort_keys=True)
        with self._lock:
            if self._closed:
                raise ValueError("write() on a closed JsonlSink")
            self._fh.write(line + "\n")
            self._unflushed += 1
            if self._unflushed >= self._flush_every:
                self._fh.flush()
                self._unflushed = 0

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._fh.flush()
                self._unflushed = 0

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._fh.flush()
            if self._owns:
                self._fh.close()


def add_sink(sink) -> None:
    """Attach a span sink (any object with `write(record: dict)`)."""
    global _sinks
    with _sinks_lock:
        _sinks = _sinks + (sink,)


def remove_sink(sink) -> None:
    global _sinks
    with _sinks_lock:
        _sinks = tuple(s for s in _sinks if s is not sink)


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_trace() -> Optional[int]:
    """Trace id of the innermost open span (or adopted context) on this
    thread; None outside any span. Hand this (plus the span id) to work
    you queue onto another thread, and re-enter it there with
    `trace_context` so the settle side stitches back to the submit side."""
    st = getattr(_tls, "stack", None)
    return st[-1].trace if st else None


def current_span_id() -> Optional[int]:
    """Span id of the innermost open span on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1].span_id if st else None


@contextmanager
def trace_context(trace: Optional[int], parent_span_id: Optional[int] = None):
    """Adopt a trace begun on another thread.

    Spans opened inside the context inherit `trace` and (for top-level
    ones) parent to `parent_span_id` — the cross-thread stitch: capture
    `(span.trace, span.span_id)` where the request is submitted, then
    wrap the worker-side settle in `trace_context(trace, span_id)`.
    Nests freely with real spans and other contexts; the innermost wins.
    No timing, no sink record — identity only.
    """
    stack = _stack()
    marker = _TraceMarker(parent_span_id, trace)
    stack.append(marker)
    try:
        yield
    finally:
        stack.pop()


@contextmanager
def span(name: str, **attrs):
    """Time a region as `name`; nest freely; yields the live Span.

    Exceptions propagate untouched (recorded as `error` on the span and in
    `consensus_span_errors_total`). Extra keyword attrs ride along into
    sink records only — they never become metric labels, so attr
    cardinality cannot pollute the registry.
    """
    stack = _stack()
    parent = stack[-1] if stack else None
    sp = Span(
        name,
        next(_ids),
        parent.span_id if parent is not None else None,
        attrs or None,
        trace=parent.trace if parent is not None else None,
    )
    stack.append(sp)
    ann = _annotator
    ann_cm = ann(name) if ann is not None else None
    if ann_cm is not None:
        ann_cm.__enter__()
    sp.t0 = time.perf_counter()
    try:
        yield sp
    except BaseException as e:
        sp.error = type(e).__name__
        raise
    finally:
        dt = time.perf_counter() - sp.t0
        if ann_cm is not None:
            ann_cm.__exit__(None, None, None)
        sp.duration_s = dt
        stack.pop()
        _SPAN_SECONDS.observe(dt, span=name)
        if sp.error is not None:
            _SPAN_ERRORS.inc(span=name)
        sinks = _sinks
        if sinks:
            record = {
                "name": name,
                "span_id": sp.span_id,
                "parent_id": sp.parent_id,
                "trace": sp.trace,
                "thread": threading.get_ident(),
                "pid": os.getpid(),
                "t0": round(sp.t0, 9),
                "dur_s": round(dt, 9),
            }
            if sp.attrs:
                record["attrs"] = sp.attrs
            if sp.error is not None:
                record["error"] = sp.error
            for s in sinks:
                try:
                    s.write(record)
                except Exception:
                    # A broken sink must never take down a verify, nor
                    # vanish without trace: every dropped record is counted.
                    _SINK_ERRORS.inc(sink=type(s).__name__)
