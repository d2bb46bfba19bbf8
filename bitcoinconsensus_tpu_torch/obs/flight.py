"""Black-box flight recorder: bounded ring buffer + dump-on-conviction.

The port of `bitcoinconsensus_tpu/obs/flight.py`. When the guards convict
something (a verdict buffer rejected, a checksum mismatch, a ticket's
deadline spent) the evidence is what happened just before. This module
keeps it: a bounded, thread-safe ring of recent events (guard anomalies,
fault injections, span completions, anything a hook site `record()`s),
plus the metric registry's delta since arming. On a trigger (a checksum
mismatch, or an explicit call) the ring is dumped, redacted and
provenance-stamped, to a ``flight_dump_<reason>_*.json``.

Disarmed by default: the fast path of `record()` is one module-global read
until armed by ``BITCOINCONSENSUS_TPU_FLIGHT=1`` or `set_enabled()`. The
span subscription attaches a sink only while armed.

Redaction: consensus inputs (scripts, signatures, pubkeys, message bytes)
never belong in a dump. Any event field whose key looks sensitive is
replaced by ``<redacted:N>`` recursively before serialization.

Dumps are count-capped per process (`MAX_DUMPS`), not rate-limited. They
go to the directory the caller names, else BITCOINCONSENSUS_TPU_FLIGHT_DIR,
else `build/flight/` in the checkout (a directory `.gitignore` lists).
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from .metrics import counter, gauge, get_registry
from . import exposition as _exposition
from . import perf as _perf
from . import spans as _spans

__all__ = [
    "CAPACITY",
    "MAX_DUMPS",
    "enabled",
    "events",
    "record",
    "reset",
    "set_enabled",
    "trigger",
]

SCHEMA = "consensus-flight-v1"

# Ring capacity: large enough to hold the span and decision window around
# a conviction, small enough to bound memory and dump size.
CAPACITY = 512

# Dumps written per process before the recorder goes quiet (count cap,
# not a rate limit — see module docstring).
MAX_DUMPS = 16

_EVENTS = counter(
    "consensus_flight_events_total",
    "events accepted by the flight ring while armed, by kind",
    ("kind",),
)
_DUMPS = counter(
    "consensus_flight_dumps_total",
    "flight dumps written, by trigger reason",
    ("trigger",),
)
_ARMED_GAUGE = gauge(
    "consensus_flight_armed",
    "1 while the flight recorder is armed, else 0",
)
_ARMED_GAUGE.set(0)

# Event-field keys whose values are redacted from dumps. Substring
# match, case-insensitive: "pubkey_x", "script_sig", "msg32" all hit.
REDACT_KEYS = (
    "payload", "data", "sig", "pubkey", "pub_key", "msg", "message",
    "raw", "script", "secret", "privkey", "key_bytes", "witness",
)

_lock = threading.Lock()
_armed = os.environ.get("BITCOINCONSENSUS_TPU_FLIGHT", "0") not in (
    "0", "", "false", "no")
_ring: deque = deque(maxlen=CAPACITY)
_appended = 0  # lifetime accepted count; - len(ring) = evicted
_dumps_written = 0
_dump_seq = 0
_armed_snapshot: Optional[dict] = None
_span_sink = None


class _FlightSpanSink:
    """Span sink feeding completed spans into the ring (attached only
    while armed; `spans.add_sink` errors are already counted there)."""

    def write(self, rec: dict) -> None:
        record("span", **rec)


def enabled() -> bool:
    return _armed


def set_enabled(flag: bool) -> None:
    """Arm or disarm the recorder (idempotent).

    Arming snapshots the metric registry (dumps carry the delta since
    arming) and subscribes the span sink; disarming detaches the sink so
    the span path returns to its unobserved cost.
    """
    global _armed, _armed_snapshot, _span_sink
    with _lock:
        if flag and not _armed:
            _armed_snapshot = get_registry().snapshot()
            _span_sink = _FlightSpanSink()
            _spans.add_sink(_span_sink)
            _armed = True
            _ARMED_GAUGE.set(1)
        elif not flag and _armed:
            _armed = False
            if _span_sink is not None:
                _spans.remove_sink(_span_sink)
                _span_sink = None
            _ARMED_GAUGE.set(0)


def reset() -> None:
    """Clear ring + dump counters (test isolation helper)."""
    global _appended, _dumps_written, _dump_seq, _armed_snapshot
    with _lock:
        _ring.clear()
        _appended = 0
        _dumps_written = 0
        _dump_seq = 0
        if _armed:
            _armed_snapshot = get_registry().snapshot()


def record(kind: str, **fields) -> None:
    """Append one event to the ring. Disarmed cost: one global read."""
    if not _armed:
        return
    global _appended
    ev = {"t": _spans.monotonic(), "kind": kind}
    ev.update(fields)
    with _lock:
        _ring.append(ev)
        _appended += 1
    _EVENTS.inc(kind=kind)


def events() -> List[dict]:
    """Current ring contents, oldest first (copy)."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """Events evicted from the ring since arming/reset."""
    with _lock:
        return max(0, _appended - len(_ring))


def _redact(value: Any, key: str = "") -> Any:
    low = key.lower()
    if any(tok in low for tok in REDACT_KEYS):
        try:
            size = len(value)  # type: ignore[arg-type]
        except TypeError:
            size = 0
        return f"<redacted:{size}>"
    if isinstance(value, dict):
        return {k: _redact(v, str(k)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_redact(v) for v in value]
    if isinstance(value, (bytes, bytearray)):
        return f"<bytes:{len(value)}>"
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)


def _dump_dir() -> str:
    env = os.environ.get("BITCOINCONSENSUS_TPU_FLIGHT_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "build", "flight")


def trigger(reason: str, out_dir: Optional[str] = None,
            **attrs) -> Optional[str]:
    """Dump the flight ring; returns the written path (None when
    disarmed or the per-process dump cap is exhausted).

    The dump holds: the trigger reason + attrs (redacted), the full
    event window oldest-first, the count of ring-evicted events, the
    metric deltas since arming, and a provenance stamp — everything a
    post-mortem needs without re-running the workload.
    """
    global _dumps_written, _dump_seq
    if not _armed:
        return None
    with _lock:
        if _dumps_written >= MAX_DUMPS:
            return None
        _dumps_written += 1
        _dump_seq += 1
        seq = _dump_seq
        window = list(_ring)
        evicted = max(0, _appended - len(_ring))
        base_snap = _armed_snapshot or {}
    deltas = _exposition.diff_snapshots(base_snap, get_registry().snapshot())
    doc = {
        "schema": SCHEMA,
        "trigger": reason,
        "attrs": _redact(dict(attrs)),
        "provenance": _perf.provenance(),
        "events": [_redact(ev) for ev in window],
        "events_dropped": evicted,
        "metric_deltas": deltas,
    }
    out_dir = out_dir or _dump_dir()
    path = os.path.join(
        out_dir, f"flight_dump_{reason}_{os.getpid()}_{seq:03d}.json")
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, default=repr)
            fh.write("\n")
    except OSError:
        return None
    _DUMPS.inc(trigger=reason)
    return path
