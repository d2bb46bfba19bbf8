"""Telemetry of the port: metrics registry, span tracing, exposition, the
flight recorder and the device-truth observatory.

The port of `bitcoinconsensus_tpu/obs/`, importing torch (lazily) and never
jax. Its pieces:

- ``metrics``: a process-global, thread-safe registry of counters, gauges
  and fixed-bucket histograms, all label-aware. Every layer of the port
  registers its metrics at import; `snapshot()` is a plain dict.
- ``spans``: nestable context-manager spans with monotonic timestamps,
  aggregated into `consensus_span_duration_seconds{span=...}`; a JSONL sink
  streams one record per span.
- ``exposition``: Prometheus text and JSON renderings of a snapshot,
  validation and diffs (byte-identical to the reference's on the same
  snapshot).
- ``perf``: the `PhaseTimeline` riding every in-flight ticket
  (`consensus_pipeline_phase_seconds{phase=...}` and the overlap gauge),
  `provenance()` with torch, CUDA, device and power-limit fields, and the
  report comparison.
- ``xprof``: a `torch.profiler` capture that charges the card's kernel time
  to the regions of `ops/regions.py`, and reads the device's busy share and
  its longest idle gaps, each labelled with the host span open over it.
- ``flight``: the black-box flight recorder, a bounded ring of recent guard
  and fault events and spans, dumped redacted and provenance-stamped on a
  checksum mismatch or an explicit trigger. Disarmed by default.
- ``stats``: the stats gate, ``python -m bitcoinconsensus_tpu_torch.obs.stats
  --check``: a small seeded workload through every ported layer, and the
  metrics each layer must light up.

Instrumentation is host-side only: no kernel reads anything of it, and
kernels run unchanged with telemetry on. `obs/spans.py` (and
`utils/profiling.py` through it) is the one sanctioned clock reader: the
host lint rejects direct `time.perf_counter()` timing in `core/`,
`models/`, `crypto/` and `resilience/`.

Left out of the reference's `perf`, with no torch counterpart: the jaxpr op
walk and XLA's cost analysis (`walk_jaxpr`, `while_trips`, `cost_analysis`,
`register_kernel`, `kernel_report`). Metric catalogue and span taxonomy:
README "Observability of the port".
"""

from .metrics import (
    MetricsRegistry,
    counter,
    gauge,
    get_registry,
    histogram,
)
from .spans import (
    JsonlSink,
    Span,
    add_sink,
    current_span_id,
    current_trace,
    monotonic,
    remove_sink,
    span,
    trace_context,
)
from . import flight
from . import perf
from . import xprof

__all__ = [
    "JsonlSink",
    "flight",
    "xprof",
    "MetricsRegistry",
    "Span",
    "add_sink",
    "counter",
    "current_span_id",
    "current_trace",
    "gauge",
    "get_registry",
    "histogram",
    "monotonic",
    "perf",
    "remove_sink",
    "span",
    "trace_context",
]
