"""Performance observatory: ticket phase timelines, overlap efficiency,
provenance-stamped reports and their comparison.

The port of the parts of `bitcoinconsensus_tpu/obs/perf.py` that have a
torch meaning:

- **PhaseTimeline** rides every in-flight ticket (`resilience/inflight.py`).
  Monotonic stamps (through the sanctioned `obs` clock) at submit /
  prepare / launch / first poll / settle start / settle end. Finalizing a
  timeline feeds `consensus_pipeline_phase_seconds{phase=...}` and the
  `consensus_pipeline_overlap_efficiency` gauge: the share of a ticket's
  wire time (launch to settled) in which the host was not waiting.
  `BITCOINCONSENSUS_TPU_PERF_TIMELINE=0` (or `set_enabled(False)`) hands
  every ticket one shared no-op instance.
- **Provenance and reports**: `provenance()` stamps every report with the
  torch and CUDA versions, the platform (`cuda` or `cpu`), the device kind
  and count, the card's power limit, python, the git revision and the
  command; `comparable()` decides whether two reports may be compared at
  all, and `compare_reports()` is the regression gate over them.
- `timed_best`: the best and median of synchronised calls.
- `telemetry_cost`: the always-on telemetry of one call, counted event by
  event and priced per primitive, as the reference's overhead test counts
  it (what the test and chip_smoke's `[obs]` gate hold under 1%).

Left out, with no torch counterpart: the reference's jaxpr op walk
(`walk_jaxpr`, `while_trips`, `ARITH`/`MOVE`), XLA's
`Compiled.cost_analysis` and the kernel registry behind its roofline report
(`register_kernel`, `kernel_report`). A kernel's bound is computed by
`chip_smoke.py` from the run's inputs (`_bound`, with the H100's rates).

Nothing here runs on the device; torch is imported lazily.
"""

from __future__ import annotations

import os
import platform as _platform
import subprocess
import sys
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .metrics import gauge, get_registry, histogram
from .spans import monotonic

__all__ = [
    "NULL_TIMELINE",
    "PhaseTimeline",
    "compare_reports",
    "comparable",
    "new_timeline",
    "overlap_efficiency",
    "phase_report",
    "provenance",
    "reset_overlap_window",
    "set_enabled",
    "span_self_seconds",
    "telemetry_cost",
    "timed_best",
    "timeline_enabled",
]

_PHASE_SECONDS = histogram(
    "consensus_pipeline_phase_seconds",
    "per-ticket pipeline phase durations (README: Performance "
    "observatory phase taxonomy)",
    ("phase",),
)
_OVERLAP = gauge(
    "consensus_pipeline_overlap_efficiency",
    "fraction of recent tickets' wire time hidden by host-side work "
    "(1.0 = the link wait is fully overlapped, 0.0 = fully exposed)",
)

# (histogram phase label, start stamp, end stamp). "inflight" is the
# overlap window: the host came back to poll the ticket only after this
# long, time the device spent working while the host did something else.
_PHASE_EDGES: Tuple[Tuple[str, str, str], ...] = (
    ("prepare", "submit", "prepare"),
    ("launch", "prepare", "launch"),
    ("inflight", "launch", "first_poll"),
    ("settle", "settle_start", "settle_end"),
    ("total", "submit", "settle_end"),
)

# Overlap gauge window: recent (hidden, wire) second pairs; the gauge is
# sum(hidden)/sum(wire), so long tickets weigh proportionally.
_OVERLAP_WINDOW = 256
_overlap_lock = threading.Lock()
_overlap_win: deque = deque(maxlen=_OVERLAP_WINDOW)

_enabled = os.environ.get(
    "BITCOINCONSENSUS_TPU_PERF_TIMELINE", ""
) not in ("0", "off")


def set_enabled(flag: bool) -> None:
    """Arm/disarm phase timelines process-wide (the A/B overhead knob).
    Tickets already carrying a live timeline finish it; new dispatches get
    the shared no-op instance while disarmed."""
    global _enabled
    _enabled = bool(flag)


def timeline_enabled() -> bool:
    return _enabled


def reset_overlap_window() -> None:
    """Drop accumulated overlap samples (test isolation; the registry's
    `reset()` does not reach this module-level window)."""
    with _overlap_lock:
        _overlap_win.clear()


def _note_overlap(hidden: float, wire: float) -> None:
    with _overlap_lock:
        _overlap_win.append((hidden, wire))
        h = sum(x for x, _ in _overlap_win)
        w = sum(y for _, y in _overlap_win)
    if w > 0.0:
        _OVERLAP.set(h / w)


class PhaseTimeline:
    """Monotonic stamp sheet for one in-flight dispatch ticket.

    The queue stamps the lifecycle edges; `finalize()` (idempotent, at
    settle) turns them into phase histogram observations and one overlap
    sample. `trace` carries the submitting span's trace id."""

    __slots__ = ("stamps", "shards", "trace", "_done")

    def __init__(self, trace: Optional[int] = None):
        self.stamps: Dict[str, float] = {}
        self.shards: List[Tuple[int, float]] = []
        self.trace = trace
        self._done = False

    def stamp(self, name: str) -> None:
        """Record `name` at now; re-stamping overwrites (a relaunch after a
        retry moves the launch edge: the settled attempt is attributed)."""
        self.stamps[name] = monotonic()

    def stamp_once(self, name: str) -> None:
        """Record `name` only if unseen (first_poll survives re-settles)."""
        if name not in self.stamps:
            self.stamps[name] = monotonic()

    def stamp_shard(self, idx: int) -> None:
        """Record completion of shard `idx`'s settle-side check."""
        self.shards.append((idx, monotonic()))

    def phase_seconds(self) -> Dict[str, float]:
        """Derived per-phase durations (only edges with both stamps)."""
        t = self.stamps
        out: Dict[str, float] = {}
        for phase, a, b in _PHASE_EDGES:
            if a in t and b in t and t[b] >= t[a]:
                out[phase] = t[b] - t[a]
        return out

    def finalize(self) -> None:
        """Feed the registry once: phase histograms, per-shard check
        durations and the overlap-efficiency sample."""
        if self._done:
            return
        self._done = True
        for phase, dt in self.phase_seconds().items():
            _PHASE_SECONDS.observe(dt, phase=phase)
        t = self.stamps
        start = t.get("settle_start")
        if self.shards and start is not None:
            prev = start
            for _idx, ts in self.shards:
                if ts >= prev:
                    _PHASE_SECONDS.observe(ts - prev, phase="shard_check")
                prev = ts
        launch = t.get("launch")
        poll = t.get("first_poll")
        end = t.get("settle_end")
        if launch is not None and poll is not None and end is not None:
            wire = end - launch
            if wire > 0.0:
                _note_overlap(min(max(poll - launch, 0.0), wire), wire)


class _NullTimeline:
    """Shared disarmed timeline: every hook a no-op, no allocation."""

    __slots__ = ()
    trace = None

    def stamp(self, name: str) -> None:
        pass

    def stamp_once(self, name: str) -> None:
        pass

    def stamp_shard(self, idx: int) -> None:
        pass

    def phase_seconds(self) -> Dict[str, float]:
        return {}

    def finalize(self) -> None:
        pass


NULL_TIMELINE = _NullTimeline()


def new_timeline(trace: Optional[int] = None):
    """A live PhaseTimeline, or the shared no-op when disarmed."""
    if not _enabled:
        return NULL_TIMELINE
    return PhaseTimeline(trace)


# ---------------------------------------------------------------------------
# Registry readbacks (report side).


def phase_report() -> Dict[str, dict]:
    """Per-phase {count, mean_s, total_s} from the pipeline histograms."""
    h = get_registry().get("consensus_pipeline_phase_seconds")
    out: Dict[str, dict] = {}
    if h is None:
        return out
    for s in h._samples():
        if s["count"]:
            out[s["labels"]["phase"]] = {
                "count": s["count"],
                "mean_s": s["sum"] / s["count"],
                "total_s": s["sum"],
            }
    return out


def overlap_efficiency() -> Optional[float]:
    """Current overlap-efficiency gauge value, or None before any settled
    ticket fed the window."""
    g = get_registry().get("consensus_pipeline_overlap_efficiency")
    if g is None or not g._samples():
        return None
    return float(g.value())


def span_self_seconds(records, root: Optional[str] = None) -> Dict[str, float]:
    """Self time by span name (a span's seconds less its children's) over
    span records (the dicts a sink receives); with `root`, only the trees
    under spans of that name, the root's own self time included. The self
    times of a tree add up to its root's duration, so a split of a call
    by them has no remainder: what no child span covers is the root's own
    self time."""
    by_id = {r["span_id"]: r for r in records}
    kids: Dict[int, List[dict]] = {}
    for r in records:
        if r.get("parent_id") in by_id:
            kids.setdefault(r["parent_id"], []).append(r)
    if root is None:
        tops = [r for r in records if r.get("parent_id") not in by_id]
    else:
        tops = [r for r in records if r["name"] == root]
    out: Dict[str, float] = {}
    stack = list(tops)
    while stack:
        r = stack.pop()
        ch = kids.get(r["span_id"], [])
        own = r["dur_s"] - sum(c["dur_s"] for c in ch)
        out[r["name"]] = out.get(r["name"], 0.0) + own
        stack.extend(ch)
    return out


def _block(x) -> None:
    """Wait for the device when `x` is or holds a CUDA tensor (report side
    only; the dispatch path settles through `resilience/inflight`)."""
    import torch

    leaves = x if isinstance(x, (tuple, list)) else (x,)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)


def timed_best(fn: Callable[[], Any], reps: int = 5):
    """(best_s, median_s, walls) over `reps` calls of `fn`, each followed
    by a synchronise of the card when one is present."""
    import torch

    cuda = torch.cuda.is_available()
    walls = []
    for _ in range(max(1, int(reps))):
        t0 = monotonic()
        out = fn()
        _block(out)
        if cuda:
            torch.cuda.synchronize()
        walls.append(monotonic() - t0)
    return min(walls), sorted(walls)[len(walls) // 2], walls


# ---------------------------------------------------------------------------
# Provenance + the regression gate.

# Provenance keys that must MATCH for two reports to be compared at all.
# The git revision and versions are recorded but not part of the key: the
# gate compares across revisions on the same hardware.
COMPARABLE_KEYS = ("platform", "device_kind")


def telemetry_cost(fn: Callable[[], Any]) -> Tuple[Dict[str, int], float]:
    """Run `fn` once and price the telemetry it makes with no sink attached,
    as the reference's `tests/test_obs.py::
    test_no_sink_overhead_under_one_percent` prices it: every counter and
    gauge update, histogram observation, span and region range, counted by
    wrapping the primitives for the call, times that primitive's cost timed
    here. Returns (events by kind, estimated seconds). Not thread-safe:
    nothing else may run meanwhile."""
    from . import metrics as M
    from . import spans as S
    from ..crypto import torch_backend as TB
    from ..ops import regions as R
    from ..resilience import inflight as IQ

    events = dict.fromkeys(("counter", "gauge", "hist", "region"), 0)
    saved = []

    def wrap(owner, attr, kind):
        real = getattr(owner, attr)

        def counted(*a, **kw):
            events[kind] += 1
            return real(*a, **kw)

        saved.append((owner, attr, vars(owner).get(attr)))
        setattr(owner, attr, counted)

    # The modules that open region ranges bind `region_scope` at import.
    for owner, attr, kind in (
            (M.Counter, "inc", "counter"), (M._BoundCounter, "inc", "counter"),
            (M.Gauge, "set", "gauge"), (M.Gauge, "add", "gauge"),
            (M._BoundGauge, "set", "gauge"), (M._BoundGauge, "add", "gauge"),
            (M.Histogram, "_observe", "hist"),
            (TB, "region_scope", "region"), (IQ, "region_scope", "region")):
        wrap(owner, attr, kind)
    s0 = next(S._ids)
    try:
        fn()
    finally:
        for owner, attr, old in reversed(saved):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
    events["span"] = next(S._ids) - s0 - 1

    reg = M.MetricsRegistry()
    c = reg.counter("ovh_total", "", ("k",)).labels(k="x")
    h = reg.histogram("ovh_hist")
    g = reg.gauge("ovh_gauge")

    def per(op, n=20_000):
        t0 = monotonic()
        for _ in range(n):
            op()
        return (monotonic() - t0) / n

    def span_once():
        with S.span("ovh-span"):
            pass

    def region_once():
        with R.region_scope("ovh"):
            pass

    cost = {"counter": per(c.inc), "hist": per(lambda: h.observe(0.1)),
            "gauge": per(lambda: g.set(1.0)), "region": per(region_once, 2_000)}
    # A span's own histogram observation is counted under `hist`.
    cost["span"] = max(per(span_once) - cost["hist"], 0.0)
    return events, sum(events[k] * cost[k] for k in events)


def _git_rev() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=5,
        )
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else "unknown"
    except Exception:
        return "unknown"


def _power_limit() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (the first card), or
    "unavailable"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return "unavailable"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unavailable"


def provenance(cmd: Optional[str] = None) -> dict:
    """Where a number came from: torch and CUDA versions, the platform
    (`cuda` or `cpu`), the device kind and count, the card's power limit,
    python, the git revision and the producing command."""
    doc = {
        "platform": "unavailable",
        "device_kind": "unavailable",
        "device_count": 0,
        "torch": "unavailable",
        "cuda": None,
        "power_limit": "unavailable",
        "python": sys.version.split()[0],
        "git_rev": _git_rev(),
        "cmd": " ".join(sys.argv) if cmd is None else cmd,
    }
    try:
        import torch

        doc["torch"] = torch.__version__
        doc["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            doc["platform"] = "cuda"
            doc["device_kind"] = torch.cuda.get_device_name(0)
            doc["device_count"] = torch.cuda.device_count()
            doc["power_limit"] = _power_limit()
        else:
            # A bare "cpu" would make every CPU box "comparable"; qualify it
            # by machine and cores so the gate bites on matched hardware only.
            doc["platform"] = "cpu"
            doc["device_kind"] = (
                f"cpu/{_platform.machine()}-{os.cpu_count() or 0}c")
            doc["device_count"] = 1
    except Exception:
        pass
    return doc


def comparable(a: dict, b: dict) -> Tuple[bool, str]:
    """Whether two provenance blocks describe comparable hardware; the
    reason string names the first mismatched key when not."""
    for k in COMPARABLE_KEYS:
        if a.get(k) != b.get(k):
            return False, f"{k}: {a.get(k)!r} vs {b.get(k)!r}"
    return True, ""


def compare_reports(
    baseline: dict,
    report: dict,
    tolerance: float = 0.5,
    abs_floor_s: float = 1e-3,
) -> Optional[List[str]]:
    """Regression-gate a perf report against a baseline.

    Returns None when the two are not comparable (provenance mismatch: a
    CPU run never fails a card's baseline), else the list of regressions
    (empty = pass). A phase regresses when its mean grew both by more than
    `tolerance` (relative) and by more than `abs_floor_s` (absolute).
    Throughput regresses on relative drop alone.
    """
    ok, _why = comparable(
        baseline.get("provenance", {}), report.get("provenance", {})
    )
    if not ok:
        return None
    problems: List[str] = []
    old_tp = (baseline.get("workload") or {}).get("verifies_per_sec")
    new_tp = (report.get("workload") or {}).get("verifies_per_sec")
    if old_tp and new_tp and new_tp < old_tp * (1.0 - tolerance):
        problems.append(
            f"throughput regression: {new_tp:.1f} verifies/s vs baseline "
            f"{old_tp:.1f} (tolerance {tolerance:.0%})"
        )
    old_ph = baseline.get("phases") or {}
    new_ph = report.get("phases") or {}
    for phase, old in sorted(old_ph.items()):
        new = new_ph.get(phase)
        if new is None:
            continue
        o, n = old.get("mean_s"), new.get("mean_s")
        if o is None or n is None:
            continue
        if n > o * (1.0 + tolerance) and n - o > abs_floor_s:
            problems.append(
                f"phase '{phase}' regression: mean {n * 1e3:.2f} ms vs "
                f"baseline {o * 1e3:.2f} ms (tolerance {tolerance:.0%}, "
                f"floor {abs_floor_s * 1e3:.0f} ms)"
            )
    return problems
