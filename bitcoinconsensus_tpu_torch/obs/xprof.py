"""Device-truth observatory: the card's kernel time charged to regions, its
busy share, and its idle gaps labelled with the host span open over them.

The port of `bitcoinconsensus_tpu/obs/xprof.py`, rebuilt on
`torch.profiler`. A capture (`trace_session`) runs the workload under
`torch.profiler.profile(activities=[CPU, CUDA])`, with every obs span
entering a `record_function` of its own name (`spans.set_annotator`), and
exports the chrome trace. `parse_trace_events` reads it:

- device tracks are the (pid, tid) pairs whose events have `cat` `kernel`,
  `gpu_memcpy` or `gpu_memset` (and, for the reference's trace format, the
  pids whose `process_name` names a device);
- a kernel event is charged to `ops/regions.KERNEL_REGIONS[symbol]` first,
  then to the innermost `region:` frame of its name (the reference's rule),
  then to the innermost `gpu_user_annotation` `region:` range enclosing it,
  else to `unattributed`; copies and sets go to the `copy` region;
- the phase of an event is its outermost frame (an enclosing annotation's
  region, such as `dispatch`, else the event's own region);
- the capture window runs from the first host annotation's start (the
  capture's own `xprof.capture` range) to the last event's end, which is
  the closing synchronise; `device_busy_share` is the union of the device
  events' intervals over that window;
- the idle gaps are the window's stretches with no device event, longest
  first, each labelled with the innermost host annotation (an obs span or a
  `record_function`) open over its middle (`host_span`), and with the
  host annotations that overlap it most without holding all of it
  (`host_spans`, name and overlapping seconds, at most three).

`capture_report(fn, ...)` runs `fn` under a capture and returns the report
(regions, phases, kernel seconds by symbol, the busy share, the gaps and
`perf.provenance()`). It raises when no CUDA device is present: the
reference's op-walk estimate on the CPU (its `opwalk` mode) is not ported,
so a measurement path that finds no card fails rather than reports an
estimate. The CPU tests parse checked-in traces
(`tests/data/xprof_fixture.trace.json`, the reference's;
`tests/data/torch_xprof_fixture.trace.json`, in torch's format).

Metrics: `consensus_kernel_region_seconds{region}`,
`consensus_xprof_captures_total{mode}` (one mode, `trace`) and
`consensus_xprof_busy_fraction{unit}`, whose one unit here is `device`
(the reference's `mxu` and `vpu` are units of the TPU).
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import counter, gauge
from . import perf as _perf
from . import spans as _spans
from ..ops.regions import extract_regions, kernel_region, kernel_symbol

__all__ = [
    "COPY",
    "SHARE_FLOOR",
    "SHARE_TOLERANCE",
    "UNATTRIBUTED",
    "capture_report",
    "check_reports",
    "parse_trace_events",
    "parse_trace_file",
    "trace_session",
    "write_report",
]

SCHEMA = "consensus-xprof-torch-v1"

# Device time outside every region: kept explicit, so that "shares sum to
# 100%" is a checkable claim and a kernel landing unmapped shows up.
UNATTRIBUTED = "unattributed"
# Host<->device copies and memsets.
COPY = "copy"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_COPY_CATS = ("gpu_memcpy", "gpu_memset")
_GPU_ANNOTATION = "gpu_user_annotation"
_HOST_ANNOTATION = "user_annotation"
CAPTURE_RANGE = "xprof.capture"
# How many of the longest idle gaps a report lists.
TOP_GAPS = 5

_REGION_SECONDS = gauge(
    "consensus_kernel_region_seconds",
    "device seconds attributed to each named kernel region by the last "
    "xprof capture (measured by torch.profiler on the card)",
    ("region",),
)
_BUSY_FRACTION = gauge(
    "consensus_xprof_busy_fraction",
    "share of the last capture's window in which the device ran a kernel "
    "or a copy (unit=device)",
    ("unit",),
)
_CAPTURES = counter(
    "consensus_xprof_captures_total",
    "xprof capture sessions, by mode",
    ("mode",),
)


# ---------------------------------------------------------------------------
# chrome-trace parsing
# ---------------------------------------------------------------------------


def _named_device_pids(events: Sequence[dict]) -> set:
    """pids whose process_name metadata names a device (the reference's
    trace format: '/device:TPU:0 ...')."""
    pids = set()
    for ev in events:
        if ev.get("ph") != "M" or ev.get("name") != "process_name":
            continue
        pname = str((ev.get("args") or {}).get("name", ""))
        low = pname.lower()
        if "/device:" in pname or "tpu" in low or "xla" in low:
            pids.add(ev.get("pid"))
    return pids


def _interval(ev: dict) -> Tuple[float, float]:
    t0 = float(ev.get("ts", 0.0))
    return t0, t0 + float(ev.get("dur", 0.0))


def _innermost(spans: Sequence[Tuple[float, float, str]], t: float):
    """The name of the innermost (latest-starting, then shortest) interval
    of `spans` containing instant `t`, or None."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or a > best[0]
                            or (a == best[0] and b - a < best[1] - best[0])):
            best = (a, b, name)
    return None if best is None else best[2]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def parse_trace_events(events: Sequence[dict]) -> dict:
    """Attribute a chrome trace's device events to regions (see the module
    docstring). Durations are chrome-trace microseconds; the result is in
    seconds:

    ``{"regions": {leaf: s}, "phases": {outer: s}, "symbols": {kernel: s},
    "unattributed_symbols": {kernel: s}, "total_s", "copy_s", "window_s",
    "device_busy_s", "device_busy_share", "gaps": [{"start_s", "length_s",
    "host_span", "host_spans"}], "kernels": count}``."""
    named_pids = _named_device_pids(events)
    complete = [ev for ev in events
                if ev.get("ph") == "X" and float(ev.get("dur", 0) or 0) > 0]
    tracks = {(ev.get("pid"), ev.get("tid")) for ev in complete
              if ev.get("cat") in DEVICE_CATS}

    def on_device(ev) -> bool:
        return (ev.get("pid"), ev.get("tid")) in tracks or ev.get("pid") in named_pids

    gpu_ann: Dict[object, List[Tuple[float, float, List[str]]]] = {}
    host_ann: List[Tuple[float, float, str]] = []
    device: List[dict] = []
    for ev in complete:
        cat = ev.get("cat")
        if cat == _GPU_ANNOTATION:
            frames = extract_regions(str(ev.get("name", "")))
            if frames:
                a, b = _interval(ev)
                gpu_ann.setdefault(ev.get("pid"), []).append((a, b, frames))
        elif cat == _HOST_ANNOTATION:
            a, b = _interval(ev)
            host_ann.append((a, b, str(ev.get("name", ""))))
        elif on_device(ev):
            device.append(ev)

    regions: Dict[str, float] = {}
    phases: Dict[str, float] = {}
    symbols: Dict[str, float] = {}
    unattributed_symbols: Dict[str, float] = {}
    total = copy_s = 0.0
    n_kernels = 0
    for ev in device:
        a, b = _interval(ev)
        dur = (b - a) / 1e6
        name = str(ev.get("name", ""))
        # Enclosing device-side annotation ranges, outermost first.
        enclosing = sorted(
            ((x, y, f) for x, y, f in gpu_ann.get(ev.get("pid"), ())
             if x <= a and b <= y), key=lambda r: (r[0], -r[1]))
        ann_frames = [fr for _x, _y, f in enclosing for fr in f]
        if ev.get("cat") in _COPY_CATS:
            leaf = COPY
            copy_s += dur
        else:
            n_kernels += 1
            hay = name
            args = ev.get("args")
            if isinstance(args, dict):
                hay += " " + " ".join(str(v) for v in args.values())
            name_frames = extract_regions(hay)
            leaf = (kernel_region(name)
                    or (name_frames[-1] if name_frames else None)
                    or (ann_frames[-1] if ann_frames else None)
                    or UNATTRIBUTED)
            sym = kernel_symbol(name)
            symbols[sym] = symbols.get(sym, 0.0) + dur
            if leaf == UNATTRIBUTED:
                unattributed_symbols[sym] = unattributed_symbols.get(sym, 0.0) + dur
            if not ann_frames and name_frames:
                ann_frames = name_frames
        outer = ann_frames[0] if ann_frames else leaf
        regions[leaf] = regions.get(leaf, 0.0) + dur
        phases[outer] = phases.get(outer, 0.0) + dur
        total += dur

    busy = _union([_interval(ev) for ev in device])
    ends = [b for _a, b in busy] + [b for _a, b, _n in host_ann]
    starts = [a for a, _b, _n in host_ann] or [a for a, _b in busy]
    gaps: List[dict] = []
    window = busy_s = 0.0
    if starts and ends:
        w0, w1 = min(starts), max(ends)
        window = (w1 - w0) / 1e6
        busy_s = sum(min(b, w1) - max(a, w0) for a, b in busy if b > w0 and a < w1) / 1e6
        edges = [(w0, w0)] + busy + [(w1, w1)]
        holes = [(edges[i][1], edges[i + 1][0]) for i in range(len(edges) - 1)
                 if edges[i + 1][0] > edges[i][1]]
        holes.sort(key=lambda h: h[0] - h[1])
        for a, b in holes[:TOP_GAPS]:
            inside = sorted(
                ((min(y, b) - max(x, a), name) for x, y, name in host_ann
                 if y > a and x < b and not (x <= a and b <= y)), reverse=True)
            gaps.append({"start_s": (a - w0) / 1e6, "length_s": (b - a) / 1e6,
                         "host_span": _innermost(host_ann, (a + b) / 2),
                         "host_spans": [[name, ov / 1e6] for ov, name in inside[:3]]})
    return {
        "regions": regions, "phases": phases, "symbols": symbols,
        "unattributed_symbols": unattributed_symbols, "total_s": total,
        "copy_s": copy_s, "window_s": window, "device_busy_s": busy_s,
        "device_busy_share": busy_s / window if window > 0 else 0.0,
        "gaps": gaps, "kernels": n_kernels,
    }


def parse_trace_file(path: str) -> dict:
    """`parse_trace_events` of one exported trace (`.json` or `.json.gz`)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return parse_trace_events(events)


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

_seq = 0


@contextmanager
def trace_session(log_dir: str):
    """A `torch.profiler` capture (CPU and, with a card, CUDA activities)
    whose chrome trace is exported into `log_dir` on exit, its path then in
    the yielded profiler's `trace_path`; every obs span opened meanwhile is
    also a `record_function` range."""
    global _seq
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    _spans.set_annotator(record_function)
    try:
        with prof:
            yield prof
    finally:
        _spans.set_annotator(None)
    _seq += 1
    prof.trace_path = os.path.join(log_dir, f"torch_{os.getpid()}_{_seq:03d}.trace.json")
    prof.export_chrome_trace(prof.trace_path)


def _finalize(parsed: dict, walls: List[float], cmd: Optional[str]) -> dict:
    total = parsed["total_s"]
    regions = parsed["regions"]
    unattr = regions.get(UNATTRIBUTED, 0.0)
    named = {k: v for k, v in regions.items() if k != UNATTRIBUTED}

    def share(s):
        return s / total if total > 0 else 0.0

    doc = {
        "schema": SCHEMA,
        "mode": "trace",
        "provenance": _perf.provenance(cmd=cmd),
        "device_total_s": total,
        "regions": {k: {"seconds": v, "share": share(v)}
                    for k, v in sorted(named.items())},
        "phases": {k: {"seconds": v, "share": share(v)}
                   for k, v in sorted(parsed["phases"].items()) if k != UNATTRIBUTED},
        "symbols": dict(sorted(parsed["symbols"].items())),
        "unattributed_s": unattr,
        "unattributed_symbols": parsed["unattributed_symbols"],
        "named_share": share(sum(named.values())),
        "copy_s": parsed["copy_s"],
        "kernels": parsed["kernels"],
        "window_s": parsed["window_s"],
        "device_busy_s": parsed["device_busy_s"],
        "device_busy_share": parsed["device_busy_share"],
        "gaps": parsed["gaps"],
        "walls_s": walls,
    }
    for k, v in named.items():
        _REGION_SECONDS.set(v, region=k)
    _REGION_SECONDS.set(unattr, region=UNATTRIBUTED)
    _BUSY_FRACTION.set(doc["device_busy_share"], unit="device")
    _CAPTURES.inc(mode="trace")
    return doc


def capture_report(fn: Callable[[], object], reps: int = 1,
                   log_dir: Optional[str] = None, cmd: Optional[str] = None) -> dict:
    """Run `fn` `reps` times under one capture on the card and return the
    report (not yet written: see `write_report`). The calls run inside a
    `record_function("xprof.capture")` range that ends after a synchronise
    of the card, so the window holds every device event they caused. A
    warm `fn` is the caller's to give. Raises RuntimeError with no CUDA
    device: there is no estimate in place of a measurement."""
    import torch
    from torch.profiler import record_function

    if not torch.cuda.is_available():
        raise RuntimeError("xprof.capture_report measures the card: no CUDA "
                           "device is available")
    own = log_dir is None
    log_dir = log_dir or tempfile.mkdtemp(prefix="consensus_xprof_")
    walls = []
    torch.cuda.synchronize()
    with trace_session(log_dir) as prof:
        with record_function(CAPTURE_RANGE):
            for _ in range(max(1, int(reps))):
                t0 = _spans.monotonic()
                fn()
                torch.cuda.synchronize()
                walls.append(_spans.monotonic() - t0)
    # This session's trace only: the directory may hold earlier ones.
    parsed = parse_trace_file(prof.trace_path)
    if own:
        import shutil

        shutil.rmtree(log_dir, ignore_errors=True)
    return _finalize(parsed, walls, cmd)


def write_report(doc: dict, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


# Minimum share a region must hold before drift in it can gate, and the
# maximum absolute share drift tolerated between same-provenance runs.
SHARE_FLOOR = 0.01
SHARE_TOLERANCE = 0.15


def check_reports(
    baseline: dict, report: dict,
    tolerance: float = SHARE_TOLERANCE, floor: float = SHARE_FLOOR,
) -> Optional[List[str]]:
    """Region-share drift gate between two xprof reports.

    Returns None when the runs are not comparable (provenance mismatch or
    different capture modes), else the list of drift findings (empty =
    pass). A region drifts when its device-time share moved by more than
    `tolerance` absolute points and at least one side holds more than
    `floor` share, so a region appearing from or collapsing to nothing is
    also a finding.
    """
    ok, _why = _perf.comparable(
        baseline.get("provenance", {}), report.get("provenance", {}))
    if not ok:
        return None
    if baseline.get("mode") != report.get("mode"):
        return None
    problems: List[str] = []
    old = {k: v.get("share", 0.0)
           for k, v in (baseline.get("regions") or {}).items()}
    new = {k: v.get("share", 0.0)
           for k, v in (report.get("regions") or {}).items()}
    for k in sorted(set(old) | set(new)):
        a, b = old.get(k, 0.0), new.get(k, 0.0)
        if max(a, b) < floor:
            continue
        if abs(b - a) > tolerance:
            problems.append(
                f"region {k}: share {a:.1%} -> {b:.1%} "
                f"(drift {abs(b - a):.1%} > {tolerance:.0%})"
            )
    old_named = baseline.get("named_share")
    new_named = report.get("named_share")
    if (isinstance(old_named, (int, float))
            and isinstance(new_named, (int, float))
            and new_named < old_named - tolerance):
        problems.append(
            f"named-region coverage dropped {old_named:.1%} -> "
            f"{new_named:.1%} (annotations eroding)"
        )
    return problems
