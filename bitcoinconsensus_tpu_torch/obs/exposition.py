"""Exposition: render a metrics snapshot as Prometheus text or JSON.

The port's copy of `bitcoinconsensus_tpu/obs/exposition.py`: on the same
snapshot its text and JSON are byte-identical to the reference's. Works on
the plain-dict output of `MetricsRegistry.snapshot()`, so it also renders
snapshots loaded back from disk (`obs.stats --out` writes one).
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "to_prometheus_text",
    "snapshot_to_json",
    "validate_snapshot",
    "diff_snapshots",
]


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str], extra: Tuple[str, str] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(str(v))}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_prometheus_text(snapshot: Dict[str, dict]) -> str:
    """Prometheus exposition-format text for a registry snapshot."""
    out: List[str] = []
    for name in sorted(snapshot):
        m = snapshot[name]
        if m["help"]:
            out.append(f"# HELP {name} {m['help']}")
        out.append(f"# TYPE {name} {m['kind']}")
        for s in m["samples"]:
            if m["kind"] == "histogram":
                for le, cum in s["buckets"]:
                    le_s = le if le == "+Inf" else _fmt_value(le)
                    out.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(s['labels'], ('le', le_s))} {cum}"
                    )
                out.append(
                    f"{name}_sum{_fmt_labels(s['labels'])} "
                    f"{_fmt_value(s['sum'])}"
                )
                out.append(
                    f"{name}_count{_fmt_labels(s['labels'])} {s['count']}"
                )
            else:
                out.append(
                    f"{name}{_fmt_labels(s['labels'])} {_fmt_value(s['value'])}"
                )
    return "\n".join(out) + "\n"


def snapshot_to_json(snapshot: Dict[str, dict], **meta) -> str:
    """Pretty JSON document: {"meta": ..., "metrics": snapshot}."""
    return json.dumps(
        {"meta": meta, "metrics": snapshot}, indent=2, sort_keys=True
    )


def _iter_values(m: dict):
    for s in m["samples"]:
        if m["kind"] == "histogram":
            yield s["sum"]
            yield s["count"]
            for _le, cum in s["buckets"]:
                yield cum
        else:
            yield s["value"]


def validate_snapshot(
    snapshot: Dict[str, dict], required_names: Sequence[str] = ()
) -> List[str]:
    """Problems with a snapshot: required metrics missing or without
    samples, any non-finite (NaN/inf) value. Empty list == healthy."""
    problems: List[str] = []
    for name in required_names:
        m = snapshot.get(name)
        if m is None:
            problems.append(f"required metric missing: {name}")
        elif not m["samples"]:
            problems.append(f"required metric has no samples: {name}")
    for name in sorted(snapshot):
        for v in _iter_values(snapshot[name]):
            if not math.isfinite(float(v)):
                problems.append(f"non-finite value in {name}: {v!r}")
                break
    return problems


def _sample_map(m: dict) -> Dict[Tuple[Tuple[str, str], ...], dict]:
    return {
        tuple(sorted((k, str(v)) for k, v in s["labels"].items())): s
        for s in m["samples"]
    }


def diff_snapshots(
    old: Dict[str, dict], new: Dict[str, dict]
) -> List[str]:
    """Human-readable per-sample deltas between two snapshots.

    Counters/histogram counts report `+delta`; gauges report `old -> new`.
    Metrics or samples present on one side only are called out.
    """
    lines: List[str] = []
    for name in sorted(set(old) | set(new)):
        if name not in old:
            lines.append(f"+ {name} (new metric)")
            continue
        if name not in new:
            lines.append(f"- {name} (metric gone)")
            continue
        om, nm = _sample_map(old[name]), _sample_map(new[name])
        kind = new[name]["kind"]
        for key in sorted(set(om) | set(nm)):
            lbl = "{" + ",".join(f"{k}={v}" for k, v in key) + "}" if key else ""
            osamp, nsamp = om.get(key), nm.get(key)
            if osamp is None or nsamp is None:
                side = "new" if osamp is None else "gone"
                lines.append(f"  {name}{lbl} ({side} sample)")
                continue
            if kind == "histogram":
                dc = nsamp["count"] - osamp["count"]
                ds = nsamp["sum"] - osamp["sum"]
                if dc or ds:
                    lines.append(
                        f"  {name}{lbl} count +{dc} sum +{round(ds, 6)}"
                    )
            elif kind == "counter":
                d = nsamp["value"] - osamp["value"]
                if d:
                    lines.append(f"  {name}{lbl} +{_fmt(d)}")
            else:
                if nsamp["value"] != osamp["value"]:
                    lines.append(
                        f"  {name}{lbl} {_fmt(osamp['value'])} -> "
                        f"{_fmt(nsamp['value'])}"
                    )
    return lines


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else str(round(f, 6))
