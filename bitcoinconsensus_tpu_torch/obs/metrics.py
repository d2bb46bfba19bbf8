"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of `bitcoinconsensus_tpu/obs/metrics.py`, with the same
semantics: a metric has a name, a help string, a fixed tuple of label names
and one sample per observed label-value combination; every mutation holds
the metric's own lock, so the registry is safe under the index-mode
interpretation threads and concurrent `verify_batch` callers. Bucket edges,
`Histogram.quantile`, `snapshot()`'s dict and `reset()` (which keeps bound
handles) are the reference's, so a snapshot of the same operations is the
same dict in both packages (`tests/test_torch_obs.py`).

Hot-path cost model: one `inc()`/`observe()` is a tuple build, one lock
acquire and one dict update. For tight loops, bind a child once with
`.labels(...)` and call `.inc()` on the bound handle (`models/sigcache.py`
does this per cache instance).

The process-global registry (`get_registry()`) is what the port's layers
instrument and what `python -m bitcoinconsensus_tpu_torch.obs.stats`
exposes; fresh `MetricsRegistry` instances serve tests. It is this
package's own: a process that imports both packages has two registries.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "gauge",
    "get_registry",
    "histogram",
    "DEFAULT_DURATION_BUCKETS",
]

# Span/phase durations land here: 10 µs .. 30 s covers a single counter
# bump through a first dispatch that builds its kernels.
DEFAULT_DURATION_BUCKETS: Tuple[float, ...] = (
    1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0,
)


class _Metric:
    """Shared plumbing: label validation, per-metric lock, sample store."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if len(labels) != len(self.labelnames) or any(
            k not in labels for k in self.labelnames
        ):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)


class _BoundCounter:
    """A counter pre-bound to one label combination (hot-path handle)."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Counter", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: int = 1) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        m = self._metric
        with m._lock:
            m._values[self._key] = m._values.get(self._key, 0) + amount


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def labels(self, **labels) -> _BoundCounter:
        return _BoundCounter(self, self._key(labels))

    def inc(self, amount: int = 1, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0)

    def _samples(self) -> List[dict]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            {"labels": dict(zip(self.labelnames, key, strict=True)), "value": v}
            for key, v in items
        ]

    def _reset(self) -> None:
        with self._lock:
            self._values.clear()


class _BoundGauge:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Gauge", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def set(self, value) -> None:
        m = self._metric
        with m._lock:
            m._values[self._key] = value

    def add(self, amount) -> None:
        m = self._metric
        with m._lock:
            m._values[self._key] = m._values.get(self._key, 0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def labels(self, **labels) -> _BoundGauge:
        return _BoundGauge(self, self._key(labels))

    def set(self, value, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = value

    def add(self, amount, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0)

    _samples = Counter._samples
    _reset = Counter._reset


class _BoundHistogram:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Histogram", key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def observe(self, value) -> None:
        self._metric._observe(self._key, value)


class Histogram(_Metric):
    """Fixed-bucket histogram; bucket `i` counts values <= buckets[i]
    (Prometheus `le` semantics), with an implicit +Inf overflow bucket."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_DURATION_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("buckets must be non-empty and strictly increasing")
        if any(not math.isfinite(x) for x in b):
            raise ValueError("buckets must be finite (+Inf is implicit)")
        self.buckets = b
        # key -> [per-bucket counts (len(buckets)+1, last is +Inf), sum, count]
        self._values: Dict[Tuple[str, ...], list] = {}

    def labels(self, **labels) -> _BoundHistogram:
        return _BoundHistogram(self, self._key(labels))

    def observe(self, value, **labels) -> None:
        self._observe(self._key(labels), value)

    def _observe(self, key: Tuple[str, ...], value) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            cell = self._values.get(key)
            if cell is None:
                cell = self._values[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
            cell[0][i] += 1
            cell[1] += value
            cell[2] += 1

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Conservative quantile estimate from the fixed buckets.

        Returns the upper bound (``le``) of the first bucket whose
        cumulative count reaches ``q * count`` — an over-estimate, which
        is the safe direction for admission control built on it.
        Returns None with no observations and
        ``math.inf`` when the quantile lands in the implicit +Inf
        overflow bucket.
        """
        if not 0.0 < q <= 1.0:
            raise ValueError("q must be in (0, 1]")
        key = self._key(labels)
        with self._lock:
            cell = self._values.get(key)
            if cell is None or cell[2] == 0:
                return None
            counts, count = list(cell[0]), cell[2]
        rank = q * count
        cum = 0
        for i, c in enumerate(counts[:-1]):
            cum += c
            if cum >= rank:
                return self.buckets[i]
        return math.inf

    def _samples(self) -> List[dict]:
        with self._lock:
            items = [
                (key, [list(c[0]), c[1], c[2]])
                for key, c in sorted(self._values.items())
            ]
        out = []
        for key, (counts, total, count) in items:
            cum, cum_counts = 0, []
            for c in counts:
                cum += c
                cum_counts.append(cum)
            out.append(
                {
                    "labels": dict(zip(self.labelnames, key, strict=True)),
                    "buckets": [
                        [le, cum_counts[i]] for i, le in enumerate(self.buckets)
                    ]
                    + [["+Inf", cum_counts[-1]]],
                    "sum": total,
                    "count": count,
                }
            )
        return out

    def _reset(self) -> None:
        with self._lock:
            self._values.clear()


class MetricsRegistry:
    """Name -> metric map with get-or-create registration.

    Re-registering an existing name returns the existing metric when kind
    and labelnames match (so independent modules can share e.g. the
    reject-reason counters) and raises when they conflict — a conflict is
    always a programming error, never something to paper over.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}, requested "
                        f"{cls.kind}{labelnames}"
                    )
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_DURATION_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able view of every registered metric and its samples."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {
            name: {
                "kind": m.kind,
                "help": m.help,
                "labelnames": list(m.labelnames),
                "samples": m._samples(),
            }
            for name, m in metrics
        }

    def reset(self) -> None:
        """Zero every sample; registrations (and bound handles) survive."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry the verify pipeline instruments."""
    return _DEFAULT


def counter(
    name: str, help: str = "", labelnames: Iterable[str] = ()
) -> Counter:
    return _DEFAULT.counter(name, help, tuple(labelnames))


def gauge(name: str, help: str = "", labelnames: Iterable[str] = ()) -> Gauge:
    return _DEFAULT.gauge(name, help, tuple(labelnames))


def histogram(
    name: str,
    help: str = "",
    labelnames: Iterable[str] = (),
    buckets: Sequence[float] = DEFAULT_DURATION_BUCKETS,
) -> Histogram:
    return _DEFAULT.histogram(name, help, tuple(labelnames), buckets=buckets)
