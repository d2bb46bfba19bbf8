"""The port's `obs/` against the JAX package's: registry semantics, spans,
exposition, `Phases`, the phase timelines and report comparison, and the
no-sink overhead budget.

Each case of the reference's `tests/test_obs.py` and `tests/test_perf.py`
that has a torch meaning runs here once per package (`pkg` is "ref" or
"port"), the same sequence through both; the equality cases run the same
operations through a fresh registry of each and compare the snapshots, the
Prometheus text and the JSON byte for byte. The two packages' registries are
separate process globals: snapshots are compared, never handles.
"""

import io
import json
import random
import threading
import time
import types

import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu.obs import exposition as JE
from bitcoinconsensus_tpu.obs import metrics as JM
from bitcoinconsensus_tpu.obs import perf as JP
from bitcoinconsensus_tpu.obs import spans as JS
from bitcoinconsensus_tpu.utils import profiling as JPROF
from bitcoinconsensus_tpu_torch.obs import exposition as TE
from bitcoinconsensus_tpu_torch.obs import metrics as TM
from bitcoinconsensus_tpu_torch.obs import perf as TP
from bitcoinconsensus_tpu_torch.obs import spans as TS
from bitcoinconsensus_tpu_torch.utils import profiling as TPROF

torch.set_num_threads(1)

PKGS = {
    "ref": types.SimpleNamespace(M=JM, S=JS, E=JE, P=JP, Phases=JPROF.Phases),
    "port": types.SimpleNamespace(M=TM, S=TS, E=TE, P=TP, Phases=TPROF.Phases),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


class _ListSink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


# -- registry semantics ------------------------------------------------------------


def test_counter_labels_and_values(pkg):
    reg = pkg.M.MetricsRegistry()
    c = reg.counter("calls_total", "calls", ("entry",))
    c.inc(entry="verify")
    c.inc(3, entry="verify")
    c.inc(entry="batch")
    assert c.value(entry="verify") == 4 and c.value(entry="batch") == 1
    c.labels(entry="verify").inc(2)
    assert c.value(entry="verify") == 6
    for bad in ({}, {"wrong": "x"}):
        with pytest.raises(ValueError):
            c.inc(**bad)
    with pytest.raises(ValueError):
        c.inc(-1, entry="verify")


def test_registry_get_or_create_and_conflicts(pkg):
    reg = pkg.M.MetricsRegistry()
    a = reg.counter("shared_total", "h", ("code",))
    assert reg.counter("shared_total", "different help ok", ("code",)) is a
    with pytest.raises(ValueError):
        reg.gauge("shared_total")
    with pytest.raises(ValueError):
        reg.counter("shared_total", "h", ("other",))
    assert reg.names() == ["shared_total"]


def test_registry_reset_keeps_bound_handles(pkg):
    reg = pkg.M.MetricsRegistry()
    c = reg.counter("c_total", "", ("k",))
    bound = c.labels(k="x")
    bound.inc(5)
    reg.reset()
    assert c.value(k="x") == 0
    bound.inc()
    assert c.value(k="x") == 1


def test_histogram_bucket_edges_and_quantile(pkg):
    reg = pkg.M.MetricsRegistry()
    h = reg.histogram("lat", "", buckets=(1, 2, 4))
    assert h.quantile(0.5) is None
    for v in (0.5, 1, 1.5, 2, 4, 5):
        h.observe(v)
    (s,) = h._samples()
    assert s["buckets"] == [[1.0, 2], [2.0, 4], [4.0, 5], ["+Inf", 6]]
    assert s["count"] == 6 and s["sum"] == pytest.approx(14.0)
    assert [h.quantile(q) for q in (0.3, 0.5, 0.8, 1.0)] == [1.0, 2.0, 4.0, float("inf")]
    for buckets in ((), (2, 1), (1, float("inf"))):
        with pytest.raises(ValueError):
            reg.histogram("bad", buckets=buckets)
    assert pkg.M.DEFAULT_DURATION_BUCKETS == JM.DEFAULT_DURATION_BUCKETS


def test_gauge_set_add(pkg):
    g = pkg.M.MetricsRegistry().gauge("fill", "", ("dev",))
    g.set(0.5, dev="0")
    g.add(0.25, dev="0")
    g.labels(dev="1").set(2)
    g.labels(dev="1").add(1)
    assert g.value(dev="0") == 0.75 and g.value(dev="1") == 3


def _ops(seed: int):
    """A seeded sequence of registry operations: (kind, name, labels, value)."""
    rng = random.Random(seed)
    out = []
    for _ in range(60):
        kind = rng.choice(["counter", "gauge", "histogram"])
        name = f"m_{kind}_{rng.randrange(3)}"
        lab = {"k": rng.choice(["a", 'q"uote', "new\nline", "b\\s"])}
        out.append((kind, name, lab, rng.choice([0, 1, 2.5, 1e-6, 0.25, 7, 31.0])))
    return out


def _apply(mod, ops):
    reg = mod.MetricsRegistry()
    for kind, name, lab, v in ops:
        if kind == "counter":
            reg.counter(name, f"help of {name}", ("k",)).inc(v, **lab)
        elif kind == "gauge":
            reg.gauge(name, f"help of {name}", ("k",)).set(v, **lab)
        else:
            reg.histogram(name, f"help of {name}", ("k",)).observe(v, **lab)
    return reg.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_operations_give_equal_snapshots_text_and_json(seed):
    ops = _ops(seed)
    ref, port = _apply(JM, ops), _apply(TM, ops)
    assert port == ref
    assert TE.to_prometheus_text(port).encode() == JE.to_prometheus_text(ref).encode()
    assert TE.snapshot_to_json(port, seed=seed) == JE.snapshot_to_json(ref, seed=seed)
    assert TE.validate_snapshot(port, ["m_counter_0"]) == \
        JE.validate_snapshot(ref, ["m_counter_0"])
    later = _apply(TM, ops + _ops(seed + 10))
    assert TE.diff_snapshots(port, later) == JE.diff_snapshots(ref, later)


# -- spans -------------------------------------------------------------------------


def test_span_nesting_parent_ids_and_sink(pkg):
    sink = _ListSink()
    pkg.S.add_sink(sink)
    try:
        with pkg.S.span("outer", n=3) as outer:
            with pkg.S.span("inner") as inner:
                pass
        assert inner.parent_id == outer.span_id and outer.parent_id is None
    finally:
        pkg.S.remove_sink(sink)
    assert [r["name"] for r in sink.records] == ["inner", "outer"]
    inner_rec, outer_rec = sink.records
    assert inner_rec["parent_id"] == outer_rec["span_id"]
    assert outer_rec["attrs"] == {"n": 3}
    assert outer_rec["dur_s"] >= inner_rec["dur_s"] >= 0
    assert set(inner_rec) == {"name", "span_id", "parent_id", "trace", "thread",
                              "pid", "t0", "dur_s"}


def test_span_exception_path(pkg):
    errs = pkg.M.get_registry().get("consensus_span_errors_total")
    before = errs.value(span="obs-test-boom")
    sink = _ListSink()
    pkg.S.add_sink(sink)
    try:
        with pytest.raises(RuntimeError):
            with pkg.S.span("obs-test-boom"):
                raise RuntimeError("boom")
    finally:
        pkg.S.remove_sink(sink)
    assert errs.value(span="obs-test-boom") == before + 1
    (rec,) = sink.records
    assert rec["error"] == "RuntimeError"


def _span_count(mod, name):
    for s in mod.get_registry().get("consensus_span_duration_seconds")._samples():
        if s["labels"] == {"span": name}:
            return s["count"]
    return 0


def test_span_aggregates_into_registry(pkg):
    before = _span_count(pkg.M, "obs-test-agg")
    for _ in range(3):
        with pkg.S.span("obs-test-agg"):
            pass
    assert _span_count(pkg.M, "obs-test-agg") == before + 3


def test_broken_sink_never_breaks_a_span(pkg):
    class Broken:
        def write(self, record):
            raise OSError("disk full")

    before = pkg.S._SINK_ERRORS.value(sink="Broken")
    b = Broken()
    pkg.S.add_sink(b)
    try:
        for name in ("obs-test-broken-sink", "obs-test-broken-sink-2"):
            with pkg.S.span(name):
                pass
    finally:
        pkg.S.remove_sink(b)
    assert pkg.S._SINK_ERRORS.value(sink="Broken") == before + 2


def test_jsonl_sink_roundtrip_and_bounded_flush(pkg):
    buf = io.StringIO()
    sink = pkg.S.JsonlSink(buf)
    pkg.S.add_sink(sink)
    try:
        with pkg.S.span("obs-test-jsonl", kind="x"):
            pass
    finally:
        pkg.S.remove_sink(sink)
        sink.flush()
    (line,) = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert line["name"] == "obs-test-jsonl" and line["attrs"] == {"kind": "x"}

    class Counting(io.StringIO):
        flushes = 0

        def flush(self):
            self.flushes += 1
            return super().flush()

    out = Counting()
    sink = pkg.S.JsonlSink(out, flush_every=4)
    for i in range(10):
        sink.write({"i": i})
    assert out.flushes == 2
    sink.close()
    sink.close()
    assert out.flushes == 3 and len(out.getvalue().splitlines()) == 10
    with pytest.raises(ValueError):
        sink.write({"late": 1})


def test_closed_jsonl_sink_counts_as_sink_error_not_crash(pkg):
    before = pkg.S._SINK_ERRORS.value(sink="JsonlSink")
    sink = pkg.S.JsonlSink(io.StringIO())
    pkg.S.add_sink(sink)
    try:
        sink.close()
        for name in ("obs-test-closed-sink", "obs-test-closed-sink-2"):
            with pkg.S.span(name):
                pass
    finally:
        pkg.S.remove_sink(sink)
    assert pkg.S._SINK_ERRORS.value(sink="JsonlSink") == before + 2


def test_root_span_defines_trace_children_inherit(pkg):
    S = pkg.S
    with S.span("trace-root") as root:
        assert root.trace == root.span_id == S.current_span_id()
        assert S.current_trace() == root.trace
        with S.span("trace-child") as child:
            assert child.trace == root.trace != child.span_id
    assert S.current_trace() is None and S.current_span_id() is None


def test_trace_context_stitches_across_threads(pkg):
    S = pkg.S
    sink = _ListSink()
    S.add_sink(sink)
    handoff = {}
    try:
        with S.span("stitch-submit") as sub:
            handoff.update(trace=sub.trace, parent=sub.span_id)

        def worker():
            with S.trace_context(handoff["trace"], handoff["parent"]):
                with S.span("stitch-settle"):
                    pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    finally:
        S.remove_sink(sink)
    by_name = {r["name"]: r for r in sink.records}
    assert by_name["stitch-settle"]["trace"] == by_name["stitch-submit"]["trace"]
    assert by_name["stitch-settle"]["parent_id"] == by_name["stitch-submit"]["span_id"]
    assert by_name["stitch-settle"]["thread"] != by_name["stitch-submit"]["thread"]
    with S.trace_context(777, 42):
        with S.span("ctx-inner") as sp:
            assert (sp.trace, sp.parent_id) == (777, 42)
    assert S.current_trace() is None


def test_span_annotator_enters_a_range_per_span():
    """The port's capture hook: while set, every span enters and leaves the
    annotator's context manager under its own name, nested as the spans
    are; unset, nothing is entered."""
    seen = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            seen.append(("enter", self.name))

        def __exit__(self, *exc):
            seen.append(("exit", self.name))

    TS.set_annotator(Range)
    try:
        with TS.span("ann-outer"):
            with pytest.raises(KeyError):
                with TS.span("ann-inner"):
                    raise KeyError("x")
    finally:
        TS.set_annotator(None)
    with TS.span("ann-after"):
        pass
    assert seen == [("enter", "ann-outer"), ("enter", "ann-inner"),
                    ("exit", "ann-inner"), ("exit", "ann-outer")]


def test_span_self_seconds_split_has_no_remainder():
    sink = _ListSink()
    TS.add_sink(sink)
    try:
        with TS.span("self-root"):
            with TS.span("self-a"):
                with TS.span("self-a1"):
                    time.sleep(0.002)
            for _ in range(2):
                with TS.span("self-b"):
                    time.sleep(0.001)
    finally:
        TS.remove_sink(sink)
    split = TP.span_self_seconds(sink.records, root="self-root")
    assert set(split) == {"self-root", "self-a", "self-a1", "self-b"}
    root = [r for r in sink.records if r["name"] == "self-root"][0]
    assert sum(split.values()) == pytest.approx(root["dur_s"], abs=1e-9)
    assert split["self-a1"] >= 0.002 and split["self-b"] >= 0.002
    assert all(v >= 0 for v in split.values())


# -- exposition --------------------------------------------------------------------


def test_prometheus_golden_output(pkg):
    reg = pkg.M.MetricsRegistry()
    c = reg.counter("req_total", "requests", ("code",))
    c.inc(2, code="ok")
    c.inc(code='we"ird\nlabel\\x')
    reg.gauge("temp", "degrees").set(1.5)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1))
    h.observe(0.25)
    h.observe(0.5)
    assert pkg.E.to_prometheus_text(reg.snapshot()) == (
        "# HELP lat_seconds latency\n"
        "# TYPE lat_seconds histogram\n"
        'lat_seconds_bucket{le="0.1"} 0\n'
        'lat_seconds_bucket{le="1"} 2\n'
        'lat_seconds_bucket{le="+Inf"} 2\n'
        "lat_seconds_sum 0.75\n"
        "lat_seconds_count 2\n"
        "# HELP req_total requests\n"
        "# TYPE req_total counter\n"
        'req_total{code="ok"} 2\n'
        'req_total{code="we\\"ird\\nlabel\\\\x"} 1\n'
        "# HELP temp degrees\n"
        "# TYPE temp gauge\n"
        "temp 1.5\n"
    )


def test_validate_and_diff_snapshots(pkg):
    E = pkg.E
    reg = pkg.M.MetricsRegistry()
    c = reg.counter("a_total", "", ("k",))
    c.inc(k="x")
    snap1 = reg.snapshot()
    assert E.validate_snapshot(snap1, ["a_total"]) == []
    assert E.validate_snapshot(snap1, ["missing_total"]) == [
        "required metric missing: missing_total"]
    reg.gauge("g").set(float("nan"))
    assert any("non-finite" in p for p in E.validate_snapshot(reg.snapshot()))
    c.inc(2, k="x")
    c.inc(k="y")
    snap2 = reg.snapshot()
    del snap2["g"]
    lines = E.diff_snapshots(snap1, snap2)
    assert "  a_total{k=x} +2" in lines and any("new sample" in x for x in lines)
    doc = json.loads(E.snapshot_to_json(snap1, workload="t"))
    assert doc["meta"] == {"workload": "t"} and "a_total" in doc["metrics"]


# -- Phases ------------------------------------------------------------------------


def test_phases_threaded_hammer_exact_counts(pkg):
    ph = pkg.Phases()
    n_threads, iters = 8, 200
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(iters):
            with ph("hammer"):
                pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rep = ph.report()
    assert rep["hammer"]["calls"] == n_threads * iters and rep["hammer"]["secs"] >= 0
    assert ph.total() == pytest.approx(rep["hammer"]["secs"], abs=1e-5)
    ph.reset()
    assert ph.report() == {}


def test_phases_disabled_is_noop_and_phases_feed_spans(pkg):
    ph = pkg.Phases(enabled=False)
    with ph("x"):
        pass
    assert ph.report() == {}
    ph = pkg.Phases(scope="obstest")
    before = _span_count(pkg.M, "obstest.phase1")
    with ph("phase1"):
        pass
    assert _span_count(pkg.M, "obstest.phase1") == before + 1
    assert ph.report()["phase1"]["calls"] == 1


def test_accumulate_and_monotonic_read_the_obs_clock():
    stats = {"k": 0.0}
    with TPROF.accumulate(stats, "k"):
        time.sleep(0.002)
    assert stats["k"] >= 0.002
    with pytest.raises(KeyError):
        with TPROF.accumulate(stats, "k"):
            raise KeyError("x")
    assert stats["k"] < 1.0  # a block that raised added nothing
    a = TPROF.monotonic()
    assert TS.monotonic() >= a


# -- phase timelines and reports (tests/test_perf.py) -------------------------------


def _phase_count(mod, phase):
    h = mod.get_registry().get("consensus_pipeline_phase_seconds")
    for s in h._samples():
        if s["labels"] == {"phase": phase}:
            return s["count"]
    return 0


def test_timeline_stamps_feed_phase_histograms(pkg):
    phases = ("prepare", "launch", "inflight", "settle", "total")
    before = {p: _phase_count(pkg.M, p) for p in phases}
    tl = pkg.P.PhaseTimeline()
    for name in ("submit", "prepare", "launch"):
        tl.stamp(name)
    tl.stamp_once("first_poll")
    tl.stamp_once("first_poll")
    tl.stamp("settle_start")
    tl.stamp("settle_end")
    got = tl.phase_seconds()
    assert set(got) == set(phases) and got["total"] >= got["settle"] >= 0
    tl.finalize()
    tl.finalize()
    assert {p: _phase_count(pkg.M, p) for p in phases} == \
        {p: n + 1 for p, n in before.items()}


def test_overlap_efficiency_math(pkg):
    P = pkg.P
    P.reset_overlap_window()
    t0 = 100.0
    tl = P.PhaseTimeline()
    tl.stamps = {"submit": t0, "prepare": t0, "launch": t0,
                 "first_poll": t0 + 0.08, "settle_start": t0 + 0.09,
                 "settle_end": t0 + 0.10}
    tl.finalize()
    assert P.overlap_efficiency() == pytest.approx(0.8)
    tl2 = P.PhaseTimeline()
    tl2.stamps = {"submit": t0, "launch": t0, "first_poll": t0,
                  "settle_start": t0 + 0.09, "settle_end": t0 + 0.10}
    tl2.finalize()
    assert P.overlap_efficiency() == pytest.approx(0.4)
    P.reset_overlap_window()


def test_null_timeline_is_inert_singleton(pkg):
    P = pkg.P
    assert P.new_timeline() is not P.NULL_TIMELINE and P.timeline_enabled()
    P.set_enabled(False)
    try:
        tl = P.new_timeline(trace=123)
        assert tl is P.NULL_TIMELINE and tl.trace is None
        tl.stamp("submit")
        tl.stamp_once("first_poll")
        tl.stamp_shard(0)
        tl.finalize()
        assert tl.phase_seconds() == {}
    finally:
        P.set_enabled(True)


def _report(mean_prepare_s, vps=1000.0, platform="cpu"):
    return {
        "workload": {"verifies_per_sec": vps},
        "phases": {
            "prepare": {"count": 4, "mean_s": mean_prepare_s,
                        "total_s": 4 * mean_prepare_s},
            "settle": {"count": 4, "mean_s": 0.002, "total_s": 0.008},
        },
        "provenance": {"platform": platform, "device_kind": platform},
    }


@pytest.mark.parametrize("baseline,report,want", [
    (_report(0.004), _report(0.050), "prepare"),
    (_report(0.004), _report(0.005), None),
    (_report(0.000002), _report(0.000006), None),
    (_report(0.004, vps=1000.0), _report(0.004, vps=100.0), "throughput"),
    (_report(0.0001, 1e5, "cuda"), _report(0.05, 50.0, "cpu"), "skip"),
], ids=["slowdown", "within", "noise", "throughput", "provenance"])
def test_compare_reports_matches_the_reference(baseline, report, want):
    port = TP.compare_reports(baseline, report, tolerance=0.5)
    assert port == JP.compare_reports(baseline, report, tolerance=0.5)
    if want == "skip":
        assert port is None
    elif want is None:
        assert port == []
    else:
        assert port and any(want in p for p in port)


def test_provenance_has_torch_cuda_and_device_fields():
    prov = TP.provenance(cmd="test")
    for key in ("platform", "device_kind", "device_count", "torch", "cuda",
                "power_limit", "python", "git_rev", "cmd"):
        assert key in prov, key
    assert prov["cmd"] == "test" and prov["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert prov["platform"] == "cpu" and prov["device_kind"].startswith("cpu/")
        assert prov["power_limit"] == "unavailable"
    ok, why = TP.comparable(prov, dict(prov))
    assert ok and why == ""
    ok, why = TP.comparable(prov, dict(prov, device_kind="NVIDIA H100 80GB HBM3"))
    assert not ok and "device_kind" in why


def test_timed_best_orders_its_walls():
    best, median, walls = TP.timed_best(lambda: time.sleep(0.001), reps=3)
    assert len(walls) == 3 and best == min(walls) <= median and best >= 0.001


def test_overlap_window_threaded(pkg):
    P = pkg.P
    P.reset_overlap_window()
    barrier = threading.Barrier(4)

    def work():
        barrier.wait()
        for _ in range(50):
            tl = P.PhaseTimeline()
            tl.stamps = {"submit": 0.0, "launch": 0.0, "first_poll": 0.5,
                         "settle_start": 0.9, "settle_end": 1.0}
            tl.finalize()

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert P.overlap_efficiency() == pytest.approx(0.5)
    P.reset_overlap_window()


# -- the queue stamps every ticket (the port's InflightQueue) ------------------------


def _queue():
    from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchResilience
    from bitcoinconsensus_tpu_torch.resilience.inflight import InflightQueue

    ok = np.ones(8, dtype=bool)
    return InflightQueue(DispatchResilience(), "obs-test",
                         launch=lambda args, n, sset: (ok, None),
                         materialize=lambda t: (t.result, np.zeros(8, dtype=bool)))


def test_ticket_timeline_through_queue_settle_and_trace():
    q = _queue()
    before = _phase_count(TM, "total")
    with TS.span("perf-trace-root") as sp:
        t = q.dispatch(("args",), 5)
        assert t.timeline.trace == sp.trace
    assert {"submit", "prepare", "launch"} <= set(t.timeline.stamps)
    q.settle(t)
    assert _phase_count(TM, "total") == before + 1
    ph = t.timeline.phase_seconds()
    assert ph["total"] >= ph["inflight"] >= 0
    t2 = q.dispatch(("args",), 3)
    assert t2.timeline.trace is None
    q.settle(t2)
    snap = TM.get_registry().snapshot()
    depth = [s for s in snap["consensus_inflight_depth"]["samples"]
             if s["labels"] == {"site": "obs-test"}]
    assert depth and depth[0]["value"] == 0


# -- no-sink overhead: event-cost accounting on a small CPU verify_batch ------------


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def test_no_sink_overhead_under_one_percent():
    """Telemetry left on must cost under 1% of a small port `verify_batch`
    on the CPU, counted as the reference counts it
    (`tests/test_obs.py::test_no_sink_overhead_under_one_percent`, here
    `obs.perf.telemetry_cost`): every counter, gauge, histogram, span and
    region range one call makes, times each primitive's microbenchmarked
    cost, against the call's wall time; not an A/B of wall clocks. And it
    is counted per batch, never per input."""
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.utils import blockgen as B

    items, _bad = B.mixed_items(8, seed=11, corrupt_rate=0.0)
    wide, _bad = B.mixed_items(32, seed=12, corrupt_rate=0.0)
    verifier = TorchSecpVerifier(device="cpu")

    def run(batch=items):
        res = verify_batch(batch, verifier=verifier,
                           sig_cache=SigCache(cache_label="obs-ovh"),
                           script_cache=ScriptExecutionCache(cache_label="obs-ovh-s"))
        assert all(r.ok for r in res)

    run()
    events, estimated = TP.telemetry_cost(run)
    # Four times the inputs (one dispatch either way) make the same events,
    # give or take a label's first use. A per-input counter or span would
    # add 24.
    per_wide, _ = TP.telemetry_cost(lambda: run(wide))
    assert sum(abs(per_wide[k] - events[k]) for k in events) <= 4, (events, per_wide)

    wall = min(_timed(run) for _ in range(3))
    assert events["counter"] > 0 and events["hist"] > 0 and events["span"] > 0
    assert events["region"] >= 2  # a dispatch and a settle, at least
    assert estimated < 0.01 * wall, (
        f"telemetry estimate {estimated * 1e6:.0f}us exceeds 1% of "
        f"verify_batch wall {wall * 1e3:.2f}ms (events={events})")
