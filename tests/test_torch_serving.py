"""The port's serving front end (`serving/queue.py`, `shedding.py`,
`server.py`, `client.verify_with_retry`) on the CPU, held against the JAX
package's.

- the queue, the SLO tracker, admission, the retry loop and the pending
  future: each case runs on both packages (`pkg`), and the cross-package
  cases hold the port's outputs equal to the reference's on the same
  inputs: pop order, admission decisions at each ladder rung (the
  reference's `Ladder` parked on the rung, the port with a duck-typed
  stub, since the port has no ladder) and the retry loop's backoff draws;
- the server over the port's `TorchSecpVerifier(device="cpu")`: 64 mixed
  items from 3 tenants, verdicts equal to the JAX package's per-input API
  and to the port's `verify_batch`; explicit sheds (`ERR_OVERLOADED`);
  a `DispatchFailed` failing its burst's requests while the worker serves
  on; the settle span stitched to its submit span; `VerifyServer()` on
  cuda:0 raising without a card.

The plain kernel runs through `PlainRows` (each distinct lane row once).
"""

import random
import threading
import types

import pytest
import torch

from torch_serving_common import mixed_items, norm, patch_plain_rows, reference

from bitcoinconsensus_tpu import serving as JS
from bitcoinconsensus_tpu.resilience.degrade import Ladder
from bitcoinconsensus_tpu.serving import client as JCLIENT
from bitcoinconsensus_tpu_torch import serving as TS
from bitcoinconsensus_tpu_torch.api import ConsensusError, Error
from bitcoinconsensus_tpu_torch.crypto import torch_backend as TBK
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.batch import verify_batch
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.obs import add_sink, remove_sink
from bitcoinconsensus_tpu_torch.resilience import FaultPlan, FaultSpec, inject
from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchFailed
from bitcoinconsensus_tpu_torch.serving import client as TCLIENT
from bitcoinconsensus_tpu_torch.serving import server as TSERVER

PKGS = {"jax_package": JS, "port": TS}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _entry(tenant, enqueued=0.0):
    return types.SimpleNamespace(tenant=tenant, enqueued=enqueued)


# -- the queue ---------------------------------------------------------------


def test_queue_pop_is_round_robin_fair(pkg):
    q = pkg.CoalescingQueue(tenant_depth=16)
    for i in range(6):
        q.put(_entry("heavy", i))
    q.put(_entry("light", 0))
    got = [e.tenant for e in q.take(4, flush_s=0.0, block=False)]
    assert got == ["heavy", "light", "heavy", "heavy"]


def test_queue_tenant_depth_bound(pkg):
    q = pkg.CoalescingQueue(tenant_depth=2)
    q.put(_entry("a"))
    q.put(_entry("a"))
    with pytest.raises(pkg.TenantQueueFull):
        q.put(_entry("a"))
    q.put(_entry("b"))
    assert q.depth("a") == 2 and q.total == 3


def test_queue_size_and_time_triggers(pkg):
    clock = [0.0]
    q = pkg.CoalescingQueue(tenant_depth=8, clock=lambda: clock[0])
    for i in range(3):
        q.put(_entry("t", 0.0))
    assert len(q.take(3, flush_s=100.0)) == 3  # size trigger, no wait
    q.put(_entry("t", 0.0))
    clock[0] = 5.0  # the oldest entry is older than flush_s
    assert len(q.take(8, flush_s=1.0)) == 1
    assert q.take(8, flush_s=1.0, block=False) is None


def test_queue_close_drains_then_none_and_cancel_all(pkg):
    q = pkg.CoalescingQueue(tenant_depth=8)
    q.put(_entry("a"))
    q.close()
    with pytest.raises(pkg.QueueClosed):
        q.put(_entry("a"))
    assert len(q.take(8, flush_s=100.0)) == 1
    assert q.take(8, flush_s=100.0) is None
    q2 = pkg.CoalescingQueue(tenant_depth=8)
    for t in ("a", "b", "a"):
        q2.put(_entry(t))
    assert len(q2.cancel_all()) == 3 and q2.total == 0


def test_queue_pop_order_equals_the_reference():
    rng = random.Random(7)
    ops = [("put", f"t{rng.randrange(4)}") if rng.random() < 0.7
           else ("take", rng.randrange(1, 6)) for _ in range(200)]

    def run(mod):
        q = mod.CoalescingQueue(tenant_depth=6)
        out = []
        for i, (op, arg) in enumerate(ops):
            if op == "put":
                try:
                    q.put(types.SimpleNamespace(tenant=arg, enqueued=0.0, n=i))
                    out.append(("ok", i))
                except mod.TenantQueueFull:
                    out.append(("full", i))
            else:
                got = q.take(arg, flush_s=0.0, block=False)
                out.append(None if got is None else [e.n for e in got])
        return out

    assert run(TS) == run(JS)


# -- SLO tracking and admission -----------------------------------------------


def test_slo_tracker_window_ages_out_slow_tail(pkg):
    slo = pkg.SloTracker(window=4)
    assert slo.quantile(0.99) is None
    slo.observe(9.0)
    for _ in range(4):
        slo.observe(0.01)
    assert slo.quantile(0.99) == 0.01
    with pytest.raises(ValueError):
        slo.quantile(0.0)


def test_admission_cold_start_empty_backlog_and_shed(pkg):
    slo = pkg.SloTracker(window=16)
    adm = pkg.AdmissionController(1.0, batch_capacity=8, slo=slo)
    assert adm.admit(100) is None  # cold start: no evidence to shed on
    for _ in range(8):
        slo.observe(0.4)
    assert adm.admit(8) is None  # 2 batches * 0.4 <= 1.0
    assert adm.admit(24) == pkg.SHED_SLO  # 4 batches * 0.4 > 1.0
    assert adm.admit(0) is None  # an empty backlog always admits
    with pytest.raises(ValueError):
        pkg.AdmissionController(0, batch_capacity=8, slo=slo)


@pytest.mark.parametrize("rung", [0, 1, 2])
def test_admission_decisions_equal_the_reference_at_each_rung(rung):
    """The reference's `Ladder` parked on `rung` against a duck-typed stub
    of the same `levels` and `current` in the port: the same decisions over
    a grid of latencies and backlogs."""
    levels = ("pallas", "xla", "host")
    ladder = Ladder(levels, f"torch-serving-rung{rung}")
    ladder._idx = rung
    stub = types.SimpleNamespace(levels=levels, current=levels[rung])
    rng = random.Random(rung)
    lat = [rng.choice((0.01, 0.05, 0.2, 0.4, 0.9)) for _ in range(40)]
    out = {}
    for name, mod, lad in (("ref", JS, ladder), ("port", TS, stub)):
        slo = mod.SloTracker(window=16)
        adm = mod.AdmissionController(1.2, batch_capacity=8, slo=slo, ladder=lad)
        got = [adm.ladder_rung(), adm.deadline_budget_s()]
        for x in lat:
            slo.observe(x)
            got.append([adm.admit(b) for b in (0, 1, 7, 8, 15, 16, 40)])
        out[name] = got
    assert out["port"] == out["ref"]
    assert out["port"][0] == rung


def test_port_server_admits_at_rung_zero():
    v = TorchSecpVerifier(device="cpu")
    srv = TS.VerifyServer(verifier=v, sig_cache=SigCache(),
                          script_cache=ScriptExecutionCache())
    assert srv.admission.ladder_rung() == 0
    assert srv.max_batch == v.lane_capacity
    srv.close()


# -- the retry loop and the pending future ------------------------------------


class _StubPending:
    def __init__(self, res):
        self.res = res

    def result(self, timeout=None):
        return self.res


class _StubServer:
    def __init__(self, mod, sheds, res="done"):
        self.mod, self.sheds, self.res, self.calls = mod, sheds, res, 0

    def submit(self, item, tenant):
        self.calls += 1
        if self.calls <= self.sheds:
            raise self.mod.OverloadError("slo")
        return _StubPending(self.res)


@pytest.mark.parametrize("sheds", [0, 2, 4, 5])
def test_retry_backoff_draws_equal_the_reference(monkeypatch, sheds):
    """Same seed, same sheds: the same delays slept, the same outcome."""
    out = {}
    for name, mod, cmod in (("ref", JS, JCLIENT), ("port", TS, TCLIENT)):
        slept = []
        monkeypatch.setattr(cmod.time, "sleep", slept.append)
        srv = _StubServer(mod, sheds)
        try:
            got = mod.verify_with_retry(srv, None, retries=4, rng=random.Random(11))
        except mod.OverloadError as e:
            got = ("shed", e.reason, int(e.code))
        out[name] = (got, slept, srv.calls)
    assert out["port"] == out["ref"]
    assert (out["port"][0][0] == "shed") == (sheds > 4)


def test_retry_non_shed_errors_propagate(pkg):
    class Boom:
        def submit(self, item, tenant):
            raise ValueError("not a shed")

    with pytest.raises(ValueError):
        pkg.verify_with_retry(Boom(), None, rng=random.Random(0))


def test_pending_done_callback_runs_once_and_contains_errors(pkg):
    p = pkg.PendingVerify(None, "t", 0.0)
    seen = []
    p.add_done_callback(lambda r: seen.append("a"))
    p.add_done_callback(lambda r: 1 / 0)  # contained
    p._resolve("x")
    p._resolve("y")  # first settlement wins
    p.add_done_callback(lambda r: seen.append("late"))
    assert seen == ["a", "late"] and p.result(0) == "x"
    with pytest.raises(TimeoutError):
        pkg.PendingVerify(None, "t", 0.0).result(timeout=0.01)


# -- the server over the port's verifier on the CPU ----------------------------


@pytest.fixture(scope="module")
def plain():
    with pytest.MonkeyPatch.context() as mp:
        yield patch_plain_rows(mp)


@pytest.fixture(scope="module")
def verifier(plain):
    return TorchSecpVerifier(device="cpu")


def _server(verifier, **kw):
    kw.setdefault("sig_cache", SigCache())
    kw.setdefault("script_cache", ScriptExecutionCache())
    return TS.VerifyServer(verifier=verifier, **kw)


def test_server_verdicts_equal_the_jax_api_and_verify_batch(verifier):
    items, bad = mixed_items(64, seed=3)
    assert 0 < sum(bad) < len(items)
    tenants = [f"tenant{i % 3}" for i in range(len(items))]
    with _server(verifier, max_batch=64, flush_s=5.0, tenant_depth=64) as srv:
        pend = [srv.submit(it, tenant=t) for it, t in zip(items, tenants)]
        got = [p.result(timeout=120) for p in pend]
    assert srv.pending == 0
    assert norm(got) == [reference(it) for it in items]
    direct = verify_batch(items, verifier=verifier, sig_cache=SigCache(),
                          script_cache=ScriptExecutionCache())
    assert norm(got) == norm(direct)


def test_server_sheds_explicitly_and_drains(verifier):
    items, _ = mixed_items(64, seed=3)
    srv = _server(verifier, max_batch=64, flush_s=30.0, tenant_depth=1).start()
    queued = srv.submit(items[0], tenant="a")
    with pytest.raises(TS.OverloadError) as ei:
        srv.submit(items[1], tenant="a")
    assert ei.value.code == Error.ERR_OVERLOADED == 7
    assert ei.value.reason == TS.SHED_TENANT_FULL
    assert isinstance(ei.value, ConsensusError)
    srv.close(drain=True)
    assert norm([queued.result(timeout=60)]) == [reference(items[0])]
    assert srv.pending == 0
    with pytest.raises(TS.OverloadError) as ei:
        srv.submit(items[0])
    assert ei.value.reason == TS.SHED_CLOSED


def test_server_nondrain_close_cancels_explicitly(verifier):
    items, _ = mixed_items(64, seed=3)
    srv = _server(verifier, max_batch=64, flush_s=30.0).start()
    p = srv.submit(items[0])
    srv.close(drain=False)
    with pytest.raises(TS.OverloadError) as ei:
        p.result(timeout=10)
    assert ei.value.reason == TS.SHED_CLOSED and srv.pending == 0


def test_dispatch_failed_fails_its_burst_and_the_worker_serves_on(verifier):
    """A dispatch whose retries are spent raises `DispatchFailed` out of the
    stream: that burst's requests fail with it, explicitly; no request is
    left unsettled, none is a wrong ACCEPT, and the next burst is served."""
    items, _ = mixed_items(64, seed=3)
    batch = items[:12]
    with _server(verifier, max_batch=12, flush_s=5.0) as srv:
        with inject(FaultPlan([FaultSpec("torch_backend.dispatch", "raise",
                                         count=64)]), seed=0):
            pend = [srv.submit(it, tenant=f"t{i % 3}") for i, it in enumerate(batch)]
            outcomes = []
            for p in pend:
                try:
                    outcomes.append(p.result(timeout=60))
                except DispatchFailed as e:
                    outcomes.append(e)
        assert all(isinstance(o, DispatchFailed) for o in outcomes)
        assert srv.pending == 0
        pend = [srv.submit(it, tenant=f"t{i % 3}") for i, it in enumerate(batch)]
        got = [p.result(timeout=120) for p in pend]
    assert norm(got) == [reference(it) for it in batch]


def test_worker_exception_fails_requests_explicitly(verifier, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("driver crashed")
        yield  # pragma: no cover

    monkeypatch.setattr(TSERVER, "verify_batch_stream", boom)
    items, _ = mixed_items(64, seed=3)
    with _server(verifier, max_batch=2, flush_s=0.001) as srv:
        p = srv.submit(items[0])
        with pytest.raises(RuntimeError, match="driver crashed"):
            p.result(timeout=30)
        q = srv.submit(items[1])  # the worker serves on
        with pytest.raises(RuntimeError):
            q.result(timeout=30)


def test_settle_span_parents_to_submit_span_across_threads(verifier):
    class Sink:
        def __init__(self):
            self.records = []
            self.lock = threading.Lock()

        def write(self, rec):
            with self.lock:
                self.records.append(rec)

    items, _ = mixed_items(64, seed=3)
    sink = Sink()
    add_sink(sink)
    try:
        with _server(verifier, max_batch=2, flush_s=0.001) as srv:
            srv.verify(items[0], tenant="stitch", timeout=120)
    finally:
        remove_sink(sink)
    subs = [r for r in sink.records if r["name"] == "serving.submit"]
    sets = [r for r in sink.records if r["name"] == "serving.settle"]
    assert len(subs) == 1 and len(sets) == 1
    assert sets[0]["parent_id"] == subs[0]["span_id"]
    assert sets[0]["trace"] == subs[0]["trace"]


def test_default_server_runs_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(TBK, "_default", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.VerifyServer()
