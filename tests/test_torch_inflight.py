"""The port's in-flight queue (`resilience/inflight.py`) on the CPU.

The queue's cases mirror the reference's `tests/test_inflight.py` and
`tests/test_resilience.py`, each test naming the one it mirrors; the
reference's host containment (a ticket whose retries are spent lands on the
host oracle) becomes `DispatchFailed` in the port, which has no host rung.
The queue is driven through stub callbacks; the reference's queue, given
the same stub, makes the same launches. Then the verifier's seams on the
queue: overlapping `verify_checks_begin` / `_finish` handles, a fault
while two overlap, backpressure, and `verify_batch_stream` with tickets
settled by backpressure before their fixpoint asks for them. The CPU
verifier's plain kernel is shared as in `test_torch_resilience.py`.
"""

import numpy as np
import pytest

from bitcoinconsensus_tpu.resilience import degrade as JD
from bitcoinconsensus_tpu.resilience import guards as JG
from bitcoinconsensus_tpu.resilience import inflight as JI
from bitcoinconsensus_tpu_torch.models.batch import verify_batch, verify_batch_stream
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.resilience import faults as F
from bitcoinconsensus_tpu_torch.resilience import guards as G
from bitcoinconsensus_tpu_torch.resilience import inflight as I
from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchFailed, DispatchResilience
from bitcoinconsensus_tpu_torch.utils import blockgen as B

from test_torch_resilience import CHECKS, ORACLE, _verifier, plain_rows  # noqa: F401


class _Backend:
    """Scriptable launch / materialize pair driving a queue (the reference
    test's `_Backend`, with the port's callback signatures)."""

    def __init__(self, launch_fails=0, settle_fails=0):
        self.launches = []  # n per (re)launch
        self.settles = []   # n per clean materialize
        self.launch_fails = launch_fails
        self.settle_fails = settle_fails

    def launch(self, args, n, sset=None):
        self.launches.append(n)
        if self.launch_fails > 0:
            self.launch_fails -= 1
            raise RuntimeError("injected launch failure")
        return ("dev", n), None

    def materialize(self, ticket):
        if self.settle_fails > 0:
            self.settle_fails -= 1
            raise G.VerdictAnomaly("test.inflight", "stub")
        self.settles.append(ticket.n)
        return np.ones(ticket.n, dtype=bool), np.zeros(ticket.n, dtype=bool)


def _mk_queue(backend, max_depth=4, deadline_s=8.0, **res_kw):
    return I.InflightQueue(DispatchResilience(**res_kw), "test.inflight",
                           launch=backend.launch, materialize=backend.materialize,
                           max_depth=max_depth, deadline_s=deadline_s, backoff_s=0.0)


def test_dispatch_returns_unsettled_ticket_and_settle_is_idempotent():
    # Mirrors test_inflight.py::test_dispatch_returns_unsettled_ticket_and_settle_is_idempotent.
    be = _Backend()
    q = _mk_queue(be)
    t = q.dispatch(("args",), 5)
    assert not t.settled and q.depth == 1 and be.launches == [5]
    ok, needs = q.settle(t)
    assert t.settled and q.depth == 0 and ok.all() and not needs.any()
    again = q.settle(t)
    assert again[0] is ok and again[1] is needs and be.launches == [5]
    assert q.stats["tickets"] == 1 and not q.stats["retries"]


def test_out_of_order_settlement():
    # Mirrors test_inflight.py::test_out_of_order_settlement.
    be = _Backend()
    q = _mk_queue(be)
    tickets = [q.dispatch(("a",), n) for n in (3, 4, 5)]
    assert q.depth == 3
    for t in reversed(tickets):
        ok, _needs = q.settle(t)
        assert ok.shape == (t.n,) and ok.all()
    assert q.depth == 0 and be.settles == [5, 4, 3]


def test_backpressure_settles_oldest_first():
    # Mirrors test_inflight.py::test_backpressure_settles_oldest_first.
    be = _Backend()
    q = _mk_queue(be, max_depth=2)
    t0, t1, t2 = (q.dispatch(("a",), n) for n in (1, 2, 3))
    assert t0.settled and not t1.settled and not t2.settled and q.depth == 2
    assert q.stats["backpressure"] == 1 and be.settles == [1]
    assert q.settle(t0)[0].shape == (1,)  # its owner gets the cached outcome
    q.settle(t2)
    q.settle(t1)
    assert q.depth == 0 and be.settles == [1, 3, 2]


def test_deadline_expired_mid_queue_raises_without_retry():
    # Mirrors test_inflight.py::test_deadline_expiry_mid_queue_contains_without_retry
    # (the reference's host containment is DispatchFailed here).
    be = _Backend(settle_fails=99)
    q = _mk_queue(be, deadline_s=0.0)
    tickets = [q.dispatch(("a",), 7), q.dispatch(("a",), 9)]
    for t in tickets:
        with pytest.raises(DispatchFailed) as e:
            q.settle(t)
        assert isinstance(e.value.__cause__, G.VerdictAnomaly)
        assert t.attempts == 1  # an expired deadline forbids retries
    assert q.stats["deadline_expired"] == 2 and be.launches == [7, 9]


def test_settle_retries_transient_failure_then_succeeds():
    # Mirrors test_inflight.py::test_settle_retries_transient_failure_then_succeeds.
    be = _Backend(settle_fails=1)
    q = _mk_queue(be)
    t = q.dispatch(("a",), 4)
    ok, _needs = q.settle(t)
    assert ok.all() and t.attempts == 2 and be.launches == [4, 4]
    assert q.stats["retries"] == 1 and q.stats["guard_anomalies"] == 1


def test_launch_exception_is_a_settle_failure():
    # Mirrors test_inflight.py::test_launch_exception_is_a_settle_failure.
    be = _Backend(launch_fails=1)
    q = _mk_queue(be)
    t = q.dispatch(("a",), 4)
    assert t.error is not None  # kept, not raised, at dispatch
    ok, _needs = q.settle(t)
    assert ok.all() and t.attempts == 2


def test_persistent_corruption_raises_dispatch_failed():
    # Mirrors test_resilience.py::test_persistent_corruption_quarantines_to_host.
    be = _Backend(settle_fails=99)
    q = _mk_queue(be)
    t = q.dispatch(("a",), 6)
    with pytest.raises(DispatchFailed) as e:
        q.settle(t)
    with pytest.raises(DispatchFailed) as again:
        q.settle(t)
    assert again.value is e.value and t.attempts == 4 and len(be.launches) == 4
    assert t.args is None and t.result is None  # the staged buffers released


def test_persistent_dispatch_exception_raises_dispatch_failed():
    # Mirrors test_resilience.py::test_persistent_dispatch_exception_lands_on_host.
    be = _Backend(launch_fails=10**6)
    q = _mk_queue(be, max_retries=1)
    with pytest.raises(DispatchFailed) as e:
        q.settle(q.dispatch(("a",), 5))
    assert str(e.value.__cause__) == "injected launch failure"
    assert be.launches == [5, 5] and not be.settles


def test_backpressure_keeps_a_failure_for_its_owner():
    # The port's own case: a failure met by backpressure raises at its owner.
    be = _Backend(settle_fails=4)
    q = _mk_queue(be, max_depth=1)
    bad = q.dispatch(("a",), 2)
    good = q.dispatch(("a",), 3)  # resolves `bad` first, which fails
    assert bad.settled and not good.settled
    with pytest.raises(DispatchFailed):
        q.settle(bad)
    assert q.settle(good)[0].all()


def test_unrecoverable_error_is_not_retried():
    # A sticky CUDA error (the `.__cause__` of the DispatchFailed) ends at once.
    err = RuntimeError("vt_verify_tiles launch failed: CUDA error 700")

    class Sticky(_Backend):
        def launch(self, args, n, sset=None):
            self.launches.append(n)
            raise err

    be = Sticky()
    q = _mk_queue(be)
    with pytest.raises(DispatchFailed) as e:
        q.settle(q.dispatch(("a",), 2))
    assert e.value.__cause__ is err and be.launches == [2]
    assert I.unrecoverable(err)
    assert I.unrecoverable(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not I.unrecoverable(RuntimeError("vt_verify_tiles launch failed: CUDA error 1"))
    assert not I.unrecoverable(G.VerdictAnomaly("s", "checksum"))


def test_threads_sharing_a_queue_settle_every_ticket_once():
    """Four threads dispatch and settle on one queue of depth 2, so
    backpressure resolves other threads' tickets: none is lost or settled
    twice."""
    import threading

    be = _Backend()
    q = _mk_queue(be, max_depth=2)
    errors = []

    def work(k):
        try:
            for i in range(50):
                t = q.dispatch(("a",), 1 + (k * 50 + i) % 7)
                ok, _needs = q.settle(t)
                assert ok.shape == (t.n,)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors and q.depth == 0
    assert len(be.settles) == len(be.launches) == q.stats["tickets"] == 200


@pytest.mark.parametrize("settle_fails,launch_fails", [(1, 0), (0, 1), (99, 0), (0, 99)])
def test_launch_sequence_equals_the_reference_queue(settle_fails, launch_fails):
    """The reference's queue, with a ladder that never demotes, relaunches
    as often as the port's under the same failures: the retry budget alone
    decides."""

    class RefBackend(_Backend):
        def launch(self, args, n, level, sset=None):
            return super().launch(args, n, sset)

        def materialize(self, ticket):
            if self.settle_fails > 0:
                self.settle_fails -= 1
                raise JG.VerdictAnomaly("test.inflight", "stub")
            return super().materialize(ticket) + (None,)

    port_be, ref_be = _Backend(launch_fails, settle_fails), RefBackend(launch_fails,
                                                                       settle_fails)
    q = _mk_queue(port_be)
    rq = JI.InflightQueue(JD.DispatchResilience(("stub", "host"), "t", demote_after=99),
                          "test.inflight", launch=ref_be.launch,
                          materialize=ref_be.materialize, backoff_s=0.0)
    rt = rq.dispatch(("a",), 4)
    ref_out = rq.settle(rt)
    pt = q.dispatch(("a",), 4)
    try:
        port_out = q.settle(pt)
    except DispatchFailed:
        port_out = None
    assert port_be.launches == ref_be.launches and pt.attempts == rt.attempts
    assert (port_out is None) == (ref_out is None)  # None: the reference's host


def test_settle_array_copies_to_the_host():
    import torch

    t = torch.arange(5)
    assert I.settle_array(t).tolist() == [0, 1, 2, 3, 4]
    assert I.settle_array([1, 2]).tolist() == [1, 2]


# -- the verifier's seams on the queue ---------------------------------------------------


def test_begin_finish_overlap_matches_oracle():
    # Mirrors test_inflight.py::test_begin_finish_overlap_matches_oracle.
    v = _verifier()
    h1 = v.verify_checks_begin(CHECKS)
    h2 = v.verify_checks_begin(CHECKS)
    assert v.in_flight == 2
    assert np.array_equal(v.verify_checks_finish(h1), ORACLE)
    assert np.array_equal(v.verify_checks_finish(h2), ORACLE)
    assert v.in_flight == 0


def test_begin_finish_out_of_order():
    # Mirrors test_inflight.py::test_begin_finish_out_of_order.
    v = _verifier()
    h1 = v.verify_checks_begin(CHECKS[:6])
    h2 = v.verify_checks_begin(CHECKS[:6])
    assert np.array_equal(v.verify_checks_finish(h2), ORACLE[:6])
    assert np.array_equal(v.verify_checks_finish(h1), ORACLE[:6])
    assert np.array_equal(v.verify_checks_finish(h1), ORACLE[:6])  # settled again


@pytest.mark.parametrize("site,kind", [("torch_backend.verdict", "flip"),
                                       ("torch_backend.verdict", "garbage"),
                                       ("torch_backend.dispatch", "raise")])
def test_overlap_with_a_fault_stays_bit_identical(site, kind):
    # Mirrors test_inflight.py::test_overlap_with_flip_fault_stays_bit_identical.
    v = _verifier()
    with F.inject(F.FaultPlan([F.FaultSpec(site, kind)]), seed=11) as inj:
        h1 = v.verify_checks_begin(CHECKS)
        h2 = v.verify_checks_begin(CHECKS)
        out1 = v.verify_checks_finish(h1)
        out2 = v.verify_checks_finish(h2)
    assert inj.total_fired() == 1
    assert np.array_equal(out1, ORACLE) and np.array_equal(out2, ORACLE)


def test_backpressure_bounds_depth_under_many_begins(monkeypatch):
    # Mirrors test_inflight.py::test_backpressure_bounds_depth_under_many_begins.
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_INFLIGHT_DEPTH", "2")
    v = _verifier()
    handles = [v.verify_checks_begin(CHECKS[:3]) for _ in range(6)]
    assert v.in_flight == 2 and v.stats["backpressure"] == 4
    for h in handles:
        assert np.array_equal(v.verify_checks_finish(h), ORACLE[:3])


def test_stream_with_tickets_settled_by_backpressure(monkeypatch):
    """`verify_batch_stream` at depth 2 over a queue of depth 1: each new
    dispatch settles the one before it, so a fixpoint's own settle returns
    the cached outcome; every batch equals `verify_batch` alone."""
    items, _bad = B.mixed_items(12, seed=92, corrupt_rate=0.25)
    batches = [items[:4], items[4:8], items[8:]]
    want = [verify_batch(b, verifier=_verifier(), sig_cache=SigCache(),
                         script_cache=ScriptExecutionCache()) for b in batches]
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_INFLIGHT_DEPTH", "1")
    v = _verifier()
    got = list(verify_batch_stream(iter(batches), verifier=v, sig_cache=SigCache(),
                                   script_cache=ScriptExecutionCache(), depth=2))
    assert got == want and v.in_flight == 0
    assert v.stats["backpressure"] >= 1 and v.stats["tickets"] >= 3


# -- the verdict accounting hook and drain -------------------------------------------------


class _AllOkBackend(_Backend):
    """A materialize that also returns the sharded step's `all_ok`."""

    def materialize(self, ticket):
        return super().materialize(ticket) + (True,)


def _hooked_queue(backend, seen):
    return I.InflightQueue(DispatchResilience(), "test.inflight", launch=backend.launch,
                           materialize=backend.materialize, backoff_s=0.0,
                           on_device=lambda t, ok, needs, all_ok: seen.append(
                               (t.n, all_ok, len(ok), len(needs))))


def test_on_device_hook_runs_once_per_clean_settle():
    seen = []
    be = _AllOkBackend(settle_fails=1)
    q = _hooked_queue(be, seen)
    t = q.dispatch(("a",), 3)
    ok, needs = q.settle(t)
    q.settle(t)  # idempotent: no second call
    assert seen == [(3, True, 3, 3)] and be.launches == [3, 3]
    assert len(ok) == len(needs) == 3
    seen2 = []
    q2 = _hooked_queue(_Backend(), seen2)  # a two-value materialize: all_ok None
    q2.settle(q2.dispatch(("a",), 4))
    assert seen2 == [(4, None, 4, 4)]
    seen3 = []
    q3 = _hooked_queue(_Backend(settle_fails=99), seen3)
    with pytest.raises(DispatchFailed):
        q3.settle(q3.dispatch(("a",), 2))
    assert seen3 == []  # a ticket that never settles clean is never counted


def test_drain_settles_every_ticket_in_flight():
    be = _Backend()
    q = _mk_queue(be)
    tickets = [q.dispatch(("a",), n) for n in (3, 4, 5)]
    q.drain()
    assert q.depth == 0 and all(t.settled for t in tickets) and be.settles == [3, 4, 5]
    q.drain()  # nothing left: a no-op
    bad = _Backend(settle_fails=99)
    qb = _mk_queue(bad)
    t = qb.dispatch(("a",), 2)
    qb.drain()  # keeps the failure on the ticket for its owner
    assert qb.depth == 0 and t.settled
    with pytest.raises(DispatchFailed):
        qb.settle(t)
