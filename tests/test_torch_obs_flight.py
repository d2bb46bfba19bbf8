"""The port's flight recorder against the reference's: ring bound and
eviction, span subscription, dumps with redaction and metric deltas, the
per-process dump cap and the disarmed cost; and its sites in the port's
guards and in-flight queue: a checksum mismatch injected through the port's
fault harness triggers one dump, whose records are of the reference's
kinds.

Each case of `tests/test_obs_flight.py` with a torch meaning runs once per
package (`pkg`). The reference's ladder-demotion case has no counterpart
(the port has no ladder); the port's queue records an expired deadline
where the reference's does.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu.obs import flight as JF
from bitcoinconsensus_tpu.obs import get_registry as j_registry
from bitcoinconsensus_tpu.obs import span as j_span
from bitcoinconsensus_tpu.resilience import guards as JG
from bitcoinconsensus_tpu_torch.obs import flight as TF
from bitcoinconsensus_tpu_torch.obs import get_registry as t_registry
from bitcoinconsensus_tpu_torch.obs import span as t_span

torch.set_num_threads(1)

PKGS = {"ref": (JF, j_registry, j_span), "port": (TF, t_registry, t_span)}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    F, reg, span = PKGS[request.param]
    F.set_enabled(False)
    F.reset()
    yield F, reg, span
    F.set_enabled(False)
    F.reset()


@pytest.fixture(autouse=True)
def _disarmed_port():
    """No test leaves either recorder armed."""
    yield
    for F in (JF, TF):
        F.set_enabled(False)
        F.reset()


def _events_count(reg, kind):
    return reg().get("consensus_flight_events_total").value(kind=kind)


def test_disarmed_record_is_noop(pkg):
    F, reg, _span = pkg
    before = _events_count(reg, "noop-test")
    F.record("noop-test", detail="dropped")
    assert F.events() == [] and not F.enabled()
    assert _events_count(reg, "noop-test") == before


def test_ring_bound_and_eviction_order(pkg):
    F, _reg, _span = pkg
    F.set_enabled(True)
    extra = 50
    for i in range(F.CAPACITY + extra):
        F.record("tick", i=i)
    evs = F.events()
    assert len(evs) == F.CAPACITY and F.dropped() == extra
    assert evs[0]["i"] == extra and evs[-1]["i"] == F.CAPACITY + extra - 1
    assert all(a["t"] <= b["t"] for a, b in zip(evs, evs[1:]))


def test_armed_gauge_and_event_counter(pkg):
    F, reg, _span = pkg
    assert reg().snapshot()["consensus_flight_armed"]["samples"][0]["value"] == 0
    F.set_enabled(True)
    assert reg().snapshot()["consensus_flight_armed"]["samples"][0]["value"] == 1
    before = _events_count(reg, "counted")
    F.record("counted")
    F.record("counted")
    assert _events_count(reg, "counted") == before + 2


def test_span_subscription_attaches_and_detaches(pkg):
    F, _reg, span = pkg
    F.set_enabled(True)
    with span("flight.test.sub"):
        pass
    assert ("span", "flight.test.sub") in [(e["kind"], e.get("name")) for e in F.events()]
    F.set_enabled(False)
    F.reset()
    with span("flight.test.after"):
        pass
    assert F.events() == []


def test_trigger_dump_contents_and_redaction(pkg, tmp_path):
    F, reg, span = pkg
    F.set_enabled(True)
    F.record("guard.anomaly", site="torch_backend.verdict", reason="checksum",
             pubkey=b"\x02" * 33, detail="mismatch")
    F.record("inflight.deadline_expired", site="torch_backend", attempts=2)
    with span("flight.test.window"):
        pass
    path = F.trigger("checksum", out_dir=str(tmp_path), script_sig=b"\x51\x51",
                     site="torch_backend")
    assert path is not None and os.path.basename(path).startswith("flight_dump_checksum_")
    doc = json.loads(open(path).read())
    assert doc["schema"] == F.SCHEMA == "consensus-flight-v1"
    assert doc["trigger"] == "checksum" and "platform" in doc["provenance"]
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds.index("guard.anomaly") < kinds.index("inflight.deadline_expired")
    assert "span" in kinds and doc["events_dropped"] == 0
    anomaly = doc["events"][kinds.index("guard.anomaly")]
    assert anomaly["pubkey"] == "<redacted:33>" and anomaly["detail"] == "mismatch"
    assert doc["attrs"] == {"script_sig": "<redacted:2>", "site": "torch_backend"}
    assert isinstance(doc["metric_deltas"], list)
    assert reg().get("consensus_flight_dumps_total").value(trigger="checksum") >= 1


def test_redaction_recurses_and_handles_bytes(pkg):
    F, _reg, _span = pkg
    red = F._redact({"msg32": b"\x00" * 32,
                     "nested": {"witness": ["a", "b"], "depth": 2},
                     "blob": b"\x01\x02", "note": "fine"})
    assert red == {"msg32": "<redacted:32>",
                   "nested": {"witness": "<redacted:2>", "depth": 2},
                   "blob": "<bytes:2>", "note": "fine"}


def test_trigger_disarmed_returns_none(pkg, tmp_path):
    F, _reg, _span = pkg
    assert F.trigger("cli", out_dir=str(tmp_path)) is None
    assert list(tmp_path.iterdir()) == []


def test_dump_cap_is_per_process(pkg, tmp_path, monkeypatch):
    F, _reg, _span = pkg
    F.set_enabled(True)
    monkeypatch.setattr(F, "MAX_DUMPS", 2)
    F.record("one")
    assert F.trigger("cap", out_dir=str(tmp_path)) is not None
    assert F.trigger("cap", out_dir=str(tmp_path)) is not None
    assert F.trigger("cap", out_dir=str(tmp_path)) is None
    F.reset()
    assert F.trigger("cap", out_dir=str(tmp_path)) is not None


def test_trigger_unwritable_dir_fails_closed(pkg):
    F, _reg, _span = pkg
    F.set_enabled(True)
    F.record("ev")
    assert F.trigger("cli", out_dir="/proc/no-such-dir/flight") is None


def test_default_dump_dir_is_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("BITCOINCONSENSUS_TPU_FLIGHT_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert TF._dump_dir() == os.path.join(repo, "build", "flight")
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_FLIGHT_DIR", "/elsewhere")
    assert TF._dump_dir() == "/elsewhere"


def test_disarmed_overhead_under_one_percent():
    """The disarmed `record()` hook, priced by microbenchmark, costs under
    1% of a small port `verify_batch` on the CPU for 64 records a batch, far
    beyond any real path (the reference's accounting)."""
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.utils import blockgen as B

    items, _bad = B.mixed_items(8, seed=12, corrupt_rate=0.0)
    v = TorchSecpVerifier(device="cpu")

    def run():
        res = verify_batch(items, verifier=v, sig_cache=SigCache(cache_label="flight-ovh"),
                           script_cache=ScriptExecutionCache(cache_label="flight-ovh-s"))
        assert all(r.ok for r in res)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    assert not TF.enabled()
    wall = min(timed(run) for _ in range(2))
    reps = 100_000
    per_record = timed(lambda: [TF.record("x", a=1) for _ in range(reps)]) / reps
    assert 64 * per_record < 0.01 * wall, (per_record, wall)


# -- the port's sites ---------------------------------------------------------------------


def _checks():
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck
    from bitcoinconsensus_tpu_torch.utils import blockgen as B
    import hashlib

    out = []
    for i in range(12):
        sk = B._sk(f"flight/{i}")
        msg = hashlib.sha256(b"flight-%d" % i).digest()
        out.append(SigCheck("ecdsa", (B.pubkey_create(sk), B.sign_ecdsa(sk, msg), msg)))
    return out


def test_injected_checksum_mismatch_dumps_once_with_the_reference_kinds(tmp_path, monkeypatch):
    """A lane flipped by the port's fault harness where no sentinel sits: the
    sentinels pass, the device checksum does not; the guard records the
    anomaly and triggers one `checksum` dump, and the retry gives the clean
    verdicts. The reference's guard, fed the same mismatch, dumps records of
    the same kinds."""
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.resilience import faults as F

    monkeypatch.setenv("BITCOINCONSENSUS_TPU_FLIGHT_DIR", str(tmp_path / "port"))
    v = TorchSecpVerifier(device="cpu")
    checks = _checks()
    clean = v.verify_checks(checks)
    TF.set_enabled(True)
    TF.reset()
    # Seed 1 flips lane 4 of the 16 padded lanes: a real lane (the
    # sentinels sit in rows 12-15), which only the checksum can catch.
    with F.inject(F.FaultPlan([F.FaultSpec("torch_backend.verdict", "flip")]), seed=1):
        got = v.verify_checks(checks)
    assert np.array_equal(got, clean) and clean.all() and v.stats["retries"] == 1
    dumps = sorted(os.listdir(tmp_path / "port"))
    assert len(dumps) == 1 and dumps[0].startswith("flight_dump_checksum_")
    port = json.load(open(tmp_path / "port" / dumps[0]))
    anomalies = [e for e in port["events"] if e["kind"] == "guard.anomaly"]
    assert [(e["site"], e["reason"]) for e in anomalies] == [("torch_backend", "checksum")]

    JF.set_enabled(True)
    JF.reset()
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_FLIGHT_DIR", str(tmp_path / "ref"))
    os.makedirs(tmp_path / "ref")
    ok = np.ones(16, dtype=bool)
    with pytest.raises(JG.VerdictAnomaly):
        JG.check_checksum((15, 0), ok, "torch_backend")
    (ref_dump,) = os.listdir(tmp_path / "ref")
    ref = json.load(open(tmp_path / "ref" / ref_dump))
    assert set(port) == set(ref)
    assert port["trigger"] == ref["trigger"] == "checksum"
    non_span = lambda d: {e["kind"] for e in d["events"] if e["kind"] != "span"}  # noqa: E731
    assert non_span(port) == non_span(ref) == {"guard.anomaly"}
    ref_anomaly = [e for e in ref["events"] if e["kind"] == "guard.anomaly"][0]
    assert set(anomalies[0]) == set(ref_anomaly)
    assert port["attrs"].keys() == ref["attrs"].keys() == {"site", "detail"}


def test_expired_deadline_is_recorded_while_armed():
    from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchFailed, DispatchResilience
    from bitcoinconsensus_tpu_torch.resilience.inflight import InflightQueue

    def bad(ticket):
        raise RuntimeError("never clean")

    q = InflightQueue(DispatchResilience(), "flight-test",
                      launch=lambda args, n, sset: (None, None), materialize=bad,
                      deadline_s=0.0, backoff_s=0.0)
    TF.set_enabled(True)
    t = q.dispatch(("args",), 4)
    with pytest.raises(DispatchFailed):
        q.settle(t)
    kinds = [e["kind"] for e in TF.events()]
    assert "inflight.deadline_expired" in kinds
    ev = TF.events()[kinds.index("inflight.deadline_expired")]
    assert ev["site"] == "flight-test" and ev["attempts"] == 1
    assert t_registry().get("consensus_inflight_deadline_expired_total").value(
        site="flight-test") >= 1
