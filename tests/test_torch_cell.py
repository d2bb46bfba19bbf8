"""The port's serving cell (`cell/`) on the CPU, held against the JAX
package's.

- the ring: `HashRing` points, placements and failover chains equal the
  reference's for the same members and keys;
- the sigstore tier: the reference's record, handoff, tombstone and salt
  cases on both packages; a handoff file written by either package absorbed
  by the other; the handoff chain (`hashring`, `sigtier`, `sigstore`) runs
  with CUDA's lazy initialisation made to raise, so it creates no CUDA
  context;
- the supervisor's policy on handle stubs, on both packages: eviction at
  the threshold, bounded monotone backoff, equal backoff logs;
- the router and the client's failover, on a two-stub cell of the port
  (`device="cpu"`): home routing, reroute of a sick member, an explicit
  `ERR_OVERLOADED` for a dead or missing replica, pipelined rids, typed
  protocol errors, the `cell.route` fault recovered by the retry client;
- the stub cell's kill, evict, handoff and re-promote loop on both
  packages, with the same counts and the same `consensus_cell_*` deltas;
- `device`: `StubReplica()`, `ReplicaProcess(...)` and `ServingCell()`
  mean cuda:0 and raise without a card; one `ReplicaProcess(device="cpu")`
  subprocess answers its known-answer probe pair over the wire. The
  two-subprocess kill -9 case is `slow`, as in the reference.
"""

import os
import random
import signal
import socket
import subprocess
import sys
import time
import types

import pytest
import torch

from torch_serving_common import mixed_items, patch_plain_rows

from bitcoinconsensus_tpu import cell as JC
from bitcoinconsensus_tpu import serving as JS
from bitcoinconsensus_tpu.cell import replica as JREP
from bitcoinconsensus_tpu.models import sigstore as JSS
from bitcoinconsensus_tpu.obs import get_registry as j_registry
from bitcoinconsensus_tpu_torch import cell as TC
from bitcoinconsensus_tpu_torch import serving as TS
from bitcoinconsensus_tpu_torch.cell import replica as TREP
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.batch import verify_batch
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.models import sigstore as TSS
from bitcoinconsensus_tpu_torch.obs import get_registry as t_registry
from bitcoinconsensus_tpu_torch.resilience import faults as TF
from bitcoinconsensus_tpu_torch.serving import ingress as TING

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax_package": types.SimpleNamespace(C=JC, S=JS, REP=JREP, SS=JSS, reg=j_registry,
                                         name="bitcoinconsensus_tpu"),
    "port": types.SimpleNamespace(C=TC, S=TS, REP=TREP, SS=TSS, reg=t_registry,
                                  name="bitcoinconsensus_tpu_torch"),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _keys(n, seed=0):
    return [bytes([(seed + i) % 256]) + (seed + i).to_bytes(31, "little")
            for i in range(n)]


def _dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- the ring -------------------------------------------------------------------


@pytest.mark.parametrize("members", [["r0", "r1"], ["a", "b", "c"],
                                     [f"r{i}" for i in range(7)]])
def test_ring_placements_equal_the_reference(members):
    keys = [f"tenant-{i}" for i in range(300)] + [f"shard-{i:02d}" for i in range(8)]
    j, t = JC.HashRing(members), TC.HashRing(members)
    assert t._points == j._points
    assert [t.lookup(k) for k in keys] == [j.lookup(k) for k in keys]
    assert [t.lookup_chain(k) for k in keys[:40]] == [j.lookup_chain(k) for k in keys[:40]]
    gone = members[0]
    j.remove(gone)
    t.remove(gone)
    assert [t.lookup(k) for k in keys] == [j.lookup(k) for k in keys]
    assert TC.HashRing().lookup("x") is None and TC.HashRing().lookup_chain("x") == []


def test_ring_moves_only_the_departed_members_keys():
    ring = TC.HashRing(["a", "b", "c"])
    keys = [f"k{i}" for i in range(500)]
    before = {k: ring.lookup(k) for k in keys}
    ring.remove("b")
    for k in keys:
        if before[k] != "b":
            assert ring.lookup(k) == before[k]
    ring.add("b")
    assert {k: ring.lookup(k) for k in keys} == before


def test_request_payload_tenant_peek():
    payload = TING.encode_request(0x01020304, "tenant-x", mixed_items(64, seed=3)[0][0])
    assert payload[0:4] == (0x01020304).to_bytes(4, "big")
    tlen = int.from_bytes(payload[4:6], "big")
    assert payload[6:6 + tlen] == b"tenant-x"


# -- the sigstore tier ----------------------------------------------------------


def test_iter_records_stop_at_corruption_and_handoff_is_ordered(pkg, tmp_path):
    C, SS = pkg.C, pkg.SS
    s = SS.PersistentSigCache(str(tmp_path / "src"), shards=1)
    ks = _keys(8)
    for k in ks:
        s.add_key(k)
    s.discard_key(ks[3])
    s.close()
    log = str(tmp_path / "src" / "shard-00.log")
    out = str(tmp_path / "handoff.log")
    assert C.write_handoff([log], out) == 9
    assert not os.path.exists(out + ".tmp")
    assert list(C.iter_shard_records(out)) == list(C.iter_shard_records(log))
    with open(log, "r+b") as fh:  # one byte inside record 3
        fh.seek(2 * SS._REC_LEN + 5)
        b = fh.read(1)
        fh.seek(2 * SS._REC_LEN + 5)
        fh.write(bytes([b[0] ^ 0xFF]))
    assert len(list(C.iter_shard_records(log))) == 2
    assert os.path.getsize(log) == 9 * SS._REC_LEN  # source never modified


def test_absorb_tombstone_wins_and_persists(pkg, tmp_path):
    C, SS = pkg.C, pkg.SS
    k = _keys(1, seed=7)[0]
    ks = _keys(6, seed=20)
    src = SS.PersistentSigCache(str(tmp_path / "src"), shards=1)
    for x in ks:
        src.add_key(x)
    src.add_key(k)
    src.discard_key(k)
    src.close()
    out = str(tmp_path / "handoff.log")
    C.write_handoff([str(tmp_path / "src" / "shard-00.log")], out)
    recv = SS.PersistentSigCache(str(tmp_path / "recv"), shards=2)
    recv.add_key(k)  # cached independently
    assert C.absorb_handoff(recv, out) == {"records": 8, "adds": 7, "dels": 1}
    assert not recv.peek_key(k)
    recv.close()
    recv2 = SS.PersistentSigCache(str(tmp_path / "recv"), shards=2)
    assert all(recv2.peek_key(x) for x in ks) and not recv2.peek_key(k)
    recv2.close()


def test_tier_shared_salt_and_owners(pkg, tmp_path):
    tier = pkg.C.SigTier(str(tmp_path), shards=4)
    sa = pkg.SS.PersistentSigCache(tier.join("a"))
    sb = pkg.SS.PersistentSigCache(tier.join("b"))
    assert sa._salt == sb._salt == (tmp_path / "salt").read_bytes()
    sa.close()
    sb.close()
    tier.leave("a")
    assert set(tier.owners().values()) == {"b"}


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_handoff_crosses_packages(writer, tmp_path):
    w = PKGS[writer]
    r = PKGS["port" if writer == "jax_package" else "jax_package"]
    src = w.SS.PersistentSigCache(str(tmp_path / "src"), shards=2)
    ks = _keys(40, seed=3)
    for k in ks:
        src.add_key(k)
    for k in ks[::4]:
        src.discard_key(k)
    src.close()
    logs = [str(tmp_path / "src" / f"shard-{i:02d}.log") for i in range(2)]
    out_w, out_r = str(tmp_path / "w.log"), str(tmp_path / "r.log")
    assert w.C.write_handoff(logs, out_w) == r.C.write_handoff(logs, out_r)
    assert open(out_w, "rb").read() == open(out_r, "rb").read()
    recv = r.SS.PersistentSigCache(str(tmp_path / "recv"), shards=4)
    rep = r.C.absorb_handoff(recv, out_w)
    assert rep == {"records": 50, "adds": 40, "dels": 10}
    live = [k for i, k in enumerate(ks) if i % 4]
    assert all(recv.peek_key(k) for k in live)
    assert not any(recv.peek_key(k) for k in ks[::4])
    recv.close()


def test_handoff_chain_creates_no_cuda_context(tmp_path, monkeypatch):
    """The control plane's chain (ring, tier, store, handoff, absorb) with
    CUDA's lazy initialisation made to raise: nothing on it touches the
    card."""
    def no_cuda(*a, **k):
        raise AssertionError("the handoff chain initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "init", no_cuda)
    tier = TC.SigTier(str(tmp_path / "cell"), shards=4)
    a = TSS.PersistentSigCache(tier.join("a"), shards=4)
    tier.join("b")
    for k in _keys(30, seed=1):
        a.add_key(k)
    a.discard_key(_keys(1, seed=1)[0])
    a.close()
    tier.leave("a")
    stores = {}

    def absorb(dest, path):
        stores[dest] = TSS.PersistentSigCache(tier.store_dir(dest), shards=4)
        return TC.absorb_handoff(stores[dest], path)

    rep = tier.handoff_from("a", absorb)
    assert rep["records"] == 31 and set(rep["receivers"]) == {"b"}
    assert len(stores["b"]) == 29
    stores["b"].close()
    assert not torch.cuda.is_initialized()


def test_kill9_during_absorb_heals_to_record_boundary(tmp_path):
    src = TSS.PersistentSigCache(str(tmp_path / "src"), shards=1)
    for k in _keys(8000):
        src.add_key(k)
    src.close()
    out = str(tmp_path / "handoff.log")
    assert TC.write_handoff([str(tmp_path / "src" / "shard-00.log")], out) == 8000
    recv_dir = str(tmp_path / "recv")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from bitcoinconsensus_tpu_torch.cell.sigtier import absorb_handoff\n"
        "from bitcoinconsensus_tpu_torch.models.sigstore import PersistentSigCache\n"
        "import torch\n"
        f"s = PersistentSigCache({recv_dir!r}, hot_entries=8, shards=4)\n"
        "print('ready', flush=True)\n"
        f"absorb_handoff(s, {out!r})\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL)
    try:
        assert proc.stdout.readline().strip() == b"ready"
        time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
    recv = TSS.PersistentSigCache(recv_dir, hot_entries=8, shards=4)
    assert recv.replay_applied == len(recv)
    for p in os.listdir(recv_dir):
        if p.endswith(".log"):
            assert os.path.getsize(os.path.join(recv_dir, p)) % TSS._REC_LEN == 0
    recv.add_key(_keys(1, seed=9999)[0])
    assert recv.peek_key(_keys(1, seed=9999)[0])
    recv.close()


# -- the supervisor's policy ----------------------------------------------------


class _FakeReplica:
    """Handle-contract stub for supervisor policy tests (no sockets)."""

    def __init__(self, alive=True, sick=True):
        self._alive = alive
        self.force_sick = sick
        self.addr = ("127.0.0.1", 1)

    def is_alive(self):
        return self._alive

    def restart(self):
        raise RuntimeError("still dead")


def test_supervisor_policy_equals_the_reference():
    out = {}
    for name, p in PKGS.items():
        evicted = []
        dead = p.REP.ReplicaSupervisor({"x": _FakeReplica(alive=False)},
                                       probe_items=(None, None), evict_after=3,
                                       backoff_s=0.1, max_backoff_s=0.4,
                                       on_evict=evicted.append)
        dead.tick()
        for _ in range(6):
            dead._state["x"].next_retry_at = 0.0
            dead.tick()
        sick = p.REP.ReplicaSupervisor({"y": _FakeReplica(alive=True, sick=True)},
                                       probe_items=(None, None), evict_after=3,
                                       on_evict=evicted.append)
        streak = []
        for _ in range(3):
            sick.tick()
            streak.append(sick.is_healthy("y"))
        out[name] = (evicted, dead.backoff_log["x"], streak, dead.healthy_names())
    assert out["port"] == out["jax_package"]
    evicted, log, streak, healthy = out["port"]
    assert evicted == ["x", "y"] and streak == [True, True, False] and healthy == []
    assert len(log) == 7 and log[-1] == 0.4
    assert all(a <= b for a, b in zip(log, log[1:]))


# -- device --------------------------------------------------------------------


def test_replicas_and_cell_mean_cuda_and_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.StubReplica()
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.ReplicaProcess("r0")
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.ServingCell(stub=True, root_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.ServingCell(root_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):  # the child's entry alike
        TREP.replica_main(["--name", "r0"])
    assert TC.StubReplica(device="cpu").device == "cpu"


def test_replica_subprocess_on_the_cpu_answers_its_probe(tmp_path):
    """One `python -m bitcoinconsensus_tpu_torch.cell.replica --device cpu`
    child: the known-answer pair (accept and reject) over the wire, the
    control channel, and a kill."""
    r = TC.ReplicaProcess("r0", store_dir=str(tmp_path / "r0"), device="cpu",
                          server_kw=dict(max_batch=8, flush_s=0.005))
    r.start()
    try:
        assert r.is_alive() and r.start_s > 0 and r.pid
        assert TC.probe_replica(r.addr, TC.make_probe_items(), timeout_s=120)
        assert r.control({"cmd": "ping"}) == {"ok": True}
        stats = r.control({"cmd": "stats"})
        assert stats["entries"] >= 1 and stats["pid"] == r.pid
        assert not stats["cuda_initialized"]  # the CPU child never touched CUDA
    finally:
        r.kill()
    assert not r.is_alive()


# -- the router and the client, on a two-stub cell of the port -----------------


@pytest.fixture(scope="module")
def plain():
    """`PlainRows`, warmed by one dispatch of every check these tests
    send (the items and the probe pair), so later dispatches cost nothing."""
    with pytest.MonkeyPatch.context() as mp:
        memo = patch_plain_rows(mp)
        good, bad = _items()
        verify_batch(good[:8] + bad[:2] + list(TC.make_probe_items()),
                     verifier=TorchSecpVerifier(device="cpu"), sig_cache=SigCache(),
                     script_cache=ScriptExecutionCache())
        yield memo


def _items():
    items, bad = mixed_items(64, seed=3)
    good = [it for it, b in zip(items, bad) if not b]
    return good, [it for it, b in zip(items, bad) if b]


def _cell(**kw):
    kw.setdefault("n_replicas", 2)
    kw.setdefault("stub", True)
    kw.setdefault("device", "cpu")
    # The plain version takes seconds a batch: an SLO above that keeps the
    # admission estimate from shedding the pipelined requests.
    kw.setdefault("server_kw", dict(max_batch=8, flush_s=0.005, slo_deadline_s=600.0))
    return TC.ServingCell(**kw).start()


@pytest.fixture(scope="module")
def cell(plain):
    c = _cell()
    yield c
    c.close()


def _entries(cell):
    return {n: cell.replicas[n].control({"cmd": "stats"})["entries"] for n in cell.replicas}


def test_router_routes_home_reroutes_sick_and_pipelines(cell):
    good, bad = _items()
    tenant = "map-tenant"
    home = cell.router._home.lookup(tenant)
    other = next(n for n in cell.replicas if n != home)
    e0 = _entries(cell)
    with TS.IngressClient(port=cell.port, timeout_s=120) as cli:
        assert cli.verify(good[0], tenant=tenant).ok
    e1 = _entries(cell)
    assert e1[home] > e0[home] and e1[other] == e0[other]
    r0 = t_registry().get("consensus_cell_reroutes_total").value()
    cell.router.set_healthy(home, False)
    try:
        with TS.IngressClient(port=cell.port, timeout_s=120) as cli:
            assert cli.verify(good[0], tenant=tenant).ok
            assert not cli.verify(bad[0], tenant=tenant).ok
    finally:
        cell.router.set_healthy(home, True)
    assert t_registry().get("consensus_cell_reroutes_total").value() >= r0 + 2
    rids = [101, 202, 303, 404]
    sock = socket.create_connection(("127.0.0.1", cell.port), timeout=120)
    got = {}
    try:
        for j, rid in enumerate(rids):
            sock.sendall(TING.encode_frame(TING.FRAME_REQ,
                                           TING.encode_request(rid, f"t{j % 2}", good[j])))
        for _ in rids:
            hdr = b""
            while len(hdr) < TING.HEADER_LEN:
                hdr += sock.recv(TING.HEADER_LEN - len(hdr))
            ftype, ln = TING.decode_header(hdr)
            payload = b""
            while len(payload) < ln:
                payload += sock.recv(ln - len(payload))
            assert ftype == TING.FRAME_RESP, TING.decode_error_payload(payload)
            rid, res = TING.decode_response_payload(payload)
            got[rid] = res.ok
    finally:
        sock.close()
    assert got == {rid: True for rid in rids}


def test_router_explicit_errors_and_typed_protocol_errors(cell):
    good, _ = _items()
    cli = TS.IngressClient(port=cell.port, timeout_s=120)
    try:
        for name in cell.replicas:
            cell.router.set_healthy(name, False)
        with pytest.raises(TS.OverloadError) as ei:
            cli.verify(good[0], tenant="t")
        assert ei.value.reason == "no_replica"
        for name in cell.replicas:
            cell.router.set_healthy(name, True)
        assert cli.verify(good[0], tenant="t").ok  # the same session
    finally:
        cli.close()
    for frame, code in ((TING.encode_frame(0x7F, b"junk"), TING.ERR_PROTO_BAD_TYPE),
                        (TING.encode_frame(TING.FRAME_REQ, b"\x00\x01"),
                         TING.ERR_PROTO_MALFORMED)):
        s = socket.create_connection(("127.0.0.1", cell.port), timeout=30)
        try:
            s.sendall(frame)
            hdr = b""
            while len(hdr) < TING.HEADER_LEN:
                hdr += s.recv(TING.HEADER_LEN - len(hdr))
            ftype, ln = TING.decode_header(hdr)
            payload = b""
            while len(payload) < ln:
                payload += s.recv(ln - len(payload))
            assert ftype == TING.FRAME_ERR
            assert TING.decode_error_payload(payload)[1] == code
            assert s.recv(64) == b""
        finally:
            s.close()


def test_router_partition_fault_recovered_by_retry(cell):
    good, _ = _items()
    with TF.inject(TF.FaultPlan([TF.FaultSpec("cell.route", "raise", count=1)]),
                   seed=3) as inj:
        with TS.IngressClient(port=cell.port, timeout_s=120) as cli:
            res = TS.verify_with_retry(cli, good[1], tenant="t", retries=4,
                                       backoff_s=0.01, max_backoff_s=0.05,
                                       rng=random.Random(0))
    assert res.ok and inj.fired.get(("cell.route", "raise")) == 1


def test_router_dead_replica_explicit_error_then_reroute(plain):
    good, _ = _items()
    c = _cell()
    try:
        tenant = "dead-tenant"
        home = c.router._home.lookup(tenant)
        c.replicas[home].kill()
        with TS.IngressClient(port=c.port, timeout_s=120) as cli:
            with pytest.raises(TS.OverloadError) as ei:
                cli.verify(good[0], tenant=tenant)
            assert ei.value.reason == "replica_connect"
            c.router.set_healthy(home, False)
            assert cli.verify(good[0], tenant=tenant).ok
    finally:
        c.close()


def test_client_endpoint_failover(pkg, cell):
    S = pkg.S
    eps = [("h0", 10), ("h1", 11), ("h2", 12)]
    cli = S.IngressClient(endpoints=eps)
    seen = [(cli.host, cli.port)]
    for _ in range(3):
        cli.rotate()
        seen.append((cli.host, cli.port))
    assert seen == [eps[0], eps[1], eps[2], eps[0]]
    with pytest.raises(ValueError):
        S.IngressClient(endpoints=[])
    good, _ = _items()  # the port's cell serves both packages' clients
    cli = S.IngressClient(endpoints=[("127.0.0.1", _dead_port()), ("127.0.0.1", cell.port)])
    try:
        res = S.verify_with_retry(cli, good[2], retries=3, backoff_s=0.01,
                                  max_backoff_s=0.05, rng=random.Random(0))
        assert res.ok and (cli.host, cli.port) == ("127.0.0.1", cell.port)
    finally:
        cli.close()
    dead = S.IngressClient(endpoints=[("127.0.0.1", _dead_port())] * 2)
    with pytest.raises(ConnectionError):
        S.verify_with_retry(dead, good[2], retries=2, backoff_s=0.01,
                            max_backoff_s=0.02, rng=random.Random(0))


# -- the stub cell's failure loop, on both packages -----------------------------


def _cell_counts(reg):
    snap = reg().snapshot()
    out = {}
    for name in ("consensus_cell_evictions_total", "consensus_cell_repromotions_total",
                 "consensus_cell_handoffs_total", "consensus_cell_handoff_records_total",
                 "consensus_cell_retried_frames_total"):
        out[name] = sum(s["value"] for s in snap.get(name, {"samples": []})["samples"])
    return out


def _loop(p, tmp_path, items):
    """Two stubs; one verdict per tenant; kill the first tenant's home;
    tick (evict, handoff); verify through the survivor; tick until the
    victim is re-promoted through a passing probe. Each step has a client
    session of its own: the reference's `IngressServer.close` awaits its
    listener before tearing sessions down, which on Python 3.12 holds a
    kill until an open session's read deadline."""
    kw = dict(n_replicas=2, stub=True, root_dir=str(tmp_path / p.name),
              server_kw=dict(max_batch=8, flush_s=0.005, slo_deadline_s=600.0),
              evict_after=1, backoff_s=0.02, max_backoff_s=0.05)
    if p is PKGS["port"]:
        kw["device"] = "cpu"
    tenants = ["loop-a", "loop-b", "loop-c"]

    def verify_all(c):
        with p.S.IngressClient(port=c.port, timeout_s=120) as cli:
            return [cli.verify(it, tenant=t).ok for it, t in zip(items, tenants)]

    before = _cell_counts(p.reg)
    trace = []
    with p.C.ServingCell(**kw) as c:
        trace.append(verify_all(c))
        victim = c.router._home.lookup(tenants[0])
        survivor = next(n for n in c.replicas if n != victim)
        moved = c.replicas[victim].control({"cmd": "stats"})["entries"]
        c.replicas[victim].kill()
        c.tick()
        trace.append((victim, sorted(c.healthy_names()), moved))
        s0 = c.replicas[survivor].control({"cmd": "stats"})
        trace.append(verify_all(c))
        s1 = c.replicas[survivor].control({"cmd": "stats"})
        trace.append((s1["probes"] - s0["probes"], s1["hits"] - s0["hits"]))
        deadline = time.monotonic() + 120
        while victim not in c.healthy_names() and time.monotonic() < deadline:
            time.sleep(0.03)
            c.tick()
        trace.append(sorted(c.healthy_names()))
        trace.append(verify_all(c))
    after = _cell_counts(p.reg)
    return trace, {k: after[k] - before[k] for k in after}


def test_stub_cell_loop_matches_the_reference(plain, tmp_path):
    good, _ = _items()
    ref_trace, ref_delta = _loop(PKGS["jax_package"], tmp_path, good[:3])
    port_trace, port_delta = _loop(PKGS["port"], tmp_path, good[:3])
    assert port_trace == ref_trace
    assert port_delta == ref_delta
    probes, hits = port_trace[3]
    assert probes >= 1 and hits == probes  # the moved tenants answer warm
    assert port_delta["consensus_cell_evictions_total"] == 1
    assert port_delta["consensus_cell_repromotions_total"] == 1
    assert port_delta["consensus_cell_handoffs_total"] == 1


@pytest.mark.slow
def test_cell_subprocess_kill9_failover_and_repromote(tmp_path):
    """Two replica subprocesses on the CPU: kill -9 one, the cell keeps
    verifying through the survivor, and the victim re-promotes through a
    passing known-answer probe on a fresh port."""
    good, bad = _items()
    c = TC.ServingCell(n_replicas=2, stub=False, device="cpu",
                       root_dir=str(tmp_path / "cell"),
                       server_kw=dict(max_batch=8, flush_s=0.005),
                       evict_after=2, backoff_s=0.05, max_backoff_s=0.2,
                       probe_timeout_s=120).start()
    try:
        tenant = "e2e-tenant"
        victim = c.router._home.lookup(tenant)
        cli = TS.IngressClient(port=c.port, timeout_s=300)
        try:
            assert cli.verify(good[0], tenant=tenant).ok
            c.replicas[victim].kill()
            c.tick()
            assert victim not in c.healthy_names()
            rng = random.Random(0)
            assert TS.verify_with_retry(cli, good[0], tenant=tenant, retries=8,
                                        backoff_s=0.02, max_backoff_s=0.2, rng=rng).ok
            assert not TS.verify_with_retry(cli, bad[0], tenant=tenant, retries=8,
                                            backoff_s=0.02, max_backoff_s=0.2,
                                            rng=rng).ok
            deadline = time.monotonic() + 300
            while victim not in c.healthy_names() and time.monotonic() < deadline:
                time.sleep(0.05)
                c.tick()
            assert victim in c.healthy_names()
            assert cli.verify(good[0], tenant=tenant).ok
        finally:
            cli.close()
    finally:
        c.close()
