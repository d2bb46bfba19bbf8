"""Cell replicas: supervised verify workers, each on its own port.

Port of `bitcoinconsensus_tpu/cell/replica.py`. A replica is one
`IngressServer`+`VerifyServer` stack with its own `PersistentSigCache`
store and its own `TorchSecpVerifier` on `device`: None means cuda:0 (the
constructor raises where CUDA is not available), "cpu" the plain torch
version. The reference parks a replica's dispatch ladder on its host rung
by default (`host_only`); the port has no ladder and no host rung, so a
replica runs where `device` says and nowhere else. Two implementations
share one handle contract (`addr`, `is_alive()`, `kill()`, `restart()`):

- `ReplicaProcess` — a real subprocess (`python -m
  bitcoinconsensus_tpu_torch.cell.replica --device ...`), the production
  shape: a kill -9 takes out the whole worker, CUDA context included, and
  chip_smoke's `[cell]` phase does exactly that. Several replicas on one
  card each hold a context on it and load the kernels from the one build
  in `build/torch_kernels/` (`ops/_build.py` serialises a build across
  processes with a file lock and an atomic rename).
  Alongside the ingress port it opens a JSON-line control channel
  (stats / absorb / peek / flush) so the supervisor can drive sigstore
  handoff across the process boundary.
- `StubReplica` — the same stack in-process, for router-logic units
  and the stats gate's cell leg, where subprocess spawn cost buys
  nothing.

`ReplicaSupervisor` health-checks replicas with known-answer probe
verifies, reusing the guards.py sentinel discipline: every probe
exercises BOTH verdict sides — one known-valid item must come back
accepted and one known-corrupt item rejected — so a replica that fails
open (accepts everything) is exactly as convicted as one that crashes.
Probe failures accumulate per replica; at
``BITCOINCONSENSUS_TPU_CELL_EVICT_AFTER`` consecutive failures
(mirroring `ShardLadder`'s count-based eviction) the replica is
evicted: flight-recorder conviction dump (carrying the failing probe
events), router re-route, sigstore handoff. Restart follows bounded
exponential backoff, and re-promotion only ever happens through a
passing known-answer probe — the same discipline `degrade.py` applies
to rungs.

The supervisor is deliberately tick-driven (`tick()` advances one
supervision round) so tests and chip_smoke control time explicitly;
`run_forever` wraps it in a thread for live cells.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import counter as _obs_counter
from ..obs import flight as _flight
from ..obs import gauge as _obs_gauge
from ..obs import monotonic as _monotonic

__all__ = [
    "ReplicaProcess",
    "ReplicaSupervisor",
    "StubReplica",
    "make_probe_items",
    "probe_replica",
    "resolve_device",
]

_G_HEALTHY = _obs_gauge(
    "consensus_cell_replicas_healthy",
    "replicas currently healthy (probe-passing) in the serving cell",
)
_C_EVICTIONS = _obs_counter(
    "consensus_cell_evictions_total",
    "replica evictions (crash or known-answer probe failure streak)",
)
_C_REPROMOTIONS = _obs_counter(
    "consensus_cell_repromotions_total",
    "replicas re-promoted to healthy after a passing known-answer probe",
)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def resolve_device(device=None) -> str:
    """The device a replica runs on: "cuda:0" for None, which raises where
    CUDA is not available (as `TorchSecpVerifier()` does), else `device`
    as given. The CPU is only ever an explicit request."""
    if device is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "a replica runs on cuda:0 by default but CUDA is not "
                "available; pass device=\"cpu\" to run the plain torch "
                "version on the CPU"
            )
        return "cuda:0"
    return str(device)


def _make_stack(device: str, store, server_kw: dict):
    """One replica's verifier, `VerifyServer` (over `store`) and
    `IngressServer`, started."""
    from ..crypto.torch_backend import TorchSecpVerifier
    from ..models.sigcache import ScriptExecutionCache
    from ..serving import IngressServer, VerifyServer

    verifier = TorchSecpVerifier(device=device, min_batch=8)
    vs = VerifyServer(
        verifier=verifier,
        sig_cache=store,
        script_cache=ScriptExecutionCache(),
        **server_kw,
    ).start()
    return vs, IngressServer(vs).start()


def _control_reply(store, obj: dict) -> dict:
    """One control-channel command against a replica's store: the JSON
    protocol of `ReplicaProcess.control`, which `StubReplica.control`
    answers in-process. Beyond the reference's keys, `stats` carries the
    process's pid, whether it has initialised CUDA (holds a context), and
    its launch counts of the verify and checksum kernels, so a supervisor
    can see a replica's work on the card."""
    cmd = obj.get("cmd")
    if cmd == "ping":
        return {"ok": True}
    if store is None:
        return {"ok": False, "error": "no store"}
    if cmd == "stats":
        import torch

        from ..ops.verify_tiles import verify_tiles_checked

        return {
            "ok": True,
            "entries": len(store),
            "probes": store._probes_since_open,
            "hits": store._hits_since_open,
            "pid": os.getpid(),
            "cuda_initialized": torch.cuda.is_initialized(),
            # The dispatches' checked verify launches, and those of them
            # that carried the verdict checksum's partials.
            "verify_tiles_launches": verify_tiles_checked.launches,
            "checksum_launches": verify_tiles_checked.checksummed,
        }
    if cmd == "absorb":
        from .sigtier import absorb_handoff

        return {"ok": True, **absorb_handoff(store, obj["path"])}
    if cmd == "peek":
        return {"ok": True, "present": store.peek_key(bytes.fromhex(obj["key"]))}
    if cmd == "flush":
        store.flush()
        return {"ok": True}
    return {"ok": False, "error": f"unknown cmd {cmd!r}"}


def make_probe_items():
    """The known-answer probe pair: (must-accept item, must-reject item).

    Deterministic single-signature spends (guards.py sentinel
    discipline): the reject item's signature is well-formed but
    cryptographically false, so a replica answering it `ok` has a
    broken verify path, not a parse error."""
    from ..core.flags import VERIFY_ALL_EXTENDED
    from ..models.batch import BatchItem
    from ..utils import blockgen

    _, funded = blockgen.make_funded_view(
        2, kinds=("p2wpkh",), seed="cell-probe"
    )
    items = []
    for j, f in enumerate(funded):
        tx = blockgen.build_spend_tx([f], corrupt_input=(0 if j else None))
        items.append(
            BatchItem(
                tx.serialize(), 0, VERIFY_ALL_EXTENDED,
                spent_outputs=[(f.amount, f.wallet.spk)],
            )
        )
    return items[0], items[1]


def probe_replica(
    addr: Tuple[str, int], probe_items, timeout_s: float = 5.0
) -> bool:
    """One known-answer probe over the wire: accept item must verify
    True AND reject item must verify False. Any transport error, shed,
    or wrong-side verdict fails the probe — fail-closed."""
    from ..serving.client import IngressClient

    good, bad = probe_items
    try:
        with IngressClient(
            addr[0], port=addr[1], timeout_s=timeout_s
        ) as cli:
            if not cli.verify(good, tenant="_probe").ok:
                return False
            if cli.verify(bad, tenant="_probe").ok:
                return False
        return True
    except Exception:
        return False


# -- in-process stub ---------------------------------------------------


class StubReplica:
    """The replica stack in-process: real wire protocol, no subprocess.

    Uses its own `TorchSecpVerifier` instance on `device` (never the
    process-global default). `kill()` is abrupt (no drain), modelling a
    crash as closely as an in-process stub can; `force_sick` makes the
    supervisor's probes fail without tearing anything down, for
    deterministic eviction-threshold tests."""

    def __init__(
        self,
        name: str = "r0",
        store_dir: Optional[str] = None,
        device=None,
        server_kw: Optional[dict] = None,
    ):
        self.name = name
        self.store_dir = store_dir
        self.device = resolve_device(device)
        self.server_kw = dict(server_kw or {})
        self.force_sick = False
        self.store = None
        self._vs = None
        self._ing = None

    @property
    def addr(self) -> Tuple[str, int]:
        if self._ing is None:
            raise RuntimeError("stub replica not started")
        return ("127.0.0.1", self._ing.port)

    def start(self) -> "StubReplica":
        if self.store_dir is not None:
            from ..models.sigstore import PersistentSigCache

            self.store = PersistentSigCache(self.store_dir)
        self._vs, self._ing = _make_stack(self.device, self.store, self.server_kw)
        return self

    def is_alive(self) -> bool:
        return self._ing is not None

    def kill(self) -> None:
        """Abrupt stop: no drain, in-flight sessions see a reset —
        the closest an in-process stub gets to kill -9. The store's
        appends are already on disk (flushed before each call returns),
        so closing it loses nothing a crash wouldn't keep."""
        ing, vs, store = self._ing, self._vs, self.store
        self._ing = self._vs = self.store = None
        if ing is not None:
            ing.close(drain=False)
        if vs is not None:
            vs.close(drain=False)
        if store is not None:
            store.close()

    def restart(self) -> "StubReplica":
        if self.is_alive():
            self.kill()
        return self.start()

    def close(self) -> None:
        self.kill()

    # Control surface, the subprocess JSON protocol answered in-process,
    # so cell plumbing (handoff absorb, stats) is handle-agnostic.
    def control(self, obj: dict) -> dict:
        return _control_reply(self.store, obj)


# -- subprocess replica ------------------------------------------------

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


class ReplicaProcess:
    """A replica as a real OS process; see the module docstring.

    The child prints ``READY <ingress_port> <ctrl_port>`` on stdout once
    both sockets are bound, then blocks until its stdin reaches EOF
    (closing our pipe end is the graceful-stop signal; `kill()` is
    SIGKILL). Restart spawns a fresh process on fresh ephemeral ports —
    the supervisor re-routes by name, so port churn is invisible above
    the handle. `device` is resolved here (None: cuda:0, raising without
    a card) and passed to the child as ``--device``; `start()` is
    `spawn()` then `wait_ready()`, which `ServingCell` splits so that its
    replicas start together. `start_s` is the last start's seconds from
    spawn to READY, `pid` the child's."""

    def __init__(
        self,
        name: str,
        store_dir: Optional[str] = None,
        device=None,
        server_kw: Optional[dict] = None,
        spawn_timeout_s: float = 120.0,
    ):
        self.name = name
        self.store_dir = store_dir
        self.device = resolve_device(device)
        self.server_kw = dict(server_kw or {})
        self.spawn_timeout_s = spawn_timeout_s
        self.port: Optional[int] = None
        self.ctrl_port: Optional[int] = None
        self.start_s: Optional[float] = None
        self._proc: Optional[subprocess.Popen] = None
        self._spawned_at = 0.0
        self._ready: List[str] = []
        self._evt = threading.Event()

    @property
    def addr(self) -> Tuple[str, int]:
        if self.port is None:
            raise RuntimeError("replica process not started")
        return ("127.0.0.1", self.port)

    @property
    def pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    def start(self) -> "ReplicaProcess":
        return self.spawn().wait_ready()

    def spawn(self) -> "ReplicaProcess":
        """Start the child without waiting for it to come up."""
        cmd = [
            sys.executable, "-m", "bitcoinconsensus_tpu_torch.cell.replica",
            "--name", self.name, "--device", self.device,
        ]
        if self.store_dir is not None:
            cmd += ["--store-dir", self.store_dir]
        for k, v in sorted(self.server_kw.items()):
            cmd += [f"--{k.replace('_', '-')}", str(v)]
        self._spawned_at = _monotonic()
        self._proc = subprocess.Popen(
            cmd,
            cwd=_REPO_ROOT,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            text=True,
        )
        ready: List[str] = []
        evt = threading.Event()
        proc = self._proc

        def _reader() -> None:
            for line in proc.stdout:
                if line.startswith("READY "):
                    ready.append(line.strip())
                    evt.set()
                    return
            evt.set()  # EOF before READY: child died during startup

        threading.Thread(target=_reader, daemon=True).start()
        self._ready, self._evt = ready, evt
        return self

    def wait_ready(self) -> "ReplicaProcess":
        """Block until the spawned child prints READY; kill it and raise
        if it dies first or takes longer than `spawn_timeout_s`."""
        if not self._evt.wait(self.spawn_timeout_s) or not self._ready:
            self.kill()
            raise RuntimeError(
                f"replica {self.name!r} did not come up "
                f"(rc={self._proc.poll()})"
            )
        self.start_s = _monotonic() - self._spawned_at
        _, port, ctrl = self._ready[0].split()
        self.port, self.ctrl_port = int(port), int(ctrl)
        return self

    def is_alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def kill(self) -> None:
        if self._proc is not None:
            try:
                self._proc.kill()
            except OSError:
                pass
            self._proc.wait()

    def restart(self) -> "ReplicaProcess":
        if self.is_alive():
            self.kill()
        return self.start()

    def close(self) -> None:
        """Graceful stop: close the stdin pipe (the child's exit
        signal) and wait briefly; escalate to SIGKILL."""
        if self._proc is None:
            return
        try:
            self._proc.stdin.close()
        except OSError:
            pass
        try:
            self._proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            self.kill()

    def control(self, obj: dict, timeout_s: float = 30.0) -> dict:
        if self.ctrl_port is None:
            raise RuntimeError("replica process not started")
        with socket.create_connection(
            ("127.0.0.1", self.ctrl_port), timeout=timeout_s
        ) as sock:
            sock.sendall((json.dumps(obj) + "\n").encode("utf-8"))
            buf = bytearray()
            while not buf.endswith(b"\n"):
                chunk = sock.recv(65536)
                if not chunk:
                    break
                buf.extend(chunk)
        return json.loads(buf.decode("utf-8"))


# -- supervisor --------------------------------------------------------


class _ReplicaState:
    __slots__ = ("healthy", "fail_streak", "attempts", "next_retry_at")

    def __init__(self) -> None:
        self.healthy = True
        self.fail_streak = 0
        self.attempts = 0
        self.next_retry_at = 0.0


class ReplicaSupervisor:
    """Health-driven eviction/restart/re-promotion over replica handles.

    Tick-driven: each `tick()` probes every healthy replica
    (known-answer, both verdict sides) and advances restart backoff for
    evicted ones. `on_evict`/`on_promote` are the cell's hooks — the
    router flips routing health and the sigstore tier runs handoff
    there, so supervision stays policy-only."""

    def __init__(
        self,
        replicas: Dict[str, object],
        probe_items=None,
        evict_after: Optional[int] = None,
        probe_timeout_s: Optional[float] = None,
        backoff_s: float = 0.25,
        max_backoff_s: float = 2.0,
        on_evict: Optional[Callable[[str], None]] = None,
        on_promote: Optional[Callable[[str], None]] = None,
    ):
        self.replicas = dict(replicas)
        self.probe_items = (
            probe_items if probe_items is not None else make_probe_items()
        )
        self.evict_after = (
            evict_after
            if evict_after is not None
            else _env_int("BITCOINCONSENSUS_TPU_CELL_EVICT_AFTER", 3)
        )
        self.probe_timeout_s = (
            probe_timeout_s
            if probe_timeout_s is not None
            else _env_float("BITCOINCONSENSUS_TPU_CELL_PROBE_TIMEOUT_S", 5.0)
        )
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.on_evict = on_evict
        self.on_promote = on_promote
        self._state = {name: _ReplicaState() for name in self.replicas}
        self.backoff_log: Dict[str, List[float]] = {
            name: [] for name in self.replicas
        }
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _G_HEALTHY.set(len(self.replicas))

    # -- introspection -------------------------------------------------

    def healthy_names(self) -> List[str]:
        with self._lock:
            return [n for n, s in self._state.items() if s.healthy]

    def is_healthy(self, name: str) -> bool:
        with self._lock:
            return self._state[name].healthy

    def _set_gauge_locked(self) -> None:
        _G_HEALTHY.set(sum(1 for s in self._state.values() if s.healthy))

    # -- probing -------------------------------------------------------

    def _probe(self, name: str) -> bool:
        r = self.replicas[name]
        if getattr(r, "force_sick", False):
            return False
        return probe_replica(r.addr, self.probe_items, self.probe_timeout_s)

    # -- supervision round ---------------------------------------------

    def tick(self) -> None:
        """One supervision round over every replica. Serialized: probes
        and membership transitions must not interleave."""
        with self._lock:
            for name, r in self.replicas.items():
                st = self._state[name]
                if st.healthy:
                    self._tick_healthy_locked(name, r, st)
                else:
                    self._tick_evicted_locked(name, r, st)

    def _tick_healthy_locked(self, name, r, st) -> None:
        if not r.is_alive():
            _flight.record("cell.probe", replica=name, ok=False,
                           cause="dead")
            self._evict_locked(name, st, reason="dead")
            return
        ok = self._probe(name)
        _flight.record("cell.probe", replica=name, ok=ok)
        if ok:
            st.fail_streak = 0
            return
        st.fail_streak += 1
        if st.fail_streak >= self.evict_after:
            self._evict_locked(name, st, reason="probe")

    def _tick_evicted_locked(self, name, r, st) -> None:
        now = _monotonic()
        if now < st.next_retry_at:
            return
        if not r.is_alive():
            try:
                r.restart()
            except Exception:
                self._backoff_locked(name, st, now)
                return
        ok = self._probe(name)
        _flight.record("cell.probe", replica=name, ok=ok, phase="repromote")
        if ok:
            st.healthy = True
            st.fail_streak = 0
            st.attempts = 0
            self._set_gauge_locked()
            _C_REPROMOTIONS.inc()
            _flight.record("cell.promote", replica=name)
            if self.on_promote is not None:
                self.on_promote(name)
        else:
            self._backoff_locked(name, st, now)

    def _backoff_locked(self, name, st, now: float) -> None:
        delay = min(self.backoff_s * (2 ** st.attempts), self.max_backoff_s)
        st.attempts += 1
        st.next_retry_at = now + delay
        self.backoff_log[name].append(delay)

    def _evict_locked(self, name, st, reason: str) -> None:
        st.healthy = False
        st.attempts = 0
        st.next_retry_at = _monotonic() + self.backoff_s
        self.backoff_log[name].append(self.backoff_s)
        self._set_gauge_locked()
        _C_EVICTIONS.inc()
        # Record the conviction before triggering the dump so the dump
        # carries it alongside the failing probe events (the same
        # record-then-trigger order degrade.py uses).
        _flight.record(
            "cell.evict", replica=name, reason=reason,
            fail_streak=st.fail_streak, evict_after=self.evict_after,
        )
        _flight.trigger("cell_eviction", replica=name, cause=reason)
        if self.on_evict is not None:
            self.on_evict(name)

    # -- background loop -----------------------------------------------

    def run_forever(self, interval_s: float = 0.5) -> "ReplicaSupervisor":
        if self._thread is not None:
            return self

        def _loop() -> None:
            while not self._stop.wait(interval_s):
                self.tick()

        self._thread = threading.Thread(
            target=_loop, name="cell-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None


# -- subprocess entry point --------------------------------------------


def _serve_control(store, sock: socket.socket) -> None:
    """JSON-line control loop: one command per connection."""
    while True:
        try:
            conn, _ = sock.accept()
        except OSError:
            return
        try:
            with conn:
                fh = conn.makefile("rw", encoding="utf-8")
                line = fh.readline()
                if not line:
                    continue
                reply = _control_reply(store, json.loads(line))
                fh.write(json.dumps(reply) + "\n")
                fh.flush()
        except Exception:
            continue  # a broken control exchange must not kill the replica


def replica_main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="serving-cell replica worker")
    p.add_argument("--name", required=True)
    p.add_argument("--store-dir", default=None)
    p.add_argument("--device", default=None,
                   help="cuda:0 when left out (raises without CUDA); cpu "
                        "runs the plain torch version")
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--flush-s", type=float, default=None)
    p.add_argument("--tenant-depth", type=int, default=None)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if device == "cpu":
        import torch

        # The plain version is thousands of tiny ops: one thread runs it
        # about ten times faster than the default pool.
        torch.set_num_threads(1)
    store = None
    if args.store_dir is not None:
        from ..models.sigstore import PersistentSigCache

        store = PersistentSigCache(args.store_dir)
    server_kw = {}
    if args.max_batch is not None:
        server_kw["max_batch"] = args.max_batch
    if args.flush_s is not None:
        server_kw["flush_s"] = args.flush_s
    if args.tenant_depth is not None:
        server_kw["tenant_depth"] = args.tenant_depth
    vs, ing = _make_stack(device, store, server_kw)
    ctrl = socket.create_server(("127.0.0.1", 0))
    threading.Thread(
        target=_serve_control, args=(store, ctrl), daemon=True
    ).start()
    print(f"READY {ing.port} {ctrl.getsockname()[1]}", flush=True)
    try:
        sys.stdin.read()  # EOF = parent closed our pipe: shut down
    except KeyboardInterrupt:
        pass
    ing.close(drain=True)
    vs.close(drain=True)
    try:
        ctrl.close()
    except OSError:
        pass
    if store is not None:
        store.close()
    return 0


if __name__ == "__main__":
    sys.exit(replica_main())
