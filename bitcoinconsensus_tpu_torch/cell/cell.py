"""`ServingCell`: replicas + router + supervisor + sigstore tier, wired.

Port of `bitcoinconsensus_tpu/cell/cell.py`. The one-stop assembly
chip_smoke's `[cell]` phase and the stats gate's cell leg use: N replicas
(subprocesses by default, in-process stubs with ``stub=True``), each
with its own `PersistentSigCache` store under the tier root (shared
salt), fronted by a `CellRouter` and supervised by a
`ReplicaSupervisor`. Every replica runs on `device`: None means cuda:0
(the constructor raises where CUDA is not available), "cpu" the plain
torch version; the reference's `host_only=True` default has no
counterpart. Subprocess replicas are spawned together and then awaited,
so N replicas on one card start (and load the one kernel build) at once.

The supervision hooks close the failure loop:

- **evict** — routing flips first (`router.set_healthy(name, False)`
  is synchronous: when it returns, no new frame reaches the member and
  its in-flight frames are on the retry-once/explicit-ERR path), then
  the member leaves the tier ring and its shard logs stream to the new
  owners (`SigTier.handoff_from`), absorbed through each survivor's
  control surface. Reads racing the handoff simply miss and recompute —
  fail-closed by construction.
- **promote** — only ever reached through a passing known-answer probe;
  the router learns the restarted replica's fresh port, the member
  rejoins the tier ring, and routing flips back. Its shards return
  cold (their keys now live on the survivors) and warm back up through
  normal traffic — the tier never hands cached verdicts to a member
  that hasn't re-earned them.

Drive it tick-by-tick (`cell.tick()`, deterministic — what the tests
and chip_smoke do) or start the background supervisor loop with
``cell.start(supervise=True)``.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Dict, List, Optional

from .replica import ReplicaProcess, ReplicaSupervisor, StubReplica, resolve_device
from .router import CellRouter
from .sigtier import SigTier

__all__ = ["ServingCell"]


class ServingCell:
    def __init__(
        self,
        n_replicas: int = 2,
        root_dir: Optional[str] = None,
        stub: bool = False,
        shards: int = 8,
        server_kw: Optional[dict] = None,
        evict_after: Optional[int] = None,
        device=None,
        probe_items=None,
        backoff_s: float = 0.25,
        max_backoff_s: float = 2.0,
        probe_timeout_s: Optional[float] = None,
    ):
        self.n_replicas = n_replicas
        self._own_root = root_dir is None
        self.root_dir = root_dir or tempfile.mkdtemp(prefix="cell-")
        self.stub = stub
        self.shards = shards
        self.server_kw = dict(server_kw or {})
        self.evict_after = evict_after
        self.device = resolve_device(device)
        self.probe_items = probe_items
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.probe_timeout_s = probe_timeout_s
        self.tier: Optional[SigTier] = None
        self.router: Optional[CellRouter] = None
        self.supervisor: Optional[ReplicaSupervisor] = None
        self.replicas: Dict[str, object] = {}
        self._started = False

    # -- lifecycle -----------------------------------------------------

    def start(self, supervise: bool = False) -> "ServingCell":
        if self._started:
            return self
        self._started = True
        self.tier = SigTier(self.root_dir, shards=self.shards)
        cls = StubReplica if self.stub else ReplicaProcess
        for i in range(self.n_replicas):
            name = f"r{i}"
            store_dir = self.tier.join(name)
            self.replicas[name] = cls(
                name,
                store_dir=store_dir,
                device=self.device,
                server_kw=self.server_kw,
            )
        if self.stub:
            for r in self.replicas.values():
                r.start()
        else:
            for r in self.replicas.values():
                r.spawn()
            for r in self.replicas.values():
                r.wait_ready()
        self.router = CellRouter(
            {n: r.addr for n, r in self.replicas.items()}
        ).start()
        self.supervisor = ReplicaSupervisor(
            self.replicas,
            probe_items=self.probe_items,
            evict_after=self.evict_after,
            probe_timeout_s=self.probe_timeout_s,
            backoff_s=self.backoff_s,
            max_backoff_s=self.max_backoff_s,
            on_evict=self._on_evict,
            on_promote=self._on_promote,
        )
        if supervise:
            self.supervisor.run_forever()
        return self

    def __enter__(self) -> "ServingCell":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    @property
    def port(self) -> int:
        if self.router is None or self.router.port is None:
            raise RuntimeError("cell not started")
        return self.router.port

    def tick(self) -> None:
        self.supervisor.tick()

    def healthy_names(self) -> List[str]:
        return self.supervisor.healthy_names()

    def close(self) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.router is not None:
            self.router.close(drain=True)
        for r in self.replicas.values():
            try:
                r.close()
            except Exception:
                pass
        if self._own_root:
            shutil.rmtree(self.root_dir, ignore_errors=True)

    # -- supervision hooks ---------------------------------------------

    def _absorb(self, dest: str, path: str) -> Optional[dict]:
        handle = self.replicas.get(dest)
        if handle is None:
            return None
        try:
            reply = handle.control({"cmd": "absorb", "path": path})
        except Exception:
            return None
        return reply if reply.get("ok") else None

    def _on_evict(self, name: str) -> None:
        self.router.set_healthy(name, False)
        if name in self.tier.ring:
            self.tier.leave(name)
            if len(self.tier.ring):
                self.tier.handoff_from(name, self._absorb)

    def _on_promote(self, name: str) -> None:
        self.router.set_addr(name, self.replicas[name].addr)
        self.tier.join(name)
        self.router.set_healthy(name, True)
