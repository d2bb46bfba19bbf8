"""Tenant-hash front door for the serving cell.

Port of `bitcoinconsensus_tpu/cell/router.py`.

`CellRouter` speaks the exact ingress frame protocol (serving/ingress.py
codec, reused verbatim) on the client side and acts as an ingress
*client* toward replicas on the other — existing `IngressClient` /
`verify_with_retry` callers point at the router port and need no
changes. Forwarded frames are byte-identical, so `rid` correlation is
preserved end to end: a pipelined client sees the same rids it sent,
in whatever order replicas settle them.

Routing: tenant → replica by consistent hash (cell/hashring.py), one
upstream connection per (client session, replica) so rids from
different client sessions can never collide at a replica. Two rings:
the *home* ring over full membership (for accounting — serving a
tenant off its home replica counts `consensus_cell_reroutes_total`)
and the *healthy* ring the supervisor edits via `set_healthy`.

Failure semantics — every admitted frame ends in exactly one explicit
outcome, never silence:

- Replica sick/evicted: its tenants re-route to the next healthy
  member clockwise. Frames in flight to the dead upstream are retried
  **exactly once** on the new owner (verdicts are pure functions of the
  item, so the replay is idempotent; `consensus_cell_retried_frames_total`)
  or, if already retried or no survivor exists, answered with a typed
  `ERR_OVERLOADED` frame (`replica_lost`) the retry client may resend.
- No healthy replica for a tenant: explicit `ERR_OVERLOADED`
  (`no_replica`), session stays open.
- Oversized / malformed / bad-type client frames: typed protocol ERR
  (>= 0x100, never retried) then close — the ingress discipline.

Chaos site `cell.route` models a router-side partition: an injected
fault tears down one client session mid-read, exactly like
`ingress.read`, and `verify_with_retry` recovers by reconnecting.
Swept on the card by `chip_smoke.py`'s `[cell]` phase.
"""

from __future__ import annotations

import asyncio
import socket
import threading
from typing import Dict, List, Optional, Tuple

from ..api import Error
from ..obs import counter as _obs_counter
from ..obs import flight as _flight
from ..obs import monotonic as _monotonic
from ..resilience import faults as _faults
from ..serving.ingress import (
    ERR_PROTO_BAD_TYPE,
    ERR_PROTO_MALFORMED,
    ERR_PROTO_OVERSIZED,
    FRAME_ERR,
    FRAME_REQ,
    FRAME_RESP,
    HEADER_LEN,
    decode_header,
    encode_error,
    encode_frame,
)
from .hashring import HashRing

__all__ = ["CellRouter"]

_C_REROUTES = _obs_counter(
    "consensus_cell_reroutes_total",
    "frames served off the tenant's home replica (health-driven failover)",
)
_C_RETRIED = _obs_counter(
    "consensus_cell_retried_frames_total",
    "in-flight frames replayed exactly once on a survivor after their "
    "upstream replica died",
)


class _Upstream:
    """One router→replica connection owned by one client session."""

    __slots__ = ("name", "reader", "writer", "inflight", "task")

    def __init__(self, name: str, reader, writer):
        self.name = name
        self.reader = reader
        self.writer = writer
        # rid -> [raw REQ frame, tenant, already-retried flag]
        self.inflight: Dict[int, list] = {}
        self.task: Optional[asyncio.Task] = None


class _RouterSession:
    __slots__ = ("reader", "writer", "wlock", "upstreams", "alive")

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.wlock = asyncio.Lock()
        self.upstreams: Dict[str, _Upstream] = {}
        self.alive = True


class CellRouter:
    """Consistent-hash tenant router over replica addresses.

    Lifecycle mirrors `IngressServer`: the listening socket binds
    synchronously in `start()`, sessions run on a dedicated asyncio
    loop in a daemon thread, and `close(drain=True)` waits for frames
    in flight to replicas to settle before tearing sessions down.
    `set_healthy`/`set_addr` are thread-safe (the supervisor calls them
    from its own thread) and synchronous — when `set_healthy(name,
    False)` returns, the routing flip has been applied and the dead
    member's upstream links are closing, so the caller may proceed to
    sigstore handoff knowing no new frame will reach it."""

    def __init__(
        self,
        replicas: Dict[str, Tuple[str, int]],
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        idle_s: float = 30.0,
        max_frame: int = 1 << 20,
        drain_timeout_s: float = 30.0,
        connect_timeout_s: float = 5.0,
        vnodes: int = 64,
    ):
        self._addrs = dict(replicas)
        self.host = host
        self._want_port = port or 0
        self.idle_s = idle_s
        self.max_frame = max_frame
        self.drain_timeout_s = drain_timeout_s
        self.connect_timeout_s = connect_timeout_s
        members = sorted(self._addrs)
        self._home = HashRing(members, vnodes=vnodes)
        self._healthy = HashRing(members, vnodes=vnodes)
        self.port: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._listener = None
        self._sessions: set = set()
        self._tasks: set = set()
        self._closed = False

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "CellRouter":
        if self._thread is not None:
            return self
        if self._closed:
            raise RuntimeError("router already closed")
        self._sock = socket.create_server(
            (self.host, self._want_port), reuse_port=False
        )
        self.port = self._sock.getsockname()[1]
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="cell-router", daemon=True
        )
        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._serve(), self._loop)
        fut.result(timeout=10)
        return self

    async def _serve(self) -> None:
        self._listener = await asyncio.start_server(
            self._handle, sock=self._sock
        )

    def __enter__(self) -> "CellRouter":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    def close(self, drain: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        if self._loop is None:
            return
        fut = asyncio.run_coroutine_threadsafe(
            self._shutdown(drain), self._loop
        )
        fut.result(timeout=self.drain_timeout_s + 10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(10)
        self._loop.close()

    async def _shutdown(self, drain: bool) -> None:
        # As in `IngressServer._shutdown`: the listener is awaited after
        # the sessions are torn down (Python 3.12's `wait_closed()` waits
        # for every open connection).
        if self._listener is not None:
            self._listener.close()
        if drain:
            deadline = _monotonic() + self.drain_timeout_s
            while (
                any(
                    up.inflight
                    for s in self._sessions
                    for up in s.upstreams.values()
                )
                and _monotonic() < deadline
            ):
                await asyncio.sleep(0.01)
        for sess in list(self._sessions):
            self._teardown(sess)
        tasks = [t for t in self._tasks if not t.done()]
        if tasks:
            await asyncio.wait(tasks, timeout=5)
        if self._listener is not None:
            try:
                await asyncio.wait_for(self._listener.wait_closed(), 5)
            except (asyncio.TimeoutError, TimeoutError):
                pass  # a connection that outlived its session task

    def _teardown(self, sess: _RouterSession) -> None:
        sess.alive = False
        for up in list(sess.upstreams.values()):
            try:
                up.writer.close()
            except Exception:
                pass
        try:
            sess.writer.close()
        except Exception:
            pass

    # -- membership (supervisor-facing, thread-safe) ---------------------

    def members(self) -> List[str]:
        return sorted(self._addrs)

    def healthy_members(self) -> List[str]:
        return sorted(self._healthy.members)

    def set_addr(self, name: str, addr: Tuple[str, int]) -> None:
        """Update a member's address (replicas restart on fresh ports)."""
        self._run_on_loop(self._apply_addr(name, addr))

    def set_healthy(self, name: str, healthy: bool) -> None:
        """Flip routing health; synchronous (see class docstring)."""
        self._run_on_loop(self._apply_health(name, healthy))

    def _run_on_loop(self, coro) -> None:
        loop = self._loop
        if loop is None or loop.is_closed():
            coro.close()
            return
        asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=10)

    async def _apply_addr(self, name: str, addr: Tuple[str, int]) -> None:
        self._addrs[name] = addr

    async def _apply_health(self, name: str, healthy: bool) -> None:
        if healthy:
            self._healthy.add(name)
            return
        self._healthy.remove(name)
        _flight.record("cell.route_sick", replica=name)
        # Close the sick member's upstream links; each pump observes the
        # close and runs the retry-once / explicit-ERR failover for its
        # in-flight frames.
        for sess in self._sessions:
            up = sess.upstreams.get(name)
            if up is not None:
                try:
                    up.writer.close()
                except Exception:
                    pass

    # -- client side ----------------------------------------------------

    async def _handle(self, reader, writer) -> None:
        sess = _RouterSession(reader, writer)
        self._sessions.add(sess)
        self._tasks.add(asyncio.current_task())
        try:
            await self._session_loop(sess)
        finally:
            self._tasks.discard(asyncio.current_task())
            self._sessions.discard(sess)
            self._teardown(sess)
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_exactly(self, sess: _RouterSession, n: int) -> bytes:
        # `cell.route` models a router partition: the injected fault
        # tears down this one client session (the peer sees a reset and
        # `verify_with_retry` reconnects); routing state is untouched.
        _faults.maybe_raise("cell.route")
        return await asyncio.wait_for(
            sess.reader.readexactly(n), self.idle_s
        )

    async def _session_loop(self, sess: _RouterSession) -> None:
        while sess.alive:
            try:
                hdr = await self._read_exactly(sess, HEADER_LEN)
            except asyncio.IncompleteReadError:
                return
            except (asyncio.TimeoutError, TimeoutError):
                return
            except (_faults.InjectedFault, ConnectionError, OSError):
                return
            ftype, ln = decode_header(hdr)
            if ln > self.max_frame:
                await self._send_err(
                    sess, 0, ERR_PROTO_OVERSIZED,
                    f"frame of {ln} bytes exceeds max_frame={self.max_frame}",
                )
                return
            try:
                payload = await self._read_exactly(sess, ln)
            except (
                asyncio.IncompleteReadError,
                asyncio.TimeoutError,
                TimeoutError,
                _faults.InjectedFault,
                ConnectionError,
                OSError,
            ):
                return
            if not await self._route(sess, ftype, payload):
                return

    async def _route(
        self, sess: _RouterSession, ftype: int, payload: bytes
    ) -> bool:
        """Route one inbound frame; False closes the session."""
        if ftype != FRAME_REQ:
            await self._send_err(
                sess, 0, ERR_PROTO_BAD_TYPE, f"unexpected frame type {ftype}"
            )
            return False
        # Cheap peek: rid and tenant prefix the REQ payload by design —
        # the router never decodes the item it forwards.
        if len(payload) < 6:
            await self._send_err(
                sess, 0, ERR_PROTO_MALFORMED, "short request payload"
            )
            return False
        rid = int.from_bytes(payload[0:4], "big")
        tlen = int.from_bytes(payload[4:6], "big")
        if len(payload) < 6 + tlen:
            await self._send_err(
                sess, 0, ERR_PROTO_MALFORMED, "truncated tenant"
            )
            return False
        try:
            tenant = payload[6 : 6 + tlen].decode("utf-8")
        except UnicodeDecodeError:
            await self._send_err(
                sess, 0, ERR_PROTO_MALFORMED, "tenant not utf-8"
            )
            return False
        owner = self._healthy.lookup(tenant)
        if owner is None:
            # Explicit, typed, retryable — overload is the cell's state.
            return await self._send_err(
                sess, rid, int(Error.ERR_OVERLOADED), "no_replica"
            )
        if owner != self._home.lookup(tenant):
            _C_REROUTES.inc()
        frame = encode_frame(FRAME_REQ, payload)
        if not await self._forward(sess, owner, rid, frame, tenant, False):
            return await self._send_err(
                sess, rid, int(Error.ERR_OVERLOADED), "replica_connect"
            )
        return True

    # -- replica side ----------------------------------------------------

    async def _get_upstream(
        self, sess: _RouterSession, owner: str
    ) -> Optional[_Upstream]:
        up = sess.upstreams.get(owner)
        if up is not None:
            return up
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(*self._addrs[owner]),
                self.connect_timeout_s,
            )
        except (OSError, asyncio.TimeoutError, TimeoutError):
            return None
        up = _Upstream(owner, reader, writer)
        sess.upstreams[owner] = up
        up.task = asyncio.get_running_loop().create_task(
            self._pump(sess, up)
        )
        self._tasks.add(up.task)
        up.task.add_done_callback(self._tasks.discard)
        return up

    async def _forward(
        self,
        sess: _RouterSession,
        owner: str,
        rid: int,
        frame: bytes,
        tenant: str,
        retried: bool,
    ) -> bool:
        up = await self._get_upstream(sess, owner)
        if up is None:
            return False
        up.inflight[rid] = [frame, tenant, retried]
        try:
            up.writer.write(frame)
            await up.writer.drain()
        except (ConnectionError, OSError):
            # The pump's failover owns frames that made it into the
            # inflight table of a dying upstream — but this one never
            # left the router, so reclaim it and report failure.
            up.inflight.pop(rid, None)
            return False
        return True

    async def _pump(self, sess: _RouterSession, up: _Upstream) -> None:
        """Forward one upstream's RESP/ERR frames back to the client,
        verbatim (rid untouched); on upstream death run failover."""
        try:
            while True:
                hdr = await up.reader.readexactly(HEADER_LEN)
                ftype, ln = decode_header(hdr)
                if ftype not in (FRAME_RESP, FRAME_ERR) or ln > self.max_frame:
                    break
                payload = await up.reader.readexactly(ln)
                rid = int.from_bytes(payload[0:4], "big")
                if rid == 0:
                    # Session-level ERR from the replica (idle reap,
                    # drain): this link is done; in-flight frames take
                    # the failover path below.
                    break
                up.inflight.pop(rid, None)
                await self._send(sess, ftype, payload)
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
        ):
            pass
        except asyncio.CancelledError:
            raise
        finally:
            await self._upstream_down(sess, up)

    async def _upstream_down(
        self, sess: _RouterSession, up: _Upstream
    ) -> None:
        if sess.upstreams.get(up.name) is up:
            del sess.upstreams[up.name]
        try:
            up.writer.close()
        except Exception:
            pass
        inflight, up.inflight = up.inflight, {}
        if not inflight:
            return
        _flight.record(
            "cell.upstream_down", replica=up.name, inflight=len(inflight)
        )
        for rid, (frame, tenant, retried) in sorted(inflight.items()):
            if not sess.alive:
                return
            owner = self._survivor_for(tenant, up.name)
            if owner is not None and not retried:
                if await self._forward(sess, owner, rid, frame, tenant, True):
                    _C_RETRIED.inc()
                    continue
            # Already retried once, or no survivor reachable: explicit
            # typed failure the retry client may resend — never silence.
            await self._send_err(
                sess, rid, int(Error.ERR_OVERLOADED), "replica_lost"
            )

    def _survivor_for(self, tenant: str, dead: str) -> Optional[str]:
        for m in self._healthy.lookup_chain(tenant):
            if m != dead:
                return m
        return None

    # -- client writes ---------------------------------------------------

    async def _send_err(
        self, sess: _RouterSession, rid: int, code: int, reason: str
    ) -> bool:
        return await self._send(
            sess, FRAME_ERR, encode_error(rid, code, reason)
        )

    async def _send(
        self, sess: _RouterSession, ftype: int, payload: bytes
    ) -> bool:
        frame = encode_frame(ftype, payload)
        try:
            async with sess.wlock:
                sess.writer.write(frame)
                await sess.writer.drain()
        except (ConnectionError, OSError):
            self._teardown(sess)
            return False
        return True
