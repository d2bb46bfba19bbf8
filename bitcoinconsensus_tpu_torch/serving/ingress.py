"""Async socket ingress in front of `VerifyServer`: explicit, bounded failure.

Port of `bitcoinconsensus_tpu/serving/ingress.py`; the wire format is the
reference's byte for byte, so a client of either package talks to a server
of the other. `VerifyServer.submit` is a Python call; this module is the
network front half: a length-prefixed binary
protocol over TCP with persistent sessions, where every failure mode
has exactly one observable:

- **Overload** propagates as an explicit `ERR` frame carrying
  `Error.ERR_OVERLOADED` and the shed reason — the wire form of the
  fail-closed `OverloadError`, and the only frame a client may retry.
- **Slow-loris / half-open peers** are reaped by a per-connection read
  deadline (`idle_s` bounds both the gap between frames and the time a
  started frame may take to finish), counted in
  `consensus_ingress_deadline_reaps_total`.
- **Oversized or malformed frames** close the session after a typed
  `ERR` frame with a protocol code (>= 0x100) — a code the retry client
  refuses to retry, because resending a malformed request re-creates
  the error.
- **Graceful drain** (`close(drain=True)`) stops the listener, lets
  every already-submitted request settle and its response flush, and
  only then closes sessions. Close the ingress BEFORE the
  `VerifyServer` it fronts: in-flight responses need the worker alive.

Sessions are handled on one asyncio loop in a daemon thread; responses
are delivered by `PendingVerify.add_done_callback` hopping back onto
the loop, so a stalled client can never block the serving worker, and
slow verifies never block frame reads (responses may arrive out of
request order — the client correlates by request id).

Framing (all integers big-endian): a 5-byte header `type:u8 len:u32`
then `len` payload bytes. Types: REQ 0x01 (`rid:u32 tenant:u16+bytes
item`), RESP 0x02 (`rid:u32 ok:u8 error:u16 script_error:u16`, with
0xFFFF meaning "no script error"), ERR 0x03 (`rid:u32 code:u16
reason:u16+bytes`; rid 0 = session-level). The item encoding mirrors
`BatchItem` field-for-field (see `encode_item`).

Chaos sites (resilience/faults.py): `ingress.read` / `ingress.write` —
an injected fault tears down that one session explicitly; the listener
and every other session keep serving. Swept on the card by
`chip_smoke.py`'s `[ingress]` phase.

Env knobs: ``BITCOINCONSENSUS_TPU_INGRESS_PORT`` (default 0 =
ephemeral), ``..._INGRESS_IDLE_S`` (read deadline, default 30),
``..._INGRESS_MAX_FRAME`` (payload byte cap, default 1 MiB).
"""

from __future__ import annotations

import asyncio
import os
import socket
import threading
from typing import Dict, Optional, Tuple

from ..api import Error
from ..core.script_error import ScriptError
from ..models.batch import BatchItem, BatchResult
from ..obs import counter as _obs_counter
from ..obs import flight as _flight
from ..obs import monotonic as _monotonic
from ..resilience import faults as _faults
from .server import OverloadError, PendingVerify, VerifyServer

__all__ = [
    "FRAME_REQ",
    "FRAME_RESP",
    "FRAME_ERR",
    "ERR_PROTO_OVERSIZED",
    "ERR_PROTO_MALFORMED",
    "ERR_PROTO_BAD_TYPE",
    "ERR_INTERNAL",
    "HEADER_LEN",
    "IngressServer",
    "encode_frame",
    "decode_header",
    "encode_item",
    "decode_item",
    "encode_request",
    "decode_request",
    "encode_response",
    "decode_response_payload",
    "encode_error",
    "decode_error_payload",
]

FRAME_REQ = 0x01
FRAME_RESP = 0x02
FRAME_ERR = 0x03
HEADER_LEN = 5

# ERR-frame codes. Values < 0x100 are `api.Error` transport codes (a
# shed arrives as ERR_OVERLOADED and is safe to retry); values >= 0x100
# are ingress protocol errors — deterministic, never retried.
ERR_PROTO_OVERSIZED = 0x100
ERR_PROTO_MALFORMED = 0x101
ERR_PROTO_BAD_TYPE = 0x102
ERR_INTERNAL = 0x103

_NO_SCRIPT_ERR = 0xFFFF

_I_SESSIONS = _obs_counter(
    "consensus_ingress_sessions_total", "ingress sessions accepted"
)
_I_FRAMES = _obs_counter(
    "consensus_ingress_frames_total", "ingress frames, by direction",
    ("dir",),
)
_I_BYTES = _obs_counter(
    "consensus_ingress_bytes_total", "ingress wire bytes, by direction",
    ("dir",),
)
_I_REAPS = _obs_counter(
    "consensus_ingress_deadline_reaps_total",
    "sessions reaped by the per-connection read deadline "
    "(slow-loris / half-open peers)",
)
_I_PROTO_ERRS = _obs_counter(
    "consensus_ingress_protocol_errors_total",
    "malformed/oversized/truncated frames (session closed, typed ERR sent)",
)


def _note_proto_err(kind: str) -> None:
    """Count a protocol error and land it in the flight ring (the
    recorder subscribes to ingress protocol errors by contract)."""
    _I_PROTO_ERRS.inc()
    _flight.record("ingress.proto_error", err=kind)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


# -- wire codec (shared with serving/client.py) ------------------------


def encode_frame(ftype: int, payload: bytes) -> bytes:
    return bytes([ftype]) + len(payload).to_bytes(4, "big") + payload


def decode_header(hdr: bytes) -> Tuple[int, int]:
    return hdr[0], int.from_bytes(hdr[1:5], "big")


def _enc_bytes(b: bytes, width: int = 4) -> bytes:
    return len(b).to_bytes(width, "big") + b


class _Cursor:
    """Bounds-checked reader over one frame payload: any overrun is a
    malformed frame, surfaced as ValueError to the protocol layer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated payload")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def u(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def i64(self) -> int:
        return int.from_bytes(self.take(8), "big", signed=True)

    def blob(self, width: int = 4) -> bytes:
        return self.take(self.u(width))

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError("trailing bytes in payload")


def encode_item(item: BatchItem) -> bytes:
    """`BatchItem`, field-for-field: `tx:u32+bytes input_index:u32
    flags:u32 amount:i64 [script:u32+bytes] [n:u16 (amount:i64
    script:u32+bytes)*]` — the two optional tails behind u8 presence
    flags, so the legacy single-prevout form and the taproot
    `spent_outputs` form share one frame type."""
    out = [
        _enc_bytes(item.spending_tx),
        item.input_index.to_bytes(4, "big"),
        item.flags.to_bytes(4, "big"),
        int(item.amount).to_bytes(8, "big", signed=True),
    ]
    if item.spent_output_script is None:
        out.append(b"\x00")
    else:
        out.append(b"\x01" + _enc_bytes(item.spent_output_script))
    if item.spent_outputs is None:
        out.append(b"\x00")
    else:
        out.append(b"\x01" + len(item.spent_outputs).to_bytes(2, "big"))
        for amt, spk in item.spent_outputs:
            out.append(int(amt).to_bytes(8, "big", signed=True))
            out.append(_enc_bytes(spk))
    return b"".join(out)


def _decode_item(cur: _Cursor) -> BatchItem:
    spending_tx = cur.blob()
    input_index = cur.u(4)
    flags = cur.u(4)
    amount = cur.i64()
    script = cur.blob() if cur.u(1) else None
    spent_outputs = None
    if cur.u(1):
        spent_outputs = [
            (cur.i64(), cur.blob()) for _ in range(cur.u(2))
        ]
    return BatchItem(
        spending_tx=spending_tx,
        input_index=input_index,
        flags=flags,
        spent_output_script=script,
        amount=amount,
        spent_outputs=spent_outputs,
    )


def decode_item(payload: bytes) -> BatchItem:
    cur = _Cursor(payload)
    item = _decode_item(cur)
    cur.done()
    return item


def encode_request(rid: int, tenant: str, item: BatchItem) -> bytes:
    tb = tenant.encode("utf-8")
    return (
        rid.to_bytes(4, "big") + _enc_bytes(tb, 2) + encode_item(item)
    )


def decode_request(payload: bytes) -> Tuple[int, str, BatchItem]:
    cur = _Cursor(payload)
    rid = cur.u(4)
    tenant = cur.blob(2).decode("utf-8")
    item = _decode_item(cur)
    cur.done()
    return rid, tenant, item


def encode_response(rid: int, res: BatchResult) -> bytes:
    se = _NO_SCRIPT_ERR if res.script_error is None else int(res.script_error)
    return (
        rid.to_bytes(4, "big")
        + bytes([1 if res.ok else 0])
        + int(res.error).to_bytes(2, "big")
        + se.to_bytes(2, "big")
    )


def decode_response_payload(payload: bytes) -> Tuple[int, BatchResult]:
    cur = _Cursor(payload)
    rid = cur.u(4)
    ok = cur.u(1) != 0
    err = Error(cur.u(2))
    se_raw = cur.u(2)
    cur.done()
    se = None if se_raw == _NO_SCRIPT_ERR else ScriptError(se_raw)
    return rid, BatchResult(ok, err, se)


def encode_error(rid: int, code: int, reason: str) -> bytes:
    return (
        rid.to_bytes(4, "big")
        + code.to_bytes(2, "big")
        + _enc_bytes(reason.encode("utf-8"), 2)
    )


def decode_error_payload(payload: bytes) -> Tuple[int, int, str]:
    cur = _Cursor(payload)
    rid = cur.u(4)
    code = cur.u(2)
    reason = cur.blob(2).decode("utf-8", "replace")
    cur.done()
    return rid, code, reason


# -- server ------------------------------------------------------------


class _Session:
    """One accepted connection: its stream pair, a write lock (response
    callbacks land concurrently), and the rids awaiting settlement."""

    __slots__ = ("reader", "writer", "wlock", "pending", "alive")

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.wlock = asyncio.Lock()
        self.pending: Dict[int, PendingVerify] = {}
        self.alive = True


class IngressServer:
    """TCP front end for one `VerifyServer`; context-managed.

    The listening socket is bound synchronously in `start()` (so `port`
    is known immediately, ephemeral binds included); sessions run on a
    dedicated asyncio loop in a daemon thread. Shutdown order matters:
    close the ingress first (drain flushes responses through the still-
    running serving worker), then the `VerifyServer`."""

    def __init__(
        self,
        verify_server: VerifyServer,
        host: str = "127.0.0.1",
        port: Optional[int] = None,
        idle_s: Optional[float] = None,
        max_frame: Optional[int] = None,
        drain_timeout_s: float = 30.0,
    ):
        self._verify = verify_server
        self.host = host
        self._want_port = (
            port
            if port is not None
            else _env_int("BITCOINCONSENSUS_TPU_INGRESS_PORT", 0)
        )
        self.idle_s = (
            idle_s
            if idle_s is not None
            else _env_float("BITCOINCONSENSUS_TPU_INGRESS_IDLE_S", 30.0)
        )
        self.max_frame = (
            max_frame
            if max_frame is not None
            else _env_int("BITCOINCONSENSUS_TPU_INGRESS_MAX_FRAME", 1 << 20)
        )
        self.drain_timeout_s = drain_timeout_s
        self.port: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._listener: Optional[asyncio.base_events.Server] = None
        self._sessions: set = set()
        self._tasks: set = set()
        self._closed = False

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "IngressServer":
        if self._thread is not None:
            return self
        if self._closed:
            raise RuntimeError("ingress already closed")
        self._sock = socket.create_server(
            (self.host, self._want_port), reuse_port=False
        )
        self.port = self._sock.getsockname()[1]
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="ingress-loop", daemon=True
        )
        self._thread.start()
        fut = asyncio.run_coroutine_threadsafe(self._serve(), self._loop)
        fut.result(timeout=10)
        return self

    async def _serve(self) -> None:
        self._listener = await asyncio.start_server(
            self._handle, sock=self._sock
        )

    def __enter__(self) -> "IngressServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    def close(self, drain: bool = True) -> None:
        """Stop the listener; with drain, wait (bounded by
        `drain_timeout_s`) for every submitted request's response to
        flush before closing sessions. Idempotent."""
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
        # Stop accepting, but await the listener only after the sessions
        # are torn down: since Python 3.12 `Server.wait_closed()` waits for
        # every open connection, so awaiting it first would hold a close
        # until each idle session's read deadline (`idle_s`) expired.
        if self._listener is not None:
            self._listener.close()
        if drain:
            deadline = _monotonic() + self.drain_timeout_s
            while (
                any(s.pending for s in self._sessions)
                and _monotonic() < deadline
            ):
                await asyncio.sleep(0.01)
        for sess in list(self._sessions):
            self._teardown(sess)
        # Let the session tasks observe their closed transports and
        # unwind before the loop dies — otherwise they are destroyed
        # mid-read with their exceptions unretrieved.
        tasks = [t for t in self._tasks if not t.done()]
        if tasks:
            await asyncio.wait(tasks, timeout=5)
        if self._listener is not None:
            try:
                await asyncio.wait_for(self._listener.wait_closed(), 5)
            except (asyncio.TimeoutError, TimeoutError):
                pass  # a connection that outlived its session task

    def _teardown(self, sess: _Session) -> None:
        sess.alive = False
        try:
            sess.writer.close()
        except Exception:
            pass

    # -- session handling ----------------------------------------------

    async def _handle(self, reader, writer) -> None:
        sess = _Session(reader, writer)
        self._sessions.add(sess)
        self._tasks.add(asyncio.current_task())
        _I_SESSIONS.inc()
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

    async def _read_exactly(self, sess: _Session, n: int) -> bytes:
        # The chaos site models a failed/reset read: torn down as if the
        # peer vanished — this session only, counted, never propagated.
        _faults.maybe_raise("ingress.read")
        return await asyncio.wait_for(
            sess.reader.readexactly(n), self.idle_s
        )

    async def _session_loop(self, sess: _Session) -> None:
        while sess.alive:
            try:
                hdr = await self._read_exactly(sess, HEADER_LEN)
            except asyncio.IncompleteReadError as e:
                if e.partial:  # died mid-header: a truncated frame
                    _note_proto_err("truncated_header")
                return  # clean EOF between frames: normal close
            except (asyncio.TimeoutError, TimeoutError):
                _I_REAPS.inc()
                return
            except (_faults.InjectedFault, ConnectionError, OSError):
                return
            ftype, ln = decode_header(hdr)
            if ln > self.max_frame:
                _note_proto_err("oversized")
                await self._send_err(
                    sess, 0, ERR_PROTO_OVERSIZED,
                    f"frame of {ln} bytes exceeds max_frame={self.max_frame}",
                )
                return
            try:
                payload = await self._read_exactly(sess, ln)
            except asyncio.IncompleteReadError:
                _note_proto_err("truncated_frame")  # header promised more
                return
            except (asyncio.TimeoutError, TimeoutError):
                _I_REAPS.inc()  # slow-loris: started a frame, stalled
                return
            except (_faults.InjectedFault, ConnectionError, OSError):
                return
            _I_FRAMES.inc(dir="in")
            _I_BYTES.inc(HEADER_LEN + ln, dir="in")
            if not await self._dispatch(sess, ftype, payload):
                return

    async def _dispatch(
        self, sess: _Session, ftype: int, payload: bytes
    ) -> bool:
        """Handle one inbound frame; False closes the session."""
        if ftype != FRAME_REQ:
            _note_proto_err("bad_type")
            await self._send_err(
                sess, 0, ERR_PROTO_BAD_TYPE, f"unexpected frame type {ftype}"
            )
            return False
        try:
            rid, tenant, item = decode_request(payload)
        except (ValueError, UnicodeDecodeError, OverflowError) as e:
            _note_proto_err("malformed")
            await self._send_err(sess, 0, ERR_PROTO_MALFORMED, str(e))
            return False
        try:
            req = self._verify.submit(item, tenant)
        except OverloadError as e:
            # The shed, on the wire: explicit, typed, retryable. The
            # session stays open — overload is the server's state, not
            # the client's error.
            return await self._send_err(
                sess, rid, int(Error.ERR_OVERLOADED), e.reason
            )
        sess.pending[rid] = req
        req.add_done_callback(
            lambda _req, s=sess, r=rid: self._on_settled(s, r)
        )
        return True

    def _on_settled(self, sess: _Session, rid: int) -> None:
        """Worker-thread → loop-thread hop for one settled request."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        try:
            loop.call_soon_threadsafe(
                lambda: loop.create_task(self._respond(sess, rid))
            )
        except RuntimeError:
            pass  # loop stopped between the check and the call

    async def _respond(self, sess: _Session, rid: int) -> None:
        req = sess.pending.pop(rid, None)
        if req is None or not sess.alive:
            return
        try:
            res = req.result(timeout=0)  # settled: never blocks the loop
        except OverloadError as e:  # cancelled by a non-drain close
            await self._send_err(
                sess, rid, int(Error.ERR_OVERLOADED), e.reason
            )
            return
        except BaseException as e:  # batch-driver failure: explicit
            await self._send_err(
                sess, rid, ERR_INTERNAL, f"{type(e).__name__}: {e}"
            )
            return
        await self._send(sess, FRAME_RESP, encode_response(rid, res))

    async def _send_err(
        self, sess: _Session, rid: int, code: int, reason: str
    ) -> bool:
        return await self._send(
            sess, FRAME_ERR, encode_error(rid, code, reason)
        )

    async def _send(self, sess: _Session, ftype: int, payload: bytes) -> bool:
        frame = encode_frame(ftype, payload)
        try:
            async with sess.wlock:
                _faults.maybe_raise("ingress.write")
                sess.writer.write(frame)
                await sess.writer.drain()
        except (_faults.InjectedFault, ConnectionError, OSError):
            self._teardown(sess)
            return False
        _I_FRAMES.inc(dir="out")
        _I_BYTES.inc(len(frame), dir="out")
        return True
