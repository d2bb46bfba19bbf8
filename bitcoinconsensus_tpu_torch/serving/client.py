"""Client paths: bounded-retry submission, in-process or over a socket.

Port of `bitcoinconsensus_tpu/serving/client.py`; the backoff is drawn as
the reference draws it (same RNG calls in the same order).

A shed (`OverloadError`) is a fail-closed reject of work that never
started, so retrying is always safe — but unbounded synchronized
retries would just re-create the overload (the classic thundering
herd). `verify_with_retry` therefore backs off exponentially with
full jitter (a uniform fraction of the current delay, so colliding
clients decorrelate) and gives up after a bounded number of attempts,
re-raising the final error for the caller to surface.

`IngressClient` is the wire transport (serving/ingress.py framing)
with the same error taxonomy the retry loop keys on:

- `OverloadError` — the server said `ERR_OVERLOADED`: retryable.
- `ConnectionError` — the connection died mid-exchange (server
  restart, reaped session, network fault): the request may or may not
  have executed, but verification is idempotent, so this is retryable
  too (the client reconnects lazily on the next call).
- `IngressProtocolError` — the server rejected the *frame* (oversized,
  malformed, internal); deterministic, NEVER retried: resending a bad
  request reproduces the error and the retry budget would just burn.

`time.sleep` is the only time-API use here (sleeping, not reading a
clock — the host-lint timing rule distinguishes the two); the RNG is
injectable so tests and the chaos sweep stay deterministic.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import Optional, Sequence, Tuple, Union

from ..api import Error
from ..models.batch import BatchItem, BatchResult
from .ingress import (
    FRAME_ERR,
    FRAME_REQ,
    FRAME_RESP,
    HEADER_LEN,
    decode_error_payload,
    decode_header,
    decode_response_payload,
    encode_frame,
    encode_request,
)
from .server import OverloadError, VerifyServer

__all__ = ["IngressClient", "IngressProtocolError", "verify_with_retry"]


class IngressProtocolError(RuntimeError):
    """The server rejected the frame itself (typed ERR, code >= 0x100,
    or an unexpected wire response). Deterministic — never retried."""

    def __init__(self, code: int, reason: str):
        super().__init__(f"ingress protocol error 0x{code:x}: {reason}")
        self.code = code
        self.reason = reason


class IngressClient:
    """Blocking socket client for one `IngressServer`.

    Connects lazily, reconnects on the call after a connection error,
    and correlates responses by request id (the server may interleave
    them out of request order). Thread-safe: calls serialize on an
    internal lock, so shared use degrades to in-order exchanges.

    Failover: `endpoints` is an ordered list of (host, port) pairs —
    replicas of one service (verdicts are pure functions of the item,
    so any endpoint is as good as any other). A connection error
    rotates to the next endpoint before the caller retries; a shed
    rotates via `rotate()` from the retry loop (the shed endpoint is
    the loaded one — the next may have headroom). With one endpoint
    (the default) rotation is a no-op and behaviour is unchanged.
    `IngressProtocolError` never rotates and is never retried: a
    malformed request is malformed everywhere."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        timeout_s: float = 30.0,
        endpoints: Optional[Sequence[Tuple[str, int]]] = None,
    ):
        if endpoints is None:
            endpoints = [(host, port)]
        if not endpoints:
            raise ValueError("endpoints must be non-empty")
        for _, p in endpoints:
            if p <= 0:
                raise ValueError("port must be a bound ingress port")
        self._endpoints = [tuple(ep) for ep in endpoints]
        self._ep = 0
        self.host, self.port = self._endpoints[0]
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._rid = 0
        self._lock = threading.Lock()

    def __enter__(self) -> "IngressClient":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        with self._lock:
            self._drop_locked()

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    @property
    def endpoint_count(self) -> int:
        return len(self._endpoints)

    def rotate(self) -> None:
        """Advance to the next endpoint (no-op with one endpoint); the
        next call connects there."""
        with self._lock:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        if len(self._endpoints) == 1:
            return
        self._drop_locked()
        self._ep = (self._ep + 1) % len(self._endpoints)
        self.host, self.port = self._endpoints[self._ep]

    def _sock_locked(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s
            )
        return self._sock

    def _recv_exactly(self, sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf.extend(chunk)
        return bytes(buf)

    def verify(self, item: BatchItem, tenant: str = "default") -> BatchResult:
        """One request/response exchange; see the module docstring for
        which failures are retryable."""
        with self._lock:
            self._rid += 1
            rid = self._rid
            frame = encode_frame(
                FRAME_REQ, encode_request(rid, tenant, item)
            )
            try:
                sock = self._sock_locked()
                sock.sendall(frame)
                return self._await_response_locked(sock, rid)
            except (ConnectionError, socket.timeout, OSError) as e:
                # The session is in an unknown framing state: drop it so
                # the next call starts clean — on the next endpoint, if
                # this client has more than one.
                self._drop_locked()
                self._rotate_locked()
                if isinstance(e, ConnectionError):
                    raise
                raise ConnectionError(str(e)) from e

    def _await_response_locked(
        self, sock: socket.socket, rid: int
    ) -> BatchResult:
        while True:
            hdr = self._recv_exactly(sock, HEADER_LEN)
            ftype, ln = decode_header(hdr)
            payload = self._recv_exactly(sock, ln)
            if ftype == FRAME_RESP:
                got, res = decode_response_payload(payload)
                if got == rid:
                    return res
                continue  # stale response from an abandoned exchange
            if ftype == FRAME_ERR:
                got, code, reason = decode_error_payload(payload)
                if got not in (rid, 0):
                    continue
                if code == int(Error.ERR_OVERLOADED):
                    raise OverloadError(reason)
                # Protocol-level ERR frames close the session server-side.
                self._drop_locked()
                raise IngressProtocolError(code, reason)
            self._drop_locked()
            raise IngressProtocolError(
                ftype, "unexpected frame type from server"
            )


def verify_with_retry(
    server: Union[VerifyServer, IngressClient],
    item: BatchItem,
    tenant: str = "default",
    retries: int = 4,
    backoff_s: float = 0.01,
    max_backoff_s: float = 0.25,
    timeout_s: Optional[float] = 60.0,
    rng: Optional[random.Random] = None,
) -> BatchResult:
    """Submit with up to `retries` re-attempts after retryable failures.

    `server` is either an in-process `VerifyServer` (retries sheds
    only) or an `IngressClient` (retries explicit `ERR_OVERLOADED`
    frames and disconnects — never `IngressProtocolError`). Returns the
    settled `BatchResult`; re-raises the last retryable error once the
    budget is spent. Batch-driver failures, protocol errors, and settle
    timeouts propagate immediately.
    """
    if rng is None:
        rng = random.Random()
    in_proc = isinstance(server, VerifyServer) or hasattr(server, "submit")
    delay = backoff_s
    attempt = 0
    while True:
        try:
            if in_proc:
                pending = server.submit(item, tenant)
            else:
                return server.verify(item, tenant)
        except OverloadError:
            if attempt >= retries:
                raise
            # A shed names THIS endpoint as loaded; a sibling replica
            # may have headroom. Connection errors already rotated
            # inside `verify`, so only the shed path rotates here.
            if not in_proc and getattr(server, "endpoint_count", 1) > 1:
                server.rotate()
        except ConnectionError:
            # Wire transport only: a dropped session is retryable (the
            # client reconnects), a protocol reject never is.
            if in_proc or attempt >= retries:
                raise
        else:
            if in_proc:
                return pending.result(timeout_s)
        attempt += 1
        time.sleep(delay * (0.5 + rng.random()))  # jitter [0.5x, 1.5x)
        delay = min(delay * 2, max_backoff_s)
