"""The port's network ingress (`serving/ingress.py`, `serving/client.py`) on
the CPU, held against the JAX package's.

- the codec: the port's frame, item, request, response and error encoders
  give the reference's bytes on the same seeded inputs, and each package
  decodes the other's frames;
- the wire across packages: the port's client against the reference's
  server and the reference's client against the port's, over sockets;
- the reference's socket cases (sheds as `ERR_OVERLOADED` frames, the
  deadline reap, oversized, garbage and truncated frames, the draining
  close, the `ingress.read` / `ingress.write` faults, the retry client's
  classification), each on both packages, against a stand-in verify
  server that settles at once;
- real verdicts: the port's `IngressServer` over a `VerifyServer` on
  `TorchSecpVerifier(device="cpu")`, pipelined rids from two clients,
  equal to the JAX package's per-input API.
"""

import random
import socket
import threading
import time
import types

import pytest

from torch_serving_common import mixed_items, norm, patch_plain_rows, reference

from bitcoinconsensus_tpu import api as JAPI
from bitcoinconsensus_tpu import serving as JS
from bitcoinconsensus_tpu.core.script_error import ScriptError as JScriptError
from bitcoinconsensus_tpu.models import batch as JBATCH
from bitcoinconsensus_tpu.resilience import faults as JF
from bitcoinconsensus_tpu.serving import ingress as JING
from bitcoinconsensus_tpu_torch import api as TAPI
from bitcoinconsensus_tpu_torch import serving as TS
from bitcoinconsensus_tpu_torch.core.script_error import ScriptError as TScriptError
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models import batch as TBATCH
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.resilience import faults as TF
from bitcoinconsensus_tpu_torch.serving import ingress as TING

PKGS = {
    "jax_package": types.SimpleNamespace(S=JS, ING=JING, B=JBATCH, API=JAPI, F=JF,
                                         SE=JScriptError),
    "port": types.SimpleNamespace(S=TS, ING=TING, B=TBATCH, API=TAPI, F=TF,
                                  SE=TScriptError),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _variants(B):
    rng = random.Random(5)
    blob = lambda n: bytes(rng.randrange(256) for _ in range(n))  # noqa: E731
    return [
        B.BatchItem(blob(60), 0, 0),
        B.BatchItem(blob(91), 3, 0x1F, spent_output_script=b"", amount=0),
        B.BatchItem(blob(120), 1, 0x20E15, spent_output_script=blob(25),
                    amount=-5),
        B.BatchItem(blob(200), 2, 0x20E15,
                    spent_outputs=[(rng.randrange(1 << 40), blob(34)) for _ in range(3)]),
        B.BatchItem(b"", 0, 0, spent_outputs=[]),
    ]


def _results(pkg):
    B, API, SE = pkg.B, pkg.API, pkg.SE
    return [B.BatchResult(True, API.Error.ERR_OK, SE.OK),
            B.BatchResult(False, API.Error.ERR_SCRIPT, SE.EVAL_FALSE),
            B.BatchResult(False, API.Error.ERR_TX_INDEX, None),
            B.BatchResult(False, API.Error.ERR_SCRIPT, SE.SIG_DER)]


# -- the codec ----------------------------------------------------------------


def test_codec_bytes_equal_the_reference():
    J, T = PKGS["jax_package"], PKGS["port"]
    for jit, tit in zip(_variants(J.B), _variants(T.B), strict=True):
        assert TING.encode_item(tit) == JING.encode_item(jit)
        assert TING.encode_request(9, "tenant-ä", tit) == JING.encode_request(9, "tenant-ä", jit)
        jf = JING.encode_frame(JING.FRAME_REQ, JING.encode_request(7, "t", jit))
        tf = TING.encode_frame(TING.FRAME_REQ, TING.encode_request(7, "t", tit))
        assert tf == jf
    for jr, tr in zip(_results(J), _results(T), strict=True):
        assert TING.encode_response(4, tr) == JING.encode_response(4, jr)
    assert TING.encode_error(3, 7, "slo") == JING.encode_error(3, 7, "slo")
    assert (TING.FRAME_REQ, TING.FRAME_RESP, TING.FRAME_ERR, TING.HEADER_LEN) == \
        (JING.FRAME_REQ, JING.FRAME_RESP, JING.FRAME_ERR, JING.HEADER_LEN)
    assert (TING.ERR_PROTO_OVERSIZED, TING.ERR_PROTO_MALFORMED, TING.ERR_PROTO_BAD_TYPE,
            TING.ERR_INTERNAL) == (JING.ERR_PROTO_OVERSIZED, JING.ERR_PROTO_MALFORMED,
                                   JING.ERR_PROTO_BAD_TYPE, JING.ERR_INTERNAL)
    assert int(TAPI.Error.ERR_OVERLOADED) == int(JAPI.Error.ERR_OVERLOADED) == 7


@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_each_package_decodes_the_others_frames(writer):
    w = PKGS[writer]
    r = PKGS["port" if writer == "jax_package" else "jax_package"]
    for item in _variants(w.B):
        rid, tenant, got = r.ING.decode_request(w.ING.encode_request(11, "tn", item))
        assert (rid, tenant) == (11, "tn")
        assert w.ING.encode_item(item) == r.ING.encode_item(got)
        assert r.ING.decode_item(w.ING.encode_item(item)) == got
    for res in _results(w):
        rid, got = r.ING.decode_response_payload(w.ING.encode_response(2, res))
        assert rid == 2 and (got.ok, int(got.error)) == (res.ok, int(res.error))
        assert (None if got.script_error is None else int(got.script_error)) == \
            (None if res.script_error is None else int(res.script_error))
    assert r.ING.decode_error_payload(w.ING.encode_error(0, 0x101, "bad")) == (0, 0x101, "bad")
    assert r.ING.decode_header(w.ING.encode_frame(3, b"xyz")[:5]) == (3, 3)


def test_malformed_payload_rejected(pkg):
    good = pkg.ING.encode_request(1, "t", pkg.B.BatchItem(b"tx", 0, 0))
    for bad in (good[:-1], good + b"\0", b"", b"\0\0\0\1\0\5ab"):
        with pytest.raises((ValueError, UnicodeDecodeError)):
            pkg.ING.decode_request(bad)


# -- sockets ------------------------------------------------------------------


def _recv_exactly(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "connection closed mid-frame"
        buf += chunk
    return buf


def _recv_frame(ing, sock):
    ftype, ln = ing.decode_header(_recv_exactly(sock, ing.HEADER_LEN))
    return ftype, _recv_exactly(sock, ln)


class _StubVerify:
    """Stand-in for a `VerifyServer` of package `pkg`: settles each submit
    (after `delay_s` on a timer) or sheds with `shed_reason`."""

    def __init__(self, pkg, delay_s=0.0, shed_reason=None):
        self.pkg = pkg
        self.delay_s = delay_s
        self.shed_reason = shed_reason
        self.submitted = []

    def submit(self, item, tenant="default"):
        if self.shed_reason is not None:
            raise self.pkg.S.OverloadError(self.shed_reason)
        req = self.pkg.S.PendingVerify(item, tenant, 0.0)
        self.submitted.append(req)
        res = self.pkg.B.BatchResult(len(item.spending_tx) % 2 == 0,
                                     self.pkg.API.Error.ERR_OK, self.pkg.SE.OK)
        if self.delay_s > 0:
            threading.Timer(self.delay_s, req._resolve, (res,)).start()
        else:
            req._resolve(res)
        return req


@pytest.mark.parametrize("server", ["jax_package", "port"])
def test_wire_interop_across_packages(server):
    srv = PKGS[server]
    cli = PKGS["port" if server == "jax_package" else "jax_package"]
    with srv.ING.IngressServer(_StubVerify(srv), idle_s=5.0) as ing:
        with cli.S.IngressClient(port=ing.port) as c:
            assert c.verify(cli.B.BatchItem(b"tx", 0, 0)).ok
            assert not c.verify(cli.B.BatchItem(b"odd", 0, 0)).ok
    with srv.ING.IngressServer(_StubVerify(srv, shed_reason="slo")) as ing:
        with cli.S.IngressClient(port=ing.port) as c:
            with pytest.raises(cli.S.OverloadError) as ei:
                c.verify(cli.B.BatchItem(b"tx", 0, 0))
            assert ei.value.reason == "slo"


def test_shed_arrives_as_overloaded_frame_session_survives(pkg):
    stub = _StubVerify(pkg, shed_reason="tenant_full")
    with pkg.ING.IngressServer(stub, idle_s=5.0) as ing:
        with pkg.S.IngressClient(port=ing.port) as cli:
            with pytest.raises(pkg.S.OverloadError) as ei:
                cli.verify(pkg.B.BatchItem(b"tx", 0, 0))
            assert ei.value.code == pkg.API.Error.ERR_OVERLOADED
            stub.shed_reason = None
            assert cli.verify(pkg.B.BatchItem(b"tx", 0, 0)).ok


def test_deadline_reaps_stalled_session(pkg):
    reaps0 = pkg.ING._I_REAPS.value()
    with pkg.ING.IngressServer(_StubVerify(pkg), idle_s=0.2) as ing:
        sock = socket.create_connection(("127.0.0.1", ing.port), timeout=5)
        sock.sendall(bytes([pkg.ING.FRAME_REQ]) + (100).to_bytes(4, "big") + b"ab")
        sock.settimeout(5)
        assert sock.recv(1) == b""
        sock.close()
        assert pkg.ING._I_REAPS.value() == reaps0 + 1
        with pkg.S.IngressClient(port=ing.port) as cli:
            assert cli.verify(pkg.B.BatchItem(b"tx", 0, 0)).ok


def test_oversized_garbage_and_truncated_frames(pkg):
    ING = pkg.ING
    errs0 = ING._I_PROTO_ERRS.value()
    with ING.IngressServer(_StubVerify(pkg), idle_s=5.0, max_frame=1024) as ing:
        for frame, code in (
                (bytes([ING.FRAME_REQ]) + (2048).to_bytes(4, "big"), ING.ERR_PROTO_OVERSIZED),
                (ING.encode_frame(0x7F, b"junk"), ING.ERR_PROTO_BAD_TYPE),
                (ING.encode_frame(ING.FRAME_REQ, b"\xff\xfe\xfd"), ING.ERR_PROTO_MALFORMED)):
            s = socket.create_connection(("127.0.0.1", ing.port), timeout=5)
            s.sendall(frame)
            ftype, payload = _recv_frame(ING, s)
            assert ftype == ING.FRAME_ERR
            assert ING.decode_error_payload(payload)[:2] == (0, code)
            assert s.recv(1) == b""
            s.close()
        s = socket.create_connection(("127.0.0.1", ing.port), timeout=5)
        s.sendall(bytes([ING.FRAME_REQ]) + (64).to_bytes(4, "big") + b"half")
        s.close()  # a mid-frame disconnect
        deadline = time.monotonic() + 5
        while ING._I_PROTO_ERRS.value() < errs0 + 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ING._I_PROTO_ERRS.value() == errs0 + 4
        with pkg.S.IngressClient(port=ing.port) as cli:
            assert cli.verify(pkg.B.BatchItem(b"tx", 0, 0)).ok


def test_graceful_drain_flushes_inflight_responses(pkg):
    ING = pkg.ING
    stub = _StubVerify(pkg, delay_s=0.3)
    ing = ING.IngressServer(stub, idle_s=2.0).start()
    sock = socket.create_connection(("127.0.0.1", ing.port), timeout=5)
    sock.sendall(ING.encode_frame(ING.FRAME_REQ,
                                  ING.encode_request(5, "t", pkg.B.BatchItem(b"tx", 0, 0))))
    deadline = time.monotonic() + 5
    while not stub.submitted and time.monotonic() < deadline:
        time.sleep(0.01)
    ing.close(drain=True)
    ftype, payload = _recv_frame(ING, sock)
    assert ftype == ING.FRAME_RESP
    rid, res = ING.decode_response_payload(payload)
    assert rid == 5 and res.ok
    assert sock.recv(1) == b""
    sock.close()
    ing.close()  # idempotent


def test_read_and_write_faults_contained_and_recovered(pkg):
    F = pkg.F
    with pkg.ING.IngressServer(_StubVerify(pkg), idle_s=5.0) as ing:
        with F.inject(F.FaultPlan([F.FaultSpec("ingress.read", "raise", count=1)]),
                      seed=0) as inj:
            with pkg.S.IngressClient(port=ing.port) as cli:
                with pytest.raises(ConnectionError):
                    cli.verify(pkg.B.BatchItem(b"tx", 0, 0))
        assert inj.fired[("ingress.read", "raise")] == 1
        cli = pkg.S.IngressClient(port=ing.port)
        with F.inject(F.FaultPlan([F.FaultSpec("ingress.write", "raise", count=1)]),
                      seed=0) as inj:
            res = pkg.S.verify_with_retry(cli, pkg.B.BatchItem(b"tx", 0, 0), retries=3,
                                          backoff_s=0.01, rng=random.Random(0))
        assert res.ok and inj.fired[("ingress.write", "raise")] == 1
        cli.close()


class _ScriptedClient:
    def __init__(self, pkg, script):
        self.pkg = pkg
        self.script = list(script)
        self.calls = 0

    def verify(self, item, tenant="default"):
        self.calls += 1
        step = self.script.pop(0)
        if isinstance(step, BaseException):
            raise step
        return step


def test_retry_classification(pkg):
    S = pkg.S
    ok = pkg.B.BatchResult(True, pkg.API.Error.ERR_OK, pkg.SE.OK)
    cli = _ScriptedClient(pkg, [S.OverloadError("slo"), ConnectionError("x"), ok])
    assert S.verify_with_retry(cli, None, backoff_s=0.001, rng=random.Random(0)) is ok
    assert cli.calls == 3
    cli = _ScriptedClient(pkg, [S.IngressProtocolError(0x101, "bad"), ok])
    with pytest.raises(S.IngressProtocolError):
        S.verify_with_retry(cli, None, backoff_s=0.001, rng=random.Random(0))
    assert cli.calls == 1
    cli = _ScriptedClient(pkg, [ConnectionError("x")] * 3)
    with pytest.raises(ConnectionError):
        S.verify_with_retry(cli, None, retries=2, backoff_s=0.001, rng=random.Random(0))


# -- real verdicts over the socket --------------------------------------------


def test_socket_verdicts_equal_the_jax_api(monkeypatch):
    """Two sessions each pipeline 8 requests (rids sent before any answer
    is read); the 16 coalesce into one batch; every verdict, matched by
    rid, equals the JAX package's per-input API."""
    patch_plain_rows(monkeypatch)
    items, _ = mixed_items(64, seed=3)
    items = items[:16]
    verifier = TorchSecpVerifier(device="cpu")
    vs = TS.VerifyServer(verifier=verifier, sig_cache=SigCache(),
                         script_cache=ScriptExecutionCache(), max_batch=16,
                         flush_s=30.0).start()
    got = {}
    try:
        with TS.IngressServer(vs, idle_s=60.0) as ing:
            socks = [socket.create_connection(("127.0.0.1", ing.port), timeout=120)
                     for _ in range(2)]
            for i, it in enumerate(items):
                socks[i % 2].sendall(TING.encode_frame(
                    TING.FRAME_REQ, TING.encode_request(100 + i, f"t{i % 2}", it)))
            for k, s in enumerate(socks):
                for _ in range(len(items) // 2):
                    ftype, payload = _recv_frame(TING, s)
                    assert ftype == TING.FRAME_RESP
                    rid, res = TING.decode_response_payload(payload)
                    assert (rid - 100) % 2 == k
                    got[rid - 100] = res
                s.close()
    finally:
        vs.close()
    assert norm([got[i] for i in range(len(items))]) == [reference(it) for it in items]
