"""The port's native host core (`csrc/native/`, `native_bridge.py`) against
the port's Python engine and against the JAX package's own core.

The core is built once per process with g++ into `build/torch_kernels/`
(a module fixture; a later process loads the same library at once). Every
comparison is exact: verdicts, `Error`, `ScriptError`, recorded check lists,
packed lane bytes and cache keys. The script_tests.json replay (the
counterpart of tests/test_native_interp.py:54) reads its vectors from the
reference checkout, as the JAX package's does, and skips where that
checkout is absent.
"""

import hashlib
import random
import struct

import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu import api as JAPI
from bitcoinconsensus_tpu import native_bridge as JNB
from bitcoinconsensus_tpu.models.sigcache import ScriptExecutionCache as JScriptCache
from bitcoinconsensus_tpu.models.sigcache import SigCache as JSigCache
from bitcoinconsensus_tpu_torch import api as TAPI
from bitcoinconsensus_tpu_torch import native_bridge as NB
from bitcoinconsensus_tpu_torch.core import flags as F
from bitcoinconsensus_tpu_torch.core.interpreter import (
    TransactionSignatureChecker,
    verify_script,
)
from bitcoinconsensus_tpu_torch.core.script import OP_CHECKMULTISIG, push_data
from bitcoinconsensus_tpu_torch.core.serialize import SerializationError
from bitcoinconsensus_tpu_torch.core.sighash import (
    SIGHASH_ALL,
    PrecomputedTxData,
    bip143_sighash,
)
from bitcoinconsensus_tpu_torch.core.tx import OutPoint, Tx, TxIn, TxOut
from bitcoinconsensus_tpu_torch.crypto import secp_host as H
from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.batch import (
    BatchItem,
    DeferringSignatureChecker,
    verify_batch,
)
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.ops import _build
from bitcoinconsensus_tpu_torch.utils import blockgen as B

torch.set_num_threads(1)  # the plain version's tiny ops gain nothing from more

REPO = _build.BUILD_DIR.parents[1]


@pytest.fixture(scope="module")
def core():
    """The port's core, built (or loaded) once for the module."""
    return NB.lib()


def _sk(i: int) -> int:
    return (i * 2654435761 + 11) % (H.N - 1) + 1


def _msg(i: int) -> bytes:
    return hashlib.sha256(b"torch-native-%d" % i).digest()


def _der(r: int, s: int) -> bytes:
    """Strict DER of (r, s)."""
    def enc(v):
        b = v.to_bytes(33, "big").lstrip(b"\x00") or b"\x00"
        if b[0] >= 0x80:
            b = b"\x00" + b
        return b"\x02" + bytes([len(b)]) + b

    body = enc(r) + enc(s)
    return b"\x30" + bytes([len(body)]) + body


def _mixed_checks(n: int):
    """n seeded valid checks (ECDSA, Schnorr, tweak in turn; tweaks of both
    parities) followed by the structural edge cases the lane packers
    handle: invalid DER, hybrid and garbage pubkeys, a high-S signature, an
    out-of-range Schnorr key and tweak, a flipped tweak parity."""
    out = []
    for i in range(n):
        sk, msg = _sk(i), _msg(i)
        if i % 3 == 0:
            out.append(SigCheck("ecdsa", (H.pubkey_create(sk, compressed=bool(i % 2)),
                                          H.sign_ecdsa(sk, msg), msg)))
        elif i % 3 == 1:
            xpk, _ = H.xonly_pubkey_create(sk)
            out.append(SigCheck("schnorr", (xpk, H.sign_schnorr(sk, msg), msg)))
        else:
            xpk, par = H.xonly_pubkey_create(sk)
            eff = sk if par == 0 else H.N - sk
            t = int.from_bytes(msg, "big") % (H.N - 1) + 1
            q, q_par = H.xonly_pubkey_create((eff + t) % H.N)
            out.append(SigCheck("tweak", (q, q_par, xpk, t.to_bytes(32, "big"))))
    sk, msg = _sk(999), _msg(999)
    pub, sig = H.pubkey_create(sk), H.sign_ecdsa(sk, msg)
    r, s = H.parse_der_lax(sig)
    x, y = H.G.mul(sk).to_affine()
    xy = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    xpk, _ = H.xonly_pubkey_create(sk)
    ssig = H.sign_schnorr(sk, msg)
    tw = out[2].data
    out += [
        SigCheck("ecdsa", (pub, b"\x30\x00", msg)),  # invalid DER
        SigCheck("ecdsa", (pub, b"", msg)),
        SigCheck("ecdsa", (bytes([6 + (y & 1)]) + xy, sig, msg)),  # hybrid
        SigCheck("ecdsa", (bytes([7 - (y & 1)]) + xy, sig, msg)),  # hybrid, bad parity
        SigCheck("ecdsa", (b"\x05" + pub[1:], sig, msg)),  # garbage prefix
        SigCheck("ecdsa", (b"\x02" + b"\xff" * 32, sig, msg)),  # x >= p
        SigCheck("ecdsa", (pub, _der(r, H.N - s), msg)),  # high S
        SigCheck("schnorr", (b"\xff" * 32, ssig, msg)),  # px >= p
        SigCheck("schnorr", (xpk[:31], ssig, msg)),
        SigCheck("tweak", (tw[0], tw[1], tw[2], b"\xff" * 32)),  # t >= n
        SigCheck("tweak", (tw[0], 1 - tw[1], tw[2], tw[3])),  # other parity
    ]
    return out


# -- build and load -----------------------------------------------------------


def test_core_builds_from_the_ports_sources(core):
    built = _build.build(_build.HOST_CORE)
    assert core._name == str(built.path)
    assert built.path.parent == _build.BUILD_DIR
    assert core.nat_version() == NB.NAT_VERSION == 4
    _, flags, srcs = _build._recipe(_build.HOST_CORE)
    port_csrc = REPO / "bitcoinconsensus_tpu_torch" / "csrc" / "native"
    assert [p.parent for p in srcs] == [port_csrc] * 7
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)
                            + " ".join(flags).encode()).hexdigest()[:16]
    assert built.path.name == f"nat-{digest}.so"
    # Each source is the reference's own, under a one-line header.
    for p in srcs:
        ref = REPO / "native" / p.name
        assert p.read_bytes().split(b"\n", 1)[1] == ref.read_bytes(), p.name


def test_failed_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_built", {})
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_gxx", lambda: "/nonexistent/bin/g++")
    monkeypatch.setattr(NB, "_lib", None)
    with pytest.raises(NB.NativeCoreError, match='engine="python"'):
        NB.lib()
    checks = _mixed_checks(3)[:3]
    calls = [
        lambda: TorchSecpVerifier(device="cpu"),
        lambda: verify_batch([], verifier=TorchSecpVerifier(device="cpu", engine="python")),
        lambda: TAPI.verify(b"\x51", 0, b"\x00", 0),
        lambda: SigCache().keys_for_checks(checks),
    ]
    for call in calls:
        with pytest.raises(NB.NativeCoreError):
            call()
    # The Python engine, chosen explicitly, needs no core.
    assert TorchSecpVerifier(device="cpu", engine="python").native is False
    with pytest.raises(TAPI.ConsensusError) as e:
        TAPI.verify(b"\x51", 0, b"\x00", 0, engine="python")
    assert e.value.code == TAPI.Error.ERR_TX_DESERIALIZE
    assert len(SigCache().keys_for_checks(checks, "python")) == 3
    with pytest.raises(ValueError, match="engine"):
        TorchSecpVerifier(device="cpu", engine="rust")


# -- lane packing --------------------------------------------------------------


def _assert_packed_equal(a_tuple, b_tuple):
    names = ["fields", "want_odd", "parity", "has_t2", "neg1", "neg2", "valid"]
    for nm, a, b in zip(names, a_tuple, b_tuple, strict=True):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, nm
        assert a.tobytes() == b.tobytes(), (nm, np.argwhere(a != b)[:5])


@pytest.mark.parametrize("n", [0, 1, 40])
def test_prep_pack_is_byte_equal_to_the_python_packers(core, n):
    checks = _mixed_checks(n) if n == 40 else _mixed_checks(3)[:n]
    v = TorchSecpVerifier(device="cpu", engine="python")
    size = v._pad(len(checks))
    got = NB.prep_pack(checks, size)
    _assert_packed_equal(v._pack_lanes(v._prep_lanes(checks)), got)
    _assert_packed_equal(JNB.prep_pack(checks, size), got)
    if n == 40:  # valid tweaks of both parities, and 8 invalid edge lanes
        assert {c.data[1] for c in checks[:40] if c.kind == "tweak"} == {0, 1}
        assert not got[6][len(checks):].any() and got[6].sum() == len(checks) - 8


# -- the single-check verifies ----------------------------------------------------


def test_native_secp_matches_the_host_oracle(core):
    ns = NB.NativeSecp
    for chk in _mixed_checks(24):
        if chk.kind == "ecdsa":
            assert ns.verify_ecdsa(*chk.data) == H.verify_ecdsa(*chk.data)
        elif chk.kind == "schnorr":
            assert ns.verify_schnorr(*chk.data) == H.verify_schnorr(*chk.data)
        else:
            assert ns.tweak_add_check(*chk.data) == H.xonly_tweak_add_check(*chk.data)
    rng = np.random.default_rng(1234)
    for _ in range(60):
        pub, sig, msg = rng.bytes(int(rng.integers(0, 70))), rng.bytes(
            int(rng.integers(0, 80))), rng.bytes(32)
        assert ns.verify_ecdsa(pub, sig, msg) == H.verify_ecdsa(pub, sig, msg)
        pk32, s64 = rng.bytes(32), rng.bytes(64)
        assert ns.verify_schnorr(pk32, s64, msg) == H.verify_schnorr(pk32, s64, msg)
    v = TorchSecpVerifier(device="cpu")
    for chk in _mixed_checks(6)[:6]:
        assert v._host_check(chk) is True


# -- cache keys ----------------------------------------------------------------------


def test_cache_keys_equal_the_python_and_reference_keys(core):
    checks = _mixed_checks(9)
    sig, jsig = SigCache(), JSigCache()
    jsig._salt = sig._salt
    native = sig.keys_for_checks(checks)
    assert native == sig.keys_for_checks(checks, "python")
    assert native == [jsig._key(jsig._parts(c.kind, c.data)) for c in checks]
    assert len(set(native)) == len(native)
    script, jscript = ScriptExecutionCache(), JScriptCache()
    jscript._salt = script._salt
    items = [
        ScriptExecutionCache._parts(_msg(1), 3, F.VERIFY_ALL_LIBCONSENSUS, _msg(2)),
        (b"", b"x", b""),  # empty parts are still length-prefixed
        (b"\x07" * 600,),
        (),
    ]
    native = script.keys_for_parts(items)
    assert native == script.keys_for_parts(items, "python")
    assert native == [jscript._key(p) for p in items]
    assert NB.digest_checks(sig._salt, []) == NB.digest_streams(sig._salt, []) == []


# -- deferring interpretation ----------------------------------------------------------


def _credit_spend(spk: bytes, script_sig: bytes, witness, value: int) -> Tx:
    """A spend of a one-output credit tx, as the JSON vectors build them."""
    credit = Tx(1, [TxIn(OutPoint(b"\x00" * 32, 0xFFFFFFFF), b"\x00\x00",
                         0xFFFFFFFF)], [TxOut(value, spk)], 0)
    txin = TxIn(OutPoint(credit.txid, 0), script_sig, 0xFFFFFFFF)
    txin.witness = witness
    return Tx(1, [txin], [TxOut(value, b"")], 0)


def _python_defer(tx, n_in, amount, spk, flags, spent, known=None):
    outs = None if spent is None else [TxOut(a, s) for a, s in spent]
    txdata = PrecomputedTxData(tx) if outs is None else PrecomputedTxData(tx, outs)
    checker = DeferringSignatureChecker(tx, n_in, amount, txdata, known=known)
    ok, err = verify_script(tx.vin[n_in].script_sig, spk, tx.vin[n_in].witness,
                            flags, checker)
    return ok, int(err), checker.unknown, [(c.kind, c.data) for c in checker.recorded]


def _native_tx(raw, spent):
    ntx = NB.NativeTx(raw)
    if spent is None:
        ntx.precompute()
    else:
        ntx.set_spent_outputs(spent)
    return ntx


def _cases():
    """(raw, n_in, amount, spk, flags, spent) over random opcode soup and
    the replay mix, corrupted inputs included."""
    rng = random.Random(0xBEEF)
    out = []
    for _ in range(150):
        spk = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 60)))
        ssig = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
        flags = F.LIBCONSENSUS_FLAGS if rng.random() < 0.7 else (
            rng.getrandbits(17) & F.ALL_FLAG_BITS & ~F.VERIFY_TAPROOT)
        out.append((_credit_spend(spk, ssig, [], 0).serialize(), 0, 0, spk, flags, None))
    items, _bad = B.mixed_items(40, seed=11, corrupt_rate=0.1)
    for it in items:
        amt, spk = it.spent_outputs[it.input_index]
        out.append((it.spending_tx, it.input_index, amt, spk, it.flags,
                    list(it.spent_outputs)))
    return out


def test_deferring_interpretation_matches_the_python_checker(core):
    cases = _cases()
    sess = NB.NativeSession()
    ntxs = [_native_tx(raw, spent) for raw, *_r, spent in cases]
    ok, err, unk, recs = sess.verify_inputs(
        ntxs, [c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases],
        [c[4] for c in cases], mode=NB.NativeSession.MODE_DEFER)
    n_recorded = 0
    for j, (raw, n_in, amt, spk, flags, spent) in enumerate(cases):
        want = _python_defer(Tx.deserialize(raw), n_in, amt, spk, flags, spent)
        assert (bool(ok[j]), int(err[j]), int(unk[j]), recs[j]) == want, j
        n_recorded += len(recs[j])
        # One input alone through the single-input call: the same answer.
        s1 = NB.NativeSession()
        single = s1.verify_input(ntxs[j], n_in, amt, spk, flags)
        assert single + (s1.take_records(),) == (bool(ok[j]), int(err[j]),
                                                 int(unk[j]), recs[j])
    assert n_recorded > 40


@pytest.mark.parametrize("answer", [True, False])
def test_oracle_replay_matches_the_python_checker(core, answer):
    """Every recorded check published with one answer: both engines then
    read the oracle alone (no unknowns) and reach the same verdict."""
    for raw, n_in, amt, spk, flags, spent in _cases()[150:170]:
        tx = Tx.deserialize(raw)
        recorded = _python_defer(tx, n_in, amt, spk, flags, spent)[3]
        known = {rec: answer for rec in recorded}
        want = _python_defer(tx, n_in, amt, spk, flags, spent, known=known)
        sess = NB.NativeSession()
        sess.add_known_batch([(k, d, r) for (k, d), r in known.items()])
        one = NB.NativeSession()
        for (k, d), r in known.items():
            one.add_known(k, d, r)
        for s in (sess, one):
            got = s.verify_input(_native_tx(raw, spent), n_in, amt, spk, flags)
            assert got + (s.take_records(),) == want
        if answer:
            assert want[2] == 0 and want[0]


def _misaligned_multisig(seed: str, corrupt: bool = False) -> BatchItem:
    """P2WSH 2-of-3 signed by keys 0 and 2: the CHECKMULTISIG cursor must
    find the (sig1, key2) pairing, which only oracle answers reveal."""
    sks = [B._sk(f"{seed}/k{i}") for i in range(3)]
    pubs = [H.pubkey_create(sk) for sk in sks]
    wscript = (b"\x52" + b"".join(push_data(p) for p in pubs) + b"\x53"
               + bytes([OP_CHECKMULTISIG]))
    spk = b"\x00\x20" + hashlib.sha256(wscript).digest()
    amount = 90_000
    tx = Tx(2, [TxIn(OutPoint(hashlib.sha256(seed.encode()).digest(), 0))],
            [TxOut(amount - 900, b"\x51")], 0)
    sighash = bip143_sighash(wscript, tx, 0, SIGHASH_ALL, amount)
    sigs = [H.sign_ecdsa(sks[i], sighash) + bytes([SIGHASH_ALL]) for i in (0, 2)]
    if corrupt:
        sigs[1] = sigs[1][:10] + bytes([sigs[1][10] ^ 1]) + sigs[1][11:]
    tx.vin[0].witness = [b""] + sigs + [wscript]
    return BatchItem(tx.serialize(), 0, F.VERIFY_ALL_LIBCONSENSUS, spk, amount)


@pytest.mark.parametrize("corrupt", [False, True])
def test_misaligned_multisig_single_dispatch(core, corrupt, monkeypatch):
    """The native engine's speculative pairings resolve a misaligned 2-of-3
    in one dispatch of its 4 reachable pairings, in index mode (through
    `dispatch_lanes`) and in the wire driver (through `verify_checks`); the
    Python engine needs the fixpoint's second. A corrupted second signature
    fails exactly."""
    item = _misaligned_multisig("torch-spec" + "-bad" * corrupt, corrupt)
    want = _reference(JAPI, item)
    assert want[0] is (not corrupt)
    for engine, idx, sizes in (("native", "1", [("dispatch_lanes", 4)]),
                               ("native", "0", [("verify_checks", 4)]),
                               ("python", "1", None)):
        monkeypatch.setenv("BITCOINCONSENSUS_TPU_IDX", idx)
        v = TorchSecpVerifier(device="cpu", engine=engine)
        calls = []
        checks_seam, lanes_seam = v.verify_checks, v.dispatch_lanes
        v.verify_checks = lambda checks: (calls.append(("verify_checks", len(checks)))
                                          or checks_seam(checks))
        v.dispatch_lanes = lambda args, n: (calls.append(("dispatch_lanes", n))
                                            or lanes_seam(args, n))
        got = verify_batch([item], verifier=v, sig_cache=SigCache(),
                           script_cache=ScriptExecutionCache(), engine=engine)
        assert _norm(got) == [want]
        if sizes is not None:
            assert calls == sizes
        else:
            assert len(calls) >= 2 and {c[0] for c in calls} == {"verify_checks"}


def test_malformed_tx_with_huge_claimed_counts(core):
    evil = struct.pack("<i", 1) + b"\xfe" + struct.pack("<I", 0x01FFFFFF)
    evil2 = (struct.pack("<i", 1) + b"\x00\x01" + b"\x01" + b"\x00" * 36 + b"\x00"
             + b"\xff\xff\xff\xff" + b"\x00" + b"\xfe" + struct.pack("<I", 0x01FFFFFF))
    for raw in (evil, evil2):
        with pytest.raises(ValueError):
            NB.NativeTx(raw)
        with pytest.raises(SerializationError):
            Tx.deserialize(raw)
    for engine in NB.ENGINES:
        with pytest.raises(TAPI.ConsensusError) as e:
            TAPI.verify(b"\x51", 0, evil, 0, engine=engine)
        assert e.value.code == TAPI.Error.ERR_TX_DESERIALIZE


def test_script_vectors_native_exact(core):
    """script_tests.json through the native engine in exact mode against the
    Python engine (tests/test_native_interp.py:54's replay for the port)."""
    from test_vectors_json import iter_script_tests, parse_flags

    from bitcoinconsensus_tpu_torch.utils.script_asm import parse_asm

    n_run, failures = 0, []
    for idx, test, witness, value, pos in iter_script_tests():
        ssig, spk = parse_asm(test[pos]), parse_asm(test[pos + 1])
        flags = parse_flags(test[pos + 2])
        if flags & F.VERIFY_CLEANSTACK:
            flags |= F.VERIFY_P2SH | F.VERIFY_WITNESS
        spend = _credit_spend(spk, ssig, witness, value)
        checker = TransactionSignatureChecker(spend, 0, value, PrecomputedTxData(spend))
        want = verify_script(ssig, spk, witness, flags, checker)
        got = NB.NativeSession().verify_input(
            _native_tx(spend.serialize(), None), 0, value, spk, flags,
            mode=NB.NativeSession.MODE_EXACT)
        n_run += 1
        if (got[0], got[1]) != (want[0], int(want[1])):
            failures.append((idx, want, got))
    assert not failures, failures[:10]
    assert n_run > 1000


# -- verify_batch and the api ------------------------------------------------------------


def _reference(api, item):
    try:
        if item.spent_outputs is not None:
            api.verify_with_spent_outputs(item.spending_tx, item.input_index,
                                          item.spent_outputs, item.flags)
        else:
            api.verify_with_flags(item.spent_output_script, item.amount,
                                  item.spending_tx, item.input_index, item.flags)
    except api.ConsensusError as e:
        return False, int(e.code), None if e.script_error is None else int(e.script_error)
    return True, 0, 0


def _norm(results):
    return [(r.ok, int(r.error), None if r.script_error is None else int(r.script_error))
            for r in results]


def test_verify_batch_engines_agree_with_the_reference(core):
    items, bad = B.mixed_items(240, seed=23, corrupt_rate=0.05)
    assert 4 <= sum(bad) <= 40
    got = {}
    for engine in NB.ENGINES:
        v = TorchSecpVerifier(device="cpu", engine=engine)
        got[engine] = _norm(verify_batch(items, verifier=v, sig_cache=SigCache(),
                                         script_cache=ScriptExecutionCache(),
                                         engine=engine))
    want = [_reference(JAPI, it) for it in items]
    assert got["native"] == got["python"] == want
    assert [not w[0] for w in want] == bad
    with pytest.raises(ValueError, match="engine"):  # no silent mix of engines
        verify_batch(items[:1], verifier=TorchSecpVerifier(device="cpu", engine="python"))


def _api_cases():
    """(name, call kwargs) for every transport error and a script error."""
    w = B.Wallet("torch-native-api", "p2wpkh")
    f = B.FundedOutput(OutPoint(hashlib.sha256(b"api").digest(), 0), w, 50_000)
    raw = B.build_spend_tx([f]).serialize()
    bad_sig = B.build_spend_tx([f], corrupt_input=0).serialize()
    outs = [(f.amount, w.spk)]
    return [
        ("ok", dict(spent_outputs=outs, raw=raw, n_in=0, flags=F.VERIFY_ALL_EXTENDED)),
        ("ok_legacy", dict(spk=w.spk, amount=f.amount, raw=raw, n_in=0,
                           flags=F.VERIFY_ALL_LIBCONSENSUS)),
        ("script", dict(spent_outputs=outs, raw=bad_sig, n_in=0,
                        flags=F.VERIFY_ALL_EXTENDED)),
        ("invalid_flags", dict(spk=w.spk, amount=f.amount, raw=raw, n_in=0,
                               flags=F.VERIFY_ALL_EXTENDED)),
        ("deserialize", dict(spk=w.spk, amount=f.amount, raw=raw[:20], n_in=0,
                             flags=F.VERIFY_ALL_LIBCONSENSUS)),
        ("index_negative", dict(spk=w.spk, amount=f.amount, raw=raw, n_in=-1,
                                flags=F.VERIFY_ALL_LIBCONSENSUS)),
        ("index_past_end", dict(spk=w.spk, amount=f.amount, raw=raw, n_in=1,
                                flags=F.VERIFY_ALL_LIBCONSENSUS)),
        ("size_mismatch", dict(spk=w.spk, amount=f.amount, raw=raw + b"\x00", n_in=0,
                               flags=F.VERIFY_ALL_LIBCONSENSUS)),
        ("index_and_size", dict(spk=w.spk, amount=f.amount, raw=raw + b"\x00",
                                n_in=3, flags=F.VERIFY_ALL_LIBCONSENSUS)),
        ("prevout_count", dict(spent_outputs=outs * 2, raw=raw, n_in=0,
                               flags=F.VERIFY_ALL_EXTENDED)),
        ("amount_required", dict(spk=w.spk, amount=f.amount, raw=raw, n_in=0,
                                 flags=F.VERIFY_TAPROOT | F.VERIFY_WITNESS
                                 | F.VERIFY_P2SH, internal=True)),
    ]


def _call_api(api, case, **engine):
    try:
        if "internal" in case:
            api._verify_input(case["spk"], case["amount"], case["raw"], case["n_in"],
                              case["flags"], allowed_flags=F.ALL_FLAG_BITS, **engine)
        elif "spent_outputs" in case:
            api.verify_with_spent_outputs(case["raw"], case["n_in"],
                                          case["spent_outputs"], case["flags"], **engine)
        else:
            api.verify_with_flags(case["spk"], case["amount"], case["raw"],
                                  case["n_in"], case["flags"], **engine)
    except api.ConsensusError as e:
        return int(e.code), None if e.script_error is None else int(e.script_error)
    return 0, 0


@pytest.mark.parametrize("name,case", _api_cases(), ids=[c[0] for c in _api_cases()])
def test_api_engines_agree_on_transport_errors(core, name, case):
    got = {e: _call_api(TAPI, case, engine=e) for e in NB.ENGINES}
    assert got["native"] == got["python"] == _call_api(JAPI, case)
    want_code = {
        "ok": 0, "ok_legacy": 0, "script": TAPI.Error.ERR_SCRIPT,
        "invalid_flags": TAPI.Error.ERR_INVALID_FLAGS,
        "deserialize": TAPI.Error.ERR_TX_DESERIALIZE,
        "index_negative": TAPI.Error.ERR_TX_INDEX,
        "index_past_end": TAPI.Error.ERR_TX_INDEX,
        "size_mismatch": TAPI.Error.ERR_TX_SIZE_MISMATCH,
        "index_and_size": TAPI.Error.ERR_TX_INDEX,
        "prevout_count": TAPI.Error.ERR_TX_INDEX,
        "amount_required": TAPI.Error.ERR_AMOUNT_REQUIRED,
    }[name]
    assert got["native"][0] == int(want_code)
