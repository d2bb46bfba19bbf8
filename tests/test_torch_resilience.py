"""The port's `resilience/` held against the JAX package's, on the CPU.

- faults: every corruption kind gives the reference's array under the same
  plan and seed (one PRNG, drawn in the same order), the raise kinds the
  same exception types, the poison site the same hits;
- guards: `validate_verdict` accepts and refuses as the reference does,
  with the same `.reason`; the sentinel templates are byte-equal, and
  `install_sentinels` writes the same rows and the same `SentinelSet` at
  each rotation; the checksum's plain version equals the reference's jitted
  `_verdict_checksum` and `verdict_checksum_host` at every width tested; the
  checksum's launch contract is proven, and refused past the int32 edge;
- the retry budget gives the reference's attempt sequence;
- the verifier: a transient fault of every kind at `torch_backend.verdict`
  and `torch_backend.dispatch` gives the reference oracle's verdicts, a
  persistent one raises `DispatchFailed` with the fault as its cause;
- the cache audit, in both drivers, against the reference's `verify_batch`
  driving the same CPU verifier: the same verdicts, cache counts and
  discarded entries; a `batch.dispatch` raise leaves both caches empty.

Tolerance everywhere: zero. No JAX verifier runs here. The CPU verifier's
device step is the plain version of the verify kernel (about 1 s a run),
shared through `PlainRows`: a lane's verdict depends on its own row only,
so each distinct lane row is run once, and a rotated sentinel, a retry's
relaunch or a second dispatch of the same checks reads the first run's
answer.
"""

import dataclasses
import hashlib
import random

import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu import api as JAPI
from bitcoinconsensus_tpu.crypto import secp_host as JH
from bitcoinconsensus_tpu.crypto.jax_backend import _checksum_jit
from bitcoinconsensus_tpu.models import batch as JBATCH
from bitcoinconsensus_tpu.models import sigcache as JSC
from bitcoinconsensus_tpu.resilience import degrade as JD
from bitcoinconsensus_tpu.resilience import faults as JF
from bitcoinconsensus_tpu.resilience import guards as JG
from bitcoinconsensus_tpu_torch.analysis import interval, kernel_check, registry
from bitcoinconsensus_tpu_torch.core.interpreter import verify_script
from bitcoinconsensus_tpu_torch.core.sighash import PrecomputedTxData
from bitcoinconsensus_tpu_torch.core.tx import Tx, TxOut
from bitcoinconsensus_tpu_torch.crypto import torch_backend as TB
from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models import batch as TBATCH
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.ops import verdict_checksum as VC
from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
from bitcoinconsensus_tpu_torch.ops.contract import Window
from bitcoinconsensus_tpu_torch.resilience import degrade as D
from bitcoinconsensus_tpu_torch.resilience import faults as F
from bitcoinconsensus_tpu_torch.resilience import guards as G
from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchFailed
from bitcoinconsensus_tpu_torch.utils import blockgen as B

from torch_serving_common import checked

torch.set_num_threads(1)

CORRUPT_KINDS = ("invert", "flip", "value", "nan", "garbage", "shape")
RAISE_KINDS = ("raise", "timeout")


# -- the shared plain version ------------------------------------------------------


class PlainRows:
    """`verify_tiles` on CPU tensors, each distinct lane row run once."""

    def __init__(self):
        self.memo = {}
        self.runs = 0

    def __call__(self, *args):
        arrs = [a.numpy() for a in args]
        keys = [b"".join(a[i].tobytes() for a in arrs) for i in range(len(arrs[0]))]
        todo = {}
        for i, k in enumerate(keys):
            if k not in self.memo and k not in todo:
                todo[k] = i
        if todo:
            idx = torch.tensor(list(todo.values()))
            ok, needs = VT.verify_tiles(*(a[idx].contiguous() for a in args))
            for j, k in enumerate(todo):
                self.memo[k] = (bool(ok[j]), bool(needs[j]))
            self.runs += 1
        got = [self.memo[k] for k in keys]
        return (torch.tensor([g[0] for g in got], dtype=torch.bool),
                torch.tensor([g[1] for g in got], dtype=torch.bool))


_PLAIN = PlainRows()


@pytest.fixture(scope="module", autouse=True)
def plain_rows():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, "verify_tiles_checked", checked(_PLAIN))
        yield _PLAIN


# -- inputs ----------------------------------------------------------------------------


def _mixed_checks():
    """ECDSA, Schnorr and taproot tweak checks, valid and invalid, and the
    crafted collision lane the kernel defers to the host (P = G, t = 1)."""
    out = []
    for i in range(3):
        sk = B._sk(f"res/ecdsa{i}")
        msg = hashlib.sha256(b"res-e%d" % i).digest()
        out.append(SigCheck("ecdsa", (B.pubkey_create(sk), B.sign_ecdsa(sk, msg), msg)))
    sk = B._sk("res/ecdsa-bad")
    out.append(SigCheck("ecdsa", (B.pubkey_create(sk), B.sign_ecdsa(sk, b"\1" * 32),
                                  b"\2" * 32)))
    for i in range(2):
        sk = B._sk(f"res/schnorr{i}")
        msg = hashlib.sha256(b"res-s%d" % i).digest()
        xpk, _ = B.xonly_pubkey_create(sk)
        out.append(SigCheck("schnorr", (xpk, B.sign_schnorr(sk, msg), msg)))
    sig = bytearray(B.sign_schnorr(sk, msg))
    sig[40] ^= 1
    out.append(SigCheck("schnorr", (xpk, bytes(sig), msg)))
    gx = JH.G_X.to_bytes(32, "big")
    for t, flip in ((5, 0), (5, 1), (1, 0)):
        qx, qy = B._g_mul(1 + t)
        out.append(SigCheck("tweak", (qx.to_bytes(32, "big"), (qy & 1) ^ flip, gx,
                                      t.to_bytes(32, "big"))))
    return out


def _oracle(checks):
    """The reference's exact host checks."""
    fns = {"ecdsa": JH.verify_ecdsa, "schnorr": JH.verify_schnorr,
           "tweak": JH.xonly_tweak_add_check}
    return np.array([fns[c.kind](*c.data) for c in checks], dtype=bool)


CHECKS = _mixed_checks()
ORACLE = _oracle(CHECKS)


def _packed(seed, size, n):
    rng = np.random.default_rng(seed)
    fields = rng.integers(0, 256, (size, 4, 32), dtype=np.uint8)
    flags = [rng.integers(lo, 2, size).astype(np.int32) for lo in (0, -1, 0, 0, 0)]
    valid = rng.integers(0, 2, size).astype(bool)
    valid[n:] = False
    return (fields, *flags, valid)


# -- faults ------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", CORRUPT_KINDS)
def test_corrupt_verdict_equals_the_reference(kind):
    rng = np.random.default_rng(7)
    bufs = [rng.integers(0, 2, 64).astype(bool), rng.integers(0, 2, 37).astype(bool)]
    got = {}
    for name, mod in (("port", F), ("ref", JF)):
        plan = mod.FaultPlan([mod.FaultSpec("torch_backend.verdict", kind, count=2,
                                            lanes=3)])
        with mod.inject(plan, seed=11) as inj:
            got[name] = [mod.corrupt_verdict("torch_backend.verdict", b) for b in bufs]
            got[name].append(mod.corrupt_verdict("torch_backend.verdict", bufs[0]))
        assert inj.fired == {("torch_backend.verdict", kind): 2}
    for p, r in zip(got["port"], got["ref"], strict=True):
        assert p.dtype == r.dtype and p.shape == r.shape
        assert np.array_equal(p, r, equal_nan=p.dtype.kind == "f")
    assert got["port"][2] is bufs[0]  # the plan is drained: untouched


def test_raise_and_poison_sites_fire_as_the_reference():
    specs = [("batch.dispatch", "raise", 2), ("batch.dispatch", "timeout", 1),
             ("sigcache.sig", "poison", 2)]
    seen = {}
    for name, mod in (("port", F), ("ref", JF)):
        plan = mod.FaultPlan([mod.FaultSpec(s, k, count=c) for s, k, c in specs])
        out = []
        with mod.inject(plan) as inj:
            for _ in range(4):
                try:
                    mod.maybe_raise("batch.dispatch")
                    out.append(None)
                except mod.InjectedFault as e:
                    out.append((type(e).__name__, e.site, e.kind))
            out += [mod.poison_hit("sigcache.sig") for _ in range(3)]
            out.append(mod.poison_hit("sigcache.script"))
        seen[name] = (out, inj.fired, inj.total_fired())
    assert seen["port"] == seen["ref"]
    assert seen["port"][0][:4] == [("InjectedFault", "batch.dispatch", "raise")] * 2 \
        + [("InjectedTimeout", "batch.dispatch", "timeout"), None]
    with F.inject(F.FaultPlan([])):
        with pytest.raises(RuntimeError, match="already armed"):
            with F.inject(F.FaultPlan([])):
                pass
    assert F.active() is None


# -- guards ------------------------------------------------------------------------------


def _verdict_cases():
    rng = np.random.default_rng(3)
    ok = rng.integers(0, 2, 16).astype(bool)
    nan = ok.astype(np.float32)
    nan[5] = np.nan
    seven = ok.astype(np.int32)
    seven[2] = 7
    return {"bool": ok, "int01": ok.astype(np.int32), "float01": ok.astype(np.float32),
            "short": ok[:-1], "2d": ok.reshape(4, 4), "nan": nan, "domain": seven,
            "complex": ok.astype(np.complex64)}


@pytest.mark.parametrize("case", sorted(_verdict_cases()))
def test_validate_verdict_equals_the_reference(case):
    arr = _verdict_cases()[case]
    got = {}
    for name, mod in (("port", G), ("ref", JG)):
        try:
            got[name] = ("ok", mod.validate_verdict(arr, 16, "site").tolist())
        except mod.VerdictAnomaly as e:
            got[name] = ("anomaly", e.reason, e.site, str(e))
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("ok" if case in ("bool", "int01", "float01") else "anomaly")


def test_sentinel_templates_are_byte_equal():
    assert G._sentinel_templates() == JG._sentinel_templates()
    assert [t[-1] for t in G._sentinel_templates()] == [True, False, True, False]


@pytest.mark.parametrize("rotation", range(4))
@pytest.mark.parametrize("size,n", [(8, 3), (16, 15), (16, 10)])
def test_install_sentinels_equals_the_reference(rotation, size, n):
    base = _packed(rotation * 100 + size + n, size, n)
    port = tuple(a.copy() for a in base)
    ref = tuple(a.copy() for a in base)
    ps = G.install_sentinels(port, n, rotation=rotation)
    rs = JG.install_sentinels(ref, n, rotation=rotation)
    for a, b in zip(port, ref, strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ps.positions.tolist() == rs.positions.tolist() == \
        list(range(n, n + min(size - n, 4)))
    assert ps.expected.tolist() == rs.expected.tolist()
    for a, b in zip(port, base):  # only the sentinel rows moved
        assert a[:n].tobytes() == b[:n].tobytes()


def test_sentinel_rotation_room_and_writability():
    args = _packed(1, 8, 4)
    first = G.install_sentinels(tuple(a.copy() for a in args), 4)
    second = G.install_sentinels(tuple(a.copy() for a in args), 4)
    assert first.expected.tolist() != second.expected.tolist()  # rotated
    assert G.install_sentinels(_packed(2, 8, 8), 8) is None  # no pad room
    ro = _packed(3, 8, 2)
    ro[0].flags.writeable = False
    assert G.install_sentinels(ro, 2) is None
    for mod in (G, JG):
        copied, did = mod.ensure_writable(ro)
        assert did and all(a.flags.writeable for a in copied)
        assert mod.ensure_writable(copied) == (copied, False)


def test_sentinel_check_excludes_needs_host_lanes_as_the_reference():
    sp = G.SentinelSet([4, 5, 6, 7], [True, False, True, False])
    sr = JG.SentinelSet([4, 5, 6, 7], [True, False, True, False])
    ok = np.array([0, 0, 0, 0, 1, 0, 0, 0], dtype=bool)  # lane 6 wrong...
    needs = np.zeros(8, dtype=bool)
    needs[6] = True  # ...but deferred to the host: not counted
    for s in (sp, sr):
        s.check(ok, needs, "site")
    for s, mod in ((sp, G), (sr, JG)):
        with pytest.raises(mod.VerdictAnomaly) as e:
            s.check(ok, None, "site")
        assert e.value.reason == "sentinel"


@pytest.mark.parametrize("B", [1, 250, 251, 252, 8191, 8192, 32768])
@pytest.mark.parametrize("fill", ["random", "true", "false"])
def test_checksum_plain_version_equals_the_reference(B, fill):
    rng = np.random.default_rng(B)
    ok = {"random": rng.integers(0, 2, B).astype(bool), "true": np.ones(B, bool),
          "false": np.zeros(B, bool)}[fill]
    t = torch.from_numpy(ok)
    plain = VC.verdict_checksum_reference(t)
    assert plain.dtype == torch.int64
    want = tuple(int(x) for x in _checksum_jit(ok))
    assert tuple(plain.tolist()) == want == JG.verdict_checksum_host(ok) == \
        G.verdict_checksum_host(ok)
    wrapped = VC.verdict_checksum(t)  # a CPU tensor: the plain version
    assert wrapped.dtype == torch.int32 and tuple(wrapped.tolist()) == want


def test_checksum_catches_every_single_flip_as_the_reference():
    ok = np.random.default_rng(5).integers(0, 2, 300).astype(bool)
    sums = G.verdict_checksum_host(ok)
    G.check_checksum(sums, ok, "site")
    G.check_checksum(None, ok, "site")
    for i in range(len(ok)):
        bad = ok.copy()
        bad[i] = not bad[i]
        for mod in (G, JG):
            with pytest.raises(mod.VerdictAnomaly) as e:
                mod.check_checksum(sums, bad, "site")
            assert e.value.reason == "checksum"


def test_checksum_contract_is_proven_and_refused_past_int32():
    rep = registry.get_kernel("cuda.verdict_checksum").analyze()
    assert rep.ok and rep.grid == (1,) and not rep.violations
    c = VC.VERDICT_CHECKSUM_CONTRACT
    assert c.threads == 1024 and c.masked_edge and VC.MAX_LANES * 251 < 2**31
    wide = 2 * VC.MAX_LANES
    over = kernel_check.check_contract(
        dataclasses.replace(c, ins=(Window((wide,), lambda b: (0,)),)),
        [interval.TensorSpec((wide,), torch.bool)], "wide", in_bounds={0: (0, 1)})
    assert not over.ok and {v.kind for v in over.violations} == {"overflow"}
    with pytest.raises(ValueError):
        VC.verdict_checksum(torch.zeros(VC.MAX_LANES + 1, dtype=torch.bool))


# -- the retry budget --------------------------------------------------------------------


def test_retry_budget_gives_the_reference_attempt_sequence():
    port = D.DispatchResilience(max_retries=2, retry_deadline_s=60.0)
    ref = JD.DispatchResilience(("xla", "host"), "t", max_retries=2,
                                retry_deadline_s=60.0)
    assert (port.max_retries, port.retry_deadline_s) == (2, 60.0)
    assert D.DispatchResilience().max_retries == JD.DispatchResilience(
        ("xla", "host"), "d").max_retries == 3
    pd, rd = port.deadline(), ref.deadline()
    assert [port.may_retry(a, pd) for a in range(1, 5)] == \
        [ref.may_retry(a, rd, "t") for a in range(1, 5)] == [True, True, False, False]
    assert not port.may_retry(1, pd - 61.0) and not ref.may_retry(1, rd - 61.0, "t")


# -- the verifier ------------------------------------------------------------------------


def _verifier():
    return TorchSecpVerifier(device="cpu")


def test_guarded_verifier_clean_path():
    v = _verifier()
    out = v.verify_checks(CHECKS)
    assert np.array_equal(out, ORACLE) and not ORACLE.all() and ORACLE.any()
    st = v.stats
    assert st["tickets"] == st["dispatches"] == 1 and st["sentinel_lanes"] == 4
    assert st["fixups"] == 1  # the collision lane, resolved on the host
    assert not st["retries"] and v.in_flight == 0


@pytest.mark.parametrize("site,kind", [("torch_backend.verdict", k) for k in CORRUPT_KINDS]
                         + [("torch_backend.dispatch", k) for k in RAISE_KINDS])
def test_transient_fault_gives_the_reference_verdicts(site, kind):
    v = _verifier()
    with F.inject(F.FaultPlan([F.FaultSpec(site, kind)]), seed=3) as inj:
        out = v.verify_checks(CHECKS)
    assert inj.fired == {(site, kind): 1}
    assert np.array_equal(out, ORACLE)
    corrupt = site == "torch_backend.verdict"
    # `dispatches` counts the kernel launches: a raised launch made none.
    assert v.stats["retries"] == 1 and v.stats["dispatches"] == (2 if corrupt else 1)
    assert v.stats["guard_anomalies"] == corrupt


@pytest.mark.parametrize("site,kind", [("torch_backend.verdict", k) for k in CORRUPT_KINDS]
                         + [("torch_backend.dispatch", k) for k in RAISE_KINDS])
def test_persistent_fault_raises_dispatch_failed(site, kind):
    v = _verifier()
    with F.inject(F.FaultPlan([F.FaultSpec(site, kind, count=64)])) as inj:
        with pytest.raises(DispatchFailed) as e:
            v.verify_checks(CHECKS)
    cause = e.value.__cause__
    if site == "torch_backend.verdict":
        assert isinstance(cause, G.VerdictAnomaly)
    else:
        assert isinstance(cause, F.InjectedTimeout if kind == "timeout" else F.InjectedFault)
    assert inj.total_fired() == 4  # the first attempt and max_retries more
    assert v.stats["retries"] == 3 and v.in_flight == 0


def test_unrecoverable_cuda_error_is_not_retried(monkeypatch):
    v = _verifier()
    err = RuntimeError("CUDA error: an illegal memory access was encountered")
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise err

    monkeypatch.setattr(TB, "verify_tiles_checked", broken)
    with pytest.raises(DispatchFailed) as e:
        v.verify_checks(CHECKS[:2])
    assert e.value.__cause__ is err and len(calls) == 1 and not v.stats["retries"]


def test_flip_fault_in_a_real_lane_is_caught_by_the_checksum(monkeypatch):
    """A flip the sentinels cannot see (lane 0, a real lane) is caught by the
    checksum alone; with BITCOINCONSENSUS_TPU_CHECKSUM=0 it would pass."""
    real = F.corrupt_verdict

    def flip_first(site, arr):
        out = np.array(arr)
        out[0] = not out[0]
        return out

    for checksum, want in (("1", "checksum"), ("0", None)):
        monkeypatch.setenv("BITCOINCONSENSUS_TPU_CHECKSUM", checksum)
        v = _verifier()
        handle = v.verify_checks_begin(CHECKS[:1])
        ticket = handle[1][0][2]
        monkeypatch.setattr(F, "corrupt_verdict", flip_first)
        try:
            v._materialize_guarded(ticket)
            caught = None
        except G.VerdictAnomaly as e:
            caught = e.reason
        monkeypatch.setattr(F, "corrupt_verdict", real)
        assert caught == want
        assert np.array_equal(v.verify_checks_finish(handle), ORACLE[:1])


def test_sync_lanes_raises_where_retries_are_spent():
    v = _verifier()
    args = v._pack_lanes(v._prep_lanes(CHECKS[:4]))
    with F.inject(F.FaultPlan([F.FaultSpec("torch_backend.verdict", "garbage",
                                           count=64)])):
        pend = v.dispatch_lanes(args, 4)
        with pytest.raises(DispatchFailed):
            v.sync_lanes(pend, 4)
        with pytest.raises(DispatchFailed):  # settling again: the same failure
            v.sync_lanes(pend, 4)
    assert args[6][4:].sum() == 0  # the caller's pad rows: no sentinel written
    ok, needs = v.sync_lanes(v.dispatch_lanes(args, 4), 4)
    assert np.array_equal(ok | needs, ORACLE[:4] | needs) and not needs.any()


# -- the cache audit, in both drivers ------------------------------------------------------


def _items():
    items, bad = B.mixed_items(10, seed=91, corrupt_rate=0.3)
    assert any(bad) and not all(bad)
    order = sorted(range(len(items)), key=lambda i: not bad[i])  # corrupted first
    return [items[i] for i in order]


ITEMS = _items()


def _api(item):
    try:
        JAPI.verify_with_spent_outputs(item.spending_tx, item.input_index,
                                       item.spent_outputs, item.flags)
    except JAPI.ConsensusError as e:
        return False, int(e.code), None if e.script_error is None else int(e.script_error)
    return True, 0, 0


WANT = [_api(it) for it in ITEMS]


def _norm(results):
    return [(r.ok, int(r.error), None if r.script_error is None else int(r.script_error))
            for r in results]


def _run(pkg, idx, monkeypatch, salt, plan=None, planted=(), audit=True):
    """One verify_batch of `pkg` ("port" or "ref") over ITEMS with the port's
    CPU verifier, fresh caches of that package salted with `salt`, the audit
    armed, `plan` injected and the keys `planted` in the sig cache first."""
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_IDX", "1" if idx else "0")
    v = _verifier()
    if pkg == "port":
        faults, guards, mod, items = F, G, TBATCH, ITEMS
        sig, script = SigCache(), ScriptExecutionCache()
    else:
        faults, guards, mod = JF, JG, JBATCH
        items = [JBATCH.BatchItem(**vars(it)) for it in ITEMS]
        sig, script = JSC.SigCache(), JSC.ScriptExecutionCache(cache_label="res-s")
    sig._salt = script._salt = salt
    for k in planted:
        sig.add_key(k)
    caught0 = JG.CACHE_POISON_CAUGHT.value(cache="sig")
    guards.set_cache_audit(audit)
    try:
        if plan is None:
            res = mod.verify_batch(items, verifier=v, sig_cache=sig, script_cache=script)
        else:
            with faults.inject(faults.FaultPlan([faults.FaultSpec(*s) for s in plan])):
                res = mod.verify_batch(items, verifier=v, sig_cache=sig,
                                       script_cache=script)
    finally:
        guards.set_cache_audit(False)
    caught = v.stats["cache_poison_caught"] if pkg == "port" else \
        JG.CACHE_POISON_CAUGHT.value(cache="sig") - caught0
    counts = {c: (x.hits, x.misses, x.insertions, x.evictions, x.erases, len(x))
              for c, x in (("sig", sig), ("script", script))}
    return _norm(res), counts, int(caught), set(sig._set)


SALT = bytes(range(32))


def _bad_key():
    """The salted sig-cache key of the first false check the first
    (corrupted) item records, found by the Python engine's deferring
    interpreter and the exact host checks."""
    item = ITEMS[0]
    tx = Tx.deserialize(item.spending_tx)
    spent = [TxOut(a, s) for a, s in item.spent_outputs]
    i = item.input_index
    chk = TBATCH.DeferringSignatureChecker(tx, i, spent[i].value,
                                           PrecomputedTxData(tx, spent))
    verify_script(tx.vin[i].script_sig, spent[i].script_pubkey, tx.vin[i].witness,
                  item.flags, chk)
    bad = [c for c in chk.recorded if not _oracle([c])[0]]
    assert bad
    sig = SigCache()
    sig._salt = SALT
    return sig.keys_for_checks(bad[:1])[0]


@pytest.mark.parametrize("idx", [True, False], ids=["index", "wire"])
def test_poisoned_hit_under_audit_gives_the_reference_verdicts_and_counts(idx, monkeypatch):
    plan = [("sigcache.sig", "poison", 1)]
    port = _run("port", idx, monkeypatch, SALT, plan)
    ref = _run("ref", idx, monkeypatch, SALT, plan)
    assert port == ref
    assert port[0] == WANT and port[2] == 1  # the fabricated hit was caught


@pytest.mark.parametrize("idx", [True, False], ids=["index", "wire"])
def test_persistent_poison_under_audit_stays_exact(idx, monkeypatch):
    plan = [("sigcache.sig", "poison", 64)]
    port = _run("port", idx, monkeypatch, SALT, plan)
    ref = _run("ref", idx, monkeypatch, SALT, plan)
    assert port == ref and port[0] == WANT
    assert port[2] >= sum(not w[0] for w in WANT) >= 1  # every false check caught
    assert port[1]["sig"][2] == 0  # a hit, audited true, is not inserted again


@pytest.mark.parametrize("idx", [True, False], ids=["index", "wire"])
def test_planted_entry_is_discarded_alike(idx, monkeypatch):
    bad = _bad_key()
    port = _run("port", idx, monkeypatch, SALT, planted=[bad])
    ref = _run("ref", idx, monkeypatch, SALT, planted=[bad])
    assert port == ref and port[0] == WANT
    assert port[2] == 1 and bad not in port[3] and port[1]["sig"][4] == 1  # erased


@pytest.mark.parametrize("idx", [True, False], ids=["index", "wire"])
def test_batch_dispatch_raise_leaves_both_caches_empty(idx, monkeypatch):
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_IDX", "1" if idx else "0")
    v = _verifier()
    sig, script = SigCache(), ScriptExecutionCache()
    with F.inject(F.FaultPlan([F.FaultSpec("batch.dispatch", "raise")])) as inj:
        with pytest.raises(F.InjectedFault):
            TBATCH.verify_batch(ITEMS, verifier=v, sig_cache=sig, script_cache=script)
        assert len(sig) == len(script) == 0 and v.stats["dispatches"] == 0
        again = TBATCH.verify_batch(ITEMS, verifier=v, sig_cache=sig,
                                    script_cache=script)
    assert inj.total_fired() == 1 and _norm(again) == WANT
    assert len(sig) > 0 and len(script) == sum(w[0] for w in WANT)


def test_cache_probe_counts_and_discard_match_the_reference():
    port, ref = SigCache(cache_label="x"), JSC.SigCache(cache_label="x")
    for c in (port, ref):
        c._salt = SALT
        c.add_key(b"k" * 32)
    out = {}
    for name, c, mod in (("port", port, F), ("ref", ref, JF)):
        with mod.inject(mod.FaultPlan([mod.FaultSpec("sigcache.x", "poison")])):
            seq = [c.contains_key(b"o" * 32), c.contains_key(b"o" * 32),
                   c.contains_key(b"k" * 32, erase=True)]
        c.discard_key(b"z" * 32)
        c.add_key(b"k" * 32)
        c.discard_key(b"k" * 32)
        out[name] = (seq, c.hits, c.misses, c.insertions, c.evictions, c.erases, len(c))
        assert c.insertions - c.evictions - c.erases == len(c)
    assert out["port"] == out["ref"] == ([True, False, True], 2, 1, 2, 0, 2, 0)


def test_fault_plan_rng_matches_over_a_random_plan():
    rng = random.Random(4)
    specs = [("torch_backend.verdict", rng.choice(CORRUPT_KINDS), rng.randrange(1, 3),
              rng.randrange(1, 5)) for _ in range(6)]
    buf = np.random.default_rng(2).integers(0, 2, 50).astype(bool)
    outs = {}
    for name, mod in (("port", F), ("ref", JF)):
        plan = mod.FaultPlan([mod.FaultSpec(s, k, count=c, lanes=l) for s, k, c, l in specs])
        with mod.inject(plan, seed=9):
            outs[name] = [mod.corrupt_verdict("torch_backend.verdict", buf)
                          for _ in range(10)]
    for p, r in zip(outs["port"], outs["ref"], strict=True):
        assert p.dtype == r.dtype and np.array_equal(p, r, equal_nan=p.dtype.kind == "f")


# -- the verdict accounting seam the mesh overrides, on the single-device verifier -----


def _collision(flip):
    """The crafted collision lane (P = G, t = 1), its parity flipped or not:
    the kernel defers it, the host fixup resolves it (True unflipped)."""
    qx, qy = B._g_mul(2)
    return SigCheck("tweak", (qx.to_bytes(32, "big"), (qy & 1) ^ flip,
                              JH.G_X.to_bytes(32, "big"), (1).to_bytes(32, "big")))


@pytest.mark.parametrize("flip", [0, 1])
def test_fixup_failed_is_set_where_the_verifier_fixup_rejects(flip):
    v = _verifier()
    assert v._fixup_failed is False
    out = v.verify_checks([_collision(flip)] + CHECKS[:2])
    assert v.stats["fixups"] == 1
    assert out.tolist() == [flip == 0] + ORACLE[:2].tolist()
    assert v._fixup_failed is (flip == 1)


@pytest.mark.parametrize("reject", [False, True])
def test_fixup_failed_is_set_where_the_index_driver_fixup_rejects(reject):
    """`_settle_uniq`, the index-mode drivers' settle, sets the flag exactly
    where a deferred lane resolves False on the host."""

    class Session:
        def uniq_host_verify(self, i):
            return not (reject and i == 1)

        def publish_uniq(self, grow, vals):
            self.published = vals.tolist()

    class Verifier:
        def __init__(self):
            self.stats = {"fixup_s": 0.0, "fixups": 0}
            self._fixup_failed = False

        def sync_lanes(self, pending, n):
            return np.array([True, False, False]), np.array([False, True, True])

    sess, ver, state = Session(), Verifier(), TBATCH._UniqState()
    state.val = np.zeros(3, dtype=bool)
    grow = np.arange(3, dtype=np.int32)
    keys = [bytes([i]) * 32 for i in range(3)]
    TBATCH._settle_uniq(sess, ver, SigCache(), state, (grow, keys, [(None, grow)]))
    assert ver._fixup_failed is reject and ver.stats["fixups"] == 2
    assert sess.published == [1, int(not reject), 1]


def test_verifier_notes_each_clean_dispatch_once(monkeypatch):
    """The in-flight queue's success hook reaches `_note_device_verdict` once
    per dispatch, after its retry, never per attempt; the settle seam
    returns all_ok None off the mesh; the stats keys are the ones the
    verifier always kept."""
    v = _verifier()
    noted = []
    monkeypatch.setattr(v, "_note_device_verdict",
                        lambda all_ok, ok, needs, count: noted.append(
                            (all_ok, count, len(ok), len(needs))))
    with F.inject(F.FaultPlan([F.FaultSpec("torch_backend.verdict", "flip")]), seed=3):
        out = v.verify_checks(CHECKS)
    assert np.array_equal(out, ORACLE) and v.stats["retries"] == 1
    padded = v.pad(len(CHECKS))
    assert noted == [(None, len(CHECKS), padded, padded)]
    v2 = _verifier()
    handle = v2.verify_checks_begin(CHECKS)
    ticket = handle[1][0][2]
    ok, needs, all_ok = v2._materialize_guarded(ticket)
    assert all_ok is None and len(ok) == len(needs) == padded
    assert np.array_equal(v2.verify_checks_finish(handle), ORACLE)
    assert sorted(v2.stats) == ["dispatches", "fixup_s", "fixups", "lane_prep_s", "lanes",
                                "padded_lanes", "sentinel_lanes", "tickets"]
