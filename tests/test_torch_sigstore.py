"""The port's persistent sig cache (`models/sigstore.py`) on the CPU, held
against the JAX package's.

- the reference's store cases (replay of entries and salt, tombstones,
  hot-tier overflow, erase-on-hit, compaction, a flipped checksum byte, a
  torn tail, a kill -9 mid-append, the `sigstore.load` / `sigstore.append`
  faults, a concurrent hammer, a shard directory that vanishes), each on
  both packages;
- the on-disk format: the same operations with the same salt leave
  byte-identical shard logs in both packages;
- the store crossing: a store written by the reference's `verify_batch`
  opens warm in the port, its hits arriving through the port's
  `verify_batch` (the drivers' batched seam), and a store written by the
  port's `verify_batch` opens warm in the reference;
- the batched seam: `verify_batch` with a store, close, reopen, and the
  rerun hits every persisted key in both drivers (index mode and wire),
  which fails if the store overrides only the single-key methods; the
  salt is on disk before the first digest;
- the audit: a poisoned persisted entry (valid CRC, the key of a false
  check) is caught under `set_cache_audit(True)`, the verdict stays right,
  and after a second reopen the key stays gone; a torn tail on a shard
  costs misses, never a wrong verdict.
"""

import os
import signal
import subprocess
import sys
import threading
import time
import types

import pytest

from torch_serving_common import (
    mixed_items,
    norm,
    patch_plain_rows,
    ref_host_verifier,
    reference,
)

from bitcoinconsensus_tpu.models import batch as JBATCH
from bitcoinconsensus_tpu.models import sigstore as JSS
from bitcoinconsensus_tpu.models.sigcache import ScriptExecutionCache as JSEC
from bitcoinconsensus_tpu.resilience import faults as JF
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models import sigstore as TSS
from bitcoinconsensus_tpu_torch.models.batch import verify_batch
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.resilience import faults as TF
from bitcoinconsensus_tpu_torch.resilience import guards as TG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax_package": types.SimpleNamespace(SS=JSS, F=JF, name="bitcoinconsensus_tpu"),
    "port": types.SimpleNamespace(SS=TSS, F=TF, name="bitcoinconsensus_tpu_torch"),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _keys(n, seed=0):
    """n distinct 32-byte keys spread over shard bytes."""
    return [bytes([(seed + i) % 256]) + (seed + i).to_bytes(31, "little")
            for i in range(n)]


def _store(pkg, tmp_path, **kw):
    kw.setdefault("hot_entries", 8)
    kw.setdefault("shards", 4)
    return pkg.SS.PersistentSigCache(str(tmp_path / "store"), **kw)


def _one_log(tmp_path):
    d = tmp_path / "store"
    logs = sorted(p for p in os.listdir(d)
                  if p.endswith(".log") and os.path.getsize(d / p) > 0)
    assert logs
    return d / logs[0]


# -- the reference's store cases, on both packages ------------------------------


def test_restart_replays_entries_and_salt(pkg, tmp_path):
    ks = _keys(20)
    s = _store(pkg, tmp_path)
    for k in ks:
        s.add_key(k)
    salt = s._salt
    s.close()
    s2 = _store(pkg, tmp_path)
    assert s2._salt == salt == open(tmp_path / "store" / "salt", "rb").read()
    assert len(s2) == 20 and (s2.replay_applied, s2.replay_skipped) == (20, 0)
    assert all(s2.contains_key(k) for k in ks)
    assert s2.warmup_s is not None and s2.warmup_s >= 0
    s2.close()


def test_tombstones_overflow_and_erase_on_hit(pkg, tmp_path):
    ks = _keys(50)
    s = _store(pkg, tmp_path, hot_entries=4)
    for k in ks:
        s.add_key(k)
    s.discard_key(ks[0])
    assert s.contains_key(ks[1], erase=True)
    assert not s.contains_key(ks[1])
    assert len(s) == 48 and all(s.contains_key(k) for k in ks[2:])
    assert s.insertions - s.evictions - s.erases == len(s)
    s.close()
    s2 = _store(pkg, tmp_path, hot_entries=4)
    assert len(s2) == 48
    assert not s2.contains_key(ks[0]) and not s2.contains_key(ks[1])
    assert all(s2.contains_key(k) for k in ks[2:])
    s2.close()


def test_compaction_bounds_log_growth(pkg, tmp_path):
    s = _store(pkg, tmp_path, shards=1)
    churn, keep = _keys(40, seed=7), _keys(5, seed=200)
    for k in keep:
        s.add_key(k)
    for _ in range(4):
        for k in churn:
            s.add_key(k)
        for k in churn:
            s.discard_key(k)
    records = os.path.getsize(tmp_path / "store" / "shard-00.log") // pkg.SS._REC_LEN
    assert records < 320 and records <= 2 * len(s) + 64 + 1
    s.close()
    s2 = _store(pkg, tmp_path, shards=1)
    assert len(s2) == 5 and all(s2.contains_key(k) for k in keep)
    assert not any(s2.contains_key(k) for k in churn)
    s2.close()


def test_flipped_checksum_and_torn_tail_heal(pkg, tmp_path):
    ks = _keys(12)
    s = _store(pkg, tmp_path)
    for k in ks:
        s.add_key(k)
    s.close()
    log = _one_log(tmp_path)
    raw = bytearray(open(log, "rb").read())
    raw[-1] ^= 0xFF  # the last record's checksum
    open(log, "wb").write(bytes(raw))
    s2 = _store(pkg, tmp_path)
    assert s2.replay_skipped >= 1 and len(s2) == 11
    assert os.path.getsize(log) == len(raw) - pkg.SS._REC_LEN
    s2.close()
    good = os.path.getsize(log)
    with open(log, "ab") as fh:
        fh.write(b"\x41\x99\x07")  # a torn append
    s3 = _store(pkg, tmp_path)
    assert s3.replay_skipped >= 1 and len(s3) == 11
    assert os.path.getsize(log) == good
    extra = _keys(1, seed=99)[0]
    s3.add_key(extra)
    s3.close()
    s4 = _store(pkg, tmp_path)
    assert s4.contains_key(extra)
    s4.close()


def test_kill9_mid_append_recovers(pkg, tmp_path):
    store = str(tmp_path / "store")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"from {pkg.name}.models.sigstore import PersistentSigCache\n"
        f"s = PersistentSigCache({store!r}, hot_entries=8, shards=4)\n"
        "print('ready', flush=True)\n"
        "i = 0\n"
        "while True:\n"
        "    i += 1\n"
        "    s.add_key(bytes([i % 256]) + i.to_bytes(31, 'little'))\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL)
    try:
        assert proc.stdout.readline().strip() == b"ready"
        time.sleep(0.3)
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
    s = pkg.SS.PersistentSigCache(store, hot_entries=8, shards=4)
    assert len(s) > 0 and s.replay_applied == len(s)
    for p in os.listdir(store):
        if p.endswith(".log"):
            assert os.path.getsize(os.path.join(store, p)) % pkg.SS._REC_LEN == 0
    s.add_key(b"\xee" * 32)
    s.close()
    s2 = pkg.SS.PersistentSigCache(store, hot_entries=8, shards=4)
    assert s2.contains_key(b"\xee" * 32)
    s2.close()


def test_load_and_append_faults_contained(pkg, tmp_path):
    F = pkg.F
    s = _store(pkg, tmp_path)
    for k in _keys(16):
        s.add_key(k)
    k_lost, k_kept = _keys(2, seed=50)
    with F.inject(F.FaultPlan([F.FaultSpec("sigstore.append", "raise", count=1)]),
                  seed=3) as inj:
        s.add_key(k_lost)
    assert inj.fired[("sigstore.append", "raise")] == 1
    s.add_key(k_kept)
    assert s.contains_key(k_lost) and s.contains_key(k_kept)
    s.close()
    with F.inject(F.FaultPlan([F.FaultSpec("sigstore.load", "raise", count=1)]),
                  seed=3) as inj:
        s2 = _store(pkg, tmp_path)
    assert inj.fired[("sigstore.load", "raise")] == 1
    assert 0 < len(s2) < 17 and s2.replay_skipped >= 1
    s2.close()
    s3 = _store(pkg, tmp_path)
    assert not s3.contains_key(k_lost) and s3.contains_key(k_kept)
    s3.close()


def test_concurrent_hammer_preserves_accounting(pkg, tmp_path):
    s = _store(pkg, tmp_path, hot_entries=16, shards=4)
    barrier = threading.Barrier(8)
    errors = []

    def worker(tid):
        try:
            barrier.wait()
            for i in range(200):
                k = bytes([(i * 13 + tid) % 97]) + ((i % 31) * 1000 + tid % 3).to_bytes(31, "little")
                op = (tid + i) % 4
                if op == 0:
                    s.add_key(k)
                elif op == 1:
                    s.contains_key(k, erase=True)
                elif op == 2:
                    s.contains_key(k)
                else:
                    s.discard_key(k)
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors
    assert s.insertions - s.evictions - s.erases == len(s)
    live = {k for shard in s._cold for k in shard}
    s.close()
    s2 = _store(pkg, tmp_path, hot_entries=16, shards=4)
    assert len(s2) == len(live) and all(s2.contains_key(k) for k in live)
    s2.close()


def test_vanished_shard_dir_counted_never_raises(pkg, tmp_path):
    import shutil

    d = tmp_path / "gone"
    s = pkg.SS.PersistentSigCache(str(d), hot_entries=16, shards=2)
    shutil.rmtree(d)
    s.add_key(b"\x07" * 32)
    assert not s.peek_key(b"\x07" * 32) and len(s) == 0
    s.close()


# -- the on-disk format ------------------------------------------------------------


def test_same_operations_leave_byte_identical_logs(tmp_path):
    """Seeded salt, the same adds, discards, erase-on-hit probes and a
    compaction in both packages: the same salt file and shard logs, byte
    for byte."""
    ks = _keys(120, seed=3)
    out = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        os.makedirs(d)
        (d / "salt").write_bytes(bytes(range(32)))
        s = p.SS.PersistentSigCache(str(d), hot_entries=8, shards=4)
        for k in ks:
            s.add_key(k)
        for k in ks[::3]:
            s.discard_key(k)
        for k in ks[1::5]:
            s.contains_key(k, erase=True)
        for k in ks[:60]:
            s.add_key(k)
        s.close()
        out[name] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert out["port"] == out["jax_package"]
    assert sorted(out["port"]) == ["salt"] + [f"shard-{i:02d}.log" for i in range(4)]


# -- the store through the batch drivers ----------------------------------------


@pytest.fixture(scope="module")
def plain():
    with pytest.MonkeyPatch.context() as mp:
        yield patch_plain_rows(mp)


def _clean_items():
    items, bad = mixed_items(64, seed=3)
    return [it for it, b in zip(items, bad) if not b]


def test_reference_store_opens_warm_in_the_port(plain, tmp_path):
    items = _clean_items()
    d = str(tmp_path / "ref")
    js = JSS.PersistentSigCache(d)
    JBATCH.verify_batch(items, verifier=ref_host_verifier(), sig_cache=js,
                        script_cache=JSEC())
    n = len(js)
    js.close()
    assert n > 0
    ts = TSS.PersistentSigCache(d)
    assert len(ts) == n
    v = TorchSecpVerifier(device="cpu")
    got = verify_batch(items, verifier=v, sig_cache=ts, script_cache=ScriptExecutionCache())
    assert norm(got) == [reference(it) for it in items]
    assert ts.hits == n  # every persisted entry answered through the batched seam
    assert v.stats["lanes"] == ts.misses  # only the misses were dispatched
    ts.close()


def test_port_store_opens_warm_in_the_reference(plain, tmp_path):
    items = _clean_items()
    d = str(tmp_path / "port")
    ts = TSS.PersistentSigCache(d)
    v = TorchSecpVerifier(device="cpu")
    verify_batch(items, verifier=v, sig_cache=ts, script_cache=ScriptExecutionCache())
    n = len(ts)
    ts.close()
    assert n > 0
    js = JSS.PersistentSigCache(d)
    assert len(js) == n
    got = JBATCH.verify_batch(items, verifier=ref_host_verifier(), sig_cache=js,
                              script_cache=JSEC())
    assert [(r.ok, int(r.error)) for r in got] == [reference(it)[:2] for it in items]
    # Every persisted entry hits; what misses is what the port's cold run
    # dispatched beyond its successes (the false CHECKMULTISIG pairings).
    assert js.hits == n and js.misses == v.stats["lanes"] - n
    js.close()


@pytest.mark.parametrize("driver", ["index", "wire"])
def test_batched_seam_persists_and_rehits(plain, tmp_path, monkeypatch, driver):
    """Cold run into a fresh store, close, reopen: the rerun hits every
    persisted key and dispatches only the misses. A store that overrode
    only the single-key methods would persist nothing here (the drivers
    call `contains_keys` / `add_keys`) and reopen cold."""
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_IDX", "0" if driver == "wire" else "1")
    items, _bad = mixed_items(64, seed=3)
    d = str(tmp_path / "seam")
    s = TSS.PersistentSigCache(d)
    salt_on_disk = open(os.path.join(d, "salt"), "rb").read()
    assert s._salt == salt_on_disk  # before any digest
    v = TorchSecpVerifier(device="cpu")
    cold = verify_batch(items, verifier=v, sig_cache=s, script_cache=ScriptExecutionCache())
    cold_lanes = v.stats["lanes"]
    n = len(s)
    assert n > 0 and s.hits == 0
    s.close()
    s2 = TSS.PersistentSigCache(d)
    assert s2._salt == salt_on_disk and len(s2) == n
    v2 = TorchSecpVerifier(device="cpu")
    warm = verify_batch(items, verifier=v2, sig_cache=s2, script_cache=ScriptExecutionCache())
    assert norm(warm) == norm(cold) == [reference(it) for it in items]
    assert s2.hits == n
    assert v2.stats["lanes"] == cold_lanes - n
    assert s2.warmup_s is not None
    s2.close()


@pytest.mark.parametrize("driver", ["index", "wire"])
def test_poisoned_entry_caught_and_stays_gone(plain, tmp_path, monkeypatch, driver):
    """Plant the keys of a corrupted item's false checks (valid CRC, wrong
    verdict), reopen, verify under the audit in either driver: caught, the
    verdict right, the keys tombstoned; a second reopen keeps them gone."""
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_IDX", "0")
    items, bad = mixed_items(64, seed=3)
    j = bad.index(True)
    target = [items[j]]
    v = TorchSecpVerifier(device="cpu")
    sent = []
    run = v.verify_checks

    def recording(checks):
        res = run(checks)
        sent.extend(zip(checks, res))
        return res

    v.verify_checks = recording
    d = str(tmp_path / "poison")
    s = TSS.PersistentSigCache(d)
    first = verify_batch(target, verifier=v, sig_cache=s, script_cache=ScriptExecutionCache())
    assert not first[0].ok
    poison = s.keys_for_checks([c for c, r in sent if not r])
    assert poison
    s.add_keys(poison)
    s.close()
    s2 = TSS.PersistentSigCache(d)
    assert all(s2.peek_key(k) for k in poison)
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_IDX", "0" if driver == "wire" else "1")
    v2 = TorchSecpVerifier(device="cpu")
    before = TG.CACHE_POISON_CAUGHT.value(cache="sig")
    TG.set_cache_audit(True)
    try:
        got = verify_batch(target, verifier=v2, sig_cache=s2,
                           script_cache=ScriptExecutionCache())
    finally:
        TG.set_cache_audit(False)
    assert norm(got) == norm(first) == [reference(target[0])]
    assert v2.stats["cache_poison_caught"] >= 1
    assert TG.CACHE_POISON_CAUGHT.value(cache="sig") > before
    assert not any(s2.peek_key(k) for k in poison)
    s2.close()
    s3 = TSS.PersistentSigCache(d)
    assert not any(s3.peek_key(k) for k in poison)
    s3.close()


def test_torn_tail_costs_misses_never_a_wrong_verdict(plain, tmp_path):
    items, _ = mixed_items(64, seed=3)
    d = str(tmp_path / "torn")
    s = TSS.PersistentSigCache(d)
    want = norm(verify_batch(items, verifier=TorchSecpVerifier(device="cpu"), sig_cache=s,
                             script_cache=ScriptExecutionCache()))
    n = len(s)
    s.close()
    logs = sorted(f for f in os.listdir(d) if f.endswith(".log"))
    path = os.path.join(d, logs[0])
    size = os.path.getsize(path)
    os.truncate(path, size - TSS._REC_LEN // 2)  # tear the last record
    s2 = TSS.PersistentSigCache(d)
    assert s2.replay_skipped == 1 and len(s2) == n - 1
    got = verify_batch(items, verifier=TorchSecpVerifier(device="cpu"), sig_cache=s2,
                       script_cache=ScriptExecutionCache())
    assert norm(got) == want == [reference(it) for it in items]
    assert s2.hits == n - 1
    s2.close()


def test_sig_store_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv("BITCOINCONSENSUS_TPU_SIGSTORE_DIR", raising=False)
    assert TSS.sig_store_from_env() is None
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_SIGSTORE_DIR", str(tmp_path / "env"))
    s = TSS.sig_store_from_env(shards=2)
    assert isinstance(s, SigCache) and s._shards == 2
    s.close()


def test_a_torn_tombstone_resurrects_the_entry_in_both_packages(pkg, tmp_path):
    """Replay drops a torn tail whatever record it was: when that record is
    the DEL of an entry the audit convicted, the entry comes back on the
    next open (fail-closed then rests on the audit catching it again). The
    same in both packages."""
    ks = _keys(6, seed=40)
    s = _store(pkg, tmp_path, shards=1)
    for k in ks:
        s.add_key(k)
    s.discard_key(ks[2])  # the conviction's tombstone, the log's last record
    s.close()
    log = tmp_path / "store" / "shard-00.log"
    os.truncate(log, os.path.getsize(log) - pkg.SS._REC_LEN // 2)
    s2 = _store(pkg, tmp_path, shards=1)
    assert s2.replay_skipped == 1 and s2.peek_key(ks[2]) and len(s2) == 6
    s2.close()
