"""The port's index-mode driver, its stream and the verifier's seams, on the
CPU: `verify_batch` in index mode against the wire driver and the JAX
package's per-input API, `_accept_mask` against the JAX package's,
`verify_batch_stream` against `verify_batch` run per batch, and `pad` /
`pad_step` against the reference's published padding rule.

Every run uses `TorchSecpVerifier(device="cpu")`, whose device step is the
plain torch version of the verify kernel (about 2 s a dispatch on one
core), so the runs are shared between tests. Tolerance everywhere: zero.
"""

import functools
import os
import hashlib

import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu import api as JAPI
from bitcoinconsensus_tpu.models import batch as JBATCH
from bitcoinconsensus_tpu_torch.core import flags as F
from bitcoinconsensus_tpu_torch.core.script import OP_CHECKMULTISIG, push_data
from bitcoinconsensus_tpu_torch.core.sighash import SIGHASH_ALL, bip143_sighash
from bitcoinconsensus_tpu_torch.core.tx import OutPoint, Tx, TxIn, TxOut
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models import batch as TBATCH
from bitcoinconsensus_tpu_torch.models.batch import (
    BatchItem,
    verify_batch,
    verify_batch_stream,
)
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.utils import blockgen as B

torch.set_num_threads(1)


def _misaligned_multisig(seed: str) -> BatchItem:
    """P2WSH 2-of-3 signed by keys 0 and 2: the CHECKMULTISIG cursor must
    find the (sig1, key2) pairing, which only oracle answers reveal."""
    sks = [B._sk(f"{seed}/k{i}") for i in range(3)]
    pubs = [B.pubkey_create(sk) for sk in sks]
    wscript = (b"\x52" + b"".join(push_data(p) for p in pubs) + b"\x53"
               + bytes([OP_CHECKMULTISIG]))
    spk = b"\x00\x20" + hashlib.sha256(wscript).digest()
    amount = 70_000
    tx = Tx(2, [TxIn(OutPoint(hashlib.sha256(seed.encode()).digest(), 0))],
            [TxOut(amount - 700, b"\x51")], 0)
    sighash = bip143_sighash(wscript, tx, 0, SIGHASH_ALL, amount)
    tx.vin[0].witness = [b""] + [B.sign_ecdsa(sks[i], sighash) + bytes([SIGHASH_ALL])
                                 for i in (0, 2)] + [wscript]
    return BatchItem(tx.serialize(), 0, F.VERIFY_ALL_LIBCONSENSUS, spk, amount)


@functools.lru_cache(maxsize=1)
def _items():
    items, bad = B.mixed_items(26, seed=30, corrupt_rate=0.08)
    assert any(bad)
    return items + [_misaligned_multisig("torch-idx")]


def _reference(item):
    """The JAX package's per-input API."""
    try:
        if item.spent_outputs is not None:
            JAPI.verify_with_spent_outputs(item.spending_tx, item.input_index,
                                           item.spent_outputs, item.flags)
        else:
            JAPI.verify_with_flags(item.spent_output_script, item.amount,
                                   item.spending_tx, item.input_index, item.flags)
    except JAPI.ConsensusError as e:
        return False, int(e.code), None if e.script_error is None else int(e.script_error)
    return True, 0, 0


def _norm(results):
    return [(r.ok, int(r.error), None if r.script_error is None else int(r.script_error))
            for r in results]


@functools.lru_cache(maxsize=1)
def _want():
    return [_reference(it) for it in _items()]


@functools.lru_cache(maxsize=1)
def _runs():
    """Four runs over `_items()`: the index-mode driver with cold caches,
    then with the sig cache that run filled (a fresh script cache), then
    with both caches warm; and the wire driver with cold caches. Each: the
    verdicts, the verifier's stats and the caches' hit counts."""
    items = _items()
    out = {}

    def run(name, sig, script, idx=True):
        v = TorchSecpVerifier(device="cpu")
        mp = pytest.MonkeyPatch()
        if not idx:
            mp.setenv("BITCOINCONSENSUS_TPU_IDX", "0")
        calls = []
        for seam in ("dispatch_lanes", "verify_checks"):
            orig = getattr(v, seam)
            setattr(v, seam, lambda *a, _o=orig, _s=seam: calls.append(_s) or _o(*a))
        try:
            hits = (sig.hits, script.hits)
            got = verify_batch(items, verifier=v, sig_cache=sig, script_cache=script)
        finally:
            mp.undo()
        out[name] = dict(verdicts=_norm(got), stats=dict(v.stats), calls=calls,
                         sig_hits=sig.hits - hits[0], script_hits=script.hits - hits[1],
                         in_flight=v.in_flight)

    sig, script = SigCache(), ScriptExecutionCache()
    run("index_cold", sig, script)
    run("index_sig_cache_hits", sig, ScriptExecutionCache())
    run("index_script_cache_hits", sig, script)
    run("wire_cold", SigCache(), ScriptExecutionCache(), idx=False)
    return out


@pytest.mark.parametrize("name", ["index_cold", "index_sig_cache_hits",
                                  "index_script_cache_hits", "wire_cold"])
def test_index_mode_matches_wire_driver_and_reference(name):
    runs = _runs()
    got = runs[name]
    assert got["verdicts"] == _want()
    assert got["verdicts"] == runs["wire_cold"]["verdicts"]
    assert got["in_flight"] == 0 and got["stats"].get("fixups", 0) == 0
    want = _want()
    n_bad = sum(not w[0] for w in want)
    assert 0 < n_bad < len(want) and want[-1][0]  # the misaligned multisig holds
    if name == "wire_cold":  # the wire driver never uses the lane seam
        assert got["calls"] == ["verify_checks"]
    elif name == "index_cold":
        # The misaligned pairing rides the first dispatch (speculative
        # pairings): one dispatch for the batch, through the lane seam only.
        assert got["calls"] == ["dispatch_lanes"]
        assert got["stats"]["dispatches"] == 1
        assert got["stats"]["lanes"] == runs["wire_cold"]["stats"]["lanes"]
    elif name == "index_sig_cache_hits":
        # Only the failing checks miss the success-only cache.
        assert got["sig_hits"] > 0 and got["script_hits"] == 0
        assert 0 < got["stats"]["lanes"] < runs["index_cold"]["stats"]["lanes"]
    else:
        assert got["script_hits"] == len(want) - n_bad


@pytest.mark.parametrize("seed", range(6))
def test_accept_mask_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    U = int(rng.integers(1, 64))
    val = rng.random(U) < 0.7
    n = int(rng.integers(1, 40))
    per = rng.integers(0, 5, n)
    bounds = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    rec_idx = rng.integers(0, U, int(bounds[-1])).astype(np.int32)
    unk = np.where(rng.random(n) < 0.3, 0, per).astype(np.int32)
    states = []
    for mod in (JBATCH, TBATCH):
        st = mod._UniqState()
        st.val = val.copy()
        states.append(mod._accept_mask(st, rec_idx, bounds, unk))
    assert states[0].dtype == states[1].dtype == bool
    assert np.array_equal(states[0], states[1])


def _reference_pad(n, min_batch, pad_step):
    """`TpuSecpVerifier._pad` of the JAX package, by its published rule:
    the power-of-two ladder from min_batch over n + 1, capped by the next
    multiple of pad_step above n (never below min_batch)."""
    size = min_batch
    while size < n + 1:
        size *= 2
    if pad_step is None:
        return size
    return min(size, max(min_batch, ((n + pad_step) // pad_step) * pad_step))


@pytest.mark.parametrize("min_batch,pad_step", [(8, None), (8, 512), (8, 2048),
                                                (512, 2048), (2048, 2048)])
def test_pad_matches_the_reference_rule(min_batch, pad_step):
    v = TorchSecpVerifier(device="cpu", min_batch=min_batch, pad_step=pad_step)
    got = [v.pad(n) for n in range(20_001)]
    assert got == [_reference_pad(n, min_batch, pad_step) for n in range(20_001)]
    assert all(p > n for n, p in enumerate(got))  # a pad lane always in reserve
    if pad_step == 2048 and min_batch == 512:
        assert v.pad(5_600) == 6_144 and v.pad(4) == 512


@pytest.mark.parametrize("pad_step", [0, -512, 1000, 513, 2047])
def test_bad_pad_step_raises(pad_step):
    with pytest.raises(ValueError, match="pad_step"):
        TorchSecpVerifier(device="cpu", pad_step=pad_step)


def test_chunk_and_lane_capacity():
    v = TorchSecpVerifier(device="cpu", chunk=1 << 12)
    assert v.chunk == 4096 and v.lane_capacity == 4095
    assert v.pad(v.lane_capacity) == 4096


# -- the stream ---------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _stream_batches():
    """[cached, real, empty, real]: the first resolved wholly from the script
    cache (warmed through a sig cache that holds its checks, so the warm-up
    dispatches nothing), two with corrupted inputs, and an empty batch."""
    items, _bad = B.mixed_items(18, seed=40, corrupt_rate=0.1)
    b0, b1, b2 = items[:4], items[4:11], items[11:]
    warm_sig = SigCache()
    verify_batch(b0, verifier=TorchSecpVerifier(device="cpu"), sig_cache=warm_sig,
                 script_cache=ScriptExecutionCache())
    assert all(w[0] for w in map(_reference, b0))
    want = [_norm(verify_batch(b, verifier=TorchSecpVerifier(device="cpu"),
                               sig_cache=SigCache(), script_cache=ScriptExecutionCache()))
            for b in (b1, b2)]
    assert want == [[_reference(it) for it in b] for b in (b1, b2)]
    assert any(not w[0] for w in want[0] + want[1])
    return (b0, b1, [], b2), warm_sig, want


def _cached_script_cache(b0, warm_sig):
    """A fresh script cache holding b0's inputs; no dispatch."""
    v = TorchSecpVerifier(device="cpu")
    script = ScriptExecutionCache()
    verify_batch(b0, verifier=v, sig_cache=warm_sig, script_cache=script)
    assert v.stats["dispatches"] == 0
    return script


class _Counting(TorchSecpVerifier):
    """A CPU verifier that counts its lane dispatches and settles."""

    def __init__(self):
        super().__init__(device="cpu")
        self.dispatched = self.synced = 0

    def dispatch_lanes(self, args, n):
        self.dispatched += 1
        return super().dispatch_lanes(args, n)

    def sync_lanes(self, pending, n):
        self.synced += 1
        return super().sync_lanes(pending, n)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_equals_verify_batch_per_batch(depth):
    batches, warm_sig, want = _stream_batches()
    script = _cached_script_cache(batches[0], warm_sig)
    v = _Counting()
    got = [_norm(r) for r in verify_batch_stream(iter(batches), verifier=v,
                                                 sig_cache=SigCache(),
                                                 script_cache=script, depth=depth)]
    assert got == [[(True, 0, 0)] * len(batches[0]), want[0], [], want[1]]
    assert v.dispatched == v.synced == 2 and v.in_flight == 0


def test_stream_closed_early_settles_every_dispatch(monkeypatch):
    batches, warm_sig, want = _stream_batches()
    runs = []

    class Recording(TBATCH.IdxFixpoint):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    monkeypatch.setattr(TBATCH, "IdxFixpoint", Recording)
    v = _Counting()
    gen = verify_batch_stream(iter([batches[1], batches[3], batches[1]]), verifier=v,
                              sig_cache=SigCache(), script_cache=ScriptExecutionCache(),
                              depth=2)
    assert _norm(next(gen)) == want[0]
    assert v.in_flight == 1 and runs[1]._in_flight is not None  # batch 2 in flight
    gen.close()
    assert len(runs) == 2 and all(r._in_flight is None and not r._pending for r in runs)
    assert v.dispatched == v.synced == 2 and v.in_flight == 0
    # The verifier goes on serving.
    again = verify_batch(batches[3], verifier=v, sig_cache=SigCache(),
                         script_cache=ScriptExecutionCache())
    assert _norm(again) == want[1] and v.in_flight == 0


def test_stream_on_the_python_engine_runs_each_batch_synchronously():
    """The Python engine has no index mode: each batch goes through
    `verify_batch` in its turn, with the same verdicts."""
    batches, _warm, want = _stream_batches()
    v = TorchSecpVerifier(device="cpu", engine="python")
    sig = SigCache()
    got = [_norm(r) for r in verify_batch_stream(
        iter([[], batches[1]]), verifier=v, sig_cache=sig,
        script_cache=ScriptExecutionCache(), engine="python")]
    assert got == [[], want[0]]
    with pytest.raises(ValueError, match="engine"):
        next(verify_batch_stream(iter([batches[1]]), verifier=v))


# -- the session's uniq surfaces against the wire protocol ------------------------


def _session_args(nb, n=12, seed="torch-idx-uniq", corrupt=4):
    """n inputs cycling p2wpkh / p2tr / p2wsh 2-of-3 in one spend tx, one of
    them with a corrupted signature, as the batched native calls of the
    bridge `nb` take them."""
    _, funded = B.make_funded_view(n, kinds=("p2wpkh", "p2tr", "p2wsh_multisig"),
                                   seed=seed)
    raw = B.build_spend_tx(funded, fee=900, corrupt_input=corrupt).serialize()
    ntx = nb.NativeTx(raw)
    ntx.set_spent_outputs([(f.amount, f.wallet.spk) for f in funded])
    return ([ntx] * n, list(range(n)), [f.amount for f in funded],
            [f.wallet.spk for f in funded], [F.VERIFY_ALL_EXTENDED] * n)


def _same_arrays(a, b):
    return all(x.shape == y.shape and x.dtype == y.dtype and x.tobytes() == y.tobytes()
               for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("n_threads", [1, 3])
def test_uniq_lanes_and_digests_equal_the_wire_protocol(n_threads):
    """The index-mode session against the wire protocol it replaces: the
    same verdicts; input i's rec_idx slice names the checks the wire path
    records for input i; `uniq_lanes` byte-equal to `prep_pack` of the same
    checks, pad lanes included; `uniq_digests` equal to the sig cache's keys
    of them; and both byte-equal to the JAX package's bridge on the same
    inputs."""
    from bitcoinconsensus_tpu import native_bridge as JNB
    from bitcoinconsensus_tpu_torch import native_bridge as NB
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck

    args = _session_args(NB)
    wire = NB.NativeSession()
    w_ok, w_err, w_unk, w_recs = wire.verify_inputs(*args, mode=NB.NativeSession.MODE_DEFER)
    flat = [r for recs in w_recs for r in recs] + wire.take_spec()

    sess = NB.NativeSession()
    ok, err, unk, rec_idx, bounds = sess.verify_inputs_idx(*args, n_threads=n_threads)
    assert np.array_equal(ok, w_ok) and np.array_equal(err, w_err)
    assert np.array_equal(unk, w_unk)
    assert (unk > 0).all()  # deferring: every signature is an oracle miss

    n_u = sess.uniq_count()
    all_idx = np.arange(n_u, dtype=np.int32)
    by_key = dict(zip(NB.digest_checks(b"salt!", flat), flat, strict=True))
    uniq_keys = [d.tobytes() for d in sess.uniq_digests(b"salt!", all_idx)]
    assert len(set(uniq_keys)) == n_u and set(uniq_keys) == set(by_key)
    for i, recs in enumerate(w_recs):
        mine = [uniq_keys[j] for j in rec_idx[int(bounds[i]):int(bounds[i + 1])]]
        assert mine == NB.digest_checks(b"salt!", recs), f"input {i}"

    checks = [SigCheck(*by_key[k]) for k in uniq_keys]
    pad = TorchSecpVerifier(device="cpu").pad(n_u)
    assert pad > n_u  # pad lanes are compared too
    assert _same_arrays(sess.uniq_lanes(all_idx, pad), NB.prep_pack(checks, pad))
    sub = all_idx[1::2][::-1].copy()  # a subset, out of order
    assert _same_arrays(sess.uniq_lanes(sub, len(sub)),
                        NB.prep_pack([checks[j] for j in sub], len(sub)))
    cache = SigCache()
    assert [d.tobytes() for d in sess.uniq_digests(cache._salt, all_idx)] == \
        cache.keys_for_checks(checks)
    assert [d.tobytes() for d in sess.uniq_digests(cache._salt, sub)] == \
        [cache.keys_for_checks(checks)[j] for j in sub]

    ref = JNB.NativeSession()
    ref_out = ref.verify_inputs_idx(*_session_args(JNB), n_threads=n_threads)
    for a, b in zip(ref_out, (ok, err, unk, rec_idx, bounds), strict=True):
        assert np.array_equal(np.asarray(a), b)
    assert ref.uniq_count() == n_u
    assert _same_arrays([np.asarray(a) for a in ref.uniq_lanes(all_idx, pad)],
                        sess.uniq_lanes(all_idx, pad))
    assert np.array_equal(np.asarray(ref.uniq_digests(b"salt!", all_idx)),
                          sess.uniq_digests(b"salt!", all_idx))


def test_publish_uniq_answers_like_the_exact_mode():
    """Every uniq entry's host verdict (`uniq_host_verify`, equal to the
    host oracle on the same check) published with `publish_uniq` answers
    every oracle read of a second pass, whose verdicts are then the exact
    mode's."""
    from bitcoinconsensus_tpu_torch import native_bridge as NB
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck

    args = _session_args(NB, n=6, seed="torch-idx-publish", corrupt=2)
    wire = NB.NativeSession()
    _ok, _err, _unk, w_recs = wire.verify_inputs(*args, mode=NB.NativeSession.MODE_DEFER)
    flat = [r for recs in w_recs for r in recs] + wire.take_spec()
    by_key = dict(zip(NB.digest_checks(b"s", flat), flat, strict=True))

    sess = NB.NativeSession()
    sess.verify_inputs_idx(*args)
    n_u = sess.uniq_count()
    all_idx = np.arange(n_u, dtype=np.int32)
    got = np.asarray([sess.uniq_host_verify(j) for j in range(n_u)], dtype=np.int32)
    host = TorchSecpVerifier(device="cpu")
    want = [host._host_check(SigCheck(*by_key[d.tobytes()]))
            for d in sess.uniq_digests(b"s", all_idx)]
    assert got.tolist() == [int(w) for w in want] and 0 < got.sum() < n_u
    sess.publish_uniq(all_idx, got)
    ok2, err2, unk2, _ri, _b = sess.verify_inputs_idx(*args)
    assert not unk2.any()
    ok_ex, err_ex, _u, _r = NB.NativeSession().verify_inputs(
        *args, mode=NB.NativeSession.MODE_EXACT)
    assert np.array_equal(ok2, ok_ex) and np.array_equal(err2, err_ex)
    assert not ok2[2] and ok2.sum() == len(ok2) - 1


def test_idx_threads_reads_the_environment(monkeypatch):
    """The index-mode fan-out: BITCOINCONSENSUS_TPU_THREADS when set (at
    least 1), else the host's core count, as the reference reads it."""
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_THREADS", "3")
    assert TBATCH._idx_threads() == JBATCH._idx_threads() == 3
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_THREADS", "0")
    assert TBATCH._idx_threads() == 1
    monkeypatch.delenv("BITCOINCONSENSUS_TPU_THREADS")
    assert TBATCH._idx_threads() == JBATCH._idx_threads() == max(1, os.cpu_count() or 1)
