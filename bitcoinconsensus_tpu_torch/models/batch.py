"""`verify_batch()`: many inputs, one signature dispatch on the device.

Port of the wire-mode driver of `bitcoinconsensus_tpu/models/batch.py`.
The reference parallelises block validation with one `CScriptCheck` per
input on a thread pool (`checkqueue.h:29-163`); here the parallel axis is
the signature, through the checker-override seam the reference provides
(`interpreter.h:275-301`, `script/sigcache.cpp:101-122`):

1. Every input's scripts run on the host with a `DeferringSignatureChecker`
   that records each curve check (ECDSA, Schnorr, taproot tweak) and
   optimistically reports success; encoding checks still run inline.
2. The recorded checks of all inputs, deduplicated and filtered through the
   salted sig cache, resolve in one mixed device dispatch
   (`crypto/torch_backend.py`).
3. Inputs whose optimistic guesses were wrong are re-interpreted with the
   device results as an oracle; checks the corrected control flow discovers
   (a CHECKMULTISIG cursor, interpreter.cpp:1177-1205) go out as further
   dispatches until a fixpoint. A round cap falls back to the exact host
   checker.

The host steps run on one of two engines, each chosen by the caller and
never swapped for the other: the native host core (`native_bridge`, the
default), which parses, precomputes, interprets every input of a phase in
one C call and digests the cache keys in C++, or the Python engine
(`core/`, `engine="python"`), the spec the native one is held to.

On the native engine the three steps run in index mode (`IdxFixpoint`):
the session keeps the deduplicated checks (`uniq`) in C++, and Python moves
only int32 indices into that list and packed lanes out of it, through the
verifier's asynchronous seam (`dispatch_lanes` / `sync_lanes`). The wire
driver, which moves every check's bytes through Python as `SigCheck`s,
stays as the executable spec: BITCOINCONSENSUS_TPU_IDX=0 selects it.
`verify_batch_stream` runs index mode over many batches, beginning batch
N+1 (parse, probe, interpretation, dispatch) before it settles batch N.
`models/validate.connect_block` drives the same fixpoint for a block.

Results are bit-identical to the per-input `api` entry points, `Error` and
`ScriptError` included, on either engine and either driver. Every dispatch
settles through the verifier's guards (`resilience/`); a device fault the
retries do not clear raises `DispatchFailed`, and so does the `batch.dispatch`
fault site where a driver dispatches (the reference re-verifies those checks
on the host instead): nothing of that dispatch enters either cache. With
`resilience.set_cache_audit(True)` both drivers re-verify every sig-cache hit
on the exact host oracle and discard an entry proven wrong
(`stats["cache_poison_caught"]` of the verifier).

Telemetry (`obs/`, the reference's names): batch sizes and items, results
by outcome, rejections by `Error` and `ScriptError` (shared with the api),
fixpoint rounds, exact fallbacks, deduplicated checks, host fixups and the
stream's window, each incremented by batch totals, never once per input.
Spans, per batch or per round: `batch.verify_batch`, `batch.prepare`,
`batch.probe` (with `batch.probe_parts`, `batch.probe_keys` and
`batch.probe_lookup`), `batch.interpret` (with `batch.interpret_args`, the
argument lists, around the verifier's `interpret` phase), `batch.resolve`
(with `batch.uniq_keys`, `batch.sig_probe`, `batch.sig_cache_insert` and
`batch.publish` in index mode), `batch.assemble` (with `batch.results` and
`batch.script_cache_insert`), `batch.accept` (the fixpoint's acceptance of
a round's verdicts), `batch.release` (index mode's native handles and prep
records freed), `batch.stream_begin` and `batch.stream_finish`; the
collector's sweep at the end of a paused section is `gc.sweep`. This module reads no clock: every span times
through `obs/spans.py`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native_bridge
from ..api import Error
from ..core.flags import ALL_FLAG_BITS, LIBCONSENSUS_FLAGS, VERIFY_TAPROOT
from ..core.interpreter import TransactionSignatureChecker, verify_script
from ..core.script_error import ScriptError
from ..core.serialize import SerializationError
from ..core.sighash import PrecomputedTxData
from ..core.tx import Tx, TxOut
from ..crypto.torch_backend import HOST_FIXUPS as _HOST_FIXUPS
from ..crypto.torch_backend import SigCheck, TorchSecpVerifier, default_verifier
from ..native_bridge import NativeSession, NativeTx
from ..obs import counter as _obs_counter
from ..obs import gauge as _obs_gauge
from ..obs import histogram as _obs_histogram
from ..obs import span as _span
from ..resilience import faults as _faults
from ..resilience import guards as _guards
from ..utils.gcpause import gc_paused
from ..utils.profiling import accumulate
from .sigcache import (
    ScriptExecutionCache,
    SigCache,
    default_script_cache,
    default_sig_cache,
)

__all__ = [
    "BatchItem",
    "BatchResult",
    "DeferringSignatureChecker",
    "IdxFixpoint",
    "run_idx_fixpoint",
    "verify_batch",
    "verify_batch_stream",
]

MAX_ROUNDS = 24  # > MAX_PUBKEYS_PER_MULTISIG cursor retries

# Batch-driver telemetry, integer-valued (the host lint bans float
# literals here).
_BATCH_SIZE = _obs_histogram(
    "consensus_batch_size",
    "items per verify_batch call",
    buckets=(1, 8, 64, 512, 4096, 32768),
)
_BATCH_ITEMS = _obs_counter(
    "consensus_batch_items_total", "inputs submitted to verify_batch"
)
_BATCH_RESULTS = _obs_counter(
    "consensus_batch_results_total",
    "verify_batch results by outcome",
    ("outcome",),
)
_STREAM_WINDOW = _obs_gauge(
    "consensus_pipeline_stream_window",
    "stream handles concurrently in flight in verify_batch_stream "
    "(begun, not yet finished) — the pipeline's realized overlap depth",
)
_FIXPOINT_ROUNDS = _obs_histogram(
    "consensus_fixpoint_rounds",
    "oracle re-interpretation rounds needed per batch fixpoint",
    buckets=(1, 2, 3, 4, 6, 8, 12, 24),
)
_EXACT_FALLBACK = _obs_counter(
    "consensus_exact_fallback_total",
    "inputs resolved by the exact host checker at the round cap",
)
_UNIQ_CHECKS = _obs_counter(
    "consensus_uniq_checks_total",
    "deduplicated curve checks discovered (uniq-list growth, index mode)",
)
# Shared with the api's entry points (one registry name, one view).
_VERIFY_REJECTS = _obs_counter(
    "consensus_verify_reject_total",
    "verify rejections by transport Error code (api + batch paths)",
    ("code",),
)
_SCRIPT_REJECTS = _obs_counter(
    "consensus_script_reject_total",
    "script-level rejections by ScriptError code (api + batch paths)",
    ("script_error",),
)


def _record_batch_results(out: List["BatchResult"]) -> None:
    """Publish a batch's result counters once, by totals: the rejections
    (a small share) are grouped by code, the rest counted as one."""
    bad = [r for r in out if not r.ok]
    if len(out) > len(bad):
        _BATCH_RESULTS.inc(len(out) - len(bad), outcome="ok")
    rejects: Dict[Tuple[str, Optional[str]], int] = {}
    for r in bad:
        serr = (r.script_error.name if r.script_error is not None
                and r.script_error != ScriptError.OK else None)
        key = (r.error.name, serr)
        rejects[key] = rejects.get(key, 0) + 1
    for (code, serr), n in rejects.items():
        _BATCH_RESULTS.inc(n, outcome="reject")
        _VERIFY_REJECTS.inc(n, code=code)
        if serr is not None:
            _SCRIPT_REJECTS.inc(n, script_error=serr)


@dataclass
class BatchItem:
    """One input verification request.

    `spent_outputs` (all prevouts of the tx, in input order) unlocks the
    taproot path; with only `spent_output_script` + `amount` the item has
    the reach of the reference C ABI.
    """

    spending_tx: bytes
    input_index: int
    flags: int
    spent_output_script: Optional[bytes] = None
    amount: int = 0
    spent_outputs: Optional[Sequence[Tuple[int, bytes]]] = None


@dataclass
class BatchResult:
    ok: bool
    error: Error
    script_error: Optional[ScriptError] = None

    @staticmethod
    def success() -> "BatchResult":
        return BatchResult(True, Error.ERR_OK, ScriptError.OK)


class DeferringSignatureChecker(TransactionSignatureChecker):
    """Records curve checks and answers from a known-results oracle,
    optimistically succeeding on unknowns; the sighash and all encoding
    checks still run inline. `unknown` counts oracle misses: zero means the
    verdict produced is exact."""

    def __init__(self, tx, n_in, amount, txdata, known=None):
        super().__init__(tx, n_in, amount, txdata)
        self.recorded: List[SigCheck] = []
        self.known = known if known is not None else {}
        self.unknown = 0

    def _resolve(self, kind: str, data: Tuple) -> bool:
        res = self.known.get((kind, data))
        if res is None:
            self.unknown += 1
            self.recorded.append(SigCheck(kind, data))
            return True
        return res

    def verify_ecdsa(self, sig_der: bytes, pubkey: bytes, sighash: bytes) -> bool:
        return self._resolve("ecdsa", (pubkey, sig_der, sighash))

    def verify_schnorr(self, sig64: bytes, pubkey32: bytes, sighash: bytes) -> bool:
        return self._resolve("schnorr", (pubkey32, sig64, sighash))

    def verify_taproot_tweak(self, q: bytes, parity: int, p: bytes, t: bytes) -> bool:
        return self._resolve("tweak", (q, parity, p, t))


@dataclass
class _Prepared:
    result: Optional[BatchResult] = None  # set when failed before batching
    tx: Optional[Tx] = None  # the Python engine's parse
    txdata: Optional[PrecomputedTxData] = None
    ntx: Optional[NativeTx] = None  # the native engine's parse
    script_pubkey: bytes = b""
    amount: int = 0
    optimistic: Optional[Tuple[bool, ScriptError]] = None
    checks: List[SigCheck] = field(default_factory=list)
    wtxid: Optional[bytes] = None


def _spent_memo_entry(item: BatchItem, spent_memo: Dict[int, Tuple]):
    """(List[TxOut], digest) for item.spent_outputs, memoised by the
    sequence's identity: the inputs of one tx share one conversion and
    digest. Identity keying is safe within one call (items hold the refs)."""
    key = id(item.spent_outputs)
    ent = spent_memo.get(key)
    if ent is None:
        outs = [TxOut(a, s) for a, s in item.spent_outputs]
        ent = (outs, ScriptExecutionCache.spent_digest(item.spent_outputs))
        spent_memo[key] = ent
    return ent


def _prepare_native(item: BatchItem, prep: _Prepared,
                    ntx_cache: Dict[Tuple, Optional[NativeTx]],
                    spent_memo: Dict[int, Tuple]) -> _Prepared:
    """The native engine's transport checks, in `_prepare`'s order. Parse
    and hash precompute run in C++ once per (raw tx, prevouts digest); a
    prevout list whose length does not match the inputs is not
    precomputed (the item fails with ERR_TX_INDEX, and so does every item
    of the same key)."""
    if item.spent_outputs is not None:
        spent_outputs, digest = _spent_memo_entry(item, spent_memo)
    else:
        spent_outputs, digest = None, None
    key = (item.spending_tx, digest)
    if key in ntx_cache:
        ntx = ntx_cache[key]
    else:
        try:
            ntx = NativeTx(item.spending_tx)
        except ValueError:
            ntx = None
        if ntx is not None:
            if spent_outputs is None:
                ntx.precompute()
            elif len(spent_outputs) == ntx.n_inputs:
                ntx.set_spent_outputs(item.spent_outputs)
        ntx_cache[key] = ntx
    if ntx is None:
        prep.result = BatchResult(False, Error.ERR_TX_DESERIALIZE)
        return prep
    if item.input_index < 0 or item.input_index >= ntx.n_inputs:
        prep.result = BatchResult(False, Error.ERR_TX_INDEX)
        return prep
    if ntx.ser_size != len(item.spending_tx):
        prep.result = BatchResult(False, Error.ERR_TX_SIZE_MISMATCH)
        return prep
    if spent_outputs is not None:
        if len(spent_outputs) != ntx.n_inputs:
            prep.result = BatchResult(False, Error.ERR_TX_INDEX)
            return prep
        prep.script_pubkey = spent_outputs[item.input_index].script_pubkey
        prep.amount = spent_outputs[item.input_index].value
    else:
        if item.flags & VERIFY_TAPROOT:
            prep.result = BatchResult(False, Error.ERR_AMOUNT_REQUIRED)
            return prep
        prep.script_pubkey = item.spent_output_script or b""
        prep.amount = item.amount
    prep.ntx = ntx
    prep.wtxid = ntx.wtxid
    return prep


def _prepare(
    item: BatchItem,
    tx_cache: Dict[bytes, Tuple[Tx, bool]],
    txdata_cache: Dict[Tuple, PrecomputedTxData],
    spent_memo: Dict[int, Tuple],
    ntx_cache: Optional[Dict[Tuple, Optional[NativeTx]]] = None,
) -> _Prepared:
    """Transport-level validation in the order of bitcoinconsensus.cpp:79-101
    (flags -> deserialize -> index -> size). With `ntx_cache` (the native
    engine) parse and precompute run in C++ and no Python Tx is built;
    without it, PrecomputedTxData is built once per (tx, prevouts digest)."""
    prep = _Prepared()
    allowed = ALL_FLAG_BITS if item.spent_outputs is not None else LIBCONSENSUS_FLAGS
    if item.flags & ~allowed:
        prep.result = BatchResult(False, Error.ERR_INVALID_FLAGS)
        return prep
    if ntx_cache is not None:
        return _prepare_native(item, prep, ntx_cache, spent_memo)

    try:
        cached = tx_cache.get(item.spending_tx)
        if cached is None:
            tx = Tx.deserialize(item.spending_tx)
            size_ok = len(tx.serialize()) == len(item.spending_tx)
            tx_cache[item.spending_tx] = (tx, size_ok)
        else:
            tx, size_ok = cached
        # Index before size, as the reference (bitcoinconsensus.cpp:89-92);
        # nIn is unsigned there, so a negative index is out of range.
        if item.input_index < 0 or item.input_index >= len(tx.vin):
            prep.result = BatchResult(False, Error.ERR_TX_INDEX)
            return prep
        if not size_ok:
            prep.result = BatchResult(False, Error.ERR_TX_SIZE_MISMATCH)
            return prep
    except SerializationError:
        prep.result = BatchResult(False, Error.ERR_TX_DESERIALIZE)
        return prep

    if item.spent_outputs is not None:
        spent_outputs, digest = _spent_memo_entry(item, spent_memo)
        if len(spent_outputs) != len(tx.vin):
            prep.result = BatchResult(False, Error.ERR_TX_INDEX)
            return prep
        tkey = (id(tx), digest)
        txdata = txdata_cache.get(tkey)
        if txdata is None:
            txdata = PrecomputedTxData(tx, spent_outputs)
            txdata_cache[tkey] = txdata
        prep.script_pubkey = spent_outputs[item.input_index].script_pubkey
        prep.amount = spent_outputs[item.input_index].value
    else:
        if item.flags & VERIFY_TAPROOT:
            prep.result = BatchResult(False, Error.ERR_AMOUNT_REQUIRED)
            return prep
        tkey = (id(tx), None)
        txdata = txdata_cache.get(tkey)
        if txdata is None:
            txdata = PrecomputedTxData(tx)
            txdata_cache[tkey] = txdata
        prep.script_pubkey = item.spent_output_script or b""
        prep.amount = item.amount
    prep.txdata = txdata
    prep.tx = tx
    prep.wtxid = tx.wtxid
    return prep


def _prepare_and_probe(items: Sequence[BatchItem],
                       script_cache: ScriptExecutionCache, engine: str):
    """Prepare every item and probe the script-execution cache: a hit
    certifies that this exact (wtxid, input, flags, prevouts) succeeded
    before, so the interpreter and the device are skipped
    (validation.cpp:1529-1536). The keys are digested in one call. Returns
    (native session or None, preps, script_keys)."""
    native = native_bridge.use_native(engine)
    nsess = NativeSession() if native else None
    tx_cache: Dict[bytes, Tuple[Tx, bool]] = {}
    txdata_cache: Dict[Tuple, PrecomputedTxData] = {}
    spent_memo: Dict[int, Tuple] = {}
    ntx_cache: Optional[Dict] = {} if native else None
    with _span("batch.prepare", n=len(items)):
        preps = [_prepare(item, tx_cache, txdata_cache, spent_memo, ntx_cache)
                 for item in items]
    script_keys: List[Optional[bytes]] = [None] * len(items)
    with _span("batch.probe"):
        probe_idx: List[int] = []
        probe_parts: List[Tuple[bytes, ...]] = []
        with _span("batch.probe_parts"):
            for idx, (item, prep) in enumerate(zip(items, preps, strict=True)):
                if prep.result is not None:
                    continue
                if item.spent_outputs is not None:
                    digest = _spent_memo_entry(item, spent_memo)[1]
                else:
                    digest = ScriptExecutionCache.spent_digest(
                        [(item.amount, item.spent_output_script or b"")]
                    )
                probe_idx.append(idx)
                probe_parts.append(ScriptExecutionCache._parts(
                    prep.wtxid, item.input_index, item.flags, digest))
        with _span("batch.probe_keys"):
            keys = script_cache.keys_for_parts(probe_parts, engine)
        with _span("batch.probe_lookup"):
            hits = script_cache.contains_keys(keys)
            for idx, key, hit in zip(probe_idx, keys, hits, strict=True):
                script_keys[idx] = key
                if hit:
                    preps[idx].result = BatchResult.success()
    return nsess, preps, script_keys


def verify_batch(
    items: Sequence[BatchItem],
    verifier: Optional[TorchSecpVerifier] = None,
    sig_cache: Optional[SigCache] = None,
    script_cache: Optional[ScriptExecutionCache] = None,
    engine: str = "native",
) -> List[BatchResult]:
    """Verify many inputs with one device signature dispatch.

    Returns one `BatchResult` per item, bit-identical to the per-input API.
    `verifier=None` builds a `TorchSecpVerifier(engine=engine)` on cuda:0;
    pass `TorchSecpVerifier(device="cpu")` to run the plain torch version.
    The success-only caches default to process-wide instances; pass fresh
    ones to isolate. `engine="native"` (the default) parses, interprets and
    digests in the native host core, which must build and load or this
    raises; `engine="python"` runs the Python engine, the spec, and needs a
    verifier of the same engine."""
    _BATCH_SIZE.observe(len(items))
    _BATCH_ITEMS.inc(len(items))
    with _span("batch.verify_batch", n=len(items)), gc_paused():
        out = _verify_batch(items, verifier, sig_cache, script_cache, engine)
    _record_batch_results(out)
    return out


def _defaults(verifier, sig_cache, script_cache, engine: str, caller: str):
    """The verifier and caches a driver runs with: the process-wide ones
    where the caller passed none (a fresh verifier on the Python engine).
    A verifier of the other engine is refused."""
    if verifier is None:
        native = native_bridge.use_native(engine)
        verifier = default_verifier() if native else TorchSecpVerifier(engine=engine)
    elif verifier.engine != engine:
        raise ValueError(f"{caller}(engine={engine!r}) was given a "
                         f"verifier of engine {verifier.engine!r}")
    if sig_cache is None:
        sig_cache = default_sig_cache()
    if script_cache is None:
        script_cache = default_script_cache()
    return verifier, sig_cache, script_cache


def _idx_mode_enabled() -> bool:
    """Index mode unless BITCOINCONSENSUS_TPU_IDX is 0 or off (the wire
    driver, kept as the executable spec)."""
    return os.environ.get("BITCOINCONSENSUS_TPU_IDX", "") not in ("0", "off")


def _idx_ready(nsess, preps) -> bool:
    """Whether a prepared batch can run in index mode: a native session, and
    every prep either resolved already or holding a native handle."""
    return (nsess is not None and _idx_mode_enabled()
            and all(p.result is not None or p.ntx is not None for p in preps))


def _verify_batch(items, verifier, sig_cache, script_cache, engine):
    native = native_bridge.use_native(engine)
    verifier, sig_cache, script_cache = _defaults(
        verifier, sig_cache, script_cache, engine, "verify_batch")

    nsess, preps, script_keys = _prepare_and_probe(items, script_cache, engine)
    if _idx_ready(nsess, preps):
        out = _verify_batch_idx(items, preps, nsess, verifier, sig_cache,
                                script_cache, script_keys)
        # The batch's native handles and prep records, freed in a span of
        # their own: each NativeTx and the session free their C++ state.
        with _span("batch.release"):
            del preps, nsess
        return out
    known: Dict[Tuple, bool] = {}

    def interpret(idxs: Sequence[int]) -> List[Tuple[bool, ScriptError, int, List[SigCheck]]]:
        """Deferring interpretation of the inputs `idxs` against `known`:
        (ok, error, oracle misses, recorded checks) each; the native engine
        takes them all in one C call."""
        if native:
            ok_a, err_a, unk_a, recs = nsess.verify_inputs(
                [preps[i].ntx for i in idxs],
                [items[i].input_index for i in idxs],
                [preps[i].amount for i in idxs],
                [preps[i].script_pubkey for i in idxs],
                [items[i].flags for i in idxs],
                mode=NativeSession.MODE_DEFER,
            )
            return [(bool(ok_a[j]), ScriptError(int(err_a[j])), int(unk_a[j]),
                     [SigCheck(k, d) for k, d in recs[j]])
                    for j in range(len(idxs))]
        out = []
        for i in idxs:
            item, prep = items[i], preps[i]
            checker = DeferringSignatureChecker(
                prep.tx, item.input_index, prep.amount, prep.txdata, known=known
            )
            ok, err = verify_script(
                prep.tx.vin[item.input_index].script_sig,
                prep.script_pubkey,
                prep.tx.vin[item.input_index].witness,
                item.flags,
                checker,
            )
            out.append((ok, err, checker.unknown, checker.recorded))
        return out

    # Phase 1: optimistic interpretation, recording curve checks.
    live = [idx for idx, prep in enumerate(preps) if prep.result is None]
    with _span("batch.interpret", n=len(live)):
        interpreted = interpret(live)
    for idx, (ok, err, _unk, checks) in zip(live, interpreted, strict=True):
        preps[idx].optimistic = (ok, err)
        preps[idx].checks = checks

    # The native engine also records the CHECKMULTISIG pairings a
    # misaligned multisig could need: they ride the same dispatch (never
    # part of any prep's checks, so no optimistic verdict depends on them),
    # and its re-interpretation then finds every answer known.
    def drain_spec() -> List[SigCheck]:
        return [SigCheck(k, d) for k, d in nsess.take_spec()] if native else []

    pushed: set = set()

    def publish_known() -> None:
        """Publish the results the native oracle has not seen yet."""
        if not native:
            return
        fresh_entries = [(key[0], key[1], val) for key, val in known.items()
                         if key not in pushed]
        if fresh_entries:
            nsess.add_known_batch(fresh_entries)
            pushed.update((k, d) for k, d, _ in fresh_entries)

    def resolve(checks: Sequence[SigCheck]) -> None:
        """Fill `known` for every check: sig-cache probe, then ONE
        deduplicated device dispatch; successes feed the cache."""
        with _span("batch.resolve"):
            todo: List[SigCheck] = []
            for chk in checks:
                key = (chk.kind, chk.data)
                if key in known:
                    continue
                known[key] = False  # placeholder until probed/dispatched
                todo.append(chk)
            if todo:
                _UNIQ_CHECKS.inc(len(todo))
                fresh: List[Tuple[SigCheck, bytes]] = []
                audit = _guards.audit_cache_hits()
                cache_keys = sig_cache.keys_for_checks(todo, engine)
                hits = sig_cache.contains_keys(cache_keys)
                for chk, ck, hit in zip(todo, cache_keys, hits, strict=True):
                    if hit:
                        # Audit: a hit certifies a past success, a poisoned
                        # entry nothing; re-verify it exactly, discard if wrong.
                        if audit and not verifier._host_check(chk):
                            verifier.stats["cache_poison_caught"] += 1
                            _guards.CACHE_POISON_CAUGHT.inc(cache="sig")
                            sig_cache.discard_key(ck)
                            fresh.append((chk, ck))
                        else:
                            known[(chk.kind, chk.data)] = True
                    else:
                        fresh.append((chk, ck))
                if fresh:
                    _faults.maybe_raise("batch.dispatch")
                    run_res = verifier.verify_checks([c for c, _ in fresh])
                    for (chk, _ck), r in zip(fresh, run_res, strict=True):
                        known[(chk.kind, chk.data)] = bool(r)
                    # Success-only insertion, like the reference.
                    sig_cache.add_keys([ck for (_c, ck), r in zip(fresh, run_res,
                                                                  strict=True) if r])
            publish_known()

    # Phase 2: one deduplicated dispatch for every recorded check.
    resolve([chk for prep in preps for chk in prep.checks] + drain_spec())

    # Phase 3: accept verdicts whose guesses all held; re-interpret the rest
    # against the oracle until a fixpoint, dispatching what they discover.
    final: Dict[int, Tuple[bool, ScriptError]] = {}
    pending: List[int] = []
    for idx in live:
        prep = preps[idx]
        if all(known[(c.kind, c.data)] for c in prep.checks):
            final[idx] = prep.optimistic
        else:
            pending.append(idx)

    rounds = 1  # the optimistic pass above is round one
    for _round in range(MAX_ROUNDS):
        if not pending:
            break
        rounds += 1
        new_checks: List[SigCheck] = []
        still: List[int] = []
        with _span("batch.interpret", n=len(pending)):
            interpreted = interpret(pending)
        for idx, (ok, err, unknown, recorded) in zip(pending, interpreted,
                                                     strict=True):
            if unknown == 0:
                final[idx] = (ok, err)  # every oracle read was exact
            else:
                new_checks.extend(recorded)
                still.append(idx)
        if still:
            resolve(new_checks + drain_spec())
        pending = still

    _FIXPOINT_ROUNDS.observe(rounds)
    if pending:
        _EXACT_FALLBACK.inc(len(pending))
    for idx in pending:  # round cap hit: exact host checker
        item, prep = items[idx], preps[idx]
        if native:
            ok, err_code, _ = nsess.verify_input(
                prep.ntx, item.input_index, prep.amount, prep.script_pubkey,
                item.flags, mode=NativeSession.MODE_EXACT,
            )
            final[idx] = (ok, ScriptError(err_code))
            continue
        checker = TransactionSignatureChecker(
            prep.tx, item.input_index, prep.amount, prep.txdata
        )
        final[idx] = verify_script(
            prep.tx.vin[item.input_index].script_sig,
            prep.script_pubkey,
            prep.tx.vin[item.input_index].witness,
            item.flags,
            checker,
        )

    return _assemble_results(preps, final, script_cache, script_keys)


# -- index mode ----------------------------------------------------------------------


def _idx_threads() -> int:
    """The interpretation fan-out of index mode (the C call shards its
    inputs across threads and releases the GIL): BITCOINCONSENSUS_TPU_THREADS,
    else the host's core count."""
    env = os.environ.get("BITCOINCONSENSUS_TPU_THREADS", "")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


class _UniqState:
    """One fixpoint's verdicts over its session's uniq list: `val[i]` is
    entry i's (every entry resolves in the round that discovers it, so the
    array is complete up to its length)."""

    __slots__ = ("val",)

    def __init__(self):
        self.val = np.zeros(0, dtype=bool)


def _accept_mask(state: _UniqState, rec_idx: np.ndarray, bounds, unk) -> np.ndarray:
    """Which inputs' verdicts are exact after a resolve round: those with no
    oracle misses (unk == 0), and those whose misses all resolved true (the
    optimistic guess held), counted over the rec_idx slices with one
    cumulative sum."""
    unk = np.asarray(unk)
    out = unk == 0
    if len(rec_idx) and not out.all():
        have = state.val[rec_idx].astype(np.int64)
        b = np.asarray(bounds, dtype=np.int64)
        cs = np.concatenate([np.zeros(1, np.int64), np.cumsum(have)])
        out = out | ((cs[b[1:]] - cs[b[:-1]]) == (b[1:] - b[:-1]))
    return out


def _dispatch_uniq(nsess, verifier, sig_cache, state: _UniqState):
    """The asynchronous half of a resolve round over the uniq entries this
    round discovered: the salted sig-cache probe first (a hit certifies a
    past success; under the cache audit it is re-verified exactly in the
    session, and an entry proven wrong is discarded and its check
    dispatched), then the misses' lanes packed in the session and
    dispatched, one `dispatch_lanes` per chunk, nothing synchronised.
    Every new entry resolves in its round, the speculative CHECKMULTISIG
    pairings included: a misaligned multisig's re-interpretation needs them
    known. Returns the round's record for `_settle_uniq`, or None when the
    round discovered nothing."""
    U = nsess.uniq_count()
    lo = len(state.val)
    if U == lo:
        return None
    _UNIQ_CHECKS.inc(U - lo)
    grow = np.arange(lo, U, dtype=np.int32)
    with verifier.phases("host_prep"):
        raw = nsess.uniq_digests(sig_cache._salt, grow).tobytes()
    with _span("batch.uniq_keys"):
        keys = [raw[32 * j : 32 * j + 32] for j in range(U - lo)]
    state.val = np.concatenate([state.val, np.zeros(U - lo, dtype=bool)])
    if len(sig_cache) == 0 and _faults.active() is None:
        miss = grow  # a cold cache: every probe misses
    else:
        with _span("batch.sig_probe"):
            hit = np.array(sig_cache.contains_keys(keys), dtype=bool)
            if _guards.audit_cache_hits():
                for j in np.nonzero(hit)[0]:
                    if not nsess.uniq_host_verify(int(grow[j])):
                        verifier.stats["cache_poison_caught"] += 1
                        _guards.CACHE_POISON_CAUGHT.inc(cache="sig")
                        sig_cache.discard_key(keys[j])
                        hit[j] = False
        state.val[grow[hit]] = True
        miss = grow[~hit]
    if len(miss):
        _faults.maybe_raise("batch.dispatch")
    pending = []
    cap = verifier.lane_capacity
    for s in range(0, len(miss), cap):
        sub = miss[s : s + cap]
        with accumulate(verifier.stats, "lane_prep_s"), verifier.phases("host_prep"):
            lanes = nsess.uniq_lanes(sub, verifier.pad(len(sub)))
        pending.append((verifier.dispatch_lanes(lanes, len(sub)), sub))
    return grow, keys, pending


def _settle_uniq(nsess, verifier, sig_cache, state: _UniqState, round_rec) -> None:
    """The settling half of a resolve round: each dispatch's verdicts,
    with the lanes the kernel flags `needs_host` resolved exactly in the
    session; successes go into the sig cache, and every verdict of the
    round into the session's oracle."""
    if round_rec is None:
        return
    grow, keys, pending = round_rec
    lo = int(grow[0])
    for pend, sub in pending:
        okv, needs = verifier.sync_lanes(pend, len(sub))
        okv = okv.copy()
        fix = np.nonzero(needs)[0]
        if len(fix):
            _HOST_FIXUPS.inc(len(fix))
            with accumulate(verifier.stats, "fixup_s"):
                for t in fix:
                    okv[t] = nsess.uniq_host_verify(int(sub[t]))
                    if not okv[t]:
                        verifier._fixup_failed = True
                verifier.stats["fixups"] += len(fix)
        state.val[sub] = okv
        with _span("batch.sig_cache_insert"):
            # Success-only, like the reference.
            sig_cache.add_keys([keys[int(i) - lo] for i in sub[okv]])
    with _span("batch.publish"):
        nsess.publish_uniq(grow, state.val[grow].astype(np.int32))


class IdxFixpoint:
    """The deferral fixpoint of index mode, shared by `verify_batch`,
    `verify_batch_stream` and `models/validate._connect_block_native`, split
    into an asynchronous `begin` and a settling `finish`.

    `begin()` interprets the pending inputs (`run_idx(pos) -> (ok, err, unk,
    rec_idx, bounds)`) and dispatches every uniq check they discovered,
    leaving the lanes in flight. `finish()` settles them, accepts the inputs
    whose verdicts are exact, and runs further rounds to the fixpoint;
    inputs still pending after `max_rounds` go through `exact_fallback(idx)
    -> (ok, err_code)`. A stream calls batch N+1's `begin()` between batch
    N's `begin()` and `finish()`."""

    def __init__(self, nsess, verifier: TorchSecpVerifier, sig_cache: SigCache,
                 live: Sequence[int], run_idx, exact_fallback,
                 max_rounds: int = 24):  # > MAX_PUBKEYS_PER_MULTISIG cursor retries
        self.nsess = nsess
        self.verifier = verifier
        self.sig_cache = sig_cache
        self.run_idx = run_idx
        self.exact_fallback = exact_fallback
        self.max_rounds = max_rounds
        self.final: Dict[int, Tuple[bool, int]] = {}
        self._state = _UniqState()
        self._pending = list(live)
        self._rounds = 0
        self._in_flight = None  # (interpretation, the round's uniq record)

    def begin(self) -> None:
        """Start a round: interpret and dispatch, nothing synchronised."""
        if self._in_flight is not None or not self._pending:
            return
        if self._rounds >= self.max_rounds:
            return
        self._rounds += 1
        with _span("batch.interpret", n=len(self._pending)):
            interp = self.run_idx(self._pending)
        with _span("batch.resolve"):
            rec = _dispatch_uniq(self.nsess, self.verifier, self.sig_cache,
                                 self._state)
        self._in_flight = (interp, rec)

    def _settle_round(self) -> None:
        interp, rec = self._in_flight
        self._in_flight = None
        with _span("batch.resolve"):
            _settle_uniq(self.nsess, self.verifier, self.sig_cache, self._state,
                         rec)
        with _span("batch.accept", n=len(self._pending)):
            ok, err, unk, rec_idx, bounds = interp
            accept = _accept_mask(self._state, rec_idx, bounds, unk)
            still: List[int] = []
            for k, idx in enumerate(self._pending):
                if accept[k]:
                    self.final[idx] = (bool(ok[k]), int(err[k]))
                else:
                    still.append(idx)
            self._pending = still

    def abandon(self) -> None:
        """Settle and discard the round in flight without running the
        fixpoint (a stream closed early). Unlike the reference, which
        swallows every settle error here, a failure raises: with the guards,
        one that reaches this point is a `DispatchFailed` (the device gave
        no guarded answer within the retry budget), which a closed stream
        must not hide from its caller."""
        if self._in_flight is not None:
            _interp, rec = self._in_flight
            self._in_flight = None
            if rec is not None:
                for pend, sub in rec[2]:
                    self.verifier.sync_lanes(pend, len(sub))
        self._pending = []

    def finish(self) -> Dict[int, Tuple[bool, int]]:
        """Settle the round in flight, then run rounds to the fixpoint."""
        if self._in_flight is not None:
            self._settle_round()
        while self._pending and self._rounds < self.max_rounds:
            self.begin()
            self._settle_round()
        _FIXPOINT_ROUNDS.observe(self._rounds)
        if self._pending:
            _EXACT_FALLBACK.inc(len(self._pending))
        for idx in self._pending:  # round cap: the exact host checker
            self.final[idx] = self.exact_fallback(idx)
        self._pending = []
        return self.final


def run_idx_fixpoint(nsess, verifier: TorchSecpVerifier, sig_cache: SigCache,
                     live: Sequence[int], run_idx, exact_fallback,
                     max_rounds: int = 24) -> Dict[int, Tuple[bool, int]]:
    """The fixpoint run synchronously (`begin`, then `finish`)."""
    run = IdxFixpoint(nsess, verifier, sig_cache, live, run_idx, exact_fallback,
                      max_rounds=max_rounds)
    run.begin()
    return run.finish()


def _idx_fixpoint_for(items: Sequence[BatchItem], preps: List[_Prepared], nsess,
                      verifier: TorchSecpVerifier, sig_cache: SigCache
                      ) -> Optional[IdxFixpoint]:
    """The fixpoint of a prepared batch, or None where every input resolved
    already (a transport error, or a script-cache hit)."""
    live = [i for i, p in enumerate(preps) if p.result is None]
    if not live:
        return None
    n_threads = _idx_threads()

    def run_idx(pos: List[int]):
        with _span("batch.interpret_args"):
            args = ([preps[i].ntx for i in pos],
                    [items[i].input_index for i in pos],
                    [preps[i].amount for i in pos],
                    [preps[i].script_pubkey for i in pos],
                    [items[i].flags for i in pos])
        with verifier.phases("interpret"):
            return nsess.verify_inputs_idx(*args, n_threads=n_threads)

    def exact_fallback(idx: int) -> Tuple[bool, int]:
        ok, err_code, _ = nsess.verify_input(
            preps[idx].ntx, items[idx].input_index, preps[idx].amount,
            preps[idx].script_pubkey, items[idx].flags,
            mode=NativeSession.MODE_EXACT,
        )
        return ok, err_code

    return IdxFixpoint(nsess, verifier, sig_cache, live, run_idx, exact_fallback)


def _assemble_results(preps: List[_Prepared], final: Dict[int, Tuple],
                      script_cache: ScriptExecutionCache,
                      script_keys: List[Optional[bytes]]) -> List[BatchResult]:
    """The batch's results in item order (`final[idx]` is (ok, ScriptError or
    its code)), then the script-cache insertion of every success, in item
    order, each step in its span."""
    with _span("batch.assemble"):
        out: List[BatchResult] = []
        inserts: List[bytes] = []
        with _span("batch.results"):
            for idx, prep in enumerate(preps):
                if prep.result is not None:
                    out.append(prep.result)
                    continue
                ok, err = final[idx]
                if ok:
                    if script_keys[idx] is not None:
                        inserts.append(script_keys[idx])
                    out.append(BatchResult.success())
                else:
                    out.append(BatchResult(False, Error.ERR_SCRIPT, ScriptError(err)))
        with _span("batch.script_cache_insert"):
            script_cache.add_keys(inserts)
    return out


def _verify_batch_idx(items, preps, nsess, verifier, sig_cache, script_cache,
                      script_keys) -> List[BatchResult]:
    """`verify_batch` in index mode: the wire driver's three steps with the
    checks kept in the session, interpretation sharded across
    `_idx_threads()` threads."""
    run = _idx_fixpoint_for(items, preps, nsess, verifier, sig_cache)
    final: Dict[int, Tuple[bool, int]] = {}
    if run is not None:
        run.begin()
        final = run.finish()
    return _assemble_results(preps, final, script_cache, script_keys)


def verify_batch_stream(
    batches,
    verifier: Optional[TorchSecpVerifier] = None,
    sig_cache: Optional[SigCache] = None,
    script_cache: Optional[ScriptExecutionCache] = None,
    depth: int = 2,
    engine: str = "native",
):
    """`verify_batch` over an iterable of item lists, pipelined.

    Yields one result list per batch, in order, each equal to `verify_batch`
    of that batch, with up to `depth` batches begun: batch N+1 is parsed,
    probed, interpreted and dispatched while batch N's lanes are on the
    card, and batch N is settled after. A batch that cannot run in index
    mode (the Python engine, or BITCOINCONSENSUS_TPU_IDX=0) runs through a
    synchronous `verify_batch` in its turn. Closing the generator early
    settles every dispatch of the batches it had begun."""
    verifier, sig_cache, script_cache = _defaults(
        verifier, sig_cache, script_cache, engine, "verify_batch_stream")
    depth = max(1, int(depth))
    idx_mode = native_bridge.use_native(engine) and _idx_mode_enabled()
    window: List[tuple] = []

    def begin(items):
        if idx_mode:
            with gc_paused(), _span("batch.stream_begin", n=len(items)):
                nsess, preps, script_keys = _prepare_and_probe(items, script_cache,
                                                               engine)
                if _idx_ready(nsess, preps):
                    _BATCH_SIZE.observe(len(items))
                    _BATCH_ITEMS.inc(len(items))
                    run = _idx_fixpoint_for(items, preps, nsess, verifier, sig_cache)
                    if run is not None:
                        run.begin()
                    return ("idx", run, preps, script_keys)
        return ("done", verify_batch(items, verifier, sig_cache, script_cache, engine))

    def finish(handle):
        if handle[0] == "done":
            return handle[1]
        _tag, run, preps, script_keys = handle
        with gc_paused(), _span("batch.stream_finish", n=len(preps)):
            final = run.finish() if run is not None else {}
            out = _assemble_results(preps, final, script_cache, script_keys)
        _record_batch_results(out)
        return out

    try:
        for items in batches:
            window.append(begin(items))
            _STREAM_WINDOW.set(len(window))
            while len(window) >= depth:
                yield finish(window.pop(0))
                _STREAM_WINDOW.set(len(window))
        while window:
            yield finish(window.pop(0))
            _STREAM_WINDOW.set(len(window))
    finally:
        # A consumer that closes the stream early leaves begun batches with
        # dispatches in flight: settle them, so none is left unsettled.
        _abandon_stream_window(window)


def _abandon_stream_window(window: List[tuple]) -> None:
    """Settle and discard every begun, unfinished stream handle."""
    while window:
        handle = window.pop(0)
        if handle[0] == "idx" and handle[1] is not None:
            handle[1].abandon()
