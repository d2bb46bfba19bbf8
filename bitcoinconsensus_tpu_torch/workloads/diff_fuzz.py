"""Continuous differential fuzzing across all three verdict engines.

A copy of `bitcoinconsensus_tpu/workloads/diff_fuzz.py` on the port's
engines. Seed-driven mutation of adversarial corpus entries (the mutant
stream byte-identical to the reference's for the same `(seed, n_cases,
corpus order)`), every mutant run through three independent
implementations:

1. ``python_verdict`` — the pure-Python interpreter (`core/interpreter`),
   driven directly (never touches the native bridge or the batch
   machinery). This is the host oracle: a line-for-line transcription of
   the spec.
2. ``native_verdict`` — the C++ core (`csrc/native/`) through
   NativeTx/NativeSession in exact mode, in the transport check order of
   the api's native branch. ``None`` when the bridge is unavailable.
3. ``batch_verdicts`` — `verify_batch` with fresh caches on the given
   verifier, in the driver's default (the native index mode): the
   deferred checker, the card's `verify_tiles` and verdict checksum
   kernels and the cache pipeline that production traffic takes.

The contract is fail-closed: any disagreement on the full verdict
triple ``(ok, Error, ScriptError)`` between any pair of engines is a
divergence, and one unexplained divergence fails the gauntlet. Fixed
seed sets for CI live in `fuzz/gauntlet_seeds.json` so failures
reproduce exactly.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

from ..api import Error
from ..core.flags import (
    ALL_FLAG_BITS,
    LIBCONSENSUS_FLAGS,
    VERIFY_CLEANSTACK,
    VERIFY_P2SH,
    VERIFY_TAPROOT,
    VERIFY_WITNESS,
)
from ..core.interpreter import TransactionSignatureChecker, verify_script
from ..core.script_error import ScriptError
from ..core.serialize import SerializationError
from ..core.sighash import PrecomputedTxData
from ..core.tx import Tx, TxOut
from ..models.batch import BatchItem, BatchResult, verify_batch
from ..models.sigcache import ScriptExecutionCache, SigCache

__all__ = [
    "Verdict",
    "python_verdict",
    "native_verdict",
    "batch_verdicts",
    "backend_verdicts",
    "mutate",
    "fuzz_cases",
    "run_diff_fuzz",
]

# (ok, transport-error name, script-error name or None). Script error is
# normalised to None on success so engines that report OK/None/absent
# on the success path can never spuriously diverge.
Verdict = Tuple[bool, str, Optional[str]]

MUTATIONS = (
    "tx_flip",
    "tx_truncate",
    "tx_extend",
    "spk_flip",
    "amount_perturb",
    "flags_random",
    "flags_invalid",
    "index_perturb",
)


def _allowed(item: BatchItem) -> int:
    # Mirrors batch._prepare / the api entry points: the full 21-bit
    # space with spent outputs, the libconsensus subset without.
    return ALL_FLAG_BITS if item.spent_outputs is not None else LIBCONSENSUS_FLAGS


def _norm(ok: bool, err: Error, serr: Optional[ScriptError]) -> Verdict:
    name = None
    if not ok and serr is not None and serr != ScriptError.OK:
        name = serr.name
    return (ok, err.name, name)


def python_verdict(item: BatchItem) -> Verdict:
    """Pure-Python engine verdict; transport check order of
    bitcoinconsensus.cpp:79-101 (flags → deserialize → index → size →
    prevout availability → script eval)."""
    if item.flags & ~_allowed(item):
        return _norm(False, Error.ERR_INVALID_FLAGS, None)
    try:
        tx = Tx.deserialize(item.spending_tx)
    except SerializationError:
        return _norm(False, Error.ERR_TX_DESERIALIZE, None)
    if item.input_index < 0 or item.input_index >= len(tx.vin):
        return _norm(False, Error.ERR_TX_INDEX, None)
    try:
        size_ok = len(tx.serialize()) == len(item.spending_tx)
    except Exception:  # noqa: BLE001 — unserializable parse is a size lie
        size_ok = False
    if not size_ok:
        return _norm(False, Error.ERR_TX_SIZE_MISMATCH, None)

    if item.spent_outputs is not None:
        if len(item.spent_outputs) != len(tx.vin):
            return _norm(False, Error.ERR_TX_INDEX, None)
        prevouts = [TxOut(v, s) for v, s in item.spent_outputs]
        txdata = PrecomputedTxData(tx, prevouts)
        spk = prevouts[item.input_index].script_pubkey
        amount = prevouts[item.input_index].value
    else:
        if item.flags & VERIFY_TAPROOT:
            return _norm(False, Error.ERR_AMOUNT_REQUIRED, None)
        txdata = PrecomputedTxData(tx)
        spk = item.spent_output_script or b""
        amount = item.amount

    checker = TransactionSignatureChecker(tx, item.input_index, amount, txdata)
    ok, script_err = verify_script(
        tx.vin[item.input_index].script_sig,
        spk,
        tx.vin[item.input_index].witness,
        item.flags,
        checker,
    )
    if ok:
        return _norm(True, Error.ERR_OK, None)
    return _norm(False, Error.ERR_SCRIPT, script_err)


def native_verdict(item: BatchItem) -> Optional[Verdict]:
    """C++ core verdict in exact mode, or None when the bridge is
    unavailable. Same transport order as the api native branch."""
    from .. import native_bridge

    if not native_bridge.available():
        return None
    if item.flags & ~_allowed(item):
        return _norm(False, Error.ERR_INVALID_FLAGS, None)
    try:
        ntx = native_bridge.NativeTx(item.spending_tx)
    except ValueError:
        return _norm(False, Error.ERR_TX_DESERIALIZE, None)
    if item.input_index < 0 or item.input_index >= ntx.n_inputs:
        return _norm(False, Error.ERR_TX_INDEX, None)
    if ntx.ser_size != len(item.spending_tx):
        return _norm(False, Error.ERR_TX_SIZE_MISMATCH, None)
    if item.spent_outputs is not None:
        if len(item.spent_outputs) != ntx.n_inputs:
            return _norm(False, Error.ERR_TX_INDEX, None)
        ntx.set_spent_outputs(list(item.spent_outputs))
        spk = item.spent_outputs[item.input_index][1]
        amount = item.spent_outputs[item.input_index][0]
    else:
        if item.flags & VERIFY_TAPROOT:
            return _norm(False, Error.ERR_AMOUNT_REQUIRED, None)
        ntx.precompute()
        spk = item.spent_output_script or b""
        amount = item.amount
    sess = native_bridge.NativeSession()
    ok, err_code, _ = sess.verify_input(
        ntx, item.input_index, amount, spk, item.flags,
        mode=native_bridge.NativeSession.MODE_EXACT,
    )
    if ok:
        return _norm(True, Error.ERR_OK, None)
    return _norm(False, Error.ERR_SCRIPT, ScriptError(err_code))


def _result_verdict(r: BatchResult) -> Verdict:
    return _norm(r.ok, r.error, r.script_error)


def batch_verdicts(items: Sequence[BatchItem], chunk: int = 64, device=None,
                   verifier=None) -> List[Verdict]:
    """Verdicts through the production batch driver, fresh caches per chunk
    (so a poisoned global cache can never mask a divergence), on `verifier`,
    else on a new one on `device` (None: cuda:0, raising without CUDA)."""
    from . import resolve_verifier

    verifier = resolve_verifier(device, verifier)
    out: List[Verdict] = []
    for lo in range(0, len(items), chunk):
        res = verify_batch(
            list(items[lo : lo + chunk]),
            verifier=verifier,
            sig_cache=SigCache(),
            script_cache=ScriptExecutionCache(),
        )
        out.extend(_result_verdict(r) for r in res)
    return out


def backend_verdicts(item: BatchItem, device=None, verifier=None) -> dict:
    """All engines on one item — {'python': V, 'native': V|None,
    'batch': V}. Test/debug convenience; run_diff_fuzz batches instead."""
    return {
        "python": python_verdict(item),
        "native": native_verdict(item),
        "batch": batch_verdicts([item], device=device, verifier=verifier)[0],
    }


def mutate(item: BatchItem, rng: random.Random) -> Tuple[BatchItem, str]:
    """One seed-driven mutation of a corpus item. Every mutation keeps
    the item well-formed at the API level (bytes/ints of the right
    types) — malformedness lives in the *content*, which is the point."""
    kind = rng.choice(MUTATIONS)
    tx = bytearray(item.spending_tx)
    fields = dataclasses.asdict(item)  # shallow copies of primitives
    if kind == "tx_flip":
        pos = rng.randrange(len(tx))
        tx[pos] ^= 1 << rng.randrange(8)
        fields["spending_tx"] = bytes(tx)
    elif kind == "tx_truncate":
        fields["spending_tx"] = bytes(tx[: rng.randrange(len(tx))])
    elif kind == "tx_extend":
        fields["spending_tx"] = bytes(tx) + bytes(
            rng.getrandbits(8) for _ in range(rng.randint(1, 8))
        )
    elif kind == "spk_flip" and item.spent_outputs:
        outs = [list(o) for o in item.spent_outputs]
        tgt = rng.randrange(len(outs))
        spk = bytearray(outs[tgt][1])
        if spk:
            spk[rng.randrange(len(spk))] ^= 1 << rng.randrange(8)
        outs[tgt][1] = bytes(spk)
        fields["spent_outputs"] = [tuple(o) for o in outs]
    elif kind == "amount_perturb" and item.spent_outputs:
        outs = [list(o) for o in item.spent_outputs]
        tgt = rng.randrange(len(outs))
        outs[tgt][0] = max(0, outs[tgt][0] + rng.choice((-1, 1, 1000, -1000)))
        fields["spent_outputs"] = [tuple(o) for o in outs]
    elif kind == "flags_random":
        f = rng.getrandbits(21)
        # The interpreter inherits Core's caller contract
        # (interpreter.cpp:1990,2076): WITNESS requires P2SH, CLEANSTACK
        # requires both. Outside it behavior is asserted, not defined —
        # the fuzzer stays inside the defined space.
        if f & VERIFY_WITNESS:
            f |= VERIFY_P2SH
        if f & VERIFY_CLEANSTACK:
            f |= VERIFY_P2SH | VERIFY_WITNESS
        fields["flags"] = f
    elif kind == "flags_invalid":
        # A bit above the defined space: every engine must agree on
        # ERR_INVALID_FLAGS before touching the tx at all.
        fields["flags"] = item.flags | (1 << rng.randint(21, 31))
    elif kind == "index_perturb":
        fields["input_index"] = rng.choice(
            (-1, item.input_index + 1, item.input_index + 64, 2**31)
        )
    else:  # spk/amount mutation drawn for a no-prevouts item
        pos = rng.randrange(len(tx))
        tx[pos] ^= 1 << rng.randrange(8)
        fields["spending_tx"] = bytes(tx)
        kind = "tx_flip"
    if fields.get("spent_outputs") is not None:
        fields["spent_outputs"] = [tuple(o) for o in fields["spent_outputs"]]
    return BatchItem(**fields), kind


def fuzz_cases(seed: int, n_cases: int, corpus) -> Tuple[List[BatchItem],
                                                          List[Tuple[str, str]]]:
    """The mutant stream of (seed, n_cases, corpus order): the items and,
    per item, (origin case name, mutation kind)."""
    rng = random.Random(seed)
    base = [c.item for c in corpus]
    names = [c.name for c in corpus]
    items: List[BatchItem] = []
    meta: List[Tuple[str, str]] = []
    while len(items) < n_cases:
        i = rng.randrange(len(base))
        mutant, kind = mutate(base[i], rng)
        items.append(mutant)
        meta.append((names[i], kind))
    return items, meta


def run_diff_fuzz(
    seed: int = 0,
    n_cases: int = 500,
    chunk: int = 64,
    corpus=None,
    device=None,
    verifier=None,
) -> dict:
    """Mutate corpus entries and compare all engines; returns a report
    with per-case divergences (one unexplained divergence fails the
    gauntlet). Deterministic from (seed, n_cases, corpus order). The batch
    engine runs on `verifier`, else on a new one on `device` (None:
    cuda:0)."""
    from .. import native_bridge
    from . import GAUNTLET_DIVERGENCE, GAUNTLET_FUZZ_CASES, resolve_verifier
    from .corpus import build_corpus

    verifier = resolve_verifier(device, verifier)
    if corpus is None:
        corpus = build_corpus()
    items, meta = fuzz_cases(seed, n_cases, corpus)

    have_native = native_bridge.available()
    py = [python_verdict(it) for it in items]
    nat = [native_verdict(it) for it in items] if have_native else [None] * len(items)
    bat = batch_verdicts(items, chunk=chunk, verifier=verifier)

    divergences: List[dict] = []
    kinds: dict = {}
    for i, it in enumerate(items):
        kinds[meta[i][1]] = kinds.get(meta[i][1], 0) + 1
        engines = {"python": py[i], "batch": bat[i]}
        if nat[i] is not None:
            engines["native"] = nat[i]
        if len(set(engines.values())) > 1:
            divergences.append(
                {
                    "case": i,
                    "origin": meta[i][0],
                    "mutation": meta[i][1],
                    "flags": it.flags,
                    "input_index": it.input_index,
                    "spending_tx": it.spending_tx.hex(),
                    "verdicts": {k: list(v) for k, v in engines.items()},
                }
            )
    GAUNTLET_FUZZ_CASES.inc(len(items))
    GAUNTLET_DIVERGENCE.inc(len(divergences), leg="diff_fuzz")
    return {
        "seed": seed,
        "cases": len(items),
        "native_available": have_native,
        "engines": 3 if have_native else 2,
        "mutations": kinds,
        "divergences": divergences,
        "bit_identical": not divergences,
    }
