"""Block connect: `connect_block`, the port of
`bitcoinconsensus_tpu/models/validate.py`.

The reference's `ConnectBlock` (`validation.cpp:1946` -> `CheckInputScripts`
`:1516-1599` -> `CScriptCheck::operator()` `:1464-1468`) fans the per-input
script checks out to a thread pool (`checkqueue.h:29-163`). Here every
input's script runs through the deferring interpreter and the block's
signature checks resolve in batched dispatches of the verify kernel:
signature-level batching in place of thread-level parallelism.

Two paths, with equal results:
- a `NativeCoinsView` on the native engine (`_connect_block_native`): the
  block layer (codec, merkle, CheckBlock, witness commitment, accounting,
  sigop cost, view update) runs in the native core, and the script phase
  drives the index-mode fixpoint (`models/batch.run_idx_fixpoint`)
  directly;
- a plain `CoinsView`, or `engine="python"` (`_connect_block_impl`): the
  block layer in Python (`core/block.py`), the script phase through
  `verify_batch`.

Scope: the consensus rules that are functions of (block, UTXO view,
height): input existence, coinbase maturity, value conservation, sigop
cost, script validity, the coinbase reward. Rules that need headers or
median time (BIP34 height in the coinbase, BIP68 sequence locks, nLockTime
finality, difficulty retargets) sit above this layer, as they sit above
`CheckInputScripts` in the reference.

Telemetry (`obs/`, the reference's names): `consensus_blocks_total{result}`
and `consensus_block_reject_total{reason}` (the reject strings verbatim),
and the span `block.connect` around each call. Inside the native path every
step has a span of its own or a verifier phase (`verifier.block_check`,
`verifier.accounting`, `verifier.probe`, `verifier.interpret`,
`verifier.apply`, and the seams'), so a span tree of one call splits it
without a remainder beyond the glue between steps: `block.parse`,
`block.script_keys`, `block.key_list`, `block.script_probe`,
`block.session`, `block.tx_handles`, `block.results`,
`block.script_cache_insert` and `block.release`, with the fixpoint's
`batch.*` spans between.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native_bridge
from ..api import Error
from ..core.block import (
    Block,
    MAX_BLOCK_SIGOPS_COST,
    POW_LIMIT_MAINNET,
    check_block,
    check_witness_commitment,
)
from ..core.flags import (
    VERIFY_P2SH,
    VERIFY_WITNESS,
    height_to_flags,
)
from ..core.script import (
    get_sig_op_count,
    is_p2sh,
    is_push_only,
    is_witness_program,
    iter_ops,
    witness_sig_ops,
)
from ..core.tx import COIN, MAX_MONEY, OutPoint, Tx, TxOut
from ..core.tx_check import WITNESS_SCALE_FACTOR
from ..core.script_error import ScriptError
from ..crypto.torch_backend import TorchSecpVerifier
from ..obs import counter as _obs_counter
from ..obs import span as _span
from ..utils.gcpause import gc_paused
from ..utils.profiling import Phases
from .batch import (
    BatchItem,
    BatchResult,
    _defaults,
    _idx_threads,
    run_idx_fixpoint,
    verify_batch,
)
from .sigcache import ScriptExecutionCache, SigCache

__all__ = [
    "Coin",
    "CoinsView",
    "ConnectResult",
    "connect_block",
    "count_witness_sigops",
    "get_transaction_sigop_cost",
    "get_block_subsidy",
    "COINBASE_MATURITY",
    "overlay_tx_outputs",
]

COINBASE_MATURITY = 100  # consensus/consensus.h:19
SUBSIDY_HALVING_INTERVAL = 210_000  # chainparams.cpp mainnet

# Block-level telemetry; the reason label is the reject string verbatim.
_BLOCKS = _obs_counter(
    "consensus_blocks_total", "connect_block calls by result", ("result",)
)
_BLOCK_REJECTS = _obs_counter(
    "consensus_block_reject_total",
    "connect_block rejections by reason string",
    ("reason",),
)

@dataclass
class Coin:
    """One unspent output + its creation metadata (coins.h Coin)."""

    out: TxOut
    height: int = 0
    coinbase: bool = False


class CoinsView:
    """Dict-backed UTXO set, the `CCoinsViewCache` role in ConnectBlock."""

    def __init__(self):
        self._map: Dict[Tuple[bytes, int], Coin] = {}

    def add(self, outpoint: OutPoint, coin: Coin) -> None:
        self._map[(outpoint.hash, outpoint.n)] = coin

    def add_tx(self, tx: Tx, height: int) -> None:
        cb = tx.is_coinbase()
        for n, out in enumerate(tx.vout):
            self._map[(tx.txid, n)] = Coin(out, height, cb)

    def get(self, outpoint: OutPoint) -> Optional[Coin]:
        return self._map.get((outpoint.hash, outpoint.n))

    def spend(self, outpoint: OutPoint) -> Optional[Coin]:
        return self._map.pop((outpoint.hash, outpoint.n), None)

    def __len__(self) -> int:
        return len(self._map)


def get_block_subsidy(height: int) -> int:
    """GetBlockSubsidy (validation.cpp:1246-1257)."""
    halvings = height // SUBSIDY_HALVING_INTERVAL
    if halvings >= 64:
        return 0
    return (50 * COIN) >> halvings


def count_witness_sigops(
    script_sig: bytes, script_pubkey: bytes, witness: List[bytes], flags: int
) -> int:
    """CountWitnessSigOps (interpreter.cpp:2074-2103)."""
    if not (flags & VERIFY_WITNESS):
        return 0
    assert flags & VERIFY_P2SH
    wp = is_witness_program(script_pubkey)
    if wp is not None:
        return witness_sig_ops(wp[0], wp[1], witness)
    if is_p2sh(script_pubkey) and is_push_only(script_sig):
        data = b""
        for _opcode, pushed in iter_ops(script_sig):
            data = pushed if pushed is not None else b""
        wp = is_witness_program(data)
        if wp is not None:
            return witness_sig_ops(wp[0], wp[1], witness)
    return 0


def get_transaction_sigop_cost(
    tx: Tx, spent_outputs: List[TxOut], flags: int
) -> int:
    """GetTransactionSigOpCost (consensus/tx_verify.cpp:125-147): legacy
    sigops ×4 + P2SH redeem sigops ×4 + witness sigops ×1."""
    cost = 0
    for txin in tx.vin:
        cost += get_sig_op_count(txin.script_sig, accurate=False)
    for txout in tx.vout:
        cost += get_sig_op_count(txout.script_pubkey, accurate=False)
    cost *= WITNESS_SCALE_FACTOR
    if tx.is_coinbase():
        return cost
    if flags & VERIFY_P2SH:
        p2sh = 0
        for txin, prevout in zip(tx.vin, spent_outputs, strict=True):
            if is_p2sh(prevout.script_pubkey) and is_push_only(txin.script_sig):
                data = b""
                for _opcode, pushed in iter_ops(txin.script_sig):
                    data = pushed if pushed is not None else b""
                p2sh += get_sig_op_count(data, accurate=True)
        cost += p2sh * WITNESS_SCALE_FACTOR
    for txin, prevout in zip(tx.vin, spent_outputs, strict=True):
        cost += count_witness_sigops(
            txin.script_sig, prevout.script_pubkey, txin.witness, flags
        )
    return cost


@dataclass
class ConnectResult:
    ok: bool
    reason: Optional[str] = None
    fees: int = 0
    sigop_cost: int = 0
    input_results: Optional[List[BatchResult]] = None

    @property
    def script_failures(self) -> List[int]:
        if not self.input_results:
            return []
        return [i for i, r in enumerate(self.input_results) if not r.ok]


def connect_block(
    block: Block,
    coins: CoinsView,
    height: int,
    flags: Optional[int] = None,
    verifier: Optional[TorchSecpVerifier] = None,
    check_pow: bool = True,
    check_scripts: bool = True,
    enforce_witness_commitment: Optional[bool] = None,
    pow_limit: int = POW_LIMIT_MAINNET,
    sig_cache: Optional[SigCache] = None,
    script_cache: Optional[ScriptExecutionCache] = None,
    engine: str = "native",
    device_merkle: Optional[bool] = None,
) -> ConnectResult:
    """Validate one block against the UTXO view and apply it.

    The consensus phases of `ConnectBlock` (validation.cpp:1946):

    1. context-free `CheckBlock`, and the witness commitment when the flags
       include WITNESS (IsWitnessEnabled);
    2. per tx: inputs present and mature, value conservation, the sigop
       cost against MAX_BLOCK_SIGOPS_COST (`validation.cpp:2155-2181`,
       `consensus/tx_verify.cpp:157-218` CheckTxInputs);
    3. every input's script, its signature checks batched on the device;
    4. the coinbase reward cap, then the view update (spend and add).

    The view changes only when every check passes. `flags` defaults to
    `height_to_flags(height, extended=True)`. `verifier=None` takes the
    process-wide verifier on cuda:0 (a fresh one on the Python engine);
    pass `TorchSecpVerifier(device="cpu")` to run the plain torch version.
    A `NativeCoinsView` on `engine="native"` runs `_connect_block_native`;
    a plain `CoinsView`, or `engine="python"`, runs `_connect_block_impl`.
    The native engine's core builds and loads or this raises
    `NativeCoreError`. The cyclic collector is paused for the call.
    `device_merkle` (default: BITCOINCONSENSUS_TPU_DEVICE_MERKLE) has the
    Python block layer's `check_block` build the txid merkle root on the
    verifier's device (`core/block.merkle_root_device`); the native block
    layer's CheckBlock hashes in C++ and does not read it, as the
    reference's native block layer does not.
    """
    native = native_bridge.use_native(engine)
    with _span("block.connect", height=height), gc_paused():
        if native and isinstance(coins, native_bridge.NativeCoinsView):
            res = _connect_block_native(
                block, coins, height, flags, verifier, check_pow,
                check_scripts, enforce_witness_commitment, pow_limit,
                sig_cache, script_cache,
            )
        else:
            res = _connect_block_impl(
                block, coins, height, flags, verifier, check_pow, check_scripts,
                enforce_witness_commitment, pow_limit, sig_cache, script_cache,
                engine, device_merkle,
            )
    _BLOCKS.inc(result="ok" if res.ok else "reject")
    if not res.ok and res.reason:
        _BLOCK_REJECTS.inc(reason=res.reason)
    return res


def _connect_block_native(
    block, coins, height, flags, verifier, check_pow, check_scripts,
    enforce_witness_commitment, pow_limit, sig_cache, script_cache,
) -> ConnectResult:
    """`connect_block` with the block layer in the native core (block.hpp)
    and the script phase on the index-mode fixpoint.

    CheckBlock, the witness commitment, the accounting (BIP30, maturity,
    values, sigop cost) and each tx's hash precompute take three C calls;
    the script phase interprets every input in one `verify_inputs_idx` call
    per round and resolves the deduplicated checks in one dispatch of the
    verify kernel per round; the view update is one C call. Each step is
    timed into the verifier's `phases` (`block_check`, `accounting`,
    `probe`, `interpret`, `apply`, and the seams' `host_prep`, `dispatch`
    and `sync`)."""
    if flags is None:
        flags = height_to_flags(height, extended=True)
    with _span("block.parse"):
        if isinstance(block, (bytes, bytearray)):
            nblk = native_bridge.NativeBlock(bytes(block))
        else:
            # The cached parse is keyed on the header and every txid and
            # wtxid, so a block changed between calls is parsed anew.
            fp = (block.header.serialize(), tuple(tx.txid for tx in block.vtx),
                  tuple(tx.wtxid for tx in block.vtx))
            cached = getattr(block, "_native", None)
            if cached is not None and cached[0] == fp:
                nblk = cached[1]
            else:
                nblk = native_bridge.NativeBlock(block.serialize())
                block._native = (fp, nblk)
    if check_scripts:
        verifier, sig_cache, script_cache = _defaults(
            verifier, sig_cache, script_cache, "native", "connect_block")
    phase = verifier.phases if verifier is not None else Phases(enabled=False)

    with phase("block_check"):
        reason = nblk.check(check_pow, pow_limit)
        if reason:
            return ConnectResult(False, reason)
        if enforce_witness_commitment is None:
            enforce_witness_commitment = bool(flags & VERIFY_WITNESS)
        if enforce_witness_commitment:
            reason = nblk.check_witness_commitment()
            if reason:
                return ConnectResult(False, reason)

    with phase("accounting"):
        (reason, fees, sigop_cost, tx_index, n_in, amounts, spk_offs,
         spk_blob) = nblk.accounting(coins, height, flags)
        if reason:
            return ConnectResult(False, reason)

    input_results: Optional[List[BatchResult]] = None
    if check_scripts:
        n = len(tx_index)
        with phase("probe"):
            with _span("block.script_keys"):
                raw_keys = nblk.script_keys(script_cache._salt, flags).tobytes()
            with _span("block.key_list"):
                keys = [raw_keys[32 * j : 32 * j + 32] for j in range(n)]
            with _span("block.script_probe"):
                if len(script_cache) == 0:  # a cold cache: every probe misses
                    hit = [False] * n
                else:
                    hit = script_cache.contains_keys(keys)

        with _span("block.session"):
            nsess = native_bridge.NativeSession()
            live = [j for j in range(n) if not hit[j]]
            n_threads = _idx_threads()
            flags_a = np.full(n, flags, dtype=np.int32)
        with _span("block.tx_handles"):
            # The block owns its txs, so these pointers live as long as nblk.
            ptr_by_tx = [nblk.tx(t)._ptr for t in range(nblk.n_tx)]

        def run_idx(pos):
            with phase("interpret"):
                if len(pos) == n:  # the whole block: the accounting's arrays
                    return nsess.verify_inputs_idx_raw(
                        [ptr_by_tx[t] for t in tx_index.tolist()], n_in, amounts,
                        spk_blob, spk_offs, flags_a, n_threads)
                sel = np.asarray(pos, dtype=np.int64)
                chunks = [spk_blob[spk_offs[j] : spk_offs[j + 1]] for j in pos]
                sub_offs = np.zeros(len(pos) + 1, dtype=np.int64)
                np.cumsum([len(c) for c in chunks], out=sub_offs[1:])
                sub_blob = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
                return nsess.verify_inputs_idx_raw(
                    [ptr_by_tx[int(tx_index[j])] for j in pos], n_in[sel],
                    amounts[sel], sub_blob, sub_offs, flags_a[sel], n_threads)

        def exact_fallback(j: int) -> Tuple[bool, int]:
            spk = spk_blob[spk_offs[j] : spk_offs[j + 1]].tobytes()
            ok, err_code, _ = nsess.verify_input(
                nblk.tx(int(tx_index[j])), int(n_in[j]), int(amounts[j]), spk,
                flags, mode=native_bridge.NativeSession.MODE_EXACT)
            return ok, err_code

        final = run_idx_fixpoint(nsess, verifier, sig_cache, live, run_idx,
                                 exact_fallback)

        input_results = []
        inserts: List[bytes] = []
        all_ok = True
        with _span("block.results"):
            for j in range(n):
                if hit[j]:
                    input_results.append(BatchResult.success())
                    continue
                ok_j, err_j = final[j]
                if ok_j:
                    inserts.append(keys[j])
                    input_results.append(BatchResult.success())
                else:
                    all_ok = False
                    input_results.append(
                        BatchResult(False, Error.ERR_SCRIPT, ScriptError(err_j)))
        with _span("block.script_cache_insert"):
            script_cache.add_keys(inserts)
        # The index session (its uniq list and oracle) and the per-input
        # records, freed in a span of their own.
        with _span("block.release"):
            del nsess, final, keys, hit
        if not all_ok:
            return ConnectResult(False, "block-validation-failed", fees,
                                 sigop_cost, input_results)

    with phase("apply"):
        coins.apply_block(nblk, height)
    return ConnectResult(True, None, fees, sigop_cost, input_results)


def _connect_block_impl(
    block, coins, height, flags, verifier, check_pow, check_scripts,
    enforce_witness_commitment, pow_limit, sig_cache, script_cache, engine,
    device_merkle=None,
) -> ConnectResult:
    if flags is None:
        flags = height_to_flags(height, extended=True)

    ok, reason = check_block(block, check_pow=check_pow, pow_limit=pow_limit,
                             device_merkle=device_merkle,
                             device=None if verifier is None else verifier.device)
    if not ok:
        return ConnectResult(False, reason)
    if enforce_witness_commitment is None:
        enforce_witness_commitment = bool(flags & VERIFY_WITNESS)
    if enforce_witness_commitment:
        ok, reason = check_witness_commitment(block)
        if not ok:
            return ConnectResult(False, reason)

    # Phase 2: inputs exist, maturity, values, sigop budget; gather the
    # spent outputs each tx needs (validation.cpp:1538-1549) without
    # mutating the view yet. Outputs created earlier in this same block are
    # spendable by later txs (the in-block overlay below).
    overlay: Dict[Tuple[bytes, int], Coin] = {}
    spent: set = set()
    per_tx_spent_outputs: List[List[TxOut]] = []
    fees = 0
    sigop_cost = 0

    # BIP30 guard (validation.cpp ConnectBlock's HaveCoin scan, run against
    # the start-of-block view before any spends): a tx whose outputs would
    # overwrite a still-unspent coin is rejected instead of silently
    # destroying it. In-block txid duplicates can't arise (identical txid
    # implies an identical tx, caught by the CVE-2012-2459 merkle check).
    for tx in block.vtx:
        for n in range(len(tx.vout)):
            if coins.get(OutPoint(tx.txid, n)) is not None:
                return ConnectResult(False, "bad-txns-BIP30")

    for tx in block.vtx:
        if tx.is_coinbase():
            per_tx_spent_outputs.append([])
            sigop_cost += get_transaction_sigop_cost(tx, [], flags)
            if sigop_cost > MAX_BLOCK_SIGOPS_COST:
                return ConnectResult(False, "bad-blk-sigops")
            overlay_tx_outputs(overlay, tx, height)
            continue
        spent_outputs: List[TxOut] = []
        value_in = 0
        for txin in tx.vin:
            key = (txin.prevout.hash, txin.prevout.n)
            if key in spent:
                return ConnectResult(False, "bad-txns-inputs-missingorspent")
            coin = overlay.get(key) or coins.get(txin.prevout)
            if coin is None:
                return ConnectResult(False, "bad-txns-inputs-missingorspent")
            if coin.coinbase and height - coin.height < COINBASE_MATURITY:
                return ConnectResult(False, "bad-txns-premature-spend-of-coinbase")
            if not (0 <= coin.out.value <= MAX_MONEY):
                return ConnectResult(False, "bad-txns-inputvalues-outofrange")
            value_in += coin.out.value
            # Accumulated value must stay in range too (CheckTxInputs,
            # consensus/tx_verify.cpp:157-218 MoneyRange(nValueIn)).
            if value_in > MAX_MONEY:
                return ConnectResult(False, "bad-txns-inputvalues-outofrange")
            spent_outputs.append(coin.out)
            spent.add(key)
        value_out = sum(o.value for o in tx.vout)
        if value_in < value_out:
            return ConnectResult(False, "bad-txns-in-belowout")
        fee = value_in - value_out
        fees += fee
        if not (0 <= fees <= MAX_MONEY):
            return ConnectResult(False, "bad-txns-fee-outofrange")
        sigop_cost += get_transaction_sigop_cost(tx, spent_outputs, flags)
        if sigop_cost > MAX_BLOCK_SIGOPS_COST:
            return ConnectResult(False, "bad-blk-sigops")
        per_tx_spent_outputs.append(spent_outputs)
        overlay_tx_outputs(overlay, tx, height)

    # Coinbase reward cap (validation.cpp:2222-2228).
    coinbase_out = sum(o.value for o in block.vtx[0].vout)
    if coinbase_out > fees + get_block_subsidy(height):
        return ConnectResult(False, "bad-cb-amount")

    # Phase 3: every input's script, one batched dispatch
    # (CheckInputScripts + CCheckQueue → verify_batch).
    input_results: Optional[List[BatchResult]] = None
    if check_scripts:
        items: List[BatchItem] = []
        for tx, spent_outputs in zip(block.vtx, per_tx_spent_outputs, strict=True):
            if tx.is_coinbase():
                continue
            raw = tx.serialize()
            outs = [(o.value, o.script_pubkey) for o in spent_outputs]
            for i in range(len(tx.vin)):
                items.append(
                    BatchItem(
                        spending_tx=raw,
                        input_index=i,
                        flags=flags,
                        spent_outputs=outs,
                    )
                )
        input_results = verify_batch(
            items,
            verifier=verifier,
            sig_cache=sig_cache,
            script_cache=script_cache,
            engine=engine,
        )
        if not all(r.ok for r in input_results):
            return ConnectResult(
                False, "block-validation-failed", fees, sigop_cost, input_results
            )

    # Phase 4: apply to the view (UpdateCoins, coins.cpp).
    for tx in block.vtx:
        for txin in tx.vin:
            if not tx.is_coinbase():
                coins.spend(txin.prevout)
        coins.add_tx(tx, height)
    return ConnectResult(True, None, fees, sigop_cost, input_results)


def overlay_tx_outputs(
    overlay: Dict[Tuple[bytes, int], Coin], tx: Tx, height: int
) -> None:
    """Record a tx's outputs in the in-block overlay so later txs of the
    same block can spend them (Core applies UpdateCoins per tx in order)."""
    cb = tx.is_coinbase()
    for n, out in enumerate(tx.vout):
        overlay[(tx.txid, n)] = Coin(out, height, cb)
