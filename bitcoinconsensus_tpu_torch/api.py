"""Per-input API: the exact host path, one input at a time.

Port of `bitcoinconsensus_tpu/api.py`: ``verify``, ``verify_with_flags``,
``verify_with_spent_outputs``, ``version``, ``height_to_flags``, the
transport-level error enum, the
libconsensus flag subset restriction and the check order of the reference C
ABI shim (`script/bitcoinconsensus.cpp:74-129`: flags → deserialize → index
→ size). Each input runs on the native host core in exact mode
(`native_bridge`, every signature checked on the host); `engine="python"`
runs the Python engine, `core/` with the `crypto/secp_host.py` oracle, the
spec both are held to. The batched device path is
`models/batch.verify_batch`, held bit-identical to this module.

Telemetry, as in the reference: every entry point counts its calls in
`consensus_verify_calls_total{entry}` and runs inside the span
`api.<entry>`; a rejection counts in `consensus_verify_reject_total{code}`
and, for a script failure, `consensus_script_reject_total{script_error}`
(`_record_reject`; the batch drivers count their rejections in the same
two counters).
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence, Tuple

from . import native_bridge
from .core.flags import (
    ALL_FLAG_BITS,
    LIBCONSENSUS_FLAGS,
    VERIFY_ALL_EXTENDED,
    VERIFY_ALL_LIBCONSENSUS,
    VERIFY_TAPROOT,
    height_to_flags,
)
from .core.interpreter import TransactionSignatureChecker, verify_script
from .core.script_error import ScriptError
from .core.serialize import SerializationError
from .core.sighash import PrecomputedTxData
from .core.tx import Tx, TxOut
from .obs import counter as _obs_counter
from .obs import span as _span

__all__ = [
    "Error",
    "ConsensusError",
    "verify",
    "verify_with_flags",
    "verify_with_spent_outputs",
    "version",
    "height_to_flags",
    "VERIFY_ALL_LIBCONSENSUS",
    "VERIFY_ALL_EXTENDED",
]

API_VERSION = 1  # bitcoinconsensus.h:36 BITCOINCONSENSUS_API_VER

_VERIFY_CALLS = _obs_counter(
    "consensus_verify_calls_total", "verify* entry-point calls", ("entry",)
)
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


def _record_reject(exc: "ConsensusError") -> None:
    _VERIFY_REJECTS.inc(code=exc.code.name)
    if exc.script_error is not None and exc.script_error != ScriptError.OK:
        _SCRIPT_REJECTS.inc(script_error=exc.script_error.name)


class Error(enum.IntEnum):
    """Transport-level errors (bitcoinconsensus.h:38-46 + lib.rs:172-185)."""

    ERR_OK = 0
    ERR_TX_INDEX = 1
    ERR_TX_SIZE_MISMATCH = 2
    ERR_TX_DESERIALIZE = 3
    ERR_AMOUNT_REQUIRED = 4
    ERR_INVALID_FLAGS = 5
    # Script-level failure (the Rust crate's ERR_SCRIPT, lib.rs:121).
    ERR_SCRIPT = 6
    # Serving-layer extension (bitcoinconsensus_tpu_torch.serving): admission
    # control shed the request before any consensus evaluation ran. A
    # fail-closed reject — the caller may retry with backoff; the request
    # was never partially evaluated. Not part of the reference ABI.
    ERR_OVERLOADED = 7


class ConsensusError(Exception):
    """Raised by verify* on failure; carries the transport error and the
    ScriptError (which the reference swallows)."""

    def __init__(self, code: Error, script_error: Optional[ScriptError] = None):
        self.code = code
        self.script_error = script_error
        detail = f", script_error={script_error.name}" if script_error is not None else ""
        super().__init__(f"{code.name}{detail}")


def version() -> int:
    """bitcoinconsensus_version (bitcoinconsensus.cpp:125-129)."""
    return API_VERSION


def _verify_input(
    spent_output_script: bytes,
    amount: int,
    spending_transaction: bytes,
    input_index: int,
    flags: int,
    allowed_flags: int,
    spent_outputs: Optional[Sequence[TxOut]] = None,
    engine: str = "native",
) -> None:
    """Shared body of the verify entry points; mirrors
    bitcoinconsensus.cpp:79-101 verify_script check order on either
    engine."""
    native = native_bridge.use_native(engine)
    if flags & ~allowed_flags:
        raise ConsensusError(Error.ERR_INVALID_FLAGS)

    if native:
        try:
            ntx = native_bridge.NativeTx(spending_transaction)
        except ValueError:
            raise ConsensusError(Error.ERR_TX_DESERIALIZE) from None
        # nIn is unsigned in the reference ABI: negative is out of range.
        if input_index < 0 or input_index >= ntx.n_inputs:
            raise ConsensusError(Error.ERR_TX_INDEX)
        if ntx.ser_size != len(spending_transaction):
            raise ConsensusError(Error.ERR_TX_SIZE_MISMATCH)
        if spent_outputs is not None:
            if len(spent_outputs) != ntx.n_inputs:
                raise ConsensusError(Error.ERR_TX_INDEX)
            ntx.set_spent_outputs([(o.value, o.script_pubkey) for o in spent_outputs])
        else:
            if flags & VERIFY_TAPROOT:
                raise ConsensusError(Error.ERR_AMOUNT_REQUIRED)
            ntx.precompute()
        ok, err_code, _ = native_bridge.NativeSession().verify_input(
            ntx, input_index, amount, spent_output_script, flags,
            mode=native_bridge.NativeSession.MODE_EXACT,
        )
        if not ok:
            raise ConsensusError(Error.ERR_SCRIPT, ScriptError(err_code))
        return

    try:
        tx = Tx.deserialize(spending_transaction)
        # nIn is unsigned in the reference ABI: negative is out of range.
        if input_index < 0 or input_index >= len(tx.vin):
            raise ConsensusError(Error.ERR_TX_INDEX)
        if len(tx.serialize()) != len(spending_transaction):
            raise ConsensusError(Error.ERR_TX_SIZE_MISMATCH)
    except SerializationError:
        raise ConsensusError(Error.ERR_TX_DESERIALIZE) from None

    if spent_outputs is not None:
        if len(spent_outputs) != len(tx.vin):
            raise ConsensusError(Error.ERR_TX_INDEX)
        txdata = PrecomputedTxData(tx, list(spent_outputs))
    else:
        if flags & VERIFY_TAPROOT:
            # BIP341 sighash needs all spent outputs (interpreter.cpp:1512).
            raise ConsensusError(Error.ERR_AMOUNT_REQUIRED)
        txdata = PrecomputedTxData(tx)

    checker = TransactionSignatureChecker(tx, input_index, amount, txdata)
    ok, script_err = verify_script(
        tx.vin[input_index].script_sig,
        spent_output_script,
        tx.vin[input_index].witness,
        flags,
        checker,
    )
    if not ok:
        raise ConsensusError(Error.ERR_SCRIPT, script_err)


def _verify_entry(entry: str, *args, **kwargs) -> None:
    """`_verify_input` counted and spanned as entry point `entry`."""
    _VERIFY_CALLS.inc(entry=entry)
    with _span(f"api.{entry}"):
        try:
            _verify_input(*args, **kwargs)
        except ConsensusError as e:
            _record_reject(e)
            raise


def verify(
    spent_output: bytes,
    amount: int,
    spending_transaction: bytes,
    input_index: int,
    *,
    engine: str = "native",
) -> None:
    """verify() (src/lib.rs:103-111): VERIFY_ALL under libconsensus flags.
    Raises ConsensusError on failure; returns None on success."""
    _verify_entry("verify", spent_output, amount, spending_transaction,
                  input_index, VERIFY_ALL_LIBCONSENSUS,
                  allowed_flags=LIBCONSENSUS_FLAGS, engine=engine)


def verify_with_flags(
    spent_output_script: bytes,
    amount: int,
    spending_transaction: bytes,
    input_index: int,
    flags: int,
    *,
    engine: str = "native",
) -> None:
    """verify_with_flags (src/lib.rs:113-139): only libconsensus flag bits
    are accepted, as in the reference C ABI."""
    _verify_entry("verify_with_flags", spent_output_script, amount,
                  spending_transaction, input_index, flags,
                  allowed_flags=LIBCONSENSUS_FLAGS, engine=engine)


def verify_with_spent_outputs(
    spending_transaction: bytes,
    input_index: int,
    spent_outputs: Sequence[Tuple[int, bytes]],
    flags: int = VERIFY_ALL_EXTENDED,
    *,
    engine: str = "native",
) -> None:
    """All spent outputs supplied, so taproot is reachable. `spent_outputs`
    is a sequence of (amount, scriptPubKey), one per input."""
    outs = [TxOut(amt, spk) for amt, spk in spent_outputs]
    if input_index < 0 or input_index >= len(outs):
        _VERIFY_CALLS.inc(entry="verify_with_spent_outputs")
        exc = ConsensusError(Error.ERR_TX_INDEX)
        _record_reject(exc)
        raise exc
    _verify_entry(
        "verify_with_spent_outputs",
        outs[input_index].script_pubkey,
        outs[input_index].value,
        spending_transaction,
        input_index,
        flags,
        allowed_flags=ALL_FLAG_BITS,
        spent_outputs=outs,
        engine=engine,
    )
