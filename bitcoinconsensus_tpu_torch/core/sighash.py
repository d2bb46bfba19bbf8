"""Signature-hash computation: legacy, BIP143 (segwit v0), BIP341 (taproot).

Host-side equivalent of the reference's sighash machinery
(`script/interpreter.cpp`): the legacy in-place serializer
(`interpreter.cpp:1273-1364` CTransactionSignatureSerializer), the BIP143
scheme (`interpreter.cpp:1581-1625`), the BIP341 tagged scheme
(`interpreter.cpp:1491-1574` SignatureHashSchnorr) and the transaction-wide
precomputed hashes (`interpreter.cpp:1422-1472`
PrecomputedTransactionData::Init).

Every consensus quirk is preserved: the SIGHASH_SINGLE out-of-range
uint256-ONE result (`interpreter.cpp:1627-1633`), OP_CODESEPARATOR removal
with the truncated-push tail behavior of SerializeScriptCode
(`interpreter.cpp:1291-1312`), value -1 placeholder outputs, and the
BIP341 readiness requirements (`interpreter.cpp:1512`).
"""

from __future__ import annotations

import struct
from typing import List, Optional

from .script import OP_CODESEPARATOR, OP_1, decode_op
from .serialize import ser_string, write_compact_size
from .tx import Tx, TxOut
from ..utils.hashes import sha256, sha256d, tagged_hash_midstate_engine

__all__ = [
    "SIGHASH_DEFAULT",
    "SIGHASH_ALL",
    "SIGHASH_NONE",
    "SIGHASH_SINGLE",
    "SIGHASH_ANYONECANPAY",
    "SigVersion",
    "PrecomputedTxData",
    "legacy_sighash",
    "bip143_sighash",
    "bip341_sighash",
]

SIGHASH_DEFAULT = 0
SIGHASH_ALL = 1
SIGHASH_NONE = 2
SIGHASH_SINGLE = 3
SIGHASH_ANYONECANPAY = 0x80
SIGHASH_OUTPUT_MASK = 3
SIGHASH_INPUT_MASK = 0x80

UINT256_ONE = b"\x01" + b"\x00" * 31


class SigVersion:
    """interpreter.h SigVersion enum."""

    BASE = 0
    WITNESS_V0 = 1
    TAPROOT = 2
    TAPSCRIPT = 3


class PrecomputedTxData:
    """Transaction-wide hash cache (interpreter.cpp:1422-1472).

    The single-SHA256 aggregates feed BIP341; their double-SHA256 forms feed
    BIP143. ``spent_outputs`` (one TxOut per input) unlocks the taproot
    sighash — exactly the data the reference's public C ABI cannot supply
    (SURVEY.md §3.2), and which our extended API always can.
    """

    __slots__ = (
        "tx",
        "spent_outputs",
        "spent_outputs_ready",
        "prevouts_single",
        "sequences_single",
        "outputs_single",
        "spent_amounts_single",
        "spent_scripts_single",
        "hash_prevouts",
        "hash_sequence",
        "hash_outputs",
        "bip143_ready",
        "bip341_ready",
    )

    def __init__(self, tx: Tx, spent_outputs: Optional[List[TxOut]] = None, force: bool = False):
        self.tx = tx
        self.spent_outputs = spent_outputs or []
        self.spent_outputs_ready = bool(self.spent_outputs)
        if self.spent_outputs_ready:
            assert len(self.spent_outputs) == len(tx.vin)

        uses_bip143 = force
        uses_bip341 = force
        for i, txin in enumerate(tx.vin):
            if uses_bip143 and uses_bip341:
                break
            if txin.witness:
                spk = self.spent_outputs[i].script_pubkey if self.spent_outputs_ready else b""
                if self.spent_outputs_ready and len(spk) == 34 and spk[0] == OP_1:
                    uses_bip341 = True
                else:
                    uses_bip143 = True

        self.prevouts_single = b""
        self.sequences_single = b""
        self.outputs_single = b""
        self.spent_amounts_single = b""
        self.spent_scripts_single = b""
        self.hash_prevouts = b"\x00" * 32
        self.hash_sequence = b"\x00" * 32
        self.hash_outputs = b"\x00" * 32
        self.bip143_ready = False
        self.bip341_ready = False

        if uses_bip143 or uses_bip341:
            self.prevouts_single = sha256(b"".join(i.prevout.serialize() for i in tx.vin))
            self.sequences_single = sha256(
                b"".join(struct.pack("<I", i.sequence) for i in tx.vin)
            )
            self.outputs_single = sha256(b"".join(o.serialize() for o in tx.vout))
        if uses_bip143:
            self.hash_prevouts = sha256(self.prevouts_single)
            self.hash_sequence = sha256(self.sequences_single)
            self.hash_outputs = sha256(self.outputs_single)
            self.bip143_ready = True
        if uses_bip341 and self.spent_outputs_ready:
            self.spent_amounts_single = sha256(
                b"".join(struct.pack("<q", o.value) for o in self.spent_outputs)
            )
            self.spent_scripts_single = sha256(
                b"".join(ser_string(o.script_pubkey) for o in self.spent_outputs)
            )
            self.bip341_ready = True


def _serialize_script_code(script_code: bytes) -> bytes:
    """SerializeScriptCode (interpreter.cpp:1291-1312): strip every
    OP_CODESEPARATOR byte, with the exact truncated-push tail behavior."""
    # First pass: count separators (only those reachable by the decoder).
    n_codeseps = 0
    pos = 0
    while pos < len(script_code):
        opcode, _, pos = decode_op(script_code, pos)
        if opcode is None:
            break
        if opcode == OP_CODESEPARATOR:
            n_codeseps += 1

    out = bytearray(write_compact_size(len(script_code) - n_codeseps))
    seg_start = 0
    pos = 0
    while pos < len(script_code):
        opcode, _, pos = decode_op(script_code, pos)
        if opcode is None:
            # Decoder failed on a truncated push. The reference's final write
            # is `s.write(&itBegin[0], it - itBegin)` (interpreter.cpp:1311)
            # with `it` left at the decode-failure point by GetScriptOp
            # (script.cpp advances pc past only the opcode/length bytes) —
            # the partial-push tail bytes are DROPPED and the declared
            # CompactSize exceeds the bytes written. Byte-identical here;
            # pinned by test_sighash_truncated_push_tail.
            out += script_code[seg_start:pos]
            return bytes(out)
        if opcode == OP_CODESEPARATOR:
            out += script_code[seg_start : pos - 1]
            seg_start = pos
    if seg_start != len(script_code):
        out += script_code[seg_start:]
    return bytes(out)


def legacy_sighash(script_code: bytes, tx: Tx, n_in: int, hash_type: int) -> bytes:
    """Legacy (pre-segwit) signature hash (interpreter.cpp:1577-1642).

    Returns the 32-byte double-SHA256 digest; implements the
    SIGHASH_SINGLE-out-of-range "one" quirk.
    """
    assert n_in < len(tx.vin)
    anyone_can_pay = bool(hash_type & SIGHASH_ANYONECANPAY)
    hash_single = (hash_type & 0x1F) == SIGHASH_SINGLE
    hash_none = (hash_type & 0x1F) == SIGHASH_NONE

    if hash_single and n_in >= len(tx.vout):
        return UINT256_ONE

    s = bytearray(struct.pack("<i", tx.version))

    # Inputs.
    if anyone_can_pay:
        in_indices = [n_in]
    else:
        in_indices = range(len(tx.vin))
    s += write_compact_size(len(in_indices))
    for i in in_indices:
        txin = tx.vin[i]
        s += txin.prevout.serialize()
        if i != n_in:
            s += write_compact_size(0)  # blanked scriptSig
        else:
            s += _serialize_script_code(script_code)
        if i != n_in and (hash_single or hash_none):
            s += struct.pack("<i", 0)
        else:
            s += struct.pack("<I", txin.sequence)

    # Outputs.
    if hash_none:
        n_outputs = 0
    elif hash_single:
        n_outputs = n_in + 1
    else:
        n_outputs = len(tx.vout)
    s += write_compact_size(n_outputs)
    for i in range(n_outputs):
        if hash_single and i != n_in:
            # Default CTxOut: value -1, empty script (interpreter.cpp:1341).
            s += struct.pack("<q", -1) + write_compact_size(0)
        else:
            s += tx.vout[i].serialize()

    s += struct.pack("<I", tx.locktime)
    s += struct.pack("<i", hash_type)
    return sha256d(bytes(s))


def bip143_sighash(
    script_code: bytes,
    tx: Tx,
    n_in: int,
    hash_type: int,
    amount: int,
    cache: Optional[PrecomputedTxData] = None,
) -> bytes:
    """BIP143 segwit-v0 signature hash (interpreter.cpp:1581-1625)."""
    zero32 = b"\x00" * 32
    cacheready = cache is not None and cache.bip143_ready

    if not (hash_type & SIGHASH_ANYONECANPAY):
        hash_prevouts = (
            cache.hash_prevouts
            if cacheready
            else sha256d(b"".join(i.prevout.serialize() for i in tx.vin))
        )
    else:
        hash_prevouts = zero32

    base_type = hash_type & 0x1F
    if not (hash_type & SIGHASH_ANYONECANPAY) and base_type not in (
        SIGHASH_SINGLE,
        SIGHASH_NONE,
    ):
        hash_sequence = (
            cache.hash_sequence
            if cacheready
            else sha256d(b"".join(struct.pack("<I", i.sequence) for i in tx.vin))
        )
    else:
        hash_sequence = zero32

    if base_type not in (SIGHASH_SINGLE, SIGHASH_NONE):
        hash_outputs = (
            cache.hash_outputs
            if cacheready
            else sha256d(b"".join(o.serialize() for o in tx.vout))
        )
    elif base_type == SIGHASH_SINGLE and n_in < len(tx.vout):
        hash_outputs = sha256d(tx.vout[n_in].serialize())
    else:
        hash_outputs = zero32

    s = bytearray(struct.pack("<i", tx.version))
    s += hash_prevouts
    s += hash_sequence
    s += tx.vin[n_in].prevout.serialize()
    s += ser_string(script_code)
    s += struct.pack("<q", amount)
    s += struct.pack("<I", tx.vin[n_in].sequence)
    s += hash_outputs
    s += struct.pack("<I", tx.locktime)
    s += struct.pack("<i", hash_type)
    return sha256d(bytes(s))


def bip341_sighash(
    tx: Tx,
    n_in: int,
    hash_type: int,
    sigversion: int,
    cache: PrecomputedTxData,
    annex_present: bool,
    annex_hash: bytes,
    tapleaf_hash: bytes = b"",
    codeseparator_pos: int = 0xFFFFFFFF,
) -> Optional[bytes]:
    """BIP341/342 taproot signature hash (interpreter.cpp:1491-1574
    SignatureHashSchnorr). Returns None on invalid hash_type or
    SIGHASH_SINGLE output out of range (the caller maps that to
    SCHNORR_SIG_HASHTYPE)."""
    if sigversion == SigVersion.TAPROOT:
        ext_flag = 0
    elif sigversion == SigVersion.TAPSCRIPT:
        ext_flag = 1
    else:
        raise AssertionError("bip341_sighash requires a taproot sigversion")
    assert n_in < len(tx.vin)
    assert cache.bip341_ready and cache.spent_outputs_ready

    eng = tagged_hash_midstate_engine("TapSighash")
    s = bytearray(b"\x00")  # epoch

    output_type = SIGHASH_ALL if hash_type == SIGHASH_DEFAULT else hash_type & SIGHASH_OUTPUT_MASK
    input_type = hash_type & SIGHASH_INPUT_MASK
    if not (hash_type <= 0x03 or 0x81 <= hash_type <= 0x83):
        return None
    s += bytes([hash_type])

    s += struct.pack("<i", tx.version)
    s += struct.pack("<I", tx.locktime)
    if input_type != SIGHASH_ANYONECANPAY:
        s += cache.prevouts_single
        s += cache.spent_amounts_single
        s += cache.spent_scripts_single
        s += cache.sequences_single
    if output_type == SIGHASH_ALL:
        s += cache.outputs_single

    spend_type = (ext_flag << 1) + (1 if annex_present else 0)
    s += bytes([spend_type])
    if input_type == SIGHASH_ANYONECANPAY:
        s += tx.vin[n_in].prevout.serialize()
        s += cache.spent_outputs[n_in].serialize()
        s += struct.pack("<I", tx.vin[n_in].sequence)
    else:
        s += struct.pack("<I", n_in)
    if annex_present:
        s += annex_hash

    if output_type == SIGHASH_SINGLE:
        if n_in >= len(tx.vout):
            return None
        s += sha256(tx.vout[n_in].serialize())

    if sigversion == SigVersion.TAPSCRIPT:
        s += tapleaf_hash
        s += b"\x00"  # key_version
        s += struct.pack("<I", codeseparator_pos)

    eng.update(bytes(s))
    return eng.digest()
