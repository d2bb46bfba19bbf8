"""Transaction primitives and the segwit-aware wire codec.

Host-side equivalent of the reference's `primitives/transaction.{h,cpp}`:
`COutPoint`/`CTxIn`/`CTxOut`/`CTransaction` with the exact BIP144
serialization rules of `UnserializeTransaction`/`SerializeTransaction`
(`transaction.h:187-253`), including the dummy-vin witness marker, the
"Superfluous witness record" and "Unknown transaction optional data"
errors (`transaction.h:216,220`), and cached txid/wtxid
(`transaction.h:259-350`).

Internally all hashes are kept in wire byte order (little-endian display).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional

from .serialize import ByteReader, SerializationError, ser_string, write_compact_size
from ..utils.hashes import sha256d

__all__ = ["OutPoint", "TxIn", "TxOut", "Tx", "SerializationError"]

# transaction.h:28-31 — COutPoint null marker
NULL_OUTPOINT_INDEX = 0xFFFFFFFF

# transaction.h:75-98 — CTxIn sequence flag constants (BIP68)
SEQUENCE_FINAL = 0xFFFFFFFF
SEQUENCE_LOCKTIME_DISABLE_FLAG = 1 << 31
SEQUENCE_LOCKTIME_TYPE_FLAG = 1 << 22
SEQUENCE_LOCKTIME_MASK = 0x0000FFFF

# amount.h:12-27
COIN = 100_000_000
MAX_MONEY = 21_000_000 * COIN


@dataclass(frozen=True)
class OutPoint:
    """(txid, vout-index) reference to a spent output (transaction.h:26)."""

    hash: bytes  # 32 bytes, wire order
    n: int

    def serialize(self) -> bytes:
        return self.hash + struct.pack("<I", self.n)

    @classmethod
    def deserialize(cls, r: ByteReader) -> "OutPoint":
        h = r.read(32)
        return cls(h, r.read_u32())

    def is_null(self) -> bool:
        return self.n == NULL_OUTPOINT_INDEX and self.hash == b"\x00" * 32


@dataclass
class TxIn:
    """Transaction input (transaction.h:61-130)."""

    prevout: OutPoint
    script_sig: bytes = b""
    sequence: int = SEQUENCE_FINAL
    witness: List[bytes] = field(default_factory=list)

    def serialize(self) -> bytes:
        return (
            self.prevout.serialize()
            + ser_string(self.script_sig)
            + struct.pack("<I", self.sequence)
        )

    @classmethod
    def deserialize(cls, r: ByteReader) -> "TxIn":
        prevout = OutPoint.deserialize(r)
        script_sig = r.read_string()
        sequence = r.read_u32()
        return cls(prevout, script_sig, sequence)


@dataclass
class TxOut:
    """Transaction output (transaction.h:133-184)."""

    value: int  # satoshis, int64
    script_pubkey: bytes = b""

    def serialize(self) -> bytes:
        return struct.pack("<q", self.value) + ser_string(self.script_pubkey)

    @classmethod
    def deserialize(cls, r: ByteReader) -> "TxOut":
        value = r.read_i64()
        spk = r.read_string()
        return cls(value, spk)


def _read_witness_stack(r: ByteReader) -> List[bytes]:
    n = r.read_compact_size()
    return [r.read_string() for _ in range(n)]


def _ser_witness_stack(stack: List[bytes]) -> bytes:
    out = write_compact_size(len(stack))
    for item in stack:
        out += ser_string(item)
    return out


class Tx:
    """Immutable transaction with cached txid/wtxid (transaction.h:259-350)."""

    __slots__ = (
        "version", "vin", "vout", "locktime", "_txid", "_wtxid", "_ser",
    )

    def __init__(self, version: int, vin: List[TxIn], vout: List[TxOut], locktime: int):
        self.version = version  # signed int32 semantics
        self.vin = vin
        self.vout = vout
        self.locktime = locktime
        self._txid: Optional[bytes] = None
        self._wtxid: Optional[bytes] = None
        self._ser: dict = {}  # include_witness -> cached wire bytes

    # -- codec --------------------------------------------------------------
    @classmethod
    def deserialize(cls, data: bytes, allow_witness: bool = True) -> "Tx":
        r = ByteReader(data)
        tx = cls._deserialize_from(r, allow_witness)
        return tx

    @classmethod
    def _deserialize_from(cls, r: ByteReader, allow_witness: bool = True) -> "Tx":
        """Exact mirror of UnserializeTransaction (transaction.h:187-224)."""
        version = r.read_i32()
        flags = 0
        n_vin = r.read_compact_size()
        vin = [TxIn.deserialize(r) for _ in range(n_vin)]
        if not vin and allow_witness:
            # BIP144 marker: empty vin is the witness-format dummy.
            flags = r.read_u8()
            if flags != 0:
                n_vin = r.read_compact_size()
                vin = [TxIn.deserialize(r) for _ in range(n_vin)]
                n_vout = r.read_compact_size()
                vout = [TxOut.deserialize(r) for _ in range(n_vout)]
            else:
                vout = []
        else:
            n_vout = r.read_compact_size()
            vout = [TxOut.deserialize(r) for _ in range(n_vout)]
        if flags & 1 and allow_witness:
            flags ^= 1
            for txin in vin:
                txin.witness = _read_witness_stack(r)
            if not any(txin.witness for txin in vin):
                # transaction.h:216
                raise SerializationError("Superfluous witness record")
        if flags:
            # transaction.h:220
            raise SerializationError("Unknown transaction optional data")
        locktime = r.read_u32()
        return cls(version, vin, vout, locktime)

    def has_witness(self) -> bool:
        return any(txin.witness for txin in self.vin)

    def serialize(self, include_witness: bool = True) -> bytes:
        """Exact mirror of SerializeTransaction (transaction.h:227-253).
        Memoized like txid/wtxid (the class is immutable by contract; a
        block replay serializes every tx for weight, ids AND batch items)."""
        use_witness = include_witness and self.has_witness()
        cached = self._ser.get(use_witness)
        if cached is not None:
            return cached
        parts = [struct.pack("<i", self.version)]
        if use_witness:
            parts.append(write_compact_size(0) + b"\x01")
        parts.append(write_compact_size(len(self.vin)))
        for txin in self.vin:
            parts.append(txin.serialize())
        parts.append(write_compact_size(len(self.vout)))
        for txout in self.vout:
            parts.append(txout.serialize())
        if use_witness:
            for txin in self.vin:
                parts.append(_ser_witness_stack(txin.witness))
        parts.append(struct.pack("<I", self.locktime))
        out = b"".join(parts)
        self._ser[use_witness] = out
        return out

    def invalidate_caches(self) -> None:
        """Drop the memoized ids AND serializations. The class is
        immutable by contract, but fixture builders (utils/blockgen.py)
        construct-then-sign; any such mutation must call this — resetting
        _txid/_wtxid alone leaves `serialize()` returning stale bytes."""
        self._txid = None
        self._wtxid = None
        self._ser.clear()

    # -- identity -----------------------------------------------------------
    @property
    def txid(self) -> bytes:
        """Double-SHA256 of the witness-stripped serialization (wire order)."""
        if self._txid is None:
            self._txid = sha256d(self.serialize(include_witness=False))
        return self._txid

    @property
    def wtxid(self) -> bytes:
        if self._wtxid is None:
            self._wtxid = sha256d(self.serialize(include_witness=True))
        return self._wtxid

    @property
    def txid_hex(self) -> str:
        """Display (big-endian) hex txid."""
        return self.txid[::-1].hex()

    def is_coinbase(self) -> bool:
        return len(self.vin) == 1 and self.vin[0].prevout.is_null()
