"""Bitcoin wire-format (de)serialization.

Host-side equivalent of the reference's header-only serialization framework
(`depend/bitcoin/src/serialize.h`): little-endian fixed-width integers,
CompactSize varints, and length-prefixed byte vectors, with the same
strictness guarantees (reads past the end raise, non-canonical CompactSize
encodings raise — `serialize.h` ReadCompactSize range checks).
"""

from __future__ import annotations

import struct

__all__ = ["SerializationError", "ByteReader", "write_compact_size", "ser_string"]

MAX_SIZE = 0x02000000  # serialize.h:31 MAX_SIZE — CompactSize sanity bound


class SerializationError(Exception):
    """Raised on malformed wire data (maps to ERR_TX_DESERIALIZE)."""


class ByteReader:
    """Sequential reader over immutable bytes, mirroring TxInputStream
    (`script/bitcoinconsensus.cpp:16-56`): single pass, hard EOF errors."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise SerializationError("read past end of data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def at_end(self) -> bool:
        return self.pos == len(self.data)

    # -- fixed-width little-endian integers ---------------------------------
    def read_u8(self) -> int:
        return self.read(1)[0]

    def read_u16(self) -> int:
        return struct.unpack("<H", self.read(2))[0]

    def read_u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def read_i32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]

    def read_u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def read_i64(self) -> int:
        return struct.unpack("<q", self.read(8))[0]

    # -- CompactSize --------------------------------------------------------
    def read_compact_size(self, range_check: bool = True) -> int:
        """CompactSize decode with canonicality enforcement
        (serialize.h ReadCompactSize: 'non-canonical ReadCompactSize()')."""
        first = self.read_u8()
        if first < 253:
            size = first
        elif first == 253:
            size = self.read_u16()
            if size < 253:
                raise SerializationError("non-canonical CompactSize")
        elif first == 254:
            size = self.read_u32()
            if size < 0x10000:
                raise SerializationError("non-canonical CompactSize")
        else:
            size = self.read_u64()
            if size < 0x100000000:
                raise SerializationError("non-canonical CompactSize")
        if range_check and size > MAX_SIZE:
            raise SerializationError("CompactSize exceeds MAX_SIZE")
        return size

    def read_string(self) -> bytes:
        """Length-prefixed byte vector (CompactSize + payload)."""
        return self.read(self.read_compact_size())


def write_compact_size(n: int) -> bytes:
    if n < 0:
        raise SerializationError("negative CompactSize")
    if n < 253:
        return bytes([n])
    if n <= 0xFFFF:
        return b"\xfd" + struct.pack("<H", n)
    if n <= 0xFFFFFFFF:
        return b"\xfe" + struct.pack("<I", n)
    return b"\xff" + struct.pack("<Q", n)


def ser_string(s: bytes) -> bytes:
    return write_compact_size(len(s)) + s
