"""Hash primitives for the consensus engine (host side).

Covers the reference's hash layer (`depend/bitcoin/src/hash.{h,cpp}`,
`crypto/sha256.cpp`, `crypto/ripemd160.cpp`): double-SHA256, SHA256+RIPEMD160,
single SHA256 and the BIP340 tagged-hash construction
(`hash.cpp:89-96` TaggedHash, `hash.h:24` CHash256, `hash.h:49` CHash160).

Host hashing uses hashlib (OpenSSL-backed, C speed). A pure-Python RIPEMD-160
fallback is provided for environments whose OpenSSL build disables the legacy
provider. The batched on-device SHA-256 lives in
``bitcoinconsensus_tpu.ops.sha256`` — this module is the scalar host path.
"""

from __future__ import annotations

import hashlib
import struct

__all__ = [
    "murmur3_32",
    "sha256",
    "sha256d",
    "hash160",
    "ripemd160",
    "sha1",
    "tagged_hash",
    "tagged_hash_midstate_engine",
]


def murmur3_32(seed: int, data: bytes) -> int:
    """MurmurHash3 x86_32 (hash.cpp:16-78) — the last compiled-surface
    hash of the reference crate (Core's bloom filters); vectors from
    src/test/hash_tests.cpp asserted in tests/test_core_basics.py."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    M = 0xFFFFFFFF
    h1 = seed & M
    nblocks = len(data) // 4
    for i in range(nblocks):
        k1 = int.from_bytes(data[4 * i : 4 * i + 4], "little")
        k1 = k1 * c1 & M
        k1 = (k1 << 15 | k1 >> 17) & M
        k1 = k1 * c2 & M
        h1 ^= k1
        h1 = (h1 << 13 | h1 >> 19) & M
        h1 = (h1 * 5 + 0xE6546B64) & M
    tail = data[nblocks * 4 :]
    k1 = 0
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        k1 = k1 * c1 & M
        k1 = (k1 << 15 | k1 >> 17) & M
        k1 = k1 * c2 & M
        h1 ^= k1
    h1 ^= len(data)
    h1 ^= h1 >> 16
    h1 = h1 * 0x85EBCA6B & M
    h1 ^= h1 >> 13
    h1 = h1 * 0xC2B2AE35 & M
    h1 ^= h1 >> 16
    return h1


def sha256(data: bytes) -> bytes:
    """Single SHA-256."""
    return hashlib.sha256(data).digest()


def sha256d(data: bytes) -> bytes:
    """Double SHA-256 (Bitcoin's Hash(); reference hash.h:24 CHash256)."""
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def sha1(data: bytes) -> bytes:
    """SHA-1, needed by OP_SHA1 (reference crypto/sha1.cpp)."""
    return hashlib.sha1(data).digest()


# ---------------------------------------------------------------------------
# RIPEMD-160 — hashlib when available, pure-Python otherwise.
# ---------------------------------------------------------------------------

try:
    hashlib.new("ripemd160", b"")
    _HAVE_OPENSSL_RIPEMD = True
except (ValueError, TypeError):  # pragma: no cover - depends on OpenSSL build
    _HAVE_OPENSSL_RIPEMD = False


def _ripemd160_pure(data: bytes) -> bytes:
    """Pure-Python RIPEMD-160 (ISO/IEC 10118-3 spec implementation)."""
    # Message schedule permutations and rotation amounts from the RIPEMD-160
    # specification (Dobbertin, Bosselaers, Preneel 1996).
    rl = [
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
        3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
        1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
        4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
    ]
    rr = [
        5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
        6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
        15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
        8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
        12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
    ]
    sl = [
        11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
        7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
        11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
        11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
        9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
    ]
    sr = [
        8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
        9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
        9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
        15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
        8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
    ]
    kl = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
    kr = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]

    def rol(x: int, n: int) -> int:
        return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF

    def f(j: int, x: int, y: int, z: int) -> int:
        if j < 16:
            return x ^ y ^ z
        if j < 32:
            return (x & y) | (~x & z) & 0xFFFFFFFF
        if j < 48:
            return (x | ~y & 0xFFFFFFFF) ^ z
        if j < 64:
            return (x & z) | (y & ~z & 0xFFFFFFFF)
        return x ^ (y | ~z & 0xFFFFFFFF)

    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    msg = data + b"\x80"
    msg += b"\x00" * ((56 - len(msg) % 64) % 64)
    msg += struct.pack("<Q", len(data) * 8)

    for off in range(0, len(msg), 64):
        x = struct.unpack("<16I", msg[off : off + 64])
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            t = rol((al + f(j, bl, cl, dl) + x[rl[j]] + kl[j // 16]) & 0xFFFFFFFF, sl[j])
            t = (t + el) & 0xFFFFFFFF
            al, el, dl, cl, bl = el, dl, rol(cl, 10), bl, t
            t = rol((ar + f(79 - j, br, cr, dr) + x[rr[j]] + kr[j // 16]) & 0xFFFFFFFF, sr[j])
            t = (t + er) & 0xFFFFFFFF
            ar, er, dr, cr, br = er, dr, rol(cr, 10), br, t
        h = [
            (h[1] + cl + dr) & 0xFFFFFFFF,
            (h[2] + dl + er) & 0xFFFFFFFF,
            (h[3] + el + ar) & 0xFFFFFFFF,
            (h[4] + al + br) & 0xFFFFFFFF,
            (h[0] + bl + cr) & 0xFFFFFFFF,
        ]
    return struct.pack("<5I", *h)


def ripemd160(data: bytes) -> bytes:
    """RIPEMD-160, needed by OP_RIPEMD160 / OP_HASH160."""
    if _HAVE_OPENSSL_RIPEMD:
        return hashlib.new("ripemd160", data).digest()
    return _ripemd160_pure(data)


def hash160(data: bytes) -> bytes:
    """RIPEMD160(SHA256(x)) (reference hash.h:49 CHash160)."""
    return ripemd160(sha256(data))


# ---------------------------------------------------------------------------
# BIP340 tagged hashes (reference hash.cpp:89-96, hash.h:164-184).
# ---------------------------------------------------------------------------

_TAG_MIDSTATES: dict[str, "hashlib._Hash"] = {}


def tagged_hash_midstate_engine(tag: str) -> "hashlib._Hash":
    """A SHA256 engine pre-fed with SHA256(tag)||SHA256(tag).

    Mirrors the reference's hard-coded tag midstates
    (`secp256k1/src/modules/schnorrsig/main_impl.h:16-44`): computing the
    64-byte prefix once and reusing it via ``.copy()`` amortizes the tag
    blocks across every tagged hash with the same tag.
    """
    eng = _TAG_MIDSTATES.get(tag)
    if eng is None:
        taghash = hashlib.sha256(tag.encode()).digest()
        eng = hashlib.sha256(taghash + taghash)
        _TAG_MIDSTATES[tag] = eng
    return eng.copy()


def tagged_hash(tag: str, data: bytes) -> bytes:
    """SHA256(SHA256(tag) || SHA256(tag) || data) per BIP340."""
    eng = tagged_hash_midstate_engine(tag)
    eng.update(data)
    return eng.digest()
