"""BIP32 public-key derivation (`CPubKey::Derive` / `CExtPubKey`).

A copy of `bitcoinconsensus_tpu/crypto/bip32.py` over the port's own
`secp_host` and `utils/hashes`, so the port imports nothing of the JAX
package.

The reference compiles the BIP32 public-derivation surface in
`pubkey.cpp:253-299` (`CPubKey::Derive` via
`secp256k1_ec_pubkey_tweak_add`, `CExtPubKey::{Encode,Decode,Derive}`,
HMAC-SHA512 `BIP32Hash` from `hash.cpp:72-80`) — wallet-facing, not
consensus, and pure host work; implemented here over the executable-spec
curve (`crypto/secp_host.py`). Only NON-hardened derivation exists for
public keys (`pubkey.cpp:255` asserts `(nChild >> 31) == 0`).
"""

from __future__ import annotations

import hmac
import hashlib
from typing import Optional, Tuple

from . import secp_host as H
from ..utils.hashes import hash160

__all__ = ["bip32_hash", "pubkey_derive", "ExtPubKey", "BIP32_EXTKEY_SIZE"]

BIP32_EXTKEY_SIZE = 74  # pubkey.h BIP32_EXTKEY_SIZE


def bip32_hash(chaincode: bytes, n_child: int, header: int, data32: bytes) -> bytes:
    """HMAC-SHA512(cc, header || data32 || ser32(n_child)) — hash.cpp:72-80."""
    assert len(chaincode) == 32 and len(data32) == 32
    msg = bytes([header]) + data32 + n_child.to_bytes(4, "big")
    return hmac.new(chaincode, msg, hashlib.sha512).digest()


def pubkey_derive(
    pubkey33: bytes, chaincode: bytes, n_child: int
) -> Optional[Tuple[bytes, bytes]]:
    """(child pubkey33, child chaincode) or None — CPubKey::Derive
    (pubkey.cpp:253-273): I = BIP32Hash(cc, n, key[0], key[1:]);
    child = point(parse(key)) + IL*G, compressed; cc_child = IR.
    None when the parent key fails to parse or the tweaked point is
    invalid (IL >= n or infinity), like `secp256k1_ec_pubkey_tweak_add`.
    """
    if n_child >> 31:
        raise ValueError("hardened derivation requires the private key")
    if len(pubkey33) != 33 or pubkey33[0] not in (2, 3):
        return None
    out = bip32_hash(chaincode, n_child, pubkey33[0], pubkey33[1:33])
    il, cc_child = out[:32], out[32:]
    x = int.from_bytes(pubkey33[1:33], "big")
    if x >= H.P:
        return None
    pt = H.lift_x(x, odd=pubkey33[0] == 3)
    if pt is None:
        return None
    t = int.from_bytes(il, "big")
    if t >= H.N:  # tweak overflow: tweak_add fails
        return None
    child = H.PointJ.from_affine(*pt).add(H.G.mul(t)).to_affine()
    if child is None:  # infinity: tweak_add fails
        return None
    cx, cy = child
    return bytes([2 + (cy & 1)]) + cx.to_bytes(32, "big"), cc_child


class ExtPubKey:
    """CExtPubKey: (depth, parent fingerprint, child number, chaincode,
    compressed pubkey) with the 74-byte Encode/Decode wire layout
    (pubkey.cpp:275-299)."""

    __slots__ = ("depth", "fingerprint", "n_child", "chaincode", "pubkey")

    def __init__(
        self,
        depth: int = 0,
        fingerprint: bytes = b"\x00" * 4,
        n_child: int = 0,
        chaincode: bytes = b"\x00" * 32,
        pubkey: bytes = b"",
    ):
        self.depth = depth
        self.fingerprint = fingerprint
        self.n_child = n_child
        self.chaincode = chaincode
        self.pubkey = pubkey

    def encode(self) -> bytes:
        assert len(self.pubkey) == 33
        return (
            bytes([self.depth])
            + self.fingerprint
            + self.n_child.to_bytes(4, "big")
            + self.chaincode
            + self.pubkey
        )

    @classmethod
    def decode(cls, code: bytes) -> "ExtPubKey":
        assert len(code) == BIP32_EXTKEY_SIZE
        return cls(
            depth=code[0],
            fingerprint=code[1:5],
            n_child=int.from_bytes(code[5:9], "big"),
            chaincode=code[9:41],
            pubkey=code[41:74],
        )

    def derive(self, n_child: int) -> Optional["ExtPubKey"]:
        """CExtPubKey::Derive (pubkey.cpp:293-299); None on tweak failure."""
        got = pubkey_derive(self.pubkey, self.chaincode, n_child)
        if got is None:
            return None
        child_pub, child_cc = got
        return ExtPubKey(
            # unsigned-char nDepth semantics (CExtPubKey::Derive stores
            # nDepth+1 into an unsigned char, wrapping at 256)
            depth=(self.depth + 1) & 0xFF,
            fingerprint=hash160(self.pubkey)[:4],  # CKeyID prefix
            n_child=n_child,
            chaincode=child_cc,
            pubkey=child_pub,
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, ExtPubKey) and self.encode() == other.encode()

    def __hash__(self) -> int:
        return hash(self.encode())
