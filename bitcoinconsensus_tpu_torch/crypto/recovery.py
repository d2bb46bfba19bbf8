"""Compact-signature public-key recovery (`CPubKey::RecoverCompact`).

A copy of `bitcoinconsensus_tpu/crypto/recovery.py` over the port's own
`secp_host`, so the port imports nothing of the JAX package.

The reference crate compiles libsecp256k1's recovery module
(its `build.rs:47`) solely for
`CPubKey::RecoverCompact` (`pubkey.cpp:209-232`), which backs message
signing — not consensus. It is a cold host path (never reached from
`verify()`), so it is implemented host-side over the same
Jacobian point algebra as the executable-spec verifier
(`crypto/secp_host.py`); the math mirrors
`secp256k1_ecdsa_sig_recover` (`modules/recovery/main_impl.h:87-121`):

    R = lift_x(r + (recid&2 ? n : 0), odd=recid&1)
    Q = r^-1 * (s*R - m*G)

Signature wire format (65 bytes): `[header || r32 || s32]` with
`header = 27 + recid + (compressed ? 4 : 0)` — `pubkey.cpp:211-213`.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from . import secp_host as H

__all__ = ["recover_compact", "sign_compact"]

COMPACT_SIGNATURE_SIZE = 65  # pubkey.h COMPACT_SIGNATURE_SIZE


def recover_compact(msg32: bytes, sig65: bytes) -> Optional[bytes]:
    """Recover the serialized pubkey from a compact signature, or None.

    Returns the 33-byte compressed or 65-byte uncompressed key according
    to the header's compression bit, exactly like `RecoverCompact`
    populating a CPubKey. Parse rules follow
    `recoverable_signature_parse_compact` (overflowing r or s rejected)
    and `sig_recover` (zero r or s rejected; recid&2 requires r+n < p).
    """
    if len(msg32) != 32 or len(sig65) != COMPACT_SIGNATURE_SIZE:
        return None
    header = sig65[0]
    # RecoverCompact masks ANY header byte (pubkey.cpp:211-213): recid and
    # the compression bit are taken mod 8 with C int wraparound, which
    # Python's & on a negative int reproduces exactly (e.g. header 26 ->
    # recid 3 compressed; header 35 -> recid 0 uncompressed).
    recid = (header - 27) & 3
    compressed = ((header - 27) & 4) != 0
    r = int.from_bytes(sig65[1:33], "big")
    s = int.from_bytes(sig65[33:65], "big")
    if r >= H.N or s >= H.N:  # parse_compact: overflow rejected
        return None
    if r == 0 or s == 0:  # sig_recover: zero scalars rejected
        return None
    fx = r
    if recid & 2:
        # main_impl.h:104-109: x = r + n must still be a field element
        if r >= H.P - H.N:
            return None
        fx = r + H.N
    pt = H.lift_x(fx, odd=bool(recid & 1))
    if pt is None:
        return None
    rinv = pow(r, H.N - 2, H.N)
    m = int.from_bytes(msg32, "big") % H.N
    u1 = (-(rinv * m)) % H.N
    u2 = (rinv * s) % H.N
    # Q = u2*R + u1*G (ecmult in main_impl.h:118)
    Q = H.PointJ.from_affine(*pt).mul(u2).add(H.G.mul(u1))
    aff = Q.to_affine()
    if aff is None:  # infinity
        return None
    x, y = aff
    if compressed:
        return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def sign_compact(seckey: int, msg32: bytes, compressed: bool = True) -> bytes:
    """Produce a recoverable compact signature (test support — the
    reference's signing side lives in the uncompiled key.cpp)."""
    assert 0 < seckey < H.N and len(msg32) == 32
    m = int.from_bytes(msg32, "big") % H.N
    counter = 0
    while True:
        k = (
            int.from_bytes(
                hashlib.sha256(
                    b"compact" + seckey.to_bytes(32, "big") + msg32
                    + counter.to_bytes(4, "big")
                ).digest(),
                "big",
            )
            % H.N
        )
        counter += 1
        if k == 0:
            continue
        Raff = H.G.mul(k).to_affine()
        assert Raff is not None
        rx, ry = Raff
        r = rx % H.N
        if r == 0:
            continue
        s = pow(k, H.N - 2, H.N) * (m + r * seckey) % H.N
        if s == 0:
            continue
        recid = (2 if rx >= H.N else 0) | (ry & 1)
        if s > H.N // 2:
            s = H.N - s
            recid ^= 1  # negating s flips the recovered point's y parity
        header = 27 + recid + (4 if compressed else 0)
        return (
            bytes([header]) + r.to_bytes(32, "big") + s.to_bytes(32, "big")
        )
