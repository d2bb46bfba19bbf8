"""Host-side secp256k1: pure-Python reference implementation.

This is the framework's scalar fallback path and the executable spec for the
batched JAX/Pallas backend (`bitcoinconsensus_tpu.crypto.jax_backend`). It
reproduces the verify-relevant behavior of the reference's vendored
libsecp256k1 + `pubkey.cpp` glue:

- pubkey parsing incl. hybrid keys (`secp256k1/src/eckey_impl.h` parse rules)
- the consensus-critical lax-DER ECDSA signature parser
  (`pubkey.cpp:28-168` ecdsa_signature_parse_der_lax)
- ECDSA verify with S-normalization (`pubkey.cpp:191-207` CPubKey::Verify)
- BIP340 Schnorr verify (`modules/schnorrsig/main_impl.h:190-237`)
- x-only tweak-add check for Taproot commitments
  (`modules/extrakeys/main_impl.h:109-129`, `pubkey.cpp:176-189`)
- strict-DER / low-S / hashtype encoding predicates used by the interpreter
  (`interpreter.cpp:107-227`)

Group math uses Jacobian coordinates over Python ints — the same formulas the
JAX backend vectorizes over 13-bit limb vectors.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..utils.hashes import tagged_hash

__all__ = [
    "P",
    "N",
    "G",
    "PointJ",
    "lift_x",
    "parse_pubkey",
    "parse_der_lax",
    "verify_ecdsa",
    "verify_schnorr",
    "xonly_tweak_add_check",
    "is_valid_signature_encoding",
    "is_low_der_signature",
    "is_compressed_or_uncompressed_pubkey",
    "is_compressed_pubkey",
]

# Curve constants: y^2 = x^3 + 7 over F_p, group order n.
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_B = 7
G_X = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
G_Y = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


class PointJ:
    """Jacobian point (X, Y, Z); Z == 0 encodes infinity.

    Formulas follow the reference's `group_impl.h` (gej_double, gej_add_ge,
    gej_add_var) in their mathematical content; this Python form is the spec
    the limb-vectorized JAX backend is tested against.
    """

    __slots__ = ("X", "Y", "Z")

    def __init__(self, X: int, Y: int, Z: int):
        self.X, self.Y, self.Z = X, Y, Z

    @staticmethod
    def infinity() -> "PointJ":
        return PointJ(1, 1, 0)

    @staticmethod
    def from_affine(x: int, y: int) -> "PointJ":
        return PointJ(x, y, 1)

    def is_infinity(self) -> bool:
        return self.Z == 0

    def double(self) -> "PointJ":
        if self.Z == 0:
            return self
        X, Y, Z = self.X, self.Y, self.Z
        # dbl-2009-l (a=0): A=X^2, B=Y^2, C=B^2, D=2((X+B)^2-A-C), E=3A, F=E^2
        A = X * X % P
        Bv = Y * Y % P
        C = Bv * Bv % P
        D = 2 * ((X + Bv) * (X + Bv) - A - C) % P
        E = 3 * A % P
        F = E * E % P
        X3 = (F - 2 * D) % P
        Y3 = (E * (D - X3) - 8 * C) % P
        Z3 = 2 * Y * Z % P
        return PointJ(X3, Y3, Z3)

    def add(self, other: "PointJ") -> "PointJ":
        if self.Z == 0:
            return other
        if other.Z == 0:
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = other.X, other.Y, other.Z
        # add-2007-bl
        Z1Z1 = Z1 * Z1 % P
        Z2Z2 = Z2 * Z2 % P
        U1 = X1 * Z2Z2 % P
        U2 = X2 * Z1Z1 % P
        S1 = Y1 * Z2 * Z2Z2 % P
        S2 = Y2 * Z1 * Z1Z1 % P
        if U1 == U2:
            if S1 != S2:
                return PointJ.infinity()
            return self.double()
        H = (U2 - U1) % P
        I = 4 * H * H % P
        J = H * I % P
        r = 2 * (S2 - S1) % P
        V = U1 * I % P
        X3 = (r * r - J - 2 * V) % P
        Y3 = (r * (V - X3) - 2 * S1 * J) % P
        Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
        return PointJ(X3, Y3, Z3)

    def add_affine(self, x: int, y: int) -> "PointJ":
        return self.add(PointJ.from_affine(x, y))

    def neg(self) -> "PointJ":
        return PointJ(self.X, (-self.Y) % P, self.Z)

    def mul(self, k: int) -> "PointJ":
        """Scalar multiplication (plain double-and-add; host oracle only)."""
        k %= N
        acc = PointJ.infinity()
        addend = self
        while k:
            if k & 1:
                acc = acc.add(addend)
            addend = addend.double()
            k >>= 1
        return acc

    def to_affine(self) -> Optional[Tuple[int, int]]:
        if self.Z == 0:
            return None
        zinv = pow(self.Z, P - 2, P)
        zinv2 = zinv * zinv % P
        return self.X * zinv2 % P, self.Y * zinv2 * zinv % P


G = PointJ.from_affine(G_X, G_Y)


def _sqrt_mod_p(a: int) -> Optional[int]:
    """Square root mod p (p ≡ 3 mod 4 → a^((p+1)/4)); None if non-residue."""
    r = pow(a, (P + 1) // 4, P)
    if r * r % P != a % P:
        return None
    return r


def lift_x(x: int, odd: Optional[bool] = None) -> Optional[Tuple[int, int]]:
    """Lift an x coordinate to a curve point.

    odd=None → even y (BIP340 lift_x); otherwise choose requested parity.
    """
    if x >= P:
        return None
    y = _sqrt_mod_p((x * x % P * x + _B) % P)
    if y is None:
        return None
    want_odd = bool(odd)
    if (y & 1) != want_odd:
        y = P - y
    return x, y


def parse_pubkey(data: bytes) -> Optional[Tuple[int, int]]:
    """secp256k1_ec_pubkey_parse semantics (eckey_impl.h), incl. hybrid keys."""
    if len(data) == 33 and data[0] in (2, 3):
        x = int.from_bytes(data[1:], "big")
        return lift_x(x, odd=(data[0] == 3))
    if len(data) == 65 and data[0] in (4, 6, 7):
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
        if x >= P or y >= P:
            return None
        if (y * y - (x * x % P * x + _B)) % P != 0:
            return None
        # Hybrid: leading byte commits to y parity (eckey_impl.h parse).
        if data[0] == 6 and (y & 1):
            return None
        if data[0] == 7 and not (y & 1):
            return None
        return x, y
    return None


def parse_der_lax(sig: bytes) -> Optional[Tuple[int, int]]:
    """The consensus-critical lax-DER parser (pubkey.cpp:28-168).

    Returns (r, s) on structural success — with (0, 0) substituted when
    either integer overflows the group order, matching the reference's
    overflow → zeroed-signature behavior — or None on structural failure.
    """
    pos = 0
    inputlen = len(sig)

    def read_len() -> Optional[Tuple[int, int]]:
        """Parse a DER length at pos; returns (length, newpos) or None."""
        nonlocal pos
        if pos == inputlen:
            return None
        lenbyte = sig[pos]
        pos += 1
        if lenbyte & 0x80:
            lenbyte -= 0x80
            if lenbyte > inputlen - pos:
                return None
            # Skip leading zero length bytes.
            while lenbyte > 0 and sig[pos] == 0:
                pos += 1
                lenbyte -= 1
            if lenbyte >= 4:
                return None
            val = 0
            while lenbyte > 0:
                val = (val << 8) + sig[pos]
                pos += 1
                lenbyte -= 1
            return val, pos
        return lenbyte, pos

    # Sequence tag byte.
    if pos == inputlen or sig[pos] != 0x30:
        return None
    pos += 1
    # Sequence length bytes — value is *ignored* (lax), only skipped.
    if pos == inputlen:
        return None
    lenbyte = sig[pos]
    pos += 1
    if lenbyte & 0x80:
        lenbyte -= 0x80
        if lenbyte > inputlen - pos:
            return None
        pos += lenbyte

    def read_integer() -> Optional[Tuple[int, int]]:
        """Parse one INTEGER; returns (valpos, vallen) or None."""
        nonlocal pos
        if pos == inputlen or sig[pos] != 0x02:
            return None
        pos += 1
        r = read_len()
        if r is None:
            return None
        length, _ = r
        if length > inputlen - pos:
            return None
        valpos = pos
        pos += length
        return valpos, length

    ri = read_integer()
    if ri is None:
        return None
    si = read_integer()
    if si is None:
        return None

    def extract(valpos: int, vallen: int) -> Optional[int]:
        """Strip leading zeros; >32 significant bytes → overflow (None)."""
        while vallen > 0 and sig[valpos] == 0:
            valpos += 1
            vallen -= 1
        if vallen > 32:
            return None
        return int.from_bytes(sig[valpos : valpos + vallen], "big")

    r = extract(*ri)
    s = extract(*si)
    # Overflow of either value (or >= group order) zeroes the signature
    # rather than failing the parse (pubkey.cpp:150-160 + parse_compact).
    if r is None or s is None or r >= N or s >= N:
        return 0, 0
    return r, s


def verify_ecdsa(pubkey: bytes, sig_der: bytes, msg32: bytes) -> bool:
    """CPubKey::Verify (pubkey.cpp:191-207): parse → lax-DER → normalize-S →
    secp256k1_ecdsa_verify (ecdsa_impl.h:207-275)."""
    pt = parse_pubkey(pubkey)
    if pt is None:
        return False
    rs = parse_der_lax(sig_der)
    if rs is None:
        return False
    r, s = rs
    if s > N // 2:  # normalize high-S before verify (pubkey.cpp:204)
        s = N - s
    if r == 0 or s == 0 or r >= N or s >= N:
        return False
    m = int.from_bytes(msg32, "big") % N
    sinv = pow(s, N - 2, N)
    u1 = m * sinv % N
    u2 = r * sinv % N
    R = G.mul(u1).add(PointJ.from_affine(*pt).mul(u2))
    aff = R.to_affine()
    if aff is None:
        return False
    return aff[0] % N == r


def verify_schnorr(pubkey32: bytes, sig64: bytes, msg32: bytes) -> bool:
    """BIP340 verify (modules/schnorrsig/main_impl.h:190-237)."""
    if len(pubkey32) != 32 or len(sig64) != 64:
        return False
    px = int.from_bytes(pubkey32, "big")
    pt = lift_x(px)  # even-y lift; None for x >= p or non-residue
    if pt is None:
        return False
    r = int.from_bytes(sig64[:32], "big")
    s = int.from_bytes(sig64[32:], "big")
    if r >= P or s >= N:
        return False
    e = (
        int.from_bytes(
            tagged_hash("BIP0340/challenge", sig64[:32] + pubkey32 + msg32), "big"
        )
        % N
    )
    # R = s*G - e*P
    R = G.mul(s).add(PointJ.from_affine(*pt).mul(N - e))
    aff = R.to_affine()
    if aff is None:
        return False
    xR, yR = aff
    return (yR & 1) == 0 and xR == r


def xonly_tweak_add_check(
    tweaked_x32: bytes, parity: int, internal_x32: bytes, tweak32: bytes
) -> bool:
    """secp256k1_xonly_pubkey_tweak_add_check (extrakeys/main_impl.h:109-129):
    verify tweaked == internal + tweak·G with the stated y parity.

    This is the Taproot commitment equation used by
    XOnlyPubKey::CheckPayToContract (pubkey.cpp:184-189)."""
    base = lift_x(int.from_bytes(internal_x32, "big"))
    if base is None:
        return False
    t = int.from_bytes(tweak32, "big")
    if t >= N:
        return False
    Q = PointJ.from_affine(*base).add(G.mul(t))
    aff = Q.to_affine()
    if aff is None:
        return False
    qx, qy = aff
    return qx == int.from_bytes(tweaked_x32, "big") and (qy & 1) == parity


# ---------------------------------------------------------------------------
# Signature/pubkey *encoding* predicates used by the interpreter
# (interpreter.cpp:107-227). These are byte-level checks, no curve math.
# ---------------------------------------------------------------------------

def is_valid_signature_encoding(sig: bytes) -> bool:
    """Strict DER check (interpreter.cpp:107-170 IsValidSignatureEncoding).

    Format: 0x30 [total-length] 0x02 [R-length] [R] 0x02 [S-length] [S]
    [sighash], with minimal positive integers.
    """
    if len(sig) < 9 or len(sig) > 73:
        return False
    if sig[0] != 0x30:
        return False
    if sig[1] != len(sig) - 3:
        return False
    lenR = sig[3]
    if 5 + lenR >= len(sig):
        return False
    lenS = sig[5 + lenR]
    if lenR + lenS + 7 != len(sig):
        return False
    if sig[2] != 0x02:
        return False
    if lenR == 0:
        return False
    if sig[4] & 0x80:
        return False
    if lenR > 1 and sig[4] == 0x00 and not (sig[5] & 0x80):
        return False
    if sig[lenR + 4] != 0x02:
        return False
    if lenS == 0:
        return False
    if sig[lenR + 6] & 0x80:
        return False
    if lenS > 1 and sig[lenR + 6] == 0x00 and not (sig[lenR + 7] & 0x80):
        return False
    return True


def is_low_der_signature(sig: bytes) -> bool:
    """Low-S check on a strict-DER sig incl. hashtype byte
    (interpreter.cpp:172-182 + pubkey.cpp:301-308 CheckLowS)."""
    rs = parse_der_lax(sig[:-1])
    if rs is None:
        return False
    _, s = rs
    return s <= N // 2


def is_compressed_or_uncompressed_pubkey(pubkey: bytes) -> bool:
    """interpreter.cpp:58-82."""
    if len(pubkey) < 33:
        return False
    if pubkey[0] == 0x04:
        return len(pubkey) == 65
    if pubkey[0] in (0x02, 0x03):
        return len(pubkey) == 33
    return False


def is_compressed_pubkey(pubkey: bytes) -> bool:
    """interpreter.cpp:84-94."""
    return len(pubkey) == 33 and pubkey[0] in (0x02, 0x03)


# ---------------------------------------------------------------------------
# Test-support signing (NOT consensus; mirrors key.cpp's role: vector
# generation only).
# ---------------------------------------------------------------------------

def _der_encode_int(v: int) -> bytes:
    raw = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    if raw[0] & 0x80:
        raw = b"\x00" + raw
    return b"\x02" + bytes([len(raw)]) + raw


def sign_ecdsa(seckey: int, msg32: bytes, grind_low_r: bool = False) -> bytes:
    """Deterministic ECDSA sign → strict-DER (without hashtype byte)."""
    import hashlib as _h

    m = int.from_bytes(msg32, "big") % N
    counter = 0
    while True:
        k = (
            int.from_bytes(
                _h.sha256(
                    seckey.to_bytes(32, "big") + msg32 + counter.to_bytes(4, "big")
                ).digest(),
                "big",
            )
            % N
        )
        counter += 1
        if k == 0:
            continue
        Raff = G.mul(k).to_affine()
        assert Raff is not None
        r = Raff[0] % N
        if r == 0:
            continue
        if grind_low_r and r >> 255:
            continue
        s = pow(k, N - 2, N) * (m + r * seckey) % N
        if s == 0:
            continue
        if s > N // 2:
            s = N - s
        body = _der_encode_int(r) + _der_encode_int(s)
        return b"\x30" + bytes([len(body)]) + body


def sign_schnorr(seckey: int, msg32: bytes, aux: bytes = b"\x00" * 32) -> bytes:
    """BIP340 sign (test-support only)."""
    d0 = seckey % N
    assert d0 != 0
    Paff = G.mul(d0).to_affine()
    assert Paff is not None
    px, py = Paff
    d = d0 if (py & 1) == 0 else N - d0
    t = d ^ int.from_bytes(tagged_hash("BIP0340/aux", aux), "big")
    k0 = (
        int.from_bytes(
            tagged_hash("BIP0340/nonce", t.to_bytes(32, "big") + px.to_bytes(32, "big") + msg32),
            "big",
        )
        % N
    )
    assert k0 != 0
    Raff = G.mul(k0).to_affine()
    assert Raff is not None
    rx, ry = Raff
    k = k0 if (ry & 1) == 0 else N - k0
    e = (
        int.from_bytes(
            tagged_hash(
                "BIP0340/challenge", rx.to_bytes(32, "big") + px.to_bytes(32, "big") + msg32
            ),
            "big",
        )
        % N
    )
    s = (k + e * d) % N
    return rx.to_bytes(32, "big") + s.to_bytes(32, "big")


def pubkey_create(seckey: int, compressed: bool = True) -> bytes:
    """Derive the serialized pubkey for a secret key (test support)."""
    aff = G.mul(seckey).to_affine()
    assert aff is not None
    x, y = aff
    if compressed:
        return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def xonly_pubkey_create(seckey: int) -> Tuple[bytes, int]:
    """Derive (xonly pubkey, parity) for a secret key (test support)."""
    aff = G.mul(seckey).to_affine()
    assert aff is not None
    x, y = aff
    return x.to_bytes(32, "big"), y & 1
