"""The port's compact-signature recovery and BIP32 public derivation
(`bitcoinconsensus_tpu_torch/crypto/recovery.py`, `crypto/bip32.py`) against
the JAX package's, mirroring `tests/test_recovery_bip32.py`:

- recover_compact round-trips sign_compact across parities and compression,
  port against reference byte for byte, and rejects every malformed-input
  class the reference rejects, alike;
- pubkey_derive / ExtPubKey: the BIP32 spec test vector 2 (master and the
  non-hardened m/0), the encode/decode round trip, the scalar identity
  child = (sk + IL) mod n, and equality with the reference's derivation.
"""

import hashlib

import pytest

from bitcoinconsensus_tpu.crypto import bip32 as ref_bip32
from bitcoinconsensus_tpu.crypto import recovery as ref_rec
from bitcoinconsensus_tpu_torch.crypto import secp_host as H
from bitcoinconsensus_tpu_torch.crypto.bip32 import (
    BIP32_EXTKEY_SIZE,
    ExtPubKey,
    bip32_hash,
    pubkey_derive,
)
from bitcoinconsensus_tpu_torch.crypto.recovery import recover_compact, sign_compact
from bitcoinconsensus_tpu_torch.utils.hashes import hash160


def _sk(seed: str) -> int:
    return int.from_bytes(hashlib.sha256(seed.encode()).digest(), "big") % H.N


def test_recover_roundtrip_port_against_reference():
    for i in range(8):
        sk = _sk(f"rec/{i}")
        msg = hashlib.sha256(b"m%d" % i).digest()
        for compressed in (True, False):
            sig = sign_compact(sk, msg, compressed=compressed)
            assert sig == ref_rec.sign_compact(sk, msg, compressed=compressed)
            got = recover_compact(msg, sig)
            assert got == H.pubkey_create(sk, compressed=compressed)
            assert got == ref_rec.recover_compact(msg, sig)


def test_recover_wrong_message_gives_the_reference_other_key():
    sk = _sk("rec/wrong")
    msg = hashlib.sha256(b"signed").digest()
    sig = sign_compact(sk, msg)
    other_msg = hashlib.sha256(b"different").digest()
    other = recover_compact(other_msg, sig)
    assert other is not None and other != H.pubkey_create(sk)
    assert other == ref_rec.recover_compact(other_msg, sig)


def _malformed():
    sk = _sk("rec/neg")
    msg = hashlib.sha256(b"neg").digest()
    sig = sign_compact(sk, msg)
    n_b = H.N.to_bytes(32, "big")
    zero = (0).to_bytes(32, "big")
    unc = sign_compact(sk, msg, compressed=False)
    return {
        "short sig": (msg, sig[:64]),
        "short msg": (msg[:31], sig),
        "r >= n": (msg, sig[:1] + n_b + sig[33:]),
        "s >= n": (msg, sig[:33] + n_b),
        "r == 0": (msg, sig[:1] + zero + sig[33:]),
        "s == 0": (msg, sig[:33] + zero),
        "recid&2 with r >= p - n": (msg, bytes([sig[0] + 2]) + sig[1:]),
        "header 26 (recid 3)": (msg, bytes([26]) + unc[1:]),
    }


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_recover_rejects_each_malformed_class_like_the_reference(case):
    msg, sig = _malformed()[case]
    assert recover_compact(msg, sig) is None
    assert ref_rec.recover_compact(msg, sig) is None


def test_recover_noncanonical_headers_masked_like_reference():
    sk = _sk("rec/mask")
    msg = hashlib.sha256(b"mask").digest()
    sig = sign_compact(sk, msg, compressed=False)
    aliased = recover_compact(msg, bytes([sig[0] + 8]) + sig[1:])
    assert aliased is not None and aliased == recover_compact(msg, sig)
    assert aliased == ref_rec.recover_compact(msg, bytes([sig[0] + 8]) + sig[1:])


# BIP32 spec test vector 2: master (m) and the non-hardened m/0, as 74-byte
# Encode() payloads (the base58check xpubs without version and checksum).
_V2_MASTER_PUB = bytes.fromhex(
    "00" "00000000" "00000000"
    "60499f801b896d83179a4374aeb7822aaeaceaa0db1f85ee3e904c4defbd9689"
    "03cbcaa9c98c877a26977d00825c956a238e8dddfbd322cce4f74b0b5bd6ace4a7"
)
_V2_M0_PUB = bytes.fromhex(
    "01" "bd16bee5" "00000000"
    "f0909affaa7ee7abe5dd4e100598d4dc53cd709d5a5c2cac40e7412f232f7c9c"
    "02fc9e5af0ac8d9b3cecfe2a888e2117ba3d089d8585886c9c826b6b22a98d12ea"
)


def test_bip32_vector2_m0():
    master = ExtPubKey.decode(_V2_MASTER_PUB)
    child = master.derive(0)
    assert child is not None and child.encode() == _V2_M0_PUB
    assert child.fingerprint == hash160(master.pubkey)[:4]
    assert ref_bip32.ExtPubKey.decode(_V2_MASTER_PUB).derive(0).encode() == _V2_M0_PUB


def test_encode_decode_roundtrip():
    master = ExtPubKey.decode(_V2_MASTER_PUB)
    assert len(master.encode()) == BIP32_EXTKEY_SIZE == ref_bip32.BIP32_EXTKEY_SIZE
    assert ExtPubKey.decode(master.encode()) == master
    assert len({master, ExtPubKey.decode(master.encode())}) == 1


def test_derive_matches_scalar_identity_and_the_reference():
    for i in range(4):
        sk = _sk(f"b32/{i}")
        pub = H.pubkey_create(sk)
        cc = hashlib.sha256(b"cc%d" % i).digest()
        got = pubkey_derive(pub, cc, i + 7)
        assert got is not None and got == ref_bip32.pubkey_derive(pub, cc, i + 7)
        child_pub, child_cc = got
        out = bip32_hash(cc, i + 7, pub[0], pub[1:])
        assert out == ref_bip32.bip32_hash(cc, i + 7, pub[0], pub[1:])
        assert child_cc == out[32:]
        assert child_pub == H.pubkey_create((sk + int.from_bytes(out[:32], "big")) % H.N)


def test_derive_rejects_like_the_reference():
    pub = H.pubkey_create(_sk("b32/h"))
    with pytest.raises(ValueError):
        pubkey_derive(pub, b"\x00" * 32, 1 << 31)
    for bad in (pub[:32], b"\x04" + pub[1:], b"\x02" + H.P.to_bytes(32, "big")):
        assert pubkey_derive(bad, b"\x00" * 32, 1) is None
        assert ref_bip32.pubkey_derive(bad, b"\x00" * 32, 1) is None
