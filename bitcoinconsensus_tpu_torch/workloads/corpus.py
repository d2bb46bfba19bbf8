"""Adversarial corpus: constructed worst-case inputs with pinned verdicts.

A copy of `bitcoinconsensus_tpu/workloads/corpus.py` on the port's `core/`,
`crypto/secp_host.py`, `crypto/glv.LAMBDA` and `utils/hashes.py`: the same
26 cases, byte for byte, with the same pins. Each entry is one `BatchItem`
plus the exact expected outcome (`ok`, transport `Error`, `ScriptError`),
pinned at construction time and enforced by `run_corpus_check` on the
Python engine, the native C++ engine and the batch driver (whose
dispatches launch `verify_tiles` on the card); `tests/test_torch_workloads.py`
holds the corpus to the JAX package's.

The shapes are the reference's hard cases: CHECKMULTISIG fan-out is the
measured deferral dead end (the optimistic first pass guesses a pairing
the cursor walk then falsifies key by key), quadratic sighash is the
pre-BIP143 O(n²) hashing cliff, max-size scripts stress the interpreter
byte budget, taproot script-path + annex exercises the longest
sighash/commitment chain, the malleation/boundary-flag entries pin the
exact flag bits where a verdict legally flips, and the scalar-edge entries
pin u1/u2 at the GLV split and signed-recoder boundaries of the kernel.

Adding a shape: write a `_case_*` constructor returning `CorpusCase`
rows with pinned verdicts, register its shape tag in `SHAPES` and extend
`shape_batch()` if it should be scaled up. A wrong pin fails the gauntlet
— that is the point.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..api import Error
from ..core.flags import (
    VERIFY_ALL_EXTENDED,
    VERIFY_DERSIG,
    VERIFY_LOW_S,
    VERIFY_NULLFAIL,
    VERIFY_P2SH,
)
from ..core.script import (
    MAX_PUBKEYS_PER_MULTISIG,
    MAX_SCRIPT_ELEMENT_SIZE,
    MAX_SCRIPT_SIZE,
    OP_1,
    OP_CHECKMULTISIG,
    OP_CHECKSIG,
    OP_DROP,
    push_data,
)
from ..core.script_error import ScriptError
from ..core.serialize import ser_string
from ..core.sighash import (
    SIGHASH_ALL,
    SIGHASH_DEFAULT,
    PrecomputedTxData,
    SigVersion,
    bip143_sighash,
    bip341_sighash,
    legacy_sighash,
)
from ..core.tx import COIN, OutPoint, Tx, TxIn, TxOut
from ..crypto import secp_host as H
from ..crypto.glv import LAMBDA
from ..models.batch import BatchItem
from ..utils.hashes import hash160, sha256, tagged_hash

__all__ = ["SHAPES", "CorpusCase", "build_corpus", "shape_batch"]

# Corpus taxonomy. The first four are the per-shape scale-up axes of
# `shape_batch`; the rest are verdict-pinning shapes (cheap,
# correctness-only).
SHAPES = (
    "multisig_fanout",
    "quadratic_sighash",
    "max_size_script",
    "taproot_annex",
    "sig_malleation",
    "boundary_flags",
    "scalar_edge",
)

AMOUNT = COIN // 100


@dataclass
class CorpusCase:
    """One pinned adversarial input."""

    name: str
    shape: str
    description: str
    item: BatchItem
    expect_ok: bool
    expect_error: Error
    expect_script_error: Optional[ScriptError]

    def expected(self) -> Tuple[bool, str, Optional[str]]:
        """(ok, Error name, ScriptError name) — the comparison triple the
        gauntlet and the differential backends all speak."""
        serr = None
        if (
            not self.expect_ok
            and self.expect_script_error is not None
            and self.expect_script_error != ScriptError.OK
        ):
            serr = self.expect_script_error.name
        return (self.expect_ok, self.expect_error.name, serr)


def _sk(tag: str) -> int:
    return int.from_bytes(hashlib.sha256(tag.encode()).digest(), "big") % (H.N - 1) + 1


def _prevout(tag: str) -> OutPoint:
    return OutPoint(hashlib.sha256(f"corpus/{tag}".encode()).digest(), 0)


def _spend_tx(tag: str, n_inputs: int = 1) -> Tx:
    """Unsigned 1-output spend of `n_inputs` synthetic prevouts."""
    return Tx(
        version=2,
        vin=[TxIn(_prevout(f"{tag}/{i}")) for i in range(n_inputs)],
        vout=[TxOut(AMOUNT * n_inputs - 1000, b"\x51")],
        locktime=0,
    )


def _item(tx: Tx, spk: bytes, flags: int = VERIFY_ALL_EXTENDED,
          input_index: int = 0, n_inputs: int = 1) -> BatchItem:
    return BatchItem(
        tx.serialize(),
        input_index,
        flags,
        spent_outputs=[(AMOUNT, spk)] * n_inputs,
    )


def _malleate_high_s(sig_with_type: bytes) -> bytes:
    """Re-encode a strict-DER signature with S -> N - S (still lax-DER
    valid; consensus-accepted without VERIFY_LOW_S, pubkey.cpp:204)."""
    sig, hashtype = sig_with_type[:-1], sig_with_type[-1:]
    r, s = H.parse_der_lax(sig)
    body = H._der_encode_int(r) + H._der_encode_int(H.N - s)
    return b"\x30" + bytes([len(body)]) + body + hashtype


def _pad_der(sig_with_type: bytes) -> bytes:
    """Re-encode with a gratuitous leading zero on R — BER-ish padding
    parse_der_lax tolerates but strict DER (BIP66) rejects."""
    sig, hashtype = sig_with_type[:-1], sig_with_type[-1:]
    r, s = H.parse_der_lax(sig)
    r_raw = r.to_bytes((r.bit_length() + 7) // 8 or 1, "big")
    if r_raw[0] & 0x80:
        r_raw = b"\x00" + r_raw
    r_enc = b"\x02" + bytes([len(r_raw) + 1]) + b"\x00" + r_raw
    s_enc = H._der_encode_int(s)
    body = r_enc + s_enc
    return b"\x30" + bytes([len(body)]) + body + hashtype


# --------------------------------------------------------------------------
# multisig_fanout — the deferral dead end. Core's CHECKMULTISIG cursor
# walks keys top-down (interpreter.cpp:1177-1205): a sig that belongs to
# the LAST of 20 keys costs 19 cryptographically-false curve checks
# before the true pairing, and the batch driver's optimistic pass guesses
# the first pairing — the worst case for oracle re-interpretation rounds.
# --------------------------------------------------------------------------

def _multisig_keys(tag: str, n: int = MAX_PUBKEYS_PER_MULTISIG):
    sks = [_sk(f"{tag}/k{i}") for i in range(n)]
    return sks, [H.pubkey_create(sk) for sk in sks]


def _opnum(n: int) -> bytes:
    """Script-number opcode for small n: OP_1..OP_16 direct, a minimal
    one-byte push above that (20 keys > OP_16 — 0x50+20 would be
    OP_NOTIF, which is how a hand-rolled multisig script quietly turns
    into an unbalanced conditional)."""
    assert 1 <= n <= 0x7F
    return bytes([0x50 + n]) if n <= 16 else push_data(bytes([n]))


def _p2wsh_multisig(tag: str, m: int, sign_with: List[int],
                    wrong_msg: bool = False,
                    key_tag: Optional[str] = None) -> Tuple[Tx, bytes]:
    """P2WSH m-of-20 spend signed by key indices `sign_with` (ascending —
    the order the cursor needs). Returns (signed tx, spk). `key_tag`
    shares one derived key set across many txs (bench scale-ups)."""
    sks, pubs = _multisig_keys(key_tag or tag)
    ws = (
        _opnum(m)
        + b"".join(push_data(p) for p in pubs)
        + _opnum(len(pubs))
        + bytes([OP_CHECKMULTISIG])
    )
    spk = b"\x00\x20" + sha256(ws)
    tx = _spend_tx(tag)
    sighash = bip143_sighash(ws, tx, 0, SIGHASH_ALL, AMOUNT)
    if wrong_msg:
        sighash = sha256(b"corpus/other-msg")
    sigs = [H.sign_ecdsa(sks[i], sighash) + bytes([SIGHASH_ALL]) for i in sign_with]
    tx.vin[0].witness = [b""] + sigs + [ws]
    tx.invalidate_caches()
    return tx, spk


def _cases_multisig_fanout() -> List[CorpusCase]:
    tx1, spk1 = _p2wsh_multisig("ms-last", 1, [19])
    tx2, spk2 = _p2wsh_multisig("ms-top2", 2, [18, 19])
    tx3, spk3 = _p2wsh_multisig("ms-none", 1, [19], wrong_msg=True)
    return [
        CorpusCase(
            "multisig-1of20-last-key", "multisig_fanout",
            "1-of-20 CHECKMULTISIG whose sig matches only the last key: "
            "19 false curve checks before the true pairing",
            _item(tx1, spk1), True, Error.ERR_OK, ScriptError.OK,
        ),
        CorpusCase(
            "multisig-2of20-top-keys", "multisig_fanout",
            "2-of-20 signed by the two highest keys — the cursor burns "
            "18 misses before the first hit",
            _item(tx2, spk2), True, Error.ERR_OK, ScriptError.OK,
        ),
        CorpusCase(
            "multisig-1of20-no-match", "multisig_fanout",
            "well-formed sig matching none of the 20 keys: full cursor "
            "walk, then false (NULLFAIL not in the extended flag set)",
            _item(tx3, spk3), False, Error.ERR_SCRIPT, ScriptError.EVAL_FALSE,
        ),
    ]


# --------------------------------------------------------------------------
# quadratic_sighash — pre-BIP143 legacy inputs: every input's SIGHASH_ALL
# serializes the ENTIRE transaction (interpreter.cpp:1577-1642), so a
# K-input legacy tx hashes O(K²) bytes. BIP143 killed this for segwit;
# legacy spends still pay it.
# --------------------------------------------------------------------------

def _quadratic_tx(tag: str, k: int) -> Tuple[Tx, List[Tuple[int, bytes]]]:
    sks = [_sk(f"{tag}/q{i}") for i in range(k)]
    pubs = [H.pubkey_create(sk) for sk in sks]
    spks = [
        b"\x76\xa9" + push_data(hash160(p)) + b"\x88\xac" for p in pubs
    ]
    tx = _spend_tx(tag, n_inputs=k)
    for i in range(k):
        sighash = legacy_sighash(spks[i], tx, i, SIGHASH_ALL)
        sig = H.sign_ecdsa(sks[i], sighash) + bytes([SIGHASH_ALL])
        tx.vin[i].script_sig = push_data(sig) + push_data(pubs[i])
    tx.invalidate_caches()
    return tx, [(AMOUNT, spk) for spk in spks]


def _cases_quadratic() -> List[CorpusCase]:
    k = 16
    tx, outs = _quadratic_tx("quad16", k)
    raw = tx.serialize()
    first = BatchItem(raw, 0, VERIFY_ALL_EXTENDED, spent_outputs=outs)
    last = BatchItem(raw, k - 1, VERIFY_ALL_EXTENDED, spent_outputs=outs)
    return [
        CorpusCase(
            "quadratic-16in-legacy-first", "quadratic_sighash",
            "input 0 of a 16-input all-legacy tx: each input re-hashes "
            "the whole tx (pre-BIP143 quadratic shape)",
            first, True, Error.ERR_OK, ScriptError.OK,
        ),
        CorpusCase(
            "quadratic-16in-legacy-last", "quadratic_sighash",
            "last input of the same 16-input legacy tx",
            last, True, Error.ERR_OK, ScriptError.OK,
        ),
    ]


# --------------------------------------------------------------------------
# max_size_script — scriptPubKeys at the 10,000-byte consensus limit:
# 18 × (520-byte push + OP_DROP) filler then a P2PK tail keeps the
# non-push op count at 19 (limit 201) while the byte budget nearly fills.
# --------------------------------------------------------------------------

def _max_size_spk(tag: str, oversize: bool = False) -> Tuple[bytes, int]:
    """(spk, signing key). ~9.5 kB valid; `oversize` pads one byte past
    MAX_SCRIPT_SIZE so execution must fail with SCRIPT_SIZE."""
    sk = _sk(f"{tag}/pk")
    pub = H.pubkey_create(sk)
    blob = hashlib.sha256(f"corpus/{tag}/blob".encode()).digest()
    blob = (blob * ((MAX_SCRIPT_ELEMENT_SIZE // 32) + 1))[:MAX_SCRIPT_ELEMENT_SIZE]
    unit = push_data(blob) + bytes([OP_DROP])
    spk = unit * 18 + push_data(pub) + bytes([OP_CHECKSIG])
    if oversize:
        spk += bytes([0x61]) * (MAX_SCRIPT_SIZE + 1 - len(spk))  # OP_NOP pad
    assert (len(spk) > MAX_SCRIPT_SIZE) == oversize
    return spk, sk


def _max_size_tx(tag: str, spk: bytes, sk: int) -> Tx:
    tx = _spend_tx(tag)
    sighash = legacy_sighash(spk, tx, 0, SIGHASH_ALL)
    sig = H.sign_ecdsa(sk, sighash) + bytes([SIGHASH_ALL])
    tx.vin[0].script_sig = push_data(sig)
    tx.invalidate_caches()
    return tx


def _cases_max_size() -> List[CorpusCase]:
    spk, sk = _max_size_spk("maxs")
    tx = _max_size_tx("maxs", spk, sk)
    spk_big, sk_big = _max_size_spk("maxs-over", oversize=True)
    tx_big = _max_size_tx("maxs-over", spk_big, sk_big)
    return [
        CorpusCase(
            "maxscript-9.5kb-p2pk", "max_size_script",
            f"{len(spk)}-byte scriptPubKey (520-byte pushes + OP_DROP "
            "filler, P2PK tail) just under MAX_SCRIPT_SIZE",
            _item(tx, spk), True, Error.ERR_OK, ScriptError.OK,
        ),
        CorpusCase(
            "maxscript-oversize-10001", "max_size_script",
            "one byte past MAX_SCRIPT_SIZE: must fail SCRIPT_SIZE before "
            "any execution",
            _item(tx_big, spk_big), False, Error.ERR_SCRIPT,
            ScriptError.SCRIPT_SIZE,
        ),
    ]


# --------------------------------------------------------------------------
# taproot_annex — BIP341 script-path spend with an annex: single tapleaf
# (`<xonly> OP_CHECKSIG`), control block committing the leaf into the
# output key, witness [sig, script, control, annex]. The annex rides the
# sighash (spend_type bit + annex hash, interpreter.cpp:1106-1108), so a
# signature that ignores it must fail.
# --------------------------------------------------------------------------

def _taproot_scriptpath(tag: str, sign_annex: bool = True) -> Tuple[Tx, bytes]:
    internal_sk = _sk(f"{tag}/internal")
    px, parity = H.xonly_pubkey_create(internal_sk)

    leaf_sk = _sk(f"{tag}/leaf")
    leaf_px, leaf_parity = H.xonly_pubkey_create(leaf_sk)
    leaf_sk_even = leaf_sk if leaf_parity == 0 else H.N - leaf_sk
    script = push_data(leaf_px) + bytes([OP_CHECKSIG])
    tapleaf_hash = tagged_hash("TapLeaf", bytes([0xC0]) + ser_string(script))

    t = int.from_bytes(tagged_hash("TapTweak", px + tapleaf_hash), "big") % H.N
    internal_even = internal_sk if parity == 0 else H.N - internal_sk
    out_sk = (internal_even + t) % H.N
    qx, q_parity = H.xonly_pubkey_create(out_sk)
    spk = b"\x51\x20" + qx
    control = bytes([0xC0 | q_parity]) + px

    annex = bytes([0x50]) + hashlib.sha256(f"corpus/{tag}/annex".encode()).digest()
    tx = _spend_tx(tag)
    txdata = PrecomputedTxData(tx, [TxOut(AMOUNT, spk)], force=True)
    sighash = bip341_sighash(
        tx, 0, SIGHASH_DEFAULT, SigVersion.TAPSCRIPT, txdata,
        annex_present=sign_annex,
        annex_hash=sha256(ser_string(annex)) if sign_annex else b"",
        tapleaf_hash=tapleaf_hash,
    )
    sig = H.sign_schnorr(leaf_sk_even, sighash)
    tx.vin[0].witness = [sig, script, control, annex]
    tx.invalidate_caches()
    return tx, spk


def _cases_taproot_annex() -> List[CorpusCase]:
    tx, spk = _taproot_scriptpath("tap-annex")
    tx_bad, spk_bad = _taproot_scriptpath("tap-annex-bad", sign_annex=False)
    return [
        CorpusCase(
            "taproot-scriptpath-annex", "taproot_annex",
            "taproot script-path spend (single CHECKSIG tapleaf) with a "
            "33-byte annex committed into the BIP341 sighash",
            _item(tx, spk), True, Error.ERR_OK, ScriptError.OK,
        ),
        CorpusCase(
            "taproot-scriptpath-annex-unsigned", "taproot_annex",
            "same spend but the signature did not commit to the annex — "
            "the sighash diverges and the Schnorr check must fail",
            _item(tx_bad, spk_bad), False, Error.ERR_SCRIPT,
            ScriptError.SCHNORR_SIG,
        ),
    ]


# --------------------------------------------------------------------------
# sig_malleation + boundary_flags — the exact flag bits where a verdict
# legally flips: high-S (LOW_S), BER padding (DERSIG), CHECKMULTISIG
# dummy (NULLDUMMY) and failed-sig cleanliness (NULLFAIL). Each pair pins
# BOTH sides so a flag-plumbing regression in any backend surfaces as a
# corpus divergence, not a silent policy drift.
# --------------------------------------------------------------------------

def _p2pkh_spend(tag: str, mangle=None) -> Tuple[Tx, bytes]:
    sk = _sk(f"{tag}/pk")
    pub = H.pubkey_create(sk)
    spk = b"\x76\xa9" + push_data(hash160(pub)) + b"\x88\xac"
    tx = _spend_tx(tag)
    sighash = legacy_sighash(spk, tx, 0, SIGHASH_ALL)
    sig = H.sign_ecdsa(sk, sighash) + bytes([SIGHASH_ALL])
    if mangle is not None:
        sig = mangle(sig)
    tx.vin[0].script_sig = push_data(sig) + push_data(pub)
    tx.invalidate_caches()
    return tx, spk


def _bare_1of1(tag: str, dummy: bytes, wrong_msg: bool = False) -> Tuple[Tx, bytes]:
    sk = _sk(f"{tag}/pk")
    pub = H.pubkey_create(sk)
    spk = bytes([OP_1]) + push_data(pub) + bytes([OP_1, OP_CHECKMULTISIG])
    tx = _spend_tx(tag)
    sighash = legacy_sighash(spk, tx, 0, SIGHASH_ALL)
    if wrong_msg:
        sighash = sha256(b"corpus/multisig-wrong")
    sig = H.sign_ecdsa(sk, sighash) + bytes([SIGHASH_ALL])
    tx.vin[0].script_sig = dummy + push_data(sig)
    tx.invalidate_caches()
    return tx, spk


def _cases_malleation_and_flags() -> List[CorpusCase]:
    hs_tx, hs_spk = _p2pkh_spend("mall-highs", mangle=_malleate_high_s)
    pad_tx, pad_spk = _p2pkh_spend("mall-pad", mangle=_pad_der)
    nd_tx, nd_spk = _bare_1of1("flag-nulldummy", bytes([OP_1]))
    nf_tx, nf_spk = _bare_1of1("flag-nullfail", b"\x00", wrong_msg=True)
    return [
        CorpusCase(
            "malleate-high-s-accepted", "sig_malleation",
            "S -> N-S malleated signature; consensus-valid while "
            "VERIFY_LOW_S is off (verify normalizes, pubkey.cpp:204)",
            _item(hs_tx, hs_spk), True, Error.ERR_OK, ScriptError.OK,
        ),
        CorpusCase(
            "malleate-high-s-low-s-flag", "sig_malleation",
            "same spend with VERIFY_LOW_S set: SIG_HIGH_S",
            _item(hs_tx, hs_spk, flags=VERIFY_ALL_EXTENDED | VERIFY_LOW_S),
            False, Error.ERR_SCRIPT, ScriptError.SIG_HIGH_S,
        ),
        CorpusCase(
            "malleate-der-padded-dersig", "sig_malleation",
            "BER-padded R integer under VERIFY_DERSIG (BIP66): SIG_DER",
            _item(pad_tx, pad_spk), False, Error.ERR_SCRIPT,
            ScriptError.SIG_DER,
        ),
        CorpusCase(
            "malleate-der-padded-pre-dersig", "sig_malleation",
            "same BER padding with only P2SH active (pre-BIP66 rules): "
            "parse_der_lax tolerates it",
            _item(pad_tx, pad_spk, flags=VERIFY_P2SH),
            True, Error.ERR_OK, ScriptError.OK,
        ),
        CorpusCase(
            "boundary-nulldummy-rejected", "boundary_flags",
            "bare 1-of-1 CHECKMULTISIG with an OP_1 dummy under "
            "VERIFY_NULLDUMMY (in the extended set): SIG_NULLDUMMY",
            _item(nd_tx, nd_spk), False, Error.ERR_SCRIPT,
            ScriptError.SIG_NULLDUMMY,
        ),
        CorpusCase(
            "boundary-nulldummy-accepted", "boundary_flags",
            "same dummy with only P2SH active: accepted",
            _item(nd_tx, nd_spk, flags=VERIFY_P2SH),
            True, Error.ERR_OK, ScriptError.OK,
        ),
        CorpusCase(
            "boundary-nullfail", "boundary_flags",
            "failed CHECKMULTISIG with a non-empty signature under "
            "VERIFY_NULLFAIL: SIG_NULLFAIL instead of plain false",
            _item(nf_tx, nf_spk, flags=VERIFY_ALL_EXTENDED | VERIFY_NULLFAIL),
            False, Error.ERR_SCRIPT, ScriptError.SIG_NULLFAIL,
        ),
        CorpusCase(
            "boundary-nullfail-off", "boundary_flags",
            "same failed CHECKMULTISIG without NULLFAIL: EVAL_FALSE",
            _item(nf_tx, nf_spk), False, Error.ERR_SCRIPT,
            ScriptError.EVAL_FALSE,
        ),
    ]


# --------------------------------------------------------------------------
# scalar_edge — verifications whose ECDSA scalars hit the GLV/recoder
# boundaries the scalar-schedule prover certifies (analysis/scalar_check):
# u2 = r·s⁻¹ mod n is what `split_lambda` decomposes and the windowed
# recoders digest, so each case *constructs* a signature with a pinned u2.
#
# Construction (bare OP_CHECKSIG spk, so the legacy sighash z is
# key-independent): pick a nonce k, r = x(k·G); set s = r·t⁻¹ so that
# u2 = r·s⁻¹ = t exactly; then the verification equation
# u1·G + u2·P = k·G fixes the secret key sk = (k − u1)·t⁻¹ mod n.
# Flags are VERIFY_P2SH only (no LOW_S: s is whatever t demands).
# --------------------------------------------------------------------------

def _u2_pinned_spend(tag: str, t: int, u1_one: bool = False,
                     break_sig: bool = False) -> Tuple[Tx, bytes]:
    """Spend of a bare OP_CHECKSIG output whose verification scalar
    u2 ≡ t (mod n) — or u1 == 1 when `u1_one` (t is then implied)."""
    spk = bytes([OP_CHECKSIG])
    tx = _spend_tx(tag)
    z = int.from_bytes(legacy_sighash(spk, tx, 0, SIGHASH_ALL), "big") % H.N
    ctr = 0
    while True:
        k = _sk(f"{tag}/nonce/{ctr}")
        ctr += 1
        raff = H.G.mul(k).to_affine()
        r = raff[0] % H.N
        if r == 0:
            continue
        if u1_one:
            s = z  # u1 = z·s⁻¹ = 1
            t = r * pow(s, H.N - 2, H.N) % H.N
        else:
            s = r * pow(t, H.N - 2, H.N) % H.N
        if s == 0 or t == 0:
            continue
        u1 = z * pow(s, H.N - 2, H.N) % H.N
        sk = (k - u1) * pow(t, H.N - 2, H.N) % H.N
        if sk == 0:
            continue
        break
    pub = H.pubkey_create(sk)
    if break_sig:
        s = s + 1 if s + 1 < H.N else s - 1
    body = H._der_encode_int(r) + H._der_encode_int(s)
    sig = b"\x30" + bytes([len(body)]) + body + bytes([SIGHASH_ALL])
    tx.vin[0].script_sig = push_data(sig) + push_data(pub)
    tx.invalidate_caches()
    return tx, spk


def _cases_scalar_edge() -> List[CorpusCase]:
    # Every signed digit at the minimum -16 (the maximal 25-long carry
    # chain): window 0 holds 16, windows 1..24 hold 15 (+1 carry-in),
    # and the top window absorbs the final carry at its proven cap of 7.
    max_digits = 16 + 15 * sum(32 ** w for w in range(1, 25)) + 6 * 32 ** 25
    targets = [
        ("scalar-u2-one", 1,
         "u2 pinned to 1: the minimal nonzero scalar through the "
         "GLV split and both recoders"),
        ("scalar-u2-n-minus-1", H.N - 1,
         "u2 pinned to n-1: negation-heavy split, maximal reduction"),
        ("scalar-u2-lambda", LAMBDA,
         "u2 pinned to the endomorphism eigenvalue lambda: the split "
         "degenerates to (0, 1) up to sign"),
        ("scalar-u2-lambda-plus-1", (LAMBDA + 1) % H.N,
         "u2 pinned one past lambda: smallest perturbation off the "
         "lattice eigenvector"),
        ("scalar-u2-2p128-minus-1", (1 << 128) - 1,
         "u2 pinned to 2^128-1: a split half exactly at the proven "
         "|k_i| < 2^128 boundary when the split passes it through"),
        ("scalar-u2-2p128", 1 << 128,
         "u2 pinned to 2^128: first scalar the 128-bit half encoding "
         "cannot carry verbatim — the lattice must actually reduce"),
        ("scalar-u2-max-signed-digits", max_digits,
         "u2 whose signed recoding is all windows at -16 (maximal "
         "carry chain) with the top window at its carry-free cap of 7"),
    ]
    cases = [
        CorpusCase(
            name, "scalar_edge", desc,
            _item(_tx_spk[0], _tx_spk[1], flags=VERIFY_P2SH),
            True, Error.ERR_OK, ScriptError.OK,
        )
        for name, t, desc in targets
        for _tx_spk in [_u2_pinned_spend(name, t)]
    ]
    u1_tx, u1_spk = _u2_pinned_spend("scalar-u1-one", 0, u1_one=True)
    cases.append(CorpusCase(
        "scalar-u1-one", "scalar_edge",
        "u1 pinned to 1: the G-table multiplier at its minimal nonzero "
        "value",
        _item(u1_tx, u1_spk, flags=VERIFY_P2SH),
        True, Error.ERR_OK, ScriptError.OK,
    ))
    bad_tx, bad_spk = _u2_pinned_spend("scalar-u2-lambda-bad", LAMBDA,
                                       break_sig=True)
    cases.append(CorpusCase(
        "scalar-u2-lambda-badsig", "scalar_edge",
        "same lambda-pinned construction with s+1: CHECKSIG pushes "
        "false and the script fails EVAL_FALSE (no NULLFAIL in flags)",
        _item(bad_tx, bad_spk, flags=VERIFY_P2SH),
        False, Error.ERR_SCRIPT, ScriptError.EVAL_FALSE,
    ))
    return cases


def build_corpus() -> List[CorpusCase]:
    """The full pinned corpus, deterministic (no RNG anywhere above)."""
    return (
        _cases_multisig_fanout()
        + _cases_quadratic()
        + _cases_max_size()
        + _cases_taproot_annex()
        + _cases_malleation_and_flags()
        + _cases_scalar_edge()
    )


def shape_batch(shape: str, n: int, seed: int = 0) -> List[BatchItem]:
    """`n` all-valid items of one worst-case shape for benching (distinct
    prevouts/sighashes per item so nothing short-circuits through the
    sig/script caches on a cold run; key material is shared per shape —
    construction cost stays linear)."""
    tag = f"bench{seed}"
    items: List[BatchItem] = []
    if shape == "multisig_fanout":
        for i in range(n):
            tx, spk = _p2wsh_multisig(
                f"{tag}/ms{i}", 1, [19], key_tag=f"{tag}/ms-keys"
            )
            items.append(_item(tx, spk))
    elif shape == "quadratic_sighash":
        tx, outs = _quadratic_tx(f"{tag}/quad", n)
        raw = tx.serialize()
        items = [
            BatchItem(raw, i, VERIFY_ALL_EXTENDED, spent_outputs=outs)
            for i in range(n)
        ]
    elif shape == "max_size_script":
        spk, sk = _max_size_spk(f"{tag}/maxs")
        for i in range(n):
            tx = _max_size_tx(f"{tag}/maxs{i}", spk, sk)
            items.append(_item(tx, spk))
    elif shape == "taproot_annex":
        for i in range(n):
            tx, spk = _taproot_scriptpath(f"{tag}/tap{i}")
            items.append(_item(tx, spk))
    else:
        raise ValueError(f"no bench batch for shape {shape!r}")
    return items


def run_corpus_check(corpus: Optional[List[CorpusCase]] = None, device=None,
                     verifier=None) -> dict:
    """Every corpus entry through every available engine, each verdict
    compared against its pin. One mismatch is either a consensus bug or
    a stale pin — both fail the gauntlet (fail-closed, no allowlist).
    Also feeds the per-shape telemetry the stats gate requires. The batch
    leg runs on `verifier`, else on a new one on `device` (None: cuda:0).
    `batch_launches` counts its checked verify launches."""
    from time import perf_counter

    from ..ops.verify_tiles import verify_tiles_checked
    from . import (
        GAUNTLET_CORPUS_CASES,
        GAUNTLET_DIVERGENCE,
        GAUNTLET_SHAPE_SECONDS,
        resolve_verifier,
    )
    from .diff_fuzz import batch_verdicts, native_verdict, python_verdict

    verifier = resolve_verifier(device, verifier)
    cases = build_corpus() if corpus is None else corpus
    launches0 = verify_tiles_checked.launches
    bat = batch_verdicts([c.item for c in cases], verifier=verifier)
    batch_launches = verify_tiles_checked.launches - launches0
    mismatches: List[dict] = []
    native_seen = False
    for c, b in zip(cases, bat):
        GAUNTLET_CORPUS_CASES.inc(shape=c.shape)
        t0 = perf_counter()
        got = {"batch": b, "python": python_verdict(c.item)}
        nat = native_verdict(c.item)
        GAUNTLET_SHAPE_SECONDS.observe(perf_counter() - t0, shape=c.shape)
        if nat is not None:
            native_seen = True
            got["native"] = nat
        want = c.expected()
        for engine, verdict in got.items():
            if verdict != want:
                mismatches.append(
                    {
                        "case": c.name,
                        "shape": c.shape,
                        "engine": engine,
                        "want": list(want),
                        "got": list(verdict),
                    }
                )
    GAUNTLET_DIVERGENCE.inc(len(mismatches), leg="corpus")
    return {
        "cases": len(cases),
        "shapes": sorted({c.shape for c in cases}),
        "native_available": native_seen,
        "device": str(verifier.device),
        "batch_launches": batch_launches,
        "mismatches": mismatches,
        "pinned": not mismatches,
    }
