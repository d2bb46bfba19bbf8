"""Synthetic funded outputs, signed spends and blocks (tests and
chip_smoke.py only).

A copy of the builders of `bitcoinconsensus_tpu/utils/blockgen.py`
(`Wallet`, `FundedOutput`, `build_spend_tx`, `make_funded_view`,
`build_block` with regtest-grade proof of work), and the port's one
definition of the replay script-type mix (`DEFAULT_MIX` and `_pick_kind`,
those of `bitcoinconsensus_tpu/workloads/replay.py`), which
`workloads/replay.py` takes from here; plus `mixed_items`, which draws a
seeded batch of inputs in that mix (chip_smoke's main path).

Signing is deterministic (`crypto/secp_host.py` sign_ecdsa / sign_schnorr),
so for the same seeds these builders give byte-identical transactions to
the JAX package's. They differ only in how k·G is computed: through the G
window table of `ops/gen_gtable.py` (32 affine additions in Python ints)
instead of a plain double-and-add, which makes a 10k-input batch take
seconds rather than minutes.
"""

from __future__ import annotations

import hashlib
import random
import struct
from typing import List, Optional, Sequence, Tuple

from ..core.block import (
    Block,
    BlockHeader,
    block_merkle_root,
    block_witness_merkle_root,
    check_proof_of_work,
    witness_commitment_index,
)
from ..core.flags import VERIFY_ALL_EXTENDED
from ..core.script import OP_CHECKMULTISIG, OP_RETURN, push_data
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
from ..ops.gen_gtable import affine_table
from .hashes import hash160, sha256d, tagged_hash

__all__ = [
    "KINDS",
    "DEFAULT_MIX",
    "Wallet",
    "FundedOutput",
    "make_funded_view",
    "build_spend_tx",
    "build_block",
    "mixed_items",
    "REGTEST_POW_LIMIT",
    "REGTEST_BITS",
]

# Regtest-grade proof of work, so that a block mines in a few nonce tries
# (chainparams.cpp regtest powLimit and genesis nBits).
REGTEST_POW_LIMIT = 0x7FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF
REGTEST_BITS = 0x207FFFFF

KINDS = ("p2pkh", "p2wpkh", "p2wsh_multisig", "p2tr")

# Mainnet-like script-type ratios (input-count share, post-taproot).
DEFAULT_MIX = (
    ("p2wpkh", 0.55),
    ("p2tr", 0.20),
    ("p2pkh", 0.15),
    ("p2wsh_multisig", 0.10),
)


def _g_mul(k: int) -> Tuple[int, int]:
    """Affine k·G for 0 < k < n, one table row per byte of k."""
    table = affine_table()
    acc = H.PointJ.infinity()
    for w in range(32):
        d = (k >> (8 * w)) & 0xFF
        if d:
            acc = acc.add_affine(*table[w][d - 1])
    aff = acc.to_affine()
    assert aff is not None
    return aff


def pubkey_create(seckey: int) -> bytes:
    x, y = _g_mul(seckey % H.N)
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def xonly_pubkey_create(seckey: int) -> Tuple[bytes, int]:
    x, y = _g_mul(seckey % H.N)
    return x.to_bytes(32, "big"), y & 1


def sign_ecdsa(seckey: int, msg32: bytes) -> bytes:
    """`secp_host.sign_ecdsa` (deterministic nonce, low-S, strict DER)."""
    m = int.from_bytes(msg32, "big") % H.N
    counter = 0
    while True:
        k = int.from_bytes(
            hashlib.sha256(
                seckey.to_bytes(32, "big") + msg32 + counter.to_bytes(4, "big")
            ).digest(),
            "big",
        ) % H.N
        counter += 1
        if k == 0:
            continue
        r = _g_mul(k)[0] % H.N
        if r == 0:
            continue
        s = pow(k, H.N - 2, H.N) * (m + r * seckey) % H.N
        if s == 0:
            continue
        if s > H.N // 2:
            s = H.N - s
        body = H._der_encode_int(r) + H._der_encode_int(s)
        return b"\x30" + bytes([len(body)]) + body


def sign_schnorr(seckey: int, msg32: bytes, aux: bytes = b"\x00" * 32) -> bytes:
    """`secp_host.sign_schnorr` (BIP340)."""
    d0 = seckey % H.N
    assert d0 != 0
    px, py = _g_mul(d0)
    d = d0 if (py & 1) == 0 else H.N - d0
    t = d ^ int.from_bytes(tagged_hash("BIP0340/aux", aux), "big")
    k0 = int.from_bytes(
        tagged_hash("BIP0340/nonce",
                    t.to_bytes(32, "big") + px.to_bytes(32, "big") + msg32),
        "big",
    ) % H.N
    assert k0 != 0
    rx, ry = _g_mul(k0)
    k = k0 if (ry & 1) == 0 else H.N - k0
    e = int.from_bytes(
        tagged_hash("BIP0340/challenge",
                    rx.to_bytes(32, "big") + px.to_bytes(32, "big") + msg32),
        "big",
    ) % H.N
    s = (k + e * d) % H.N
    return rx.to_bytes(32, "big") + s.to_bytes(32, "big")


def _sk(seed: str) -> int:
    return int.from_bytes(hashlib.sha256(seed.encode()).digest(), "big") % (H.N - 1) + 1


class Wallet:
    """Deterministic per-seed key material for one output `kind`."""

    def __init__(self, seed: str, kind: str):
        if kind not in KINDS:
            raise ValueError(f"unknown output kind {kind!r}")
        self.kind = kind
        self.seed = seed
        if kind == "p2wsh_multisig":
            self.sks = [_sk(f"{seed}/k{i}") for i in range(3)]
            self.pubs = [pubkey_create(sk) for sk in self.sks]
            # 2-of-3: OP_2 <pk0> <pk1> <pk2> OP_3 OP_CHECKMULTISIG
            self.witness_script = (
                b"\x52"
                + b"".join(push_data(p) for p in self.pubs)
                + b"\x53"
                + bytes([OP_CHECKMULTISIG])
            )
            self.spk = b"\x00\x20" + hashlib.sha256(self.witness_script).digest()
        elif kind == "p2tr":
            d = _sk(seed)
            px, parity = xonly_pubkey_create(d)
            d_even = d if parity == 0 else H.N - d
            t = int.from_bytes(tagged_hash("TapTweak", px), "big") % H.N
            self.out_sk = (d_even + t) % H.N
            qx, _ = xonly_pubkey_create(self.out_sk)
            self.spk = b"\x51\x20" + qx
        else:
            self.sk = _sk(seed)
            self.pub = pubkey_create(self.sk)
            h = hash160(self.pub)
            if kind == "p2pkh":
                self.spk = b"\x76\xa9" + push_data(h) + b"\x88\xac"
            else:  # p2wpkh
                self.spk = b"\x00\x14" + h

    def sign_input(
        self,
        tx: Tx,
        n_in: int,
        amount: int,
        txdata: Optional[PrecomputedTxData] = None,
        corrupt: bool = False,
    ) -> None:
        """Fill scriptSig/witness of tx.vin[n_in] spending this wallet's spk."""
        if self.kind == "p2pkh":
            sighash = legacy_sighash(self.spk, tx, n_in, SIGHASH_ALL)
            sig = sign_ecdsa(self.sk, sighash) + bytes([SIGHASH_ALL])
            if corrupt:
                sig = _flip(sig, 9)
            tx.vin[n_in].script_sig = push_data(sig) + push_data(self.pub)
        elif self.kind == "p2wpkh":
            code = b"\x76\xa9" + push_data(hash160(self.pub)) + b"\x88\xac"
            sighash = bip143_sighash(code, tx, n_in, SIGHASH_ALL, amount)
            sig = sign_ecdsa(self.sk, sighash) + bytes([SIGHASH_ALL])
            if corrupt:
                sig = _flip(sig, 9)
            tx.vin[n_in].witness = [sig, self.pub]
        elif self.kind == "p2wsh_multisig":
            sighash = bip143_sighash(
                self.witness_script, tx, n_in, SIGHASH_ALL, amount
            )
            sigs = [
                sign_ecdsa(sk, sighash) + bytes([SIGHASH_ALL])
                for sk in self.sks[:2]
            ]
            if corrupt:
                sigs[0] = _flip(sigs[0], 9)
            tx.vin[n_in].witness = [b""] + sigs + [self.witness_script]
        else:  # p2tr key path
            if txdata is None:
                raise ValueError("taproot signing needs PrecomputedTxData")
            sighash = bip341_sighash(
                tx, n_in, SIGHASH_DEFAULT, SigVersion.TAPROOT, txdata, False, b""
            )
            sig = sign_schnorr(self.out_sk, sighash)
            if corrupt:
                sig = _flip(sig, 40)
            tx.vin[n_in].witness = [sig]
        # Signing mutates the tx: drop memoised ids and serializations.
        tx.invalidate_caches()


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1 :]


class FundedOutput:
    __slots__ = ("outpoint", "wallet", "amount")

    def __init__(self, outpoint: OutPoint, wallet: Wallet, amount: int):
        self.outpoint = outpoint
        self.wallet = wallet
        self.amount = amount


def make_funded_view(
    n: int,
    kinds: Sequence[str] = KINDS,
    amount: int = COIN // 100,
    height: int = 1,
    seed: str = "fund",
):
    """(CoinsView, funded outputs): n outputs cycling through `kinds`."""
    from ..models.validate import Coin, CoinsView

    coins = CoinsView()
    funded: List[FundedOutput] = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        w = Wallet(f"{seed}/{i}", kind)
        op = OutPoint(hashlib.sha256(f"{seed}/op/{i}".encode()).digest(), i & 0xFFFF)
        coins.add(op, Coin(TxOut(amount, w.spk), height=height, coinbase=False))
        funded.append(FundedOutput(op, w, amount))
    return coins, funded


def build_spend_tx(
    inputs: Sequence[FundedOutput],
    fee: int = 1000,
    corrupt_input: Optional[int] = None,
) -> Tx:
    """One signed tx spending `inputs` to an anyone-can-spend output."""
    total = sum(f.amount for f in inputs)
    tx = Tx(
        version=2,
        vin=[TxIn(f.outpoint) for f in inputs],
        vout=[TxOut(total - fee, b"\x51")],
        locktime=0,
    )
    spent = [TxOut(f.amount, f.wallet.spk) for f in inputs]
    # force=True: BIP341 readiness is normally inferred from witnesses,
    # which are only attached below as each input signs.
    txdata = (
        PrecomputedTxData(tx, spent, force=True)
        if any(f.wallet.kind == "p2tr" for f in inputs)
        else None
    )
    for i, f in enumerate(inputs):
        f.wallet.sign_input(
            tx, i, f.amount, txdata=txdata, corrupt=(i == corrupt_input)
        )
    return tx


def _make_coinbase(height: int, reward: int, with_witness_commitment: bool) -> Tx:
    """A coinbase paying `reward`: the BIP34 height push, and a BIP141
    commitment placeholder that `build_block` fills in."""
    script_sig = push_data(struct.pack("<I", height).rstrip(b"\x00") or b"\x00") + b"\x00"
    vout = [TxOut(reward, b"\x51")]
    if with_witness_commitment:
        vout.append(TxOut(0, bytes([OP_RETURN, 0x24]) + b"\xaa\x21\xa9\xed" + b"\x00" * 32))
    tx = Tx(
        version=1,
        vin=[TxIn(OutPoint(b"\x00" * 32, 0xFFFFFFFF), script_sig, 0xFFFFFFFF)],
        vout=vout,
        locktime=0,
    )
    if with_witness_commitment:
        tx.vin[0].witness = [b"\x00" * 32]
    return tx


def build_block(
    txs: List[Tx],
    height: int,
    prev_hash: bytes = b"\x00" * 32,
    fees: int = 0,
    time: int = 1_600_000_000,
    bits: int = REGTEST_BITS,
    witness_commitment: bool = True,
) -> Block:
    """A structurally valid block over `txs`, mined: the coinbase pays the
    subsidy at `height` plus `fees`, the witness commitment is computed over
    the final txs, and the nonce is ground until the header meets the
    regtest target."""
    from ..models.validate import get_block_subsidy

    coinbase = _make_coinbase(height, get_block_subsidy(height) + fees,
                              witness_commitment)
    header = BlockHeader(version=0x20000000, prev_hash=prev_hash,
                         merkle_root=b"\x00" * 32, time=time, bits=bits, nonce=0)
    block = Block(header, [coinbase] + txs)
    if witness_commitment:
        root, _ = block_witness_merkle_root(block)
        commit = sha256d(root + coinbase.vin[0].witness[0])
        idx = witness_commitment_index(block)
        spk = coinbase.vout[idx].script_pubkey
        coinbase.vout[idx] = TxOut(0, spk[:6] + commit)
        coinbase.invalidate_caches()  # changed after its ids were cached
    header.merkle_root = block_merkle_root(block)[0]
    while not check_proof_of_work(block.hash, bits, REGTEST_POW_LIMIT):
        header.nonce += 1
    return block


def _pick_kind(rng: random.Random, mix) -> str:
    r = rng.random() * sum(w for _, w in mix)
    for kind, w in mix:
        r -= w
        if r <= 0:
            return kind
    return mix[-1][0]


MAX_TX_INPUTS = 3
DUP_SIGNER_RATE = 0.35  # P(reuse a seen wallet), as addresses are reused


def mixed_items(n_inputs: int, seed: int, corrupt_rate: float = 0.01):
    """`n_inputs` inputs (transactions of 1..MAX_TX_INPUTS inputs, the last
    one cut to fit) in DEFAULT_MIX, every one with all its spent outputs and
    VERIFY_ALL_EXTENDED. A transaction is corrupted with probability
    `corrupt_rate × its input count`, in one input (a flipped signature
    byte); signers repeat with DUP_SIGNER_RATE.

    Returns (items, corrupted): BatchItems and, per item, whether it is the
    corrupted input of its transaction."""
    from ..models.batch import BatchItem

    rng = random.Random(seed)
    pool = {k: [] for k, _ in DEFAULT_MIX}
    items, corrupted = [], []
    t = 0
    while len(items) < n_inputs:
        n_in = min(rng.randint(1, MAX_TX_INPUTS), n_inputs - len(items))
        funded = []
        for i in range(n_in):
            kind = _pick_kind(rng, DEFAULT_MIX)
            seen = pool[kind]
            if seen and rng.random() < DUP_SIGNER_RATE:
                w = rng.choice(seen)
            else:
                w = Wallet(f"mix/{seed}/{kind}/{len(seen)}", kind)
                seen.append(w)
            op = OutPoint(
                hashlib.sha256(f"mix/{seed}/{t}/{i}".encode()).digest(), i
            )
            funded.append(FundedOutput(op, w, rng.randrange(10_000, 1_000_000)))
        bad = rng.randrange(n_in) if rng.random() < corrupt_rate * n_in else None
        raw = build_spend_tx(funded, corrupt_input=bad).serialize()
        outs = [(f.amount, f.wallet.spk) for f in funded]
        for i in range(n_in):
            items.append(BatchItem(raw, i, VERIFY_ALL_EXTENDED, spent_outputs=outs))
            corrupted.append(i == bad)
        t += 1
    return items, corrupted


def perturbed_panel(verifier, packed, n_lanes: int, rng):
    """The verify kernel's test panel: `packed` (the verifier's 7-tuple of
    numpy arrays) cut or padded with pad lanes to `n_lanes`, lane 0 replaced
    by the crafted collision lane (P = G, R = 2G: the equal-points case the
    kernel defers), and five disjoint sets of about n_lanes / 160 lanes
    perturbed: the target, the structural validity, the pubkey x, the parity
    rules, and the sign of the first GLV half. Returns the seven arrays and
    the (5, k) perturbed lane indices; `rng` is a numpy Generator."""
    import numpy as np

    from ..crypto.torch_backend import SigCheck

    packed = [np.array(a[:n_lanes]) for a in packed]
    n = len(packed[0])
    if n < n_lanes:  # pad lanes as the packer makes them
        pad = verifier._pack_lanes([])
        packed = [np.concatenate([a, np.repeat(p[:1], n_lanes - n, axis=0)])
                  for a, p in zip(packed, pad)]
    f, wo, par, h2, n1, n2, val = packed
    qx, qy = _g_mul(2)
    coll = verifier._pack_lanes(verifier._prep_lanes([SigCheck(
        "tweak", (qx.to_bytes(32, "big"), qy & 1, H.G_X.to_bytes(32, "big"),
                  (1).to_bytes(32, "big")))]))
    for a, c in zip(packed, coll):
        a[0] = c[0]
    # ~5 x 50 perturbed lanes at 8,192; none where lane 0 is all there is.
    per = min(max(1, n_lanes // 160), (n_lanes - 1) // 5)
    idx = rng.permutation(np.arange(1, n_lanes))[: 5 * per].reshape(5, per)
    f[idx[0], 3, 0] ^= 1  # target
    val[idx[1]] = False  # structurally invalid
    f[idx[2], 2, 0] ^= 1  # pubkey x
    par[idx[3]] = np.where(par[idx[3]] < 0, par[idx[3]], par[idx[3]] ^ 1)
    wo[idx[3]] ^= 1  # parity rules
    n1[idx[4]] ^= 1  # GLV sign
    return (f, wo, par, h2, n1, n2, val), idx
