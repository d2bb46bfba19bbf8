"""Block primitives: header/block codec, merkle roots, context-free checks.

Host-side equivalent of the reference's vendored block layer — the shapes
the block-replay north star needs (SURVEY §2.3, §3.5):

- `BlockHeader`/`Block` wire codec (`primitives/block.h:20-90`),
- `merkle_root` with CVE-2012-2459 mutation detection
  (`consensus/merkle.cpp:45-64`), witness merkle root
  (`consensus/merkle.cpp` BlockWitnessMerkleRoot: coinbase wtxid pinned
  to zero),
- compact-bits target decode + proof-of-work check
  (`arith_uint256.cpp` SetCompact, `pow.cpp` CheckProofOfWork),
- `check_block`: the context-free CheckBlock rules
  (`validation.cpp:3402-3474` — merkle, size limits, coinbase placement,
  per-tx CheckTransaction, legacy-sigop cap),
- witness commitment discovery and validation
  (`consensus/validation.h:161-179` GetWitnessCommitmentIndex,
  `validation.cpp:3385-3428` ContextualCheckBlock witness rules).

Like the reference, all hashes are held in wire byte order.

A copy of `bitcoinconsensus_tpu/core/block.py`. Its device merkle root,
`merkle_root_device`, runs the port's merkle tree kernel, the whole tree
in one launch (`ops/sha256.merkle_tree`, `csrc/sha256.cu`) on cuda:0 by
default, or on
the device asked for ("cpu" runs the plain torch version);
`check_block(device_merkle=True)` or BITCOINCONSENSUS_TPU_DEVICE_MERKLE=1
selects it, as in the reference.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .script import OP_RETURN, get_sig_op_count
from .serialize import ByteReader, SerializationError, write_compact_size
from .tx import Tx
from .tx_check import MAX_BLOCK_WEIGHT, WITNESS_SCALE_FACTOR, check_transaction
from ..utils.hashes import sha256d

__all__ = [
    "BlockHeader",
    "Block",
    "merkle_root",
    "merkle_root_device",
    "block_merkle_root",
    "block_witness_merkle_root",
    "bits_to_target",
    "check_proof_of_work",
    "check_block",
    "witness_commitment_index",
    "check_witness_commitment",
    "MAX_BLOCK_SIGOPS_COST",
    "POW_LIMIT_MAINNET",
]

MAX_BLOCK_SIGOPS_COST = 80_000  # consensus/consensus.h:17
MIN_WITNESS_COMMITMENT = 38  # consensus/validation.h:19
# chainparams.cpp mainnet powLimit.
POW_LIMIT_MAINNET = 0x00000000FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF


@dataclass
class BlockHeader:
    """80-byte block header (primitives/block.h:20-72)."""

    version: int
    prev_hash: bytes  # 32 bytes, wire order
    merkle_root: bytes  # 32 bytes, wire order
    time: int
    bits: int
    nonce: int

    def serialize(self) -> bytes:
        return (
            struct.pack("<i", self.version)
            + self.prev_hash
            + self.merkle_root
            + struct.pack("<III", self.time, self.bits, self.nonce)
        )

    @classmethod
    def deserialize(cls, r: ByteReader) -> "BlockHeader":
        version = r.read_i32()
        prev_hash = r.read(32)
        merkle = r.read(32)
        time = r.read_u32()
        bits = r.read_u32()
        nonce = r.read_u32()
        return cls(version, prev_hash, merkle, time, bits, nonce)

    @property
    def hash(self) -> bytes:
        """Double-SHA256 of the 80-byte header (wire order)."""
        return sha256d(self.serialize())

    @property
    def hash_hex(self) -> str:
        return self.hash[::-1].hex()


class Block:
    """Header + transactions (primitives/block.h:75-90)."""

    __slots__ = ("header", "vtx", "_native")  # _native: cached NativeBlock

    def __init__(self, header: BlockHeader, vtx: List[Tx]):
        self.header = header
        self.vtx = vtx

    def __getstate__(self):
        # The cached native parse is a raw C++ handle — drop it from
        # pickles/copies; models/validate.py re-parses on demand.
        return (self.header, self.vtx)

    def __setstate__(self, state):
        self.header, self.vtx = state

    @classmethod
    def deserialize(cls, data: bytes) -> "Block":
        r = ByteReader(data)
        header = BlockHeader.deserialize(r)
        n = r.read_compact_size()
        vtx = [Tx._deserialize_from(r) for _ in range(n)]
        if r.remaining():
            raise SerializationError("trailing data after block")
        return cls(header, vtx)

    def serialize(self, include_witness: bool = True) -> bytes:
        parts = [self.header.serialize(), write_compact_size(len(self.vtx))]
        for tx in self.vtx:
            parts.append(tx.serialize(include_witness=include_witness))
        return b"".join(parts)

    @property
    def hash(self) -> bytes:
        return self.header.hash


def merkle_root(hashes: List[bytes]) -> Tuple[bytes, bool]:
    """(root, mutated) over 32-byte leaf hashes (consensus/merkle.cpp:45-64).

    Bitcoin's odd-count duplication rule makes certain duplicate-leaf lists
    collide (CVE-2012-2459); `mutated` flags any level that hashes two
    identical siblings, which callers must treat as an invalid block.
    """
    if not hashes:
        return b"\x00" * 32, False
    level = list(hashes)
    mutated = False
    while len(level) > 1:
        for pos in range(0, len(level) - 1, 2):
            if level[pos] == level[pos + 1]:
                mutated = True
        if len(level) & 1:
            level.append(level[-1])
        level = [
            sha256d(level[i] + level[i + 1]) for i in range(0, len(level), 2)
        ]
    return level[0], mutated


def merkle_root_device(hashes: List[bytes], device=None) -> Tuple[bytes, bool]:
    """`merkle_root` computed on a device: one launch of
    `ops/sha256.merkle_tree` reduces the whole tree (each block a chunk of
    leaves in shared memory, the last block to finish the chunk roots), and
    one copy reads the root and the `mutated` flag back. Bit-identical to
    the host version (tests/test_torch_sha256.py), the CVE-2012-2459 flag
    with the host's semantics included: sibling equality is taken before the
    odd duplicate, so the synthetic last pair never counts. One leaf is its
    own root: no launch.

    `device=None` means cuda:0 and raises where CUDA is not available;
    `device="cpu"` runs the plain torch version (the level loop). On a card
    a launch that fails raises: nothing falls back to the host hash.
    """
    import numpy as np
    import torch

    from ..ops.sha256 import merkle_tree, tree_work_bytes
    from ..resilience.inflight import settle_array

    if not hashes:
        return b"\x00" * 32, False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "merkle_root_device() runs on cuda:0 but CUDA is not "
                "available; pass device=\"cpu\" to run the plain torch version"
            )
        device = "cuda:0"
    device = torch.device(device)
    n = len(hashes)
    # One upload: the leaves, then the tree's zeroed work bytes (the root,
    # the flag, the ticket and a row a chunk), so no fill kernel runs and one
    # copy reads the root and the flag back.
    staged = np.zeros(32 * n + tree_work_bytes(n), dtype=np.uint8)
    staged[:32 * n] = np.frombuffer(b"".join(hashes), dtype=np.uint8)
    buf = torch.from_numpy(staged).to(device)
    leaves = buf[:32 * n].view(n, 32)
    work = buf[32 * n:]
    if n == 1:
        work[:32].copy_(leaves[0])
    else:
        merkle_tree(leaves, work)
    host = settle_array(work[:36])
    return host[:32].tobytes(), bool(host[32:].view(np.int32)[0])


def block_merkle_root(block: Block) -> Tuple[bytes, bool]:
    """BlockMerkleRoot: txid leaves (consensus/merkle.cpp:66-73)."""
    return merkle_root([tx.txid for tx in block.vtx])


def block_witness_merkle_root(block: Block) -> Tuple[bytes, bool]:
    """BlockWitnessMerkleRoot: wtxid leaves with the coinbase pinned to
    zero (consensus/merkle.cpp:75-84)."""
    leaves = [b"\x00" * 32] + [tx.wtxid for tx in block.vtx[1:]]
    return merkle_root(leaves)


def bits_to_target(bits: int) -> Tuple[int, bool, bool]:
    """Compact encoding -> (target, negative, overflow)
    (arith_uint256.cpp SetCompact)."""
    size = bits >> 24
    word = bits & 0x007FFFFF
    if size <= 3:
        target = word >> (8 * (3 - size))
    else:
        target = word << (8 * (size - 3))
    negative = word != 0 and (bits & 0x00800000) != 0
    overflow = word != 0 and (
        size > 34 or (word > 0xFF and size > 33) or (word > 0xFFFF and size > 32)
    )
    return target, negative, overflow


def check_proof_of_work(
    header_hash: bytes, bits: int, pow_limit: int = POW_LIMIT_MAINNET
) -> bool:
    """CheckProofOfWork (pow.cpp:74-90); hash in wire order."""
    target, negative, overflow = bits_to_target(bits)
    if negative or target == 0 or overflow or target > pow_limit:
        return False
    return int.from_bytes(header_hash, "little") <= target


def witness_commitment_index(block: Block) -> int:
    """Last coinbase output carrying the BIP141 commitment header, or -1
    (consensus/validation.h:161-179)."""
    commitpos = -1
    if block.vtx:
        for o, txout in enumerate(block.vtx[0].vout):
            spk = txout.script_pubkey
            if (
                len(spk) >= MIN_WITNESS_COMMITMENT
                and spk[0] == OP_RETURN
                and spk[1:6] == b"\x24\xaa\x21\xa9\xed"
            ):
                commitpos = o
    return commitpos


def check_witness_commitment(block: Block) -> Tuple[bool, Optional[str]]:
    """BIP141 witness-commitment rules from ContextualCheckBlock
    (validation.cpp:3385-3428): if a commitment output exists, the coinbase
    witness must be exactly one 32-byte reserved value and
    SHA256d(witness_root || reserved) must equal the committed bytes; with
    no commitment, no transaction may carry witness data."""
    commitpos = witness_commitment_index(block)
    if commitpos != -1:
        coinbase = block.vtx[0]
        if not coinbase.vin:
            # Standalone callers may skip CheckBlock's CheckTransaction
            # (which guarantees a coinbase input exists).
            return False, "bad-witness-nonce-size"
        witness = coinbase.vin[0].witness
        if len(witness) != 1 or len(witness[0]) != 32:
            return False, "bad-witness-nonce-size"
        root, _ = block_witness_merkle_root(block)
        expect = sha256d(root + witness[0])
        commit = block.vtx[0].vout[commitpos].script_pubkey[6:38]
        if expect != commit:
            return False, "bad-witness-merkle-match"
        return True, None
    for tx in block.vtx:
        if tx.has_witness():
            return False, "unexpected-witness"
    return True, None


def check_block(
    block: Block,
    check_pow: bool = True,
    check_merkle: bool = True,
    pow_limit: int = POW_LIMIT_MAINNET,
    device_merkle: Optional[bool] = None,
    device=None,
) -> Tuple[bool, Optional[str]]:
    """Context-free CheckBlock (validation.cpp:3402-3474).

    Returns (ok, reject-reason); reasons match the reference's strings.
    Witness rules are contextual in the reference (segwit activation); use
    `check_witness_commitment` alongside for post-segwit blocks.
    `device_merkle` selects the device merkle root `merkle_root_device`
    (default: the BITCOINCONSENSUS_TPU_DEVICE_MERKLE env, "1" or "on"), on
    `device` (None: cuda:0).
    """
    if check_pow and not check_proof_of_work(block.hash, block.header.bits, pow_limit):
        return False, "high-hash"

    if check_merkle:
        if device_merkle is None:
            device_merkle = os.environ.get(
                "BITCOINCONSENSUS_TPU_DEVICE_MERKLE", ""
            ) in ("1", "on")
        leaves = [tx.txid for tx in block.vtx]
        if device_merkle:
            root, mutated = merkle_root_device(leaves, device)
        else:
            root, mutated = merkle_root(leaves)
        if block.header.merkle_root != root:
            return False, "bad-txnmrklroot"
        if mutated:
            return False, "bad-txns-duplicate"

    if (
        not block.vtx
        or len(block.vtx) * WITNESS_SCALE_FACTOR > MAX_BLOCK_WEIGHT
        or len(block.serialize(include_witness=False)) * WITNESS_SCALE_FACTOR
        > MAX_BLOCK_WEIGHT
    ):
        return False, "bad-blk-length"

    if not block.vtx[0].is_coinbase():
        return False, "bad-cb-missing"
    for tx in block.vtx[1:]:
        if tx.is_coinbase():
            return False, "bad-cb-multiple"

    for tx in block.vtx:
        ok, reason = check_transaction(tx)
        if not ok:
            return False, reason

    sigops = 0
    for tx in block.vtx:
        for txin in tx.vin:
            sigops += get_sig_op_count(txin.script_sig, accurate=False)
        for txout in tx.vout:
            sigops += get_sig_op_count(txout.script_pubkey, accurate=False)
    if sigops * WITNESS_SCALE_FACTOR > MAX_BLOCK_SIGOPS_COST:
        return False, "bad-blk-sigops"

    return True, None
