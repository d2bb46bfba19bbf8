"""Consistent-hash sigstore tier: shard handoff on cell membership change.

Port of `bitcoinconsensus_tpu/cell/sigtier.py`. Nothing on this chain
(`hashring`, this module, `models/sigstore.py`) touches the card: a
control-plane process that absorbs shards creates no CUDA context.

`PersistentSigCache` (models/sigstore.py) made signature-cache shards
portable — fixed-width CRC-checked records, truncation-tolerant replay,
durable DEL tombstones. This module promotes those per-replica stores
into a cell-wide tier:

- **Shared salt.** Cache keys are salted digests; the tier holds the
  canonical 32-byte salt at ``root/salt`` and seeds it into every
  replica's store directory before the replica opens it, so a record
  written by one replica is addressable by every other. Without this a
  handed-off log would be meaningless bytes.
- **Shard ownership.** Shard index ``i`` (the key's leading digest
  byte modulo the shard count) maps to an owning replica via the same
  consistent ring the router uses for tenants, so ownership moves
  minimally under churn.
- **Handoff on departure.** When a replica is evicted, each of its
  shard logs streams to that shard's new owner: records are re-verified
  CRC-by-CRC on the way out (the stream stops at the first bad record —
  the same truncation-tolerant fail-closed rule as replay), written to
  a handoff file with the atomic tmp→fsync→rename idiom, and absorbed
  into the receiver's **live** store in original order, so an ADD
  followed by its tombstone DEL lands evicted — audit-convicted poison
  stays convicted across handoff.
- **Fail-closed reads.** A key whose shard is mid-handoff simply misses
  in the receiver and re-verifies on the device/host path — the tier
  can cost work, never serve an unverified cached verdict.

Held on the card by ``chip_smoke.py``'s ``[cell]`` phase (after a
replica's kill -9: >=90% warm hits on the moved tenants, tombstones
preserved).
"""

from __future__ import annotations

import os
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..models.sigstore import (
    _KEY_LEN,
    _OP_ADD,
    _OP_DEL,
    _REC_LEN,
    PersistentSigCache,
)
from ..obs import counter as _obs_counter
from ..obs import flight as _flight
from .hashring import HashRing

__all__ = [
    "SigTier",
    "absorb_handoff",
    "iter_shard_records",
    "write_handoff",
]

_C_HANDOFFS = _obs_counter(
    "consensus_cell_handoffs_total",
    "sigstore shard handoffs streamed to a new owner on membership change",
)
_C_HANDOFF_RECORDS = _obs_counter(
    "consensus_cell_handoff_records_total",
    "CRC-verified records streamed in sigstore shard handoffs",
)


def iter_shard_records(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (op, key) for every intact record of one shard log.

    CRC-checked record-by-record with the store's truncation-tolerant
    rule: the stream stops at the first short, checksum-failing, or
    unknown-op record — everything past a corrupt byte is untrusted and
    losing it costs cache misses, never wrong hits. The source file is
    never modified (the departed owner may still be inspected
    post-mortem)."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as fh:
        while True:
            rec = fh.read(_REC_LEN)
            if len(rec) < _REC_LEN:
                return  # clean end or torn tail: stop fail-closed
            body = rec[: 1 + _KEY_LEN]
            crc = int.from_bytes(rec[1 + _KEY_LEN :], "little")
            if zlib.crc32(body) != crc:
                return
            op, key = body[:1], body[1:]
            if op not in (_OP_ADD, _OP_DEL):
                return
            yield op, key


def write_handoff(src_paths: Sequence[str], out_path: str) -> int:
    """Stream the intact records of `src_paths` into one handoff file.

    Atomic (tmp + fsync + rename, the compaction idiom): the receiver
    either sees a complete CRC-clean handoff file or no file at all.
    Record order within each source log is preserved, so ADD/DEL
    sequences (tombstones) replay to the same final state. Returns the
    record count."""
    n = 0
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as fh:
        for src in src_paths:
            for op, key in iter_shard_records(src):
                body = op + key
                fh.write(body + zlib.crc32(body).to_bytes(4, "little"))
                n += 1
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, out_path)
    return n


def absorb_handoff(store: PersistentSigCache, path: str) -> Dict[str, int]:
    """Apply a handoff file into a live store, in record order.

    ADD inserts through the normal `add_key` path (persisted into the
    receiver's own shard logs), DEL evicts-and-tombstones through
    `discard_key` — so a key the departed owner convicted (ADD … DEL)
    ends absent here even if this store had cached it independently.
    A kill -9 mid-absorb leaves the receiver's logs healing to the last
    good record boundary on the next open, exactly like any other
    interrupted append sequence."""
    adds = dels = 0
    for op, key in iter_shard_records(path):
        if op == _OP_ADD:
            store.add_key(key)
            adds += 1
        else:
            store.discard_key(key)
            dels += 1
    return {"records": adds + dels, "adds": adds, "dels": dels}


class SigTier:
    """Shard-ownership coordinator over the per-replica stores.

    Holds the canonical salt, the member ring, and the handoff
    procedure. The supervisor drives it: ``join`` before spawning a
    replica (seeds the salt into its store dir), ``leave`` +
    ``handoff_from`` when one is evicted. The `absorb` callable bridges
    process boundaries — in-process stubs call `absorb_handoff`
    directly, subprocess replicas take a control-channel command."""

    def __init__(self, root_dir: str, shards: int = 8, vnodes: int = 64):
        self.root_dir = root_dir
        self.shards = shards
        os.makedirs(root_dir, exist_ok=True)
        self._salt = self._load_salt()
        self.ring = HashRing(vnodes=vnodes)
        self._handoff_seq = 0

    def _load_salt(self) -> bytes:
        path = os.path.join(self.root_dir, "salt")
        try:
            with open(path, "rb") as fh:
                salt = fh.read()
            if len(salt) == _KEY_LEN:
                return salt
        except FileNotFoundError:
            pass
        salt = os.urandom(_KEY_LEN)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(salt)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return salt

    def store_dir(self, member: str) -> str:
        return os.path.join(self.root_dir, member)

    def join(self, member: str) -> str:
        """Add `member` to the ring; returns its store dir with the
        cell salt pre-seeded (PersistentSigCache honours an existing
        salt file, so the store opens onto the shared keyspace)."""
        d = self.store_dir(member)
        os.makedirs(d, exist_ok=True)
        salt_path = os.path.join(d, "salt")
        if not os.path.exists(salt_path):
            tmp = salt_path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(self._salt)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, salt_path)
        self.ring.add(member)
        return d

    def leave(self, member: str) -> None:
        self.ring.remove(member)

    def shard_owner(self, shard_i: int) -> Optional[str]:
        return self.ring.lookup(f"shard-{shard_i:02d}")

    def owners(self) -> Dict[int, Optional[str]]:
        return {i: self.shard_owner(i) for i in range(self.shards)}

    def handoff_from(
        self,
        departed: str,
        absorb: Callable[[str, str], Optional[dict]],
    ) -> dict:
        """Stream every shard log of `departed` to the shards' current
        owners (call `leave(departed)` first so ownership has already
        moved). One handoff file per receiving member, written into the
        receiver's store dir and absorbed via the `absorb` callable;
        the file is removed after a successful absorb. Returns a
        per-receiver record-count report."""
        src_dir = self.store_dir(departed)
        by_dest: Dict[str, List[str]] = {}
        for i in range(self.shards):
            owner = self.shard_owner(i)
            if owner is None or owner == departed:
                continue
            path = os.path.join(src_dir, "shard-%02d.log" % i)
            if os.path.exists(path):
                by_dest.setdefault(owner, []).append(path)
        report: Dict[str, dict] = {}
        for dest, paths in sorted(by_dest.items()):
            self._handoff_seq += 1
            out = os.path.join(
                self.store_dir(dest),
                "handoff-%s-%03d.log" % (departed, self._handoff_seq),
            )
            n = write_handoff(paths, out)
            _C_HANDOFFS.inc()
            _C_HANDOFF_RECORDS.inc(n)
            _flight.record(
                "cell.handoff", src=departed, dst=dest, records=n,
                shards=len(paths),
            )
            absorbed = absorb(dest, out)
            report[dest] = {
                "records": n,
                "absorbed": absorbed,
                "path": out,
            }
            if absorbed is not None:
                try:
                    os.remove(out)
                except OSError:
                    pass
        return {"departed": departed, "receivers": report,
                "records": sum(r["records"] for r in report.values())}
