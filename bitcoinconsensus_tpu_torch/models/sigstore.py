"""Crash-safe persistent signature cache: hot RAM tier over shard logs.

Port of `bitcoinconsensus_tpu/models/sigstore.py`, with the reference's
on-disk format byte for byte (37-byte records, the `salt` file, the
`shard-NN.log` names), so a store written by either package opens warm in
the other.

`SigCache` (models/sigcache.py) is what repeat traffic pays for (most
inputs a node sees re-verify signatures it already checked at mempool
acceptance), but it evaporates on every restart, forcing a cold device
warm-up exactly when a recovering server is most fragile.
`PersistentSigCache` promotes it to a sharded two-tier store:

- **Hot tier**: the inherited bounded LRU (`_SaltedLRU`), sized by
  `hot_entries` — recency-ordered, probe-first.
- **Disk tier**: per-shard append-only record logs under `store_dir`,
  replayed (mmap) into an in-memory key index at open. Shard affinity
  is the key's leading digest byte, so concurrent appends from sharded
  servers never contend on one file and compaction is per-shard.

The batched seam: the port's drivers probe and insert a batch's keys in
one call (`contains_keys`, `add_keys`), and the base class's single-key
methods delegate to those, so this store overrides the batched methods
(and `discard_key`): every probe and insert of `verify_batch` reaches the
disk tier. The persisted salt is loaded (or created on disk) in
`__init__`, before any digest: the native driver hashes cache keys in C++
with `_salt`, and a salt that changed on restart would leave every
persisted key unreachable without a word.

Durability contract (the crash-safety story, mirrored from WAL
recovery): every record is fixed-width and CRC-checksummed
(`op ‖ key ‖ crc32(op ‖ key)`), a call's appends are written and flushed
to the OS before it returns, one write a shard (kill -9 loses nothing
already flushed; only the torn tail of an in-progress append is at
risk), and replay is truncation-tolerant —
it stops at the first short or checksum-failing record, truncates the
log back to the last good boundary, and counts what it skipped. A
corrupt byte can therefore cost cache *misses*, never a wrong hit from
a mangled key.

Integrity contract (fail-closed, the cache audit of
`resilience/guards.set_cache_audit`): the salt is
persisted with the store, so persisted entries stay addressable across
restarts — and a *poisoned* persisted entry (wrong key on disk, however
it got there) is exactly what `resilience.set_cache_audit(True)` exists
for: both batch drivers re-verify cache hits exactly on the host and
call `discard_key` on disagreement, which here also appends a
tombstone record so the poison cannot resurrect on the next restart.
The store itself never turns a miss into a hit: all it can fabricate
is extra work.

Chaos sites (resilience/faults.py): `sigstore.load` (a replay fault
leaves that shard cold — contained, counted) and `sigstore.append` (a
failed append costs persistence of one entry, never correctness).
Swept on the card by `chip_smoke.py`'s `[sigstore]` phase.

Env knobs: ``BITCOINCONSENSUS_TPU_SIGSTORE_DIR`` (store directory for
`sig_store_from_env`), ``BITCOINCONSENSUS_TPU_SIGSTORE_HOT_ENTRIES``
(hot-tier LRU bound, default 65536).

This module is consensus-adjacent host code (models/): the host AST
lint applies in full — integer arithmetic only, no entropy imports, and
the one sanctioned clock is `obs.monotonic` (warm-up gauge).
"""

from __future__ import annotations

import mmap
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import counter as _obs_counter
from ..obs import gauge as _obs_gauge
from ..obs import monotonic as _monotonic
from ..resilience import faults as _faults
from .sigcache import SigCache

__all__ = ["PersistentSigCache", "ShardLog", "sig_store_from_env"]

# Record layout: 1-byte op + 32-byte key + 4-byte little-endian CRC32
# over (op ‖ key). Fixed width makes torn-tail detection a length check.
_OP_ADD = b"A"
_OP_DEL = b"D"
_KEY_LEN = 32
_CRC_LEN = 4
_REC_LEN = 1 + _KEY_LEN + _CRC_LEN

# Compaction: rewrite a shard once its log carries this many dead
# records (duplicates + tombstones) beyond the live set — amortized
# O(1) appends, bounded disk growth.
_COMPACT_SLACK = 64

_S_HITS = _obs_counter(
    "consensus_sigstore_hits_total",
    "persistent sigstore hits, by serving tier",
    ("tier",),
)
_S_MISSES = _obs_counter(
    "consensus_sigstore_misses_total", "persistent sigstore misses"
)
_S_TIER = _obs_gauge(
    "consensus_sigstore_tier_entries",
    "current persistent-sigstore entry count, by tier",
    ("tier",),
)
_S_WARMUP = _obs_gauge(
    "consensus_sigstore_warmup_seconds",
    "time from store open to a 90% rolling hit rate (restart warm-up)",
)
_S_REPLAY = _obs_counter(
    "consensus_sigstore_replay_records_total",
    "records applied from shard logs at store open",
)
_S_REPLAY_SKIP = _obs_counter(
    "consensus_sigstore_replay_skipped_total",
    "replay records skipped fail-closed, by reason",
    ("reason",),
)
_S_APPENDS = _obs_counter(
    "consensus_sigstore_appends_total", "records appended to shard logs"
)
_S_APPEND_ERRORS = _obs_counter(
    "consensus_sigstore_append_errors_total",
    "failed shard-log appends (entry stays unpersisted; contained)",
)
_S_COMPACTIONS = _obs_counter(
    "consensus_sigstore_compactions_total", "shard-log compaction rewrites"
)
_S_SHARD_MOVED = _obs_counter(
    "consensus_sigstore_shard_moved_total",
    "shard backing files found missing mid-run (ownership moved away); "
    "the shard restarts cold, the verify path never sees an error",
)


def _rec(op: bytes, key: bytes) -> bytes:
    body = op + key
    return body + zlib.crc32(body).to_bytes(_CRC_LEN, "little")


class ShardLog:
    """One shard's append-only record log (crash-safe, compactable).

    Not thread-safe on its own: `PersistentSigCache` serializes every
    call under its store lock."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None  # append handle, opened lazily

    def _handle(self):
        if self._fh is None:
            self._fh = open(self.path, "ab")
        return self._fh

    def append(self, op: bytes, key: bytes) -> None:
        """Append one record and flush to the OS: a kill -9 after this
        returns loses nothing (only power loss can — by design we never
        fsync per record; compaction fsyncs its rewrite)."""
        self.append_records([_rec(op, key)])

    def append_records(self, recs: Sequence[bytes]) -> None:
        """Append encoded records in one write and flush to the OS, with
        `append`'s guarantee once it returns; a kill -9 during the write
        leaves a torn tail that replay heals to the last whole record."""
        fh = self._handle()
        fh.write(b"".join(recs))
        fh.flush()

    def replay_into(self, out: Dict[bytes, None]) -> Tuple[int, int]:
        """Apply every intact record to `out`; returns (applied, skipped).

        Truncation-tolerant, fail-closed: replay stops at the first
        short, checksum-failing, or unknown-op record and truncates the
        file back to the last good boundary — everything past a corrupt
        byte is untrusted (it may be a torn write), and losing it costs
        misses, never wrong hits."""
        if not os.path.exists(self.path):
            return 0, 0
        size = os.path.getsize(self.path)
        if size == 0:
            return 0, 0
        applied = 0
        skipped = 0
        pos = 0
        with open(self.path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            try:
                while pos + _REC_LEN <= size:
                    rec = mm[pos : pos + _REC_LEN]
                    body = rec[: 1 + _KEY_LEN]
                    crc = int.from_bytes(rec[1 + _KEY_LEN :], "little")
                    if zlib.crc32(body) != crc:
                        skipped += 1
                        _S_REPLAY_SKIP.inc(reason="checksum")
                        break
                    op, key = body[:1], body[1:]
                    if op == _OP_ADD:
                        out[key] = None
                    elif op == _OP_DEL:
                        out.pop(key, None)
                    else:
                        skipped += 1
                        _S_REPLAY_SKIP.inc(reason="bad_op")
                        break
                    applied += 1
                    pos += _REC_LEN
            finally:
                mm.close()
        if pos < size:
            if skipped == 0:  # clean prefix + short tail = torn append
                skipped += 1
                _S_REPLAY_SKIP.inc(reason="torn_tail")
            os.truncate(self.path, pos)
        return applied, skipped

    def compact(self, live: Dict[bytes, None]) -> None:
        """Atomically rewrite the log as one ADD record per live key:
        tmp file, fsync, rename — a crash at any point leaves either
        the old log or the new one, never a mix."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            for key in live:
                fh.write(_rec(_OP_ADD, key))
            fh.flush()
            os.fsync(fh.fileno())
        self.close()
        os.replace(tmp, self.path)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class PersistentSigCache(SigCache):
    """Two-tier `SigCache`: hot LRU over replayed per-shard disk logs.

    Drop-in for `SigCache` anywhere the batch drivers take one —
    `contains_keys` / `add_keys` (and through them `contains_key` /
    `add_key`), `discard_key` and `keys_for_checks` all keep their
    contracts, including the audit-mode poison-eviction path
    (`discard_key` additionally appends a tombstone so an evicted entry
    stays evicted across restarts). The salt is persisted with the
    store; entries remain non-addressable without the store directory.
    """

    def __init__(
        self,
        store_dir: str,
        hot_entries: Optional[int] = None,
        shards: int = 8,
        cache_label: str = "sig",
        warmup_min_probes: int = 16,
    ):
        if hot_entries is None:
            raw = os.environ.get(
                "BITCOINCONSENSUS_TPU_SIGSTORE_HOT_ENTRIES", ""
            )
            hot_entries = int(raw) if raw else 1 << 16
        assert shards >= 1
        super().__init__(max_entries=hot_entries, cache_label=cache_label)
        self.store_dir = store_dir
        self._shards = shards
        os.makedirs(store_dir, exist_ok=True)
        self._salt = self._load_salt()
        self._logs: List[ShardLog] = [
            ShardLog(os.path.join(store_dir, "shard-%02d.log" % i))
            for i in range(shards)
        ]
        # Disk-tier index: every persisted key, by shard. The hot tier
        # (inherited `_set`) is a bounded recency view over this.
        self._cold: List[Dict[bytes, None]] = [{} for _ in range(shards)]
        # Records currently in each shard file, live or dead — drives
        # the compaction trigger.
        self._records: List[int] = [0] * shards
        self._entries = 0
        self._closed = False
        self.replay_applied = 0
        self.replay_skipped = 0
        self._replay()
        # Warm-up clock: time from open until the rolling hit rate over
        # this instance's probes reaches 90% (integer cross-multiply; the
        # probe floor keeps one lucky hit from declaring warmth).
        self._warm_floor = warmup_min_probes
        self._opened = _monotonic()
        self._probes_since_open = 0
        self._hits_since_open = 0
        self.warmup_s: Optional[object] = None
        self._m_hit_hot = _S_HITS.labels(tier="hot")
        self._m_hit_cold = _S_HITS.labels(tier="cold")
        self._set_tier_gauges()

    # -- persistence ---------------------------------------------------

    def _load_salt(self) -> bytes:
        """Load (or atomically create) the store's persisted salt —
        the property that makes persisted digests meaningful across
        restarts while keeping entries non-addressable offline."""
        path = os.path.join(self.store_dir, "salt")
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

    def _replay(self) -> None:
        """Warm the disk-tier index from the shard logs. A shard whose
        replay faults (`sigstore.load` site, or real I/O failure) starts
        cold — contained and counted, never propagated: a cache that
        cannot load is an empty cache, not a broken verifier."""
        for i, log in enumerate(self._logs):
            try:
                _faults.maybe_raise("sigstore.load")
                applied, skipped = log.replay_into(self._cold[i])
            except (OSError, _faults.InjectedFault):
                self._cold[i].clear()
                _S_REPLAY_SKIP.inc(reason="load_error")
                self.replay_skipped += 1
                continue
            self._records[i] = applied
            self.replay_applied += applied
            self.replay_skipped += skipped
            if applied:
                _S_REPLAY.inc(applied)
        self._entries = sum(len(c) for c in self._cold)
        self.insertions = self._entries  # replayed entries count as inserted

    def _shard_of(self, k: bytes) -> int:
        return k[0] % self._shards

    def _append(self, shard_i: int, op: bytes, keys: Sequence[bytes]) -> None:
        """Fault-guarded log append of one record per key, written and
        flushed in one call: a failure (injected or real) costs
        persistence of those records, never the in-RAM verdict path. The
        `sigstore.append` site is asked once a record, as the reference
        asks it, so a fault drops exactly the records it fires on."""
        recs = []
        for key in keys:
            try:
                _faults.maybe_raise("sigstore.append")
            except _faults.InjectedFault:
                _S_APPEND_ERRORS.inc()
                continue
            recs.append(_rec(op, key))
        if not recs:
            return
        try:
            self._logs[shard_i].append_records(recs)
        except FileNotFoundError:
            # The shard's backing directory vanished: ownership moved
            # away under the cell's handoff. Restart the shard cold —
            # reads miss and recompute (fail-closed), nothing raises
            # into the verify path.
            self._shard_moved_locked(shard_i)
            return
        except OSError:
            _S_APPEND_ERRORS.inc(len(recs))
            return
        self._records[shard_i] += len(recs)
        _S_APPENDS.inc(len(recs))
        live = len(self._cold[shard_i])
        if self._records[shard_i] > 2 * live + _COMPACT_SLACK:
            try:
                self._logs[shard_i].compact(self._cold[shard_i])
            except FileNotFoundError:
                self._shard_moved_locked(shard_i)
                return
            except OSError:
                _S_APPEND_ERRORS.inc()
                return
            self._records[shard_i] = live
            _S_COMPACTIONS.inc()

    def _shard_moved_locked(self, shard_i: int) -> None:
        """Treat one shard as moved-away: drop its entries from both
        tiers (it must not keep answering hits for keys whose records
        now live elsewhere), close the stale handle, count it."""
        _S_SHARD_MOVED.inc()
        self._logs[shard_i].close()
        gone = self._cold[shard_i]
        self._cold[shard_i] = {}
        self._entries -= len(gone)
        self._records[shard_i] = 0
        for k in gone:
            self._set.pop(k, None)
        self._set_tier_gauges()

    def _set_tier_gauges(self) -> None:
        _S_TIER.set(len(self._set), tier="hot")
        _S_TIER.set(self._entries, tier="cold")

    # -- cache contract ------------------------------------------------
    #
    # The port's drivers probe and insert a batch's keys in one call
    # (`contains_keys`, `add_keys`; models/batch.py), and the base class's
    # single-key methods delegate to those, so the batched methods are
    # the seam this store overrides: every probe and insert of
    # `verify_batch`, `verify_batch_stream` and `connect_block` reaches
    # the disk tier through them. `discard_key` (the audit's eviction) is
    # single-key in both packages.

    def contains_keys(self, keys: Sequence[bytes],
                      erase: bool = False) -> List[bool]:
        """`contains_key` of each key in order, under one lock: a hot hit
        refreshes recency, a cold hit promotes the key into the hot LRU,
        `erase` evicts a hit from both tiers and tombstones it on disk. An
        armed `poison` fault reports a hit and changes nothing, as in the
        base class. Counts and metrics move once for the batch."""
        if _faults.active() is None:
            poisoned = None
        else:
            poisoned = [_faults.poison_hit(self._poison_site) for _ in keys]
        out: List[bool] = []
        hits = hot_hits = cold_hits = erased = 0
        warm = False
        dels: Dict[int, List[bytes]] = {}
        with self._lock:
            hot = self._set
            for j, k in enumerate(keys):
                shard_i = self._shard_of(k)
                tier = None
                if k in hot:
                    tier = "hot"
                    if not erase:
                        hot.move_to_end(k)
                elif k in self._cold[shard_i]:
                    tier = "cold"
                    if not erase:  # promote: recency now lives in the hot LRU
                        hot[k] = None
                        while len(hot) > self._max:
                            hot.popitem(last=False)
                present = tier is not None
                hit = present or (poisoned is not None and poisoned[j])
                if present:
                    if tier == "hot":
                        hot_hits += 1
                    else:
                        cold_hits += 1
                    if erase:
                        self._evict_locked(k)
                        erased += 1
                        dels.setdefault(shard_i, []).append(k)
                if hit:
                    hits += 1
                    self._hits_since_open += 1
                self._probes_since_open += 1
                if (
                    self.warmup_s is None
                    and self._probes_since_open >= self._warm_floor
                    and 10 * self._hits_since_open
                    >= 9 * self._probes_since_open
                ):
                    self.warmup_s = _monotonic() - self._opened
                    warm = True
                out.append(hit)
            self.hits += hits
            self.misses += len(out) - hits
            self.erases += erased
            for shard_i, ks in dels.items():
                self._append(shard_i, _OP_DEL, ks)
            self._set_tier_gauges()
            entries = self._entries
        # Registry updates outside the store lock, like the base class.
        misses = len(out) - hits
        self._m_lookups.inc(len(out))
        if hits:
            self._m_hits.inc(hits)
        if hot_hits:
            self._m_hit_hot.inc(hot_hits)
        if cold_hits:
            self._m_hit_cold.inc(cold_hits)
        if erased:
            self._m_erases.inc(erased)
            self._m_entries.set(entries)
        if misses:
            self._m_misses.inc(misses)
            _S_MISSES.inc(misses)
        if warm:
            _S_WARMUP.set(self.warmup_s)
        return out

    def add_keys(self, keys: Sequence[bytes]) -> None:
        """`add_key` of each key in order, under one lock: the key becomes
        most recent in the hot tier, and a key new to its shard is
        appended to that shard's log (one write a shard for the call).
        Hot-tier overflow only demotes recency: the key stays in the disk
        tier, so it is not an eviction."""
        new = 0
        adds: Dict[int, List[bytes]] = {}
        with self._lock:
            hot = self._set
            for k in keys:
                shard_i = self._shard_of(k)
                shard = self._cold[shard_i]
                hot[k] = None
                hot.move_to_end(k)
                while len(hot) > self._max:
                    hot.popitem(last=False)
                if k not in shard:
                    shard[k] = None
                    self.insertions += 1
                    self._entries += 1
                    new += 1
                    adds.setdefault(shard_i, []).append(k)
            for shard_i, ks in adds.items():
                self._append(shard_i, _OP_ADD, ks)
            self._set_tier_gauges()
            entries = self._entries
        if new:
            self._m_inserts.inc(new)
        self._m_entries.set(entries)

    def discard_key(self, k: bytes) -> None:
        """Drop a proven-wrong entry from BOTH tiers and tombstone it on
        disk — the audit-mode containment path (resilience/guards.py):
        a poisoned persisted entry must stay evicted across restarts."""
        with self._lock:
            present = self._evict_locked(k)
            if present:
                self.erases += 1
                self._append(self._shard_of(k), _OP_DEL, [k])
            self._set_tier_gauges()
            entries = self._entries
        if present:
            self._m_erases.inc()
            self._m_entries.set(entries)

    def peek_key(self, k: bytes) -> bool:
        """Presence check with NO side effects: no probe/hit accounting,
        no LRU promotion, no metrics. For measurement surfaces (the cell
        control channel's tombstone audit) that must not pollute the
        warm-rate statistics they are trying to read."""
        with self._lock:
            return k in self._set or k in self._cold[self._shard_of(k)]

    def _evict_locked(self, k: bytes) -> bool:
        """Remove `k` from both in-RAM tiers; True when it was present."""
        self._set.pop(k, None)
        shard = self._cold[self._shard_of(k)]
        if k in shard:
            del shard[k]
            self._entries -= 1
            return True
        return False

    def __len__(self) -> int:
        # The store's size is the disk tier (hot is a subset view); the
        # batch driver's cold-cache shortcut keys off this.
        return self._entries

    # -- lifecycle -----------------------------------------------------

    def flush(self) -> None:
        """fsync every shard log (tests / checkpoint barriers)."""
        with self._lock:
            for i, log in enumerate(self._logs):
                if log._fh is None:
                    continue
                try:
                    log._fh.flush()
                    os.fsync(log._fh.fileno())
                except FileNotFoundError:
                    self._shard_moved_locked(i)
                except OSError:
                    _S_APPEND_ERRORS.inc()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for log in self._logs:
                log.close()

    def __enter__(self) -> "PersistentSigCache":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def sig_store_from_env(**kw) -> Optional[PersistentSigCache]:
    """Open the persistent store named by
    ``BITCOINCONSENSUS_TPU_SIGSTORE_DIR``; None when unset (callers fall
    back to the in-RAM `SigCache`)."""
    store_dir = os.environ.get("BITCOINCONSENSUS_TPU_SIGSTORE_DIR", "")
    if not store_dir:
        return None
    return PersistentSigCache(store_dir, **kw)
