"""Cross-batch signature and script-execution caches.

Bitcoin Core skips re-verifying signatures it already checked at mempool
acceptance: a salted-SHA256-keyed set of (sighash, pubkey, sig) triples
(`script/sigcache.cpp:22-122`) and a second set of whole-input script
successes keyed on wtxid + flags (`validation.cpp:1477-1495,1529-1536`).
Both store successes only, so a cache fault can cost work, never consensus.

- `SigCache`: hits resolve a deferred curve check without a device lane;
  checks verified true are inserted after each dispatch.
- `ScriptExecutionCache`: per-(wtxid, input, flags, spent-outputs) script
  success, probed before interpretation. The spent-outputs digest is in the
  key because callers may supply arbitrary prevouts for the same tx.

Keys are salted per process (`os.urandom`), as the reference salts its
hashers (sigcache.cpp:22-30). A batch's keys are digested in one call of
the native host core (`native_bridge.digest_checks` / `digest_streams`),
byte-equal to `_key`, which stays the spec and serves `engine="python"`.
Storage is a bounded LRU behind a mutex, so concurrent `verify_batch`
calls are safe. The counts keep `hits + misses` equal to the probes and
`insertions - evictions - erases` equal to the entries. Each cache is a
fault site, `sigcache.<label>` (`resilience/faults.py`): an armed `poison`
fault makes one probe report a fabricated hit, what a poisoned entry would
show; `discard_key` drops an entry the batch drivers' audit proved wrong
(`resilience/guards.set_cache_audit`). Port of
`bitcoinconsensus_tpu/models/sigcache.py`, with its public probe and insert
methods (`contains`/`add`, `contains_check`/`add_check`,
`contains_input`/`add_input`), each over `contains_key`/`add_key` so the
poison site, the audit and the counts see every probe, and its telemetry:
lookups, hits, misses, insertions, evictions and erases by `cache` label,
and the entries gauge (`obs/`), published outside the cache's lock and
once per call: the drivers probe and insert a batch's keys in one call
(`contains_keys`, `add_keys`), so the counters move by batch totals.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Iterable, List, Optional, Sequence, Tuple

from .. import native_bridge
from ..obs import counter as _obs_counter
from ..obs import gauge as _obs_gauge
from ..resilience import faults as _faults

__all__ = [
    "SigCache",
    "ScriptExecutionCache",
    "default_sig_cache",
    "default_script_cache",
]

# Cache telemetry by cache role ("sig" / "script"; tests pass labels of
# their own): hits + misses == lookups; insertions - evictions - erases ==
# entries.
_C_LOOKUPS = _obs_counter(
    "consensus_cache_lookups_total", "cache probes", ("cache",)
)
_C_HITS = _obs_counter("consensus_cache_hits_total", "cache hits", ("cache",))
_C_MISSES = _obs_counter(
    "consensus_cache_misses_total", "cache misses", ("cache",)
)
_C_INSERTS = _obs_counter(
    "consensus_cache_insertions_total", "cache insertions", ("cache",)
)
_C_EVICTS = _obs_counter(
    "consensus_cache_evictions_total", "LRU evictions past max_entries",
    ("cache",),
)
_C_ERASES = _obs_counter(
    "consensus_cache_erases_total",
    "erase-on-hit removals (Core's mempool->block pattern)", ("cache",),
)
_C_ENTRIES = _obs_gauge(
    "consensus_cache_entries", "current cache entry count", ("cache",)
)


class _SaltedLRU:
    """Bounded success-set with a per-process salted key digest."""

    def __init__(self, max_entries: int, cache_label: str = "cache"):
        if max_entries <= 0:
            raise ValueError("max_entries must be positive")
        self._salt = os.urandom(32)
        self._max = max_entries
        self._poison_site = "sigcache." + cache_label
        self._set: OrderedDict[bytes, None] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.erases = 0
        self.insertions = 0
        # Bound metric children: plain locked adds on the hot paths.
        lbl = {"cache": cache_label}
        self._m_lookups = _C_LOOKUPS.labels(**lbl)
        self._m_hits = _C_HITS.labels(**lbl)
        self._m_misses = _C_MISSES.labels(**lbl)
        self._m_inserts = _C_INSERTS.labels(**lbl)
        self._m_evicts = _C_EVICTS.labels(**lbl)
        self._m_erases = _C_ERASES.labels(**lbl)
        self._m_entries = _C_ENTRIES.labels(**lbl)

    def _key(self, parts: Iterable[bytes]) -> bytes:
        h = hashlib.sha256(self._salt)
        for p in parts:
            h.update(len(p).to_bytes(4, "little"))
            h.update(p)
        return h.digest()

    def keys_for_parts(self, items: Sequence[Tuple[bytes, ...]],
                       engine: str = "native") -> List[bytes]:
        """`_key` of many part tuples; one native call by default."""
        if native_bridge.use_native(engine):
            return native_bridge.digest_streams(self._salt, items)
        return [self._key(parts) for parts in items]

    def contains_key(self, k: bytes, erase: bool = False) -> bool:
        """Probe by a precomputed digest. A hit refreshes its recency, or
        with `erase` removes the entry (the reference's erase-on-hit of the
        block path). An armed `poison` fault reports a hit and leaves the
        entries as they were."""
        return self.contains_keys((k,), erase=erase)[0]

    def contains_keys(self, keys: Sequence[bytes], erase: bool = False) -> List[bool]:
        """`contains_key` of each key in order, under one lock, with the
        metrics published once for the batch (the drivers' probe loops)."""
        if _faults.active() is None:
            poisoned = None
        else:
            poisoned = [_faults.poison_hit(self._poison_site) for _ in keys]
        out: List[bool] = []
        hits = erased = 0
        with self._lock:
            entries = self._set
            for j, k in enumerate(keys):
                if k in entries:
                    hits += 1
                    if erase:
                        del entries[k]
                        erased += 1
                    else:
                        entries.move_to_end(k)
                    out.append(True)
                elif poisoned is not None and poisoned[j]:
                    hits += 1  # counted as a hit: hits + misses == probes
                    out.append(True)
                else:
                    out.append(False)
            self.hits += hits
            self.misses += len(out) - hits
            self.erases += erased
            size = len(entries)
        # The registry outside the cache's lock: no nested lock order.
        self._m_lookups.inc(len(out))
        if hits:
            self._m_hits.inc(hits)
        if len(out) > hits:
            self._m_misses.inc(len(out) - hits)
        if erased:
            self._m_erases.inc(erased)
            self._m_entries.set(size)
        return out

    def discard_key(self, k: bytes) -> None:
        """Drop an entry proven wrong (the cache audit); nothing where it is
        absent. Counted as an erase."""
        with self._lock:
            present = k in self._set
            if present:
                del self._set[k]
                self.erases += 1
            size = len(self._set)
        if present:
            self._m_erases.inc()
            self._m_entries.set(size)

    def add_key(self, k: bytes) -> None:
        self.add_keys((k,))

    def add_keys(self, keys: Sequence[bytes]) -> None:
        """`add_key` of each key in order, under one lock, with the metrics
        published once for the batch. A re-add of a present key is a
        freshness touch, not an insertion (keeps insertions - evictions -
        erases == entries)."""
        new = evicted = 0
        with self._lock:
            entries = self._set
            for k in keys:
                if k not in entries:
                    new += 1
                entries[k] = None
                entries.move_to_end(k)
                while len(entries) > self._max:
                    entries.popitem(last=False)
                    evicted += 1
            self.evictions += evicted
            self.insertions += new
            size = len(entries)
        if new:
            self._m_inserts.inc(new)
        if evicted:
            self._m_evicts.inc(evicted)
        self._m_entries.set(size)

    def contains(self, parts: Iterable[bytes], erase: bool = False) -> bool:
        """`contains_key` of the salted digest of `parts`."""
        return self.contains_key(self._key(parts), erase=erase)

    def add(self, parts: Iterable[bytes]) -> None:
        """`add_key` of the salted digest of `parts`."""
        self.add_key(self._key(parts))

    def __len__(self) -> int:
        return len(self._set)


class SigCache(_SaltedLRU):
    """Valid-signature set over deferred curve checks (sigcache.cpp:22-122).

    A `SigCheck`'s (kind, data) tuple is flattened into the salted digest."""

    def __init__(self, max_entries: int = 1 << 16, cache_label: str = "sig"):
        super().__init__(max_entries, cache_label=cache_label)

    @staticmethod
    def _parts(kind: str, data: Tuple) -> Tuple[bytes, ...]:
        # Ints serialize at 8 bytes signed; the length-prefixed digest keeps
        # encodings of different widths distinct.
        parts = [kind.encode()]
        for d in data:
            parts.append(
                d if isinstance(d, bytes) else int(d).to_bytes(8, "little", signed=True)
            )
        return tuple(parts)

    def contains_check(self, kind: str, data: Tuple, erase: bool = False) -> bool:
        """Whether the check (kind, data) is a cached success."""
        return self.contains(self._parts(kind, data), erase=erase)

    def add_check(self, kind: str, data: Tuple) -> None:
        """Cache the check (kind, data) as a success."""
        self.add(self._parts(kind, data))

    def keys_for_checks(self, checks, engine: str = "native") -> List[bytes]:
        """Digests for many SigCheck-shaped (kind, data) checks; one native
        call by default."""
        pairs = [(c.kind, c.data) for c in checks]
        if native_bridge.use_native(engine):
            return native_bridge.digest_checks(self._salt, pairs)
        return [self._key(self._parts(k, d)) for k, d in pairs]


class ScriptExecutionCache(_SaltedLRU):
    """Per-input script success keyed on (wtxid, input index, flags,
    spent-outputs digest) — validation.cpp:1529-1536 reshaped to the
    per-input batch API."""

    def __init__(self, max_entries: int = 1 << 15, cache_label: str = "script"):
        super().__init__(max_entries, cache_label=cache_label)

    @staticmethod
    def _parts(
        wtxid: bytes, n_in: int, flags: int, spent_digest: bytes
    ) -> Tuple[bytes, ...]:
        return (
            wtxid,
            n_in.to_bytes(4, "little"),
            flags.to_bytes(4, "little"),
            spent_digest,
        )

    @staticmethod
    def spent_digest(spent_outputs) -> bytes:
        """Digest of the (amount, scriptPubKey) list a caller supplied
        (empty-sentinel for the legacy single-prevout form)."""
        h = hashlib.sha256()
        if spent_outputs is None:
            return b"\x00" * 32
        for amt, spk in spent_outputs:
            h.update(int(amt).to_bytes(8, "little", signed=True))
            h.update(len(spk).to_bytes(4, "little"))
            h.update(spk)
        return h.digest()

    def key_for_input(
        self, wtxid: bytes, n_in: int, flags: int, spent_digest: bytes
    ) -> bytes:
        return self._key(self._parts(wtxid, n_in, flags, spent_digest))

    def contains_input(
        self, wtxid: bytes, n_in: int, flags: int, spent_digest: bytes
    ) -> bool:
        """Whether this input's script run is a cached success."""
        return self.contains(self._parts(wtxid, n_in, flags, spent_digest))

    def add_input(
        self, wtxid: bytes, n_in: int, flags: int, spent_digest: bytes
    ) -> None:
        """Cache this input's script run as a success."""
        self.add(self._parts(wtxid, n_in, flags, spent_digest))


_default_sig: Optional[SigCache] = None
_default_script: Optional[ScriptExecutionCache] = None
_default_lock = threading.Lock()


def default_sig_cache() -> SigCache:
    global _default_sig
    with _default_lock:
        if _default_sig is None:
            _default_sig = SigCache()
        return _default_sig


def default_script_cache() -> ScriptExecutionCache:
    global _default_script
    with _default_lock:
        if _default_script is None:
            _default_script = ScriptExecutionCache()
        return _default_script
