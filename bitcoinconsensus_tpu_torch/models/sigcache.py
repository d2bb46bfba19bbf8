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
`bitcoinconsensus_tpu/models/sigcache.py`; its telemetry counters wait for
the port's `obs/`.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Iterable, List, Optional, Sequence, Tuple

from .. import native_bridge
from ..resilience import faults as _faults

__all__ = [
    "SigCache",
    "ScriptExecutionCache",
    "default_sig_cache",
    "default_script_cache",
]


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
        poisoned = _faults.poison_hit(self._poison_site)
        with self._lock:
            if k in self._set:
                self.hits += 1
                if erase:
                    del self._set[k]
                    self.erases += 1
                else:
                    self._set.move_to_end(k)
                return True
            if poisoned:
                self.hits += 1  # counted as a hit: hits + misses == probes
                return True
            self.misses += 1
            return False

    def discard_key(self, k: bytes) -> None:
        """Drop an entry proven wrong (the cache audit); nothing where it is
        absent. Counted as an erase."""
        with self._lock:
            if k in self._set:
                del self._set[k]
                self.erases += 1

    def add_key(self, k: bytes) -> None:
        with self._lock:
            # A re-add of a present key is a freshness touch, not an
            # insertion (keeps insertions - evictions - erases == entries).
            new = k not in self._set
            self._set[k] = None
            self._set.move_to_end(k)
            while len(self._set) > self._max:
                self._set.popitem(last=False)
                self.evictions += 1
            if new:
                self.insertions += 1

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
