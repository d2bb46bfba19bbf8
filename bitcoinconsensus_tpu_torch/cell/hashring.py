"""Consistent-hash ring: stable key→member placement under churn.

Port of `bitcoinconsensus_tpu/cell/hashring.py`: the same points and the
same placements for the same members and keys.

The cell uses one ring twice — tenants→replicas in the router
(cell/router.py) and sigstore shards→owners in the tier
(cell/sigtier.py). Both need the same property: when a member leaves,
only the keys it owned move (to the next member clockwise), and when it
rejoins, exactly those keys come back. A modulo hash would reshuffle
nearly everything on every membership change, defeating both the warm
sigstore handoff and tenant session affinity.

Deterministic and dependency-free: ring points are the leading 8 bytes
of ``sha256(member '#' vnode)``, so every process in the cell (router,
supervisor, chaos harness, tests) derives the identical placement from
the member names alone — no coordination service, no shared state.

``vnodes`` virtual points per member smooth the key distribution; 64 is
plenty for single-digit member counts (the cell's regime) while keeping
ring rebuilds trivially cheap.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, List, Optional, Tuple

__all__ = ["HashRing"]


def _point(member: str, vnode: int) -> int:
    h = hashlib.sha256(f"{member}#{vnode}".encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big")


class HashRing:
    """Sorted ring of (point, member) pairs with vnode smoothing.

    Not thread-safe: owners (router, tier) rebuild or mutate it under
    their own locks — membership changes are rare and member counts are
    small, so copy-and-swap is the cheap, safe idiom.
    """

    def __init__(self, members: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._members: List[str] = []
        self._points: List[Tuple[int, str]] = []
        for m in members:
            self.add(m)

    @property
    def members(self) -> List[str]:
        return list(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.append(member)
        for v in range(self.vnodes):
            bisect.insort(self._points, (_point(member, v), member))

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.remove(member)
        self._points = [p for p in self._points if p[1] != member]

    def _key_point(self, key: str) -> int:
        h = hashlib.sha256(key.encode("utf-8")).digest()
        return int.from_bytes(h[:8], "big")

    def lookup(self, key: str) -> Optional[str]:
        """Owner of `key`: the first member point clockwise of the key's
        point (wrapping); None on an empty ring."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, (self._key_point(key), "￿"))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def lookup_chain(self, key: str) -> List[str]:
        """Every member, in ring order starting from `key`'s owner —
        the failover preference list (distinct members, each once)."""
        if not self._points:
            return []
        start = bisect.bisect_right(
            self._points, (self._key_point(key), "￿")
        )
        chain: List[str] = []
        n = len(self._points)
        for off in range(n):
            m = self._points[(start + off) % n][1]
            if m not in chain:
                chain.append(m)
                if len(chain) == len(self._members):
                    break
        return chain
