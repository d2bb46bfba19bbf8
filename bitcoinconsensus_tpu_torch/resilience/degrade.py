"""The retry budget of a dispatch.

Port of `DispatchFailed` and `DispatchResilience` of
`bitcoinconsensus_tpu/resilience/degrade.py`: a failed dispatch retries at
most `max_retries` times, within a wall-clock deadline, read through the
sanctioned clock (`utils/profiling.monotonic`).

The reference's degradation ladder (`Ladder`: pallas -> xla -> host, with
quarantine and re-promotion probes) is not ported, by the port's rule:
below the CUDA kernel there is no rung, no XLA program and no host-exact
oracle for a dispatch to be demoted to, so a dispatch that exhausts its
budget raises `DispatchFailed` instead.

`ShardLadder` is the reference's per-device health of an elastic mesh
(`parallel/mesh.py`): `evict_after` consecutive shard failures on one mesh
entry (BITCOINCONSENSUS_TPU_MESH_EVICT_AFTER, 3) evict it, and every
`reprobe_after`-th clean mesh dispatch (16) nominates the longest-evicted
entry for a known-answer re-promotion probe. It keeps the
`consensus_mesh_healthy_devices` gauge and records `shard.evict` and
`shard.repromote` in the flight ring; an eviction also triggers a
`quarantine` dump. The in-flight queue counts each retry in its verifier's `stats` and in
`consensus_resilience_retries_total{site}` (`RETRIES`, registered here as in
the reference). The ladder's metrics (`consensus_resilience_level`,
`_demotions_total`, `_repromotions_total`, `_probes_total`) are not
registered: the port has no ladder.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import counter as _obs_counter
from ..obs import flight as _flight
from ..obs import gauge as _obs_gauge
from ..utils.profiling import monotonic

__all__ = ["DispatchFailed", "DispatchResilience", "RETRIES", "ShardLadder"]

RETRIES = _obs_counter(
    "consensus_resilience_retries_total",
    "dispatch retries after a contained fault",
    ("site",),
)


class DispatchFailed(RuntimeError):
    """A dispatch failed on every attempt its retry budget allowed; the
    last failure is its `__cause__`."""


class DispatchResilience:
    """The retry budget of one verifier."""

    def __init__(self, max_retries: int = 3, retry_deadline_s: float = 2.0):
        self.max_retries = max_retries
        self.retry_deadline_s = retry_deadline_s

    def deadline(self) -> float:
        """The absolute retry deadline of a dispatch starting now."""
        return monotonic() + self.retry_deadline_s

    def may_retry(self, attempts: int, deadline: float) -> bool:
        """Whether another attempt fits: `attempts` made so far, at most
        `max_retries` beyond the first, before `deadline`."""
        return attempts <= self.max_retries and monotonic() < deadline


_SHARD_HEALTH = _obs_gauge(
    "consensus_mesh_healthy_devices",
    "devices currently in the active mesh (evicted devices excluded)",
    ("ladder",),
)


class ShardLadder:
    """Per-entry health of an elastic mesh: evict the sick, re-probe later.

    Each entry of a sharded dispatch is tracked on its own: `evict_after`
    consecutive shard failures (a guard anomaly, a checksum mismatch, a
    straggler deadline, a device loss) convict that entry alone, and the
    mesh's owner rebuilds over the survivors. Every `reprobe_after`-th
    consecutive clean mesh dispatch nominates the longest-evicted entry for
    a known-answer probe. Count-based and clockless: the owner supplies the
    per-shard deadline."""

    def __init__(self, device_ids: Sequence[str], evict_after: Optional[int] = None,
                 reprobe_after: int = 16, min_devices: int = 1):
        if evict_after is None:
            evict_after = int(os.environ.get("BITCOINCONSENSUS_TPU_MESH_EVICT_AFTER", "3"))
        if evict_after < 1:
            raise ValueError("evict_after must be >= 1")
        self.evict_after = evict_after
        self.reprobe_after = reprobe_after
        self.min_devices = min_devices
        self._all: Tuple[str, ...] = tuple(device_ids)
        self._fails: Dict[str, int] = {d: 0 for d in self._all}
        self._evicted: List[str] = []  # oldest first: it re-probes first
        self._clean_streak = 0
        _SHARD_HEALTH.set(len(self._all), ladder="mesh")

    def healthy(self) -> List[str]:
        """The entry ids in the mesh, in their original order."""
        return [d for d in self._all if d not in self._evicted]

    def report_shard(self, device_id: str, ok: bool) -> bool:
        """Record one shard's outcome; True means "evict this entry now".
        Never asks for an eviction that would leave fewer than
        `min_devices` entries."""
        if device_id in self._evicted:
            return False
        if ok:
            self._fails[device_id] = 0
            return False
        self._clean_streak = 0
        self._fails[device_id] = self._fails.get(device_id, 0) + 1
        return (self._fails[device_id] >= self.evict_after
                and len(self.healthy()) > self.min_devices)

    def evict(self, device_id: str) -> None:
        if device_id not in self._evicted:
            self._evicted.append(device_id)
            self._fails[device_id] = 0
            _SHARD_HEALTH.set(len(self.healthy()), ladder="mesh")
            _flight.record("shard.evict", device=device_id,
                           healthy=len(self.healthy()))
            _flight.trigger("quarantine", shard=device_id)

    def note_clean_dispatch(self) -> Optional[str]:
        """Record a fully clean mesh settle: every `reprobe_after`-th in a
        row returns the longest-evicted entry id to probe, else None."""
        if not self._evicted:
            return None
        self._clean_streak += 1
        if self._clean_streak >= self.reprobe_after:
            self._clean_streak = 0
            return self._evicted[0]
        return None

    def repromote(self, device_id: str) -> None:
        if device_id in self._evicted:
            self._evicted.remove(device_id)
            self._fails[device_id] = 0
            _SHARD_HEALTH.set(len(self.healthy()), ladder="mesh")
            _flight.record("shard.repromote", device=device_id,
                           healthy=len(self.healthy()))
