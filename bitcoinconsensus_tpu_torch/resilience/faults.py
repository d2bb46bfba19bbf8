"""Deterministic, seed-driven fault injection for the dispatch path.

Port of `bitcoinconsensus_tpu/resilience/faults.py`. Every fault the guards
claim to catch is injectable on demand and reproducibly, so a test or
`chip_smoke.py`'s `[chaos]` phase can assert the claim instead of trusting
it:

- **Deterministic.** An injector is a (plan, seed) pair: the same pair fires
  the same faults at the same sites in the same order, and the lanes a
  verdict corruption picks come from a seeded `random.Random`, drawn in the
  reference's order, so one plan and seed corrupt a buffer identically in
  both packages.
- **Bounded.** Every `FaultSpec` carries a `count`; once drained the site
  goes quiet, so a transient fault (`count=1`: a retry succeeds) and a
  persistent one (a count past the retry budget: the dispatch fails) are
  both a matter of choosing `count`.
- **Free when idle.** Every hook's fast path is one module-global read.

Sites of the port (grep for the literal):

    torch_backend.dispatch  raise/timeout at the verifier's launch
    torch_backend.verdict   corrupt the settled verdict buffer
    batch.dispatch          raise where a batch driver dispatches
    sigcache.<label>        a fabricated hit on a cache probe
                            (`sigcache.sig`, `sigcache.script`)
    mesh.dispatch           raise/timeout/device-loss at a sharded launch
    mesh.shard.<i>          per-shard settle of a sharded dispatch: any
                            raise kind (device-loss included), any
                            corruption of shard i's verdict slice, and
                            `straggle` (simulated lag, read by
                            `shard_delay`)
    mesh.probe              raise kinds at a re-promotion probe
    ingress.read            raise at a session's frame read: that one
                            session is torn down (`serving/ingress.py`)
    ingress.write           raise at a response write: that one session
                            is torn down, the retrying client recovers
    sigstore.load           raise at a shard's replay: the shard opens
                            cold (`models/sigstore.py`)
    sigstore.append         raise at a shard-log append: one record goes
                            unpersisted, the verdict path never sees it
    cell.route              raise at the cell router's session read: one
                            client session torn down (`cell/router.py`)

`device-loss` raises `InjectedDeviceLoss`, which the mesh's settle counts
as a per-shard hardware failure feeding its eviction ladder. `fired` counts
the faults fired by (site, kind), and so does
`consensus_resilience_faults_injected_total`.

Host-side policy, never consensus: it reads no clock.
"""

from __future__ import annotations

import random
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs import counter as _obs_counter

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "FaultInjector",
    "InjectedDeviceLoss",
    "InjectedFault",
    "InjectedTimeout",
    "active",
    "corrupt_verdict",
    "inject",
    "maybe_raise",
    "poison_hit",
    "shard_delay",
]

_FAULTS_FIRED = _obs_counter(
    "consensus_resilience_faults_injected_total",
    "chaos-harness faults fired, by site and kind",
    ("site", "kind"),
)

# `corrupt_verdict` consumes the corruption kinds, `maybe_raise` the raise
# kinds, so one plan can arm both on one site.
_RAISE_KINDS = ("raise", "timeout", "device-loss")
_CORRUPT_KINDS = ("invert", "flip", "value", "nan", "garbage", "shape")
_STRAGGLE_KINDS = ("straggle",)


class InjectedFault(RuntimeError):
    """A fault fired by the harness (site and kind in the message)."""

    def __init__(self, site: str, kind: str):
        super().__init__(f"injected {kind} fault at {site}")
        self.site = site
        self.kind = kind


class InjectedTimeout(InjectedFault):
    """An injected dispatch timeout (a type of its own)."""


class InjectedDeviceLoss(InjectedFault):
    """An injected device loss (a type of its own: the mesh's settle counts
    it as a per-shard hardware failure feeding the eviction ladder)."""


@dataclass
class FaultSpec:
    """One armed fault: fire `kind` at `site` up to `count` times.

    kind: "raise" | "timeout" -> maybe_raise sites
          "device-loss"       -> maybe_raise sites (InjectedDeviceLoss)
          "straggle"          -> shard_delay sites report `value` seconds
                                 of simulated shard lag
          "invert"            -> logical NOT of the whole buffer
          "flip"              -> flip `lanes` PRNG-chosen lanes
          "value"             -> set `lanes` lanes to `value` (int32 cast:
                                 a verdict outside {0, 1})
          "nan"               -> set `lanes` lanes to NaN (float32 cast)
          "garbage"           -> the whole buffer PRNG int32 noise
          "shape"             -> the buffer cut short by one lane
          "poison"            -> poison_hit sites report a hit
    """

    site: str
    kind: str
    count: int = 1
    lanes: int = 1
    value: int = 7


class FaultPlan:
    """An ordered set of FaultSpecs; `inject(plan, seed)` arms it."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs = list(specs)

    def __iter__(self):
        return iter(self.specs)


class FaultInjector:
    """An armed plan and its seeded PRNG; tracks each spec's remaining
    fires and counts the fired ones by (site, kind)."""

    def __init__(self, plan: FaultPlan, seed: int = 0):
        self._rng = random.Random(seed)
        self._remaining: List[List] = [[spec, spec.count] for spec in plan]
        self.fired: Dict[tuple, int] = {}

    def _take(self, site: str, kinds) -> Optional[FaultSpec]:
        for ent in self._remaining:
            spec, left = ent
            if left > 0 and spec.site == site and spec.kind in kinds:
                ent[1] = left - 1
                key = (site, spec.kind)
                self.fired[key] = self.fired.get(key, 0) + 1
                _FAULTS_FIRED.inc(site=site, kind=spec.kind)
                return spec
        return None

    def total_fired(self) -> int:
        return sum(self.fired.values())


_active: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _active


@contextmanager
def inject(plan: FaultPlan, seed: int = 0):
    """Arm `plan` for the dynamic extent of the block (not reentrant: one
    plan at a time)."""
    global _active
    if _active is not None:
        raise RuntimeError("a fault plan is already armed")
    inj = FaultInjector(plan, seed=seed)
    _active = inj
    try:
        yield inj
    finally:
        _active = None


def maybe_raise(site: str) -> None:
    """Dispatch-site hook: raises when a raise, timeout or device-loss fault
    is armed."""
    inj = _active
    if inj is None:
        return
    spec = inj._take(site, _RAISE_KINDS)
    if spec is None:
        return
    if spec.kind == "timeout":
        raise InjectedTimeout(site, spec.kind)
    if spec.kind == "device-loss":
        raise InjectedDeviceLoss(site, spec.kind)
    raise InjectedFault(site, spec.kind)


def shard_delay(site: str) -> float:
    """Shard-settle hook: seconds of simulated lag for this shard, 0.0 when
    disarmed (one module-global read). The mesh's settle adds it to the
    shard's observed elapsed time, so an armed `straggle` past the per-shard
    deadline drives the deadline path without sleeping."""
    inj = _active
    if inj is None:
        return 0.0
    spec = inj._take(site, _STRAGGLE_KINDS)
    if spec is None:
        return 0.0
    return float(spec.value)


def poison_hit(site: str) -> bool:
    """Cache-probe hook: True forces a fabricated hit (a poisoned entry)."""
    inj = _active
    if inj is None:
        return False
    return inj._take(site, ("poison",)) is not None


def corrupt_verdict(site: str, arr: np.ndarray) -> np.ndarray:
    """Verdict-buffer hook: a corrupted COPY when armed, else the array
    untouched. It runs before the guards see the buffer, so every kind must
    be caught."""
    inj = _active
    if inj is None:
        return arr
    spec = inj._take(site, _CORRUPT_KINDS)
    if spec is None:
        return arr
    rng = inj._rng
    if spec.kind == "invert":
        return ~np.asarray(arr, dtype=bool)
    if spec.kind == "shape":
        return np.asarray(arr)[:-1]
    if spec.kind == "garbage":
        return np.asarray(
            [rng.randrange(-(2**31), 2**31) for _ in range(len(arr))],
            dtype=np.int32,
        )
    out = np.array(arr)  # a writable copy, of the original dtype
    idxs = [rng.randrange(len(out)) for _ in range(min(spec.lanes, len(out)))]
    if spec.kind == "flip":
        for i in idxs:
            out[i] = not bool(out[i])
        return out
    if spec.kind == "value":
        out = out.astype(np.int32)
        for i in idxs:
            out[i] = spec.value
        return out
    out = out.astype(np.float32)  # nan
    for i in idxs:
        out[i] = np.nan
    return out
