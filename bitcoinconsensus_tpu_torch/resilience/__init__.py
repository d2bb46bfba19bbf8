"""Fault containment of the dispatch path.

Port of `bitcoinconsensus_tpu/resilience/`. The reference verifier is
fail-closed by construction: a pure function whose every anomaly is a
REJECT. A device path has failure modes it never had: a corrupted verdict
buffer, a launch that fails, a poisoned cache entry. Here they cost a retry
or an exception, never a verdict:

- ``faults``: the deterministic, seeded fault-injection harness, with its
  sites in `crypto/torch_backend.py` (`torch_backend.dispatch`,
  `torch_backend.verdict`), `models/batch.py` (`batch.dispatch`),
  `models/sigcache.py` (`sigcache.<label>`) and `parallel/mesh.py`
  (`mesh.dispatch`, `mesh.shard.<i>`, `mesh.probe`). Disarmed, each hook
  is one module-global read.
- ``guards``: every device return is validated (shape, domain,
  finiteness), checked on its known-answer sentinel lanes and against the
  device verdict checksum (the checked verify launch's epilogue,
  `ops/verify_tiles.verify_tiles_checked`); and the opt-in audit
  of signature-cache hits.
- ``degrade``: the retry budget (`DispatchResilience`), `DispatchFailed`,
  and the mesh's per-entry health (`ShardLadder`: eviction and
  re-promotion probes).
- ``inflight``: the in-flight queue. Every dispatch of
  `TorchSecpVerifier` returns a ticket; every ticket settles through the
  guards and the retry budget before a verdict is believed, and raises
  `DispatchFailed` where no attempt passes.

Deliberate divergence from the reference: no degradation ladder
(`Ladder`). Below the CUDA kernel the port has no rung, no XLA program and
no host-exact oracle, so a dispatch whose retries are spent raises instead
of landing on the host. Host-side policy only: nothing here runs on the
card, and time is read through `utils/profiling.monotonic`.
"""

from .degrade import DispatchFailed, DispatchResilience
from .faults import FaultPlan, FaultSpec, InjectedFault, InjectedTimeout, inject
from .guards import VerdictAnomaly, install_sentinels, set_cache_audit, validate_verdict
from .inflight import InflightQueue, Ticket, settle_array

# The reference's names (`bitcoinconsensus_tpu/resilience/__init__.py`) but
# `Ladder`, then the port's own.
__all__ = [
    "DispatchResilience",
    "FaultPlan",
    "FaultSpec",
    "InflightQueue",
    "InjectedFault",
    "InjectedTimeout",
    "Ticket",
    "VerdictAnomaly",
    "inject",
    "install_sentinels",
    "set_cache_audit",
    "settle_array",
    "validate_verdict",

    "DispatchFailed",
]
