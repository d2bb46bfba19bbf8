"""The retry budget of a dispatch.

Port of `DispatchFailed` and `DispatchResilience` of
`bitcoinconsensus_tpu/resilience/degrade.py`: a failed dispatch retries at
most `max_retries` times, within a wall-clock deadline, read through the
sanctioned clock (`utils/profiling.monotonic`).

The reference's degradation ladder (`Ladder`: pallas -> xla -> host, with
quarantine and re-promotion probes) is not ported, by the port's rule:
below the CUDA kernel there is no rung, no XLA program and no host-exact
oracle for a dispatch to be demoted to, so a dispatch that exhausts its
budget raises `DispatchFailed` instead. `ShardLadder` comes with the mesh.
The in-flight queue counts each retry in its verifier's `stats` and in
`consensus_resilience_retries_total{site}` (`RETRIES`, registered here as in
the reference). The ladder's metrics (`consensus_resilience_level`,
`_demotions_total`, `_repromotions_total`, `_probes_total`) are not
registered: the port has no ladder.
"""

from __future__ import annotations

from ..obs import counter as _obs_counter
from ..utils.profiling import monotonic

__all__ = ["DispatchFailed", "DispatchResilience", "RETRIES"]

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
