"""Verdict guards: every device return is validated before it is believed.

Port of `bitcoinconsensus_tpu/resilience/guards.py`. The device's answer to
"is this spend valid" is a buffer that crossed a driver, a kernel and a
copy. Before the verifier treats it as a consensus verdict it must pass:

1. **Structural validation** (`validate_verdict`): exactly the dispatched
   lane count, every element finite and in {0, 1}. A truncated buffer, a
   NaN or a 7 raises `VerdictAnomaly`.
2. **Sentinel lanes** (`install_sentinels` / `SentinelSet.check`):
   known-answer checks written into the pad region of each packed dispatch,
   lanes the pad would have wasted anyway. Each is an R = (a + b)·G
   identity with a precomputed verdict (half expect True; half carry a
   target one off R.x and expect False). Templates rotate across
   dispatches, so a stuck or replayed buffer that answers the previous
   dispatch's pattern is caught.
3. **The verdict checksum** (`check_checksum`): the device's (count,
   position-weighted) sums over the verdict buffer, computed on the card
   by the verify launch's own epilogue from the verdicts it stores
   (`ops/verify_tiles.verify_tiles_checked`, per warp, summed on the host;
   `ops/verdict_checksum.py` is the standalone kernel of the same sums),
   against the same sums recomputed from the buffer the host received. Any single-lane
   flip moves the count.

A buffer that fails any of them raises `VerdictAnomaly`; the in-flight
queue retries the dispatch on the same kernel within its budget and then
raises (`resilience/inflight.py`). The port has no host-exact rung to
demote to.

Cache audit (`set_cache_audit`): when armed, the batch drivers re-verify
every signature-cache hit on the exact host oracle and discard entries
proven wrong. Off by default: it re-pays the work the cache skips.

Telemetry, as in the reference where it means something without a host
rung: `consensus_resilience_guard_anomalies_total{site,reason}`,
`_sentinel_lanes_total`, `_sentinel_skipped_total{reason}`,
`_cache_poison_caught_total{cache}` and `_writable_copies_total` (the
verifier's `stats` keep their own counts). Every anomaly is recorded in the
flight ring (`guard.anomaly`), and a checksum mismatch also triggers a
flight dump (`obs/flight.py`, disarmed by default). The reference's
`_contained_total` and `_host_exact_lanes_total` count work demoted to the
host and are not registered: the port has no host rung. Host-side numpy on
materialised buffers only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..crypto import secp_host
from ..crypto.glv import split_lambda
from ..obs import counter as _obs_counter
from ..obs import flight as _flight

__all__ = [
    "CHECKSUM_MOD",
    "SentinelSet",
    "VerdictAnomaly",
    "audit_cache_hits",
    "check_checksum",
    "check_sentinels",
    "ensure_writable",
    "install_sentinels",
    "install_sentinels_at",
    "set_cache_audit",
    "validate_verdict",
    "verdict_checksum_host",
]

GUARD_ANOMALIES = _obs_counter(
    "consensus_resilience_guard_anomalies_total",
    "device verdict buffers rejected by the guards, by site and reason",
    ("site", "reason"),
)
_SENTINEL_LANES = _obs_counter(
    "consensus_resilience_sentinel_lanes_total",
    "known-answer sentinel lanes mixed into device dispatches",
)
_SENTINEL_SKIPPED = _obs_counter(
    "consensus_resilience_sentinel_skipped_total",
    "dispatches that could not carry sentinels (no pad room or "
    "read-only packed buffers), by reason",
    ("reason",),
)
CACHE_POISON_CAUGHT = _obs_counter(
    "consensus_resilience_cache_poison_caught_total",
    "cache hits whose audit re-verification disagreed (entry evicted)",
    ("cache",),
)
_WRITABLE_COPIES = _obs_counter(
    "consensus_resilience_writable_copies_total",
    "packed batches copied host-side so sentinels could be installed "
    "(native prep_pack hands back read-only views)",
)


class VerdictAnomaly(RuntimeError):
    """A device verdict buffer failed validation (reason in `.reason`).
    Raising one is the guards' single choke point: it is counted, recorded
    in the flight ring, and a checksum mismatch triggers a flight dump."""

    def __init__(self, site: str, reason: str, detail: str = ""):
        msg = f"verdict anomaly at {site}: {reason}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.site = site
        self.reason = reason
        GUARD_ANOMALIES.inc(site=site, reason=reason)
        _flight.record("guard.anomaly", site=site, reason=reason, detail=detail)
        if reason == "checksum":
            _flight.trigger("checksum", site=site, detail=detail)


def validate_verdict(arr, n: int, site: str) -> np.ndarray:
    """Validate a materialised verdict buffer of `n` lanes (the padded
    size); return it as bool. Raises `VerdictAnomaly` on a wrong shape, a
    non-finite value or a value outside {0, 1}. A bool buffer is trusted
    once its shape holds."""
    a = np.asarray(arr)
    if a.ndim != 1 or a.shape[0] != n:
        raise VerdictAnomaly(site, "shape", f"got {a.shape}, want ({n},)")
    if a.dtype == np.bool_:
        return a
    if np.issubdtype(a.dtype, np.floating):
        if not np.isfinite(a).all():
            raise VerdictAnomaly(site, "nonfinite")
    elif not np.issubdtype(a.dtype, np.integer):
        raise VerdictAnomaly(site, "dtype", str(a.dtype))
    in_domain = (a == 0) | (a == 1)
    if not in_domain.all():
        raise VerdictAnomaly(
            site, "domain", f"{int((~in_domain).sum())} lanes outside {{0,1}}"
        )
    return a != 0


# --- sentinel lanes ---------------------------------------------------------
#
# Each template is a fully packed lane (the 128-byte field block and the
# flags) and its expected verdict: R = a·G + b·G against the target t1,
# with t1 = ((a + b)·G).x for an expect-True lane and that x plus one for
# an expect-False lane. b ships GLV-split like a real lane's, so sentinels
# run the kernel's split, digit and ladder path.

_SENTINEL_SCALARS = ((2, 3, True), (5, 7, False), (11, 13, True), (17, 19, False))
_templates: Optional[List[Tuple[bytes, int, int, int, int, int, bool]]] = None


def _sentinel_templates():
    """The packed sentinel rows, built once per process (host EC math)."""
    global _templates
    if _templates is not None:
        return _templates
    rows = []
    for a, b, expect in _SENTINEL_SCALARS:
        aff = secp_host.G.mul((a + b) % secp_host.N).to_affine()
        rx = aff[0]
        t1 = rx if expect else (rx + 1) % secp_host.P
        b1, neg1, b2, neg2 = split_lambda(b)
        raw = (
            a.to_bytes(32, "little")
            + b1.to_bytes(16, "little")
            + b2.to_bytes(16, "little")
            + secp_host.G_X.to_bytes(32, "little")
            + t1.to_bytes(32, "little")
        )
        want_odd = secp_host.G_Y & 1
        rows.append((raw, want_odd, -1, 0, neg1, neg2, expect))
    _templates = rows
    return rows


class SentinelSet:
    """Positions and expected verdicts of the sentinels of one dispatch."""

    __slots__ = ("positions", "expected")

    def __init__(self, positions: List[int], expected: List[bool]):
        self.positions = np.asarray(positions, dtype=np.int64)
        self.expected = np.asarray(expected, dtype=bool)

    def check(self, ok: np.ndarray, needs: Optional[np.ndarray], site: str) -> None:
        """Compare the sentinels' verdicts with their expectations; raise
        on a mismatch. A lane the kernel flagged `needs_host` reports False
        whatever its answer, so flagged sentinels are left out."""
        got = np.asarray(ok, dtype=bool)[self.positions]
        exp = self.expected
        if needs is not None:
            usable = ~np.asarray(needs, dtype=bool)[self.positions]
            got, exp = got[usable], exp[usable]
        if not np.array_equal(got, exp):
            raise VerdictAnomaly(
                site,
                "sentinel",
                f"expected {exp.tolist()}, got {got.tolist()}",
            )


_rotation = 0


def _writable(a) -> bool:
    return getattr(a, "flags", None) is not None and a.flags.writeable


def ensure_writable(args: Tuple) -> Tuple[Tuple, bool]:
    """`(args, copied)` with every packed buffer writable: read-only
    buffers are copied once, writable ones pass through untouched."""
    if all(_writable(a) for a in args):
        return args, False
    _WRITABLE_COPIES.inc()
    return tuple(np.array(a) for a in args), True


def install_sentinels(
    args: Tuple, n: int, rotation: Optional[int] = None
) -> Optional[SentinelSet]:
    """Write sentinel lanes into the pad region of a packed batch, in place.

    `args` is the verifier's packed 7-tuple (fields, want_odd, parity,
    has_t2, neg1, neg2, valid); `n` is the real lane count, so rows
    [n, size) are pad. The starting template advances by one on every call
    (a process-wide counter); `rotation` pins it. Returns the SentinelSet to
    check at settle, or None where the batch has no pad room or a buffer is
    read-only."""
    fields = args[0]
    size = int(fields.shape[0])
    room = size - n
    if room <= 0:
        _SENTINEL_SKIPPED.inc(reason="no_pad_room")
        return None
    k = min(room, len(_sentinel_templates()))
    return install_sentinels_at(args, list(range(n, n + k)), rotation)


def install_sentinels_at(
    args: Tuple, positions: Sequence[int], rotation: Optional[int] = None
) -> Optional[SentinelSet]:
    """Write sentinel lanes at explicit rows, in place (templates cycle
    across `positions`, the rotation as in `install_sentinels`). Returns
    None where a buffer is read-only."""
    global _rotation
    fields, want_odd, parity, has_t2, neg1, neg2, valid = args
    if not all(_writable(a) for a in args):
        _SENTINEL_SKIPPED.inc(reason="readonly")
        return None
    templates = _sentinel_templates()
    if rotation is None:
        rotation = _rotation
        _rotation = (_rotation + 1) % len(templates)
    out_pos, expected = [], []
    for i, pos in enumerate(positions):
        raw, w, par, h2, n1, n2, exp = templates[(rotation + i) % len(templates)]
        fields[pos] = np.frombuffer(raw, dtype=np.uint8).reshape(4, 32)
        want_odd[pos] = w
        parity[pos] = par
        has_t2[pos] = h2
        neg1[pos] = n1
        neg2[pos] = n2
        valid[pos] = True
        out_pos.append(int(pos))
        expected.append(exp)
    _SENTINEL_LANES.inc(len(out_pos))
    return SentinelSet(out_pos, expected)


def check_sentinels(
    sset: Optional[SentinelSet],
    ok: np.ndarray,
    needs: Optional[np.ndarray],
    site: str,
) -> None:
    """`sset.check`, and nothing for a dispatch without sentinels."""
    if sset is not None:
        sset.check(ok, needs, site)


# --- verdict checksum -------------------------------------------------------
#
# (sum of lanes, sum of lane·weight) with weight[i] = i % CHECKSUM_MOD + 1,
# computed on the card over the in-flight verdict buffer and again here
# over the buffer the host received. The weighted sum stays below 252·B,
# within int32 on the card up to about 8.5M lanes.

CHECKSUM_MOD = 251


def verdict_checksum_host(ok: np.ndarray) -> Tuple[int, int]:
    """The host's recomputation of the device verdict checksum (int64)."""
    v = np.asarray(ok).astype(np.int64)
    w = np.arange(v.shape[0], dtype=np.int64) % CHECKSUM_MOD + 1
    return int(v.sum()), int((v * w).sum())


def check_checksum(
    device_sums: Optional[Tuple[int, int]], ok: np.ndarray, site: str
) -> None:
    """Compare the device's (count, weighted) pair with the sums of the
    materialised buffer; None means the dispatch carried no checksum.
    Raises `VerdictAnomaly(reason="checksum")` on a mismatch."""
    if device_sums is None:
        return
    count, wsum = verdict_checksum_host(ok)
    dev = (int(device_sums[0]), int(device_sums[1]))
    if dev != (count, wsum):
        raise VerdictAnomaly(
            site, "checksum", f"device {dev} vs host {(count, wsum)}"
        )


# --- cache audit mode -------------------------------------------------------

_audit_cache = False


def set_cache_audit(on: bool) -> None:
    """Arm or disarm the audit of signature-cache hits: when armed, the
    batch drivers re-verify every hit on the exact host oracle and discard
    entries that disagree."""
    global _audit_cache
    _audit_cache = bool(on)


def audit_cache_hits() -> bool:
    return _audit_cache
