"""Batched signature verification on one device: ECDSA, Schnorr and taproot
tweak checks in one mixed dispatch.

The port of `bitcoinconsensus_tpu/crypto/jax_backend.py`. All three check
kinds reduce to R = a·G + b·P compared against a target:

    kind      a        b      P            accept
    ECDSA     m/s      r/s    pubkey       R.x ∈ {r, r+n} (mod p)
    Schnorr   s        n-e    lift_x(pk)   R.x == r and even(R.y)
    tweak     t        1      lift_x(pki)  R.x == out_x and parity matches

The host parses and range-checks each check, inverts the ECDSA s values in
one batch mod n, hashes the BIP340 challenges (or, on the Python engine with
`device_challenge`, has the card hash every challenge of a call in one
launch of `ops/sha256.bip340_challenge`), splits b by the GLV
endomorphism and packs each lane as 4 x 32 bytes plus 6 flags: in one call
of the native host core (`native_bridge.prep_pack`) by default, or with
`engine="python"` through `_prep_lanes` / `_pack_lanes`, the spec the core
is held to byte for byte. The device side is
`ops/verify_tiles.verify_tiles_checked`: the hand-written CUDA kernel on a
card, its plain torch version on the CPU. Lanes the kernel
flags `needs_host` (an equal-points case of its fast additions, reached
only by crafted scalars) are resolved exactly by the host oracle
`crypto/secp_host.py` (or its native counterpart, `NativeSecp`); that
fixup is part of the kernel's contract.

Every dispatch is guarded, as in the reference (`resilience/`): it goes
through the verifier's in-flight queue, which stages the packed lanes,
writes known-answer sentinel lanes into their pad region, and launches the
checked verify kernel (`ops/verify_tiles.verify_tiles_checked`): one
kernel that writes the verdicts and, as its epilogue, the verdict
checksum's per-warp partials (the sums of `ops/verdict_checksum.py`;
BITCOINCONSENSUS_TPU_CHECKSUM=0 leaves the partials out, the lane program
alone in the same launch). At settle it validates the verdict buffers,
the sentinels and the checksum before a verdict is returned. A failed
guard or launch is retried on the same kernel within the budget
(`resilience/degrade.py`) and then raises `DispatchFailed`; nothing falls
back to the host.

Telemetry, as in the reference (`obs/`): checks by kind, dispatches by
backend (`cuda` for the kernel, `torch` for the plain version on the CPU),
real and padded lanes, the last dispatch's fill ratio, dispatches at a
padded width new to the verifier (each stages new pinned buffers on a
card), and host fixups. Each launch runs inside `region_scope("dispatch")`
and each settle inside `region_scope("settle")`, so a capture
(`obs/xprof.py`) sees the kernels under the seam that launched them.
"""

from __future__ import annotations

import os
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native_bridge
from ..obs import counter as _obs_counter
from ..obs import gauge as _obs_gauge
from ..ops.limbs import P_INT
from ..ops.regions import region_scope
from ..ops.curve import G_X
from ..ops.sha256 import bip340_challenge
from ..ops.verify_tiles import epilogue_sums, verify_tiles_checked
from ..resilience import faults as _faults
from ..resilience import guards as _guards
from ..resilience.degrade import DispatchResilience
from ..resilience.inflight import InflightQueue, Ticket, settle_array
from ..utils.gcpause import gc_paused
from ..utils.hashes import tagged_hash
from ..utils.profiling import Phases, accumulate
from .glv import split_lambda
from .secp_host import N, parse_der_lax

__all__ = ["SigCheck", "TorchSecpVerifier", "default_verifier"]

_CHECKS_TOTAL = _obs_counter(
    "consensus_checks_total", "deferred curve checks by kind", ("kind",)
)
_DISPATCH_TOTAL = _obs_counter(
    "consensus_dispatch_total", "device dispatches by backend", ("backend",)
)
_DISPATCH_LANES = _obs_counter(
    "consensus_dispatch_lanes_total", "real (unpadded) lanes dispatched"
)
_DISPATCH_PADDED = _obs_counter(
    "consensus_dispatch_padded_lanes_total",
    "padded lanes dispatched (pad ladder fill)",
)
_DISPATCH_FILL = _obs_gauge(
    "consensus_dispatch_fill_ratio",
    "real/padded lane ratio of the most recent dispatch",
)
_NEW_SHAPES = _obs_counter(
    "consensus_dispatch_new_shapes_total",
    "dispatches at a padded width new to their verifier (on a card: new "
    "pinned staging and result buffers)",
)
# Shared with models/batch.py's index-mode settle.
HOST_FIXUPS = _obs_counter(
    "consensus_host_fixup_total",
    "exceptional device lanes resolved exactly on host",
)


class SigCheck:
    """One deferred signature-algebra check (host-parsed, device-verified).

    kind: 'ecdsa'   -> data = (pubkey_bytes, sig_der_no_hashtype, msg32)
          'schnorr' -> data = (pubkey32, sig64, msg32)
          'tweak'   -> data = (tweaked32, parity, internal32, tweak32)
    """

    __slots__ = ("kind", "data")

    def __init__(self, kind: str, data: Tuple):
        if kind not in ("ecdsa", "schnorr", "tweak"):
            raise ValueError(f"unknown check kind {kind!r}")
        self.kind = kind
        self.data = data


def _batch_inv_mod_n(vals: List[int]) -> List[int]:
    """Montgomery batch inversion mod the group order n (one modexp total)."""
    prefix = []
    acc = 1
    for v in vals:
        acc = acc * v % N
        prefix.append(acc)
    inv = pow(acc, N - 2, N)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv * (prefix[i - 1] if i else 1) % N
        inv = inv * vals[i] % N
    return out


class _Lane:
    """Host-parsed check, ready for byte packing.

    a: fixed-base scalar (< n); the variable-base scalar b ships GLV-split
    as (|b1|, |b2|, neg1, neg2) with |bi| < 2^128. px: the point's x
    coordinate; want_odd: parity of the y lift; t1: the x-coordinate
    target; has_t2 marks the ECDSA r+n secondary target (only when
    r + n < p); parity constrains R.y (-1 don't care / 0 even / 1 odd).
    """

    __slots__ = (
        "valid", "a", "b1", "b2", "neg1", "neg2", "px", "want_odd", "t1",
        "has_t2", "parity",
    )

    def __init__(self):
        self.valid = False
        self.a = 0
        self.b1 = 0
        self.b2 = 0
        self.neg1 = 0
        self.neg2 = 0
        self.px = G_X
        self.want_odd = 0
        self.t1 = 0
        self.has_t2 = 0
        self.parity = -1

    def set_b(self, b: int) -> None:
        self.b1, self.neg1, self.b2, self.neg2 = split_lambda(b)


def _host_parse_pubkey(lane: _Lane, pubkey: bytes) -> bool:
    """Structural half of secp256k1_ec_pubkey_parse (eckey_impl.h): length,
    prefix, range and (for uncompressed forms) on-curve/hybrid checks. The
    decompression square root runs on the device."""
    if len(pubkey) == 33 and pubkey[0] in (2, 3):
        x = int.from_bytes(pubkey[1:], "big")
        if x >= P_INT:
            return False
        lane.px = x
        lane.want_odd = 1 if pubkey[0] == 3 else 0
        return True
    if len(pubkey) == 65 and pubkey[0] in (4, 6, 7):
        x = int.from_bytes(pubkey[1:33], "big")
        y = int.from_bytes(pubkey[33:], "big")
        if x >= P_INT or y >= P_INT:
            return False
        if (y * y - (x * x % P_INT * x + 7)) % P_INT != 0:
            return False
        if pubkey[0] == 6 and (y & 1):
            return False
        if pubkey[0] == 7 and not (y & 1):
            return False
        # y is on-curve, hence exactly the lift of its own parity: the
        # device recomputes it from (x, want_odd).
        lane.px, lane.want_odd = x, y & 1
        return True
    return False


def _prep_ecdsa(lane: _Lane, pubkey: bytes, sig_der: bytes, msg32: bytes):
    """Host half of CPubKey::Verify (pubkey.cpp:191-207): parse pubkey,
    lax-DER parse, normalise S. Returns (r, s, m) for the batched inversion,
    or None."""
    if not _host_parse_pubkey(lane, pubkey):
        return None
    rs = parse_der_lax(sig_der)
    if rs is None:
        return None
    r, s = rs
    if s > N // 2:
        s = N - s  # normalise high-S (pubkey.cpp:204)
    if r == 0 or s == 0:
        return None
    lane.t1 = r
    lane.has_t2 = 1 if r + N < P_INT else 0
    lane.valid = True
    return r, s, int.from_bytes(msg32, "big") % N


def _prep_schnorr(lane: _Lane, pubkey32: bytes, sig64: bytes, msg32: bytes,
                  defer_challenge: bool = False):
    """BIP340 verify host half (modules/schnorrsig/main_impl.h:190-237).

    With `defer_challenge` the structural work happens here and the
    challenge hash is left to the caller: returns the (r32, px32, m32)
    triple for one batched `ops/sha256.bip340_challenge`, after which the
    caller sets `lane.set_b((N - e) % N)`. Otherwise returns None."""
    if len(pubkey32) != 32 or len(sig64) != 64:
        return None
    px = int.from_bytes(pubkey32, "big")
    if px >= P_INT:
        return None
    r = int.from_bytes(sig64[:32], "big")
    s = int.from_bytes(sig64[32:], "big")
    if r >= P_INT or s >= N:
        return None
    lane.px = px
    lane.want_odd = 0  # BIP340 lift_x: even y; the device checks existence
    lane.a = s
    lane.t1 = r
    lane.parity = 0  # require even R.y
    lane.valid = True
    if defer_challenge:
        return (sig64[:32], pubkey32, msg32)
    e = int.from_bytes(
        tagged_hash("BIP0340/challenge", sig64[:32] + pubkey32 + msg32), "big"
    ) % N
    lane.set_b((N - e) % N)  # (n-e)·P = -e·P
    return None


def _prep_tweak(lane: _Lane, tweaked32: bytes, parity: int, internal32: bytes,
                tweak32: bytes):
    """Taproot commitment check host half (extrakeys/main_impl.h:109-129):
    Q = P_internal + t·G must equal (tweaked_x, parity)."""
    px = int.from_bytes(internal32, "big")
    if px >= P_INT:
        return
    t = int.from_bytes(tweak32, "big")
    if t >= N:
        return
    lane.px = px
    lane.want_odd = 0  # x-only internal key: even-y lift, device-checked
    lane.a = t
    lane.set_b(1)
    # A target >= p never equals a canonical x: the raw compare fails it.
    lane.t1 = int.from_bytes(tweaked32, "big")
    lane.parity = parity & 1
    lane.valid = True


class _Launched:
    """One launch of a ticket, unsynchronised: the host tensors its verdicts
    land in (pinned, filled by non-blocking copies on a card), the CUDA
    events around the verify kernel and after the copies (None on the
    CPU)."""

    __slots__ = ("ok", "needs", "events", "done")

    def __init__(self, ok, needs, events=None, done=None):
        self.ok = ok
        self.needs = needs
        self.events = events
        self.done = done


class TorchSecpVerifier:
    """Batched verifier on one device. Large batches are split into
    `chunk`-lane dispatches; each dispatch pads to the power-of-two ladder
    of `_pad` from `min_batch` up, which keeps at least one pad lane in
    reserve. `pad_step` caps that ladder at the next multiple of the step
    (a 5.6k-lane dispatch pads to 6,144 at step 2,048, not to 8,192), and
    must be a positive multiple of 512 lanes.

    `device=None` means `cuda:0`; without CUDA the constructor raises, and a
    caller that wants the plain torch version passes `device="cpu"`.
    `engine="native"` (the default) packs lanes and runs the host fixup in
    the native core, which loads here or raises; `engine="python"` runs the
    Python packers and the `secp_host` oracle.

    `device_challenge` (default: BITCOINCONSENSUS_TPU_DEVICE_SHA, "1" or
    "on", read here as the reference reads it) has the Python engine's lane
    prep hash every BIP340 challenge of a call on this verifier's device,
    in one `bip340_challenge` launch (`csrc/sha256.cu`), its digests read
    back through `settle_array`; `e mod n` and the GLV split stay on the
    host. The native engine's prep hashes its challenges in C++ and ignores
    the option, as the reference's native prep does. A launch that fails
    raises; nothing falls back to host hashing.

    Two seams, each split into an asynchronous half and a settling half:
    `verify_checks_begin` / `verify_checks_finish` take `SigCheck`s, and
    `dispatch_lanes` / `sync_lanes` take lanes already packed (the index-mode
    drivers pack them inside the native session). Both go through the
    in-flight queue (`resilience/inflight.py`): a dispatch stages the lanes
    (pinned on a card), writes the sentinel lanes into the staged pad,
    uploads with non-blocking copies, makes the one checked verify launch
    (verdicts and checksum partials) on the device's current stream and
    queues the copies of the results back, all without waiting; a settle
    waits once, then holds
    the padded verdicts to `validate_verdict`, the sentinels and the
    checksum, retrying a failed dispatch within the budget and then raising
    `DispatchFailed`. Settling a handle again returns the same verdicts.
    `in_flight` is the queue's depth: dispatches not yet settled (at most
    BITCOINCONSENSUS_TPU_INFLIGHT_DEPTH, 4; a deeper one settles the oldest
    first). A ticket's retries end at BITCOINCONSENSUS_TPU_SETTLE_DEADLINE_S
    (8.0) seconds after its dispatch. `phases` times `host_prep`,
    `dispatch` and `sync` (and the drivers' own phases).
    """

    _SITE = "torch_backend"

    def __init__(self, device=None, engine: str = "native", min_batch: int = 8,
                 chunk: int = 1 << 13, pad_step: Optional[int] = None,
                 device_challenge: Optional[bool] = None):
        if pad_step is not None and (pad_step <= 0 or pad_step % 512 != 0):
            raise ValueError("pad_step must be a positive multiple of 512 lanes")
        if min_batch < 1 or chunk < 2:
            raise ValueError("min_batch must be >= 1 and chunk >= 2")
        self.native = native_bridge.use_native(engine)
        self.engine = engine
        if device_challenge is None:
            device_challenge = os.environ.get(
                "BITCOINCONSENSUS_TPU_DEVICE_SHA", "") in ("1", "on")
        self.device_challenge = bool(device_challenge)
        self._min_batch = min_batch
        self._chunk = chunk
        self._pad_step = pad_step
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchSecpVerifier() runs on cuda:0 but CUDA is not "
                    "available; pass device=\"cpu\" to run the plain torch "
                    "version on the CPU"
                )
            device = "cuda:0"
        self.device = torch.device(device)
        self.stats: Dict[str, float] = defaultdict(float)
        self.phases = Phases()
        self._seen_shapes: set = set()
        # Set where a host fixup rejects a lane the kernel deferred (here or
        # in an index-mode driver): the mesh's block verdict reads it.
        self._fixup_failed = False
        # The guards: the device checksum rides every dispatch unless
        # BITCOINCONSENSUS_TPU_CHECKSUM is 0 or off; the queue's depth bounds
        # how far a caller runs ahead, its deadline how long a ticket retries.
        self._checksum = os.environ.get(
            "BITCOINCONSENSUS_TPU_CHECKSUM", "") not in ("0", "off")
        self._inflight = InflightQueue(
            DispatchResilience(), self._SITE, launch=self._launch_ticket,
            materialize=self._materialize_guarded, prepare=self._prepare_ticket,
            on_device=self._on_device_settle, stats=self.stats,
            max_depth=int(os.environ.get("BITCOINCONSENSUS_TPU_INFLIGHT_DEPTH", "4")),
            deadline_s=float(os.environ.get(
                "BITCOINCONSENSUS_TPU_SETTLE_DEADLINE_S", "8.0")),
        )
        # Set-up, once per verifier, so that a verify call's time is the
        # verify's own: the sentinel templates' host EC math; on a card, the
        # kernel built or loaded, the G table uploaded and the module loaded
        # by one checked launch over pad lanes.
        _guards._sentinel_templates()
        if self.device.type == "cuda":
            verify_tiles_checked(*self.to_device(self._pack_lanes([])),
                                 partials=self._checksum)
            torch.cuda.synchronize(self.device)

    @property
    def in_flight(self) -> int:
        """Dispatches not yet settled (the in-flight queue's depth)."""
        return self._inflight.depth

    def _pad(self, n: int) -> int:
        # `n + 1`, not `n`: every padded shape reserves at least one pad lane
        # (room for a known-answer sentinel lane); chunked drivers slice at
        # `lane_capacity` (= chunk - 1) so full chunks keep one shape.
        size = self._min_batch
        while size < n + 1:
            size *= 2
        if self._pad_step is not None:
            # The smaller of the ladder and the step rounding: a 5.6k-lane
            # dispatch pads to 6,144 at step 2,048, while a 4-check round
            # still pads to min_batch, not to a whole step.
            step = self._pad_step
            return min(size, max(self._min_batch, (n + step) // step * step))
        return size

    def pad(self, n: int) -> int:
        """The padded lane count of a dispatch of `n` lanes (the index-mode
        drivers pack lanes natively and need the same shapes)."""
        return self._pad(n)

    @property
    def chunk(self) -> int:
        return self._chunk

    @property
    def lane_capacity(self) -> int:
        """Real lanes per chunk dispatch: one short of `chunk`, so a full
        chunk keeps its reserved pad lane without going up a pad rung."""
        return self._chunk - 1

    def _prep_lanes(self, checks: Sequence[SigCheck]) -> List[_Lane]:
        lanes = [_Lane() for _ in checks]
        ecdsa_pending = []  # (lane, r, s, m)
        schnorr_pending = []  # (lane, r32, px32, m32): device_challenge only
        defer = self.device_challenge
        for lane, chk in zip(lanes, checks, strict=True):
            if chk.kind == "ecdsa":
                got = _prep_ecdsa(lane, *chk.data)
                if got is not None:
                    ecdsa_pending.append((lane, *got))
            elif chk.kind == "schnorr":
                trip = _prep_schnorr(lane, *chk.data, defer_challenge=defer)
                if trip is not None:
                    schnorr_pending.append((lane, *trip))
            else:
                _prep_tweak(lane, *chk.data)
        if ecdsa_pending:
            sinvs = _batch_inv_mod_n([s for _, _, s, _ in ecdsa_pending])
            for (lane, r, _s, m), sinv in zip(ecdsa_pending, sinvs, strict=True):
                lane.a = m * sinv % N  # u1
                lane.set_b(r * sinv % N)  # u2
        if schnorr_pending:
            # One launch for every challenge of the call; the GLV split of
            # (n - e) stays on the host, where the wide integers are.
            digests = self._challenges(schnorr_pending)
            for (lane, *_), d in zip(schnorr_pending, digests, strict=True):
                e = int.from_bytes(d.tobytes(), "big") % N
                lane.set_b((N - e) % N)  # (n-e)·P = -e·P
        return lanes

    def _challenges(self, pending) -> np.ndarray:
        """(n, 32) uint8 BIP340 challenge digests of the (lane, r32, px32,
        m32) rows, hashed on this verifier's device: one upload of the three
        (n, 32) planes, one `bip340_challenge` over them in place, one
        `settle_array` back."""
        n = len(pending)
        planes = np.frombuffer(
            b"".join(r for _, r, _, _ in pending)
            + b"".join(px for _, _, px, _ in pending)
            + b"".join(m for _, _, _, m in pending), dtype=np.uint8,
        ).reshape(3, n, 32)
        dev = torch.from_numpy(planes.copy()).to(self.device)
        self.stats["challenge_lanes"] += n
        return settle_array(bip340_challenge(dev[0], dev[1], dev[2]))

    def _pack_lanes(self, lanes: List[_Lane]):
        """The packed 7-tuple as numpy arrays, padded to `_pad(len(lanes))`:
        fields (B, 4, 32) uint8 LE (a, |b1|‖|b2|, px, t1), int32 want_odd,
        parity, has_t2, neg1, neg2, and bool valid. Pad lanes are invalid."""
        n = len(lanes)
        size = self._pad(n)
        raw = bytearray(size * 4 * 32)
        pos = 0
        for lane in lanes:
            raw[pos : pos + 32] = lane.a.to_bytes(32, "little")
            raw[pos + 32 : pos + 48] = lane.b1.to_bytes(16, "little")
            raw[pos + 48 : pos + 64] = lane.b2.to_bytes(16, "little")
            raw[pos + 64 : pos + 96] = lane.px.to_bytes(32, "little")
            raw[pos + 96 : pos + 128] = lane.t1.to_bytes(32, "little")
            pos += 128
        fields = np.frombuffer(raw, dtype=np.uint8).reshape(size, 4, 32)

        def flag(get, pad_value):
            arr = np.fromiter((get(l) for l in lanes), dtype=np.int32, count=n)
            return np.concatenate([arr, np.full(size - n, pad_value, np.int32)])

        want_odd = flag(lambda l: l.want_odd, 0)
        parity = flag(lambda l: l.parity, -1)
        has_t2 = flag(lambda l: l.has_t2, 0)
        neg1 = flag(lambda l: l.neg1, 0)
        neg2 = flag(lambda l: l.neg2, 0)
        valid = np.zeros(size, dtype=bool)
        valid[:n] = [lane.valid for lane in lanes]
        return fields, want_odd, parity, has_t2, neg1, neg2, valid

    def to_device(self, args) -> Tuple[torch.Tensor, ...]:
        """Packed numpy 7-tuple -> tensors on this verifier's device
        (a synchronous copy)."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in args)

    # -- the guarded dispatch: the in-flight queue's callbacks ----------------

    def _stage(self, args) -> Tuple[torch.Tensor, ...]:
        """A copy of a packed 7-tuple as host tensors (pinned on a card), for
        the launches of a ticket to read from; the caller's arrays stay as
        they were packed."""
        host = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)
        if self.device.type == "cuda":
            return tuple(t.pin_memory() for t in host)
        return tuple(t.clone() for t in host)

    def _prepare_ticket(self, args, n: int):
        """Stage one packed 7-tuple for its ticket (`_stage`), with the
        rotating known-answer sentinel lanes written into the staged pad
        rows. Returns (staged tensors, SentinelSet)."""
        host = self._stage(args)
        return host, self._install_sentinels(tuple(t.numpy() for t in host), n)

    def _install_sentinels(self, views, n: int):
        """The sentinel lanes written into the pad rows of staged numpy
        views, and the staging counted; returns the SentinelSet (None where
        a caller packed exactly n lanes)."""
        sset = _guards.install_sentinels(views, n)
        if sset is None:  # no pad row: a caller packed exactly n lanes
            self.stats["sentinel_skipped"] += 1
        else:
            self.stats["sentinel_lanes"] += len(sset.positions)
        self.stats["lanes"] += n
        self.stats["padded_lanes"] += int(views[0].shape[0])
        return sset

    def _launch_ticket(self, host, n: int, sset):
        """Upload a ticket's staged lanes, make the one checked verify
        launch (the verdicts and, with the checksum on, its per-warp
        partials) and queue the copies back, with nothing synchronised: on
        a card the uploads are non-blocking copies from pinned memory and
        everything goes on the device's current stream. Returns (the
        launch, the (3, n_warps) partials or None)."""
        _faults.maybe_raise("torch_backend.dispatch")
        self.stats["dispatches"] += 1
        self._note_dispatch(int(host[0].shape[0]), n,
                            "cuda" if self.device.type == "cuda" else "torch")
        with region_scope("dispatch"):
            if self.device.type != "cuda":
                ok, needs, parts = verify_tiles_checked(*host, partials=self._checksum)
                return _Launched(ok, needs), parts
            dev = tuple(t.to(self.device, non_blocking=True) for t in host)
            stream = torch.cuda.current_stream(self.device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
            ok, needs, parts = verify_tiles_checked(*dev, partials=self._checksum)
            events[1].record(stream)
            outs = [ok, needs] + ([parts] if parts is not None else [])
            back = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
            for h, t in zip(back, outs):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            return (_Launched(back[0], back[1], events, done),
                    back[2] if self._checksum else None)

    def _note_dispatch(self, padded: int, n: int, backend: str) -> None:
        """Dispatch accounting, once per launch (a relaunch counts again),
        under the level's label: `cuda` or `torch` here, `mesh` for a
        sharded dispatch."""
        _DISPATCH_TOTAL.inc(backend=backend)
        _DISPATCH_LANES.inc(n)
        _DISPATCH_PADDED.inc(padded)
        if padded:
            _DISPATCH_FILL.set(n / padded)
        if padded not in self._seen_shapes:
            self._seen_shapes.add(padded)
            _NEW_SHAPES.inc()

    def _materialize_guarded(self, ticket: Ticket):
        """The settle seam, the one place a dispatch's verdicts reach the
        host (`_guard_launch`). Returns padded (ok, needs) bool arrays and
        `all_ok`, the sharded step's verdict, None off the mesh; raises
        `VerdictAnomaly`."""
        ok, needs = self._guard_launch(ticket.result, ticket.aux, ticket.sset,
                                       int(ticket.args[0].shape[0]))
        return ok, needs, None

    def _guard_launch(self, res: "_Launched", aux, sset, padded: int):
        """One wait for a launch's copies, then the guards over its padded
        buffers: `validate_verdict` on `ok` (after the `torch_backend.verdict`
        fault hook) and `needs`, the sentinels of `sset`, and the device
        checksum, the warps' partials `aux` summed here, against the sums
        of the `ok` received. Returns padded (ok, needs) bool arrays;
        raises `VerdictAnomaly`."""
        with region_scope("settle"):
            if res.done is not None:
                with accumulate(self.stats, "device_wait_s"):
                    res.done.synchronize()
            ok_raw = _faults.corrupt_verdict("torch_backend.verdict", res.ok.numpy())
            ok = _guards.validate_verdict(ok_raw, padded, self._SITE)
            needs = _guards.validate_verdict(res.needs.numpy(), padded, self._SITE)
            _guards.check_sentinels(sset, ok, needs, self._SITE)
            if aux is not None:
                count, wsum, _fails = epilogue_sums(aux)
                _guards.check_checksum((count, wsum), ok, self._SITE)
            if res.events is not None:
                self.stats["kernel_ms"] += res.events[0].elapsed_time(res.events[1])
            return ok, needs

    # -- the verdict accounting the mesh overrides -------------------------------

    def _on_device_settle(self, ticket: Ticket, ok, needs, all_ok) -> None:
        """The in-flight queue's success hook: exactly once per ticket that
        settles clean, so a retried ticket is never counted twice."""
        self._note_device_verdict(all_ok, ok, needs, ticket.n)

    def _note_device_verdict(self, all_ok, ok, needs, count: int) -> None:
        """A dispatch of `count` lanes passed every guard. The single-device
        verifier keeps no verdict over a whole call; the mesh ANDs its
        block verdict here."""

    def _note_host_lanes(self, results: np.ndarray) -> None:
        """Lanes resolved on the host instead of the device. The port's
        verifier never hands a dispatch to the host; the hook keeps the
        reference's seam for the mesh's accounting."""

    def verify_checks(self, checks: Sequence[SigCheck]) -> np.ndarray:
        """Verify a mixed batch; returns a bool array aligned with `checks`:
        `verify_checks_begin` then `verify_checks_finish`, with the cyclic
        collector paused.

        `self.stats` accumulates where the time went: host lane prep and
        packing (`lane_prep_s`), host time spent waiting for the results to
        reach the host (`device_wait_s`), device time of the
        kernel by CUDA events (`kernel_ms`, CUDA only), the host fixup
        (`fixup_s`), and the lane, padded lane, dispatch and fixup counts
        (`lanes`, `padded_lanes`, `dispatches`, `fixups`), over both seams.
        The guards add theirs: `tickets`, `sentinel_lanes` (and
        `sentinel_skipped`), `settle_failures`, `guard_anomalies`,
        `retries`, `backpressure` and `deadline_expired`; the batch drivers
        add `cache_poison_caught`."""
        if not checks:
            return np.zeros(0, dtype=bool)
        with gc_paused():
            return self.verify_checks_finish(self.verify_checks_begin(checks))

    def verify_checks_begin(self, checks: Sequence[SigCheck]):
        """The asynchronous half of `verify_checks`: prep, pack and dispatch
        every chunk; returns a handle for `verify_checks_finish` without
        waiting for the device."""
        kinds: Dict[str, int] = {}
        for c in checks:
            kinds[c.kind] = kinds.get(c.kind, 0) + 1
        for k, cnt in kinds.items():
            _CHECKS_TOTAL.inc(cnt, kind=k)
        pending = []
        cap = self.lane_capacity
        for start in range(0, len(checks), cap):
            sub = checks[start : start + cap]
            with accumulate(self.stats, "lane_prep_s"), self.phases("host_prep"):
                if self.native:
                    packed = native_bridge.prep_pack(sub, self._pad(len(sub)))
                else:
                    packed = self._pack_lanes(self._prep_lanes(sub))
            with self.phases("dispatch"):
                pending.append((start, len(sub),
                                self._inflight.dispatch(packed, len(sub))))
        return checks, pending

    def verify_checks_finish(self, handle) -> np.ndarray:
        """Settle a `verify_checks_begin` handle into the result array: every
        dispatch through the guards (raising `DispatchFailed` where its
        retries are spent); lanes the kernel flags `needs_host` are resolved
        exactly on the host."""
        checks, pending = handle
        out = np.zeros(len(checks), dtype=bool)
        for start, count, ticket in pending:
            with self.phases("sync"):
                ok, needs = self._inflight.settle(ticket)
            out[start : start + count] = ok[:count]
            # Exceptional group-law lanes (crafted scalar collisions): the
            # fast device adds deferred them; resolve exactly on the host.
            fix = np.nonzero(needs[:count])[0]
            if len(fix):
                HOST_FIXUPS.inc(len(fix))
            with accumulate(self.stats, "fixup_s"):
                for i in fix:
                    r = self._host_check(checks[start + int(i)])
                    out[start + int(i)] = r
                    if not r:
                        self._fixup_failed = True
                    self.stats["fixups"] += 1
        return out

    def dispatch_lanes(self, args, n: int) -> Ticket:
        """Dispatch one packed lane batch (the 7-tuple of `prep_pack` or
        `NativeSession.uniq_lanes`, already padded, `n` real lanes); returns
        its ticket for `sync_lanes`, without waiting for the device."""
        with self.phases("dispatch"):
            return self._inflight.dispatch(args, n)

    def sync_lanes(self, pending: Ticket, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Settle a `dispatch_lanes` ticket through the guards:
        (ok[:n], needs_host[:n]), or `DispatchFailed` where its retries are
        spent. Lanes flagged `needs_host` report ok False; the caller
        resolves them exactly (`NativeSession.uniq_host_verify`)."""
        with self.phases("sync"):
            ok, needs = self._inflight.settle(pending)
        return ok[:n], needs[:n]

    def _host_check(self, chk: SigCheck) -> bool:
        """Exact host resolution of one check: the native core's, or the
        pure-Python oracle's with `engine="python"`."""
        if self.native:
            ns = native_bridge.NativeSecp
            if chk.kind == "ecdsa":
                return ns.verify_ecdsa(*chk.data)
            if chk.kind == "schnorr":
                return ns.verify_schnorr(*chk.data)
            return ns.tweak_add_check(*chk.data)
        from . import secp_host

        if chk.kind == "ecdsa":
            return secp_host.verify_ecdsa(*chk.data)
        if chk.kind == "schnorr":
            return secp_host.verify_schnorr(*chk.data)
        return secp_host.xonly_tweak_add_check(*chk.data)

    # Single-check conveniences (tests and differential checks).
    def verify_ecdsa(self, pubkey: bytes, sig_der: bytes, msg32: bytes) -> bool:
        return bool(self.verify_checks([SigCheck("ecdsa", (pubkey, sig_der, msg32))])[0])

    def verify_schnorr(self, pubkey32: bytes, sig64: bytes, msg32: bytes) -> bool:
        return bool(self.verify_checks([SigCheck("schnorr", (pubkey32, sig64, msg32))])[0])

    def tweak_add_check(self, tweaked32: bytes, parity: int, internal32: bytes,
                        tweak32: bytes) -> bool:
        return bool(self.verify_checks(
            [SigCheck("tweak", (tweaked32, parity, internal32, tweak32))])[0])


_default: Optional[TorchSecpVerifier] = None
_default_lock = threading.Lock()


def default_verifier() -> TorchSecpVerifier:
    """The process-wide verifier on cuda:0 (native engine), built at first
    use; raises where CUDA is not available."""
    global _default
    with _default_lock:
        if _default is None:
            _default = TorchSecpVerifier()
        return _default
