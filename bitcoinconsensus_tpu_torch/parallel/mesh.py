"""The sharded verifier: each dispatch spread over a 1-D mesh of devices, with
a fault domain per shard.

The port of `bitcoinconsensus_tpu/parallel/mesh.py`. The reference shards
the signature-check batch over a `jax.sharding.Mesh` on a `batch` axis and
runs its verify step SPMD under `shard_map`, each shard's failure count
AND-reduced by a `psum` into the block verdict: the counterpart of
`CCheckQueueControl::Wait()`'s all-inputs-valid barrier
(`checkqueue.h:139-142`). Here:

- `make_mesh` builds a `Mesh`: a tuple of `torch.device` entries on one
  axis. With no arguments it spans every CUDA device. An explicit list may
  name one device more than once; each entry is a shard with its own CUDA
  stream, so one card runs the real shard layouts, settles, evictions and
  probes (the reference forces a virtual 8-device CPU platform for the
  same purpose). An entry's id is its position in the first list, as a
  string: the reference's `str(d.id)` on its virtual mesh.
- `make_sharded_step(mesh)` is the step. Per shard it uploads the shard's
  contiguous rows to its entry's device on the entry's stream and makes one
  checked verify launch over them (`ops/verify_tiles.verify_tiles_checked`):
  the kernel writes the shard's verdicts straight into its rows of the
  device's group buffers and, as its epilogue, each warp's (count,
  weighted sum, failures), the terms of the reference's shard checksum
  pair and failure count (`ops/shard_step.py` is their standalone
  counterpart). Per device one reduction sums the warps into every
  shard's triple; the devices' triples meet on the first entry's device,
  where one reduction of the failures gives `all_ok`, the `psum`'s
  counterpart (a copy on one card, a peer copy across cards; NCCL is not
  used). Nothing waits: the settle waits once, on one event a stream. On
  CPU entries each shard runs the plain versions.
- `ShardedSecpVerifier` is a drop-in `TorchSecpVerifier`. Each shard keeps
  its last row for a rotating known-answer sentinel; at settle every shard
  is checked on its own (structure, then its checksum pair, then its
  sentinel), so a fault on one shard convicts that shard alone, and only
  its lanes are dispatched again: over the surviving mesh, then in one
  launch of the base kernel on a surviving entry. An entry that keeps
  failing is evicted (`resilience/degrade.ShardLadder`), the mesh is
  rebuilt over the survivors, and the entry is probed later with known
  answers for re-promotion. A shard's lag has its own deadline
  (BITCOINCONSENSUS_TPU_SHARD_DEADLINE_S, 4.0), apart from the in-flight
  queue's deadline of a whole ticket.

Deliberate divergences from the reference, by the port's rule that a failed
guard is never demoted to a slower backend: no host rung. Where the
reference's levels are mesh, then XLA, then the host oracle, the port's are
the surviving mesh, then the base kernel on one entry (the counter label
`device` in place of `xla`); where neither answers cleanly the ticket fails
and, its retries spent, raises `DispatchFailed`. A ticket whose retries all
fail on the mesh raises too. A settle where every shard failed is a
mesh-wide fault: it is retried as a whole and feeds no entry's eviction.

Telemetry, as in the reference: `consensus_mesh_devices`,
`_dispatch_total`, `_shard_lanes`, `_shard_failures_total{device,reason}`,
`_evictions_total{device}`, `_repromotions_total{device}` and
`_redispatch_lanes_total{level}`; the ladder keeps
`consensus_mesh_healthy_devices`; a rebuild runs in a `mesh.build` span and
each shard's check stamps the ticket's timeline.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..crypto.torch_backend import SigCheck, TorchSecpVerifier, _Launched
from ..obs import counter as _obs_counter
from ..obs import gauge as _obs_gauge
from ..obs import histogram as _obs_histogram
from ..obs import monotonic as _monotonic
from ..obs import span as _obs_span
from ..ops.regions import region_scope
from ..ops.contract import cdiv
from ..ops.verify_tiles import WARP, verify_tiles_checked
from ..resilience import degrade as _degrade
from ..resilience import faults as _faults
from ..resilience import guards as _guards
from ..resilience.degrade import DispatchFailed
from ..resilience.inflight import settle_array, unrecoverable
from ..utils.profiling import accumulate

__all__ = ["make_mesh", "ShardedSecpVerifier", "make_sharded_step", "Mesh"]

# Mesh telemetry: host-side accounting of the driver only.
_MESH_DEVICES = _obs_gauge(
    "consensus_mesh_devices", "devices in the sharded verifier's mesh"
)
_MESH_DISPATCH = _obs_counter(
    "consensus_mesh_dispatch_total", "sharded (multi-chip) dispatches"
)
_MESH_SHARD_LANES = _obs_histogram(
    "consensus_mesh_shard_lanes",
    "live (real, non-sentinel/pad) lanes per device shard per dispatch",
    buckets=(8, 64, 512, 4096, 32768),
)
_MESH_SHARD_FAILURES = _obs_counter(
    "consensus_mesh_shard_failures_total",
    "per-shard settle failures (guard anomaly, checksum mismatch, "
    "straggler deadline, device loss), by device and reason",
    ("device", "reason"),
)
_MESH_EVICTIONS = _obs_counter(
    "consensus_mesh_evictions_total",
    "devices evicted from the mesh after repeated shard failures",
    ("device",),
)
_MESH_REPROMOTIONS = _obs_counter(
    "consensus_mesh_repromotions_total",
    "evicted devices re-promoted into the mesh after a clean probe",
    ("device",),
)
_MESH_REDISPATCH_LANES = _obs_counter(
    "consensus_mesh_redispatch_lanes_total",
    "lanes re-dispatched after their shard failed settle, by the level "
    "that answered (mesh = surviving shards, device = one launch of the "
    "base kernel on a surviving entry)",
    ("level",),
)


class Mesh:
    """A 1-D mesh: device entries on one axis (the counterpart of a
    `jax.sharding.Mesh` over `("batch",)`). Entries may repeat; all are CUDA
    devices or all the CPU. `ids` are the entries' positions in the list
    the mesh was first made from, as strings."""

    def __init__(self, devices: Sequence, axis: str = "batch",
                 ids: Optional[Sequence[str]] = None):
        devs = []
        for d in devices:
            d = torch.device(d)
            devs.append(torch.device("cuda", 0) if d.type == "cuda" and d.index is None
                        else d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"a mesh's entries are all CUDA devices or all the "
                             f"CPU, got {sorted(kinds)}")
        self.devices: Tuple[torch.device, ...] = tuple(devs)
        self.axis_names = (axis,)
        self.ids: Tuple[str, ...] = (tuple(str(i) for i in range(len(devs)))
                                     if ids is None else tuple(ids))
        if len(self.ids) != len(devs):
            raise ValueError("one id per entry")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the batch axis: every CUDA device (the first
    `n_devices`), or the explicit `devices`, which may repeat an entry
    (`["cpu"] * 8`, `["cuda:0"] * 4`). Asking for more devices than there
    are is an error, not a silent truncation: a deployment that believes it
    runs 8 wide must not quietly run 1 wide. Without CUDA and without
    `devices` it raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() spans the CUDA devices but CUDA is not available; "
                "pass devices=[...] (for example [\"cpu\"] * 8) for the plain "
                "versions on the CPU")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(count)]
        if n_devices is not None:
            if n_devices > count:
                raise ValueError(
                    f"make_mesh: requested {n_devices} devices but only {count} "
                    "are available (platform cuda)")
            devices = devices[:n_devices]
    return Mesh(devices, axis)


class _ShardedLaunch:
    """One sharded step in flight: the host buffers its results land in
    (pinned, filled by non-blocking copies on a card), one event a stream
    that did work, and the device buffers they were copied from. `settle`
    waits once and returns (per_lane, needs, all_ok, counts, wsums) as
    numpy, in the reference's shapes."""

    __slots__ = ("padded", "rows", "groups", "trips", "all_ok", "done",
                 "timing", "keep")

    def __init__(self, padded, rows, groups, trips, all_ok, done, timing, keep):
        self.padded = padded
        self.rows = rows
        self.groups = groups  # [(shard indices, host ok, host needs)]
        self.trips = trips    # (d, 3) int32: each shard's count, wsum, failures
        self.all_ok = all_ok  # () bool
        self.done = done      # CUDA events, one a stream (empty on the CPU)
        self.timing = timing  # (start, end) events around each shard's verify
        self.keep = keep      # device buffers the copies read

    def settle(self):
        with region_scope("settle"):
            for ev in self.done:
                ev.synchronize()
            S = self.rows
            if len(self.groups) == 1 and self.groups[0][0] == list(
                    range(len(self.groups[0][0]))):
                ok, needs = self.groups[0][1].numpy(), self.groups[0][2].numpy()
            else:
                ok = np.zeros(self.padded, dtype=bool)
                needs = np.zeros(self.padded, dtype=bool)
                for shards, h_ok, h_needs in self.groups:
                    g_ok, g_needs = h_ok.numpy(), h_needs.numpy()
                    for j, s in enumerate(shards):
                        ok[s * S:(s + 1) * S] = g_ok[j * S:(j + 1) * S]
                        needs[s * S:(s + 1) * S] = g_needs[j * S:(j + 1) * S]
            trips = self.trips.numpy()
            return ok, needs, bool(self.all_ok.numpy()), trips[:, 0], trips[:, 1]

    def kernel_ms(self) -> float:
        """Device ms of the shards' verify kernels (after `settle`)."""
        return sum(e0.elapsed_time(e1) for e0, e1 in self.timing)


def make_sharded_step(mesh: Mesh):
    """The sharded verify step over `mesh`.

    Returns ``step(fields, want_odd, parity_req, has_t2, neg1, neg2, valid,
    live) -> _ShardedLaunch`` over host tensors of the padded batch (pinned
    for a CUDA mesh), `live` marking the real lanes. Shard s is rows
    [s*S, (s+1)*S), S = padded / d. Settled, the launch gives the
    reference's (per_lane, needs_host, all_ok, counts, wsums): per-lane
    verdicts and deferrals (padded,), all_ok True iff no live lane of any
    shard failed outright (a deferred lane stays out; the host fixup ANDs
    it in), and each shard's checksum pair over its own slice (d,)."""
    devs = mesh.devices
    d = mesh.size
    cuda = devs[0].type == "cuda"
    streams = [torch.cuda.Stream(device=x) for x in devs] if cuda else [None] * d
    by_dev = {}
    for s, x in enumerate(devs):
        by_dev.setdefault(x, []).append(s)
    groups = list(by_dev.items())  # (device, its shards), first entry first
    order = [s for _dev, shards in groups for s in shards]
    perm = None if order == list(range(d)) else torch.tensor(
        np.argsort(order), dtype=torch.int64)

    def on(stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def event(stream, timing=False):
        ev = torch.cuda.Event(enable_timing=timing)
        ev.record(stream)
        return ev

    def host_like(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if cuda else t

    def step(fields, want_odd, parity_req, has_t2, neg1, neg2, valid, live):
        args = (fields, want_odd, parity_req, has_t2, neg1, neg2, valid, live)
        padded = int(fields.shape[0])
        S = padded // d
        timing, keep, out_groups, trips_g = [], [], [], []
        with region_scope("shard_step"):
            for dev, shards in groups:
                k = len(shards)
                lead = streams[shards[0]]
                with on(lead):
                    ok_g = torch.empty(k * S, dtype=torch.bool, device=dev)
                    needs_g = torch.empty_like(ok_g)
                    parts_g = torch.empty((k, 3, cdiv(S, WARP)), dtype=torch.int32,
                                          device=dev)
                waits = []
                for j, s in enumerate(shards):
                    st = streams[s]
                    rows, loc = slice(s * S, (s + 1) * S), slice(j * S, (j + 1) * S)
                    with on(st):
                        if cuda and st is not lead:
                            st.wait_stream(lead)  # the group buffers' allocation
                        shard = tuple(a[rows].to(dev, non_blocking=True) for a in args)
                        e0 = event(st, True) if cuda else None
                        # The shard's verdicts land in its rows of the group
                        # buffers, its warps' partials in its own slice.
                        verify_tiles_checked(*shard[:7], live=shard[7], ok_out=ok_g[loc],
                                             needs_out=needs_g[loc], partials=parts_g[j])
                        if cuda:
                            timing.append((e0, event(st, True)))
                            if st is not lead:
                                waits.append(event(st))
                with on(lead):
                    for ev in waits:
                        lead.wait_event(ev)
                    trip = parts_g.sum(dim=2, dtype=torch.int32)  # (k, 3)
                    h_ok, h_needs = host_like(ok_g), host_like(needs_g)
                    if cuda:
                        h_ok.copy_(ok_g, non_blocking=True)
                        h_needs.copy_(needs_g, non_blocking=True)
                keep += [ok_g, needs_g, parts_g]
                out_groups.append((shards, h_ok, h_needs))
                trips_g.append((lead, trip))
            # The devices' triples meet on the first entry's device, where one
            # reduction of the failures gives all_ok (the psum's counterpart).
            s0, dev0 = streams[0], devs[0]
            with on(s0):
                cols = []
                for lead, trip in trips_g:
                    if trip.device != dev0:
                        s0.wait_event(event(lead))
                        with on(lead):
                            trip = trip.to(dev0, non_blocking=True)
                    cols.append(trip)
                trips = cols[0] if len(cols) == 1 else torch.cat(cols, dim=0)
                if perm is not None:
                    trips = trips[perm.to(dev0)]
                all_ok = trips[:, 2].sum() == 0
                h_trips, h_all = host_like(trips), host_like(all_ok)
                if cuda:
                    h_trips.copy_(trips, non_blocking=True)
                    h_all.copy_(all_ok, non_blocking=True)
            keep += [trips, all_ok]
            done = [event(st) for st in dict.fromkeys(streams)] if cuda else []
        return _ShardedLaunch(padded, S, out_groups, h_trips, h_all, done, timing, keep)

    return step


def _shard_positions(n: int, shard_size: int) -> np.ndarray:
    """Global row of real lane `i` under the scatter layout: each shard of
    `shard_size` rows holds `shard_size - 1` real lanes and then its
    sentinel row, so lane i lands at ``(i // (S-1)) * S + (i % (S-1))``."""
    cap = shard_size - 1
    idx = np.arange(n, dtype=np.int64)
    return (idx // cap) * shard_size + (idx % cap)


class _ShardLayout:
    """Settle context of one scattered mesh dispatch (rides `ticket.sset`).

    `positions` maps real-lane order to global rows; `ssets` holds one
    single-lane SentinelSet a shard (local row S-1), `flat_sset` the same
    sentinels as one global set for the single-device rung. `epoch` pins the
    mesh generation the layout was built for: after an eviction rebuilds
    the mesh, an older layout is no longer shard-aligned and relaunches on
    the single-device rung. `deadline_armed` is False at a padded width new
    to the verifier (its first dispatch stages new buffers), so the
    per-shard deadline never fires on set-up time. The port keeps three
    more: `ids`, the entries the layout was built over (whose health its
    settle reports); `views`, numpy views of the laid-out host buffers
    (the failed shards' lanes are gathered from them); and `live`, the
    host mask of real lanes the step reads."""

    __slots__ = (
        "n", "padded", "n_shards", "shard_size", "positions", "ssets",
        "flat_sset", "epoch", "deadline_armed", "ids", "views", "live",
    )

    def __init__(self, n, padded, n_shards, shard_size, positions, ssets,
                 flat_sset, epoch, deadline_armed, ids, views, live):
        self.n = n
        self.padded = padded
        self.n_shards = n_shards
        self.shard_size = shard_size
        self.positions = positions
        self.ssets = ssets
        self.flat_sset = flat_sset
        self.epoch = epoch
        self.deadline_armed = deadline_armed
        self.ids = ids
        self.views = views
        self.live = live


# Pad row values per packed array (as `_pack_lanes` pads): fields 0,
# want_odd 0, parity -1 (don't care), has_t2/neg1/neg2 0, valid False.
_PAD_VALUES = (0, 0, -1, 0, 0, 0, 0)


class ShardedSecpVerifier(TorchSecpVerifier):
    """Drop-in `TorchSecpVerifier` that spreads each dispatch over a mesh,
    with a fault domain per shard: per-shard sentinels and checksums at
    settle, re-dispatch of a failed shard's lanes alone, and eviction of an
    entry that keeps failing. `mesh=None` takes `make_mesh()`, every CUDA
    device; a one-entry mesh dispatches as the base verifier does."""

    _SITE = "mesh"

    def __init__(self, mesh: Optional[Mesh] = None, min_batch: int = 8,
                 chunk: int = 1 << 13, evict_after: Optional[int] = None):
        mesh = mesh if mesh is not None else make_mesh()
        self.mesh = mesh  # `_pad`, which the base's set-up packs at, reads it
        super().__init__(device=mesh.devices[0], min_batch=min_batch, chunk=chunk)
        self._axis = mesh.axis_names[0]
        self._all_entries = list(zip(mesh.ids, mesh.devices))
        self._base_min_batch = min_batch
        self._mesh_epoch = 0
        self._shard_ladder = _degrade.ShardLadder(list(mesh.ids), evict_after=evict_after)
        self._shard_deadline_s = float(os.environ.get(
            "BITCOINCONSENSUS_TPU_SHARD_DEADLINE_S", "4.0"))
        self._verdict_acc = True
        self._dispatched = 0
        self.last_shard_lanes: List[int] = []  # live lanes a shard, last dispatch
        self._install_mesh(mesh)
        if self.device.type == "cuda":
            # Set-up, as the base verifier's on the first card: the checked
            # kernel's module loaded and its G table uploaded on each card
            # of the mesh past the first.
            for dev in dict.fromkeys(mesh.devices):
                if dev != self.device:
                    verify_tiles_checked(
                        *(t.to(dev) for t in self.to_device(self._pack_lanes([]))))

    def _install_mesh(self, mesh: Mesh) -> None:
        """(Re)build the sharded step over `mesh`: the eviction and
        re-promotion rebuild too, in a `mesh.build` span, and the mesh size
        in the gauge."""
        n = mesh.size
        self.mesh = mesh
        self._shard_device_ids = list(mesh.ids)
        # Batch sizes divide evenly across the mesh: min_batch rounds up to
        # a multiple of n (doubling in _pad keeps it one).
        self._min_batch = -(-self._base_min_batch // n) * n
        self.device = mesh.devices[0]  # the single-device rung's entry
        with _obs_span("mesh.build", devices=n, epoch=self._mesh_epoch):
            self._step = make_sharded_step(mesh)
        _MESH_DEVICES.set(n)

    # --- layout -------------------------------------------------------------

    def _pad(self, n: int) -> int:
        # One sentinel row PER SHARD: the padded size fits n real lanes and n
        # entries' sentinels, and every shard is at least 2 rows, so its
        # sentinel never crowds out real work. Like the reference, pad_step
        # is not read.
        d = self.mesh.size
        size = self._min_batch
        while size < n + d or size // d < 2:
            size *= 2
        return size

    @property
    def lane_capacity(self) -> int:
        """Real lanes a chunk dispatch: one short of `chunk` PER SHARD, so
        the shards' sentinel rows never push a full chunk up a pad rung."""
        return self._chunk - self.mesh.size

    def _blank_args(self, like, padded: int):
        """Fresh all-pad packed numpy buffers shaped like `like` at `padded`."""
        out = []
        for a, pv in zip(like, _PAD_VALUES):
            buf = np.zeros((padded,) + tuple(a.shape[1:]), dtype=a.dtype)
            if pv:
                buf[...] = pv
            out.append(buf)
        return tuple(out)

    def _host_tensor(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _build_layout(self, args, n: int) -> Optional[_ShardLayout]:
        """Scatter the real lanes of numpy buffers `args` across the shards,
        in place, and write each shard's sentinel into its last row; None
        where the buffers cannot carry the layout (the caller lays them out
        contiguously instead)."""
        d = self.mesh.size
        padded = int(args[0].shape[0])
        if d < 2 or padded % d or padded < n + d:
            return None
        shard = padded // d
        if shard < 2 or n > d * (shard - 1):
            return None
        positions = _shard_positions(n, shard)
        for a, pv in zip(args, _PAD_VALUES):
            real = a[:n].copy()
            a[...] = pv
            a[positions] = real
        sent_rows = [s * shard + shard - 1 for s in range(d)]
        flat = _guards.install_sentinels_at(args, sent_rows)
        if flat is None:
            return None
        ssets = [_guards.SentinelSet([shard - 1], [bool(flat.expected[s])])
                 for s in range(d)]
        live = np.zeros(padded, dtype=bool)
        live[positions] = True  # sentinel and pad rows stay out of the failures
        return _ShardLayout(
            n, padded, d, shard, positions, ssets, flat, self._mesh_epoch,
            padded in self._seen_shapes, tuple(self._shard_device_ids), args,
            self._host_tensor(live),
        )

    def _prepare_ticket(self, args, n: int):
        """Stage one packed 7-tuple (`_stage`: the caller's arrays stay as
        they were packed), then lay the staged copy out shard-major with one
        rotating sentinel a shard. Falls back to the base verifier's
        contiguous sentinels where the batch cannot shard."""
        host = self._stage(args)
        views = tuple(t.numpy() for t in host)
        layout = self._build_layout(views, n)
        if layout is None:
            if self.mesh.size > 1:
                self.stats["mesh_unsharded"] += 1
            return host, self._install_sentinels(views, n)
        self.stats["sentinel_lanes"] += layout.n_shards
        self.stats["lanes"] += n
        self.stats["padded_lanes"] += layout.padded
        return host, layout

    # --- launch -------------------------------------------------------------

    def _launch_ticket(self, host, n: int, sset):
        """Launch one chunk (the in-flight queue's callback). A sharded launch
        needs a layout of the current mesh epoch; anything else (an
        unshardable batch, or a layout from before an eviction rebuilt the
        mesh) runs the base verifier's launch on the first surviving entry,
        its settle guarded by the flat sentinels and the global checksum."""
        layout = sset if isinstance(sset, _ShardLayout) else None
        if layout is None or layout.epoch != self._mesh_epoch:
            return TorchSecpVerifier._launch_ticket(self, host, n, sset)
        _faults.maybe_raise("mesh.dispatch")
        self.stats["dispatches"] += 1
        self.stats["mesh_dispatches"] += 1
        self._note_dispatch(layout.padded, n, "mesh")
        _MESH_DISPATCH.inc()
        cap = layout.shard_size - 1
        self.last_shard_lanes = [min(max(n - s * cap, 0), cap)
                                 for s in range(layout.n_shards)]
        for lanes in self.last_shard_lanes:
            _MESH_SHARD_LANES.observe(lanes)
        # The shards' checksum pairs ride in the step's result: no aux.
        with region_scope("dispatch"):
            return self._step(*host, layout.live), None

    # --- settle -------------------------------------------------------------

    def _materialize_guarded(self, ticket):
        layout = ticket.sset if isinstance(ticket.sset, _ShardLayout) else None
        if layout is None:  # contiguous prep: the base settle seam
            return TorchSecpVerifier._materialize_guarded(self, ticket)
        if isinstance(ticket.result, _Launched):
            return self._materialize_flat(ticket, layout)
        return self._materialize_sharded(ticket, layout)

    def _materialize_flat(self, ticket, layout: _ShardLayout):
        """Settle a scattered buffer the single-device rung answered: the
        whole-buffer guards (flat sentinels, global checksum), then the real
        lanes gathered back to the caller's order."""
        ok, needs = self._guard_launch(ticket.result, ticket.aux, layout.flat_sset,
                                       layout.padded)
        return ok[layout.positions], needs[layout.positions], None

    def _materialize_sharded(self, ticket, layout: _ShardLayout):
        """The per-shard settle seam: every shard validated on its own
        (structure, its checksum pair first, then its sentinel), each
        entry's health fed to the ladder, and only the failed shards' lanes
        dispatched again."""
        res = ticket.result
        with accumulate(self.stats, "device_wait_s"):
            ok_np, needs_np, all_ok, cnts_np, wsums_np = res.settle()
        self.stats["kernel_ms"] += res.kernel_ms()
        if (ok_np.ndim != 1 or ok_np.shape[0] != layout.padded
                or needs_np.shape != ok_np.shape
                or cnts_np.shape[0] != layout.n_shards
                or wsums_np.shape[0] != layout.n_shards):
            raise _guards.VerdictAnomaly(
                self._SITE, "shape",
                f"got {ok_np.shape}/{cnts_np.shape}, "
                f"want ({layout.padded},)/({layout.n_shards},)")
        elapsed = _monotonic() - ticket.born
        ok_v, needs_v, bad = self._check_shards(
            ok_np, needs_np, cnts_np, wsums_np, layout, elapsed,
            timeline=ticket.timeline)
        for s, dev in enumerate(layout.ids):
            if s in bad:
                _MESH_SHARD_FAILURES.inc(device=dev, reason=bad[s])
        if len(bad) == layout.n_shards:
            # Nothing survived: a mesh-wide fault, for the ticket's retries
            # and not for the ladder, which would evict every entry but one.
            raise _guards.VerdictAnomaly(
                self._SITE, "all-shards", ",".join(sorted(set(bad.values()))))
        # Each entry's health feeds the eviction ladder at the primary settle
        # only (a re-dispatch must not convict twice). Evictions apply after
        # the loop, since each one rebuilds the mesh.
        to_evict = [dev for s, dev in enumerate(layout.ids)
                    if self._shard_ladder.report_shard(dev, s not in bad)]
        for dev in to_evict:
            self._evict_device(dev)
        if not bad:
            probe_dev = self._shard_ladder.note_clean_dispatch()
            if probe_dev is not None:
                self._probe_evicted(probe_dev)
            return ok_v[layout.positions], needs_v[layout.positions], all_ok
        # Partial settlement: the good shards' verdicts stand, the failed
        # shards' real lanes go again. all_ok None: the accounting recomputes
        # it from the assembled lanes (the step's reduction saw the faults).
        cap = layout.shard_size - 1
        lane_shard = np.arange(layout.n, dtype=np.int64) // cap
        bad_keys = np.fromiter(bad.keys(), dtype=np.int64, count=len(bad))
        bad_mask = np.isin(lane_shard, bad_keys)
        ok_r = np.zeros(layout.n, dtype=bool)
        needs_r = np.zeros(layout.n, dtype=bool)
        good = ~bad_mask
        ok_r[good] = ok_v[layout.positions[good]]
        needs_r[good] = needs_v[layout.positions[good]]
        k = int(bad_mask.sum())
        if k:
            rows = layout.positions[bad_mask]
            ok_b, needs_b = self._redispatch_lanes(tuple(v[rows] for v in layout.views), k)
            ok_r[bad_mask] = ok_b
            needs_r[bad_mask] = needs_b
        return ok_r, needs_r, None

    def _check_shards(self, ok_np, needs_np, cnts_np, wsums_np,
                      layout: _ShardLayout, elapsed: float, timeline=None):
        """Validate each shard's verdict slice on its own; returns (ok,
        needs, bad): padded bool buffers holding the surviving shards'
        slices, and shard index -> failure reason. The order is the
        reference's: structure, then the shard's checksum (so a single-lane
        flip always convicts as "checksum"), then its sentinel. `timeline`
        (the settling ticket's) gets one stamp a shard."""
        shard = layout.shard_size
        ok_v = np.zeros(layout.padded, dtype=bool)
        needs_v = np.zeros(layout.padded, dtype=bool)
        bad = {}
        for s in range(layout.n_shards):
            site = f"mesh.shard.{s}"
            sl = slice(s * shard, (s + 1) * shard)
            try:
                _faults.maybe_raise(site)
                delay = _faults.shard_delay(site)
                # Convict on a shard's own lag only (the harness's simulated
                # delay): a slow dispatch as a whole is the ticket deadline's
                # business, and would convict every shard at once.
                if (layout.deadline_armed and delay > 0.0
                        and elapsed + delay > self._shard_deadline_s):
                    _guards.GUARD_ANOMALIES.inc(site=site, reason="deadline")
                    bad[s] = "deadline"
                    continue
                ok_s = _guards.validate_verdict(
                    _faults.corrupt_verdict(site, ok_np[sl]), shard, site)
                needs_s = _guards.validate_verdict(needs_np[sl], shard, site)
                _guards.check_checksum((int(cnts_np[s]), int(wsums_np[s])), ok_s, site)
                layout.ssets[s].check(ok_s, needs_s, site)
            except _guards.VerdictAnomaly as exc:
                bad[s] = exc.reason
            except _faults.InjectedDeviceLoss:
                bad[s] = "device-loss"
            except _faults.InjectedTimeout:
                bad[s] = "timeout"
            except Exception:
                bad[s] = "dispatch"
            else:
                ok_v[sl] = ok_s
                needs_v[sl] = needs_s
            finally:
                if timeline is not None:
                    timeline.stamp_shard(s)
        return ok_v, needs_v, bad

    # --- shard re-dispatch --------------------------------------------------

    def _redispatch_lanes(self, sub, k: int):
        """Answer again `k` lanes whose shard failed settle: over the
        surviving mesh, then in one launch of the base kernel on a surviving
        entry. Where neither answers cleanly it raises `DispatchFailed`: the
        port has no host rung, and the ticket's retries take it from there."""
        last = None
        for target in ("mesh", "device"):
            try:
                if target == "mesh":
                    out = self._redispatch_mesh(sub, k)
                else:
                    out = self._redispatch_device(sub, k)
            except Exception as exc:
                if unrecoverable(exc):
                    raise
                out, last = None, exc
            if out is not None:
                _MESH_REDISPATCH_LANES.inc(k, level=target)
                return out
        raise DispatchFailed(
            f"{self._SITE}: {k} lanes of failed shards found no rung that "
            "answered cleanly") from last

    def _fill(self, sub, k: int):
        args = self._blank_args(sub, self._pad(k))
        for a, r in zip(args, sub):
            a[:k] = r
        return args

    def _redispatch_mesh(self, sub, k: int):
        """One dispatch of the failed lanes over the current (maybe rebuilt)
        mesh, waited for at once and guarded shard by shard; None where the
        mesh cannot answer cleanly."""
        args = self._fill(sub, k)
        layout = self._build_layout(args, k)
        if layout is None:
            return None
        self.stats["dispatches"] += 1
        self.stats["mesh_dispatches"] += 1
        self._note_dispatch(layout.padded, k, "mesh")
        _MESH_DISPATCH.inc()
        host = tuple(self._host_tensor(a) for a in args)
        res = self._step(*host, layout.live)
        ok_np, needs_np, _all_ok, cnts, wsums = res.settle()
        ok_v, needs_v, bad = self._check_shards(ok_np, needs_np, cnts, wsums,
                                                layout, 0.0)
        if bad:
            return None
        return ok_v[layout.positions], needs_v[layout.positions]

    def _redispatch_device(self, sub, k: int):
        """One launch of the base kernel over the failed lanes on the first
        surviving entry, guarded by a fresh contiguous sentinel set and the
        global verdict checksum."""
        args = self._fill(sub, k)
        sset = _guards.install_sentinels(args, k)
        launched, aux = TorchSecpVerifier._launch_ticket(
            self, tuple(self._host_tensor(a) for a in args), k, sset)
        ok, needs = self._guard_launch(launched, aux, sset, int(args[0].shape[0]))
        return ok[:k], needs[:k]

    # --- elastic mesh: eviction and re-promotion ------------------------------

    def _evict_device(self, dev_id: str) -> None:
        """Convict one entry: the mesh shrinks to the survivors and the step
        is rebuilt. In-flight layouts of the old epoch relaunch on the
        single-device rung."""
        self._shard_ladder.evict(dev_id)
        _MESH_EVICTIONS.inc(device=dev_id)
        self._rebuild_mesh()

    def _rebuild_mesh(self) -> None:
        healthy = set(self._shard_ladder.healthy())
        keep = [(i, d) for i, d in self._all_entries if i in healthy]
        self._mesh_epoch += 1
        self._install_mesh(Mesh([d for _, d in keep], self._axis,
                                ids=[i for i, _ in keep]))

    def _probe_evicted(self, dev_id: str) -> None:
        """Known-answer re-promotion probe of an evicted entry: a clean probe
        re-admits it (and rebuilds the step over the grown mesh), a failed
        one leaves it out until its next nomination."""
        try:
            ok = self._probe_device(dev_id)
        except Exception:
            ok = False
        if ok:
            self._shard_ladder.repromote(dev_id)
            _MESH_REPROMOTIONS.inc(device=dev_id)
            self._rebuild_mesh()

    def _probe_device(self, dev_id: str) -> bool:
        """An all-sentinel batch of 8 lanes through one checked launch on the
        entry's device; True iff every known answer comes back right."""
        _faults.maybe_raise("mesh.probe")
        dev = dict(self._all_entries).get(dev_id)
        if dev is None:
            return False
        size = 8
        like = (np.zeros((1, 4, 32), dtype=np.uint8),) + tuple(
            np.zeros(1, dtype=np.int32) for _ in range(5)) + (np.zeros(1, dtype=bool),)
        args = self._blank_args(like, size)
        sset = _guards.install_sentinels_at(args, [0, 1, 2, 3], rotation=0)
        if sset is None:
            return False
        ok, _needs, _ = verify_tiles_checked(
            *(torch.from_numpy(a).to(dev) for a in args), partials=False)
        ok = _guards.validate_verdict(settle_array(ok), size, "mesh.probe")
        try:
            sset.check(ok, None, "mesh.probe")
        except _guards.VerdictAnomaly:
            return False
        return True

    # --- verdict accounting ---------------------------------------------------

    def _note_device_verdict(self, all_ok, ok, needs, count: int) -> None:
        """AND a settled chunk into the block verdict: the step's `all_ok`
        for a clean mesh dispatch; for a partly re-dispatched or
        single-device one, recomputed from the lanes with the same meaning
        (deferred lanes left out: the host fixup ANDs their verdicts in
        through `_fixup_failed`). At settle, never at dispatch, so a retried
        chunk never counts twice."""
        if all_ok is None:
            lanes_ok = ok[:count]
            if needs is not None:
                lanes_ok = lanes_ok | needs[:count]
            all_ok = bool(np.all(lanes_ok))
        self._verdict_acc = self._verdict_acc and bool(all_ok)
        self._dispatched += count

    def _note_host_lanes(self, results: np.ndarray) -> None:
        self._verdict_acc = self._verdict_acc and bool(np.all(results))
        self._dispatched += len(results)

    def verify_checks_with_verdict(self, checks: Sequence[SigCheck]):
        """(per-check results, block-level all-ok). The all-ok of the
        dispatched lanes is the sharded step's reduction, not a host
        re-reduction; lanes rejected on the host before dispatch (structural
        parse failures) AND in through the dispatched count, and host-
        resolved deferrals through `_fixup_failed`."""
        self._verdict_acc = True
        self._dispatched = 0
        self._fixup_failed = False
        try:
            res = self.verify_checks(checks)
            return res, (self._verdict_acc and self._dispatched == len(checks)
                         and not self._fixup_failed)
        finally:
            # A raising verify_checks must not poison the next verdict: settle
            # whatever is still in flight and clear the accounting either way.
            self._inflight.drain()
            self._verdict_acc = True
            self._dispatched = 0
            self._fixup_failed = False
