"""The port's stats gate: a seeded workload through every ported layer, then
the metrics snapshot, checked for the metrics each layer must light up.

    python -m bitcoinconsensus_tpu_torch.obs.stats --check               # on cuda:0
    python -m bitcoinconsensus_tpu_torch.obs.stats --check --device cpu  # plain version
    python -m bitcoinconsensus_tpu_torch.obs.stats --format prom
    python -m bitcoinconsensus_tpu_torch.obs.stats --out snap.json

The counterpart of the reference's `scripts/consensus_stats.py`. The
workload (`run_workload`) drives the api (each entry point, and each kind of
rejection), `verify_batch` in index mode, in the wire driver and on the
Python engine (a mixed batch with one bad input, then a replay that hits
both caches), `verify_batch_stream`, the serving front end (a two-tenant fan-in through
a `VerifyServer`, then a forced `tenant_full` shed and a draining close),
the ingress (one socket round trip, a garbage frame, a reaped slow-loris),
the persistent sigstore (populated through `verify_batch`, reopened, the
rerun warm; a store whose directory vanishes), a two-stub `ServingCell`
(a replica killed, evicted, its shards handed off, its tenant rerouted,
then re-promoted through a passing probe), `connect_block` on a
`NativeCoinsView` (a valid block, then its replay, rejected), a dispatch
with a fault injected (retried clean), the mesh (one sharded dispatch over a 4-entry
mesh on the device, then one injected device loss that evicts an entry with
`evict_after=1`), the gauntlet (`workloads/`: replay seed 5, two blocks
of two transactions; the 26-case corpus; eight mutants of fuzz seed 1),
the fast scalar-schedule certificates and, on the
card, a device capture (`obs/xprof.py`); the flight recorder is armed for
the last part and triggered once. `--check` exits 1 when a metric of
`required_metrics(device)` is missing or has no sample, or a value is not
finite. In a process whose registry already holds a capture or the
scalar certificates (`chip_smoke.py` runs the gate after its `[xprof]` and
`[prover]` phases), the workload leaves that leg out: the metrics it would
light are the earlier leg's own.

`REQUIRED_METRICS` keeps the reference's names for every layer, the
adversarial gauntlet's (`consensus_gauntlet_*`, lit by a tiny replay
stream, the pinned corpus and eight fuzz mutants on the gate's verifier)
among them. As in the reference, `consensus_cell_retried_frames_total` samples an
explicit zero: a retried frame needs a frame in flight at the instant an
upstream dies. The cell leg's stub replicas run on the gate's device.
`consensus_resilience_level` (the ladder's gauge) is left out for good: the
port has no ladder. As in the reference, `consensus_mesh_repromotions_total`
is not required: only a re-promotion probe lights it. The device-truth group needs the card: with
`--device cpu` it is not required, since `xprof.capture_report` raises
without one.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
from typing import Dict, List, Tuple

__all__ = ["REQUIRED_METRICS", "main", "required_metrics", "run_workload"]

# Every metric name the workload must light up, by layer.
REQUIRED_METRICS: Dict[str, Tuple[str, ...]] = {
    "api": (
        "consensus_verify_calls_total",
        "consensus_verify_reject_total",
        "consensus_script_reject_total",
    ),
    "batch": (
        "consensus_batch_size",
        "consensus_batch_items_total",
        "consensus_batch_results_total",
        "consensus_fixpoint_rounds",
        "consensus_uniq_checks_total",
    ),
    "caches": (
        "consensus_cache_lookups_total",
        "consensus_cache_hits_total",
        "consensus_cache_misses_total",
        "consensus_cache_insertions_total",
        "consensus_cache_entries",
    ),
    "dispatch": (
        "consensus_checks_total",
        "consensus_dispatch_total",
        "consensus_dispatch_lanes_total",
        "consensus_dispatch_padded_lanes_total",
        "consensus_dispatch_fill_ratio",
        "consensus_dispatch_new_shapes_total",
    ),
    "mesh": (
        "consensus_mesh_devices",
        "consensus_mesh_dispatch_total",
        "consensus_mesh_shard_lanes",
        "consensus_mesh_healthy_devices",
        "consensus_mesh_shard_failures_total",
        "consensus_mesh_evictions_total",
        "consensus_mesh_redispatch_lanes_total",
    ),
    "serving": (
        "consensus_serving_admitted_total",
        "consensus_serving_shed_total",
        "consensus_serving_queue_depth",
        "consensus_serving_queue_wait_seconds",
        "consensus_serving_batch_fill",
        "consensus_serving_batch_seconds",
        "consensus_serving_slo_seconds",
        "consensus_serving_slo_p50_seconds",
        "consensus_serving_slo_p99_seconds",
        "consensus_serving_batches_total",
    ),
    "ingress": (
        "consensus_ingress_sessions_total",
        "consensus_ingress_frames_total",
        "consensus_ingress_bytes_total",
        "consensus_ingress_deadline_reaps_total",
        "consensus_ingress_protocol_errors_total",
    ),
    "sigstore": (
        "consensus_sigstore_hits_total",
        "consensus_sigstore_misses_total",
        "consensus_sigstore_tier_entries",
        "consensus_sigstore_warmup_seconds",
        "consensus_sigstore_replay_records_total",
        "consensus_sigstore_appends_total",
        "consensus_sigstore_shard_moved_total",
    ),
    "cell": (
        "consensus_cell_replicas_healthy",
        "consensus_cell_evictions_total",
        "consensus_cell_repromotions_total",
        "consensus_cell_reroutes_total",
        "consensus_cell_retried_frames_total",
        "consensus_cell_handoffs_total",
        "consensus_cell_handoff_records_total",
    ),
    "gauntlet": (
        "consensus_gauntlet_corpus_cases_total",
        "consensus_gauntlet_divergence_total",
        "consensus_gauntlet_replay_blocks_total",
        "consensus_gauntlet_fuzz_cases_total",
        "consensus_gauntlet_shape_seconds",
    ),
    "block": (
        "consensus_blocks_total",
        "consensus_block_reject_total",
    ),
    "resilience": (
        "consensus_resilience_sentinel_lanes_total",
        "consensus_resilience_guard_anomalies_total",
        "consensus_resilience_faults_injected_total",
        "consensus_resilience_retries_total",
    ),
    "inflight": (
        "consensus_inflight_depth",
        "consensus_inflight_tickets_total",
        "consensus_inflight_settle_seconds",
    ),
    "pipeline": (
        "consensus_pipeline_phase_seconds",
        "consensus_pipeline_overlap_efficiency",
        "consensus_pipeline_stream_window",
    ),
    "prover": (
        "consensus_scalar_certificates",
        "consensus_glv_split_range_total",
    ),
    "device-truth": (
        "consensus_kernel_region_seconds",
        "consensus_xprof_busy_fraction",
        "consensus_xprof_captures_total",
    ),
    "flight": (
        "consensus_flight_armed",
        "consensus_flight_events_total",
        "consensus_flight_dumps_total",
    ),
    "spans": (
        "consensus_span_duration_seconds",
    ),
}


def required_metrics(device: str) -> List[str]:
    """The names `--check` requires on `device` ("cuda" or "cpu")."""
    return [name for group, names in REQUIRED_METRICS.items()
            if device == "cuda" or group != "device-truth" for name in names]


def _expect(code, fn, *args, **kw) -> None:
    from .. import api

    try:
        fn(*args, **kw)
    except api.ConsensusError as e:
        if e.code != code:
            raise AssertionError(f"expected {code.name}, got {e.code.name}") from e
    else:
        raise AssertionError(f"expected {code.name}, got success")


def _sampled(name: str) -> bool:
    from . import get_registry

    m = get_registry().get(name)
    return m is not None and bool(m._samples())


def run_workload(device: str = "cuda") -> dict:
    """The seeded workload on `device`; returns what it checked (verdicts and
    the capture report on the card). Raises where a verdict is not the
    expected one. The device capture and the scalar certificates run only
    where this process's registry holds none yet."""
    from .. import api
    from .. import native_bridge as NB
    from ..analysis import scalar_check
    from ..core.flags import VERIFY_ALL_EXTENDED
    from ..crypto import glv
    from ..crypto.torch_backend import SigCheck, TorchSecpVerifier
    from ..models.batch import BatchItem, verify_batch, verify_batch_stream
    from ..models.sigcache import ScriptExecutionCache, SigCache
    from ..models.validate import connect_block
    from ..parallel import ShardedSecpVerifier, make_mesh
    from ..resilience import FaultPlan, FaultSpec, inject
    from ..utils import blockgen
    from . import flight, spans, xprof

    dev = "cuda:0" if device == "cuda" else "cpu"
    out: dict = {"device": dev}

    # -- api: one success per entry point, one of each rejection ------------
    _view, funded = blockgen.make_funded_view(8, seed="stats")
    tx = blockgen.build_spend_tx(funded[:4])
    raw = tx.serialize()
    outs = [(f.amount, f.wallet.spk) for f in funded[:4]]
    api.verify_with_spent_outputs(raw, 0, outs)
    pk_fund = [f for f in funded if f.wallet.kind == "p2pkh"][0]
    pk_raw = blockgen.build_spend_tx([pk_fund]).serialize()
    api.verify(pk_fund.wallet.spk, pk_fund.amount, pk_raw, 0)
    api.verify_with_flags(pk_fund.wallet.spk, pk_fund.amount, pk_raw, 0, 0)
    _expect(api.Error.ERR_TX_DESERIALIZE, api.verify, b"\x51", 0, b"junk", 0)
    _expect(api.Error.ERR_INVALID_FLAGS, api.verify_with_flags, b"\x51", 0, raw,
            0, 1 << 30)
    _expect(api.Error.ERR_TX_INDEX, api.verify_with_spent_outputs, raw, 99, outs)
    bad_raw = blockgen.build_spend_tx(funded[:4], corrupt_input=1).serialize()
    _expect(api.Error.ERR_SCRIPT, api.verify_with_spent_outputs, bad_raw, 1, outs)

    # -- batch drivers, caches, dispatch: a mixed batch with one bad input,
    # then its replay (cache hits), in index mode, the wire driver and the
    # Python engine --------------------------------------------------------
    items = [BatchItem(raw, i, VERIFY_ALL_EXTENDED, spent_outputs=outs)
             for i in range(4)]
    items.append(BatchItem(bad_raw, 1, VERIFY_ALL_EXTENDED, spent_outputs=outs))
    want = [True] * 4 + [False]
    verifier = TorchSecpVerifier(device=dev)
    sig, script = SigCache(), ScriptExecutionCache()
    for _pass in range(2):
        got = [r.ok for r in verify_batch(items, verifier=verifier, sig_cache=sig,
                                          script_cache=script)]
        if got != want:
            raise AssertionError(f"index mode gave {got}, want {want}")
    saved = os.environ.get("BITCOINCONSENSUS_TPU_IDX")
    os.environ["BITCOINCONSENSUS_TPU_IDX"] = "0"
    try:
        got = [r.ok for r in verify_batch(items, verifier=verifier,
                                          sig_cache=SigCache(),
                                          script_cache=ScriptExecutionCache())]
    finally:
        if saved is None:
            os.environ.pop("BITCOINCONSENSUS_TPU_IDX", None)
        else:
            os.environ["BITCOINCONSENSUS_TPU_IDX"] = saved
    if got != want:
        raise AssertionError(f"the wire driver gave {got}, want {want}")
    py = TorchSecpVerifier(device=dev, engine="python")
    got = [r.ok for r in verify_batch(items, verifier=py, sig_cache=SigCache(),
                                      script_cache=ScriptExecutionCache(),
                                      engine="python")]
    if got != want:
        raise AssertionError(f"the Python engine gave {got}, want {want}")
    streamed = [[r.ok for r in res] for res in verify_batch_stream(
        iter([items[:3], items[3:]]), verifier=verifier, sig_cache=SigCache(),
        script_cache=ScriptExecutionCache(), depth=2)]
    if streamed != [want[:3], want[3:]]:
        raise AssertionError(f"the stream gave {streamed}")

    _serving_legs(items, verifier, sig, script, dev)

    # -- block: one valid block on a NativeCoinsView, then its replay ---------
    bview, bfunded = blockgen.make_funded_view(4, height=1, seed="stats-blk")
    good = blockgen.build_spend_tx(bfunded, fee=2000)
    blk = blockgen.build_block([good], height=200, fees=2000)
    nview = NB.NativeCoinsView()
    nview.add_coins_batch([(t, n, c.out.value, c.height, c.coinbase,
                            c.out.script_pubkey) for (t, n), c in bview._map.items()])
    r1 = connect_block(blk, nview, 200, check_pow=False, verifier=verifier,
                       sig_cache=SigCache(), script_cache=ScriptExecutionCache())
    r2 = connect_block(blk, nview, 200, check_pow=False, verifier=verifier,
                       sig_cache=SigCache(), script_cache=ScriptExecutionCache())
    if not r1.ok or r2.ok:
        raise AssertionError(f"block: {r1.reason!r}, replay {r2.reason!r}")

    # -- resilience: a corrupted verdict buffer, caught and retried clean -----
    with inject(FaultPlan([FaultSpec("torch_backend.verdict", "invert")]), seed=0):
        got = [r.ok for r in verify_batch(items, verifier=verifier,
                                          sig_cache=SigCache(),
                                          script_cache=ScriptExecutionCache())]
    if got != want or not verifier.stats["retries"]:
        raise AssertionError("the injected fault was not retried to the clean verdicts")

    # -- mesh: one sharded dispatch over 4 entries on the device, then one
    # injected device loss, which evicts an entry and answers its lanes again
    # over the survivors ------------------------------------------------------
    w = blockgen.Wallet("stats-mesh", "p2wpkh")
    msg = hashlib.sha256(b"stats-mesh-msg").digest()
    mchecks = [SigCheck("ecdsa", (w.pub, blockgen.sign_ecdsa(w.sk, msg), msg))] * 4
    sv = ShardedSecpVerifier(mesh=make_mesh(devices=[dev] * 4))
    res, verdict = sv.verify_checks_with_verdict(mchecks)
    if not (verdict and res.all()):
        raise AssertionError(f"the mesh gave {res.tolist()}, verdict {verdict}")
    sv2 = ShardedSecpVerifier(mesh=make_mesh(devices=[dev] * 4), evict_after=1)
    with inject(FaultPlan([FaultSpec("mesh.shard.1", "device-loss")]), seed=0):
        res2, verdict2 = sv2.verify_checks_with_verdict(mchecks)
    if not (verdict2 and res2.all()) or sv2.mesh.size != 3:
        raise AssertionError("the mesh did not evict the lost entry and answer again")

    # -- the adversarial gauntlet: a tiny replay stream, the pinned corpus
    # (per-shape latency histogram) and a handful of fuzz mutants light the
    # consensus_gauntlet_* family with its zero-divergence samples ---------
    from ..workloads import ReplayConfig, run_diff_fuzz, run_replay
    from ..workloads.corpus import run_corpus_check

    grep = run_replay(ReplayConfig(seed=5, n_blocks=2, txs_per_block=2),
                      verifier=verifier)
    if not grep["bit_identical"]:
        raise AssertionError(f"the gauntlet replay: {grep['divergences']}")
    crep = run_corpus_check(verifier=verifier)
    if not crep["pinned"]:
        raise AssertionError(f"the gauntlet corpus: {crep['mismatches']}")
    frep = run_diff_fuzz(seed=1, n_cases=8, verifier=verifier)
    if not frep["bit_identical"]:
        raise AssertionError(f"the gauntlet fuzz: {frep['divergences']}")

    # -- the scalar-schedule prover's fast certificates; the GLV range guard's
    # explicit zero samples (the split ran inside its proven bound) ----------
    if not _sampled("consensus_scalar_certificates"):
        certs = scalar_check.certify_all(quick=True, include_heavy=False)
        bad = [(c.name, c.status) for c in certs if not c.ok]
        if bad:
            raise AssertionError(f"scalar certificates failed: {bad}")
    for k in (1, glv.LAMBDA, (1 << 128) - 1):
        glv.split_lambda(k)
    glv._SPLIT_RANGE.inc(amount=0, half="k1")
    glv._SPLIT_RANGE.inc(amount=0, half="k2")

    # -- device truth and the flight recorder: a capture on the card, one
    # span through the armed recorder, one explicit trigger ----------------
    flight.set_enabled(True)
    try:
        if device == "cuda" and not _sampled("consensus_xprof_captures_total"):
            def run():
                verify_batch(items, verifier=verifier, sig_cache=SigCache(),
                             script_cache=ScriptExecutionCache())
            run()
            out["xprof"] = xprof.capture_report(run)
        with spans.span("stats.flight_leg"):
            pass
        out["flight_dump"] = flight.trigger(
            "stats", out_dir=os.path.join(flight._dump_dir(), "stats"))
        if out["flight_dump"] is None:
            raise AssertionError("the armed flight recorder wrote no dump")
    finally:
        flight.set_enabled(False)
    return out


def _serving_legs(items, verifier, sig, script, dev: str) -> None:
    """The serving, ingress, sigstore and cell legs of the workload, as the
    reference's gate drives them: `items` are four clean inputs and one
    bad, `sig` and `script` caches already warm with them."""
    import shutil
    import socket
    import tempfile
    import threading

    from .. import api
    from ..cell import ServingCell
    from ..cell.router import _C_RETRIED
    from ..models.batch import verify_batch
    from ..models.sigcache import ScriptExecutionCache
    from ..models.sigstore import PersistentSigCache
    from ..serving import IngressClient, IngressServer, VerifyServer
    from ..serving.ingress import encode_frame
    from .spans import monotonic

    def server(**kw):
        return VerifyServer(verifier=verifier, sig_cache=sig, script_cache=script, **kw)

    # -- serving: a coalesced fan-in from two tenants, then a deliberate
    # overload (tenant_depth=1, no time flush): both admission outcomes and
    # the shed counter sample --------------------------------------------------
    with server(max_batch=8, flush_s=0.005, tenant_depth=8) as srv:
        pend = [srv.submit(it, tenant=f"tenant{i % 2}") for i, it in enumerate(items[:4])]
        if [p.result(timeout=600).ok for p in pend] != [True] * 4:
            raise AssertionError("the serving fan-in gave a wrong verdict")
    srv2 = server(max_batch=64, flush_s=30.0, tenant_depth=1).start()
    queued = srv2.submit(items[0])
    _expect(api.Error.ERR_OVERLOADED, srv2.submit, items[1])
    srv2.close(drain=True)  # the draining close settles the queued request
    if not queued.result(timeout=600).ok or srv2.pending:
        raise AssertionError("the draining close left a request unsettled")

    # -- ingress: one socket round trip, a garbage frame, a reaped
    # slow-loris, against a short-idle listener --------------------------------
    with server(max_batch=8, flush_s=0.005, tenant_depth=8) as srv3:
        with IngressServer(srv3, idle_s=0.2) as ing:
            with IngressClient(port=ing.port, timeout_s=600) as cli:
                if not cli.verify(items[0]).ok:
                    raise AssertionError("the socket round trip gave a wrong verdict")
            with socket.create_connection(("127.0.0.1", ing.port), timeout=30) as s:
                s.sendall(encode_frame(0x7D, b"junk"))  # an unknown frame type
                s.recv(64)  # the typed ERR frame, then EOF
            with socket.create_connection(("127.0.0.1", ing.port), timeout=30) as s:
                s.sendall(b"\x01\x00\x00\x00\x40")  # a header, then a stall
                while s.recv(64):  # until the deadline reap closes it
                    pass

    # -- persistent sigstore: populate through the driver, reopen (replay),
    # the rerun warm; then a store whose directory vanishes mid-run ----------
    good = items[:4]
    with tempfile.TemporaryDirectory(prefix="stats-sigstore-") as sdir:
        with PersistentSigCache(sdir, hot_entries=64, shards=2,
                                warmup_min_probes=2) as store:
            verify_batch(good, verifier=verifier, sig_cache=store,
                         script_cache=ScriptExecutionCache(cache_label="ss1"))
        with PersistentSigCache(sdir, hot_entries=64, shards=2,
                                warmup_min_probes=2) as store2:
            if not len(store2):
                raise AssertionError("the reopened store replayed nothing")
            verify_batch(good, verifier=verifier, sig_cache=store2,
                         script_cache=ScriptExecutionCache(cache_label="ss2"))
            if store2.warmup_s is None:
                raise AssertionError("the rerun over the reopened store was not warm")
    sdir2 = tempfile.mkdtemp(prefix="stats-shard-moved-")
    store3 = PersistentSigCache(sdir2, hot_entries=16, shards=2)
    shutil.rmtree(sdir2)
    store3.add_key(b"\x07" * 32)  # the lazy shard open finds the directory gone
    if store3.peek_key(b"\x07" * 32) or len(store3):
        raise AssertionError("a moved shard kept answering")
    store3.close()

    # -- the cell: two stub replicas on `dev` behind the router; kill one and
    # drive eviction, shard handoff, reroute and re-promotion for real --------
    with tempfile.TemporaryDirectory(prefix="stats-cell-") as root:
        with ServingCell(n_replicas=2, root_dir=root, stub=True, device=dev,
                         server_kw=dict(max_batch=8, flush_s=0.005),
                         evict_after=1, backoff_s=0.02, max_backoff_s=0.05) as cell:
            with IngressClient(port=cell.port, timeout_s=600) as cli:
                if not cli.verify(items[0], tenant="cell-t0").ok:
                    raise AssertionError("the cell gave a wrong verdict")
                victim = cell.router._home.lookup("cell-t0")
                cell.replicas[victim].kill()
                cell.tick()  # dead: evicted, its shards handed off
                if victim in cell.healthy_names():
                    raise AssertionError("the killed replica was not evicted")
                if not cli.verify(items[0], tenant="cell-t0").ok:  # rerouted
                    raise AssertionError("the rerouted verdict is wrong")
                deadline = monotonic() + 600
                pause = threading.Event()
                while victim not in cell.healthy_names() and monotonic() < deadline:
                    pause.wait(0.02)
                    cell.tick()  # restart and a passing known-answer probe
                if victim not in cell.healthy_names():
                    raise AssertionError("the replica was not re-promoted")
    _C_RETRIED.inc(0)  # an explicit zero: no frame in flight at a link's death


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda:0 (the default) or the plain version on the CPU")
    ap.add_argument("--format", choices=("json", "prom"), default="json",
                    help="stdout exposition format (default: json)")
    ap.add_argument("--out", help="also write the JSON document to this path")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on a required metric missing or without "
                    "samples, or a value not finite")
    args = ap.parse_args(argv)

    from . import get_registry
    from .exposition import snapshot_to_json, to_prometheus_text, validate_snapshot

    run_workload(args.device)
    snap = get_registry().snapshot()
    doc = snapshot_to_json(snap, device=args.device)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(doc + "\n")
    if args.format == "prom":
        sys.stdout.write(to_prometheus_text(snap))
    else:
        print(doc)

    if args.check:
        problems = validate_snapshot(snap, required_metrics(args.device))
        with_samples = [n for n in snap if snap[n]["samples"]]
        print(f"# {len(with_samples)} metrics with samples, "
              f"{len(problems)} problems", file=sys.stderr)
        for p in problems:
            print(f"PROBLEM: {p}", file=sys.stderr)
        if problems:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
