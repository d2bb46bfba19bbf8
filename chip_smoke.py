#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. The card: nvidia-smi name and power limit, torch and CUDA versions.
2. Build every kernel from `bitcoinconsensus_tpu_torch/csrc` with nvcc (the
   verify kernel and its checked launch, the verdict checksum, the four
   SHA-256 kernels, the mesh's shard-step epilogue and the toys), and
   the native host core (`csrc/native/`) and the host build of the verify
   kernel's lane program (`csrc/verify_tiles_host.cpp`, for the scalar
   prover) with g++, one process per source, all started together; print
   each build time and the ptxas registers and spills.
3. Main path: 10,000 seeded inputs in the replay mix (55% p2wpkh, 20% p2tr,
   15% p2pkh, 10% p2wsh 2-of-3; about 1% carry a corrupted signature) go
   through one `verify_batch` on cuda:0 on the native host engine in index
   mode (`[main_path]`), through one in the wire driver
   (`[main_path_wire]`, BITCOINCONSENSUS_TPU_IDX=0) and through one on the
   Python engine (`[main_path_python]`), each with fresh caches; all three
   must give the same verdicts item for item (`[engines]`); the two native
   drivers then run again in turns, wire, index, index, wire
   (`[drivers_turns]`), since a process's first call pays one-time costs.
   Every clean
   input must be accepted, every corrupted one rejected with ERR_SCRIPT and
   the ScriptError of the exact per-input `api` path on its Python engine,
   and 64 sampled clean inputs must match that path bit for bit. Then the
   same inputs in 5 batches of 2,000 through `verify_batch_stream` at depth
   2, in 3 rounds in turns with one `verify_batch` per batch (`[stream]`:
   every time, every batch's verdicts equal), the kernel held to its plain
   version on every lane of the stream's first dispatch
   (`[stream_compare]`), and a stream closed after its first yield, which
   must leave no dispatch unsettled (`[stream_close]`). Then the block of
   BASELINE.json config 5 (3,200 inputs in 400 txs, 4,000 signatures, as
   scripts/bench_configs.py builds it) through `connect_block` on a
   NativeCoinsView, 5 times with fresh caches (`[block]`: best and median
   ms, the phase split, launches, padded lanes, kernel ms in the pipeline
   and warmed on the same lanes), held to a plain CoinsView on the Python
   engine; the kernel held to its plain version on every lane the block
   dispatched (`[block_compare]`); those lanes, and the index session's,
   byte-equal to `prep_pack` of the checks the wire protocol records for
   the block, and the session's cache keys equal to the sig cache's
   (`[block_lanes]`); 64 sampled inputs' results equal to the per-input
   `api` on its Python engine (`[block_exact]`); and the block with one
   corrupted signature, rejected alike by both, the bad tx's inputs as the
   per-input `api` says (`[block_reject]`). Each path's kernel launches are
   read around it alone: each dispatch must be one checked verify launch
   (`vt_verify_tiles_checked`, the verify kernel with its epilogue) that
   carries the verdict checksum's partials, and no unchecked verify or
   standalone checksum launch may run: every dispatch is guarded (sentinel
   lanes in its pad, the checksum, `validate_verdict`). Then
   `[guards]`: the main path, the block and the stream with
   BITCOINCONSENSUS_TPU_CHECKSUM on and off in turns, every verdict equal,
   sentinel lanes per dispatch, the checked launches and those carrying
   partials reported; and
   `[chaos]`: each fault kind at each of the port's sites
   (`torch_backend.dispatch`, `torch_backend.verdict`, `batch.dispatch`,
   `sigcache.sig` under the cache audit), once transient and once
   persistent, over 2,000 of the inputs: a transient fault gives the clean
   verdicts, a persistent one raises what the site raises, and no case
   returns a wrong ACCEPT. The telemetry (`obs/`): each `[main_path*]`
   line carries its call's split by span self time (`span_self_ms`), and
   `[block]`'s `split_ms` is the best run's span split, its `residual` what
   no span covers (`[block_split]`: each step's ms and share). `[obs]`: the
   main path and the block with telemetry armed (a JSONL span sink, phase
   timelines) and disarmed, in six rounds of turns each, every verdict
   equal (`scripts/torch_obs_gate.py` runs these turns alone, many times,
   with host readings beside each call). `[xprof]`: a
   torch.profiler capture around a warmed main path and a warmed block:
   device seconds by region and by kernel symbol (`vt_verify_checked_kernel`
   on `verify_tiles`, none of the port's kernels unattributed), the
   device's busy share of the window and
   its five longest idle gaps with the host spans open over them; the
   reports go to the output directory (`--out-dir`, by default
   build/chip_smoke/) as xprof_*.json. Then the device SHA-256 paths, after
   all of the above so that those phases run as they did before them:
   `[challenge_path]`, the main path's inputs on the Python engine with
   `device_challenge` off and on, in turns (off, on, on, off): verdicts
   equal to `[main_path]`'s, the challenge kernel launched (> 0 on, 0 off),
   the Schnorr lanes hashed on the card, `lane_prep_s` both ways, and the
   host's `tagged_hash` over the same checks; `[merkle]`,
   `merkle_root_device` on the card against the host `merkle_root` (root
   and flag) at 1 to 262,144 seeded leaves (512 and 513 at a chunk's
   edge), the block's txids, duplicated sibling pairs (one across two
   chunk roots) and odd tails, both timed, one tree launch a root and no
   level launch; then the tree against the old level sequence in turns,
   by the host clock and on the device, at the block's txids and at
   262,144 leaves; `[block_device_sha]`, the block on the Python block
   layer and engine with `device_merkle` and `device_challenge`, equal to
   the native `[block]`, its corrupted twin rejected alike, launching the
   merkle tree (once), challenge and checked verify kernels; and one more
   `[xprof]` capture, of that path, which must charge
   `sh_merkle_tree_kernel` to `sha256_compress` and `sh_challenge_kernel`
   to `sighash_prep`.
4. Lane packing: the native core's packed lanes of the first 8,192 checks
   byte-equal to the Python packers', pad lanes included (`[lane_pack]`,
   both host times). Kernel against its plain version on the card: those
   lanes, a few hundred perturbed and one crafted collision lane; `ok`
   and `needs_host` must be bit-identical. Times by CUDA events; the
   operation bound counts the schedule's field squares and multiplies on
   these inputs. Every launch takes the contract's dynamic shared bytes,
   which the C launcher refuses unless they are the kernel's. Then its
   field layer alone against the integer model on edge and seeded operands,
   its signed recoder alone (`vt_recode`, `[recode]`) on the carry
   automaton's 1,584 lanes, 32,768 seeded 128-bit values and the edges (0,
   2^128 - 1, each 16·32^w boundary) against the plain torch recoder, the
   `.cu`'s own recoder built with g++ and an independent Python recoder
   (signed digits, tolerance 0, with the kernel's ms), and a width sweep: kernel ms at 64, 4,908, 8,192 and 32,768 lanes (the
   panel tiled), each compared with the plain version on a sample of lanes,
   with the SM clock and power draw read while it runs back to back. Then
   `[verify_epilogue]`: the checked launch at the sweep widths and at 4,100
   and 8,191 lanes against the unchecked kernel and the plain version
   (verdicts), the standalone checksum kernel and its plain version (summed
   partials) and the plain epilogue (each warp's), and at the mesh layouts
   1 x 8,192, 4 x 2,048, 8 x 1,024 and 4 x 16 (one launch a shard, a live
   mask) against the shard epilogue kernel and its plain version, tolerance
   0; at 8,192 lanes in turns, the checked launch against the sequence a
   dispatch made before (verify, two `!=`, checksum) by CUDA events and on
   the device, and the mesh's per-card sequence before and after at 4 x
   2,048; the epilogue's marginal device cost; the port's launches per
   dispatch on the main path, block, stream and mesh, and the main path's
   device kernels per dispatch. Then
   the verdict checksum kernel against its plain version at 16 widths from
   1 to 32,768 lanes, random, all-true and all-false buffers, with its time
   per call beside the two-call PyTorch equivalent (in turns), its device
   time and its bound at the sweep widths (`[checksum]`). Then `[sha256]`:
   each of the five SHA-256 kernels against its plain version on the card
   at 1, 2,048, 8,192 and 262,144 lanes (tolerance 0; the fixed hash also
   on a view one byte past an aligned address, the tree with its depth)
   and on 256 lanes against hashlib, with its time per call, device time,
   plain time and bound, and at the width its path gives it.
5. The kernel prover (`analysis/registry.py`), after the main path so that
   its tracing leaves the main path's timing alone: every non-heavy entry
   must prove, `verify_tiles`'s launch contract included (8,192 and 4,908
   lanes); the positive toy must prove and each planted defect be rejected
   with its kind. Then the scalar-schedule prover: every schedule target
   (the two ladder ledgers and the G-table certificate included; the carry
   automaton drives `vt_recode` on the card) must be a THEOREM, and each
   `scalar-*` negative must be rejected.
6. The toys, each through its wrapper on cuda:0 once (launch counts read
   around this drive alone) on seeded inputs inside its declared bounds:
   positive (8, 256), mul (20, 256) W2-bounded limbs, the three float32
   toys and the float output fixture (8, 256), and the three planted
   defects instrumented (8, 256). Each is held to its plain version on the
   card at tolerance 0 (the defects: output, write counts and faults), and
   timed by CUDA events per call (`ms`: what a caller waits, the wrapper's
   host cost included; the median of 7 rounds of 200 calls, and where one
   PyTorch call computes the same function, the two are timed in turns) and by
   torch.profiler on the card alone (`device_ms`).
   Where one PyTorch call sequence computes a toy's function (`x + 1`; the
   dot toys' column of X X^T by `einsum`; the float squares), it is timed in
   turns with the toy, and its output held to the toy's
   (`library_max_abs_err`).
7. `[stats]`: the stats gate (`python -m bitcoinconsensus_tpu_torch.obs.stats
   --check --device cuda`, in this process): every metric the ported
   layers must light has samples, the gauntlet's five among them
   (snapshot in the output directory).
8. The mesh (`parallel/mesh.py`), after everything above so that those
   phases run in the state they had before it. `[shard_step]`: the
   epilogue kernel `ss_epilogue_kernel` against its plain version at 2 x
   4,096, 4 x 2,048, 8 x 1,024 and 4 x 16 rows (seeded, all-true and
   all-false buffers; differing words 0), with its time per call, device
   time, plain time, bound and the fewest PyTorch calls for the same
   triple, in turns. `[mesh]`: a ShardedSecpVerifier over 4 entries of
   cuda:0, each on its own stream: the main path's inputs through
   `verify_batch`, the config-5 block through `connect_block` and the
   stream's 5 batches, each with its launches counted around it alone
   (one checked verify launch a shard carrying its checksum and failure
   partials; the unchecked verify, the standalone epilogue and the checksum
   kernel never) and every verdict equal to the single-device
   runs'; `verify_checks_with_verdict`'s all_ok on a clean and a bad batch;
   the main path sharded against single in turns (a figure for the record,
   not a claim); and `make_mesh()` on the one card, which must dispatch as
   the base verifier (mesh_dispatches=0). NCCL and peer copies between
   cards are not exercised: the entries share one card. `[mesh_faults]`:
   the fault harness on that mesh, one line a case (a flip convicted by its
   shard's checksum, a device loss that evicts and rebuilds over 3 entries,
   re-promotion after a clean probe, a failed probe, a straggle past the
   shard deadline, every shard failing into DispatchFailed), each
   `held=True wrong_accepts=0`. `[xprof]` of one sharded dispatch:
   `vt_verify_checked_kernel` charged to `verify_tiles`, no
   `ss_epilogue_kernel`.
9. The service, after everything above (`serving/`, `models/sigstore.py`,
   `cell/`). `[serve]`: the main path's inputs from 8 client threads over 4
   tenants through one `VerifyServer` on cuda:0 (default `max_batch`, the
   lane capacity, and flush), each thread submitting its share without
   waiting and retrying a shed with `verify_with_retry`: every verdict equal
   to `[main_path]`'s, every request settled, 0 pending after the draining
   close; admitted, sheds by reason, batches, mean fill, settle p50/p99,
   inputs/s and launches; the same run again with a span sink (each span
   name's summed ms and count). Then 2,000 with BITCOINCONSENSUS_TPU_SERVE_SLO_S
   at 0.0001 (sheds explicit, `ERR_OVERLOADED`) and 2,000 with dispatch
   faults armed (a first wave failing with `DispatchFailed`, a second
   retried clean, 0 wrong ACCEPTs, the server serving after). `[ingress]`:
   2,000 through `IngressServer` over 4 pipelined sessions; on the same
   server a garbage frame, an oversized frame, a mid-frame disconnect and a
   slow-loris reaped at the idle deadline beside 4 well-behaved
   `IngressClient`s; `ingress.read` / `ingress.write` faults recovered by
   the retrying client. `[sigstore]`: the 10,000 through `verify_batch`
   with a `PersistentSigCache`, cold, then reopened (every persisted entry
   a hit, none dispatched again; appends, replay records, open and warm-up
   seconds); a poisoned persisted entry caught by the audit and kept out
   across a reopen; a torn tail healed as misses. `[cell]`: a
   `ServingCell` of two replica subprocesses on cuda:0 started together
   (the pids `nvidia-smi --query-compute-apps` shows), 2,000 inputs from 4
   tenants through the router, a SIGKILL of one replica under 2,000 more
   (0 lost admitted verdicts, eviction within `evict_after` ticks with a
   flight dump, the survivor warm on the moved tenants' inputs, a tombstone
   kept), `cell.route` faults, `no_replica` with both replicas down, and
   both re-promoted through passing known-answer probes.
10. The gauntlet (`workloads/`), after everything above, on one verifier
   on cuda:0, each leg's launches counted around it alone. `[gauntlet]
   leg=corpus`: the 26 pinned cases on the Python engine, the native core
   and `verify_batch` (0 mismatches, the native core present, each shape's
   `consensus_gauntlet_shape_seconds`); `leg=corpus_lanes`: the
   scalar-edge, fan-out and taproot cases' checks packed by `prep_pack`,
   the checked launch against `verify_tiles_reference` on the card lane for
   lane (tolerance 0) and every decided lane against the host oracle;
   `leg=fuzz`: 500 mutants over the five seeds of
   `fuzz/gauntlet_seeds.json`, three engines, 0 divergences, cases by
   mutation kind; `leg=replay`: `run_replay` at config 5's block width
   (seed 0, 4 blocks of about 400 transactions of up to 15 inputs, half
   again as mempool batches), bit-identical to the Python oracle (judged
   in worker processes) and cache-warmed, with inputs/s of the stream;
   `leg=serve|ingress|overload|cell`: the reference's CI-size stream
   through a `VerifyServer`, the socket ingress, an overloaded server and
   a two-stub `ServingCell`, all accounted, sheds explicit (and happening
   when overloaded). `[gauntlet_chaos]`: the ten trials of
   `python -m bitcoinconsensus_tpu_torch.workloads --chaos`, one line
   each, each `held=True` with 0 wrong ACCEPTs.
11. A `kernels` JSON line (each path's checked verify launches; the
   unchecked verify kernel's, the standalone checksum's and epilogue's
   counted around their own drives, as the toys'; the SHA-256 kernels';
   the cell's replicas launch in their own processes, read over their
   control channels), the card line, and the result line.

The script needs the repository beside it; with no CUDA device, or alone in
a directory, it exits non-zero without a result. `--rehearse-cpu` runs the
same phases on the CPU at a small size (plain versions, no build) and also
exits non-zero: a rehearsal is never a result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM integer rate used for the operation bound: 132 SMs x 64 int32
# multiply-adds per SM per clock x 1.98 GHz boost clock.
H100_INT32_OPS = 132 * 64 * 1.98e9
H100_BYTES_PER_S = 3.35e12
# Published peaks (NVIDIA's H100 SXM data sheet, dense).
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12
# int32 operations per 256-bit field multiply and square, the yardstick of
# the bound: 32x32->64 multiply-accumulates at 3 int32 operations each (a
# wide multiply-add is two, the carry add one), 64 for a multiply and 36 for
# a square (each cross product once, and the diagonal), plus about 48 for
# the reduction mod p, as counted from the first kernel's source. It counts
# the work the schedule needs, not any one kernel's instructions, so every
# version of the kernel is held to one bound.
INT_OPS_PER_FE_MUL = 64 * 3 + 48
INT_OPS_PER_FE_SQR = 36 * 3 + 48
SWEEP_WIDTHS = (64, 4908, 8192, 32768)
P = 2**256 - 2**32 - 977
TOYS = "bitcoinconsensus_tpu/analysis/pallas_check.py"
TOY_SOURCE = "bitcoinconsensus_tpu_torch/csrc/toy_kernels.cu"


def _line(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _import_port():
    sys.path.insert(0, HERE)
    try:
        import bitcoinconsensus_tpu_torch as port
    except ImportError as e:
        print(f"FAIL: the port package is not beside chip_smoke.py ({e})",
              file=sys.stderr)
        sys.exit(2)
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        print("FAIL: bitcoinconsensus_tpu_torch was imported from outside "
              "this checkout", file=sys.stderr)
        sys.exit(2)
    return port


def _nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        _fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def _fe_ops_per_lane(fields, valid_in):
    """(squares, multiplies) of field elements each lane of the kernel
    performs on these inputs, following csrc/verify_tiles.cu's control flow:
    fixed lift and table work, 5 doublings per window once R is finite, one
    mixed add per nonzero digit (the first one of each ladder is a free
    lift), the join, and the affine step for lanes that reach it."""
    import numpy as np

    # (squares, multiplies) of each piece of the schedule.
    LIFT = (1 + 253 + 1, 1 + 13)  # x^3, the (p+1)/4 chain, the square check
    # one doubling, 14 mixed adds, the rescale: a running product of the
    # ratios, then per row c^2, c^3 and the two coordinates
    TABLE = (5 + 14 * 4 + 15, 2 + 14 * 7 + 14 + 15 * 3)
    DBL, MADD, JOIN = (5, 2), (4, 7), (5, 11)
    AFFINE = (255 + 1, 15 + 3)  # the p-2 chain, then Z^-2 and Z^-3 applied
    counts = np.zeros((fields.shape[0], 2), dtype=np.int64)
    for i in range(fields.shape[0]):
        b1 = int.from_bytes(fields[i, 1, :16].tobytes(), "little")
        b2 = int.from_bytes(fields[i, 1, 16:].tobytes(), "little")
        d1, d2 = _signed_mags(b1), _signed_mags(b2)
        dbl = madd = beta = 0
        r_inf = True
        for w in range(25, -1, -1):
            if not r_inf:
                dbl += 5
            for d, h in ((d1[w], 0), (d2[w], 1)):
                if d:
                    beta += h
                    madd += 0 if r_inf else 1
                    r_inf = False
        g = [b for b in fields[i, 0].tobytes() if b]
        madd += max(len(g) - 1, 0)
        x = int.from_bytes(fields[i, 2].tobytes(), "little") % P
        rhs = (x * x * x + 7) % P
        residue = pow(rhs, (P - 1) // 2, P) in (0, 1)
        affine = 1 if (valid_in[i] and residue) else 0
        for k in (0, 1):
            counts[i, k] = (LIFT[k] + TABLE[k] + dbl * DBL[k] + madd * MADD[k]
                            + JOIN[k] + affine * AFFINE[k])
        counts[i, 1] += beta + 1  # the λ half's x·β; back to the true Z
    return counts[:, 0], counts[:, 1]


def _mul_toy_ops_per_column() -> int:
    """int32 operations of `tk_fe_mul_col` in csrc/toy_kernels.cu, counted
    from the source: 400 multiply-adds for the columns; a carry pass over n
    limbs 3 per limb (shift, mask, add) plus 3 where its top carry wraps; a
    fold 3 multiply-adds per high limb."""
    from bitcoinconsensus_tpu_torch.ops import limbs as L

    ops, n = L.NLIMB * L.NLIMB, 2 * L.NLIMB - 1
    for step in L._settle_plan(tuple(L._MUL_BOUNDS)):
        if step == "fold":
            ops += 3 * (n - L.NLIMB)
            n = max(L.NLIMB, n - L.NLIMB + 2)
        else:
            ops += 3 * n + (3 if step == "pass:wrap" else 0)
            n += step == "pass:append"
    return ops


def _bound(nbytes: float, ops: float, rate: float = H100_INT32_OPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the rate of their type (int32 by default)."""
    byte_ms = nbytes / H100_BYTES_PER_S * 1e3
    op_ms = ops / rate * 1e3
    return max(byte_ms, op_ms), ("operations" if op_ms >= byte_ms else "bytes")


def _timed(fn, reps, device):
    """Mean ms per call: CUDA events around `reps` calls after one warm-up
    call on the card; the host clock on the CPU."""
    import torch

    if device.type == "cuda":
        fn()
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize(device)
        return e0.elapsed_time(e1) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def _clocks_during(fn, seconds=0.6):
    """The card's SM clock (MHz) and power draw (W) read by nvidia-smi while
    `fn` runs back to back for about `seconds`."""
    import threading

    import torch

    seen = {}

    def read():
        time.sleep(seconds / 2)
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=60)
        seen["smi"] = proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else ""

    th = threading.Thread(target=read)
    th.start()
    t0 = time.perf_counter()
    while th.is_alive() or time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    th.join()
    parts = [p.strip() for p in seen.get("smi", "").split(",")]
    return (parts + ["?", "?"])[:2]


def _timed_turns(fns, reps, rounds, device):
    """Median ms per call of each of `fns`, timed as `_timed` does in turns
    (a, b, ..., then the reverse order, `rounds` times over), so that the
    host's drift between them cancels."""
    import statistics

    times = [[] for _ in fns]
    for r in range(rounds):
        order = list(range(len(fns)))
        for i in (order if r % 2 == 0 else order[::-1]):
            times[i].append(_timed(fns[i], reps, device))
    return [statistics.median(t) for t in times]


def _device_ms(fn, reps, kernel: str):
    """Mean device time a launch of the CUDA kernels whose name holds
    `kernel`, read through `_device_kernels`' capture (a discarded warm-up
    step of `reps` calls, then `reps` calls); None (not measured) where the
    profiler fails or shows no device time for them."""
    got = _device_kernels(fn, reps) or {}
    hits = [(ms, n) for sym, (ms, n) in got.items() if kernel in sym]
    launches = sum(n for _, n in hits)
    return sum(ms * n for ms, n in hits) / launches if launches else None


class _ListSink:
    """Keeps the span records of the runs it is attached to."""

    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def _span_split(records, root: str):
    """{span: self ms} over the span trees under `root`, largest first: each
    span's time less its children's, so the split of a call adds up to it
    and the root's own entry is what no span inside it covers."""
    from bitcoinconsensus_tpu_torch.obs import perf

    split = perf.span_self_seconds(records, root=root)
    return {k: round(v * 1e3, 4)
            for k, v in sorted(split.items(), key=lambda kv: -kv[1])}


def _prover() -> None:
    """Every non-heavy registry entry proves; the positive toy proves and
    every planted defect is rejected with its kind; every scalar-schedule
    target is a THEOREM and every scalar negative is rejected."""
    from bitcoinconsensus_tpu_torch.analysis import kernel_check as K
    from bitcoinconsensus_tpu_torch.analysis import registry

    bad = []
    if "cuda.verdict_checksum" not in [s.name for s in registry.all_kernels(False)]:
        bad.append("cuda.verdict_checksum is not registered")
    for spec in registry.all_kernels(include_heavy=False):
        t0 = time.perf_counter()
        rep = spec.analyze()
        _line("prover", entry=spec.name, ok=rep.ok, nodes=rep.n_nodes,
              grid=json.dumps(rep.grid), violations=len(rep.violations),
              seconds=f"{time.perf_counter() - t0:.2f}")
        if not rep.ok:
            bad.append(f"{spec.name}: {rep.violations[:2]}")
    t0 = time.perf_counter()
    rep = K.analyze_positive_toy()
    _line("prover", entry="toy.positive", ok=rep.ok, grid=json.dumps(rep.grid),
          smem_bytes=rep.smem_peak_bytes, out_rows=len(rep.out_bounds[0]),
          seconds=f"{time.perf_counter() - t0:.2f}")
    if not rep.ok or rep.out_bounds[0] != [(1, 101)] * 8:
        bad.append(f"toy.positive: {rep.violations[:2]} {rep.out_bounds[:1]}")
    for name, kind in K.NEGATIVE_KINDS.items():
        t0 = time.perf_counter()
        rep = K.analyze_negative(name)
        kinds = sorted({v.kind for v in rep.violations})
        rejected = not rep.ok and kind in kinds
        _line("prover", entry=f"negative.{name}", rejected=rejected,
              want=kind, kinds=",".join(kinds),
              seconds=f"{time.perf_counter() - t0:.2f}")
        if not rejected:
            bad.append(f"negative {name} not rejected with {kind}: {kinds}")
    from bitcoinconsensus_tpu_torch.analysis import scalar_check as SC

    t_leg = time.perf_counter()
    for spec in registry.all_schedules():
        t0 = time.perf_counter()
        cert = spec.certify()
        SC.emit_certificates([cert])
        _line("prover", schedule=spec.name, status=cert.status,
              facts=",".join(sorted(cert.facts)),
              seconds=f"{time.perf_counter() - t0:.2f}")
        if not cert.ok:
            bad.append(f"{spec.name}: {cert.status} {cert.failures[:2]}")
    for name in sorted(SC.NEGATIVES):
        t0 = time.perf_counter()
        rep = SC.analyze_negative(name)
        rejected = not rep.ok and any(v.kind == "schedule" for v in rep.violations)
        _line("prover", entry=f"negative.{name}", rejected=rejected,
              want="schedule", seconds=f"{time.perf_counter() - t0:.2f}")
        if not rejected:
            bad.append(f"scalar negative {name} not rejected")
    _line("prover", schedule_leg_seconds=f"{time.perf_counter() - t_leg:.2f}")
    if bad:
        _fail("kernel prover: " + "; ".join(bad))


def _ptxas(log: str, kernel: str):
    """registers, stack frame, spill stores and loads, and static shared
    bytes of `kernel` from nvcc's `-Xptxas -v` output (None where absent)."""
    out = dict(registers=None, stack_frame=None, spill_stores=None,
               spill_loads=None, static_smem=0)
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and kernel in ln:
            for nxt in lines[i + 1:i + 3]:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", nxt)
                if m:
                    out.update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                               spill_loads=int(m[3]))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    out["registers"] = int(m[1])
                m = re.search(r"(\d+) bytes smem", nxt)
                if m:
                    out["static_smem"] = int(m[1])
    return out


def _field_check(VT, device, rng):
    """The kernel's field layer on the card against the integer model, every
    operation, on edge values and seeded operands: the number of words that
    differ."""
    import torch

    p = 2**256 - 0x1000003D1
    edge = [0, 1, p - 1, p, p + 1, 2**256 - 1, 2**255, 0x1000003D1]
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(512)]
    lazy = [p + int(rng.integers(0, 0x1000003D1)) for _ in range(64)]
    a = [x for x in edge for _ in edge] + rand + lazy
    b = [y for _ in edge for y in edge] + rand[::-1] + lazy[::-1]
    aw = torch.from_numpy(VT.ints_to_words(a).copy())
    bw = torch.from_numpy(VT.ints_to_words(b).copy())
    bad = 0
    for op, k in [("mul", 0), ("sqr", 0), ("add", 0), ("sub", 0),
                  ("mul_int", 2), ("mul_int", 8), ("canon", 0), ("is_zero", 0)]:
        got = VT.field_op(op, aw.to(device), bw.to(device), k).cpu()
        want = VT.field_op(op, aw, bw, k)
        bad += int((got != want).sum())
    return len(a), bad


def _recode_check(VT, device, rng, card: str, rehearse: bool) -> None:
    """The kernel's signed recoder alone (`vt_recode` on the card) on the
    carry automaton's lanes, seeded values and the edges, against the plain
    torch recoder, the `.cu`'s recoder built with g++ and the prover's
    independent Python recoder: signed digits, tolerance 0."""
    import numpy as np
    import torch

    from bitcoinconsensus_tpu_torch.analysis import scalar_check as SC

    t_phase = time.perf_counter()
    auto = [x for x, _, _, _ in SC.automaton_lanes()]
    n_rand = 256 if rehearse else 32_768
    rand = [int.from_bytes(rng.bytes(16), "little") for _ in range(n_rand)]
    edges = [0, (1 << 128) - 1] + [v for w in range(26) for v in
                                   (16 * 32 ** w - 1, 16 * 32 ** w)
                                   if v < 1 << 128]
    xs = auto + rand + edges
    words = SC.values_to_words(xs)
    dev = torch.from_numpy(words).to(device)
    mag, sgn = VT.recode(dev)
    got = SC.signed_digits(mag.cpu().numpy(), sgn.cpu().numpy())
    plain = SC.signed_digits(*(t.numpy() for t in VT.recode(torch.from_numpy(words))))
    t0 = time.perf_counter()
    host = SC.signed_digits(*SC.host_recode(words))
    host_s = time.perf_counter() - t0
    ref = np.array([SC._ref_signed_recode(x) for x in xs], dtype=np.int64)
    diff = {k: int((got != v).any(axis=1).sum())
            for k, v in (("plain", plain), ("host_build", host), ("python", ref))}
    ms = _timed(lambda: VT.recode(dev), 1 if rehearse else 20, device)
    _line("recode", values=len(xs), automaton=len(auto), random=n_rand,
          edges=len(edges), tolerance=0,
          **{f"differing_{k}": v for k, v in diff.items()},
          kernel_ms=f"{ms:.5f}", host_recode_s=f"{host_s:.4f}",
          seconds=f"{time.perf_counter() - t_phase:.2f}", card=json.dumps(card))
    if any(diff.values()):
        _fail(f"the kernel's recoder disagrees: {diff}")


def _signed_mags(v: int):
    out, carry = [], 0
    for w in range(26):
        t = ((v >> (5 * w)) & 31) + carry
        carry = 1 if t >= 16 else 0
        out.append(abs(t - 32) if carry else t)
    return out


def _verdicts(results):
    return [(r.ok, r.error, r.script_error) for r in results]


def _api_exact(raw: bytes, index: int, spent, flags: int):
    """One input through the per-input `api` on its Python engine: a spec
    independent of the native core and the kernel under test."""
    from bitcoinconsensus_tpu_torch import ScriptError, api

    try:
        api.verify_with_spent_outputs(raw, index, spent, flags, engine="python")
        return (True, api.Error.ERR_OK, ScriptError.OK)
    except api.ConsensusError as e:
        return (False, e.code, e.script_error)


def _hold_to_plain(VT, verifier, lanes, sync):
    """The path's kernel (the checked launch) and its plain version on the
    same packed lanes, every lane on the card: (max_abs_err over `ok` and
    `needs_host`, kernel accepts)."""
    dev = verifier.to_device(lanes)
    ok_k, nd_k, _ = VT.verify_tiles_checked(*dev)
    ok_r, nd_r = VT.verify_tiles_reference(*dev)
    sync()
    err = max(int((ok_k.int() - ok_r.int()).abs().max()),
              int((nd_k.int() - nd_r.int()).abs().max()))
    return err, int(ok_k.sum())


def _same_arrays(a, b) -> bool:
    return all(x.shape == y.shape and x.dtype == y.dtype and x.tobytes() == y.tobytes()
               for x, y in zip(a, b, strict=True))


def _dispatch_recorder(verifier):
    """Wrap `verifier.dispatch_lanes` so that it keeps each dispatch's packed
    lanes and lane count in the returned list while `on[0]` holds."""
    seen, on = [], [True]
    dispatch = verifier.dispatch_lanes

    def keep(args, n):
        if on[0]:
            seen.append((args, n))
        return dispatch(args, n)

    verifier.dispatch_lanes = keep
    return seen, on


def _stream(items, results, device, sync, launches_around, rehearse) -> None:
    """`verify_batch_stream` over the main path's inputs in 5 batches at
    depth 2, with fresh caches, in turns with the same batches through one
    `verify_batch` each (`[stream]`): every yielded list must equal its
    batch's, and the main path's verdicts. The kernel is held to its plain
    version on every lane of the stream's first dispatch
    (`[stream_compare]`). Then a stream closed after its first yield must
    leave no dispatch unsettled (`[stream_close]`)."""
    import torch

    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch, verify_batch_stream
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT

    n_b = 5
    size = len(items) // n_b
    batches = [items[k * size:(k + 1) * size] for k in range(n_b)]
    want = [_verdicts(results[k * size:(k + 1) * size]) for k in range(n_b)]
    verifier = TorchSecpVerifier(device=device)
    seen, recording = _dispatch_recorder(verifier)  # the first streamed run's

    def sequential():
        sig, script = SigCache(), ScriptExecutionCache()
        out, per = [], []
        for b in batches:
            t0 = time.perf_counter()
            out.append(verify_batch(b, verifier=verifier, sig_cache=sig,
                                    script_cache=script))
            sync()
            per.append(time.perf_counter() - t0)
        return out, per

    def streamed():
        sig, script = SigCache(), ScriptExecutionCache()
        t0 = time.perf_counter()
        out = list(verify_batch_stream(iter(batches), verifier=verifier, sig_cache=sig,
                                       script_cache=script, depth=2))
        sync()
        return out, time.perf_counter() - t0

    # Rounds in turns (sequential, stream, stream, sequential, ...); the
    # stream's first run has its launches counted around it alone.
    seq_runs, st_runs, outs = [], [], []
    st_dispatches = 0
    for r in range(2 if rehearse else 3):
        for kind in (("seq", "stream") if r % 2 == 0 else ("stream", "seq")):
            if kind == "seq":
                out, per = sequential()
                seq_runs.append(sum(per))
            elif not st_runs:
                verifier.stats.clear()
                out, dt = launches_around("stream", streamed)
                recording[0] = False
                st_dispatches = int(verifier.stats["dispatches"])
                st_runs.append(dt)
            else:
                out, dt = streamed()
                st_runs.append(dt)
            outs.append(out)
    bad = sum(_verdicts(o) != w for out in outs for o, w in zip(out, want, strict=True))
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    _line("stream", batches=n_b, batch_inputs=size, depth=2, tolerance=0,
          batches_differing=bad, stream_s=json.dumps([round(t, 4) for t in st_runs]),
          sequential_sum_s=json.dumps([round(t, 4) for t in seq_runs]),
          sequential_per_batch_s=json.dumps([round(t, 4) for t in per]),
          stream_over_sequential_median=f"{med(st_runs) / med(seq_runs):.3f}",
          kernel_launches=st_dispatches, in_flight=verifier.in_flight)
    if bad or any(len(out) != n_b for out in outs):
        _fail("verify_batch_stream's results differ from verify_batch per batch")
    lanes, n_real = seen[0]
    err, accepted = _hold_to_plain(VT, verifier, lanes, sync)
    _line("stream_compare", dispatch=1, of=len(seen), lanes=n_real, padded=len(lanes[0]),
          tolerance=0, max_abs_err=err, kernel_ok=accepted)
    if err:
        _fail("kernel and plain version disagree on the stream's lanes")

    gen = verify_batch_stream(iter(batches), verifier=verifier, sig_cache=SigCache(),
                              script_cache=ScriptExecutionCache(), depth=2)
    first = next(gen)
    begun = verifier.in_flight
    gen.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # raises on a device fault
    again = verify_batch(batches[0], verifier=verifier, sig_cache=SigCache(),
                         script_cache=ScriptExecutionCache())
    _line("stream_close", in_flight_at_close=begun, in_flight_after=verifier.in_flight,
          first_equal=_verdicts(first) == want[0], after_equal=_verdicts(again) == want[0])
    if begun < 1 or verifier.in_flight != 0 or _verdicts(first) != want[0] \
            or _verdicts(again) != want[0]:
        _fail("a stream closed early left a dispatch unsettled or changed a verdict")


def _block(device, sync, launches_around, rehearse):
    """BASELINE.json config 5 as scripts/bench_configs.py builds it: 3,200
    inputs in 400 txs of 8, kinds cycling p2wpkh, p2tr, p2wpkh, p2wsh 2-of-3
    (4,000 signatures), height 710,000, regtest proof of work, the verifier
    at min_batch 512, chunk 8,192, pad_step 2,048. `connect_block` on a
    fresh NativeCoinsView clone with fresh caches, 5 times (`[block]`), then
    on a plain CoinsView on the Python engine, which must give the same
    result and view size. The block's dispatched lanes are then held to
    independent specs: every lane's kernel result to the plain version
    (`[block_compare]`), the lanes themselves to `prep_pack` of the checks
    the wire protocol records for the block, in the index session's uniq
    order, with the session's cache keys (`[block_lanes]`), and a sample of
    per-input results to the per-input `api` on its Python engine
    (`[block_exact]`). `[block_reject]`: the block with one corrupted
    signature, rejected alike on both, the views unchanged, the bad tx's
    inputs as the per-input `api` says. Returns `connect(verifier)`, which
    connects the block on a fresh clone of the view with fresh caches, and
    the result it must give (for `[guards]`)."""
    import numpy as np

    from bitcoinconsensus_tpu_torch import native_bridge as NB
    from bitcoinconsensus_tpu_torch.core.flags import height_to_flags
    from bitcoinconsensus_tpu_torch.core.tx import OutPoint, TxOut
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import _idx_threads
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.models.validate import Coin, CoinsView, connect_block
    from bitcoinconsensus_tpu_torch.native_bridge import NativeCoinsView
    from bitcoinconsensus_tpu_torch.obs import add_sink, remove_sink
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
    from bitcoinconsensus_tpu_torch.utils import blockgen as B

    height = 710_000
    kinds = ("p2wpkh", "p2tr", "p2wpkh", "p2wsh_multisig")
    n_in = 40 if rehearse else 4000 * 4 // 5  # 5 signatures per 4 inputs
    t0 = time.perf_counter()
    coins, funded = B.make_funded_view(n_in, kinds=kinds, seed="bench-block")
    txs = [B.build_spend_tx(funded[i:i + 8], fee=800) for i in range(0, n_in - 7, 8)]
    block = B.build_block(txs, height, fees=800 * len(txs))
    k = len(txs) // 2  # the tx whose second input gets a corrupted signature
    bad_txs = txs[:k] + [B.build_spend_tx(funded[8 * k:8 * k + 8], fee=800,
                                          corrupt_input=1)] + txs[k + 1:]
    bad_block = B.build_block(bad_txs, height, fees=800 * len(txs))
    entries = [(t, n, c.out.value, c.height, c.coinbase, c.out.script_pubkey)
               for (t, n), c in coins._map.items()]
    nview0 = NativeCoinsView()
    nview0.add_coins_batch(entries)

    def plain_view():
        view = CoinsView()
        for t, n, value, h, cb, spk in entries:
            view.add(OutPoint(t, n), Coin(TxOut(value, spk), h, cb))
        return view

    _line("block_data", txs=len(txs), inputs=n_in, signatures=n_in * 5 // 4,
          block_bytes=len(block.serialize()), seconds=f"{time.perf_counter() - t0:.3f}")

    def tup(res):
        return (res.ok, res.reason, res.fees, res.sigop_cost,
                None if res.input_results is None else _verdicts(res.input_results))

    verifier = TorchSecpVerifier(device=device, min_batch=512, chunk=8192, pad_step=2048)
    py_verifier = TorchSecpVerifier(device=device, engine="python", min_batch=512,
                                    chunk=8192, pad_step=2048)
    iters = 2 if rehearse else 5
    runs = []
    seen, _on = _dispatch_recorder(verifier)  # the last run's dispatches

    def connect_runs():
        for _ in range(iters):
            seen.clear()
            view = nview0.clone()
            sig, script = SigCache(), ScriptExecutionCache()
            verifier.stats.clear()
            sink = _ListSink()
            add_sink(sink)
            try:
                t0 = time.perf_counter()
                res = connect_block(block, view, height, verifier=verifier,
                                    pow_limit=B.REGTEST_POW_LIMIT, sig_cache=sig,
                                    script_cache=script)
                sync()
                dt = time.perf_counter() - t0
            finally:
                remove_sink(sink)
            runs.append((dt, res, view, dict(verifier.stats), sink.records))

    launches_around("block", connect_runs)
    times = sorted(r[0] for r in runs)
    best = min(runs, key=lambda r: r[0])
    dt, res, view, st, records = best
    # The span split: every step's self time; the residual is what no span
    # inside block.connect covers, plus the caller's time around the call.
    split = _span_split(records, "block.connect")
    split["residual"] = round(dt * 1e3 - sum(split.values())
                              + split.pop("block.connect", 0.0), 4)
    # The same lanes again, the kernel warmed and launched back to back: an
    # in-pipeline launch follows tens of ms of idle device.
    warm_args = verifier.to_device(seen[-1][0])
    warm_ms = _timed(lambda: VT.verify_tiles_checked(*warm_args), 1 if rehearse else 20,
                     device)
    plain = plain_view()
    t0 = time.perf_counter()
    res_py = launches_around("block_python", lambda: connect_block(
        block, plain, height, verifier=py_verifier, pow_limit=B.REGTEST_POW_LIMIT,
        sig_cache=SigCache(), script_cache=ScriptExecutionCache(), engine="python"))
    py_s = time.perf_counter() - t0
    same = all(tup(r[1]) == tup(res) for r in runs) and tup(res_py) == tup(res)
    _line("block", inputs=n_in, txs=len(txs), iterations=iters, ok=res.ok,
          best_ms=f"{times[0] * 1e3:.3f}", median_ms=f"{times[len(times) // 2] * 1e3:.3f}",
          all_ms=json.dumps([round(t * 1e3, 3) for t in (r[0] for r in runs)]),
          split_ms=json.dumps(split),
          kernel_launches=int(st.get("dispatches", 0)),
          lanes=int(st.get("lanes", 0)), padded_lanes=int(st.get("padded_lanes", 0)),
          kernel_ms=f"{st.get('kernel_ms', 0.0):.4f}", warm_kernel_ms=f"{warm_ms:.4f}",
          busy_share=f"{st.get('kernel_ms', 0.0) / (dt * 1e3):.4f}",
          fixups=int(st.get("fixups", 0)),
          fees=res.fees, sigop_cost=res.sigop_cost,
          python_engine_ms=f"{py_s * 1e3:.3f}", python_equal=same,
          view_size=len(view), python_view_size=len(plain))
    if not res.ok or not same or len(view) != len(plain):
        _fail("connect_block: the block was rejected, or the two paths differ")
    total = dt * 1e3
    _line("block_split", best_ms=f"{total:.3f}", spans=len(split) - 1,
          residual_ms=f"{split['residual']:.4f}",
          residual_share=f"{split['residual'] / total:.4f}",
          split=json.dumps({k: [v, round(v / total, 4)] for k, v in split.items()}))
    if not records or split["residual"] > 0.5 * total:
        _fail("[block_split]: the block's spans cover less than half of it")

    errs = [_hold_to_plain(VT, verifier, lanes, sync) for lanes, _n in seen]
    _line("block_compare", dispatches=len(seen), lanes=json.dumps([n for _, n in seen]),
          padded=json.dumps([len(a[0]) for a, _ in seen]), tolerance=0,
          max_abs_err=max(e for e, _ in errs), kernel_ok=sum(a for _, a in errs))
    if max(e for e, _ in errs):
        _fail("kernel and plain version disagree on the block's lanes")

    # The index session's lanes and keys against the wire protocol's records.
    flags = height_to_flags(height, extended=True)
    nblk = NB.NativeBlock(block.serialize())
    (_r, _fe, _so, tx_index, n_in_a, amounts, spk_offs,
     spk_blob) = nblk.accounting(nview0.clone(), height, flags)
    n = len(tx_index)
    sess = NB.NativeSession()
    t0 = time.perf_counter()
    idx_out = sess.verify_inputs_idx_raw(
        [nblk.tx(int(t))._ptr for t in tx_index], n_in_a, amounts, spk_blob, spk_offs,
        np.full(n, flags, np.int32), _idx_threads())
    n_u = sess.uniq_count()
    all_idx = np.arange(n_u, dtype=np.int32)
    pad = verifier.pad(n_u)
    uniq_packed = sess.uniq_lanes(all_idx, pad)
    cache = SigCache()
    uniq_keys = [d.tobytes() for d in sess.uniq_digests(cache._salt, all_idx)]
    idx_s = time.perf_counter() - t0
    wire = NB.NativeSession()
    t0 = time.perf_counter()
    w_ok, w_err, w_unk, w_recs = wire.verify_inputs(
        [nblk.tx(int(t)) for t in tx_index], n_in_a.tolist(), amounts.tolist(),
        [spk_blob[spk_offs[j]:spk_offs[j + 1]].tobytes() for j in range(n)],
        [flags] * n, mode=NB.NativeSession.MODE_DEFER)
    flat = [SigCheck(k, d) for recs in w_recs for k, d in recs]
    flat += [SigCheck(k, d) for k, d in wire.take_spec()]
    by_key = dict(zip(cache.keys_for_checks(flat), flat))
    wire_s = time.perf_counter() - t0
    checks = [by_key.get(k) for k in uniq_keys]
    same_checks = (len(set(uniq_keys)) == n_u and set(uniq_keys) == set(by_key)
                   and all(np.array_equal(a, b) for a, b in
                           zip(idx_out[:3], (w_ok, w_err, w_unk), strict=True)))
    packed_equal = same_checks and _same_arrays(uniq_packed, NB.prep_pack(checks, pad))
    # The pipeline's dispatches (a cold sig cache: every uniq entry, in order).
    off, sent_equal = 0, same_checks
    for lanes, n_d in seen:
        if off >= n_u:
            break
        sent_equal = sent_equal and _same_arrays(
            lanes, NB.prep_pack(checks[off:off + n_d], len(lanes[0])))
        off += n_d
    sent_equal = sent_equal and off == n_u
    _line("block_lanes", inputs=n, uniq=n_u, wire_records=len(flat), padded=pad,
          same_checks=same_checks, uniq_lanes_equal_prep_pack=packed_equal,
          dispatched_equal_prep_pack=sent_equal, index_s=f"{idx_s:.4f}",
          wire_s=f"{wire_s:.4f}")
    if not (same_checks and packed_equal and sent_equal):
        _fail("the index session's lanes or keys differ from the wire protocol's")

    def spec(block_txs, j):
        t, i = divmod(j, 8)
        return _api_exact(block_txs[t].serialize(), i,
                          [(f.amount, f.wallet.spk) for f in funded[8 * t:8 * t + 8]],
                          flags)

    pick = sorted(np.random.default_rng(n_in).choice(n_in, size=min(64, n_in),
                                                      replace=False).tolist())
    exact_diff = sum(_verdicts([res.input_results[j]])[0] != spec(txs, j) for j in pick)
    _line("block_exact", sampled=len(pick), tolerance=0, differing=exact_diff)
    if exact_diff:
        _fail("the block's per-input results disagree with the per-input api")

    view = nview0.clone()
    bad_n = launches_around("block_reject", lambda: connect_block(
        bad_block, view, height, verifier=verifier, pow_limit=B.REGTEST_POW_LIMIT,
        sig_cache=SigCache(), script_cache=ScriptExecutionCache()))
    plain = plain_view()
    bad_p = connect_block(bad_block, plain, height, verifier=py_verifier,
                          pow_limit=B.REGTEST_POW_LIMIT, sig_cache=SigCache(),
                          script_cache=ScriptExecutionCache(), engine="python")
    failed = [(i, r.error.name, r.script_error.name)
              for i, r in enumerate(bad_n.input_results or []) if not r.ok]
    unchanged = (len(view) == len(nview0) == len(plain) == len(entries)
                 and view.get(funded[0].outpoint) is not None)
    bad_diff = sum(_verdicts([bad_n.input_results[j]])[0] != spec(bad_txs, j)
                   for j in range(8 * k, 8 * k + 8)) if bad_n.input_results else 8
    _line("block_reject", reason=bad_n.reason, python_reason=bad_p.reason,
          python_equal=tup(bad_n) == tup(bad_p), failed_inputs=json.dumps(failed),
          bad_tx_inputs_vs_api_differing=bad_diff, views_unchanged=unchanged)
    if bad_n.reason != "block-validation-failed" or tup(bad_n) != tup(bad_p) \
            or len(failed) != 1 or failed[0][0] != 8 * k + 1 \
            or failed[0][1] != "ERR_SCRIPT" or bad_diff or not unchanged:
        _fail("the block with a corrupted signature was not rejected alike")

    def connect(verifier):
        got = connect_block(block, nview0.clone(), height, verifier=verifier,
                            pow_limit=B.REGTEST_POW_LIMIT, sig_cache=SigCache(),
                            script_cache=ScriptExecutionCache())
        return tup(got)

    # What the device-SHA phases, which run after [xprof], need of the block.
    sha_ctx = dict(block=block, bad_block=bad_block, height=height,
                   plain_view=plain_view, want=tup(res), bad_want=tup(bad_n))
    return connect, tup(res), dict(min_batch=512, chunk=8192, pad_step=2048), sha_ctx


def _checksum_phase(device, rng, rehearse):
    """`[checksum]`: the verdict checksum kernel against its plain version on
    random, all-true and all-false buffers at every width listed, 0
    differing; at the sweep widths its time per call (CUDA events, the
    wrapper's host cost included) in turns with the two-call PyTorch
    equivalent (`torch.mv` of a (2, B) float32 matrix of ones and weights
    over the buffer as float32, exact below 2^24), its device time
    (torch.profiler), the plain version's time and its bound. Returns the
    kernels-line entry at 8,192 lanes (the main path's dispatch width)."""
    import numpy as np
    import torch

    from bitcoinconsensus_tpu_torch.ops import verdict_checksum as VC

    widths = (1, 31, 32, 33, 64, 250, 251, 252, 1023, 1024, 1025, 4908, 6144,
              8191, 8192, 32768)
    timed_widths = (64,) if rehearse else SWEEP_WIDTHS
    entry = None
    differing = max_err = 0
    for width in widths:
        bufs = [rng.integers(0, 2, width).astype(bool), np.ones(width, bool),
                np.zeros(width, bool)]
        for buf in bufs:
            ok = torch.from_numpy(buf).to(device)
            got = VC.verdict_checksum(ok).cpu().tolist()
            want = VC.verdict_checksum_reference(ok).cpu().tolist()
            differing += got != want
            max_err = max(max_err, *(abs(a - b) for a, b in zip(got, want)))
        if width not in timed_widths:
            continue
        ok = torch.from_numpy(bufs[0]).to(device)
        w = torch.stack((torch.ones(width), torch.arange(width) % VC.CHECKSUM_MOD + 1.0)
                        ).to(device=device, dtype=torch.float32)

        def library(ok=ok, w=w):
            return torch.mv(w, ok.to(torch.float32))

        lib = [int(x) for x in library().cpu().tolist()]
        differing += lib != VC.verdict_checksum_reference(ok).cpu().tolist()
        ms, lib_ms = _timed_turns([lambda ok=ok: VC.verdict_checksum(ok), library],
                                  1 if rehearse else 200, 1 if rehearse else 7, device)
        plain_ms = _timed(lambda ok=ok: VC.verdict_checksum_reference(ok),
                          1 if rehearse else 20, device)
        dev_ms = None if rehearse else _device_ms(lambda ok=ok: VC.verdict_checksum(ok),
                                                  50, "vc_checksum_kernel")
        # Each input byte read once and the two words written once; about 4
        # int32 operations a lane (compare, multiply, two adds).
        b_ms, b_by = _bound(width + 8.0, 4.0 * width)
        _line("checksum", lanes=width, ms=f"{ms:.5f}", device_ms=json.dumps(dev_ms),
              plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.5f}",
              bound_ms=f"{b_ms:.3g}", bound_by=b_by)
        if width == 8192 or rehearse:
            entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, device_ms=dev_ms)
    _line("checksum", widths=len(widths), buffers=3 * len(widths), tolerance=0,
          differing=differing, max_abs_err=max_err)
    if differing:
        _fail("the verdict checksum kernel and its plain version disagree")
    entry["max_abs_err"] = max_err
    return entry


def _set_checksum(on: bool) -> None:
    """BITCOINCONSENSUS_TPU_CHECKSUM for the verifiers built next."""
    os.environ["BITCOINCONSENSUS_TPU_CHECKSUM"] = "1" if on else "0"


def _guards_phase(items, results, block_run, device, sync, rehearse) -> None:
    """`[guards]`: the main path (one `verify_batch` over every input), the
    config-5 block and the stream (5 batches at depth 2), each with the
    device checksum on and off in turns (on, off, off, on), a fresh verifier
    and fresh caches each time: every verdict equal to the main path's
    (held to the exact spec by `[main_path_check]`) and the block's result
    equal to `[block]`'s. Reports the sentinel lanes per dispatch, the
    tickets, and the checked launches and those carrying the checksum
    partials in each run."""
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch, verify_batch_stream
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT

    want = _verdicts(results)
    size = len(items) // 5
    batches = [items[k * size:(k + 1) * size] for k in range(5)]
    connect, block_want, block_cfg = block_run[:3]
    paths = {
        "main_path": ({}, lambda v: _verdicts(verify_batch(
            items, verifier=v, sig_cache=SigCache(), script_cache=ScriptExecutionCache())),
            want),
        "block": (block_cfg, connect, block_want),
        "stream": ({}, lambda v: [r for out in verify_batch_stream(
            iter(batches), verifier=v, sig_cache=SigCache(),
            script_cache=ScriptExecutionCache(), depth=2) for r in _verdicts(out)],
            want[:5 * size]),
    }
    try:
        for path, (cfg, run, expect) in paths.items():
            seen = {True: [], False: []}
            for on in (True, False, False, True):
                _set_checksum(on)
                v = TorchSecpVerifier(device=device, **cfg)
                sync()
                vt0 = VT.verify_tiles_checked.launches
                vc0 = VT.verify_tiles_checked.checksummed
                t0 = time.perf_counter()
                got = run(v)
                sync()
                dt = time.perf_counter() - t0
                st = v.stats
                seen[on].append(dict(
                    s=dt, differing=int(got != expect) if path == "block" else
                    sum(a != b for a, b in zip(got, expect, strict=True)),
                    tickets=int(st["tickets"]), sentinels=int(st["sentinel_lanes"]),
                    skipped=int(st["sentinel_skipped"]),
                    verify=VT.verify_tiles_checked.launches - vt0,
                    checksum=VT.verify_tiles_checked.checksummed - vc0,
                    anomalies=int(st["guard_anomalies"])))
            runs = seen[True] + seen[False]
            _line("guards", path=path, order="on,off,off,on",
                  checksum_on_s=json.dumps([round(r["s"], 4) for r in seen[True]]),
                  checksum_off_s=json.dumps([round(r["s"], 4) for r in seen[False]]),
                  tickets=json.dumps([r["tickets"] for r in runs]),
                  sentinel_lanes_per_dispatch=json.dumps(
                      [round(r["sentinels"] / max(r["tickets"], 1), 2) for r in runs]),
                  verify_launches=json.dumps([r["verify"] for r in runs]),
                  checksum_launches_on=json.dumps([r["checksum"] for r in seen[True]]),
                  checksum_launches_off=json.dumps([r["checksum"] for r in seen[False]]),
                  differing=sum(r["differing"] for r in runs), tolerance=0,
                  guard_anomalies=sum(r["anomalies"] for r in runs))
            if any(r["differing"] or r["anomalies"] or r["skipped"]
                   or r["sentinels"] < r["tickets"] or r["tickets"] < 1 for r in runs):
                _fail(f"[guards] {path}: a verdict differs, a guard fired on a "
                      "clean run, or a dispatch carried no sentinel lane")
            if not rehearse and any(r["checksum"] != r["verify"] or r["verify"] < 1
                                    for r in seen[True]) \
                    or any(r["checksum"] for r in seen[False]):
                _fail(f"[guards] {path}: the checksum partials did not ride every "
                      "dispatch with the checksum on, or were written with it off")
    finally:
        os.environ.pop("BITCOINCONSENSUS_TPU_CHECKSUM", None)


CHAOS_KINDS = (
    ("torch_backend.dispatch", ("raise", "timeout")),
    ("torch_backend.verdict", ("invert", "flip", "value", "nan", "garbage", "shape")),
    ("batch.dispatch", ("raise", "timeout")),
    ("sigcache.sig", ("poison",)),
)


def _chaos_phase(items, corrupted, results, device, rehearse) -> None:
    """`[chaos]`: one line per fault kind and port site, once transient (one
    fire) and once persistent (64), in index mode, and in the wire driver too
    for `batch.dispatch` and `sigcache.sig`, over the main path's first
    2,000 inputs with its corrupted ones first, a fresh verifier and caches
    each. What each must give:
    - `torch_backend.*`: transient, the clean run's verdicts after a retry;
      persistent, `DispatchFailed` caused by the fault (`VerdictAnomaly`,
      `InjectedFault`, `InjectedTimeout`);
    - `batch.dispatch`: the injected error raised with both caches empty,
      and, transient, the caller's second call gives the clean verdicts;
      persistent, it raises again;
    - `sigcache.sig` (a fabricated hit), with the cache audit armed: the
      clean verdicts, every poisoned hit on a false check caught.
    No case may return an ACCEPT the clean run rejects (`wrong_accepts`)."""
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.resilience import faults as F
    from bitcoinconsensus_tpu_torch.resilience import guards as G
    from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchFailed

    order = sorted(range(len(items)), key=lambda i: not corrupted[i])[:2000]
    sub = [items[i] for i in order]
    want = _verdicts([results[i] for i in order])
    bad = []
    n_lines = 0
    t_phase = time.perf_counter()
    for site, kinds in CHAOS_KINDS:
        drivers = ("index", "wire") if site in ("batch.dispatch", "sigcache.sig") \
            else ("index",)
        for driver, kind, (regime, count) in (
                (d, k, r) for d in drivers for k in kinds
                for r in (("transient", 1), ("persistent", 64))):
            os.environ["BITCOINCONSENSUS_TPU_IDX"] = "0" if driver == "wire" else "1"
            v = TorchSecpVerifier(device=device)
            sig, script = SigCache(), ScriptExecutionCache()
            G.set_cache_audit(site == "sigcache.sig")
            outcomes = []
            try:
                with F.inject(F.FaultPlan([F.FaultSpec(site, kind, count=count)]),
                              seed=n_lines) as inj:
                    for _ in range(2 if site == "batch.dispatch" else 1):
                        try:
                            got = _verdicts(verify_batch(sub, verifier=v, sig_cache=sig,
                                                         script_cache=script))
                            outcomes.append(("verdicts", got))
                        except (DispatchFailed, F.InjectedFault) as e:
                            outcomes.append(("raised", e, len(sig), len(script)))
            finally:
                G.set_cache_audit(False)
                os.environ.pop("BITCOINCONSENSUS_TPU_IDX", None)
            wrong = sum(g[0] and not w[0] for o in outcomes if o[0] == "verdicts"
                        for g, w in zip(o[1], want, strict=True))
            differing = sum(sum(g != w for g, w in zip(o[1], want, strict=True))
                            for o in outcomes if o[0] == "verdicts")
            raised = [o for o in outcomes if o[0] == "raised"]
            cause = None
            if raised:
                e = raised[0][1]
                cause = type(e.__cause__ if isinstance(e, DispatchFailed) else e).__name__
            want_raise = {"torch_backend.verdict": "VerdictAnomaly",
                          "torch_backend.dispatch": "InjectedTimeout" if kind == "timeout"
                          else "InjectedFault",
                          "batch.dispatch": "InjectedTimeout" if kind == "timeout"
                          else "InjectedFault"}.get(site)
            if site == "sigcache.sig":
                held = (not raised and differing == 0
                        and v.stats["cache_poison_caught"] >= 1)
            elif site == "batch.dispatch":
                first = raised and outcomes[0] is raised[0] and cause == want_raise \
                    and raised[0][2] == raised[0][3] == 0
                held = bool(first) and (
                    (len(raised) == 1 and outcomes[1][0] == "verdicts"
                     and differing == 0) if regime == "transient" else len(raised) == 2)
            elif regime == "transient":
                held = not raised and differing == 0 and v.stats["retries"] >= 1
            else:
                held = len(raised) == 1 and isinstance(raised[0][1], DispatchFailed) \
                    and cause == want_raise
            n_lines += 1
            _line("chaos", site=site, kind=kind, regime=regime, driver=driver,
                  fired=inj.total_fired(),
                  outcome="+".join("verdicts" if o[0] == "verdicts"
                                   else f"raised:{type(o[1]).__name__}" for o in outcomes),
                  cause=cause, differing=differing, wrong_accepts=wrong,
                  retries=int(v.stats["retries"]),
                  guard_anomalies=int(v.stats["guard_anomalies"]),
                  poison_caught=int(v.stats["cache_poison_caught"]), held=held)
            if wrong or not held or inj.total_fired() < 1:
                bad.append(f"{site}/{kind}/{regime}/{driver}")
    _line("chaos", cases=n_lines, inputs=len(sub), corrupted=sum(not w[0] for w in want),
          failed=len(bad), seconds=f"{time.perf_counter() - t_phase:.2f}")
    if bad:
        _fail("[chaos]: " + ", ".join(bad))


class _TimedSink:
    """A span sink that times its inner sink's writes."""

    def __init__(self, sink):
        self.sink, self.seconds = sink, 0.0

    def write(self, record) -> None:
        t0 = time.perf_counter()
        self.sink.write(record)
        self.seconds += time.perf_counter() - t0


OBS_ROUNDS = 6  # `[obs]`'s rounds of (off, on, on, off) a path


def _obs_phase(items, results, block_run, device, sync) -> None:
    """`[obs]`: the main path (one `verify_batch` over every input) and the
    config-5 block, each with telemetry armed (a JSONL span sink attached,
    phase timelines on) and disarmed (no sink, timelines off), in turns
    (off, on, on, off; six times for each path) on one warmed verifier,
    fresh caches each call: both sides' times,
    medians and spreads, the first armed call and the sink's write time in
    each armed call (a cost of arming would show there), and every verdict
    compared with `[main_path]`'s and `[block]`'s (tolerance 0).

    Two gates. The armed median may lie beyond the disarmed range by no
    more than the disarmed spread (the host's own noise, in the same
    turns). And the always-on telemetry, counted rather than timed
    (`obs.perf.telemetry_cost` over one disarmed call), must stay under 1%
    of the disarmed median."""
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.obs import JsonlSink, add_sink, perf, remove_sink

    t_phase = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "obs")
    os.makedirs(out_dir, exist_ok=True)
    connect, block_want, block_cfg = block_run[:3]
    want = _verdicts(results)
    # (verifier config, one call, its verdicts, rounds of turns). Six rounds:
    # the host's noise moves a main-path call by up to half its time, in
    # bursts that can take both armed calls of one round (12 rounds a path
    # on the card showed no cost of arming: scripts/torch_obs_gate.py).
    paths = {
        "main_path": ({}, lambda v: _verdicts(verify_batch(
            items, verifier=v, sig_cache=SigCache(), script_cache=ScriptExecutionCache())),
            want, OBS_ROUNDS),
        "block": (block_cfg, connect, block_want, OBS_ROUNDS),
    }
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    bad = []
    for path, (cfg, run, expect, rounds) in paths.items():
        order = (False, True, True, False) * rounds
        v = TorchSecpVerifier(device=device, **cfg)
        perf.set_enabled(False)
        try:
            run(v)  # warm: the verifier stages its buffers at this width
            sync()
            events, always_on_s = perf.telemetry_cost(lambda: (run(v), sync()))
        finally:
            perf.set_enabled(True)
        times = {True: [], False: []}
        sink_s = []
        differing = records = 0
        for armed in order:
            sink = None
            perf.set_enabled(armed)
            if armed:
                spans_path = os.path.join(out_dir, f"{path}.jsonl")
                if os.path.exists(spans_path):
                    os.remove(spans_path)
                sink = _TimedSink(JsonlSink(spans_path))
                add_sink(sink)
            try:
                t0 = time.perf_counter()
                got = run(v)
                sync()
                times[armed].append(time.perf_counter() - t0)
            finally:
                perf.set_enabled(True)
                if sink is not None:
                    remove_sink(sink)
                    sink.sink.close()
                    sink_s.append(sink.seconds)
                    with open(spans_path, encoding="utf-8") as fh:
                        records += sum(1 for _ in fh)
            differing += int(got != expect) if path == "block" else \
                sum(a != b for a, b in zip(got, expect, strict=True))
        off, on = times[False], times[True]
        spread = max(off) - min(off)
        within = min(off) <= med(on) <= max(off) and min(on) <= med(off) <= max(on)
        _line("obs", path=path, order=f"(off,on,on,off)x{rounds}",
              disarmed_s=json.dumps([round(t, 4) for t in off]),
              armed_s=json.dumps([round(t, 4) for t in on]),
              disarmed_median_s=f"{med(off):.4f}", armed_median_s=f"{med(on):.4f}",
              disarmed_spread_s=f"{spread:.4f}", armed_spread_s=f"{max(on) - min(on):.4f}",
              armed_over_disarmed_median=f"{med(on) / med(off):.3f}",
              within_each_others_spread=within, first_armed_s=f"{on[0]:.4f}",
              span_records_per_call=f"{records / len(on):.1f}",
              sink_write_ms=json.dumps([round(t * 1e3, 3) for t in sink_s]),
              always_on_events=json.dumps(events),
              always_on_ms=f"{always_on_s * 1e3:.4f}",
              always_on_share=f"{always_on_s / med(off):.6f}",
              tolerance=0, differing=differing)
        if differing or not records:
            bad.append(f"{path}: a verdict changed with telemetry armed, or the "
                       "armed sink received no span")
        if med(on) > max(off) + spread:
            bad.append(f"{path}: the armed median {med(on):.4f} s lies beyond the "
                       f"disarmed range by more than its spread {spread:.4f} s")
        if always_on_s >= 0.01 * med(off):
            bad.append(f"{path}: the always-on telemetry is counted at "
                       f"{always_on_s / med(off):.2%} of a call")
    _line("obs_time", seconds=f"{time.perf_counter() - t_phase:.2f}")
    if bad:
        _fail("[obs] " + "; ".join(bad))


def _xprof_phase(items, results, block_run, device, sync, rehearse, out_dir,
                 sha_connect=None) -> None:
    """`[xprof]`: a torch.profiler capture around one warmed `verify_batch`
    of the main path and one around a warmed `connect_block` of the config-5
    block (`obs/xprof.capture_report`): seconds per region, kernel seconds
    by symbol, the unattributed seconds (0 for the port's own kernels), the
    device's busy share of the window and its five longest idle gaps with
    their host spans. Given `sha_connect` (a later call, after the device-SHA
    phases, so that the earlier phases run as they did before them), one
    capture of the same block on the device-SHA path (the Python block layer
    with `device_merkle`, a verifier with `device_challenge`), whose merkle
    tree (one launch) and challenge kernels must be charged to
    `sha256_compress` and `sighash_prep`. Each report is written to `out_dir`. A capture that
    fails ends the run: this phase is the measurement, not an option."""
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.obs import xprof

    if rehearse:
        _line("xprof", skipped="a capture measures the card; none in a rehearsal")
        return
    t_phase = time.perf_counter()
    connect, block_want, block_cfg = block_run[:3]
    want = _verdicts(results)
    got = {}

    if sha_connect is None:
        main_v = TorchSecpVerifier(device=device)
        block_v = TorchSecpVerifier(device=device, **block_cfg)

        def main_run():
            got["main_path"] = _verdicts(verify_batch(
                items, verifier=main_v, sig_cache=SigCache(),
                script_cache=ScriptExecutionCache()))

        def block_run_once():
            got["block"] = connect(block_v)

        runs = (("main_path", main_run, want), ("block", block_run_once, block_want))
    else:
        sha_v = TorchSecpVerifier(device=device, engine="python", device_challenge=True,
                                  **block_cfg)

        def sha_run_once():
            got["block_device_sha"] = sha_connect(sha_v)

        runs = (("block_device_sha", sha_run_once, block_want),)
    for name, fn, expect in runs:
        fn()  # warm: a first call at a width stages its buffers
        sync()
        t0 = time.perf_counter()
        rep = xprof.capture_report(fn, log_dir=os.path.join(HERE, "build", "xprof", name))
        cap_s = time.perf_counter() - t0
        xprof.write_report(rep, os.path.join(out_dir, f"xprof_{name}.json"))
        port_unattr = {k: v for k, v in rep["unattributed_symbols"].items()
                       if k.startswith(("vt_", "vc_", "sh_", "tk_"))}
        sym = rep["symbols"]
        # A dispatch is one kernel: the checked launch, and on the device-SHA
        # path the merkle tree and challenge kernels besides.
        allowed = {"vt_verify_checked_kernel"} | (
            {"sh_merkle_tree_kernel", "sh_challenge_kernel"}
            if name == "block_device_sha" else set())
        others = sorted(set(sym) - allowed)
        _line("xprof", path=name, wall_s=f"{rep['walls_s'][0]:.4f}",
              capture_s=f"{cap_s:.2f}",
              regions_ms=json.dumps({k: round(v["seconds"] * 1e3, 5)
                                     for k, v in rep["regions"].items()}),
              symbols_ms=json.dumps({k: round(v * 1e3, 5) for k, v in sym.items()}),
              unattributed_ms=f"{rep['unattributed_s'] * 1e3:.5f}",
              port_unattributed_ms=f"{sum(port_unattr.values()) * 1e3:.5f}",
              device_busy_share=f"{rep['device_busy_share']:.5f}",
              window_ms=f"{rep['window_s'] * 1e3:.3f}", kernels=rep["kernels"],
              other_kernels=json.dumps(others), same_verdicts=got[name] == expect)
        for g in rep["gaps"]:
            _line("xprof", path=name, gap_ms=f"{g['length_s'] * 1e3:.3f}",
                  at_ms=f"{g['start_s'] * 1e3:.3f}", host_span=g["host_span"],
                  host_spans=json.dumps([[n, round(t * 1e3, 3)]
                                         for n, t in g["host_spans"]]))
        regions = rep["regions"]
        if (not sym.get("vt_verify_checked_kernel") or others
                or port_unattr or got[name] != expect
                or regions.get("verify_tiles", {}).get("seconds")
                != sym["vt_verify_checked_kernel"]
                or not 0.0 < rep["device_busy_share"] <= 1.0):
            _fail(f"[xprof] {name}: the capture did not charge the checked launch to "
                  "verify_tiles, saw another kernel on the path, or a verdict "
                  "changed under it")
        if name == "block_device_sha" and (
                not sym.get("sh_merkle_tree_kernel") or not sym.get("sh_challenge_kernel")
                or regions.get("sha256_compress", {}).get("seconds")
                != sym["sh_merkle_tree_kernel"]
                or regions.get("sighash_prep", {}).get("seconds")
                != sym["sh_challenge_kernel"]):
            _fail("[xprof] block_device_sha: the SHA-256 kernels were not charged "
                  "to sha256_compress and sighash_prep")
    _line("xprof_time", seconds=f"{time.perf_counter() - t_phase:.2f}")


def _stats_phase(rehearse, out_dir) -> None:
    """`[stats]`: `python -m bitcoinconsensus_tpu_torch.obs.stats --check
    --device cuda` run in this process, after `[xprof]` and `[prover]`, whose
    capture and certificates the gate's workload then reuses. Every required
    metric must have samples."""
    import contextlib
    import io

    from bitcoinconsensus_tpu_torch.obs import stats

    dev = "cpu" if rehearse else "cuda"
    snap_path = os.path.join(out_dir, "stats_snapshot.json")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = stats.main(["--check", "--device", dev, "--out", snap_path])
    with open(snap_path, encoding="utf-8") as fh:
        snap = json.load(fh)["metrics"]
    required = stats.required_metrics(dev)
    missing = [n for n in required if not (snap.get(n) or {}).get("samples")]
    gauntlet = {n: len((snap.get(n) or {}).get("samples", []))
                for n in stats.REQUIRED_METRICS["gauntlet"]}
    _line("stats", device=dev, rc=rc, required=len(required), missing=len(missing),
          seconds=f"{time.perf_counter() - t0:.2f}",
          gauntlet_group=json.dumps(gauntlet),
          samples=json.dumps({n: len((snap.get(n) or {}).get("samples", []))
                              for n in required}))
    if rc or missing:
        _fail(f"[stats]: required metrics without samples: {missing}")


# The mesh's layouts on the card (shards x rows a shard): the main path's
# dispatches at 2, 4 and 8 entries, and a small batch at 4.
SHARD_LAYOUTS = ((2, 4096), (4, 2048), (8, 1024), (4, 16))
MESH_ENTRIES = 4
MESH_SOURCE = "bitcoinconsensus_tpu_torch/csrc/shard_step.cu"


def _shard_step_phase(device, rng, rehearse):
    """`[shard_step]`: the epilogue kernel against its plain version at every
    layout of SHARD_LAYOUTS, on seeded random, all-true and all-false
    buffers (differing words, 0), then at each layout its time per call
    (CUDA events, the wrapper's host cost included) in turns with the fewest
    PyTorch calls for the same triple (`library_ms`: the failure mask, then
    one batched float32 product of (ok, failures) by (ones, weights), exact
    below 2^24), its device time (torch.profiler), the plain version's time
    and its bound: 3 bytes read a row and 12 written a shard over the memory
    rate, 6 int32 operations a row over the int32 rate. Returns the
    kernels-line entry at 4 x 2,048 rows (the main path's layout)."""
    import numpy as np
    import torch

    from bitcoinconsensus_tpu_torch.ops import shard_step as SS

    differing = max_err = 0
    entry = None
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the library call in full float32
    try:
        for d, rows in SHARD_LAYOUTS:
            B = d * rows
            bufs = [rng.integers(0, 2, (3, B)).astype(bool), np.ones((3, B), bool),
                    np.zeros((3, B), bool)]
            for buf in bufs:
                ok, needs, live = (torch.from_numpy(x.copy()).to(device) for x in buf)
                got = SS.shard_epilogue(ok, needs, live, d).cpu().long()
                want = SS.shard_epilogue_reference(ok, needs, live, d).cpu()
                differing += int((got != want).sum())
                max_err = max(max_err, int((got - want).abs().max()))
            ok, needs, live = (torch.from_numpy(x.copy()).to(device) for x in bufs[0])
            w = torch.stack((torch.ones(rows), torch.arange(rows) % SS.CHECKSUM_MOD + 1.0)
                            ).to(device=device, dtype=torch.float32)

            def library(ok=ok, needs=needs, live=live, w=w, d=d, rows=rows):
                fails = live & ~(ok | needs)
                m = torch.stack((ok, fails)).view(2, d, rows).to(torch.float32)
                return torch.matmul(m, w.T)  # [0]: (count, wsum); [1]: (failures, -)

            lib = library().cpu()
            kern = SS.shard_epilogue(ok, needs, live, d).cpu()
            lib_err = max(int((lib[0, :, 0].long() - kern[0]).abs().max()),
                          int((lib[0, :, 1].long() - kern[1]).abs().max()),
                          int((lib[1, :, 0].long() - kern[2]).abs().max()))
            differing += lib_err != 0
            ms, lib_ms = _timed_turns(
                [lambda: SS.shard_epilogue(ok, needs, live, d), library],
                1 if rehearse else 200, 1 if rehearse else 7, device)
            plain_ms = _timed(lambda: SS.shard_epilogue_reference(ok, needs, live, d),
                              1 if rehearse else 20, device)
            dev_ms = None if rehearse else _device_ms(
                lambda: SS.shard_epilogue(ok, needs, live, d), 50, "ss_epilogue_kernel")
            b_ms, b_by = _bound(3.0 * B + 12.0 * d, 6.0 * B)
            _line("shard_step", shards=d, rows=rows, ms=f"{ms:.5f}",
                  device_ms=json.dumps(dev_ms), plain_ms=f"{plain_ms:.4f}",
                  library_ms=f"{lib_ms:.5f}", library_max_abs_err=lib_err,
                  bound_ms=f"{b_ms:.3g}", bound_by=b_by)
            if (d, rows) == (4, 2048):
                entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms, device_ms=dev_ms)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    _line("shard_step", layouts=len(SHARD_LAYOUTS), buffers=3 * len(SHARD_LAYOUTS),
          tolerance=0, differing=differing, max_abs_err=max_err)
    if differing:
        _fail("the shard-step epilogue kernel and its plain version disagree")
    entry["max_abs_err"] = max_err
    return entry


# The checked launch's widths: the sweep's, one whose last block holds 4
# lanes (its second warp wholly past the lanes) and one a lane short of a
# dispatch (its last warp 31 lanes); and the mesh layouts (shards x rows).
EPILOGUE_WIDTHS = SWEEP_WIDTHS + (4100, 8191)
EPILOGUE_LAYOUTS = ((1, 8192), (4, 2048), (8, 1024), (4, 16))


def _device_kernels(fn, reps):
    """{kernel: [mean device ms a launch, launches a call]} of every CUDA
    kernel `fn` launches (copies, fills and the device side of `region:`
    ranges left out), by torch.profiler over `reps` calls. The profiler
    first records a warm-up step of `reps` calls and throws it away: a
    capture that starts recording at once lost its first launches on the
    card (launch counts of 0.8 a call for a kernel launched once). None
    (not measured) where the profiler fails or shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.append(p.key_averages())) as prof:
            for _step in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
    except Exception as e:  # an optional measurement: report, do not fail
        print(f"  profiler unavailable: {type(e).__name__}: {e}", flush=True)
        return None
    out = {}
    for e in got[-1] if got else ():
        if getattr(e, "device_type", None) != DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.key.startswith(("Memcpy", "Memset", "region:")):
            continue
        sym = e.key.split("(")[0].split("<")[0].split(" ")[-1].split("::")[-1]
        t = out.setdefault(sym, [0.0, 0])
        t[0] += e.self_device_time_total / 1e3
        t[1] += e.count
    return {k: [ms / n, n / reps] for k, (ms, n) in out.items() if n} or None


def _verify_epilogue_phase(tiled, panel_plain, items, block_run, device, sync, rng,
                           rehearse):
    """`[verify_epilogue]`: the checked launch (`vt_verify_tiles_checked`:
    the verify kernel's lane program with its epilogue), tolerance 0
    throughout. At every width of EPILOGUE_WIDTHS over the perturbed panel
    tiled (lane i is the panel's lane i mod its width, so `panel_plain`,
    the plain version's verdicts on the panel, gives every lane's): its
    verdicts against `vt_verify_tiles`' and the plain version's on every
    lane, its summed partials against the standalone `verdict_checksum` kernel and
    `verdict_checksum_reference`, its per-warp partials against
    `epilogue_reference`. At every layout of EPILOGUE_LAYOUTS, one checked
    launch a shard into the group buffers with a seeded live mask: each
    shard's (count, weighted sum, failures) against the `shard_epilogue`
    kernel and its plain version, the verdicts against `vt_verify_tiles`'
    and the plain version's. Then, at 8,192 lanes in turns (CUDA events;
    and a launch's device time by torch.profiler), the checked launch
    against the sequence a dispatch made before it (verify, two `!=`,
    checksum) and against the lane program alone in the same launcher; at
    4 x 2,048 the mesh's per-card
    sequence before (four verifies, eight `!=`, eight copies, the epilogue)
    against the new one (four checked launches, one sum). Last, the port's
    kernel launches per dispatch on the main path, the block, the stream
    and the 4-entry mesh, and the main path's device kernels per dispatch.
    Returns the kernels-line entry's measured numbers at 8,192 lanes."""
    import numpy as np
    import torch

    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch, verify_batch_stream
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.ops import shard_step as SS
    from bitcoinconsensus_tpu_torch.ops import verdict_checksum as VC
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT

    t_phase = time.perf_counter()

    def dev_args(width):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:width])).to(device)
                     for a in tiled)

    def diff(a, b) -> int:
        return int((a.cpu().long() != b.cpu().long()).sum())

    def plain(width):
        idx = torch.arange(width, device=device) % panel_plain[0].shape[0]
        return panel_plain[0][idx], panel_plain[1][idx]

    bad = max_err = 0
    widths = (16, 64) if rehearse else EPILOGUE_WIDTHS
    layouts = ((1, 64), (4, 16)) if rehearse else EPILOGUE_LAYOUTS
    for width in widths:
        args = dev_args(width)
        ok_v, nd_v = VT.verify_tiles(*args)
        ok_c, nd_c, parts = VT.verify_tiles_checked(*args)
        ok_p, nd_p = plain(width)
        sync()
        _, _, p_ref = VT.epilogue_reference(ok_c, nd_c)
        sums = list(VT.epilogue_sums(parts.cpu()))
        vc_k = VC.verdict_checksum(ok_c).cpu().tolist()
        vc_r = VC.verdict_checksum_reference(ok_c).cpu().tolist()
        n = dict(vs_unchecked=diff(ok_c, ok_v) + diff(nd_c, nd_v),
                 vs_plain=diff(ok_c, ok_p) + diff(nd_c, nd_p),
                 partial_words=diff(parts, p_ref),
                 sums=int(sums[:2] != vc_k) + int(sums[:2] != vc_r) + int(sums[2] != 0))
        max_err = max(max_err, *(abs(a - b) for a, b in zip(sums[:2], vc_k)),
                      int((parts.cpu().long() - p_ref.cpu()).abs().max()))
        bad += sum(n.values())
        _line("verify_epilogue", lanes=width, warps=parts.shape[1],
              count=sums[0], wsum=sums[1], checksum_kernel=json.dumps(vc_k),
              tolerance=0, **{f"differing_{k}": v for k, v in n.items()})
    for d, rows in layouts:
        B = d * rows
        args = dev_args(B)
        live = torch.from_numpy(rng.random(B) < 0.9).to(device)
        ok_g = torch.empty(B, dtype=torch.bool, device=device)
        needs_g = torch.empty_like(ok_g)
        parts_g = torch.empty((d, 3, -(-rows // VT.WARP)), dtype=torch.int32, device=device)
        for s in range(d):
            sl = slice(s * rows, (s + 1) * rows)
            VT.verify_tiles_checked(*(a[sl] for a in args), live=live[sl], ok_out=ok_g[sl],
                                    needs_out=needs_g[sl], partials=parts_g[s])
        trips = parts_g.sum(dim=2).T
        ok_v, nd_v = VT.verify_tiles(*args)
        ok_p, nd_p = plain(B)
        ss_k = SS.shard_epilogue(ok_g, needs_g, live, d)
        ss_r = SS.shard_epilogue_reference(ok_g, needs_g, live, d)
        sync()
        n = dict(verdicts=diff(ok_g, ok_v) + diff(needs_g, nd_v),
                 verdicts_plain=diff(ok_g, ok_p) + diff(needs_g, nd_p),
                 triples_kernel=diff(trips, ss_k), triples_plain=diff(trips, ss_r))
        max_err = max(max_err, int((trips.cpu().long() - ss_r.cpu()).abs().max()))
        bad += sum(n.values())
        _line("verify_epilogue", shards=d, rows=rows,
              failures=json.dumps(trips[2].cpu().tolist()), tolerance=0,
              **{f"differing_{k}": v for k, v in n.items()})

    # The checked launch against the sequence it replaces, at a dispatch.
    width = 64 if rehearse else 8192
    args = dev_args(width)
    reps, rounds = (1, 1) if rehearse else (20, 5)

    def old():  # vt_verify_tiles, two `!=`, the standalone checksum
        ok, _needs = VT.verify_tiles(*args)
        return VC.verdict_checksum(ok)

    fns = {"old_sequence": old, "checked": lambda: VT.verify_tiles_checked(*args),
           "checked_no_partials": lambda: VT.verify_tiles_checked(*args, partials=False)}
    ms = dict(zip(fns, _timed_turns(list(fns.values()), reps, rounds, device)))
    dev = {k: None if rehearse else _device_kernels(f, 10)
           for k, f in fns.items() if k != "checked_no_partials"}

    # The mesh's per-card sequence at 4 x 2,048, on one stream.
    d, rows = (4, 16) if rehearse else (4, 2048)
    margs = dev_args(d * rows)
    shards = [tuple(a[s * rows:(s + 1) * rows] for a in margs) for s in range(d)]
    live = torch.ones(d * rows, dtype=torch.bool, device=device)
    ok_g, needs_g = torch.empty_like(live), torch.empty_like(live)
    parts_g = torch.empty((d, 3, -(-rows // VT.WARP)), dtype=torch.int32, device=device)

    def mesh_old():  # per shard a verify, two `!=`, two copies; the epilogue
        for s, sh in enumerate(shards):
            ok, nd = VT.verify_tiles(*sh)
            ok_g[s * rows:(s + 1) * rows].copy_(ok)
            needs_g[s * rows:(s + 1) * rows].copy_(nd)
        return SS.shard_epilogue(ok_g, needs_g, live, d)

    def mesh_new():  # per shard one checked launch; one sum of the warps
        for s, sh in enumerate(shards):
            sl = slice(s * rows, (s + 1) * rows)
            VT.verify_tiles_checked(*sh, live=live[sl], ok_out=ok_g[sl],
                                    needs_out=needs_g[sl], partials=parts_g[s])
        return parts_g.sum(dim=2, dtype=torch.int32)

    mfns = {"mesh_old_sequence": mesh_old, "mesh_checked": mesh_new}
    ms.update(zip(mfns, _timed_turns(list(mfns.values()), max(1, reps // 4), rounds,
                                     device)))
    dev.update({k: None if rehearse else _device_kernels(f, 3) for k, f in mfns.items()})
    # A call's device time: each kernel's mean a launch times its launches.
    total = {k: None if v is None else round(sum(t * c for t, c in v.values()), 5)
             for k, v in dev.items()}
    _line("verify_epilogue", timed="turns", lanes=width, mesh_layout=f"{d}x{rows}",
          ms=json.dumps({k: round(v, 5) for k, v in ms.items()}),
          device_ms=json.dumps(total),
          device_kernels=json.dumps({k: None if v is None else
                                     {s: [round(t, 5), round(c, 3)] for s, (t, c) in v.items()}
                                     for k, v in dev.items()}),
          kernels_per_call=json.dumps({k: None if v is None else
                                       round(sum(c for _, c in v.values()), 3)
                                       for k, v in dev.items()}))
    # The epilogue's marginal device cost: a checked launch's mean device
    # time less an unchecked one's, both captured in this phase.
    per_launch = {k: None if v is None else v.get(sym, [None])[0] for k, v, sym in (
        ("unchecked", dev["old_sequence"], "vt_verify_kernel"),
        ("checked", dev["checked"], "vt_verify_checked_kernel"))}
    marginal = None if None in per_launch.values() else \
        round(per_launch["checked"] - per_launch["unchecked"], 5)

    # The port's kernel launches per dispatch on each path, and the main
    # path's device kernels per dispatch.
    connect, _want, block_cfg = block_run[:3]
    size = len(items) // 5
    batches = [items[k * size:(k + 1) * size] for k in range(5)]

    def caches():
        return dict(sig_cache=SigCache(), script_cache=ScriptExecutionCache())

    drives = {
        "main_path": (TorchSecpVerifier(device=device),
                      lambda v: verify_batch(items, verifier=v, **caches())),
        "block": (TorchSecpVerifier(device=device, **block_cfg), connect),
        "stream": (TorchSecpVerifier(device=device), lambda v: list(verify_batch_stream(
            iter(batches), verifier=v, depth=2, **caches()))),
        "mesh": (_mesh_verifier(device),
                 lambda v: verify_batch(items, verifier=v, **caches())),
    }
    per_dispatch = {}
    for path, (v, run) in drives.items():
        sync()
        VT.verify_tiles_checked.launches = VT.verify_tiles.launches = 0
        VC.verdict_checksum.launches = SS.shard_epilogue.launches = 0
        run(v)
        sync()
        launched = (VT.verify_tiles_checked.launches + VT.verify_tiles.launches
                    + VC.verdict_checksum.launches + SS.shard_epilogue.launches)
        per_dispatch[path] = round(launched / max(int(v.stats["dispatches"]), 1), 4)
    # One warm-up call and one profiled call of the main path.
    main_v, main_run = drives["main_path"]
    dispatches0 = int(main_v.stats["dispatches"])
    kernels = None if rehearse else _device_kernels(lambda: main_run(main_v), 1)
    per_call = (int(main_v.stats["dispatches"]) - dispatches0) / 2
    _line("verify_epilogue", launches_per_dispatch=json.dumps(per_dispatch),
          mesh_entries=MESH_ENTRIES, main_path_dispatches=per_call,
          main_path_device_kernels_per_dispatch=json.dumps(
              None if kernels is None or not per_call else
              {s: round(c / per_call, 4) for s, (_t, c) in kernels.items()}))
    _line("verify_epilogue", widths=len(widths), layouts=len(layouts),
          tolerance=0, differing=bad, max_abs_err=max_err,
          epilogue_marginal_device_ms=json.dumps(marginal),
          seconds=f"{time.perf_counter() - t_phase:.2f}")
    if bad:
        _fail("[verify_epilogue]: the checked launch disagrees with the unchecked "
              "kernel, the plain version or the standalone checksum and epilogue")
    if not rehearse and (per_dispatch["main_path"] != 1 or per_dispatch["block"] != 1
                         or per_dispatch["stream"] != 1
                         or per_dispatch["mesh"] != MESH_ENTRIES):
        _fail(f"[verify_epilogue]: a dispatch launched more than its kernel: "
              f"{per_dispatch}")
    return dict(ms=ms["checked"], device_ms=per_launch["checked"], max_abs_err=max_err,
                old_sequence_ms=ms["old_sequence"],
                epilogue_marginal_device_ms=marginal)


def _mesh_verifier(device, **kw):
    """A ShardedSecpVerifier over MESH_ENTRIES entries of `device`."""
    from bitcoinconsensus_tpu_torch.parallel import ShardedSecpVerifier, make_mesh

    return ShardedSecpVerifier(mesh=make_mesh(devices=[str(device)] * MESH_ENTRIES), **kw)


def _shard_lane_recorder(verifier):
    """Wrap a mesh verifier's sharded step so that it keeps the live lanes
    of each shard of each sharded launch (a clean run's: a re-dispatch
    would record its launch's again)."""
    seen = []
    step = verifier._step

    def keep(*args):
        seen.append(list(verifier.last_shard_lanes))
        return step(*args)

    verifier._step = keep
    return seen


def _mesh_phase(items, results, block_run, sent, device, sync, rehearse, path_launches):
    """`[mesh]`: a ShardedSecpVerifier over 4 entries of the card (one
    stream each): the main path's inputs through `verify_batch` in index
    mode, the config-5 block through `connect_block` and the stream's 5
    batches through `verify_batch_stream`, each with fresh caches and its
    kernels' launch counts set to 0 just before it and read just after:
    every verdict equal to the single-device runs', the checked verify
    kernel launched once a shard with its partials, and the standalone
    epilogue, the unchecked verify kernel and the standalone checksum
    never. Then `verify_checks_with_verdict`'s all_ok on a
    clean and a bad batch; the main path sharded against single in turns
    (single, mesh, mesh, single; a figure for the record, not a claim); and
    the one-entry mesh of `make_mesh()` on the card, which dispatches as the
    base verifier (mesh_dispatches=0, the reference's d < 2 rule). Returns
    the context of the next phases."""
    import torch

    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch, verify_batch_stream
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.ops import shard_step as SS
    from bitcoinconsensus_tpu_torch.ops import verdict_checksum as VC
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
    from bitcoinconsensus_tpu_torch.parallel import ShardedSecpVerifier, make_mesh

    t_phase = time.perf_counter()
    want = _verdicts(results)

    def counted(path, verifier, fn):
        sync()
        VT.verify_tiles_checked.launches = VT.verify_tiles_checked.checksummed = 0
        VT.verify_tiles.launches = SS.shard_epilogue.launches = 0
        VC.verdict_checksum.launches = 0
        t0 = time.perf_counter()
        out = fn()
        sync()
        dt = time.perf_counter() - t0
        n = dict(verify=VT.verify_tiles_checked.launches,
                 partials=VT.verify_tiles_checked.checksummed,
                 unchecked=VT.verify_tiles.launches, epilogue=SS.shard_epilogue.launches,
                 checksum=VC.verdict_checksum.launches)
        path_launches[path] = n["verify"]
        md = int(verifier.stats["mesh_dispatches"])
        if not rehearse and (md < 1 or n["verify"] != MESH_ENTRIES * md
                             or n["partials"] != n["verify"] or n["unchecked"]
                             or n["epilogue"] or n["checksum"]
                             or verifier.stats["mesh_unsharded"]):
            _fail(f"[mesh] {path}: the sharded dispatches did not make one checked "
                  f"verify launch a shard and nothing else: {n}, mesh_dispatches={md}")
        return out, n, dt

    def line(path, verifier, n, dt, lanes, differing, **extra):
        st = verifier.stats
        _line("mesh", path=path, entries=MESH_ENTRIES, device=str(device),
              checks=int(st["lanes"]), padded_lanes=int(st["padded_lanes"]),
              dispatches=int(st["dispatches"]), mesh_dispatches=int(st["mesh_dispatches"]),
              shard_lanes=json.dumps(lanes), verify_launches=n["verify"],
              partials_launches=n["partials"], unchecked_verify_launches=n["unchecked"],
              epilogue_launches=n["epilogue"], checksum_launches=n["checksum"],
              kernel_ms=f"{st['kernel_ms']:.3f}", s=f"{dt:.4f}", tolerance=0,
              differing=differing, **extra)

    mv = _mesh_verifier(device)
    lanes = _shard_lane_recorder(mv)
    res, n, dt = counted("mesh_main_path", mv, lambda: verify_batch(
        items, verifier=mv, sig_cache=SigCache(), script_cache=ScriptExecutionCache()))
    diff = sum(a != b for a, b in zip(_verdicts(res), want, strict=True))
    line("main_path", mv, n, dt, lanes, diff, inputs=len(items))
    if diff:
        _fail("[mesh] main_path: a verdict differs from the single-device verifier's")

    connect, block_want, block_cfg = block_run[:3]
    bv = _mesh_verifier(device, min_batch=block_cfg["min_batch"], chunk=block_cfg["chunk"])
    lanes = _shard_lane_recorder(bv)
    got, n, dt = counted("mesh_block", bv, lambda: connect(bv))
    line("block", bv, n, dt, lanes, int(got != block_want), ok=got[0])
    if got != block_want:
        _fail("[mesh] block: the result differs from the native block's")

    size = len(items) // 5
    batches = [items[k * size:(k + 1) * size] for k in range(5)]
    sv = _mesh_verifier(device)
    lanes = _shard_lane_recorder(sv)
    outs, n, dt = counted("mesh_stream", sv, lambda: list(verify_batch_stream(
        iter(batches), verifier=sv, sig_cache=SigCache(),
        script_cache=ScriptExecutionCache(), depth=2)))
    diff = sum(_verdicts(o) != want[k * size:(k + 1) * size] for k, o in enumerate(outs))
    line("stream", sv, n, dt, lanes, diff, batches=len(batches), depth=2)
    if diff or len(outs) != len(batches):
        _fail("[mesh] stream: a batch differs from verify_batch's")

    checks = sent[:2000]
    single = TorchSecpVerifier(device=device).verify_checks(checks)
    clean = [c for c, w in zip(checks, single) if w]
    bad = clean + [next(c for c, w in zip(checks, single) if not w)]
    vv = _mesh_verifier(device)
    r_clean, ok_clean = vv.verify_checks_with_verdict(clean)
    r_bad, ok_bad = vv.verify_checks_with_verdict(bad)
    _line("mesh", path="verify_checks_with_verdict", clean=len(clean), bad=len(bad),
          clean_all_ok=ok_clean, bad_all_ok=ok_bad,
          clean_results_all=bool(r_clean.all()), bad_rejected=int((~r_bad).sum()))
    if not ok_clean or ok_bad or not r_clean.all() or int((~r_bad).sum()) != 1:
        _fail("[mesh] verify_checks_with_verdict: the block verdict is wrong")

    turns = {"single": [], "mesh": []}
    for kind in ("single", "mesh", "mesh", "single")[:2 if rehearse else 4]:
        v = TorchSecpVerifier(device=device) if kind == "single" else _mesh_verifier(device)
        sync()
        t0 = time.perf_counter()
        res_t = verify_batch(items, verifier=v, sig_cache=SigCache(),
                             script_cache=ScriptExecutionCache())
        sync()
        turns[kind].append(time.perf_counter() - t0)
        if _verdicts(res_t) != want:
            _fail(f"[mesh] turns: the {kind} run's verdicts changed")
    _line("mesh_turns", order="single,mesh,mesh,single", inputs=len(items),
          single_s=json.dumps([round(t, 4) for t in turns["single"]]),
          mesh_s=json.dumps([round(t, 4) for t in turns["mesh"]]),
          mesh_over_single=f"{sum(turns['mesh']) / sum(turns['single']):.3f}",
          note="a_figure_for_the_record_not_a_claim")

    one = ShardedSecpVerifier(mesh=make_mesh(devices=[str(device)]) if rehearse
                              else make_mesh())
    res1 = verify_batch(items, verifier=one, sig_cache=SigCache(),
                        script_cache=ScriptExecutionCache())
    diff = sum(a != b for a, b in zip(_verdicts(res1), want, strict=True))
    _line("mesh", path="one_entry", entries=one.mesh.size,
          mesh_dispatches=int(one.stats["mesh_dispatches"]),
          dispatches=int(one.stats["dispatches"]), differing=diff,
          note="one_entry_dispatches_as_the_base_verifier_not_a_shard_run")
    if diff or one.stats["mesh_dispatches"] or one.mesh.size != (
            1 if rehearse else torch.cuda.device_count()):
        _fail("[mesh] one_entry: the one-entry mesh differs from the base verifier")
    _line("mesh_time", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return dict(checks=checks, single=single)


def _mesh_faults_phase(ctx, device, rehearse) -> None:
    """`[mesh_faults]`: the fault harness on the 4-entry card mesh over the
    main path's first 2,000 checks, one line a case (`held`: the verdicts
    equal the clean run's, or the case raised what it must; `wrong_accepts`
    must be 0): a flip at shard 2, convicted by that shard's checksum, the
    other shards' verdicts standing; a device loss at shard 1 with
    evict_after=1, which evicts, rebuilds over 3 entries and answers the lost
    lanes again, then a batch over the 3 shards; re-promotion after the clean
    dispatches the ladder asks for; a failed probe that keeps the entry out;
    a straggle past BITCOINCONSENSUS_TPU_SHARD_DEADLINE_S on an armed width;
    and every shard failing, which must raise DispatchFailed after the retry
    budget."""
    import numpy as np

    from bitcoinconsensus_tpu_torch.parallel import mesh as M
    from bitcoinconsensus_tpu_torch.resilience import FaultPlan, FaultSpec, inject
    from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchFailed

    checks, want = ctx["checks"], np.asarray(ctx["single"], dtype=bool)
    bad_cases = []

    def counts():
        return ({lvl: M._MESH_REDISPATCH_LANES.value(level=lvl) for lvl in ("mesh", "device")},
                {k: v for k, v in _metric_samples("consensus_mesh_shard_failures_total")},
                {k: v for k, v in _metric_samples("consensus_mesh_repromotions_total")})

    def run(case, v, plan=None, expect_raise=False, **extra):
        before = counts()
        raised = None
        res = None
        try:
            if plan is None:
                res = v.verify_checks(checks)
            else:
                with inject(FaultPlan(plan)):
                    res = v.verify_checks(checks)
        except DispatchFailed as e:
            raised = e
        after = counts()
        wrong = 0 if res is None else int((res & ~want).sum())
        held = (raised is not None) if expect_raise else (
            res is not None and bool(np.array_equal(res, want)))
        redisp = {k: int(after[0][k] - before[0][k]) for k in after[0]}
        fails = {f"{dict(k)['device']}:{dict(k)['reason']}": int(v_ - before[1].get(k, 0))
                 for k, v_ in after[1].items() if v_ - before[1].get(k, 0)}
        repro = int(sum(after[2].values()) - sum(before[2].values()))
        _line("mesh_faults", case=case, held=held, wrong_accepts=wrong,
              evicted=json.dumps(list(v._shard_ladder._evicted)),
              devices_after=v.mesh.size, redispatch_lanes=json.dumps(redisp),
              shard_failures=json.dumps(fails), repromotions=repro,
              raised=type(raised).__name__ if raised else None,
              cause=getattr(getattr(raised, "__cause__", None), "reason", None), **extra)
        if not held or wrong:
            bad_cases.append(case)
        return res, redisp, fails

    v = _mesh_verifier(device)
    run("clean", v)
    _res, redisp, fails = run("flip_shard_2", v, [FaultSpec("mesh.shard.2", "flip")])
    if set(fails) != {"2:checksum"} or not redisp["mesh"]:
        bad_cases.append("flip_shard_2 (convicted elsewhere or not re-dispatched)")

    v = _mesh_verifier(device, evict_after=1)
    run("device_loss_shard_1", v, [FaultSpec("mesh.shard.1", "device-loss")])
    # Two clean dispatches nominate the evicted entry for its probe: the
    # first over the 3 survivors, the second ends in the probe.
    v._shard_ladder.reprobe_after = 2
    run("after_eviction", v)
    if v.mesh.size != MESH_ENTRIES - 1 or len(v.last_shard_lanes) != MESH_ENTRIES - 1:
        bad_cases.append("after_eviction (no eviction or no 3-shard batch)")
    run("repromoted_after_probe", v)
    if v.mesh.size != MESH_ENTRIES:
        bad_cases.append("repromoted_after_probe (the entry stayed out)")

    v = _mesh_verifier(device, evict_after=1)
    run("device_loss_shard_3", v, [FaultSpec("mesh.shard.3", "device-loss")])
    v._shard_ladder.reprobe_after = 1
    run("failed_probe", v, [FaultSpec("mesh.probe", "raise")])
    if v.mesh.size != MESH_ENTRIES - 1:
        bad_cases.append("failed_probe (the entry came back)")

    v = _mesh_verifier(device)
    run("straggle_unarmed_width", v, [FaultSpec("mesh.shard.0", "straggle", value=9e9)])
    _res, _r, fails = run("straggle_armed", v,
                          [FaultSpec("mesh.shard.0", "straggle", value=9e9)],
                          deadline_s=v._shard_deadline_s)
    if set(fails) != {"0:deadline"}:
        bad_cases.append("straggle_armed (not convicted on its deadline)")

    v = _mesh_verifier(device)
    run("all_shards_fail", v, [FaultSpec(f"mesh.shard.{s}", "flip", count=64)
                               for s in range(MESH_ENTRIES)], expect_raise=True)
    if bad_cases:
        _fail(f"[mesh_faults]: {bad_cases}")


def _metric_samples(name):
    """(labels as a sorted tuple, value) of one metric of the port's registry."""
    from bitcoinconsensus_tpu_torch.obs import get_registry

    m = get_registry().snapshot().get(name) or {"samples": []}
    return [(tuple(sorted(s["labels"].items())), s["value"]) for s in m["samples"]]


def _mesh_xprof_phase(ctx, device, sync, rehearse, out_dir) -> None:
    """`[xprof]` of one warmed sharded dispatch (`verify_checks` of the
    2,000 checks on the 4-entry card mesh): `vt_verify_checked_kernel`
    charged to `verify_tiles`, no `ss_epilogue_kernel`, unchecked verify or
    checksum kernel, no kernel of the port unattributed (the warps' sums
    are PyTorch reductions, listed); the busy share and the idle gaps."""
    from bitcoinconsensus_tpu_torch.obs import xprof

    if rehearse:
        _line("xprof", path="mesh", skipped="a capture measures the card; none in a rehearsal")
        return
    v = _mesh_verifier(device)
    checks = ctx["checks"]

    def run():
        v.verify_checks(checks)

    run()
    sync()
    rep = xprof.capture_report(run, log_dir=os.path.join(HERE, "build", "xprof", "mesh"))
    xprof.write_report(rep, os.path.join(out_dir, "xprof_mesh.json"))
    sym, regions = rep["symbols"], rep["regions"]
    port_unattr = {k: v_ for k, v_ in rep["unattributed_symbols"].items()
                   if k.startswith(("vt_", "vc_", "sh_", "ss_", "tk_"))}
    _line("xprof", path="mesh", wall_s=f"{rep['walls_s'][0]:.4f}",
          regions_ms=json.dumps({k: round(r["seconds"] * 1e3, 5) for k, r in regions.items()}),
          symbols_ms=json.dumps({k: round(t * 1e3, 5) for k, t in sym.items()}),
          port_unattributed_ms=f"{sum(port_unattr.values()) * 1e3:.5f}",
          device_busy_share=f"{rep['device_busy_share']:.5f}",
          window_ms=f"{rep['window_s'] * 1e3:.3f}", kernels=rep["kernels"])
    for g in rep["gaps"]:
        _line("xprof", path="mesh", gap_ms=f"{g['length_s'] * 1e3:.3f}",
              at_ms=f"{g['start_s'] * 1e3:.3f}", host_span=g["host_span"])
    stale = [k for k in ("ss_epilogue_kernel", "vt_verify_kernel", "vc_checksum_kernel")
             if sym.get(k)]
    if (not sym.get("vt_verify_checked_kernel") or stale or port_unattr
            or regions.get("verify_tiles", {}).get("seconds")
            != sym["vt_verify_checked_kernel"]
            or not 0.0 < rep["device_busy_share"] <= 1.0):
        _fail(f"[xprof] mesh: the capture did not charge the checked launch to "
              f"verify_tiles, or the old route ran: {stale}")


SHA_WIDTHS = (1, 2048, 8192, 262144)
# 32-bit instructions of one SHA-256 compression at the fewest the card
# needs, as csrc/sha256.cu's note counts them: 48 schedule words of 10 (two
# funnel shifts and a shift, one three-way xor as a LOP3, two three-input
# adds as IADD3s), 64 rounds of 14 (six funnel shifts, a LOP3 each for Σ1,
# Σ0, ch and maj, four IADD3s), and the 8 final adds; a block whose schedule
# is a constant (a padding-only block) needs only its rounds.
SHA_INSTR_PER_COMPRESSION = 48 * 10 + 64 * 14 + 8
SHA_INSTR_CONSTANT_BLOCK = 64 * 14 + 8
# The card's ceiling for such instructions: each of an SM's four partitions
# starts one warp instruction (32 lanes) a clock, 132 SMs at 1.98 GHz. The
# int32 rate above (64 lanes a clock) is the verify kernel's yardstick for
# multiply-adds; SHA-256's logic, shifts and adds also run on the other
# pipe, and the challenge kernel runs faster than the time that rate gives
# (0.043 ms against 0.072 at 262,144 lanes on an H100 80GB HBM3 at 700 W),
# so the instruction ceiling gives the least time here.
H100_INSTR_RATE = 132 * 4 * 32 * 1.98e9
SHA_SOURCE = "bitcoinconsensus_tpu_torch/csrc/sha256.cu"


def _sha_counts():
    """The five SHA-256 wrappers' launch counts, by kernel symbol."""
    from bitcoinconsensus_tpu_torch.ops import sha256 as SH

    return {k: w.launches for k, w in SH.WRAPPERS.items()}


def _sha_zero():
    from bitcoinconsensus_tpu_torch.ops import sha256 as SH

    for w in SH.WRAPPERS.values():
        w.launches = 0


def _challenge_path(items, results, py_sent, device, sync, launches_around,
                    rehearse):
    """`[challenge_path]`: the main path's inputs through one `verify_batch`
    on the Python engine with `device_challenge` off and on, in turns (off,
    on, on, off), each with a fresh verifier and caches: every verdict equal
    to `[main_path]`'s, the challenge kernel's launches (> 0 on, 0 off), the
    Schnorr lanes hashed on the card, and `lane_prep_s` both ways. Beside
    it, the host's `tagged_hash` over the same Schnorr checks. Returns the
    first `on` run's challenge launches."""
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.utils.hashes import tagged_hash

    want = _verdicts(results)
    runs = {False: [], True: []}
    for on in (False, True, True, False):
        v = TorchSecpVerifier(device=device, engine="python", device_challenge=on)

        def run(v=v):
            _sha_zero()
            t0 = time.perf_counter()
            res = verify_batch(items, verifier=v, sig_cache=SigCache(),
                               script_cache=ScriptExecutionCache(), engine="python")
            sync()
            return res, time.perf_counter() - t0, _sha_counts()["sh_challenge_kernel"]

        res, dt, n_chal = launches_around(
            "challenge_path" if on else "challenge_path_host", run)
        if _verdicts(res) != want:
            _fail(f"[challenge_path]: device_challenge={on} changed a verdict")
        if not rehearse and (n_chal > 0) != on:
            _fail(f"[challenge_path]: device_challenge={on} launched the "
                  f"challenge kernel {n_chal} times")
        runs[on].append((dt, v.stats["lane_prep_s"], n_chal,
                         int(v.stats.get("challenge_lanes", 0)),
                         int(v.stats["dispatches"])))
    schnorr = [c for c in py_sent if c.kind == "schnorr"]
    t0 = time.perf_counter()
    for c in schnorr:
        pk, sig, msg = c.data
        tagged_hash("BIP0340/challenge", sig[:32] + pk + msg)
    host_hash_s = time.perf_counter() - t0
    on, off = runs[True], runs[False]
    _line("challenge_path", inputs=len(items), order="off,on,on,off",
          schnorr_checks=len(schnorr), challenge_lanes=on[0][3],
          challenge_launches=on[0][2], dispatches=on[0][4],
          off_launches=off[0][2], verdicts_equal_main_path=True,
          lane_prep_s_on=json.dumps([round(r[1], 4) for r in on]),
          lane_prep_s_off=json.dumps([round(r[1], 4) for r in off]),
          total_s_on=json.dumps([round(r[0], 4) for r in on]),
          total_s_off=json.dumps([round(r[0], 4) for r in off]),
          host_tagged_hash_s=f"{host_hash_s:.5f}")
    if on[0][3] != on[1][3] or (not rehearse and on[0][3] == 0):
        _fail("[challenge_path]: the Schnorr lanes hashed on the card differ "
              "between runs, or none were")
    return on[0][2]


def _sha_bound(lanes: int, compressions: int, nbytes: float, constant_blocks: int = 0,
               extra_ops: int = 0):
    """(bound_ms, bound_by) of `lanes` lanes of `compressions` compressions,
    `constant_blocks` of which hash a block whose schedule is a constant."""
    per_lane = ((compressions - constant_blocks) * SHA_INSTR_PER_COMPRESSION
                + constant_blocks * SHA_INSTR_CONSTANT_BLOCK + extra_ops)
    return _bound(nbytes, float(lanes) * per_lane, H100_INSTR_RATE)


def _tree_pairs(n: int) -> int:
    """The pairs the merkle tree of n leaves hashes: ceil(n_l / 2) at each
    level, the odd tail's self-pair included."""
    pairs = 0
    while n > 1:
        n = (n + 1) // 2
        pairs += n
    return pairs


def _sha256_phase(device, rng, rehearse, chal_width: int, merkle_width: int,
                  tree_width: int):
    """`[sha256]`: each kernel of csrc/sha256.cu against its plain version on
    the card at the sweep widths (1, 2,048, 8,192, 262,144 lanes; the tree
    at 1, 4,097 and 262,144 leaves; tolerance 0, every byte compared; the
    fixed hash also on a view one byte past an aligned address,
    `sh_fixed_kernel@1`, read in aligned words), and on 256
    lanes against hashlib (single and double hashes at six lengths with and
    without a midstate and at three misaligned offsets, challenges, merkle
    pairs, a 512-leaf tree, and a compression of H0 over a padded message).
    At each width its time per call (CUDA events, the wrapper's host cost
    included), its device time (torch.profiler, a launch, from 4,097
    lanes), the plain version's time (its checked call) and its
    bound: the fewest 32-bit instructions of its compressions over the
    card's instruction ceiling (3.35e13/s) against its bytes over 3.35 TB/s
    (the tree: its pairs at 3,672 instructions and 16 more, with its depth,
    the levels, and its device time at two leaves beside). Then each at the
    width its path gives it (the challenge at the main path's first
    dispatch's Schnorr lanes, the tree at the config-5 block's txids, the
    merkle level at their first level; the compression and the fixed hash,
    on no path, at 8,192). Returns the kernels-line entries by kernel
    symbol."""
    import hashlib

    import numpy as np
    import torch

    from bitcoinconsensus_tpu_torch.core.block import merkle_root
    from bitcoinconsensus_tpu_torch.ops import sha256 as SH
    from bitcoinconsensus_tpu_torch.utils.hashes import tagged_hash

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)

    def words(rows, n):
        return torch.from_numpy(rng.integers(0, 1 << 32, (rows, n), dtype=np.uint32)).to(device)

    def at_offset(t, offset):
        """t's bytes in a contiguous view `offset` bytes past an aligned one."""
        buf = torch.zeros(t.numel() + 16, dtype=torch.uint8, device=device)
        view = buf[offset:offset + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    def cases(n):
        """(label, symbol, kernel call, plain call, hashes, bytes,
        compressions, constant blocks, extra ops): the fixed hash of 64-byte
        rows and a merkle pair each hash a padding-only block; a merkle pair
        compares 8 words; the tree hashes `_tree_pairs(n)` pairs."""
        st, bl = words(8, n), words(16, n)
        pairs = u8(n, 64)
        odd = at_offset(pairs, 1)
        r, p, m = u8(n, 32), u8(n, 32), u8(n, 32)
        level = u8(2 * n, 32)
        if n > 1:
            level[2 * n - 1] = level[2 * n - 2]  # the last sibling pair equal
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        pflag = torch.zeros(1, dtype=torch.int32, device=device)
        leaves = u8(n, 32)
        if n > 1:
            leaves[1] = leaves[0]  # the first sibling pair equal
        work = torch.zeros(SH.tree_work_bytes(n), dtype=torch.uint8, device=device)
        return [
            ("sh_compress_kernel", "sh_compress_kernel",
             lambda: SH.sha256_compress(st, bl),
             lambda: SH.sha256_compress_reference(st, bl), n, n * 32 * 4.0, 1, 0, 0),
            ("sh_fixed_kernel", "sh_fixed_kernel", lambda: SH.sha256d_fixed(pairs),
             lambda: SH.sha256d_fixed_reference(pairs), n, n * 96.0 + 32, 3, 1, 0),
            ("sh_fixed_kernel@1", "sh_fixed_kernel", lambda: SH.sha256d_fixed(odd),
             lambda: SH.sha256d_fixed_reference(odd), n, n * 96.0 + 32, 3, 1, 0),
            ("sh_challenge_kernel", "sh_challenge_kernel",
             lambda: SH.bip340_challenge(r, p, m),
             lambda: SH.bip340_challenge_reference(r, p, m), n, n * 128.0, 2, 0, 0),
            ("sh_merkle_level_kernel", "sh_merkle_level_kernel",
             lambda: (SH.merkle_level(level, flag), flag),
             lambda: (SH.merkle_level_reference(level, pflag), pflag),
             n, n * 96.0 + 4, 3, 1, 16),
            ("sh_merkle_tree_kernel", "sh_merkle_tree_kernel",
             lambda: SH.merkle_tree(leaves, work),
             lambda: SH.merkle_tree_reference(leaves),
             _tree_pairs(n), n * 32.0 + 36, 3, 1, 16),
        ]

    def differing(a, b) -> int:
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        return sum(int((x.cpu().numpy().view(np.uint8)
                        != y.cpu().numpy().view(np.uint8)).sum()) for x, y in zip(a, b))

    def checked(kern, plain):
        """(differing bytes, the plain call's ms): one call of each, the
        plain one timed by the host clock, synchronised."""
        got = kern()
        sync()
        t0 = time.perf_counter()
        want = plain()
        sync()
        return differing(got, want), (time.perf_counter() - t0) * 1e3

    _sha_zero()
    t_phase = time.perf_counter()
    widths = (1, 64) if rehearse else SHA_WIDTHS
    total_diff = 0
    two = u8(2, 32)
    two_work = torch.zeros(SH.tree_work_bytes(2), dtype=torch.uint8, device=device)
    two_leaf_ms = None if rehearse else _device_ms(
        lambda: SH.merkle_tree(two, two_work), 20, "sh_merkle_tree_kernel")

    def tree_depth(n):
        """The tree's depth beside its bound: its levels, and its device
        time at two leaves (one level)."""
        return dict(levels=(n - 1).bit_length(), two_leaf_device_ms=json.dumps(two_leaf_ms))

    # The tree sweeps its own widths (its plain version pays seconds a
    # width): one leaf, 4,097 (nine chunks, a ragged tail) and 262,144; the
    # block's txids come with the path widths below.
    tree_widths = (1, 64) if rehearse else (1, 4097, 262144)
    for n in sorted(set(widths) | set(tree_widths)):
        for label, sym, kern, plain, hashes, nbytes, comps, const, extra in cases(n):
            if n not in (tree_widths if sym == "sh_merkle_tree_kernel" else widths):
                continue
            diff, p_ms = checked(kern, plain)
            total_diff += diff
            ms = _timed(kern, 1 if rehearse else 20, device)
            dev_ms = None if rehearse or n not in (4097, 8192, 262144) else \
                _device_ms(kern, 20, sym)
            b_ms, b_by = _sha_bound(hashes, comps, nbytes, const, extra)
            depth = tree_depth(n) if sym == "sh_merkle_tree_kernel" else {}
            _line("sha256", kernel=label, lanes=n, tolerance=0, differing_bytes=diff,
                  ms=f"{ms:.5f}", device_ms=json.dumps(dev_ms), plain_ms=f"{p_ms:.4f}",
                  bound_ms=f"{b_ms:.3g}", bound_by=b_by,
                  bound_share=f"{b_ms / (dev_ms or ms):.4f}", **depth)
    # 256 lanes against hashlib: lengths across the padding boundaries, with
    # and without the TapSighash midstate, and misaligned; the challenge;
    # merkle pairs; a tree.
    n = 256
    sample_diff = 0
    th = hashlib.sha256(b"TapSighash").digest()
    ms_tag = SH.tag_midstate("TapSighash")
    for length in (0, 55, 56, 64, 80, 119, 200):
        data = u8(n, length)
        host = data.cpu().numpy()
        one = SH.sha256_fixed(data).cpu().numpy()
        two = SH.sha256d_fixed(data).cpu().numpy()
        tag = SH.sha256_fixed(data, midstate=ms_tag, prefix_len=64).cpu().numpy()
        for i in range(n):
            h = hashlib.sha256(host[i].tobytes()).digest()
            sample_diff += (one[i].tobytes() != h) + (two[i].tobytes() != hashlib.sha256(h).digest())
            sample_diff += tag[i].tobytes() != hashlib.sha256(th + th + host[i].tobytes()).digest()
    for offset, length in ((1, 64), (2, 55), (3, 119)):
        data = u8(n, length)
        host = data.cpu().numpy()
        two = SH.sha256d_fixed(at_offset(data, offset)).cpu().numpy()
        sample_diff += sum(two[i].tobytes() != hashlib.sha256(hashlib.sha256(
            host[i].tobytes()).digest()).digest() for i in range(n))
    r, p, m = u8(n, 32), u8(n, 32), u8(n, 32)
    chal = SH.bip340_challenge(r, p, m).cpu().numpy()
    rh, ph, mh = (x.cpu().numpy() for x in (r, p, m))
    sample_diff += sum(chal[i].tobytes() != tagged_hash(
        "BIP0340/challenge", rh[i].tobytes() + ph[i].tobytes() + mh[i].tobytes())
        for i in range(n))
    level = u8(2 * n, 32)
    lv = SH.merkle_level(level, torch.zeros(1, dtype=torch.int32, device=device)).cpu().numpy()
    lh = level.cpu().numpy()
    sample_diff += sum(lv[j].tobytes() != hashlib.sha256(hashlib.sha256(
        lh[2 * j].tobytes() + lh[2 * j + 1].tobytes()).digest()).digest() for j in range(n))
    root, flag = SH.merkle_tree(level)
    sample_diff += (root.cpu().numpy().tobytes(), bool(flag.item())) != \
        merkle_root([x.tobytes() for x in lh])
    msg = rng.integers(0, 256, 55, dtype=np.uint8).tobytes()
    blk = np.frombuffer(msg + SH._padding(55), dtype=">u4").astype(np.uint32)
    h0 = np.asarray(SH._H0, dtype=np.uint32)[:, None]
    st = SH.sha256_compress(torch.from_numpy(h0).to(device),
                            torch.from_numpy(blk[:, None].copy()).to(device))
    sample_diff += SH._bytes_from_words(st.cpu()).numpy()[0].tobytes() != \
        hashlib.sha256(msg).digest()
    launches = _sha_counts()
    _line("sha256", widths=json.dumps(list(widths)), tolerance=0,
          differing_bytes=total_diff, hashlib_sample=n, hashlib_differing=sample_diff,
          launches=json.dumps(launches), seconds=f"{time.perf_counter() - t_phase:.2f}")
    if total_diff or sample_diff:
        _fail("[sha256]: a SHA-256 kernel disagrees with its plain version or hashlib")
    if not rehearse and 0 in launches.values():
        _fail(f"[sha256]: a wrapper never launched its kernel: {launches}")
    # Each kernel at the width its path gives it: the kernels line's numbers.
    at = {"sh_compress_kernel": 8192, "sh_fixed_kernel": 8192,
          "sh_challenge_kernel": max(chal_width, 1),
          "sh_merkle_level_kernel": max(merkle_width, 1),
          "sh_merkle_tree_kernel": max(tree_width, 1)}
    entries = {}
    for sym, width in at.items():
        _, _, kern, plain, hashes, nbytes, comps, const, extra = next(
            c for c in cases(width) if c[0] == sym)
        err, p_ms = checked(kern, plain)
        ms = _timed_turns([kern], 1 if rehearse else 200, 1 if rehearse else 7, device)[0]
        dev_ms = None if rehearse else _device_ms(kern, 50, sym)
        b_ms, b_by = _sha_bound(hashes, comps, nbytes, const, extra)
        _line("sha256", kernel=sym, path_lanes=width, max_abs_err=err, ms=f"{ms:.5f}",
              device_ms=json.dumps(dev_ms), plain_ms=f"{p_ms:.4f}",
              bound_ms=f"{b_ms:.3g}", bound_by=b_by,
              **(tree_depth(width) if sym == "sh_merkle_tree_kernel" else {}))
        if err:
            _fail(f"[sha256]: {sym} disagrees with its plain version at {width} lanes")
        entries[sym] = dict(lanes=width, max_abs_err=err, ms=ms, plain_ms=p_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            device_ms=dev_ms)
    return entries, launches


def _level_sequence_root(hashes, device):
    """The merkle root as `merkle_root_device` took it before the tree
    kernel: one upload, one `merkle_level` launch a level, one readback."""
    import numpy as np
    import torch

    from bitcoinconsensus_tpu_torch.ops import sha256 as SH

    n = len(hashes)
    staged = np.zeros(32 * n + 36, dtype=np.uint8)
    staged[:32 * n] = np.frombuffer(b"".join(hashes), dtype=np.uint8)
    buf = torch.from_numpy(staged).to(device)
    level, out = buf[:32 * n].view(n, 32), buf[32 * n:]
    mutated = out[32:].view(torch.int32)
    while level.shape[0] > 2:
        level = SH.merkle_level(level, mutated)
    SH.merkle_level(level, mutated, out=out[:32].view(1, 32))
    host = out.cpu().numpy()
    return host[:32].tobytes(), bool(host[32:].view(np.int32)[0])


def _merkle_phase(device, rng, block_txids, rehearse):
    """`[merkle]`: `merkle_root_device` on the card against the port's host
    `merkle_root` (root and `mutated` flag equal) at 1, 2, 3, 512, 513,
    2,047, 4,096, 4,097, 16,384 and 262,144 seeded leaves, the config-5
    block's txids, a duplicated sibling pair (at the start, deep in a
    4,097-leaf set, as two equal subtrees, and as two equal chunk roots) and
    odd tails equal to their neighbour (not a mutation); each timed by the
    host clock, the device's including the upload and the one readback:
    best of 3. Every root of two or more leaves must be one tree launch, and
    no level launch. Then, at the block's txids and at 262,144 leaves, the
    tree against the old level sequence (a `merkle_level` launch a level)
    in turns: the whole root by the host clock, and the launches alone on
    leaves already on the card by CUDA events and on the device. Returns
    the tree launches of the phase's sets."""
    import numpy as np
    import torch

    from bitcoinconsensus_tpu_torch.core.block import merkle_root, merkle_root_device
    from bitcoinconsensus_tpu_torch.ops import sha256 as SH

    def leaves(n):
        return [r.tobytes() for r in rng.integers(0, 256, (n, 32), dtype=np.uint8)]

    sizes = (1, 2, 3, 40) if rehearse else \
        (1, 2, 3, 512, 513, 2047, 4096, 4097, 16384, 262144)
    sets = [(str(n), leaves(n)) for n in sizes]
    sets.append(("config5_txids", list(block_txids)))
    sets.append(("dup_pair", [b"\x11" * 32] * 2 + [b"\x22" * 32, b"\x33" * 32]))
    deep = leaves(4097 if not rehearse else 41)
    deep[-2] = deep[-3]  # the last full sibling pair
    sets.append(("dup_deep", deep))
    sub = leaves(8)
    sets.append(("dup_subtree", sub[:4] * 2))
    half = leaves(SH.TREE_CHUNK if not rehearse else 8)
    sets.append(("dup_chunk_roots", half * 2))  # chunks 0 and 1 equal
    sets.append(("odd_tail_equal", [b"\x44" * 32] + [b"\x55" * 32] * 2))
    odd = leaves(4097 if not rehearse else 41)
    odd[-1] = odd[-2]
    sets.append(("odd_tail_equal_4097", odd))
    dev = None if device.type == "cuda" else device
    _sha_zero()
    t_phase = time.perf_counter()
    bad = []
    roots = 0
    for name, hs in sets:
        want = merkle_root(hs)
        d_times, h_times = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            got = merkle_root_device(hs, dev)
            d_times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            merkle_root(hs)
            h_times.append(time.perf_counter() - t0)
        roots += 3 * (len(hs) > 1)
        _line("merkle", leaves=len(hs), set=name, equal=got == want, mutated=got[1],
              device_ms=f"{min(d_times) * 1e3:.4f}", host_ms=f"{min(h_times) * 1e3:.4f}")
        if got != want:
            bad.append(name)
        if name.startswith("dup") != want[1]:
            bad.append(f"{name}: flag {want[1]}")
    counts = _sha_counts()
    launches = counts["sh_merkle_tree_kernel"]
    _line("merkle", sets=len(sets), differing=len(bad), roots=roots,
          tree_launches=launches, level_launches=counts["sh_merkle_level_kernel"])
    if bad:
        _fail(f"[merkle]: the device root or flag differs from the host's: {bad}")
    if not rehearse and (launches != roots or counts["sh_merkle_level_kernel"]):
        _fail(f"[merkle]: {launches} tree launches for {roots} roots, "
              f"{counts['sh_merkle_level_kernel']} level launches")
    # The tree against the level sequence, in turns.
    for name, hs in (("config5_txids", list(block_txids)),
                     ("262144", leaves(262144 if not rehearse else 64))):
        n = len(hs)
        want = merkle_root(hs)
        if _level_sequence_root(hs, device) != want:
            _fail(f"[merkle]: the level sequence's root differs at {name}")
        host_tree, host_seq = _timed_turns(
            [lambda: merkle_root_device(hs, dev), lambda: _level_sequence_root(hs, device)],
            1 if rehearse else 10 if n < 10000 else 2, 1 if rehearse else 4, device)
        on_card = torch.from_numpy(np.frombuffer(b"".join(hs), dtype=np.uint8)
                                   .reshape(n, 32).copy()).to(device)
        work = torch.zeros(SH.tree_work_bytes(n), dtype=torch.uint8, device=device)
        flag = torch.zeros(1, dtype=torch.int32, device=device)

        def tree():
            SH.merkle_tree(on_card, work)

        def seq():
            level = on_card
            while level.shape[0] > 1:
                level = SH.merkle_level(level, flag)

        ev_tree, ev_seq = _timed_turns([tree, seq], 1 if rehearse else 50,
                                       1 if rehearse else 4, device)
        d_tree = None if rehearse else _device_kernels(tree, 10)
        d_seq = None if rehearse else _device_kernels(seq, 10)

        def per_call(d, sym):
            return None if not d or sym not in d else d[sym][0] * d[sym][1]

        _line("merkle", turns=name, leaves=n, order="tree,levels,levels,tree",
              host_ms_tree=f"{host_tree:.4f}", host_ms_levels=f"{host_seq:.4f}",
              events_ms_tree=f"{ev_tree:.5f}", events_ms_levels=f"{ev_seq:.5f}",
              device_ms_tree=json.dumps(per_call(d_tree, "sh_merkle_tree_kernel")),
              device_ms_levels=json.dumps(per_call(d_seq, "sh_merkle_level_kernel")),
              level_launches=(n - 1).bit_length(), tree_launches=1)
    _line("merkle", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return launches


def _block_device_sha(block, bad_block, height, plain_view, want, bad_want, device,
                      sync, launches_around, rehearse, cfg):
    """`[block_device_sha]`: the config-5 block through `connect_block` on the
    Python block layer and engine with `device_merkle=True` and a verifier
    with `device_challenge=True`: its result and every input's equal to the
    native `[block]`'s, with the merkle tree launched once (and no merkle
    level), the challenge and checked verify kernels launched in the run;
    then `[block_reject]`'s
    corrupted block, rejected alike. Returns (`connect(verifier)` on this
    path, its launches by kernel)."""
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.models.validate import connect_block
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
    from bitcoinconsensus_tpu_torch.utils import blockgen as B

    def tup(res):
        return (res.ok, res.reason, res.fees, res.sigop_cost,
                None if res.input_results is None else _verdicts(res.input_results))

    def connect(verifier, blk=block):
        return connect_block(blk, plain_view(), height, verifier=verifier,
                             pow_limit=B.REGTEST_POW_LIMIT, sig_cache=SigCache(),
                             script_cache=ScriptExecutionCache(), engine="python",
                             device_merkle=True)

    verifier = TorchSecpVerifier(device=device, engine="python", device_challenge=True,
                                 **cfg)
    got = {}

    def run():
        _sha_zero()
        t0 = time.perf_counter()
        res = connect(verifier)
        sync()
        got["ms"] = (time.perf_counter() - t0) * 1e3
        got["sha"] = _sha_counts()
        return res

    res = launches_around("block_device_sha", run)
    counts = dict(got["sha"], vt_verify_checked_kernel=VT.verify_tiles_checked.launches)
    bad = connect(verifier, bad_block)
    _line("block_device_sha", ok=res.ok, equal_native=tup(res) == want,
          reject_reason=bad.reason, reject_equal_native=tup(bad) == bad_want,
          ms=f"{got['ms']:.3f}", challenge_lanes=int(verifier.stats["challenge_lanes"]),
          launches=json.dumps({k: counts[k] for k in (
              "sh_merkle_tree_kernel", "sh_merkle_level_kernel", "sh_challenge_kernel",
              "vt_verify_checked_kernel")}))
    if tup(res) != want or tup(bad) != bad_want:
        _fail("[block_device_sha]: the device-SHA block path differs from the native block")
    need = ("sh_merkle_tree_kernel", "sh_challenge_kernel", "vt_verify_checked_kernel")
    if not rehearse and (not all(counts[k] > 0 for k in need)
                         or counts["sh_merkle_tree_kernel"] != 1
                         or counts["sh_merkle_level_kernel"]):
        _fail(f"[block_device_sha]: a kernel of the path was not launched, or the "
              f"root was not one tree launch: {counts}")

    def connect_tup(v):
        return tup(connect(v))

    return connect_tup, counts


# -- the serving front end, the ingress, the persistent sig cache and the cell,
# after every phase above, so that those run in the process state they had
# before this slice ----------------------------------------------------------------

SERVE_CLIENTS, SERVE_TENANTS = 8, 4


def _launch_counts():
    """(checked verify launches, those that carried the checksum partials)."""
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT

    return VT.verify_tiles_checked.launches, VT.verify_tiles_checked.checksummed


def _metric_by(name, label):
    """{label value: value} of one labelled metric of the port's registry."""
    return {dict(k).get(label, ""): v for k, v in _metric_samples(name)}


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def _hist_sum_count(name):
    """(sum, count) of an unlabelled histogram of the port's registry."""
    from bitcoinconsensus_tpu_torch.obs import get_registry

    m = get_registry().snapshot().get(name) or {"samples": []}
    return (sum(s.get("sum", 0.0) for s in m["samples"]),
            sum(s.get("count", 0) for s in m["samples"]))


def _quantiles(xs):
    import numpy as np

    if not xs:
        return "nan", "nan"
    a = np.asarray(xs)
    return f"{np.quantile(a, 0.5):.4f}", f"{np.quantile(a, 0.99):.4f}"


def _pipelined(port, sessions, on_sent=None, timeout=300):
    """Each of `sessions` (a list of (rid, tenant, item) lists) on a socket of
    its own, every request sent before any answer is read; returns {rid:
    BatchResult or (code, reason) of an ERR frame}. `on_sent()` runs once all
    requests are sent."""
    import socket
    import threading

    from bitcoinconsensus_tpu_torch.serving import ingress as ING

    socks = [socket.create_connection(("127.0.0.1", port), timeout=timeout)
             for _ in sessions]
    out, lock, errors = {}, threading.Lock(), []

    def recv_exactly(s, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed mid-exchange")
            buf.extend(chunk)
        return bytes(buf)

    def reader(s, n):
        try:
            for _ in range(n):
                ftype, ln = ING.decode_header(recv_exactly(s, ING.HEADER_LEN))
                payload = recv_exactly(s, ln)
                if ftype == ING.FRAME_RESP:
                    rid, res = ING.decode_response_payload(payload)
                else:
                    rid, code, reason = ING.decode_error_payload(payload)
                    res = (code, reason)
                with lock:
                    out[rid] = res
        except Exception as e:  # surfaced as missing rids
            errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(s, len(reqs)), daemon=True)
               for s, reqs in zip(socks, sessions)]
    for t in threads:
        t.start()
    for s, reqs in zip(socks, sessions):
        s.sendall(b"".join(ING.encode_frame(ING.FRAME_REQ, ING.encode_request(r, t, it))
                           for r, t, it in reqs))
    if on_sent is not None:
        on_sent()
    for t in threads:
        t.join(timeout)
    for s in socks:
        s.close()
    return out, errors


def _serve_phase(items, results, device, launches_around, rehearse) -> None:
    """`[serve]`: the main path's inputs through one `VerifyServer` on the
    device, from 8 client threads across 4 tenants (each thread submits its
    share without waiting; a shed is retried by `verify_with_retry`), with
    the default `max_batch` (the verifier's lane capacity) and flush; then a
    short run with BITCOINCONSENSUS_TPU_SERVE_SLO_S set low (sheds must
    arrive as `OverloadError(ERR_OVERLOADED)`), and one with dispatch faults
    armed (each admitted request a verdict or an explicit `DispatchFailed`,
    0 wrong ACCEPTs, the server serving after it)."""
    import random
    import threading

    from bitcoinconsensus_tpu_torch.api import Error
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.resilience import faults as F
    from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchFailed
    from bitcoinconsensus_tpu_torch.serving import OverloadError, VerifyServer, verify_with_retry

    want = _verdicts(results)
    # On the CPU a batch takes seconds: an SLO above that keeps the
    # rehearsal's admission from shedding what the card would admit.
    slo = 600.0 if rehearse else None

    def server(v, **kw):
        return VerifyServer(verifier=v, sig_cache=SigCache(),
                            script_cache=ScriptExecutionCache(), **kw)

    def clients(srv, idx, n_threads, retry=True):
        """Each thread submits its share of `idx`; returns {i: result or
        exception} and each request's settle seconds."""
        out, settle, lock = {}, [], threading.Lock()

        def run(k):
            rng = random.Random(k)
            pend = []
            for i in idx[k::n_threads]:
                tenant = f"tenant{k % SERVE_TENANTS}"
                t0 = time.perf_counter()
                try:
                    p = srv.submit(items[i], tenant=tenant)
                except OverloadError as e:
                    if not retry:
                        with lock:
                            out[i] = e
                        continue
                    try:
                        res = verify_with_retry(srv, items[i], tenant=tenant, retries=8,
                                                max_backoff_s=0.5, timeout_s=300, rng=rng)
                    except Exception as e2:  # noqa: BLE001 (an explicit outcome)
                        res = e2
                    with lock:
                        out[i] = res
                        settle.append(time.perf_counter() - t0)
                    continue
                p.add_done_callback(lambda _p, t0=t0: settle.append(time.perf_counter() - t0))
                pend.append((i, p))
            for i, p in pend:
                try:
                    res = p.result(timeout=300)
                except Exception as e:  # noqa: BLE001 (an explicit outcome)
                    res = e
                with lock:
                    out[i] = res

        threads = [threading.Thread(target=run, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        return out, settle

    # -- the main run --------------------------------------------------------------
    v = TorchSecpVerifier(device=device)
    idx = list(range(len(items)))
    adm0 = _metric_by("consensus_serving_admitted_total", "tenant")
    shed0 = _metric_by("consensus_serving_shed_total", "reason")
    b0 = sum(v for _, v in _metric_samples("consensus_serving_batches_total"))
    fill0 = _hist_sum_count("consensus_serving_batch_fill")
    srv = server(v, slo_deadline_s=slo).start()

    def main_run():
        t0 = time.perf_counter()
        got = clients(srv, idx, SERVE_CLIENTS)
        srv.close(drain=True)
        return got, time.perf_counter() - t0

    (out, settle), dt = launches_around("serve", main_run)
    launched = _launch_counts()
    missing = [i for i in idx if i not in out]
    errors = [i for i in idx if isinstance(out.get(i), BaseException)]
    differing = sum(_verdicts([out[i]])[0] != want[i] for i in idx
                    if i in out and not isinstance(out[i], BaseException))
    shed = _delta(_metric_by("consensus_serving_shed_total", "reason"), shed0)
    admitted = sum(_delta(_metric_by("consensus_serving_admitted_total", "tenant"),
                          adm0).values())
    batches = sum(v for _, v in _metric_samples("consensus_serving_batches_total")) - b0
    p50, p99 = _quantiles(settle)
    fill1 = _hist_sum_count("consensus_serving_batch_fill")
    fill_snap = (fill1[0] - fill0[0], fill1[1] - fill0[1])
    _line("serve", run="main", inputs=len(items), clients=SERVE_CLIENTS,
          tenants=SERVE_TENANTS, max_batch=srv.max_batch, flush_s=srv.flush_s,
          admitted=admitted, shed=json.dumps(shed), batches=int(batches),
          mean_batch_fill=f"{fill_snap[0] / max(fill_snap[1], 1):.4f}",
          settle_p50_s=p50, settle_p99_s=p99, seconds=f"{dt:.4f}",
          inputs_per_s=f"{len(items) / dt:.1f}", differing=differing,
          errors=len(errors), unsettled=len(missing), pending_after_close=srv.pending,
          verify_tiles_launches=launched[0], checksum_launches=launched[1])
    if missing or errors or differing or srv.pending:
        _fail(f"[serve] main run: {len(missing)} unsettled, {len(errors)} failed, "
              f"{differing} verdicts differ from [main_path], {srv.pending} pending")

    # The same run again with a span sink attached: each span name's summed
    # seconds (a span's own and its children's) and count, to see where a
    # served batch's time goes. Not a timing of the main run.
    from bitcoinconsensus_tpu_torch.obs import add_sink, remove_sink

    sink = _ListSink()
    srv_t = server(TorchSecpVerifier(device=device), slo_deadline_s=slo).start()
    add_sink(sink)
    try:
        t0 = time.perf_counter()
        out_t, _ = clients(srv_t, idx, SERVE_CLIENTS)
        srv_t.close(drain=True)
        dt_t = time.perf_counter() - t0
    finally:
        remove_sink(sink)
    totals, n_spans = {}, {}
    for r in sink.records:
        totals[r["name"]] = totals.get(r["name"], 0.0) + r["dur_s"]
        n_spans[r["name"]] = n_spans.get(r["name"], 0) + 1
    top = sorted(totals, key=lambda k: -totals[k])[:12]
    differing_t = sum(isinstance(out_t.get(i), BaseException) or i not in out_t
                      or _verdicts([out_t[i]])[0] != want[i] for i in idx)
    _line("serve", run="traced", inputs=len(items), seconds=f"{dt_t:.4f}",
          inputs_per_s=f"{len(items) / dt_t:.1f}", differing=differing_t,
          span_total_ms=json.dumps({k: round(totals[k] * 1e3, 1) for k in top}),
          span_counts=json.dumps({k: n_spans[k] for k in top}))
    if differing_t:
        _fail("[serve] the traced run's verdicts differ from [main_path]")

    # -- forced overload -------------------------------------------------------------
    cut = idx[:min(2000, len(items))]
    os.environ["BITCOINCONSENSUS_TPU_SERVE_SLO_S"] = "0.0001"
    try:
        srv2 = server(TorchSecpVerifier(device=device)).start()
    finally:
        os.environ.pop("BITCOINCONSENSUS_TPU_SERVE_SLO_S", None)
    shed0 = _metric_by("consensus_serving_shed_total", "reason")
    wave = cut[:len(cut) // 4]
    first, _ = clients(srv2, wave, 1, retry=False)  # evidence for the estimate
    out2, _ = clients(srv2, cut[len(wave):], 4, retry=False)
    srv2.close(drain=True)
    out2.update(first)
    sheds = [e for e in out2.values() if isinstance(e, OverloadError)]
    other = [e for e in out2.values()
             if isinstance(e, BaseException) and not isinstance(e, OverloadError)]
    wrong_code = sum(int(e.code) != int(Error.ERR_OVERLOADED) for e in sheds)
    differing2 = sum(_verdicts([r])[0] != want[i] for i, r in out2.items()
                     if not isinstance(r, BaseException))
    shed2 = _delta(_metric_by("consensus_serving_shed_total", "reason"), shed0)
    _line("serve", run="overload", slo_s=srv2.admission.slo_deadline_s, inputs=len(cut),
          admitted=len(cut) - len(sheds), shed=json.dumps(shed2), explicit=len(sheds),
          wrong_code=wrong_code, other_errors=len(other), differing=differing2,
          unsettled=len(cut) - len(out2), pending_after_close=srv2.pending)
    if not sheds or wrong_code or other or differing2 or len(out2) != len(cut) \
            or srv2.pending:
        _fail("[serve] forced overload: sheds must be explicit OverloadError"
              "(ERR_OVERLOADED) and every admitted verdict equal")

    # -- dispatch faults ---------------------------------------------------------------
    v3 = TorchSecpVerifier(device=device)
    srv3 = server(v3, slo_deadline_s=slo).start()
    plan = F.FaultPlan([F.FaultSpec("torch_backend.dispatch", "raise", count=4),
                        F.FaultSpec("torch_backend.verdict", "flip", count=1)])
    half = len(cut) // 2
    with F.inject(plan, seed=14) as inj:
        # The first wave's dispatch fails all its attempts (DispatchFailed);
        # the second wave's first settle is flipped and retried clean.
        out3, _ = clients(srv3, cut[:half], 4)
        more, _ = clients(srv3, cut[half:], 4)
        out3.update(more)
    failed = [i for i, r in out3.items() if isinstance(r, DispatchFailed)]
    other = [r for r in out3.values()
             if isinstance(r, BaseException) and not isinstance(r, DispatchFailed)]
    verdicts3 = {i: _verdicts([r])[0] for i, r in out3.items()
                 if not isinstance(r, BaseException)}
    wrong_accepts = sum(vv[0] and not want[i][0] for i, vv in verdicts3.items())
    differing3 = sum(vv != want[i] for i, vv in verdicts3.items())
    after, _ = clients(srv3, cut[:256], 2)  # the same server, the faults disarmed
    srv3.close(drain=True)
    differing_after = sum(isinstance(r, BaseException) or _verdicts([r])[0] != want[i]
                          for i, r in after.items())
    held = (not other and not wrong_accepts and not differing3 and len(out3) == len(cut)
            and len(failed) > 0 and len(verdicts3) > 0 and not differing_after
            and len(after) == len(cut[:256]) and not srv3.pending
            and inj.fired == {("torch_backend.dispatch", "raise"): 4,
                              ("torch_backend.verdict", "flip"): 1})
    _line("serve", run="faults", inputs=len(cut), fired=json.dumps(
              {f"{s}:{k}": n for (s, k), n in inj.fired.items()}),
          verdicts=len(verdicts3), dispatch_failed=len(failed), other_errors=len(other),
          wrong_accepts=wrong_accepts, differing=differing3,
          served_after=len(after), differing_after=differing_after,
          retries=int(v3.stats["retries"]), held=held)
    if not held:
        _fail("[serve] dispatch faults: the restated gate did not hold")


def _ingress_phase(items, results, device, launches_around, rehearse) -> None:
    """`[ingress]`: 2,000 inputs through `IngressServer` over a
    `VerifyServer` on the device, 4 sessions pipelining their rids; then, on
    the same server, hostile sockets (a garbage frame, an oversized frame, a
    slow-loris reaped by the idle deadline, a mid-frame disconnect) beside 4
    well-behaved `IngressClient`s; then `ingress.read` / `ingress.write`
    faults recovered by the retrying client."""
    import random
    import socket
    import threading

    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.resilience import faults as F
    from bitcoinconsensus_tpu_torch.serving import (IngressClient, IngressServer,
                                                    VerifyServer, verify_with_retry)
    from bitcoinconsensus_tpu_torch.serving import ingress as ING

    want = _verdicts(results)
    cut = list(range(min(2000, len(items))))
    slo = 600.0 if rehearse else None
    srv = VerifyServer(verifier=TorchSecpVerifier(device=device), sig_cache=SigCache(),
                       script_cache=ScriptExecutionCache(), slo_deadline_s=slo).start()
    try:
        with IngressServer(srv, idle_s=20.0 if rehearse else 3.0,
                           max_frame=1 << 16) as ing:
            sessions = [[(1 + i, f"tenant{k}", items[i]) for i in cut[k::4]]
                        for k in range(4)]

            def clean():
                t0 = time.perf_counter()
                got = _pipelined(ing.port, sessions)
                return got, time.perf_counter() - t0

            (got, errs), dt = launches_around("ingress", clean)
            launched = _launch_counts()
            differing = sum(not hasattr(got.get(1 + i), "ok")
                            or _verdicts([got[1 + i]])[0] != want[i] for i in cut)
            _line("ingress", run="clean", inputs=len(cut), sessions=4,
                  seconds=f"{dt:.4f}", inputs_per_s=f"{len(cut) / dt:.1f}",
                  differing=differing, reader_errors=len(errs),
                  verify_tiles_launches=launched[0], checksum_launches=launched[1])
            if differing or errs:
                _fail("[ingress] clean run: verdicts differ from [main_path]")

            # Hostile sockets beside well-behaved clients, on the same server.
            e0 = ING._I_PROTO_ERRS.value()
            r0 = ING._I_REAPS.value()
            good_out, lock = {}, threading.Lock()

            def good_client(k):
                with IngressClient(port=ing.port, timeout_s=300) as cli:
                    for i in cut[k:200:4]:
                        r = cli.verify(items[i], tenant=f"good{k}")
                        with lock:
                            good_out[i] = r

            def exchange(frame):
                with socket.create_connection(("127.0.0.1", ing.port), timeout=60) as s:
                    s.sendall(frame)
                    buf = b""
                    while len(buf) < ING.HEADER_LEN:
                        buf += s.recv(ING.HEADER_LEN - len(buf))
                    ftype, ln = ING.decode_header(buf)
                    payload = b""
                    while len(payload) < ln:
                        payload += s.recv(ln - len(payload))
                    closed = s.recv(1) == b""
                    return ftype, ING.decode_error_payload(payload)[1], closed

            threads = [threading.Thread(target=good_client, args=(k,)) for k in range(4)]
            for t in threads:
                t.start()
            garbage = exchange(ING.encode_frame(0x7F, b"junk"))
            oversized = exchange(bytes([ING.FRAME_REQ]) + (1 << 20).to_bytes(4, "big"))
            with socket.create_connection(("127.0.0.1", ing.port), timeout=60) as s:
                s.sendall(bytes([ING.FRAME_REQ]) + (64).to_bytes(4, "big") + b"half")
            t_loris = time.perf_counter()
            with socket.create_connection(("127.0.0.1", ing.port), timeout=120) as s:
                s.sendall(bytes([ING.FRAME_REQ]) + (100).to_bytes(4, "big") + b"ab")
                reaped = s.recv(1) == b""
            loris_s = time.perf_counter() - t_loris
            for t in threads:
                t.join(300)
            good_diff = sum(_verdicts([r])[0] != want[i] for i, r in good_out.items())
            deadline = time.perf_counter() + 10
            while ING._I_PROTO_ERRS.value() < e0 + 3 and time.perf_counter() < deadline:
                time.sleep(0.01)
            proto = ING._I_PROTO_ERRS.value() - e0
            held = (garbage == (ING.FRAME_ERR, ING.ERR_PROTO_BAD_TYPE, True)
                    and oversized == (ING.FRAME_ERR, ING.ERR_PROTO_OVERSIZED, True)
                    and reaped and ING._I_REAPS.value() - r0 >= 1 and proto == 3
                    and len(good_out) == len(cut[:200]) and not good_diff)
            _line("ingress", run="hostile", garbage=garbage[1], oversized=oversized[1],
                  mid_frame_disconnect=1, slow_loris_reaped=reaped,
                  slow_loris_s=f"{loris_s:.3f}", idle_s=ing.idle_s,
                  protocol_errors=proto, reaps=ING._I_REAPS.value() - r0,
                  good_clients=4, good_verdicts=len(good_out), good_differing=good_diff,
                  held=held)
            if not held:
                _fail("[ingress] hostile sockets were not contained to their sessions")

            # Injected faults, recovered by the retrying client.
            plan = F.FaultPlan([F.FaultSpec("ingress.read", "raise", count=2),
                                F.FaultSpec("ingress.write", "raise", count=2)])
            fault_out = {}
            with F.inject(plan, seed=5) as inj:
                with IngressClient(port=ing.port, timeout_s=300) as cli:
                    rng = random.Random(5)
                    for i in cut[:32]:
                        fault_out[i] = verify_with_retry(cli, items[i], tenant="faulty",
                                                         retries=6, rng=rng)
            fdiff = sum(_verdicts([r])[0] != want[i] for i, r in fault_out.items())
            fired = {f"{s}:{k}": n for (s, k), n in inj.fired.items()}
            _line("ingress", run="faults", inputs=len(fault_out), fired=json.dumps(fired),
                  differing=fdiff, held=not fdiff and sum(fired.values()) == 4)
            if fdiff or sum(fired.values()) != 4:
                _fail("[ingress] injected read/write faults were not recovered")
    finally:
        srv.close(drain=True)


def _sigstore_phase(items, corrupted, results, device, launches_around, rehearse,
                    out_dir) -> None:
    """`[sigstore]`: the main path's inputs through `verify_batch` with a
    `PersistentSigCache` (cold), then reopened (warm: hits and dispatched
    lanes); a poisoned persisted entry caught by the audit and kept out
    across a reopen; a torn tail healed as misses."""
    import shutil
    import tempfile

    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache
    from bitcoinconsensus_tpu_torch.models.sigstore import _OP_DEL, _REC_LEN, PersistentSigCache
    from bitcoinconsensus_tpu_torch.resilience import guards as G

    want = _verdicts(results)
    root = tempfile.mkdtemp(prefix="sigstore-", dir=out_dir)
    try:
        d = os.path.join(root, "store")
        ap0 = sum(v for _, v in _metric_samples("consensus_sigstore_appends_total"))
        store = PersistentSigCache(d)
        v = TorchSecpVerifier(device=device)

        def cold_run():
            t0 = time.perf_counter()
            res = verify_batch(items, verifier=v, sig_cache=store,
                               script_cache=ScriptExecutionCache())
            return res, time.perf_counter() - t0

        cold, cold_s = launches_around("sigstore_cold", cold_run)
        cold_launches = _launch_counts()[0]
        entries = len(store)
        store.close()
        appends = sum(v for _, v in _metric_samples("consensus_sigstore_appends_total")) - ap0
        t0 = time.perf_counter()
        store2 = PersistentSigCache(d)
        open_s = time.perf_counter() - t0
        v2 = TorchSecpVerifier(device=device)

        def warm_run():
            t0 = time.perf_counter()
            res = verify_batch(items, verifier=v2, sig_cache=store2,
                               script_cache=ScriptExecutionCache())
            return res, time.perf_counter() - t0

        warm, warm_s = launches_around("sigstore_warm", warm_run)  # the misses
        warm_launches = _launch_counts()[0]
        # Only successes are cached, so a miss is a check whose verdict is
        # false: a corrupted input's, or a 2-of-3's speculative pairing of a
        # signature with a key it does not sign for. The gate reads the
        # persisted entries' hits; the probes' hit rate is reported beside.
        probes = store2.hits + store2.misses
        hit_rate = store2.hits / max(probes, 1)
        entry_rate = store2.hits / max(entries, 1)
        d_cold = sum(a != b for a, b in zip(_verdicts(cold), want))
        d_warm = sum(a != b for a, b in zip(_verdicts(warm), want))
        redispatched = int(v2.stats["lanes"]) - store2.misses
        _line("sigstore", run="cold_warm", inputs=len(items), checks=int(v.stats["lanes"]),
              entries=entries, appends=int(appends), replay_records=store2.replay_applied,
              replay_skipped=store2.replay_skipped, open_s=f"{open_s:.4f}",
              warmup_s=("none" if store2.warmup_s is None else f"{store2.warmup_s:.4f}"),
              cold_s=f"{cold_s:.4f}", warm_s=f"{warm_s:.4f}",
              warm_hits=store2.hits, warm_misses=store2.misses,
              hit_rate=f"{hit_rate:.4f}", entries_hit_rate=f"{entry_rate:.4f}",
              warm_lanes=int(v2.stats["lanes"]),
              persisted_entries_redispatched=redispatched,
              cold_launches=cold_launches, warm_launches=warm_launches,
              differing_cold=d_cold, differing_warm=d_warm)
        store2.close()
        if d_cold or d_warm or entry_rate < 0.9 or redispatched:
            _fail("[sigstore] the warm rerun missed its gate (>= 90% of the persisted "
                  "entries hit, none dispatched again, verdicts equal)")

        # Torn tail: half a record cut from one shard of a copy of the store
        # as the clean runs left it: the lost record costs a miss.
        dt_ = os.path.join(root, "torn")
        shutil.copytree(d, dt_)
        logs = sorted(f for f in os.listdir(dt_) if f.endswith(".log"))
        path = os.path.join(dt_, logs[0])
        os.truncate(path, os.path.getsize(path) - _REC_LEN // 2)
        s6 = PersistentSigCache(dt_)
        skipped = s6.replay_skipped
        torn = verify_batch(items, verifier=TorchSecpVerifier(device=device), sig_cache=s6,
                            script_cache=ScriptExecutionCache())
        tdiff = sum(a != b for a, b in zip(_verdicts(torn), want))
        _line("sigstore", run="torn_tail", shard=logs[0], replay_skipped=skipped,
              misses=s6.misses, hits=s6.hits, differing=tdiff,
              held=skipped == 1 and not tdiff and s6.misses >= 1)
        s6.close()
        if skipped != 1 or tdiff:
            _fail("[sigstore] a torn tail gave a wrong verdict or was not healed")

        # Poison: the keys of a corrupted input's false checks, planted.
        bad_idx = [i for i, b in enumerate(corrupted) if b][:4]
        target = [items[i] for i in bad_idx]
        os.environ["BITCOINCONSENSUS_TPU_IDX"] = "0"
        try:
            rec = TorchSecpVerifier(device=device)
            sent = []
            run = rec.verify_checks

            def recording(checks):
                res = run(checks)
                sent.extend(zip(checks, res))
                return res

            rec.verify_checks = recording
            s3 = PersistentSigCache(d)
            verify_batch(target, verifier=rec, sig_cache=s3,
                         script_cache=ScriptExecutionCache())
            poison = s3.keys_for_checks([c for c, r in sent if not r])
            s3.add_keys(poison)
            s3.close()
        finally:
            os.environ.pop("BITCOINCONSENSUS_TPU_IDX", None)
        s4 = PersistentSigCache(d)
        planted = sum(s4.peek_key(k) for k in poison)
        v4 = TorchSecpVerifier(device=device)
        G.set_cache_audit(True)
        try:
            got = verify_batch(target, verifier=v4, sig_cache=s4,
                               script_cache=ScriptExecutionCache())
        finally:
            G.set_cache_audit(False)
        caught = int(v4.stats["cache_poison_caught"])
        gone_now = not any(s4.peek_key(k) for k in poison)
        s4.close()
        s5 = PersistentSigCache(d)
        gone_after = not any(s5.peek_key(k) for k in poison)
        s5.close()
        pdiff = sum(a != want[i] for a, i in zip(_verdicts(got), bad_idx))
        held = planted == len(poison) > 0 and caught >= 1 and gone_now and gone_after \
            and not pdiff
        _line("sigstore", run="poison", inputs=len(target), planted=planted,
              cache_poison_caught=caught, differing=pdiff, evicted=gone_now,
              evicted_after_reopen=gone_after, held=held)
        if not held:
            _fail("[sigstore] the poisoned persisted entry was not caught and kept out")

        # A torn tombstone: the audit's DEL records are the last of their
        # shards; cut each in half and the poisoned entries come back on
        # replay. Only the audit stands between them and a wrong ACCEPT, so
        # the rerun runs with it armed and must catch them again.
        torn_dels = 0
        for f in sorted(os.listdir(d)):
            if not f.endswith(".log"):
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                fh.seek(max(0, os.path.getsize(p) - _REC_LEN))
                last = fh.read(_REC_LEN)
            if len(last) == _REC_LEN and last[:1] == _OP_DEL and last[1:33] in poison:
                os.truncate(p, os.path.getsize(p) - _REC_LEN // 2)
                torn_dels += 1
        s7 = PersistentSigCache(d)
        back = sum(s7.peek_key(k) for k in poison)
        v7 = TorchSecpVerifier(device=device)
        G.set_cache_audit(True)
        try:
            got7 = verify_batch(target, verifier=v7, sig_cache=s7,
                                script_cache=ScriptExecutionCache())
        finally:
            G.set_cache_audit(False)
        s7.close()
        caught7 = int(v7.stats["cache_poison_caught"])
        d7 = sum(a != want[i] for a, i in zip(_verdicts(got7), bad_idx))
        held7 = not d7 and caught7 >= back
        _line("sigstore", run="torn_tombstone", torn_dels=torn_dels, resurrected=back,
              caught_with_audit=caught7, differing=d7, held=held7)
        if not held7:
            _fail("[sigstore] a resurrected poisoned entry was not caught by the audit")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _is_p2wsh(item) -> bool:
    spk = (item.spent_outputs[item.input_index][1] if item.spent_outputs is not None
           else item.spent_output_script)
    return len(spk) == 34 and spk[:2] == b"\x00\x20"


def _smi(query: str) -> str:
    proc = subprocess.run(["nvidia-smi", query, "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip()


def _cell_phase(items, results, device, rehearse, out_dir) -> dict:
    """`[cell]`: `ServingCell(n_replicas=2)` with replica subprocesses on the
    device (each its own CUDA context on cuda:0, started together); 2,000
    inputs from 4 tenants through the router; one replica killed with
    SIGKILL under 2,000 more (every admitted request a verdict, after the
    router's exactly-once retry or an explicit ERR_OVERLOADED retried by the
    client), its eviction with a flight dump, the shard handoff (the
    survivor warm on the moved tenants' earlier inputs, a tombstone kept),
    `cell.route` faults, `no_replica` sheds with both replicas down, and
    re-promotion of both through passing known-answer probes."""
    import glob
    import random
    import shutil
    import tempfile

    from bitcoinconsensus_tpu_torch.cell import ServingCell
    from bitcoinconsensus_tpu_torch.models.sigstore import _OP_ADD, _OP_DEL, ShardLog
    from bitcoinconsensus_tpu_torch.obs import flight
    from bitcoinconsensus_tpu_torch.resilience import faults as F
    from bitcoinconsensus_tpu_torch.serving import IngressClient, OverloadError
    from bitcoinconsensus_tpu_torch.serving import verify_with_retry

    want = _verdicts(results)
    half = min(2000, len(items) // 2)
    load_idx, kill_idx = list(range(half)), list(range(half, 2 * half))
    tenants = [f"cell-t{k}" for k in range(4)]
    root = tempfile.mkdtemp(prefix="cell-", dir=out_dir)
    flight_dir = os.path.join(root, "flight")
    os.environ["BITCOINCONSENSUS_TPU_FLIGHT_DIR"] = flight_dir
    flight.set_enabled(True)
    counts = {}
    if rehearse:  # on the CPU a batch takes seconds: a longer SLO, inherited
        os.environ["BITCOINCONSENSUS_TPU_SERVE_SLO_S"] = "600"
    t0 = time.perf_counter()
    cell = ServingCell(n_replicas=2, root_dir=os.path.join(root, "tier"),
                       device="cpu" if rehearse else None,
                       evict_after=2, backoff_s=0.05, max_backoff_s=0.5,
                       probe_timeout_s=300.0 if rehearse else 60.0)

    def total(name):
        return sum(v for _, v in _metric_samples(name))

    def sessions(idx, base):
        return [[(base + i, tenants[i % 4], items[i]) for i in idx if i % 4 == k]
                for k in range(4)]

    def settle(idx, got, base):
        """Retry every explicit ERR through a retrying client: (verdicts
        differing, rids never answered, explicit ERRs, wrong ACCEPTs)."""
        errs = [i for i in idx if not hasattr(got.get(base + i), "ok")]
        lost = [i for i in idx if base + i not in got]
        with IngressClient(port=cell.port, timeout_s=300) as cli:
            rng = random.Random(base)
            for i in errs:
                got[base + i] = verify_with_retry(cli, items[i], tenant=tenants[i % 4],
                                                  retries=8, max_backoff_s=0.5, rng=rng)
        vs = {i: _verdicts([got[base + i]])[0] for i in idx}
        return (sum(vs[i] != want[i] for i in idx), lost, errs,
                sum(vs[i][0] and not want[i][0] for i in idx))

    mem0 = "cpu" if rehearse else _smi("--query-gpu=memory.used")
    try:
        cell.start()
        start_s = time.perf_counter() - t0
        pids = {n: r.pid for n, r in cell.replicas.items()}
        # nvidia-smi lists the card's compute processes by the pids of its
        # own PID namespace, which a container may hide; each replica
        # also reports its pid and whether it initialised CUDA.
        apps = "cpu" if rehearse else _smi("--query-compute-apps=pid,used_memory")
        mem1 = "cpu" if rehearse else _smi("--query-gpu=memory.used")
        own = {n: r.control({"cmd": "stats"}) for n, r in cell.replicas.items()}
        contexts = sum(own[n]["cuda_initialized"] and own[n]["pid"] == pids[n]
                       for n in own)
        _line("cell", run="start", replicas=len(pids), pids=json.dumps(pids),
              start_s=json.dumps({n: round(r.start_s, 3) for n, r in cell.replicas.items()}),
              cell_start_s=f"{start_s:.3f}", compute_apps=json.dumps(apps),
              memory_used_before=json.dumps(mem0), memory_used_after=json.dumps(mem1),
              replica_cuda_contexts=contexts)
        if not rehearse and contexts != 2:
            _fail("[cell] the two replica subprocesses do not each hold a context on the card")

        t1 = time.perf_counter()
        got, _errs = _pipelined(cell.port, sessions(load_idx, 10_000))
        load_s = time.perf_counter() - t1
        diff, lost, errs, wa = settle(load_idx, got, 10_000)
        stats = {n: cell.replicas[n].control({"cmd": "stats"}) for n in cell.replicas}
        counts["cell_replicas"] = (sum(s["verify_tiles_launches"] for s in stats.values()),
                                   sum(s["checksum_launches"] for s in stats.values()))
        _line("cell", run="load", inputs=len(load_idx), tenants=4,
              seconds=f"{load_s:.4f}", inputs_per_s=f"{len(load_idx) / load_s:.1f}",
              differing=diff, explicit_errors=len(errs), unanswered=len(lost),
              wrong_accepts=wa, replica_launches=json.dumps(
                  {n: [s["verify_tiles_launches"], s["checksum_launches"]]
                   for n, s in stats.items()}))
        if diff or wa or lost or (not rehearse and not all(
                s["verify_tiles_launches"] for s in stats.values())):
            _fail("[cell] load: verdicts differ from [main_path], or a replica "
                  "launched no verify kernel")

        # A tombstone in the victim's log (ADD then DEL of a planted key) that
        # the handoff must carry over in order.
        victim = cell.router._home.lookup(tenants[0])
        survivor = next(n for n in cell.replicas if n != victim)
        moved = [t for t in tenants if cell.router._home.lookup(t) == victim]
        tomb = b"\x5a" * 32
        log = ShardLog(os.path.join(cell.tier.store_dir(victim),
                                    "shard-%02d.log" % (tomb[0] % cell.shards)))
        log.append(_OP_ADD, tomb)
        log.append(_OP_DEL, tomb)
        log.close()
        ev0, rt0 = total("consensus_cell_evictions_total"), \
            total("consensus_cell_retried_frames_total")
        flight.reset()

        def kill_victim():
            cell.replicas[victim].kill()  # SIGKILL, with the frames in flight

        got2, _errs2 = _pipelined(cell.port, sessions(kill_idx, 20_000),
                                  on_sent=kill_victim)
        ticks = 0
        while victim in cell.healthy_names() and ticks < 10:
            cell.tick()
            ticks += 1
        dumps = glob.glob(os.path.join(flight_dir, "flight_dump_cell_eviction_*.json"))
        diff2, lost2, errs2, wa2 = settle(kill_idx, got2, 20_000)
        retried = total("consensus_cell_retried_frames_total") - rt0
        evicted = total("consensus_cell_evictions_total") - ev0
        # The moved tenants' load-run inputs, which only the victim had seen,
        # now on the survivor: warm through the handed-off shards. Single-key
        # inputs only: a 2-of-3 also probes its false speculative pairings,
        # which are never cached and so miss on any store.
        s0 = cell.replicas[survivor].control({"cmd": "stats"})
        moved_idx = [i for i in load_idx if tenants[i % 4] in moved
                     and not _is_p2wsh(items[i])]
        got3, _ = _pipelined(cell.port, [[(30_000 + i, tenants[i % 4], items[i])
                                           for i in moved_idx]])
        s1 = cell.replicas[survivor].control({"cmd": "stats"})
        probes, hits = s1["probes"] - s0["probes"], s1["hits"] - s0["hits"]
        warm = hits / max(probes, 1)
        tomb_present = cell.replicas[survivor].control(
            {"cmd": "peek", "key": tomb.hex()})["present"]
        mdiff = sum(not hasattr(got3.get(30_000 + i), "ok")
                    or _verdicts([got3[30_000 + i]])[0] != want[i] for i in moved_idx)
        held = (not diff2 and not wa2 and not lost2
                and ticks <= cell.supervisor.evict_after
                and victim not in cell.healthy_names() and len(dumps) >= 1
                and probes > 0 and warm >= 0.9 and not tomb_present and not mdiff
                and evicted == 1)
        _line("cell", run="kill", victim=victim, moved_tenants=len(moved),
              inputs=len(kill_idx), explicit_errors=len(errs2), unanswered=len(lost2),
              retried_exactly_once=int(retried), lost_admitted_verdicts=diff2,
              wrong_accepts=wa2, evict_ticks=ticks,
              evict_after=cell.supervisor.evict_after, flight_dumps=len(dumps),
              moved_inputs=len(moved_idx), survivor_probes=probes, survivor_hits=hits,
              survivor_warm=f"{warm:.4f}", tombstone_kept=not tomb_present,
              moved_differing=mdiff, held=held)
        if not held:
            _fail("[cell] the kill -9 case did not hold")

        # cell.route faults: each tears one client session down; the retrying
        # client reconnects.
        with F.inject(F.FaultPlan([F.FaultSpec("cell.route", "raise", count=2)]),
                      seed=7) as inj:
            with IngressClient(port=cell.port, timeout_s=300) as cli:
                rng = random.Random(7)
                route_out = {i: verify_with_retry(cli, items[i], tenant=tenants[i % 4],
                                                  retries=6, rng=rng)
                             for i in load_idx[:32]}
        rdiff = sum(_verdicts([r])[0] != want[i] for i, r in route_out.items())
        fired = inj.fired.get(("cell.route", "raise"), 0)
        _line("cell", run="route_faults", inputs=len(route_out), fired=fired,
              differing=rdiff, held=fired == 2 and not rdiff)
        if fired != 2 or rdiff:
            _fail("[cell] cell.route faults were not recovered")

        # Both down: the victim held out of its restart, the survivor killed
        # too; the router answers `no_replica`, explicitly.
        sup = cell.supervisor
        sup._state[victim].next_retry_at = float("inf")
        cell.replicas[survivor].kill()
        ticks2 = 0
        while cell.healthy_names() and ticks2 < 10:
            cell.tick()
            ticks2 += 1
        with IngressClient(port=cell.port, timeout_s=60) as cli:
            try:
                cli.verify(items[0], tenant=tenants[0])
                no_replica = "answered"
            except OverloadError as e:
                no_replica = f"{e.reason}:{int(e.code)}"
        # Re-promotion of both, each only through a passing known-answer probe.
        flight.reset()
        rp0 = total("consensus_cell_repromotions_total")
        for name in cell.replicas:
            sup._state[name].next_retry_at = 0.0
        t2 = time.perf_counter()
        deadline = t2 + (900 if rehearse else 240)
        while len(cell.healthy_names()) < 2 and time.perf_counter() < deadline:
            time.sleep(0.05)
            cell.tick()
        repromote_s = time.perf_counter() - t2
        events = flight.events()
        proven = []
        for j, ev in enumerate(events):
            if ev["kind"] == "cell.promote":
                proven.append(any(
                    e["kind"] == "cell.probe" and e.get("replica") == ev["replica"]
                    and e.get("phase") == "repromote" and e.get("ok")
                    for e in events[:j]))
        repromoted = total("consensus_cell_repromotions_total") - rp0
        with IngressClient(port=cell.port, timeout_s=300) as cli:
            after = {i: cli.verify(items[i], tenant=tenants[i % 4]) for i in load_idx[:32]}
        adiff = sum(_verdicts([r])[0] != want[i] for i, r in after.items())
        held = (no_replica == "no_replica:7" and len(cell.healthy_names()) == 2
                and repromoted == 2 and len(proven) == 2 and all(proven) and not adiff)
        _line("cell", run="repromote", no_replica=no_replica, repromoted=int(repromoted),
              through_passing_probe=json.dumps(proven), repromote_s=f"{repromote_s:.3f}",
              restart_s=json.dumps({n: round(r.start_s, 3)
                                    for n, r in cell.replicas.items()}),
              healthy=json.dumps(sorted(cell.healthy_names())), differing_after=adiff,
              held=held)
        if not held:
            _fail("[cell] no_replica sheds or re-promotion did not hold")
    finally:
        cell.close()
        flight.set_enabled(False)
        os.environ.pop("BITCOINCONSENSUS_TPU_FLIGHT_DIR", None)
        if rehearse:
            os.environ.pop("BITCOINCONSENSUS_TPU_SERVE_SLO_S", None)
        shutil.rmtree(root, ignore_errors=True)
    return counts


# The gauntlet's replay leg at config 5's block width (about 3,200 inputs a
# block batch, half of them again as mempool batches), and its serving legs
# at the reference's CI size.
GAUNTLET_REPLAY = dict(seed=0, n_blocks=4, txs_per_block=400, max_inputs=15)
GAUNTLET_SMALL = dict(seed=1, n_blocks=2, txs_per_block=3)
GAUNTLET_FUZZ = 500
# The shapes whose packed lanes `[gauntlet] leg=corpus_lanes` holds the
# kernel to its plain version on: the GLV/recoder pins, the 20-key fan-out
# and the taproot script path.
GAUNTLET_LANE_SHAPES = ("scalar_edge", "multisig_fanout", "taproot_annex")


def _hist_by(name, label):
    """{label value: (sum, count)} of one labelled histogram."""
    from bitcoinconsensus_tpu_torch.obs import get_registry

    m = get_registry().snapshot().get(name) or {"samples": []}
    return {s["labels"].get(label, ""): (s.get("sum", 0.0), s.get("count", 0))
            for s in m["samples"]}


def _gauntlet_phase(device, sync, launches_around, path_launches, checksum_launches,
                    rehearse) -> None:
    """`[gauntlet]` and `[gauntlet_chaos]`: the port's `workloads/` on one
    verifier on the device, each leg's launches counted around it alone.
    - leg=corpus: the 26 pinned cases through the Python engine, the native
      core and `verify_batch` (0 mismatches, the native core present);
    - leg=corpus_lanes: the scalar-edge, fan-out and taproot cases' checks
      (the wire driver's, recorded), packed by `prep_pack`, through
      `verify_tiles` and `verify_tiles_reference` on the device: equal lane
      for lane, and every lane the kernel decides equal to the host oracle;
    - leg=fuzz: 500 mutants over the five CI seeds, three engines, 0
      divergences;
    - leg=replay: `run_replay` at config 5's block width, bit-identical to
      the Python oracle and cache-warmed;
    - leg=serve, ingress, overload, cell: the reference's CI-size stream
      through a `VerifyServer`, the socket ingress, an overloaded server
      (sheds must happen) and a two-stub `ServingCell` on the device, all
      accounted, sheds explicit only;
    - `[gauntlet_chaos]`: the ten trials of the CLI's `--chaos`, each held
      with 0 wrong ACCEPTs."""
    from bitcoinconsensus_tpu_torch import native_bridge
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
    from bitcoinconsensus_tpu_torch.workloads import (
        ReplayConfig,
        run_replay,
        run_replay_cell,
        run_replay_serving,
    )
    from bitcoinconsensus_tpu_torch.workloads import __main__ as cli
    from bitcoinconsensus_tpu_torch.workloads.corpus import build_corpus, run_corpus_check

    t_phase = time.perf_counter()
    v = TorchSecpVerifier(device=device)
    slo = cli.CPU_SLO_S if rehearse else None
    bad = []

    def launches(path):
        """The path's verify_tiles and verdict checksum launches."""
        return f"{path_launches[path]}/{checksum_launches[path]}"

    # -- the pinned corpus on three engines ----------------------------------
    shape0 = _hist_by("consensus_gauntlet_shape_seconds", "shape")
    t0 = time.perf_counter()
    rep = launches_around("gauntlet_corpus", lambda: run_corpus_check(verifier=v))
    shape1 = _hist_by("consensus_gauntlet_shape_seconds", "shape")
    shape_s = {k: round(shape1[k][0] - shape0.get(k, (0.0, 0))[0], 6) for k in shape1}
    _line("gauntlet", leg="corpus", cases=rep["cases"], mismatches=len(rep["mismatches"]),
          native_available=rep["native_available"], engines=3,
          launches_verify_checksum=launches("gauntlet_corpus"),
          seconds=f"{time.perf_counter() - t0:.3f}",
          shape_seconds=json.dumps(shape_s))
    if rep["cases"] != 26 or rep["mismatches"] or not rep["native_available"]:
        bad.append(f"corpus: {rep['mismatches'][:3]}, native {rep['native_available']}")

    # -- the kernel against its plain version on the corpus's own lanes -------
    corpus = [c for c in build_corpus() if c.shape in GAUNTLET_LANE_SHAPES]
    wire = TorchSecpVerifier(device=device)
    sent = []
    verify_checks = wire.verify_checks

    def recording(checks):
        sent.extend(checks)
        return verify_checks(checks)

    wire.verify_checks = recording
    os.environ["BITCOINCONSENSUS_TPU_IDX"] = "0"
    try:
        verify_batch([c.item for c in corpus], verifier=wire, sig_cache=SigCache(),
                     script_cache=ScriptExecutionCache())
    finally:
        os.environ.pop("BITCOINCONSENSUS_TPU_IDX", None)
    packed = native_bridge.prep_pack(sent, v._pad(len(sent)))
    dev = v.to_device(packed)
    ok_k, nd_k, _ = VT.verify_tiles_checked(*dev)
    ok_r, nd_r = VT.verify_tiles_reference(*dev)
    sync()
    ok_k, nd_k, ok_r, nd_r = (t.cpu() for t in (ok_k, nd_k, ok_r, nd_r))
    differing = int(((ok_k != ok_r) | (nd_k != nd_r)).sum())
    decided = [i for i in range(len(sent)) if not bool(nd_k[i])]
    host_diff = sum(bool(ok_k[i]) != v._host_check(sent[i]) for i in decided)
    _line("gauntlet", leg="corpus_lanes", shapes=",".join(GAUNTLET_LANE_SHAPES),
          cases=len(corpus), lanes=len(sent), padded=int(ok_k.numel()),
          kernel_ok=int(ok_k[:len(sent)].sum()), plain_ok=int(ok_r[:len(sent)].sum()),
          kernel_needs=int(nd_k[:len(sent)].sum()), tolerance=0,
          lanes_differing=differing, decided_vs_host_differing=host_diff)
    if differing or host_diff or not sent:
        bad.append(f"corpus_lanes: {differing} lanes differ, {host_diff} against the host")

    # -- the differential fuzz over the CI seeds -------------------------------
    n_fuzz = 10 if rehearse else GAUNTLET_FUZZ
    t0 = time.perf_counter()
    rep = launches_around("gauntlet_fuzz",
                          lambda: cli.run_fuzz_leg(v, cli.ci_fuzz_seeds(), n_fuzz, ceil=True))
    _line("gauntlet", leg="fuzz", cases=rep["cases"], seeds=len(rep["seeds"]),
          engines=rep["engines"], divergences=len(rep["divergences"]),
          mutations=json.dumps(rep["mutations"]),
          launches_verify_checksum=launches("gauntlet_fuzz"),
          seconds=f"{time.perf_counter() - t0:.3f}")
    if rep["divergences"] or rep["engines"] != 3 or rep["cases"] < n_fuzz:
        bad.append(f"fuzz: {rep['divergences'][:2]}")

    # -- the mainnet-shaped replay through the stream --------------------------
    cfg = ReplayConfig(**(dict(seed=3, n_blocks=2, txs_per_block=2, max_inputs=2)
                          if rehearse else GAUNTLET_REPLAY))
    t0 = time.perf_counter()
    rep = launches_around("gauntlet_replay", lambda: run_replay(cfg, verifier=v))
    _line("gauntlet", leg="replay", config=json.dumps({k: getattr(cfg, k) for k in (
              "seed", "n_blocks", "txs_per_block", "max_inputs")}),
          blocks=rep["blocks"], txs=rep["txs"], inputs=rep["items"],
          batches=rep["batches"], mempool_overlap=rep["mempool_overlap_items"],
          expected_warm_hits=rep["expected_warm_hits"],
          script_cache_hits=rep["script_cache_hits"], sig_cache_hits=rep["sig_cache_hits"],
          bit_identical=rep["bit_identical"], warmed=rep["warmed"],
          stream_s=f"{rep['stream_s']:.4f}",
          inputs_per_s=f"{rep['items'] / rep['stream_s']:.1f}",
          generate_s=f"{rep['generate_s']:.2f}", oracle_s=f"{rep['oracle_s']:.2f}",
          oracle_workers=rep["oracle_workers"],
          launches_verify_checksum=launches("gauntlet_replay"),
          seconds=f"{time.perf_counter() - t0:.2f}")
    if not (rep["bit_identical"] and rep["warmed"]):
        bad.append(f"replay: {rep['divergences'][:3]}, warmed {rep['warmed']}")

    # -- the serving surfaces ---------------------------------------------------
    small = ReplayConfig(**GAUNTLET_SMALL)
    legs = (
        ("serve", lambda: run_replay_serving(small, mode="serve", verifier=v,
                                             slo_deadline_s=slo)),
        ("ingress", lambda: run_replay_serving(small, mode="ingress", verifier=v,
                                               slo_deadline_s=slo)),
        ("overload", lambda: run_replay_serving(small, mode="serve", overload=True,
                                                verifier=v, slo_deadline_s=slo)),
        ("cell", lambda: run_replay_cell(small, n_replicas=2, device=str(device),
                                         slo_deadline_s=slo)),
    )
    for leg, fn in legs:
        t0 = time.perf_counter()
        rep = launches_around(f"gauntlet_{leg}", fn)
        held = rep["bit_identical"] and rep["all_accounted"] and \
            rep["sheds_explicit_only"] and (leg != "overload" or rep["sheds_happened"])
        _line("gauntlet", leg=leg, items=rep["items"], settled=rep["settled"],
              sheds=rep["sheds"], errors=len(rep["errors"]),
              hung_threads=rep["hung_threads"], bit_identical=rep["bit_identical"],
              all_accounted=rep["all_accounted"],
              sheds_explicit_only=rep["sheds_explicit_only"],
              sheds_happened=rep.get("sheds_happened", "n/a"),
              launches_verify_checksum=launches(f"gauntlet_{leg}"), held=held,
              seconds=f"{time.perf_counter() - t0:.2f}")
        if not held:
            bad.append(f"{leg}: {rep['errors'][:3]} {rep['divergences'][:3]}")

    # -- the gauntlet fault sweep ---------------------------------------------
    t0 = time.perf_counter()
    n0 = VT.verify_tiles_checked.launches
    sweep = cli.run_gauntlet_sweep(0, fuzz_cases=n_fuzz, verifier=v)
    sync()
    for t in sweep["trials"]:
        extra = {k: t[k] for k in cli.HARD_KEYS if k in t}
        _line("gauntlet_chaos", trial=t["trial"], **extra,
              fired=json.dumps(t.get("fired", {})), wrong_accepts=t["wrong_accepts"],
              held=t["held"])
        if not t["held"]:
            bad.append(f"chaos {t['trial']}")
    _line("gauntlet_chaos", trials=len(sweep["trials"]),
          held=sum(t["held"] for t in sweep["trials"]),
          wrong_accepts=sum(t["wrong_accepts"] for t in sweep["trials"]),
          launches=VT.verify_tiles_checked.launches - n0,
          seconds=f"{time.perf_counter() - t0:.2f}")
    _line("gauntlet_time", seconds=f"{time.perf_counter() - t_phase:.2f}")
    if len(sweep["trials"]) != 10:
        bad.append(f"chaos: {len(sweep['trials'])} trials, not 10")
    if bad:
        _fail("[gauntlet]: " + "; ".join(bad))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run the phases on the CPU at a small size (exits 3)")
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--out-dir", default=os.path.join(HERE, "build", "chip_smoke"),
                    help="where the xprof reports and the stats snapshot go")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not args.rehearse_cpu and not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    _import_port()
    from bitcoinconsensus_tpu_torch import api, native_bridge
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.obs import add_sink, remove_sink
    from bitcoinconsensus_tpu_torch.ops import _build
    from bitcoinconsensus_tpu_torch.ops import limbs as L
    from bitcoinconsensus_tpu_torch.ops import verdict_checksum as VC
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
    from bitcoinconsensus_tpu_torch.utils import blockgen

    rehearse = args.rehearse_cpu
    out_dir = args.out_dir
    seed = args.seed
    device = torch.device("cpu" if rehearse else "cuda:0")
    n_inputs, n_lanes = (40, 64) if rehearse else (10_000, 8192)
    if rehearse:
        torch.set_num_threads(1)
    t_start = time.perf_counter()

    # -- 1. the card ---------------------------------------------------------
    card = "cpu rehearsal" if rehearse else _nvidia_smi()
    kind = "cpu" if rehearse else torch.cuda.get_device_name(0)
    _line("card", nvidia_smi=json.dumps(card), torch=torch.__version__,
          cuda=torch.version.cuda, device=json.dumps(kind),
          count=0 if rehearse else torch.cuda.device_count())

    # -- 2. build, and the kernel prover -------------------------------------
    if not rehearse:
        from concurrent.futures import ThreadPoolExecutor

        sources = ("verify_tiles", "verdict_checksum", "sha256", "toy_kernels",
                   "shard_step", _build.HOST_CORE, _build.VT_HOST)
        with ThreadPoolExecutor(len(sources)) as pool:
            builds = list(pool.map(_build.build, sources))
        for name, built in zip(sources, builds):
            what = dict(kernel=name) if name in (
                "verify_tiles", "verdict_checksum", "sha256", "toy_kernels",
                "shard_step") else dict(name=name)
            _line("build", **what, seconds=f"{built.seconds:.2f}",
                  library=os.path.relpath(built.path, HERE))
            for ln in built.log.splitlines():
                if re.search(r"registers|spill|stack frame", ln):
                    print("  ptxas: " + ln.strip(), flush=True)
        vt_ptxas = _ptxas(builds[0].log, "vt_verify_kernel")
        _line("ptxas", kernel="vt_verify_kernel", **vt_ptxas,
              dynamic_smem=VT.VERIFY_TILES_CONTRACT.dynamic_smem_bytes(),
              build_s=f"{builds[0].seconds:.2f}")
        _line("ptxas", kernel="vt_verify_checked_kernel",
              **_ptxas(builds[0].log, "vt_verify_checked_kernel"),
              dynamic_smem=VT.VERIFY_TILES_CHECKED_CONTRACT.dynamic_smem_bytes(),
              build_s=f"{builds[0].seconds:.2f}")
        _line("ptxas", kernel="vc_checksum_kernel",
              **_ptxas(builds[1].log, "vc_checksum_kernel"),
              build_s=f"{builds[1].seconds:.2f}")
        for sym in ("sh_compress_kernel", "sh_fixed_kernel", "sh_challenge_kernel",
                    "sh_merkle_level_kernel", "sh_merkle_tree_kernel"):
            _line("ptxas", kernel=sym, **_ptxas(builds[2].log, sym),
                  build_s=f"{builds[2].seconds:.2f}")
        _line("ptxas", kernel="ss_epilogue_kernel",
              **_ptxas(builds[4].log, "ss_epilogue_kernel"),
              build_s=f"{builds[4].seconds:.2f}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # -- 3. main path ----------------------------------------------------------
    t0 = time.perf_counter()
    items, corrupted = blockgen.mixed_items(
        n_inputs, seed=args.seed, corrupt_rate=0.05 if rehearse else 0.01)
    t_gen = time.perf_counter() - t0
    _line("data", inputs=len(items), corrupted=sum(corrupted),
          seconds=f"{t_gen:.3f}")
    if not any(corrupted):
        _fail("the data holds no corrupted input")
    span_records = {}  # each driven path's span records
    path_launches = {}  # each path's checked verify launches, counted around it alone
    checksum_launches = {}  # and those of them that carried the checksum partials

    def launches_around(path, fn):
        """fn() with the verify kernels' and the standalone checksum's launch
        counts set to 0 just before it and read just after; fails if the
        path never made the checked verify launch, made one without the
        checksum partials, or launched the unchecked verify kernel or the
        standalone checksum kernel (a dispatch is one kernel)."""
        sync()
        VT.verify_tiles_checked.launches = VT.verify_tiles_checked.checksummed = 0
        VT.verify_tiles.launches = VC.verdict_checksum.launches = 0
        out = fn()
        sync()
        path_launches[path] = VT.verify_tiles_checked.launches
        checksum_launches[path] = VT.verify_tiles_checked.checksummed
        if not rehearse and path_launches[path] == 0:
            _fail(f"the {path} path never made the checked verify_tiles launch")
        if not rehearse and checksum_launches[path] != path_launches[path]:
            _fail(f"the {path} path carried the checksum partials in "
                  f"{checksum_launches[path]} of {path_launches[path]} launches")
        if VT.verify_tiles.launches or VC.verdict_checksum.launches:
            _fail(f"the {path} path launched the unchecked verify kernel "
                  f"{VT.verify_tiles.launches} times and the standalone checksum "
                  f"{VC.verdict_checksum.launches} times")
        return out

    def drive(path, engine, driver="index"):
        """One `verify_batch` over `items` on `engine` with fresh caches, in
        index mode or through the wire driver: (results, launches, the
        verifier, the checks it dispatched through `verify_checks`, s)."""
        verifier = TorchSecpVerifier(device=device, engine=engine)
        sent = []  # the checks the wire seam dispatched, in order
        verify_checks = verifier.verify_checks

        def recording(checks):
            sent.extend(checks)
            return verify_checks(checks)

        verifier.verify_checks = recording
        os.environ["BITCOINCONSENSUS_TPU_IDX"] = "0" if driver == "wire" else "1"
        sink = _ListSink()
        span_records[path] = sink.records
        add_sink(sink)
        try:
            def run():
                t0 = time.perf_counter()
                res = verify_batch(items, verifier=verifier, sig_cache=SigCache(),
                                   script_cache=ScriptExecutionCache(), engine=engine)
                sync()
                return res, time.perf_counter() - t0
            results, t_total = launches_around(path, run)
        finally:
            remove_sink(sink)
            os.environ.pop("BITCOINCONSENSUS_TPU_IDX", None)
        return results, path_launches[path], verifier, sent, t_total

    def split(phase, engine, driver, results, launches, verifier, t_total):
        st = verifier.stats
        ph = {k: v["secs"] for k, v in verifier.phases.report().items()}
        dispatch_s = ph.get("dispatch", 0.0)
        prep_interp = (t_total - st["lane_prep_s"] - dispatch_s
                       - st["device_wait_s"] - st["fixup_s"])
        _line(phase, engine=engine, driver=driver, inputs=len(results),
              checks=int(st["lanes"]), padded_lanes=int(st["padded_lanes"]),
              dispatches=int(st["dispatches"]), kernel_launches=launches,
              fixups=int(st["fixups"]), total_s=f"{t_total:.4f}",
              prepare_interpret_s=f"{prep_interp:.4f}",
              interpret_s=f"{ph.get('interpret', 0.0):.4f}",
              lane_prep_s=f"{st['lane_prep_s']:.4f}", dispatch_s=f"{dispatch_s:.4f}",
              device_wait_s=f"{st['device_wait_s']:.4f}",
              kernel_ms=f"{st['kernel_ms']:.3f}", fixup_s=f"{st['fixup_s']:.4f}",
              inputs_per_s=f"{len(results) / t_total:.1f}",
              checks_per_s=f"{st['lanes'] / t_total:.1f}",
              span_self_ms=json.dumps(_span_split(span_records[phase],
                                                  "batch.verify_batch")))

    verdicts = _verdicts
    results, launches, _v, _s, t_total = drive("main_path", "native")
    split("main_path", "native", "index", results, launches, _v, t_total)
    wire_run = drive("main_path_wire", "native", "wire")
    split("main_path_wire", "native", "wire", wire_run[0], *wire_run[1:3], wire_run[4])
    _r, _l, verifier, sent, _t = wire_run
    py_run = drive("main_path_python", "python")
    split("main_path_python", "python", "wire", py_run[0], *py_run[1:3], py_run[4])
    n_wire_diff = sum(a != b for a, b in zip(verdicts(results), verdicts(wire_run[0])))
    n_engine_diff = sum(a != b for a, b in zip(verdicts(results), verdicts(py_run[0])))
    _line("engines", inputs=len(items), tolerance=0,
          index_vs_wire_differing=n_wire_diff, index_vs_python_differing=n_engine_diff,
          index_launches=launches, wire_launches=wire_run[1], python_launches=py_run[1])
    if n_wire_diff or n_engine_diff or not (
            len(results) == len(wire_run[0]) == len(py_run[0]) == len(items)):
        _fail("the index-mode, wire and Python drivers' verdicts differ")
    py_sent = py_run[3]

    # The two native drivers again, in turns (wire, index, index, wire), each
    # with a fresh verifier and caches: the first call of a process pays
    # one-time costs, so only runs in turns compare the drivers.
    turns = {"index": [], "wire": []}
    for driver in ("wire", "index", "index", "wire"):
        verifier_t = TorchSecpVerifier(device=device)
        os.environ["BITCOINCONSENSUS_TPU_IDX"] = "0" if driver == "wire" else "1"
        try:
            sync()
            t0 = time.perf_counter()
            res_t = verify_batch(items, verifier=verifier_t, sig_cache=SigCache(),
                                 script_cache=ScriptExecutionCache())
            sync()
            dt = time.perf_counter() - t0
        finally:
            os.environ.pop("BITCOINCONSENSUS_TPU_IDX", None)
        st = verifier_t.stats
        disp = verifier_t.phases.report().get("dispatch", {"secs": 0.0})["secs"]
        turns[driver].append((dt, dt - st["lane_prep_s"] - disp - st["device_wait_s"]
                              - st["fixup_s"]))
        if verdicts(res_t) != verdicts(results):
            _fail(f"the {driver} driver's verdicts changed between runs")
    _line("drivers_turns", order="wire,index,index,wire",
          index_total_s=json.dumps([round(t, 4) for t, _ in turns["index"]]),
          wire_total_s=json.dumps([round(t, 4) for t, _ in turns["wire"]]),
          index_prepare_interpret_s=json.dumps([round(p, 4) for _, p in turns["index"]]),
          wire_prepare_interpret_s=json.dumps([round(p, 4) for _, p in turns["wire"]]),
          index_over_wire=f"{sum(t for t, _ in turns['index']) / sum(t for t, _ in turns['wire']):.3f}")

    def exact(item):
        return _api_exact(item.spending_tx, item.input_index, item.spent_outputs,
                          item.flags)

    n_bad_ok = n_clean_fail = 0
    for item, res, bad in zip(items, results, corrupted):
        if bad:
            want = exact(item)
            if res.ok or res.error != api.Error.ERR_SCRIPT or \
                    (res.ok, res.error, res.script_error) != want:
                n_bad_ok += 1
        elif not res.ok:
            n_clean_fail += 1
    rng = np.random.default_rng(args.seed)
    clean = [i for i, bad in enumerate(corrupted) if not bad]
    sample = rng.choice(clean, size=min(64, len(clean)), replace=False)
    n_sample_diff = sum(
        (results[i].ok, results[i].error, results[i].script_error) != exact(items[i])
        for i in sample
    )
    _line("main_path_check", corrupted=sum(corrupted),
          corrupted_mismatch=n_bad_ok, clean_rejected=n_clean_fail,
          sampled=len(sample), sampled_mismatch=n_sample_diff)
    if n_bad_ok or n_clean_fail or n_sample_diff:
        _fail("verify_batch verdicts disagree with the expected ones")

    _stream(items, results, device, sync, launches_around, rehearse)
    block_run = _block(device, sync, launches_around, rehearse)
    _guards_phase(items, results, block_run, device, sync, rehearse)
    _chaos_phase(items, corrupted, results, device, rehearse)
    _obs_phase(items, results, block_run, device, sync)
    os.makedirs(out_dir, exist_ok=True)
    _xprof_phase(items, results, block_run, device, sync, rehearse, out_dir)

    # -- the device SHA-256 paths, after the phases above so that those run
    # in the process state they had before this slice -------------------------
    chal_launches = _challenge_path(items, results, py_sent, device, sync,
                                    launches_around, rehearse)
    # The challenge kernel's width on that path: the first dispatch's
    # Schnorr checks.
    chal_width = sum(c.kind == "schnorr" for c in py_sent[:py_run[2].lane_capacity])
    sha_ctx = block_run[3]
    merkle_launches = _merkle_phase(
        device, np.random.default_rng([seed, 4097]),
        [tx.txid for tx in sha_ctx["block"].vtx], rehearse)
    sha_connect, sha_counts = _block_device_sha(
        sha_ctx["block"], sha_ctx["bad_block"], sha_ctx["height"], sha_ctx["plain_view"],
        sha_ctx["want"], sha_ctx["bad_want"], device, sync, launches_around, rehearse,
        block_run[2])
    _xprof_phase(items, results, block_run, device, sync, rehearse, out_dir,
                 sha_connect=sha_connect)

    # -- 4. lane packing, and the kernel against its plain version ---------------
    pack_checks = sent[:n_lanes]
    t0 = time.perf_counter()
    lanes = verifier._prep_lanes(pack_checks)
    py_packed = verifier._pack_lanes(lanes)
    py_pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat_packed = native_bridge.prep_pack(pack_checks, verifier._pad(len(pack_checks)))
    nat_pack_s = time.perf_counter() - t0
    pack_diff = sum(not _same_arrays([a], [b])
                    for a, b in zip(py_packed, nat_packed, strict=True))
    _line("lane_pack", lanes=len(pack_checks), padded=len(nat_packed[0]),
          arrays=len(nat_packed), arrays_differing=pack_diff,
          native_s=f"{nat_pack_s:.4f}", python_s=f"{py_pack_s:.4f}")
    if pack_diff:
        _fail("the native core's packed lanes differ from the Python packers'")

    (f, wo, par, h2, n1, n2, val), idx = blockgen.perturbed_panel(
        verifier, py_packed, n_lanes, rng)
    dev = verifier.to_device((f, wo, par, h2, n1, n2, val))

    # The unchecked kernel's own drive: its launches are counted around it,
    # as the toys'. The plain version is the checked launch's (the plain
    # verify, then the plain epilogue), one synchronised call timed on the
    # host clock.
    sync()
    VT.verify_tiles.launches = 0
    ok_k, nd_k = VT.verify_tiles(*dev)
    sync()
    vt_launches = VT.verify_tiles.launches
    t_plain = time.perf_counter()
    ok_r, nd_r, _parts_r = VT.verify_tiles_checked_reference(*dev)
    sync()
    checked_plain_ms = (time.perf_counter() - t_plain) * 1e3
    err = max(int((ok_k.int() - ok_r.int()).abs().max()),
              int((nd_k.int() - nd_r.int()).abs().max()))
    _line("compare", lanes=n_lanes, perturbed=int(idx.size), tolerance=0,
          kernel_ok=int(ok_k.sum()), plain_ok=int(ok_r.sum()),
          kernel_needs=int(nd_k.sum()), plain_needs=int(nd_r.sum()),
          max_abs_err=err)
    if err != 0 or not bool(nd_k[0]) or bool(ok_k[0]):
        _fail("kernel and plain version disagree (tolerance: bit-identical)")

    kernel_ms = _timed(lambda: VT.verify_tiles(*dev), 1 if rehearse else 20, device)
    plain_ms = _timed(lambda: VT.verify_tiles_reference(*dev), 1, device)
    sqrs, muls = _fe_ops_per_lane(f, val)
    int_ops = (float(sqrs.sum()) * INT_OPS_PER_FE_SQR
               + float(muls.sum()) * INT_OPS_PER_FE_MUL)
    nbytes = n_lanes * (128 + 5 * 4 + 1 + 2 * 4) + 32 * 255 * 2 * 32
    op_ms = int_ops / H100_INT32_OPS * 1e3
    byte_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(op_ms, byte_ms)
    _line("kernel_time", lanes=n_lanes, kernel_ms=f"{kernel_ms:.4f}",
          plain_ms=f"{plain_ms:.3f}", fe_sqrs_per_lane=f"{sqrs.mean():.1f}",
          fe_muls_per_lane=f"{muls.mean():.1f}",
          int_ops=f"{int_ops:.4g}", op_bound_ms=f"{op_ms:.4f}",
          byte_bound_ms=f"{byte_ms:.6f}",
          roofline_share=f"{bound_ms / kernel_ms:.4f}")

    if not rehearse:
        n_ops, bad_words = _field_check(VT, device, rng)
        _line("field", operands=n_ops, ops=8, tolerance=0, words_differing=bad_words)
        if bad_words:
            _fail("the kernel's field layer disagrees with the integer model")
    _recode_check(VT, device, np.random.default_rng([args.seed, 8]), card,
                  rehearse)

    # Width sweep: the panel tiled to the widest width; each width's kernel
    # result is compared with the plain version on a sample of its lanes.
    widths = (16, 64) if rehearse else SWEEP_WIDTHS
    reps = max(widths) // n_lanes + 1
    tiled = [np.ascontiguousarray(np.concatenate([a] * reps)[:max(widths)])
             for a in (f, wo, par, h2, n1, n2, val)]
    for width in widths:
        args = verifier.to_device([a[:width] for a in tiled])
        ok_w, nd_w = VT.verify_tiles(*args)
        pick = np.sort(rng.choice(width, size=min(width, 256), replace=False))
        sample = verifier.to_device([np.ascontiguousarray(a[:width][pick])
                                     for a in tiled])
        ok_s, nd_s = VT.verify_tiles_reference(*sample)
        sync()
        idx_t = torch.from_numpy(pick).to(device)
        err_w = max(int((ok_w[idx_t].int() - ok_s.int()).abs().max()),
                    int((nd_w[idx_t].int() - nd_s.int()).abs().max()))
        ms_w = _timed(lambda: VT.verify_tiles(*args), 1 if rehearse else 10, device)
        clock, watts = ("cpu", "cpu") if rehearse else \
            _clocks_during(lambda: VT.verify_tiles(*args))
        _line("sweep", lanes=width, kernel_ms=f"{ms_w:.4f}",
              ns_per_lane=f"{ms_w * 1e6 / width:.1f}", sample=len(pick),
              tolerance=0, max_abs_err=err_w, sm_clock_mhz=clock,
              power_w=watts)
        if err_w:
            _fail(f"kernel and plain version disagree at {width} lanes")

    epi = _verify_epilogue_phase(tiled, (ok_r, nd_r), items, block_run, device, sync,
                                 np.random.default_rng([seed, 16]), rehearse)
    VC.verdict_checksum.launches = 0
    checksum = _checksum_phase(device, rng, rehearse)
    vc_launches = VC.verdict_checksum.launches
    sha_entries, sha_launches = _sha256_phase(
        device, np.random.default_rng([seed, 256]), rehearse, chal_width,
        (len(sha_ctx["block"].vtx) + 1) // 2, len(sha_ctx["block"].vtx))

    # The checked launch's bound: the verify's operations and bytes, with
    # its epilogue's (about 4 int32 operations a lane; the verdicts as 2
    # bytes a lane and 12 bytes of partials a warp in place of 8 bytes a
    # lane of int32 verdicts).
    c_bytes = (n_lanes * (128 + 5 * 4 + 1 + 2) + 32 * 255 * 2 * 32
               + 12 * -(-n_lanes // VT.WARP))
    c_bound_ms, c_bound_by = _bound(c_bytes, int_ops + 4.0 * n_lanes)
    kernels = [{
        "name": "verify_tiles_checked",
        "route": "cuda",
        "source": "bitcoinconsensus_tpu_torch/csrc/verify_tiles.cu",
        "replaces": "bitcoinconsensus_tpu/ops/pallas_kernel.py:490 with "
                    "bitcoinconsensus_tpu/crypto/jax_backend.py:379 chained after it "
                    "(the verify pallas_call and the verdict checksum, one launch)",
        "launches": launches,
        "launches_by_path": path_launches,
        "checksum_launches_by_path": checksum_launches,
        "max_abs_err": epi["max_abs_err"],
        "ms": epi["ms"],
        "plain_ms": checked_plain_ms,
        "bound_ms": c_bound_ms,
        "bound_by": c_bound_by,
        "library_ms": None,
        "device_ms": epi["device_ms"],
        "epilogue_marginal_device_ms": epi["epilogue_marginal_device_ms"],
        "old_sequence_ms": epi["old_sequence_ms"],
    }, {
        "name": "verify_tiles",
        "route": "cuda",
        "source": "bitcoinconsensus_tpu_torch/csrc/verify_tiles.cu",
        "replaces": "bitcoinconsensus_tpu/ops/pallas_kernel.py:490",
        # Off the dispatch path since the checked launch: the prover's,
        # [compare]'s, [sweep]'s, [field]'s and [recode]'s kernel, its
        # launches counted around [compare], as the toys'.
        "launches": vt_launches,
        "launches_by_path": {"compare": vt_launches},
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": None,
    }, {
        "name": "verdict_checksum",
        "route": "cuda",
        "source": "bitcoinconsensus_tpu_torch/csrc/verdict_checksum.cu",
        "replaces": "bitcoinconsensus_tpu/crypto/jax_backend.py:379 (an XLA "
                    "program of the reference, not a pallas_call)",
        # Off the dispatch path since the checked launch: counted around
        # its own [checksum] drive.
        "launches": vc_launches,
        "launches_by_path": {"checksum": vc_launches},
        **checksum,
    }]
    sha_paths = {"block_device_sha": sha_counts, "merkle": merkle_launches}
    by_path = {
        "sh_compress_kernel": {"sha256": sha_launches["sh_compress_kernel"]},
        "sh_fixed_kernel": {"sha256": sha_launches["sh_fixed_kernel"]},
        "sh_challenge_kernel": {
            "challenge_path": chal_launches,
            "block_device_sha": sha_paths["block_device_sha"]["sh_challenge_kernel"]},
        # Off every path since the tree: counted around [sha256], as the
        # compression's.
        "sh_merkle_level_kernel": {"sha256": sha_launches["sh_merkle_level_kernel"]},
        "sh_merkle_tree_kernel": {
            "block_device_sha": sha_paths["block_device_sha"]["sh_merkle_tree_kernel"],
            "merkle": sha_paths["merkle"]},
    }
    for sym, name, line in (
            ("sh_compress_kernel", "sha256_compress", "bitcoinconsensus_tpu/ops/sha256.py:80"),
            ("sh_fixed_kernel", "sha256_fixed", "bitcoinconsensus_tpu/ops/sha256.py:130"),
            ("sh_challenge_kernel", "bip340_challenge",
             "bitcoinconsensus_tpu/ops/sha256.py:206"),
            ("sh_merkle_level_kernel", "merkle_level",
             "bitcoinconsensus_tpu/core/block.py:158 (one level)"),
            ("sh_merkle_tree_kernel", "merkle_tree",
             "bitcoinconsensus_tpu/core/block.py:158")):
        # The compression, the fixed hash and the merkle level run on no path
        # of the system: their launches are counted around the [sha256]
        # drive, as the toys'.
        first = next(iter(by_path[sym].values()))
        kernels.append({
            "name": name, "route": "cuda", "source": SHA_SOURCE,
            "replaces": f"{line} (an XLA program of the reference, not a pallas_call)",
            "launches": first, "launches_by_path": by_path[sym],
            **sha_entries[sym]})

    # -- 5. the kernel prover ----------------------------------------------------
    # The prover's modules are imported only now, so that the main path runs
    # in a process that has not loaded them.
    from bitcoinconsensus_tpu_torch.analysis import kernel_check as K
    from bitcoinconsensus_tpu_torch.ops.contract import run_contract

    _prover()

    # -- 6. the toys ------------------------------------------------------------
    if not rehearse:
        toy_lib = _build.load("toy_kernels")
        for wrapper in K.TOY_WRAPPERS:
            getattr(toy_lib, "tk" + wrapper.__name__[3:])  # raises if missing
        _line("toys", launchers=len(K.TOY_WRAPPERS), present=True)
    cols = K.TOY_TILE * 2
    rows8 = (K.TOY_ROWS, cols)

    def ints(lo, hi, shape=rows8):
        return torch.from_numpy(rng.integers(lo, hi + 1, shape).astype(np.int32)).to(device)

    w2 = np.asarray(L.W2, dtype=np.int64)[:, None]
    xm = rng.integers(0, w2 + 1, (L.NLIMB, cols)).astype(np.int32)
    xm[:, 0] = L.W2  # the W2 corner
    elems8 = float(K.TOY_ROWS * cols)
    dot_flops = 2.0 * K.TOY_ROWS * cols  # column 0 of X X^T, per 128 columns
    checked_bytes = elems8 * 12 + cols // K.TOY_TILE * 8  # x, o, writes; faults
    # (name, wrapper, contract, input, pallas_check.py line, kernel symbol,
    #  bytes, operations, rate, library call or None)
    x8 = ints(-1000, 1000)
    x_tf32, x_dot, x_sq, x_wr = ints(0, 100), ints(0, 1 << 9), ints(0, 100), ints(0, 100)

    def dot_col0(x, tf32):
        """The dot toys' function in the fewest PyTorch calls: per 128-column
        block, column 0 of X X^T broadcast over the block's columns."""
        def f():
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                xf = x.view(K.TOY_ROWS, -1, K.TOY_TILE).float()
                return torch.einsum("rbc,bc->rb", xf, xf[0]).int().repeat_interleave(
                    K.TOY_TILE, 1)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
        return f

    toys = [
        ("positive", K.toy_positive, K.POSITIVE_CONTRACT, x8, 780,
         "tk_positive_kernel", elems8 * 8, elems8, H100_INT32_OPS, lambda: x8 + 1),
        ("mul", K.toy_mul, K.MUL_CONTRACT, torch.from_numpy(xm).to(device), 841,
         "tk_mul_kernel", xm.size * 8.0, float(cols * _mul_toy_ops_per_column()),
         H100_INT32_OPS, None),
        ("f32_dot_tf32", K.toy_f32_dot_tf32, K.F32_DOT_TF32_CONTRACT, x_tf32,
         884, "tk_f32_dot_tf32_kernel", elems8 * 8, dot_flops, H100_TF32_FLOPS,
         dot_col0(x_tf32, True)),
        ("f32_dot", K.toy_f32_dot, K.F32_DOT_CONTRACT, x_dot, 910,
         "tk_f32_dot_kernel", elems8 * 8, dot_flops, H100_F32_FLOPS,
         dot_col0(x_dot, False)),
        ("f32_square", K.toy_f32_square, K.F32_SQUARE_CONTRACT, x_sq, 933,
         "tk_f32_square_kernel", elems8 * 8, elems8, H100_F32_FLOPS,
         lambda: x_sq.float().square().int()),
        ("f32_write", K.toy_f32_write, K.F32_WRITE_CONTRACT, x_wr, None,
         "tk_f32_write_kernel", elems8 * 8, elems8, H100_F32_FLOPS,
         lambda: x_wr.float().square()),
        ("oob_index_map", K.toy_oob_index_map, K.OOB_CONTRACT, x8, 798,
         "tk_window_copy_kernel", checked_bytes, 0.0, H100_INT32_OPS, None),
        ("read_before_write", K.toy_read_before_write, K.RBW_CONTRACT, x8, 819,
         "tk_read_before_write_kernel", checked_bytes, 0.0, H100_INT32_OPS, None),
        ("double_write", K.toy_double_write, K.DOUBLE_WRITE_CONTRACT, x8, 860,
         "tk_window_copy_kernel", checked_bytes, 0.0, H100_INT32_OPS, None),
    ]
    for t in toys:
        t[1].launches = 0
    sync()
    outs = [t[1](t[3]) for t in toys]  # the toys' drive
    sync()
    toy_launches = {t[0]: t[1].launches for t in toys}
    if not rehearse and 0 in toy_launches.values():
        _fail(f"a toy wrapper never launched its kernel: {toy_launches}")
    for (name, wrapper, contract, x, line, symbol, nbytes_t, ops_t, rate,
         library), out in zip(toys, outs):
        checked = isinstance(out, tuple)
        plain_fn = (lambda c=contract, x=x: K.run_checked(c, x)) if checked else \
            (lambda c=contract, x=x: run_contract(c, x))
        plain = plain_fn()
        sync()
        if checked:
            o, writes, faults = out
            po, pwrites, pfaults = plain
            once = pwrites == 1  # elements two blocks race on have no defined value
            err = max(int((writes - pwrites).abs().max()),
                      int((faults - pfaults).abs().max()),
                      int((o[once].long() - po[once].long()).abs().sum()))
            extra = dict(faults=json.dumps(faults.tolist()),
                         writes_max=int(writes.max()),
                         unwritten=int((writes == 0).sum()))
        else:
            err = float((out.double() - plain.double()).abs().max())
            err = int(err) if err.is_integer() else err
            extra = {}
        # Every toy by one measure: the median of 7 rounds of 200 calls, the
        # kernel's call and the library's (where there is one) in turns.
        fns = [lambda: wrapper(x)] + ([library] if library else [])
        got = _timed_turns(fns, 1 if rehearse else 200, 1 if rehearse else 7, device)
        ms, lib_ms = got[0], (got[1] if library else None)
        if library is not None and not checked:
            # The library call's output against the kernel's: equal where it
            # computes the same function bit for bit.
            lib_out = library()
            sync()
            extra["library_max_abs_err"] = float(
                (lib_out.double() - out.double()).abs().max())
        p_ms = _timed(plain_fn, 1 if rehearse else 20, device)
        dev_ms = None if rehearse else _device_ms(lambda: wrapper(x), 50, symbol)
        b_ms, b_by = _bound(nbytes_t, ops_t, rate)
        _line("toys", kernel=f"toy_{name}", shape=json.dumps(list(x.shape)),
              launches=toy_launches[name], max_abs_err=err, tolerance=0,
              ms=f"{ms:.5f}", device_ms=json.dumps(dev_ms),
              plain_ms=f"{p_ms:.4f}",
              library_ms="null" if lib_ms is None else f"{lib_ms:.5f}",
              bound_ms=f"{b_ms:.3g}", bound_by=b_by, **extra)
        if err != 0:
            _fail(f"toy_{name} and its plain version disagree (tolerance 0)")
        kernels.append({
            "name": f"toy_{name}", "route": "cuda", "source": TOY_SOURCE,
            "replaces": (f"{TOYS}:{line}" if line else
                         "tests/test_pallas_check.py:112"),
            "launches": toy_launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "device_ms": dev_ms})
    _stats_phase(rehearse, out_dir)

    # -- the mesh, after every phase above, so that those run in the process
    # state they had before this slice -------------------------------------------
    from bitcoinconsensus_tpu_torch.ops import shard_step as SS

    SS.shard_epilogue.launches = 0
    ss_entry = _shard_step_phase(device, np.random.default_rng([seed, 13]), rehearse)
    ss_launches = SS.shard_epilogue.launches
    mesh_ctx = _mesh_phase(items, results, block_run, py_sent, device, sync, rehearse,
                           path_launches)
    _mesh_faults_phase(mesh_ctx, device, rehearse)
    _mesh_xprof_phase(mesh_ctx, device, sync, rehearse, out_dir)

    # -- serving, ingress, the persistent sig cache and the cell, after every
    # phase above, so that those run in the process state they had before ----
    t_serving = time.perf_counter()
    _serve_phase(items, results, device, launches_around, rehearse)
    _ingress_phase(items, results, device, launches_around, rehearse)
    _sigstore_phase(items, corrupted, results, device, launches_around, rehearse, out_dir)
    cell_counts = _cell_phase(items, results, device, rehearse, out_dir)
    # The replicas' launches happen in their own processes, read over their
    # control channels after the load: not this process's counts.
    path_launches["cell_replica_processes"] = cell_counts["cell_replicas"][0]
    checksum_launches["cell_replica_processes"] = cell_counts["cell_replicas"][1]
    _line("serving_phases", seconds=f"{time.perf_counter() - t_serving:.1f}")

    # -- the gauntlet (`workloads/`), after every phase above, so that those
    # run in the process state they had before this slice ---------------------
    _gauntlet_phase(device, sync, launches_around, path_launches, checksum_launches,
                    rehearse)
    # Off the mesh's path since the checked launch: counted around its own
    # [shard_step] drive.
    kernels.insert(3, {
        "name": "shard_epilogue", "route": "cuda", "source": MESH_SOURCE,
        "replaces": "bitcoinconsensus_tpu/parallel/mesh.py:201 (make_sharded_step's "
                    "local_step, an XLA program of the reference, not a pallas_call)",
        "launches": ss_launches, "launches_by_path": {"shard_step": ss_launches},
        **ss_entry})
    _line("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if rehearse:
        print("rehearsal complete (not a result)", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
