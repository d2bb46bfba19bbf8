#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. The card: nvidia-smi name and power limit, torch and CUDA versions.
2. Build every kernel from `bitcoinconsensus_tpu_torch/csrc` with nvcc and
   the native host core (`csrc/native/`) with g++, one process per source,
   all started together; print each build time and the ptxas registers and
   spills.
3. Main path: 10,000 seeded inputs in the replay mix (55% p2wpkh, 20% p2tr,
   15% p2pkh, 10% p2wsh 2-of-3; about 1% carry a corrupted signature) go
   through one `verify_batch` on cuda:0 on the native host engine
   (`[main_path] engine=native`), then through another on the Python
   engine with fresh caches (`[main_path_python]`), whose verdicts must
   equal the first's item for item. Every clean input must be accepted,
   every corrupted one rejected with ERR_SCRIPT and the ScriptError of the
   exact per-input `api` path on its Python engine, and 64 sampled clean
   inputs must match that path bit for bit. The kernel's launch count is
   read around each call alone, and each must launch it.
4. Lane packing: the native core's packed lanes of the first 8,192 checks
   byte-equal to the Python packers', pad lanes included (`[lane_pack]`,
   both host times). Kernel against its plain version on the card: those
   lanes, a few hundred perturbed and one crafted collision lane; `ok`
   and `needs_host` must be bit-identical. Times by CUDA events; the
   operation bound counts the schedule's field squares and multiplies on
   these inputs. Every launch takes the contract's dynamic shared bytes,
   which the C launcher refuses unless they are the kernel's. Then its
   field layer alone against the integer model on edge and seeded operands,
   and a width sweep: kernel ms at 64, 4,908, 8,192 and 32,768 lanes (the
   panel tiled), each compared with the plain version on a sample of lanes,
   with the SM clock and power draw read while it runs back to back.
5. The kernel prover (`analysis/registry.py`), after the main path so that
   its tracing leaves the main path's timing alone: every non-heavy entry
   must prove, `verify_tiles`'s launch contract included (8,192 and 4,908
   lanes); the positive toy must prove and each planted defect be rejected
   with its kind.
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
7. A `kernels` JSON line, the card line, and the result line.

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
    """Mean device time per call of the CUDA kernels whose name holds
    `kernel`, by torch.profiler over `reps` calls; None (not measured) where
    the profiler fails or shows no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except Exception as e:  # an optional measurement: report, do not fail
        print(f"  profiler unavailable: {type(e).__name__}: {e}", flush=True)
        return None
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in events
             if kernel in e.key)
    return us / reps / 1e3 if us > 0 else None


def _prover() -> None:
    """Every non-heavy registry entry proves; the positive toy proves and
    every planted defect is rejected with its kind."""
    from bitcoinconsensus_tpu_torch.analysis import kernel_check as K
    from bitcoinconsensus_tpu_torch.analysis import registry

    bad = []
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


def _signed_mags(v: int):
    out, carry = [], 0
    for w in range(26):
        t = ((v >> (5 * w)) & 31) + carry
        carry = 1 if t >= 16 else 0
        out.append(abs(t - 32) if carry else t)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run the phases on the CPU at a small size (exits 3)")
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not args.rehearse_cpu and not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    port = _import_port()
    from bitcoinconsensus_tpu_torch import api, native_bridge
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.ops import _build
    from bitcoinconsensus_tpu_torch.ops import limbs as L
    from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
    from bitcoinconsensus_tpu_torch.utils import blockgen

    rehearse = args.rehearse_cpu
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

        sources = ("verify_tiles", "toy_kernels", _build.HOST_CORE)
        with ThreadPoolExecutor(len(sources)) as pool:
            builds = list(pool.map(_build.build, sources))
        for name, built in zip(sources, builds):
            what = dict(name=name) if name == _build.HOST_CORE else dict(kernel=name)
            _line("build", **what, seconds=f"{built.seconds:.2f}",
                  library=os.path.relpath(built.path, HERE))
            for ln in built.log.splitlines():
                if re.search(r"registers|spill|stack frame", ln):
                    print("  ptxas: " + ln.strip(), flush=True)
        vt_ptxas = _ptxas(builds[0].log, "vt_verify_kernel")
        _line("ptxas", kernel="vt_verify_kernel", **vt_ptxas,
              dynamic_smem=VT.VERIFY_TILES_CONTRACT.dynamic_smem_bytes(),
              build_s=f"{builds[0].seconds:.2f}")

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

    def drive(engine):
        """One `verify_batch` over `items` on `engine` with fresh caches:
        (results, launches, the verifier, the checks it dispatched, total s).
        The launch count is set to 0 just before the call, read just after."""
        verifier = TorchSecpVerifier(device=device, engine=engine)
        sent = []  # the checks the verifier dispatched, in order
        verify_checks = verifier.verify_checks

        def recording(checks):
            sent.extend(checks)
            return verify_checks(checks)

        verifier.verify_checks = recording
        sync()
        VT.verify_tiles.launches = 0
        t0 = time.perf_counter()
        results = verify_batch(items, verifier=verifier, sig_cache=SigCache(),
                               script_cache=ScriptExecutionCache(), engine=engine)
        sync()
        t_total = time.perf_counter() - t0
        launches = VT.verify_tiles.launches
        if not rehearse and launches == 0:
            _fail(f"the {engine} main path never launched the verify_tiles kernel")
        return results, launches, verifier, sent, t_total

    def split(phase, engine, results, launches, verifier, t_total):
        st = verifier.stats
        prep_interp = t_total - st["lane_prep_s"] - st["device_wait_s"] - st["fixup_s"]
        _line(phase, engine=engine, inputs=len(results), checks=int(st["lanes"]),
              dispatches=int(st["dispatches"]), kernel_launches=launches,
              fixups=int(st["fixups"]), total_s=f"{t_total:.3f}",
              prepare_interpret_s=f"{prep_interp:.3f}",
              lane_prep_s=f"{st['lane_prep_s']:.3f}",
              device_wait_s=f"{st['device_wait_s']:.3f}",
              kernel_ms=f"{st['kernel_ms']:.3f}", fixup_s=f"{st['fixup_s']:.4f}",
              inputs_per_s=f"{len(results) / t_total:.1f}",
              checks_per_s=f"{st['lanes'] / t_total:.1f}")

    def verdicts(results):
        return [(r.ok, r.error, r.script_error) for r in results]

    results, launches, verifier, sent, t_total = drive("native")
    split("main_path", "native", results, launches, verifier, t_total)
    py_run = drive("python")
    split("main_path_python", "python", py_run[0], *py_run[1:3], py_run[4])
    n_engine_diff = sum(a != b for a, b in zip(verdicts(results), verdicts(py_run[0])))
    _line("engines", inputs=len(items), tolerance=0, verdicts_differing=n_engine_diff,
          native_launches=launches, python_launches=py_run[1])
    if n_engine_diff or len(py_run[0]) != len(results):
        _fail("the native and Python engines' verdicts differ")

    def exact(item):
        """The per-input `api` on its Python engine: a spec independent of
        the native core under test."""
        try:
            api.verify_with_spent_outputs(item.spending_tx, item.input_index,
                                          item.spent_outputs, item.flags,
                                          engine="python")
            return (True, api.Error.ERR_OK, port.ScriptError.OK)
        except api.ConsensusError as e:
            return (False, e.code, e.script_error)

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

    # -- 4. lane packing, and the kernel against its plain version ---------------
    pack_checks = sent[:n_lanes]
    t0 = time.perf_counter()
    lanes = verifier._prep_lanes(pack_checks)
    py_packed = verifier._pack_lanes(lanes)
    py_pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat_packed = native_bridge.prep_pack(pack_checks, verifier._pad(len(pack_checks)))
    nat_pack_s = time.perf_counter() - t0
    pack_diff = sum(
        a.shape != b.shape or a.dtype != b.dtype or a.tobytes() != b.tobytes()
        for a, b in zip(py_packed, nat_packed, strict=True))
    _line("lane_pack", lanes=len(pack_checks), padded=len(nat_packed[0]),
          arrays=len(nat_packed), arrays_differing=pack_diff,
          native_s=f"{nat_pack_s:.4f}", python_s=f"{py_pack_s:.4f}")
    if pack_diff:
        _fail("the native core's packed lanes differ from the Python packers'")

    (f, wo, par, h2, n1, n2, val), idx = blockgen.perturbed_panel(
        verifier, py_packed, n_lanes, rng)
    dev = verifier.to_device((f, wo, par, h2, n1, n2, val))

    ok_k, nd_k = VT.verify_tiles(*dev)
    ok_r, nd_r = VT.verify_tiles_reference(*dev)
    sync()
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

    kernels = [{
        "name": "verify_tiles",
        "route": "cuda",
        "source": "bitcoinconsensus_tpu_torch/csrc/verify_tiles.cu",
        "replaces": "bitcoinconsensus_tpu/ops/pallas_kernel.py:490",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": None,
    }]

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
    toys = [
        ("positive", K.toy_positive, K.POSITIVE_CONTRACT, x8, 780,
         "tk_positive_kernel", elems8 * 8, elems8, H100_INT32_OPS, lambda: x8 + 1),
        ("mul", K.toy_mul, K.MUL_CONTRACT, torch.from_numpy(xm).to(device), 841,
         "tk_mul_kernel", xm.size * 8.0, float(cols * _mul_toy_ops_per_column()),
         H100_INT32_OPS, None),
        ("f32_dot_tf32", K.toy_f32_dot_tf32, K.F32_DOT_TF32_CONTRACT, ints(0, 100),
         884, "tk_f32_dot_tf32_kernel", elems8 * 8, dot_flops, H100_TF32_FLOPS, None),
        ("f32_dot", K.toy_f32_dot, K.F32_DOT_CONTRACT, ints(0, 1 << 9), 910,
         "tk_f32_dot_kernel", elems8 * 8, dot_flops, H100_F32_FLOPS, None),
        ("f32_square", K.toy_f32_square, K.F32_SQUARE_CONTRACT, ints(0, 100), 933,
         "tk_f32_square_kernel", elems8 * 8, elems8, H100_F32_FLOPS, None),
        ("f32_write", K.toy_f32_write, K.F32_WRITE_CONTRACT, ints(0, 100), None,
         "tk_f32_write_kernel", elems8 * 8, elems8, H100_F32_FLOPS, None),
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
