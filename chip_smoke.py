#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. The card: nvidia-smi name and power limit, torch and CUDA versions.
2. Build every kernel of the main path from `bitcoinconsensus_tpu_torch/csrc`
   with nvcc; print the build time and ptxas registers and spills.
3. Main path: 10,000 seeded inputs in the replay mix (55% p2wpkh, 20% p2tr,
   15% p2pkh, 10% p2wsh 2-of-3; about 1% carry a corrupted signature) go
   through one `verify_batch` on cuda:0. Every clean input must be accepted,
   every corrupted one rejected with ERR_SCRIPT and the ScriptError of the
   exact per-input `api` path, and 64 sampled clean inputs must match that
   path bit for bit. The kernel's launch count is read around this call alone.
4. Kernel against its plain version on the card: the first 8,192 lanes of
   that batch, a few hundred perturbed and one crafted collision lane; `ok`
   and `needs_host` must be bit-identical. Times by CUDA events.
5. A `kernels` JSON line, the card line, and the result line.

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
# int32 operations per 256-bit field multiply in csrc/verify_tiles.cu,
# counted from the source: 64 32x32->64 multiply-accumulates at 3 int32
# operations each (a wide multiply-add is two, the carry add one), plus
# about 48 for the reduction mod p.
INT_OPS_PER_FE_MUL = 64 * 3 + 48
P = 2**256 - 2**32 - 977


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


def _fe_muls_per_lane(fields, valid_in):
    """Field multiplies each lane of the kernel performs on these inputs,
    following csrc/verify_tiles.cu's control flow: fixed lift and table
    work, 5 doublings per window once R is finite, one mixed add per
    nonzero digit (the first one of each ladder is a free lift), the join,
    and the affine step for lanes that reach it."""
    import numpy as np

    LIFT = 2 + 266 + 1  # x^3, the (p+1)/4 chain, the square check
    TABLE = 7 + 14 * 11 + 14 + 15 * 4
    DBL, MADD, JOIN, AFFINE = 7, 11, 16, 270 + 4
    counts = np.zeros(fields.shape[0], dtype=np.int64)
    for i in range(fields.shape[0]):
        b1 = int.from_bytes(fields[i, 1, :16].tobytes(), "little")
        b2 = int.from_bytes(fields[i, 1, 16:].tobytes(), "little")
        d1, d2 = _signed_mags(b1), _signed_mags(b2)
        muls, r_inf = LIFT + TABLE, True
        for w in range(25, -1, -1):
            if not r_inf:
                muls += 5 * DBL
            for d, beta in ((d1[w], 0), (d2[w], 1)):
                if d:
                    muls += beta + (0 if r_inf else MADD)
                    r_inf = False
        muls += 1  # back to the true curve's Z
        g = [b for b in fields[i, 0].tobytes() if b]
        muls += MADD * max(len(g) - 1, 0) + JOIN
        x = int.from_bytes(fields[i, 2].tobytes(), "little") % P
        rhs = (x * x * x + 7) % P
        residue = pow(rhs, (P - 1) // 2, P) in (0, 1)
        if valid_in[i] and residue:
            muls += AFFINE
        counts[i] = muls
    return counts


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
    from bitcoinconsensus_tpu_torch import api
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.ops import _build
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

    # -- 2. build ------------------------------------------------------------
    if not rehearse:
        built = _build.build("verify_tiles")
        _line("build", kernel="verify_tiles", seconds=f"{built.seconds:.2f}",
              library=os.path.relpath(built.path, HERE))
        for ln in built.log.splitlines():
            if re.search(r"registers|spill|stack frame", ln):
                print("  ptxas: " + ln.strip(), flush=True)

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

    verifier = TorchSecpVerifier(device=device)
    sent = []  # the checks the verifier dispatched, in order
    verify_checks = verifier.verify_checks

    def recording(checks):
        sent.extend(checks)
        return verify_checks(checks)

    verifier.verify_checks = recording
    VT.verify_tiles.launches = 0
    sync()
    t0 = time.perf_counter()
    results = verify_batch(items, verifier=verifier, sig_cache=SigCache(),
                           script_cache=ScriptExecutionCache())
    sync()
    t_total = time.perf_counter() - t0
    launches = VT.verify_tiles.launches
    st = verifier.stats
    if not rehearse and launches == 0:
        _fail("the main path never launched the verify_tiles kernel")

    def exact(item):
        try:
            api.verify_with_spent_outputs(item.spending_tx, item.input_index,
                                          item.spent_outputs, item.flags)
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
    prep_interp = t_total - st["lane_prep_s"] - st["device_wait_s"] - st["fixup_s"]
    _line("main_path", inputs=len(items), checks=int(st["lanes"]),
          dispatches=int(st["dispatches"]), kernel_launches=launches,
          fixups=int(st["fixups"]), total_s=f"{t_total:.3f}",
          prepare_interpret_s=f"{prep_interp:.3f}",
          lane_prep_s=f"{st['lane_prep_s']:.3f}",
          device_wait_s=f"{st['device_wait_s']:.3f}",
          kernel_ms=f"{st['kernel_ms']:.3f}", fixup_s=f"{st['fixup_s']:.4f}",
          inputs_per_s=f"{len(items) / t_total:.1f}",
          checks_per_s=f"{st['lanes'] / t_total:.1f}")
    _line("main_path_check", corrupted=sum(corrupted),
          corrupted_mismatch=n_bad_ok, clean_rejected=n_clean_fail,
          sampled=len(sample), sampled_mismatch=n_sample_diff)
    if n_bad_ok or n_clean_fail or n_sample_diff:
        _fail("verify_batch verdicts disagree with the expected ones")

    # -- 4. kernel against its plain version -------------------------------------
    lanes = verifier._prep_lanes(sent[:n_lanes])
    packed = [np.array(a[:n_lanes]) for a in verifier._pack_lanes(lanes)]
    f, wo, par, h2, n1, n2, val = packed
    n = len(lanes)
    if n < n_lanes:  # pad lanes as the packer makes them
        pad = verifier._pack_lanes([])
        packed = [np.concatenate([a, np.repeat(p[:1], n_lanes - n, axis=0)])
                  for a, p in zip(packed, pad)]
        f, wo, par, h2, n1, n2, val = packed
    qx, qy = blockgen._g_mul(2)
    coll = verifier._pack_lanes(verifier._prep_lanes([SigCheck(
        "tweak", (qx.to_bytes(32, "big"), qy & 1,
                  (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
                   ).to_bytes(32, "big"), (1).to_bytes(32, "big")))]))
    for a, c in zip((f, wo, par, h2, n1, n2, val), coll):
        a[0] = c[0]
    per = max(1, n_lanes // 160)  # ~5 x 50 perturbed lanes at full width
    idx = rng.permutation(np.arange(1, n_lanes))[: 5 * per].reshape(5, per)
    f[idx[0], 3, 0] ^= 1  # target
    val[idx[1]] = False  # structurally invalid
    f[idx[2], 2, 0] ^= 1  # pubkey x
    par[idx[3]] = np.where(par[idx[3]] < 0, par[idx[3]], par[idx[3]] ^ 1)
    wo[idx[3]] ^= 1  # parity rules
    n1[idx[4]] ^= 1  # GLV sign
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

    def timed(fn, reps):
        if device.type == "cuda":
            fn()
            sync()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            sync()
            return e0.elapsed_time(e1) / reps
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps

    kernel_ms = timed(lambda: VT.verify_tiles(*dev), 1 if rehearse else 20)
    plain_ms = timed(lambda: VT.verify_tiles_reference(*dev), 1)
    muls = _fe_muls_per_lane(f, val)
    int_ops = float(muls.sum()) * INT_OPS_PER_FE_MUL
    nbytes = n_lanes * (128 + 5 * 4 + 1 + 2 * 4) + 32 * 255 * 2 * 32
    op_ms = int_ops / H100_INT32_OPS * 1e3
    byte_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(op_ms, byte_ms)
    _line("kernel_time", lanes=n_lanes, kernel_ms=f"{kernel_ms:.4f}",
          plain_ms=f"{plain_ms:.3f}", fe_muls_per_lane=f"{muls.mean():.1f}",
          int_ops=f"{int_ops:.4g}", op_bound_ms=f"{op_ms:.4f}",
          byte_bound_ms=f"{byte_ms:.6f}",
          roofline_share=f"{bound_ms / kernel_ms:.4f}")

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
