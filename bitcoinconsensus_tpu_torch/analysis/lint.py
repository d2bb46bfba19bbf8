"""Kernel lint of the port: prove every registered kernel.

    python -m bitcoinconsensus_tpu_torch.analysis.lint            # everything
    python -m bitcoinconsensus_tpu_torch.analysis.lint --quick    # skip heavy entries
    python -m bitcoinconsensus_tpu_torch.analysis.lint --kernel limbs.fe_mul
    python -m bitcoinconsensus_tpu_torch.analysis.lint --report out.json
    python -m bitcoinconsensus_tpu_torch.analysis.lint --negative oob-index-map
    python -m bitcoinconsensus_tpu_torch.analysis.lint --negative list
    python -m bitcoinconsensus_tpu_torch.analysis.lint --exactness --quick
    python -m bitcoinconsensus_tpu_torch.analysis.lint --schedule --quick
    python -m bitcoinconsensus_tpu_torch.analysis.lint --schedule
    python -m bitcoinconsensus_tpu_torch.analysis.lint --negative scalar-carry-fold
    python -m bitcoinconsensus_tpu_torch.analysis.lint --host

The port's counterpart of `scripts/consensus_lint.py`. Exit status 0 if
and only if every selected kernel proves. The JSON report carries each
entry's derived per-row output bounds and, for launch contracts, the grid
and the shared bytes a block declares.

`--negative NAME` checks one deliberately broken toy, a kernel of
`analysis/kernel_check.NEGATIVES` or a scalar schedule of
`analysis/scalar_check.NEGATIVES` (`scalar-*`), and exits non-zero with its
diagnostics: the gate proving it still fires.

`--exactness` is the exact-float leg: each selected entry is a THEOREM
(every float32 value it makes is proven an exact integer), VACUOUS (it makes
none) or FAIL (a `float` violation), and every `f32-*` negative must come
back rejected with a `float` violation. Exit 0 if and only if nothing
FAILs and every such negative is rejected.

`--schedule` is the scalar-schedule theorem leg: every target of
`analysis/registry.all_schedules()` (with `--quick`, the fast set; with
`--kernel NAME`, the named ones) must be a THEOREM, the sound toy ladder
must pass, and every `scalar-*` negative must be REJECTED with a `schedule`
violation. Exit 0 if and only if all hold.

`--host` is the host lint (`analysis/host_lint.py`): the float,
nondeterminism and clock rules over `core/` and `models/`, the clock rule
over `crypto/`, `parallel/` and `resilience/`, the sync rule over
`crypto/torch_backend.py`, `parallel/mesh.py` and
`resilience/inflight.py`, scalar
coverage over `ops/`, `crypto/glv.py` and `csrc/verify_tiles.cu`, and region
coverage (every kernel of `csrc/*.cu` mapped in `ops/regions.py`). Exit 0
if and only if it finds nothing.

Not here yet, each with the module it waits for: the reference's
`precision` and `pallas` rules (no torch or CUDA counterpart in the port
today); the `sync` rule over `mesh.py`, `ingress.py` and `sigstore.py`; the
`sha256.bytes_from_words` and `curve.double_scalar_mult(_glv)` schedule
targets.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bitcoinconsensus_tpu_torch.analysis.lint",
        description=__doc__.split("\n\n")[0],
        epilog="Not yet ported: region coverage, the precision and pallas "
               "rules, obs counters (see the module docstring).")
    ap.add_argument("--quick", action="store_true",
                    help="skip heavy entries (the verify kernel's body proof)")
    ap.add_argument("--kernel", action="append", default=None,
                    help="prove only the named entry (repeatable)")
    ap.add_argument("--report", default=None,
                    help="write the per-entry bound report as JSON")
    ap.add_argument("--list", action="store_true",
                    help="list the registered entries and exit")
    ap.add_argument("--negative", default=None, metavar="NAME",
                    help="check one broken toy kernel (or `list`); exits "
                         "non-zero with its diagnostics")
    ap.add_argument("--exactness", action="store_true",
                    help="the exact-float leg: THEOREM / VACUOUS / FAIL per "
                         "entry, and every f32-* negative rejected")
    ap.add_argument("--schedule", action="store_true",
                    help="scalar-schedule theorem leg: certify every schedule "
                         "target (the fast set with --quick) and reject every "
                         "scalar-* negative")
    ap.add_argument("--host", action="store_true",
                    help="host lint: determinism, clock, sync and scalar "
                         "coverage rules")
    args = ap.parse_args(argv)

    from . import kernel_check, registry, scalar_check

    if args.negative:
        if args.negative == "list":
            for n in sorted(kernel_check.NEGATIVES) + sorted(scalar_check.NEGATIVES):
                print(n)
            return 0
        if args.negative in scalar_check.NEGATIVES:
            rep = scalar_check.analyze_negative(args.negative)
        else:
            rep = kernel_check.analyze_negative(args.negative)
        print(f"negative toy `{args.negative}`: "
              f"{'FAILED the gate (expected)' if not rep.ok else 'PROVED CLEAN (gate is dead!)'}")
        for v in rep.violations:
            print(f"  {v.kind:10s} {v.where}")
            print(f"             {v.msg}")
        return 1 if not rep.ok else 0

    if args.list:
        for s in registry.all_kernels() + registry.all_schedules():
            print(f"{s.name:32s} {'heavy' if s.heavy else ''}")
        return 0

    if args.host:
        return _host()
    if args.schedule:
        return _schedule(args, registry, scalar_check)

    if args.kernel:
        specs = [registry.get_kernel(n) for n in args.kernel]
    else:
        specs = registry.all_kernels(include_heavy=not args.quick)
    if args.exactness:
        return _exactness(specs, kernel_check, args.report)

    print("== kernel interval prover + launch contracts ==")
    all_ok = True
    reports = []
    for spec in specs:
        t0 = time.perf_counter()
        rep = spec.analyze()
        dt = time.perf_counter() - t0
        extra = ""
        if rep.grid is not None:
            extra = f" grid={tuple(rep.grid)} smem={rep.smem_peak_bytes}B"
        print(f"  {spec.name:32s} {'PROVEN' if rep.ok else 'FAIL'}  "
              f"nodes={rep.n_nodes} max|v|={rep.max_observed}{extra}  ({dt:.1f}s)",
              flush=True)
        for v in rep.violations[:12]:
            print(f"      {v.kind:10s} {v.where}")
            print(f"                 {v.msg}")
        if len(rep.violations) > 12:
            print(f"      ... {len(rep.violations) - 12} more")
        all_ok = all_ok and rep.ok
        d = rep.to_dict()
        d["seconds"] = round(dt, 3)
        if spec.note:
            d["note"] = spec.note
        reports.append(d)

    if args.report:
        with open(args.report, "w") as fh:
            json.dump({"kernels": reports}, fh, indent=2, sort_keys=True)
        print(f"\nreport written to {args.report}")
    peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    print(f"\nkernel lint: {'OK' if all_ok else 'FAILED'}  (peak RSS {peak_mb} MB)")
    return 0 if all_ok else 1


def _host() -> int:
    import os

    from . import host_lint

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print("== host lint (core/, models/; clock rule over crypto/, parallel/, "
          "resilience/, serving/ and cell/; sync rule over "
          "crypto/torch_backend.py, parallel/mesh.py, resilience/inflight.py, "
          "serving/ingress.py and models/sigstore.py) ==")
    findings = host_lint.lint_consensus_host(repo)
    print("\n== scalar-recoder coverage (ops/, crypto/glv.py, "
          "csrc/verify_tiles.cu) ==")
    findings += host_lint.lint_scalar_recoders(repo)
    print("\n== kernel region coverage (csrc/*.cu, the launchers bound in ops/) ==")
    findings += host_lint.lint_kernel_regions(repo)
    for f in findings:
        print(f"  {f}")
    print(f"\nhost lint: {len(findings)} findings")
    return 1 if findings else 0


def _schedule(args, registry, scalar_check) -> int:
    if args.kernel:
        specs = [registry.get_schedule(n) for n in args.kernel]
    else:
        specs = registry.all_schedules(include_heavy=not args.quick)
    print("== scalar-schedule theorems (bit slices, carry automaton, GLV, "
          "weight ledger) ==")
    ok = True
    sections = []
    for spec in specs:
        t0 = time.perf_counter()
        cert = spec.certify(quick=args.quick)
        dt = time.perf_counter() - t0
        scalar_check.emit_certificates([cert])
        print(f"  {spec.name:32s} {cert.status}  facts={len(cert.facts)}  "
              f"({dt:.1f}s)", flush=True)
        for f in cert.failures[:8]:
            print(f"      {f}")
        d = cert.to_dict()
        d["seconds"] = round(dt, 2)
        sections.append(d)
        ok = ok and cert.ok
    print("\n== sound toy schedule must PASS (checker liveness) ==")
    cert = scalar_check.toy_ladder_selftest()
    print(f"  {'toy-ladder-selftest':32s} {cert.status}")
    for f in cert.failures[:8]:
        print(f"      {f}")
    sections.append({"name": "selftest.toy_ladder", "status": cert.status,
                     "ok": cert.ok})
    ok = ok and cert.ok
    print("\n== unsound scalar toys must be rejected ==")
    for name in sorted(scalar_check.NEGATIVES):
        rep = scalar_check.analyze_negative(name)
        rejected = not rep.ok and any(v.kind == "schedule" for v in rep.violations)
        print(f"  {name:32s} "
              f"{'REJECTED (expected)' if rejected else 'NOT REJECTED (gate is dead!)'}")
        sections.append({"name": f"negative.{name}", "rejected": rejected})
        ok = ok and rejected
    if args.report:
        with open(args.report, "w") as fh:
            json.dump({"schedule": sections}, fh, indent=2, sort_keys=True,
                      default=str)
        print(f"\nreport written to {args.report}")
    print(f"\nschedule theorems: {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


def _exactness(specs, kernel_check, report_path: Optional[str]) -> int:
    print("== exact-float leg ==")
    ok = True
    out = {"kernels": [], "negatives": []}
    for spec in specs:
        rep = spec.analyze()
        floats = [v for v in rep.violations if v.kind == "float"]
        status = "FAIL" if floats else ("THEOREM" if rep.n_float else "VACUOUS")
        ok = ok and not floats
        print(f"  {spec.name:32s} {status}  float values={rep.n_float}", flush=True)
        for v in floats[:6]:
            print(f"      {v.where}\n                 {v.msg}")
        out["kernels"].append({"kernel": spec.name, "status": status,
                               "n_float": rep.n_float,
                               "exactness": rep.exactness})
    for name in sorted(n for n in kernel_check.NEGATIVES if n.startswith("f32-")):
        rep = kernel_check.analyze_negative(name)
        rejected = not rep.ok and any(v.kind == "float" for v in rep.violations)
        ok = ok and rejected
        print(f"  negative {name:32s} {'REJECTED' if rejected else 'NOT REJECTED'}",
              flush=True)
        out["negatives"].append({"negative": name, "rejected": rejected,
                                 "violations": [str(v) for v in rep.violations]})
    if report_path:
        with open(report_path, "w") as fh:
            json.dump(out, fh, indent=2, sort_keys=True)
        print(f"\nreport written to {report_path}")
    print(f"\nexact-float leg: {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
