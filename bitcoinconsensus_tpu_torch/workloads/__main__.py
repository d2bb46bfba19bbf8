"""Adversarial workload gauntlet: replay, corpus pins, differential fuzz.

The port's counterpart of `scripts/consensus_gauntlet.py`, with the
gauntlet fault sweep of `scripts/consensus_chaos.py --gauntlet` as
`--chaos`. Three legs, all deterministic from `--seed`, every batch on one
`TorchSecpVerifier` on `--device` (cuda:0 by default: each dispatch
launches `verify_tiles` and the verdict checksum kernel):

    replay   mainnet-shaped multi-block streams (mixed script types,
             duplicate signers, mempool→block re-verification, bursty
             tenants) through `verify_batch_stream`, a live VerifyServer
             and the socket ingress — every verdict bit-identical to the
             independent host oracle, the mempool→block overlap must
             actually warm the script cache, and overload sheds only
             explicitly.
    cell     the same traffic through a two-stub-replica ServingCell.
    corpus   every pinned worst-case entry (workloads/corpus.py) on every
             engine — python, native C++, batch/device — must reproduce
             its pinned (ok, Error, ScriptError) verdict.
    fuzz     seed-driven mutation of corpus entries through the same
             engines, fail-closed on any disagreement. CI seeds live in
             fuzz/gauntlet_seeds.json (read-only) so failures replay
             exactly.

Usage:
    python -m bitcoinconsensus_tpu_torch.workloads                  # all legs, small
    python -m bitcoinconsensus_tpu_torch.workloads --replay         # one leg
    python -m bitcoinconsensus_tpu_torch.workloads --corpus
    python -m bitcoinconsensus_tpu_torch.workloads --fuzz 500
    python -m bitcoinconsensus_tpu_torch.workloads --chaos          # fault sweep
    python -m bitcoinconsensus_tpu_torch.workloads --check          # gate
    python -m bitcoinconsensus_tpu_torch.workloads --report out.json
    python -m bitcoinconsensus_tpu_torch.workloads --device cpu     # plain torch

Without CUDA and without `--device cpu` it exits 2 before any work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SEEDS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "fuzz",
    "gauntlet_seeds.json",
)

# A batch of the plain torch version takes seconds on the CPU, longer than
# the server's default admission SLO: CPU runs serve with this one.
CPU_SLO_S = 600.0


def ci_fuzz_seeds() -> list:
    """The checked-in seed set (fuzz/gauntlet_seeds.json) — fixed so a CI
    failure reproduces exactly from the artifact alone."""
    with open(SEEDS_PATH, encoding="utf-8") as fh:
        return json.load(fh)["seeds"]


def _slo(verifier):
    return CPU_SLO_S if verifier.device.type == "cpu" else None


def run_replay_leg(verifier, seed: int, blocks: int, txs: int) -> dict:
    from . import ReplayConfig, run_replay, run_replay_serving

    cfg = ReplayConfig(seed=seed, n_blocks=blocks, txs_per_block=txs)
    stream = run_replay(cfg, verifier=verifier)
    small = ReplayConfig(seed=seed + 1, n_blocks=2, txs_per_block=3)
    kw = dict(verifier=verifier, slo_deadline_s=_slo(verifier))
    serve = run_replay_serving(small, mode="serve", **kw)
    shed = run_replay_serving(small, mode="serve", overload=True, **kw)
    ingress = run_replay_serving(small, mode="ingress", **kw)
    ok = all(
        (
            stream["bit_identical"],
            stream["warmed"],
            serve["bit_identical"],
            serve["all_accounted"],
            shed["bit_identical"],
            shed["all_accounted"],
            shed["sheds_happened"],
            ingress["bit_identical"],
            ingress["all_accounted"],
        )
    )
    return {
        "ok": ok,
        "stream": stream,
        "serving": serve,
        "overload": shed,
        "ingress": ingress,
    }


def run_cell_leg(verifier, seed: int) -> dict:
    from . import ReplayConfig, run_replay_cell

    small = ReplayConfig(seed=seed + 2, n_blocks=2, txs_per_block=3)
    cell = run_replay_cell(small, n_replicas=2, device=str(verifier.device),
                           slo_deadline_s=_slo(verifier))
    cell["ok"] = cell["bit_identical"] and cell["all_accounted"]
    return {"ok": cell["ok"], "cell": cell}


def run_corpus_leg(verifier) -> dict:
    from .corpus import run_corpus_check

    rep = run_corpus_check(verifier=verifier)
    rep["ok"] = rep["pinned"]
    return rep


def run_fuzz_leg(verifier, seeds, n_cases: int, ceil: bool = False) -> dict:
    """`n_cases` mutants split over `seeds` (at least `n_cases` in all
    with `ceil`, as the sweep's trial counts them)."""
    from . import run_diff_fuzz
    from .corpus import build_corpus

    corpus = build_corpus()
    per_seed = -(-n_cases // len(seeds)) if ceil else max(1, n_cases // len(seeds))
    runs = [run_diff_fuzz(seed=s, n_cases=per_seed, corpus=corpus,
                          verifier=verifier) for s in seeds]
    divergences = [d for r in runs for d in r["divergences"]]
    kinds: dict = {}
    for r in runs:
        for k, n in r["mutations"].items():
            kinds[k] = kinds.get(k, 0) + n
    return {
        "ok": not divergences,
        "seeds": list(seeds),
        "cases": sum(r["cases"] for r in runs),
        "engines": runs[0]["engines"],
        "native_available": runs[0]["native_available"],
        "mutations": dict(sorted(kinds.items())),
        "divergences": divergences,
    }


def _problems(report: dict) -> list:
    probs = []
    for leg, rep in report["legs"].items():
        if not rep["ok"]:
            probs.append(f"{leg}: leg failed")
        for sub in ("stream", "serving", "overload", "ingress", "cell"):
            r = rep.get(sub)
            if r is None:
                continue
            if not r.get("bit_identical", True):
                probs.append(f"{leg}.{sub}: diverged from host oracle")
            if r.get("warmed") is False:
                probs.append(f"{leg}.{sub}: mempool→block cache warm-up missing")
            if r.get("all_accounted") is False:
                probs.append(f"{leg}.{sub}: silent drop/hang (not all accounted)")
            if r.get("sheds_happened") is False:
                probs.append(f"{leg}.{sub}: overload never shed")
        for d in rep.get("mismatches", []):
            probs.append(
                f"corpus pin miss: {d['case']} [{d['engine']}] "
                f"want {d['want']} got {d['got']}"
            )
        for d in rep.get("divergences", []):
            probs.append(
                f"fuzz divergence: case {d['case']} ({d['origin']}, "
                f"{d['mutation']}): {d['verdicts']}"
            )
    return probs


# -- the gauntlet fault sweep (--chaos) ----------------------------------

# The sweep's hard criteria: a trial that carries one of these keys holds
# only where it is True (consensus_chaos.py's gauntlet keys).
HARD_KEYS = (
    "bit_identical", "fault_fired", "replay_warmed", "all_accounted",
    "sheds_explicit_only", "sheds_happened", "corpus_pinned",
    "fuzz_zero_divergence", "fuzz_cases_ok", "poison_caught_by_audit",
)


def _wrong_accepts(divergences) -> int:
    """Divergences where the port accepted what the host oracle rejects:
    `got`/`want` triples (replay, serving, corpus), or a fuzz case's
    engines against its Python verdict."""
    n = 0
    for d in divergences:
        if "verdicts" in d:
            v = d["verdicts"]
            n += any(e[0] for k, e in v.items() if k != "python") and not v["python"][0]
        else:
            n += bool(d["got"][0]) and not d["want"][0]
    return n


def _finish(trial: dict, inj, specs) -> dict:
    if specs:
        trial["fired"] = {
            f"{s}:{k}": c for (s, k), c in sorted(inj.fired.items())
        }
        trial["fault_fired"] = inj.total_fired() >= 1
    trial["held"] = all(trial[k] for k in HARD_KEYS if k in trial) and \
        trial["wrong_accepts"] == 0
    return trial


def _replay_trial(name, cfg, specs, seed, verifier, audit=False):
    """Mainnet-shaped replay stream with a fault armed: verdicts must stay
    bit-identical to the host oracle AND the mempool→block cache warm-up
    must still materialise — containment may cost retries, never
    correctness or the skip path."""
    from ..resilience import FaultPlan, inject, set_cache_audit
    from ..resilience.guards import CACHE_POISON_CAUGHT
    from . import run_replay

    caught0 = CACHE_POISON_CAUGHT.value(cache="sig")
    if audit:
        set_cache_audit(True)
    try:
        with inject(FaultPlan(specs), seed=seed) as inj:
            rep = run_replay(cfg, verifier=verifier)
    finally:
        if audit:
            set_cache_audit(False)
    trial = {
        "trial": name,
        "bit_identical": rep["bit_identical"],
        "replay_warmed": rep["warmed"],
        "blocks": rep["blocks"],
        "items": rep["items"],
        "script_cache_hits": rep["script_cache_hits"],
        "wrong_accepts": _wrong_accepts(rep["divergences"]),
    }
    if audit:
        trial["poison_caught_by_audit"] = (
            CACHE_POISON_CAUGHT.value(cache="sig") > caught0
        )
    return _finish(trial, inj, specs)


def _serving_trial(name, cfg, mode, specs, seed, verifier, overload=False):
    """Replay pushed through the live serving path (VerifyServer or the
    socket ingress) under an armed fault: every submission settles
    bit-identical or sheds explicitly — hangs and silent drops fail."""
    from ..resilience import FaultPlan, inject
    from . import run_replay_serving

    with inject(FaultPlan(specs), seed=seed) as inj:
        rep = run_replay_serving(cfg, mode=mode, overload=overload,
                                 verifier=verifier, slo_deadline_s=_slo(verifier))
    trial = {
        "trial": name,
        "bit_identical": rep["bit_identical"],
        "all_accounted": rep["all_accounted"],
        "sheds_explicit_only": rep["sheds_explicit_only"],
        "sheds_happened": rep["sheds_happened"],
        "settled": rep["settled"],
        "sheds": rep["sheds"],
        "errors": rep["errors"][:5],
        "wrong_accepts": _wrong_accepts(rep["divergences"]),
    }
    return _finish(trial, inj, specs)


def _corpus_trial(name, specs, seed, verifier):
    """All pinned adversarial corpus entries on every engine, optionally
    with a fault armed — the pins must hold either way."""
    from ..resilience import FaultPlan, inject
    from .corpus import run_corpus_check

    with inject(FaultPlan(specs), seed=seed) as inj:
        rep = run_corpus_check(verifier=verifier)
    trial = {
        "trial": name,
        "bit_identical": rep["pinned"],
        "corpus_pinned": rep["pinned"],
        "cases": rep["cases"],
        "native_available": rep["native_available"],
        "mismatches": rep["mismatches"][:5],
        "wrong_accepts": _wrong_accepts(rep["mismatches"]),
    }
    return _finish(trial, inj, specs)


def _fuzz_trial(min_cases, verifier):
    """Differential fuzz over the checked-in CI seed set: >= `min_cases`
    mutants through every engine, zero unexplained divergence."""
    rep = run_fuzz_leg(verifier, ci_fuzz_seeds(), min_cases, ceil=True)
    trial = {
        "trial": "gauntlet-diff-fuzz",
        "bit_identical": rep["ok"],
        "fuzz_zero_divergence": rep["ok"],
        "fuzz_cases_ok": rep["cases"] >= min_cases,
        "cases": rep["cases"],
        "seeds": rep["seeds"],
        "engines": rep["engines"],
        "divergences": rep["divergences"][:5],
        "wrong_accepts": _wrong_accepts(rep["divergences"]),
    }
    return _finish(trial, None, [])


def run_gauntlet_sweep(seed: int, fuzz_cases: int = 500, verifier=None,
                       device=None) -> dict:
    """The adversarial gauntlet under fault injection, on `verifier` or a
    new one on `device` (None: cuda:0): the replay stream end-to-end (batch
    stream, live server, socket ingress) under three distinct fault
    classes, corpus pins clean and under verdict corruption, and the
    >=500-case differential-fuzz leg. Ten trials; each carries `held`.
    The disarmed-hook overhead budget of the reference's sweep is
    chip_smoke's `[guards]` and `[obs]` phases, not repeated here."""
    from ..resilience import FaultSpec
    from . import ReplayConfig, resolve_verifier

    verifier = resolve_verifier(device, verifier)
    cfg = ReplayConfig(seed=seed, n_blocks=4, txs_per_block=4)
    small = ReplayConfig(seed=seed + 1, n_blocks=2, txs_per_block=3)
    v = verifier
    trials = [
        _replay_trial("gauntlet-replay-clean", cfg, [], seed, v),
        # Three fault classes against the same stream: device verdict
        # corruption, dispatch failure, cache poisoning (audit armed).
        _replay_trial(
            "gauntlet-replay-verdict-flip", cfg,
            [FaultSpec("torch_backend.verdict", "flip")], seed, v,
        ),
        _replay_trial(
            "gauntlet-replay-dispatch-raise", cfg,
            [FaultSpec("torch_backend.dispatch", "raise")], seed, v,
        ),
        # Persistent poison (count=64): a single fabricated hit can land
        # on a probe whose true answer is ACCEPT (harmless by luck);
        # firing across the stream guarantees some poisoned hits cover
        # the invalid spends, which audit mode MUST catch.
        _replay_trial(
            "gauntlet-replay-cache-poison", cfg,
            [FaultSpec("sigcache.sig", "poison", count=64)], seed, v,
            audit=True,
        ),
        # The same traffic through the full serving path under faults,
        # and a clean overload run that must shed explicitly.
        _serving_trial(
            "gauntlet-serve-dispatch-raise", small, "serve",
            [FaultSpec("torch_backend.dispatch", "raise")], seed, v,
        ),
        _serving_trial(
            "gauntlet-ingress-verdict-flip", small, "ingress",
            [FaultSpec("torch_backend.verdict", "flip")], seed, v,
        ),
        _serving_trial(
            "gauntlet-overload-explicit-sheds", small, "serve", [], seed, v,
            overload=True,
        ),
        _corpus_trial("gauntlet-corpus-pins", [], seed, v),
        _corpus_trial(
            "gauntlet-corpus-verdict-flip",
            [FaultSpec("torch_backend.verdict", "flip")], seed, v,
        ),
        _fuzz_trial(fuzz_cases, v),
    ]
    return {"seed": seed, "gauntlet": True, "device": str(verifier.device),
            "trials": trials}


def _sweep_problems(report: dict) -> list:
    probs = []
    for t in report["trials"]:
        for key in HARD_KEYS:
            if t.get(key) is False:
                probs.append(f"{t['trial']}: {key} is False")
        if t["wrong_accepts"]:
            probs.append(f"{t['trial']}: {t['wrong_accepts']} wrong ACCEPTs")
    return probs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replay", action="store_true", help="replay leg only")
    ap.add_argument("--cell", action="store_true",
                    help="cell leg only (replay through the serving-cell "
                    "router)")
    ap.add_argument("--corpus", action="store_true", help="corpus leg only")
    ap.add_argument("--fuzz", type=int, metavar="N", default=0,
                    help="fuzz leg only, with N mutated cases")
    ap.add_argument("--chaos", action="store_true",
                    help="the ten-trial gauntlet fault sweep instead of "
                    "the clean legs")
    ap.add_argument("--fuzz-cases", type=int, default=500,
                    help="minimum mutated cases of the sweep's fuzz trial "
                    "(default: 500)")
    ap.add_argument("--blocks", type=int, default=4,
                    help="replay blocks (default: 4)")
    ap.add_argument("--txs", type=int, default=4,
                    help="mean txs per replay block (default: 4)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (cuda:0, the default) or cpu (the plain "
                    "torch version)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any divergence, pin miss, missing "
                    "warm-up, non-explicit shed or trial not held")
    ap.add_argument("--report", metavar="PATH",
                    help="write the JSON gauntlet report to this path")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("FAIL: the gauntlet runs on cuda:0 but CUDA is not available; "
              "pass --device cpu to run the plain torch version on the CPU",
              file=sys.stderr)
        return 2
    from . import resolve_verifier

    verifier = resolve_verifier(None if args.device == "cuda" else "cpu")
    t0 = time.perf_counter()
    if args.chaos:
        report = run_gauntlet_sweep(args.seed, fuzz_cases=args.fuzz_cases,
                                    verifier=verifier)
        probs = _sweep_problems(report)
        what = f"{len(report['trials'])} trials"
    else:
        all_legs = not (args.replay or args.cell or args.corpus or args.fuzz)
        legs = {}
        if args.replay or all_legs:
            legs["replay"] = run_replay_leg(verifier, args.seed, args.blocks, args.txs)
        if args.cell or all_legs:
            legs["cell"] = run_cell_leg(verifier, args.seed)
        if args.corpus or all_legs:
            legs["corpus"] = run_corpus_leg(verifier)
        if args.fuzz or all_legs:
            legs["fuzz"] = run_fuzz_leg(verifier, ci_fuzz_seeds(), args.fuzz or 150)
        report = {"seed": args.seed, "device": str(verifier.device), "legs": legs}
        probs = _problems(report)
        what = f"{len(legs)} legs"
    report["wall_s"] = round(time.perf_counter() - t0, 3)
    report["problems"] = probs
    doc = json.dumps(report, indent=2)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            fh.write(doc + "\n")
    print(doc)
    print(f"# gauntlet: {what} in {report['wall_s']:.1f}s on "
          f"{report['device']}, {len(probs)} problems", file=sys.stderr)
    if args.check and probs:
        for p in probs:
            print(f"PROBLEM: {p}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
