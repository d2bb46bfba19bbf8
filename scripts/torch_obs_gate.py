"""chip_smoke's `[obs]` turns, run many times on the card with host readings
beside every call: the port's telemetry gate examined on its own.

`[obs]` times the main path (one `verify_batch` over 10,000 inputs) and the
config-5 block with telemetry armed (a JSONL span sink, phase timelines on)
and disarmed, in turns (off, on, on, off), and fails when the armed median
lies beyond the disarmed range by more than the disarmed spread. This
script runs the same calls `--rounds` times a path and records, for each
call: its wall time, the process's CPU time, its voluntary and involuntary
context switches, the collections of the cyclic collector, the sink's write
time, and the machine's CPU shares over the call from /proc/stat (busy,
steal, iowait), which say whether the host was busy with other work where
a container's /proc/stat moves (on the H100 machine it reads 0). It then
evaluates the gate on every window of the turns `[obs]` took before it ran
6 rounds a path (2 rounds of the main path, 4 of the block) and on all the
rounds together, and runs chip_smoke's own `_obs_phase` `--repeats` times,
counting how often it fails.

Needs a CUDA device; run from the repository's root:

    python3 scripts/torch_obs_gate.py --rounds 12 --repeats 3 --out build/obs_gate.json

Prints one `[obs_gate]` line a path and window summary, and the whole
record as JSON into `--out`.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as CS  # noqa: E402


def _cpu_stat():
    """The machine's (busy, steal, iowait, total) jiffies from /proc/stat."""
    with open("/proc/stat", encoding="ascii") as fh:
        f = [int(x) for x in fh.readline().split()[1:]]
    user, nice, system, idle, iowait, irq, softirq = f[:7]
    steal = f[7] if len(f) > 7 else 0
    total = sum(f[:8])
    return user + nice + system + irq + softirq, steal, iowait, total


def _measured(fn, sink_timer=None):
    """fn() with the host readings around it."""
    collections = [0]

    def on_gc(phase, info):
        if phase == "start":
            collections[0] += 1

    gc.callbacks.append(on_gc)
    ru0, st0 = resource.getrusage(resource.RUSAGE_SELF), _cpu_stat()
    c0, t0 = time.process_time(), time.perf_counter()
    try:
        fn()
    finally:
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        ru1, st1 = resource.getrusage(resource.RUSAGE_SELF), _cpu_stat()
        gc.callbacks.remove(on_gc)
    d = [b - a for a, b in zip(st0, st1)]
    tot = max(d[3], 1)
    return dict(s=round(wall, 5), cpu_s=round(cpu, 4),
                vcsw=ru1.ru_nvcsw - ru0.ru_nvcsw, ivcsw=ru1.ru_nivcsw - ru0.ru_nivcsw,
                gc=collections[0], host_busy=round(d[0] / tot, 4),
                host_steal=round(d[1] / tot, 4), host_iowait=round(d[2] / tot, 4),
                sink_ms=None if sink_timer is None else round(sink_timer.seconds * 1e3, 3))


def _gate(calls):
    """chip_smoke `[obs]`'s rule over a list of calls: (held, armed median,
    disarmed min, max, spread)."""
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    off = [c["s"] for c in calls if not c["armed"]]
    on = [c["s"] for c in calls if c["armed"]]
    spread = max(off) - min(off)
    return med(on) <= max(off) + spread, med(on), min(off), max(off), spread


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--out", default=os.path.join(HERE, "build", "obs_gate.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    CS._import_port()
    from concurrent.futures import ThreadPoolExecutor

    from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch
    from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
    from bitcoinconsensus_tpu_torch.obs import JsonlSink, add_sink, perf, remove_sink
    from bitcoinconsensus_tpu_torch.ops import _build
    from bitcoinconsensus_tpu_torch.utils import blockgen

    device = torch.device("cuda:0")
    card = CS._nvidia_smi()
    CS._line("card", nvidia_smi=json.dumps(card), cpus=os.cpu_count())
    sources = ("verify_tiles", "verdict_checksum", _build.HOST_CORE)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))

    def sync():
        torch.cuda.synchronize(device)

    items, _corrupted = blockgen.mixed_items(10_000, seed=args.seed, corrupt_rate=0.01)
    results = verify_batch(items, verifier=TorchSecpVerifier(device=device),
                           sig_cache=SigCache(), script_cache=ScriptExecutionCache())
    block_run = CS._block(device, sync, lambda path, fn: fn(), False)
    connect, _block_want, block_cfg = block_run[:3]
    paths = {
        "main_path": ({}, lambda v: verify_batch(
            items, verifier=v, sig_cache=SigCache(), script_cache=ScriptExecutionCache()),
            2),
        "block": (block_cfg, connect, 4),
    }
    out_dir = os.path.join(HERE, "build", "obs")
    os.makedirs(out_dir, exist_ok=True)
    record = {"card": card, "paths": {}}
    for path, (cfg, run, window) in paths.items():
        v = TorchSecpVerifier(device=device, **cfg)
        perf.set_enabled(False)
        run(v)
        sync()
        perf.set_enabled(True)
        calls = []
        for _ in range(args.rounds):
            for armed in (False, True, True, False):
                sink = None
                perf.set_enabled(armed)
                if armed:
                    spans_path = os.path.join(out_dir, f"gate_{path}.jsonl")
                    if os.path.exists(spans_path):
                        os.remove(spans_path)
                    sink = CS._TimedSink(JsonlSink(spans_path))
                    add_sink(sink)
                try:
                    got = _measured(lambda: (run(v), sync()), sink)
                finally:
                    perf.set_enabled(True)
                    if sink is not None:
                        remove_sink(sink)
                        sink.sink.close()
                calls.append(dict(armed=armed, **got))
        windows = []
        for k in range(0, args.rounds - window + 1, window):
            held, m_on, lo, hi, spread = _gate(calls[4 * k:4 * (k + window)])
            windows.append(dict(first_round=k, held=held, armed_median_s=m_on,
                                disarmed_min_s=lo, disarmed_max_s=hi, spread_s=spread))
        held, m_on, lo, hi, spread = _gate(calls)
        slow = sorted(calls, key=lambda c: -c["s"])[:4]
        CS._line("obs_gate", path=path, rounds=args.rounds, calls=len(calls),
                 windows=len(windows), windows_failed=sum(not w["held"] for w in windows),
                 all_rounds_held=held, armed_median_s=f"{m_on:.4f}",
                 disarmed_range_s=f"{lo:.4f}-{hi:.4f}", spread_s=f"{spread:.4f}",
                 armed_s=json.dumps([c["s"] for c in calls if c["armed"]]),
                 disarmed_s=json.dumps([c["s"] for c in calls if not c["armed"]]),
                 gc_collections=sum(c["gc"] for c in calls),
                 slowest=json.dumps(slow))
        record["paths"][path] = dict(calls=calls, windows=windows)
    # chip_smoke's own phase, as the script runs it.
    fails = 0
    for _ in range(args.repeats):
        try:
            CS._obs_phase(items, results, block_run, device, sync)
        except SystemExit:
            fails += 1
    CS._line("obs_gate", phase_runs=args.repeats, phase_failed=fails)
    record["phase"] = dict(runs=args.repeats, failed=fails)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
