"""Historical-replay harness: mainnet-shaped streams through the pipeline.

A copy of `bitcoinconsensus_tpu/workloads/replay.py` on the port's drivers.
A deterministic, seed-driven generator of realistic multi-block workloads
— mixed script types at mainnet-like ratios (`utils/blockgen.DEFAULT_MIX`,
the one definition of the mix), duplicate signers, mempool→block
re-verification (the cache-warm pattern production replay actually
exhibits), varying batch fill and a sprinkle of invalid spends — plus
drivers that push the stream end-to-end through each serving surface and
assert the fail-closed contract:

- `run_replay` — `verify_batch_stream` (the pipelined batch driver),
  every verdict compared bit-identically against the independent
  pure-Python host oracle, and the mempool→block overlap must actually
  warm the script/sig caches.
- `run_replay_serving` — the full path: per-tenant client threads in
  bursts through `VerifyServer` (mode="serve") or over a real socket
  through `IngressServer`/`IngressClient` (mode="ingress"). Every
  submission ends in exactly one explicit outcome: a settled verdict
  (oracle-checked) or an `OverloadError` shed; with `overload=True`
  the config is tightened until sheds actually happen — and they must
  all be explicit.
- `run_replay_cell` — the same traffic through a `ServingCell` of stub
  replicas behind its router.

Each runs on one device: `device=None` is cuda:0 (raising without CUDA),
`device="cpu"` the plain torch version. Where a `DispatchFailed` fails a
burst (the port has no host rung to land it on), its requests count as
explicit failures in `errors`: never settled, never a silent drop, and
`all_accounted` is then false. Never imported by the production verify
path.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Optional, Tuple

from ..core.flags import VERIFY_ALL_EXTENDED
from ..models.batch import BatchItem, verify_batch_stream
from ..models.sigcache import ScriptExecutionCache, SigCache
from ..utils import blockgen
from ..utils.blockgen import DEFAULT_MIX, _pick_kind

__all__ = [
    "ReplayConfig",
    "ReplayBlock",
    "generate_stream",
    "run_replay",
    "run_replay_cell",
    "run_replay_serving",
]

@dataclass
class ReplayConfig:
    seed: int = 0
    n_blocks: int = 4
    txs_per_block: int = 6          # mean; actual fill varies ±50% per block
    max_inputs: int = 3
    mix: Tuple[Tuple[str, float], ...] = DEFAULT_MIX
    dup_signer_rate: float = 0.35   # P(reuse an already-seen wallet)
    mempool_fraction: float = 0.5   # share of a block pre-verified "in mempool"
    invalid_rate: float = 0.15      # P(one corrupted input in a tx)
    tenants: int = 3


@dataclass
class ReplayBlock:
    """One block's worth of verification traffic: the mempool batch
    (arrivals verified ahead of the block) and the block batch (every
    input re-verified at connect time — the overlap is the cache-warm
    pattern)."""

    height: int
    mempool_items: List[BatchItem]
    block_items: List[BatchItem]
    expected_ok: List[bool] = field(default_factory=list)  # per block item
    n_txs: int = 0


def generate_stream(cfg: ReplayConfig) -> List[ReplayBlock]:
    """Deterministic multi-block stream from `cfg.seed` (same seed, same
    bytes — the chaos sweep and CI replays depend on it)."""
    rng = random.Random(cfg.seed)
    pool: Dict[str, List[blockgen.Wallet]] = {k: [] for k, _ in cfg.mix}
    blocks: List[ReplayBlock] = []

    def wallet(kind: str) -> blockgen.Wallet:
        seen = pool[kind]
        if seen and rng.random() < cfg.dup_signer_rate:
            return rng.choice(seen)  # duplicate signer
        w = blockgen.Wallet(f"replay/{cfg.seed}/{kind}/{len(seen)}", kind)
        seen.append(w)
        return w

    for b in range(cfg.n_blocks):
        lo = max(1, cfg.txs_per_block // 2)
        n_txs = rng.randint(lo, cfg.txs_per_block + cfg.txs_per_block // 2)
        block_items: List[BatchItem] = []
        expected: List[bool] = []
        mempool_cut: List[int] = []
        for t in range(n_txs):
            n_in = rng.randint(1, cfg.max_inputs)
            funded = []
            for i in range(n_in):
                w = wallet(_pick_kind(rng, cfg.mix))
                op = blockgen.OutPoint(
                    blockgen.hashlib.sha256(
                        f"replay/{cfg.seed}/{b}/{t}/{i}".encode()
                    ).digest(),
                    i,
                )
                amount = rng.randrange(10_000, 1_000_000)
                funded.append(blockgen.FundedOutput(op, w, amount))
            corrupt = (
                rng.randrange(n_in) if rng.random() < cfg.invalid_rate else None
            )
            tx = blockgen.build_spend_tx(funded, corrupt_input=corrupt)
            raw = tx.serialize()
            outs = [(f.amount, f.wallet.spk) for f in funded]
            start = len(block_items)
            for i in range(n_in):
                block_items.append(
                    BatchItem(raw, i, VERIFY_ALL_EXTENDED, spent_outputs=outs)
                )
                expected.append(corrupt is None or i != corrupt)
            if rng.random() < cfg.mempool_fraction:
                mempool_cut.extend(range(start, len(block_items)))
        blocks.append(
            ReplayBlock(
                height=100 + b,
                mempool_items=[block_items[i] for i in mempool_cut],
                block_items=block_items,
                expected_ok=expected,
                n_txs=n_txs,
            )
        )
    return blocks


# Below this many items the oracle runs in the caller's process: a spawned
# worker takes seconds to import the port, about a thousand verdicts' time.
ORACLE_PARALLEL_MIN = 2048


def oracle_workers(n_items: int) -> int:
    """How many processes `_oracle` spreads `n_items` over: 1 below
    `ORACLE_PARALLEL_MIN`, else one a spare CPU, at most 7."""
    if n_items < ORACLE_PARALLEL_MIN:
        return 1
    return max(1, min(7, (os.cpu_count() or 2) - 1))


def _oracle(items: List[BatchItem]) -> List[Tuple[bool, str, Optional[str]]]:
    """Independent per-item host oracle (pure-Python engine; no caches,
    no device, no batching) — the bit-identity reference. A large list
    is spread over `oracle_workers(len(items))` spawned processes (each
    imports the port, none touches a device), all stopped before this
    returns; spawn re-imports the caller's `__main__`, so a script that
    replays at that size guards its entry point."""
    from .diff_fuzz import python_verdict

    workers = oracle_workers(len(items))
    if workers <= 1:
        return [python_verdict(it) for it in items]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(python_verdict, items,
                             chunksize=max(1, len(items) // (4 * workers))))


def _triple(r) -> Tuple[bool, str, Optional[str]]:
    from ..core.script_error import ScriptError

    serr = (
        r.script_error.name
        if r.script_error is not None and r.script_error != ScriptError.OK
        else None
    )
    return (r.ok, r.error.name, serr if not r.ok else None)


def _norm(t: Tuple[bool, str, Optional[str]]) -> Tuple[bool, str, Optional[str]]:
    ok, err, serr = t
    return (ok, err, serr if not ok else None)


def run_replay(cfg: ReplayConfig, depth: int = 2, device=None,
               verifier=None) -> dict:
    """Drive the generated stream through `verify_batch_stream` against
    fresh caches, on `verifier` or a new one on `device` (None: cuda:0);
    returns a report with divergence and cache-warm counts (both hard
    gauntlet criteria). The host oracle judges each distinct item once
    (a mempool item is its block's item)."""
    from . import (
        GAUNTLET_DIVERGENCE,
        GAUNTLET_REPLAY_BLOCKS,
        resolve_verifier,
    )

    verifier = resolve_verifier(device, verifier)

    t0 = perf_counter()
    blocks = generate_stream(cfg)
    generate_s = perf_counter() - t0
    # Mempool validation runs ahead of block connection (as on mainnet);
    # the lag must exceed the stream pipeline depth or the block batch's
    # cache probe races the mempool batch's insert and the warm-up the
    # harness is asserting never materialises.
    lag = depth + 1
    batches: List[List[BatchItem]] = []
    expect_hits = 0
    for i in range(len(blocks) + lag):
        if i < len(blocks) and blocks[i].mempool_items:
            batches.append(blocks[i].mempool_items)
        if i >= lag:
            blk = blocks[i - lag]
            batches.append(blk.block_items)
            if blk.mempool_items:
                ok_idx = {
                    j for j, ok in enumerate(blk.expected_ok) if ok
                }
                expect_hits += sum(
                    1
                    for j, it in enumerate(blk.block_items)
                    if it in blk.mempool_items and j in ok_idx
                )

    sig_cache, script_cache = SigCache(), ScriptExecutionCache()
    t0 = perf_counter()
    results = list(
        verify_batch_stream(
            batches, verifier=verifier, sig_cache=sig_cache,
            script_cache=script_cache, depth=depth,
        )
    )
    stream_s = perf_counter() - t0

    t0 = perf_counter()
    distinct = {id(it): it for batch in batches for it in batch}
    judged = dict(zip(distinct, _oracle(list(distinct.values()))))
    oracle_s = perf_counter() - t0
    divergences: List[dict] = []
    n_items = 0
    for batch, res in zip(batches, results, strict=True):
        oracle = [judged[id(it)] for it in batch]
        n_items += len(batch)
        for j, (r, want) in enumerate(zip(res, oracle, strict=True)):
            if _triple(r) != _norm(want):
                divergences.append(
                    {"batch_item": j, "got": _triple(r), "want": _norm(want)}
                )
    # Unconditional (a zero sample is the "leg ran, no divergence" fact
    # the stats gate wants to see, not just the absence of a counter).
    GAUNTLET_DIVERGENCE.inc(len(divergences), leg="replay")
    GAUNTLET_REPLAY_BLOCKS.inc(len(blocks))

    # Cache warm-up: every VALID mempool item re-verifies inside its
    # block batch (the cache is success-only, so invalid overlap can
    # never hit), so the script cache MUST have taken at least that many
    # hits. Fewer means the mempool→block skip path silently died.
    return {
        "device": str(verifier.device),
        "blocks": len(blocks),
        "batches": len(batches),
        "items": n_items,
        "txs": sum(b.n_txs for b in blocks),
        "mempool_overlap_items": sum(len(b.mempool_items) for b in blocks),
        "expected_warm_hits": expect_hits,
        "script_cache_hits": script_cache.hits,
        "sig_cache_hits": sig_cache.hits,
        "warmed": script_cache.hits >= expect_hits > 0,
        "generate_s": generate_s,
        "stream_s": stream_s,
        "oracle_s": oracle_s,
        "oracle_workers": oracle_workers(len(distinct)),
        "divergences": divergences,
        "bit_identical": not divergences,
    }


def run_replay_serving(
    cfg: ReplayConfig,
    mode: str = "serve",
    overload: bool = False,
    timeout_s: float = 120.0,
    device=None,
    verifier=None,
    slo_deadline_s: Optional[float] = None,
) -> dict:
    """The full serving path: per-tenant threads submit the stream in
    bursts. Every submission must end settled-and-oracle-identical or
    explicitly shed — hangs, silent drops and mystery exceptions
    (a `DispatchFailed` among them) all count as failures. With
    `overload=True` the server is configured so sheds MUST happen (tiny
    tenant depth, no size flush). The server runs on `verifier` or a new
    one on `device` (None: cuda:0); `slo_deadline_s` is its admission SLO
    (a CPU batch takes seconds, longer than the default)."""
    assert mode in ("serve", "ingress")
    from ..serving import (
        IngressClient,
        IngressServer,
        OverloadError,
        VerifyServer,
    )
    from . import GAUNTLET_DIVERGENCE, resolve_verifier

    verifier = resolve_verifier(device, verifier)

    blocks = generate_stream(cfg)
    items: List[BatchItem] = [
        it for blk in blocks for it in blk.block_items
    ]
    oracle = [_norm(t) for t in _oracle(items)]

    if overload:
        server_kw = dict(max_batch=256, flush_s=0.05, tenant_depth=1)
    else:
        server_kw = dict(max_batch=16, flush_s=0.005, tenant_depth=256)

    lanes = [(i, it) for i, it in enumerate(items)]
    per_tenant: List[List[Tuple[int, BatchItem]]] = [
        lanes[t :: cfg.tenants] for t in range(cfg.tenants)
    ]

    settled: Dict[int, Tuple[bool, str, Optional[str]]] = {}
    sheds: List[int] = []
    errors: List[str] = []
    lock = threading.Lock()

    def tenant_worker(t: int, submit) -> None:
        rng = random.Random((cfg.seed << 8) | t)
        work = per_tenant[t]
        pos = 0
        while pos < len(work):
            burst = work[pos : pos + rng.randint(1, 4)]  # bursty arrival
            pos += len(burst)
            pendings = []
            for idx, it in burst:
                try:
                    pendings.append((idx, submit(it, f"tenant{t}")))
                except OverloadError:
                    with lock:
                        sheds.append(idx)
                except Exception as e:  # noqa: BLE001 — trial accounting
                    with lock:
                        errors.append(f"submit[{idx}]: {e!r}")
            for idx, pend in pendings:
                try:
                    res = pend.result(timeout=timeout_s) if pend is not None else None
                    with lock:
                        settled[idx] = _triple(res)
                except Exception as e:  # noqa: BLE001
                    with lock:
                        errors.append(f"settle[{idx}]: {e!r}")

    srv = VerifyServer(
        verifier=verifier, sig_cache=SigCache(),
        script_cache=ScriptExecutionCache(), slo_deadline_s=slo_deadline_s,
        **server_kw,
    ).start()
    ingress = None
    clients: List[IngressClient] = []
    try:
        if mode == "ingress":
            ingress = IngressServer(srv, idle_s=timeout_s).start()

            def make_submit():
                cli = IngressClient(port=ingress.port, timeout_s=timeout_s)
                clients.append(cli)

                def submit(it, tenant):
                    # Socket path is synchronous: settle inline, return a
                    # pre-resolved pending so the worker's settle loop is
                    # uniform across modes.
                    res = cli.verify(it, tenant)

                    class _Done:
                        def result(self, timeout=None):
                            return res

                    return _Done()

                return submit

            submits = [make_submit() for _ in range(cfg.tenants)]
        else:
            submits = [srv.submit for _ in range(cfg.tenants)]

        threads = [
            threading.Thread(target=tenant_worker, args=(t, submits[t]))
            for t in range(cfg.tenants)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=timeout_s)
        hung = [th for th in threads if th.is_alive()]
    finally:
        for cli in clients:
            cli.close()
        if ingress is not None:
            ingress.close(drain=True)
        srv.close(drain=True)

    divergences = [
        {"item": idx, "got": got, "want": oracle[idx]}
        for idx, got in sorted(settled.items())
        if got != oracle[idx]
    ]
    GAUNTLET_DIVERGENCE.inc(len(divergences), leg="replay-serving")
    all_accounted = len(settled) + len(sheds) == len(items)
    return {
        "mode": mode,
        "device": str(verifier.device),
        "items": len(items),
        "settled": len(settled),
        "sheds": len(sheds),
        "errors": errors,
        "hung_threads": len(hung),
        "divergences": divergences,
        "bit_identical": not divergences,
        "all_accounted": all_accounted and not errors and not hung,
        "sheds_expected": overload,
        "sheds_happened": (len(sheds) > 0) if overload else True,
        "sheds_explicit_only": all_accounted,
    }


def run_replay_cell(
    cfg: ReplayConfig,
    n_replicas: int = 2,
    timeout_s: float = 120.0,
    device=None,
    slo_deadline_s: Optional[float] = None,
) -> dict:
    """The cell path: the same bursty multi-tenant stream, but through
    the `CellRouter` fronting `n_replicas` replica stacks (in-process
    stubs, each with its own verifier on `device`, None being cuda:0 —
    the gauntlet leg proves routing + protocol end-to-end; chip_smoke's
    `[cell]` owns the subprocess kill trials). The criteria are
    `run_replay_serving`'s: every submission settles oracle-identical
    or is explicitly shed; hangs and silent drops are failures."""
    from ..cell import ServingCell
    from ..serving import OverloadError
    from ..serving.client import IngressClient, verify_with_retry
    from . import GAUNTLET_DIVERGENCE

    blocks = generate_stream(cfg)
    items: List[BatchItem] = [
        it for blk in blocks for it in blk.block_items
    ]
    oracle = [_norm(t) for t in _oracle(items)]

    lanes = [(i, it) for i, it in enumerate(items)]
    per_tenant: List[List[Tuple[int, BatchItem]]] = [
        lanes[t :: cfg.tenants] for t in range(cfg.tenants)
    ]

    settled: Dict[int, Tuple[bool, str, Optional[str]]] = {}
    sheds: List[int] = []
    errors: List[str] = []
    lock = threading.Lock()

    def tenant_worker(t: int, port: int) -> None:
        rng = random.Random((cfg.seed << 8) | t)
        cli = IngressClient(port=port, timeout_s=timeout_s)
        try:
            for idx, it in per_tenant[t]:
                try:
                    res = verify_with_retry(
                        cli, it, tenant=f"tenant{t}", retries=4, rng=rng
                    )
                    with lock:
                        settled[idx] = _triple(res)
                except OverloadError:
                    with lock:
                        sheds.append(idx)
                except Exception as e:  # noqa: BLE001 — trial accounting
                    with lock:
                        errors.append(f"cell[{idx}]: {e!r}")
        finally:
            cli.close()

    server_kw = dict(max_batch=16, flush_s=0.005, tenant_depth=256)
    if slo_deadline_s is not None:
        server_kw["slo_deadline_s"] = slo_deadline_s
    cell = ServingCell(
        n_replicas=n_replicas,
        stub=True,
        server_kw=server_kw,
        device=device,
    ).start()
    try:
        threads = [
            threading.Thread(target=tenant_worker, args=(t, cell.port))
            for t in range(cfg.tenants)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=timeout_s)
        hung = [th for th in threads if th.is_alive()]
    finally:
        cell.close()

    divergences = [
        {"item": idx, "got": got, "want": oracle[idx]}
        for idx, got in sorted(settled.items())
        if got != oracle[idx]
    ]
    GAUNTLET_DIVERGENCE.inc(len(divergences), leg="replay-cell")
    all_accounted = len(settled) + len(sheds) == len(items)
    return {
        "mode": "cell",
        "replicas": n_replicas,
        "device": cell.device,
        "items": len(items),
        "settled": len(settled),
        "sheds": len(sheds),
        "errors": errors,
        "hung_threads": len(hung),
        "divergences": divergences,
        "bit_identical": not divergences,
        "all_accounted": all_accounted and not errors and not hung,
        "sheds_explicit_only": all_accounted,
    }
