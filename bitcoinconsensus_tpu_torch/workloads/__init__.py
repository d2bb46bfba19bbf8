"""Adversarial and mainnet-shaped workload generation (the gauntlet).

Port of `bitcoinconsensus_tpu/workloads/`. Three legs, all deterministic
from explicit seeds, every one ending in the port's `verify_batch` or
`verify_batch_stream`, so each dispatch launches the CUDA `verify_tiles`
and verdict checksum kernels on the card:

- ``corpus`` — constructed worst-case transactions (max-fan-out
  CHECKMULTISIG, max-size scripts, pre-BIP143 quadratic sighash,
  taproot script-path + annex, signature-malleation, boundary-flag and
  GLV/recoder scalar-edge cases), each with a pinned expected verdict.
- ``replay`` — seed-driven realistic multi-block streams (mainnet-like
  script-type mix, duplicate signers, mempool→block re-verification
  for cache-warm patterns, varying batch fill, bursty tenant arrival)
  driven end-to-end through the stream driver, the server, the socket
  ingress and the cell, asserted bit-identical against an independent
  host oracle.
- ``diff_fuzz`` — seed-driven mutation of corpus entries run through
  the pure-Python engine, the native C++ engine and the batch/device
  driver, fail-closed on any triple disagreement.

Every runner takes `device=None`, which means cuda:0 and raises without
CUDA, or `device="cpu"` (the plain torch version), and builds one
`TorchSecpVerifier` there (or takes the caller's `verifier=`) for every
batch call. `python -m bitcoinconsensus_tpu_torch.workloads` is the CLI,
its `--chaos` the fault sweep. Never imported by the production verify
path.

Gauntlet telemetry lives here so every leg shares one set of
instruments (`obs/stats.py` REQUIRED_METRICS carries them).
"""

from __future__ import annotations

from ..obs import counter as _counter
from ..obs import histogram as _histogram

GAUNTLET_CORPUS_CASES = _counter(
    "consensus_gauntlet_corpus_cases_total",
    "adversarial corpus cases run, by shape",
    ("shape",),
)
GAUNTLET_DIVERGENCE = _counter(
    "consensus_gauntlet_divergence_total",
    "gauntlet verdict divergences (corpus pin misses, replay oracle "
    "mismatches, diff-fuzz backend disagreements) — any increment is a "
    "consensus bug or a stale pin",
    ("leg",),
)
GAUNTLET_REPLAY_BLOCKS = _counter(
    "consensus_gauntlet_replay_blocks_total",
    "replay-harness blocks streamed through the pipeline",
)
GAUNTLET_FUZZ_CASES = _counter(
    "consensus_gauntlet_fuzz_cases_total",
    "differential-fuzz mutated cases compared across backends",
)
GAUNTLET_SHAPE_SECONDS = _histogram(
    "consensus_gauntlet_shape_seconds",
    "per-item verify latency by adversarial shape (worst-case p99 "
    "tracking; populated by the corpus/bench legs)",
    ("shape",),
    buckets=(1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0),
)


def resolve_verifier(device=None, verifier=None):
    """The verifier a runner passes to every batch call: `verifier` as
    given, else a `TorchSecpVerifier` on `device` (None is cuda:0 and
    raises without CUDA; "cpu" runs the plain torch version)."""
    if verifier is not None:
        return verifier
    from ..crypto.torch_backend import TorchSecpVerifier

    return TorchSecpVerifier(device=device)


from .corpus import CorpusCase, SHAPES, build_corpus, shape_batch  # noqa: E402
from .replay import (  # noqa: E402
    ReplayBlock,
    ReplayConfig,
    generate_stream,
    run_replay,
    run_replay_cell,
    run_replay_serving,
)
from .diff_fuzz import backend_verdicts, run_diff_fuzz  # noqa: E402

__all__ = [
    "CorpusCase",
    "SHAPES",
    "build_corpus",
    "shape_batch",
    "ReplayBlock",
    "ReplayConfig",
    "generate_stream",
    "run_replay",
    "run_replay_cell",
    "run_replay_serving",
    "backend_verdicts",
    "run_diff_fuzz",
    "GAUNTLET_CORPUS_CASES",
    "GAUNTLET_DIVERGENCE",
    "GAUNTLET_REPLAY_BLOCKS",
    "GAUNTLET_FUZZ_CASES",
    "GAUNTLET_SHAPE_SECONDS",
]
