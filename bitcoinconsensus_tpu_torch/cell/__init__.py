"""Multi-process serving cell: router, replicas, shared sigstore tier.

Port of `bitcoinconsensus_tpu/cell/`. The step from "a fast server" to
"a service": several `IngressServer`+`VerifyServer` replicas (real
subprocesses, each with its own CUDA context on the card), a
consistent-hash tenant router with health-driven failover
(cell/router.py), a known-answer-probing supervisor with bounded
restart backoff (cell/replica.py), and the persistent sigstore shards
promoted to a consistent-hash tier with shard handoff on membership
change (cell/sigtier.py). `ServingCell` (cell/cell.py) wires the four
together. Gated on the card by `chip_smoke.py`'s `[cell]` phase.

Replicas, stubs and the cell take `device`: None means cuda:0 (and
raises where CUDA is not available), "cpu" runs the plain torch version,
passed to a subprocess replica as `--device cpu`. Nothing gives way to
the CPU on its own.

Import discipline: the package imports torch (its `__init__` does), so
the reference's promise that `hashring` and `sigtier` import without jax
becomes: the handoff chain (`hashring`, `sigtier`, `models/sigstore`)
creates no CUDA context, so a control-plane process absorbing shards
never touches the card. The router/replica/cell layers pull in the
serving stack; they are exposed lazily.
"""

from .hashring import HashRing
from .sigtier import SigTier, absorb_handoff, iter_shard_records, write_handoff

__all__ = [
    "CellRouter",
    "HashRing",
    "ReplicaProcess",
    "ReplicaSupervisor",
    "ServingCell",
    "SigTier",
    "StubReplica",
    "absorb_handoff",
    "iter_shard_records",
    "make_probe_items",
    "probe_replica",
    "write_handoff",
]

_LAZY = {
    "CellRouter": ("router", "CellRouter"),
    "ReplicaProcess": ("replica", "ReplicaProcess"),
    "ReplicaSupervisor": ("replica", "ReplicaSupervisor"),
    "StubReplica": ("replica", "StubReplica"),
    "make_probe_items": ("replica", "make_probe_items"),
    "probe_replica": ("replica", "probe_replica"),
    "ServingCell": ("cell", "ServingCell"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    return getattr(mod, attr)
