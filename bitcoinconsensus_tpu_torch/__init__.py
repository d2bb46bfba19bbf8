"""bitcoinconsensus_tpu_torch: the PyTorch/CUDA port of bitcoinconsensus_tpu.

Byte-exact Bitcoin script verification whose batched signature checks run
as one hand-written CUDA kernel on an NVIDIA H100 (`csrc/verify_tiles.cu`).
It imports torch and numpy, never jax, and nothing of the JAX package,
which stays beside it as the reference it is tested against.

Layout (the JAX package's names, so each counterpart is easy to find):
- ``core``    — host consensus engine: tx codec, interpreter, sighash,
                the block codec and CheckBlock
- ``crypto``  — secp256k1 host oracle, GLV split, the batched verifier
                and its asynchronous seams, compact-signature recovery
                and BIP32 public derivation
- ``ops``     — field and group ops as torch ops, the verify and
                checksum kernels' wrappers and plain versions, the nvcc and
                g++ builds
- ``csrc``    — CUDA sources, and the native host core (``csrc/native``)
- ``native_bridge`` — ctypes surface of the native host core, its
                index-mode session and its block and coins-view handles
- ``models``  — `verify_batch`, `verify_batch_stream`, `connect_block`
                and the caches
- ``parallel`` — the sharded verifier: each dispatch spread over a mesh of
                devices, a fault domain per shard, evictions and probes
- ``resilience`` — the guards every dispatch settles through (sentinel
                lanes, the device verdict checksum, validation), the
                in-flight queue with its retry budget, the fault-injection
                harness and the sig-cache audit
- ``utils``   — hashing, phase timers, synthetic spends and blocks for
                tests and chip_smoke.py
- ``analysis`` — the kernel prover, the scalar-schedule prover and the
                host lint (``python -m bitcoinconsensus_tpu_torch.analysis.lint``)

Entry points run on the card unless the caller asks for the CPU:
``verify_batch(items)``, ``verify_batch_stream(batches)`` and
``connect_block(block, coins, height)`` use the process-wide
``TorchSecpVerifier()`` on cuda:0; passing
``verifier=TorchSecpVerifier(device="cpu")`` runs the plain torch version.
Host work runs on the native host core (built with g++ at first use; a
failed build raises) unless the caller passes ``engine="python"``.
``connect_block`` on a ``NativeCoinsView`` keeps the block layer in the
native core; on a plain ``CoinsView`` it runs in Python.
"""

from .api import (
    VERIFY_ALL_EXTENDED,
    VERIFY_ALL_LIBCONSENSUS,
    ConsensusError,
    Error,
    height_to_flags,
    verify,
    verify_with_flags,
    verify_with_spent_outputs,
    version,
)
from . import parallel, resilience
from .core import flags
from .core.script_error import ScriptError
from .crypto.bip32 import ExtPubKey, pubkey_derive
from .crypto.recovery import recover_compact
from .crypto.torch_backend import SigCheck, TorchSecpVerifier
from .models.batch import BatchItem, BatchResult, verify_batch, verify_batch_stream
from .models.validate import CoinsView, ConnectResult, connect_block
from .native_bridge import NativeCoinsView

__version__ = "0.1.0"

# The reference's exports first (`bitcoinconsensus_tpu/__init__.py`), then
# the port's own.
__all__ = [
    "ConsensusError",
    "Error",
    "ExtPubKey",
    "ScriptError",
    "VERIFY_ALL_EXTENDED",
    "VERIFY_ALL_LIBCONSENSUS",
    "flags",
    "height_to_flags",
    "pubkey_derive",
    "recover_compact",
    "verify",
    "verify_with_flags",
    "verify_with_spent_outputs",
    "version",

    "BatchItem",
    "BatchResult",
    "CoinsView",
    "ConnectResult",
    "NativeCoinsView",
    "SigCheck",
    "TorchSecpVerifier",
    "connect_block",
    "parallel",
    "resilience",
    "verify_batch",
    "verify_batch_stream",
]
