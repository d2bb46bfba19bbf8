"""bitcoinconsensus_tpu_torch: the PyTorch/CUDA port of bitcoinconsensus_tpu.

Byte-exact Bitcoin script verification whose batched signature checks run
as one hand-written CUDA kernel on an NVIDIA H100 (`csrc/verify_tiles.cu`).
It imports torch and numpy, never jax, and nothing of the JAX package,
which stays beside it as the reference it is tested against.

Layout (the JAX package's names, so each counterpart is easy to find):
- ``core``    — host consensus engine: tx codec, interpreter, sighash,
                the block codec and CheckBlock
- ``crypto``  — secp256k1 host oracle, GLV split, the batched verifier
                and its asynchronous seams
- ``ops``     — field and group ops as torch ops, the verify kernel's
                wrapper and plain version, the nvcc and g++ builds
- ``csrc``    — CUDA sources, and the native host core (``csrc/native``)
- ``native_bridge`` — ctypes surface of the native host core, its
                index-mode session and its block and coins-view handles
- ``models``  — `verify_batch`, `verify_batch_stream`, `connect_block`
                and the caches
- ``utils``   — hashing, phase timers, synthetic spends and blocks for
                tests and chip_smoke.py

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
    ConsensusError,
    Error,
    verify,
    verify_with_flags,
    verify_with_spent_outputs,
)
from .core.script_error import ScriptError
from .crypto.torch_backend import SigCheck, TorchSecpVerifier
from .models.batch import BatchItem, BatchResult, verify_batch, verify_batch_stream
from .models.validate import CoinsView, ConnectResult, connect_block
from .native_bridge import NativeCoinsView

__all__ = [
    "BatchItem",
    "BatchResult",
    "CoinsView",
    "ConnectResult",
    "ConsensusError",
    "Error",
    "NativeCoinsView",
    "ScriptError",
    "SigCheck",
    "TorchSecpVerifier",
    "connect_block",
    "verify",
    "verify_batch",
    "verify_batch_stream",
    "verify_with_flags",
    "verify_with_spent_outputs",
]
