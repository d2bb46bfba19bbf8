"""bitcoinconsensus_tpu_torch: the PyTorch/CUDA port of bitcoinconsensus_tpu.

Byte-exact Bitcoin script verification whose batched signature checks run
as one hand-written CUDA kernel on an NVIDIA H100 (`csrc/verify_tiles.cu`).
It imports torch and numpy, never jax, and nothing of the JAX package,
which stays beside it as the reference it is tested against.

Layout (the JAX package's names, so each counterpart is easy to find):
- ``core``    — host consensus engine: tx codec, interpreter, sighash
- ``crypto``  — secp256k1 host oracle, GLV split, the batched verifier
- ``ops``     — field and group ops as torch ops, the verify kernel's
                wrapper and plain version, the nvcc and g++ builds
- ``csrc``    — CUDA sources, and the native host core (``csrc/native``)
- ``native_bridge`` — ctypes surface of the native host core
- ``models``  — `verify_batch` and its caches
- ``utils``   — hashing, synthetic spends for tests and chip_smoke.py

Entry points run on the card unless the caller asks for the CPU:
``verify_batch(items)`` builds ``TorchSecpVerifier()`` on cuda:0;
``TorchSecpVerifier(device="cpu")`` runs the plain torch version. Host work
runs on the native host core (built with g++ at first use; a failed build
raises) unless the caller passes ``engine="python"``.
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
from .models.batch import BatchItem, BatchResult, verify_batch

__all__ = [
    "BatchItem",
    "BatchResult",
    "ConsensusError",
    "Error",
    "ScriptError",
    "SigCheck",
    "TorchSecpVerifier",
    "verify",
    "verify_batch",
    "verify_with_flags",
    "verify_with_spent_outputs",
]
