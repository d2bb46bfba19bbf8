"""ctypes bridge to the reference consensus library (dev/bench only).

A copy of `bitcoinconsensus_tpu/utils/refbridge.py`, so that the port's
tests reach the reference `.so` (under `.baseline/`, where it was built)
without importing the JAX package; `load_reference_lib` returns None where
it is not built.

Loads the shared object produced by `scripts/build_reference.sh` and exposes
the exact C ABI the reference crate binds (`src/lib.rs:141-162`,
`script/bitcoinconsensus.h:67-75`): per-input script verification with
amount. Used for (a) the measured CPU baseline BASELINE.md mandates and
(b) differential fuzzing (the `HAVE_CONSENSUS_LIB` round-trip precedent,
`script_tests.cpp:22-24`). Never imported by the production verify path.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

__all__ = ["ReferenceLib", "load_reference_lib"]

_DEFAULT_SO = os.path.join(
    os.path.dirname(__file__), "..", "..", ".baseline", "libbitcoinconsensus.so"
)


class ReferenceLib:
    """bitcoinconsensus_verify_script_with_amount + _version via ctypes."""

    def __init__(self, path: str):
        self._lib = ctypes.CDLL(path)
        fn = self._lib.bitcoinconsensus_verify_script_with_amount
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p,     # scriptPubKey
            ctypes.c_uint,       # scriptPubKeyLen
            ctypes.c_int64,      # amount
            ctypes.c_char_p,     # txTo
            ctypes.c_uint,       # txToLen
            ctypes.c_uint,       # nIn
            ctypes.c_uint,       # flags
            ctypes.POINTER(ctypes.c_int),  # err
        ]
        self._verify = fn
        fn2 = self._lib.bitcoinconsensus_verify_script
        fn2.restype = ctypes.c_int
        fn2.argtypes = [
            ctypes.c_char_p,     # scriptPubKey
            ctypes.c_uint,       # scriptPubKeyLen
            ctypes.c_char_p,     # txTo
            ctypes.c_uint,       # txToLen
            ctypes.c_uint,       # nIn
            ctypes.c_uint,       # flags
            ctypes.POINTER(ctypes.c_int),  # err
        ]
        self._verify_no_amount = fn2
        ver = self._lib.bitcoinconsensus_version
        ver.restype = ctypes.c_uint
        self._version = ver

    def version(self) -> int:
        return int(self._version())

    def verify_with_flags(
        self,
        spent_output_script: bytes,
        amount: int,
        spending_tx: bytes,
        input_index: int,
        flags: int,
    ) -> tuple:
        """Returns (ok, err_code) — err_code is bitcoinconsensus_error
        (0 = ERR_OK; script failures return ok=0 with err 0, matching the
        reference's swallowed ScriptError, src/lib.rs:133-137)."""
        err = ctypes.c_int(0)
        ok = self._verify(
            spent_output_script,
            len(spent_output_script),
            amount,
            spending_tx,
            len(spending_tx),
            input_index,
            flags,
            ctypes.byref(err),
        )
        return bool(ok), int(err.value)

    def verify_no_amount(
        self,
        spent_output_script: bytes,
        spending_tx: bytes,
        input_index: int,
        flags: int,
    ) -> tuple:
        """bitcoinconsensus_verify_script (bitcoinconsensus.h:67-69): the
        amount-less legacy entry; WITNESS flag yields ERR_AMOUNT_REQUIRED."""
        err = ctypes.c_int(0)
        ok = self._verify_no_amount(
            spent_output_script,
            len(spent_output_script),
            spending_tx,
            len(spending_tx),
            input_index,
            flags,
            ctypes.byref(err),
        )
        return bool(ok), int(err.value)


def load_reference_lib(path: Optional[str] = None) -> Optional[ReferenceLib]:
    """Load the built reference lib, or None when it isn't built (callers
    must skip, not fail: CI machines may lack the reference checkout)."""
    p = os.path.abspath(path or os.environ.get("BITCOINCONSENSUS_REF_SO", _DEFAULT_SO))
    if not os.path.exists(p):
        return None
    try:
        return ReferenceLib(p)
    except OSError:
        return None
