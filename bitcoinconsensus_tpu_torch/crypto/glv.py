"""Host-side GLV scalar decomposition for the verify kernel.

Splits a scalar k (mod n) as k = s1·|k1| + lambda·s2·|k2| with
|k1|, |k2| < 2^128, following the lattice-basis construction of
`secp256k1/src/scalar_impl.h:60-178` (secp256k1_scalar_split_lambda):
c1 = round(b2·k/n), c2 = round(-b1·k/n), k2 = -(c1·b1 + c2·b2),
k1 = k - k2·lambda. Python ints make the rounding exact.

The device half of the scheme is the signed-window ladder of
`ops/verify_tiles.py` and `csrc/verify_tiles.cu`. A half escaping the
proven bound counts in `consensus_glv_split_range_total{half}` before
`SplitRangeError` is raised.
"""

from __future__ import annotations

from typing import Tuple

from ..obs import counter
from .secp_host import N

__all__ = ["split_lambda", "SplitRangeError", "LAMBDA"]

# lambda^3 = 1 mod n; lambda·(x, y) = (beta·x, y) on the curve.
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72

_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_B2 = 0x3086D221A7D46BCDE86C90E49284EB15

_SPLIT_RANGE = counter(
    "consensus_glv_split_range_total",
    "GLV split produced a half >= 2^128 — the lattice certificate "
    "(analysis/scalar_check.py glv.split_lambda) is violated at runtime",
    ("half",))


class SplitRangeError(ValueError):
    """A GLV half escaped the proven |k_i| < 2^128 bound.

    The shipped constants make this unreachable, so reaching it means they
    (or the arithmetic) were corrupted in-process. A wrong-size half would
    silently truncate in the 128-bit device decomposition, so this raises
    rather than asserts (it must survive ``python -O``)."""

    def __init__(self, k: int, a1: int, a2: int):
        self.k, self.a1, self.a2 = k, a1, a2
        super().__init__(
            f"GLV split out of range: k={k:#x} -> |k1|={a1:#x}, "
            f"|k2|={a2:#x}; proven bound is 2^128")


def split_lambda(k: int) -> Tuple[int, int, int, int]:
    """k (mod n) -> (abs_k1, neg1, abs_k2, neg2) with abs_ki < 2^128 and
    s1·abs_k1 + lambda·s2·abs_k2 ≡ k (mod n), si = -1 if negi else 1."""
    k %= N
    c1 = (_B2 * k + N // 2) // N
    c2 = (-_B1 * k + N // 2) // N
    k2 = -(c1 * _B1 + c2 * _B2)
    k1 = k - k2 * LAMBDA
    k1 %= N
    k2 %= N
    neg1 = k1 > N - k1
    neg2 = k2 > N - k2
    a1 = N - k1 if neg1 else k1
    a2 = N - k2 if neg2 else k2
    if a1 >= 1 << 128 or a2 >= 1 << 128:
        if a1 >= 1 << 128:
            _SPLIT_RANGE.inc(half="k1")
        if a2 >= 1 << 128:
            _SPLIT_RANGE.inc(half="k2")
        raise SplitRangeError(k, a1, a2)
    return a1, int(neg1), a2, int(neg2)
