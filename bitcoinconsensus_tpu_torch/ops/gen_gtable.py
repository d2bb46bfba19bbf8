"""The fixed-base G window table, built from the host group law.

32 windows of 8 bits: window w holds the 255 affine multiples
k·(256^w·G), k = 1..255 (the role of the reference's ecmult
precomputation, `secp256k1/src/ecmult_impl.h:312-350`). The JAX package
ships the same table as `ops/_gtable8.npz`; the port builds it at first use
(about 0.2 s of Python) and the tests hold the two equal.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np

from ..crypto.secp_host import G, P, PointJ
from .limbs import NLIMB, int_to_limbs

__all__ = ["WINDOWS", "WINDOW_BITS", "ENTRIES", "affine_table", "build_tables"]

WINDOWS = 32
WINDOW_BITS = 8
ENTRIES = (1 << WINDOW_BITS) - 1  # 255 (entry 0 = infinity, never stored)


def _batch_to_affine(points: List[PointJ]) -> List[Tuple[int, int]]:
    """Jacobian points -> affine via one Montgomery-trick inversion."""
    prefix = []
    acc = 1
    for pt in points:
        acc = acc * pt.Z % P
        prefix.append(acc)
    inv = pow(acc, P - 2, P)
    out = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        zi = inv * (prefix[i - 1] if i else 1) % P
        inv = inv * points[i].Z % P
        zi2 = zi * zi % P
        out[i] = (points[i].X * zi2 % P, points[i].Y * zi2 * zi % P)
    return out


@lru_cache(maxsize=1)
def affine_table() -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """table[w][k-1] = affine (x, y) of k·256^w·G as Python ints."""
    windows = []
    base = G
    for _ in range(WINDOWS):
        jac = []
        acc = PointJ.infinity()
        for _ in range(ENTRIES):
            acc = acc.add(base)
            jac.append(acc)
        windows.append(tuple(_batch_to_affine(jac)))
        base = acc.add(base)  # 256^{w+1}*G = 255*256^w*G + 256^w*G
    return tuple(windows)


def build_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(gx, gy): (32, 255, 20) int32 limb arrays, the layout of
    `bitcoinconsensus_tpu/ops/_gtable8.npz`."""
    gx = np.zeros((WINDOWS, ENTRIES, NLIMB), dtype=np.int32)
    gy = np.zeros((WINDOWS, ENTRIES, NLIMB), dtype=np.int32)
    for w, window in enumerate(affine_table()):
        for k, (x, y) in enumerate(window):
            gx[w, k] = int_to_limbs(x)
            gy[w, k] = int_to_limbs(y)
    return gx, gy
