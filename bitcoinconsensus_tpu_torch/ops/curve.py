"""Batched secp256k1 group ops as torch ops, over the limbs of `limbs.py`.

The port's plain counterpart of `bitcoinconsensus_tpu/ops/curve.py`: the
same formulas (dbl-2009-l, madd-2007-bl, add-2007-bl for a = 0) in the
same order, so every output is limb for limb identical to the JAX module's.
Points are Jacobian triples ``(X, Y, Z)`` of weak (20, B) field elements.
Exceptional cases of the addition law are computed beside the generic
formula and chosen with per-lane masks; the flagged variants only report
the equal-points case (``needs_dbl``), which the verifier resolves on the
host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .limbs import (
    NLIMB,
    RADIX,
    _col,
    fe_add,
    fe_is_zero_many,
    fe_mul,
    fe_mul_small,
    fe_sqr,
    fe_sub,
    int_to_limbs,
)

__all__ = [
    "G_X",
    "G_Y",
    "BETA",
    "G_WINDOWS",
    "G_WINDOW_BITS",
    "GLV_WINDOWS",
    "jacobian_double",
    "jacobian_madd_flagged",
    "jacobian_madd_flagged_ratio",
    "jacobian_add_flagged",
    "scalar_bits",
    "g_table",
]

G_X = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
G_Y = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# GLV endomorphism: beta^3 = 1 mod p and lambda·(x, y) = (beta·x, y)
# (secp256k1/src/scalar_impl.h:60-112; lambda lives in crypto/glv.py).
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE

_GX_LIMBS = int_to_limbs(G_X)
_GY_LIMBS = int_to_limbs(G_Y)
_BETA_LIMBS = int_to_limbs(BETA)
_ONE = int_to_limbs(1)

P_WINDOW_BITS = 4
G_WINDOWS = 32
G_WINDOW_BITS = 8
GLV_WINDOWS = 32


def jacobian_double(X, Y, Z):
    """Point doubling, dbl-2009-l for a=0; maps infinity to infinity."""
    A = fe_sqr(X)
    B = fe_sqr(Y)
    C = fe_sqr(B)
    D = fe_mul_small(fe_sub(fe_sqr(fe_add(X, B)), fe_add(A, C)), 2)
    E = fe_mul_small(A, 3)
    F = fe_sqr(E)
    X3 = fe_sub(F, fe_mul_small(D, 2))
    Y3 = fe_sub(fe_mul(E, fe_sub(D, X3)), fe_mul_small(C, 8))
    Z3 = fe_mul_small(fe_mul(Y, Z), 2)  # Z=0 -> Z3=0: infinity preserved
    return X3, Y3, Z3


def _select(mask, a3, b3):
    """Per-lane select between two point triples; mask shape (...,)."""
    m = mask[None]
    return tuple(torch.where(m, x, y) for x, y in zip(a3, b3, strict=True))


def _ones_like(X):
    return _col(_ONE, X).expand(X.shape).to(X.dtype)


def _inf_like(X):
    ones = _ones_like(X)
    return ones, ones, torch.zeros_like(X)


def _madd_core(X1, Y1, Z1, x2, y2, inf1):
    """Generic madd-2007-bl formula + exceptional-case masks. Returns
    (generic_triple, h_zero, r_zero, z1_zero, H); z1_zero follows the inf1
    convention (False -> statically finite, a mask -> as given)."""
    Z1Z1 = fe_sqr(Z1)
    U2 = fe_mul(x2, Z1Z1)
    S2 = fe_mul(y2, fe_mul(Z1, Z1Z1))
    H = fe_sub(U2, X1)
    Rsub = fe_sub(S2, Y1)
    h_zero, r_zero = fe_is_zero_many((H, Rsub))
    z1_zero = inf1

    HH = fe_sqr(H)
    I = fe_mul_small(HH, 4)
    J = fe_mul(H, I)
    r = fe_mul_small(Rsub, 2)
    V = fe_mul(X1, I)
    X3 = fe_sub(fe_sqr(r), fe_add(J, fe_mul_small(V, 2)))
    Y3 = fe_sub(fe_mul(r, fe_sub(V, X3)), fe_mul_small(fe_mul(Y1, J), 2))
    Z3 = fe_sub(fe_sqr(fe_add(Z1, H)), fe_add(Z1Z1, HH))
    return (X3, Y3, Z3), h_zero, r_zero, z1_zero, H


def _madd_lift(out, X1, x2, y2, z1_zero):
    """Infinite-left-operand case: result is the lifted affine operand."""
    lift = (x2.expand(X1.shape).to(X1.dtype),
            y2.expand(X1.shape).to(X1.dtype), _ones_like(X1))
    return _select(z1_zero, lift, out)


def jacobian_madd_flagged(X1, Y1, Z1, x2, y2, inf1):
    """Mixed addition (X1,Y1,Z1) + (x2,y2) without the doubling fallback:
    the equal-points case is only flagged (`needs_dbl`). `inf1` is the
    caller-tracked infinity mask of the left operand, or False when it is
    statically finite. Returns (X, Y, Z, out_inf, needs_dbl)."""
    out, h_zero, r_zero, z1_zero, _H = _madd_core(X1, Y1, Z1, x2, y2, inf1)
    out = _select(h_zero & ~r_zero, _inf_like(X1), out)
    if z1_zero is False:
        return out + (h_zero & ~r_zero, h_zero & r_zero)
    out = _madd_lift(out, X1, x2, y2, z1_zero)
    out_inf = ~z1_zero & h_zero & ~r_zero
    needs_dbl = ~z1_zero & h_zero & r_zero
    return out + (out_inf, needs_dbl)


def jacobian_madd_flagged_ratio(X1, Y1, Z1, x2, y2, inf1=False):
    """`jacobian_madd_flagged` that also returns the Z-ratio Z3/Z1 = 2H,
    which the per-lane table build records to renormalise every row to one
    global Z. Returns (X, Y, Z, out_inf, needs_dbl, ratio)."""
    out, h_zero, r_zero, z1_zero, H = _madd_core(X1, Y1, Z1, x2, y2, inf1)
    ratio = fe_mul_small(H, 2)
    out = _select(h_zero & ~r_zero, _inf_like(X1), out)
    if z1_zero is False:
        return out + (h_zero & ~r_zero, h_zero & r_zero, ratio)
    out = _madd_lift(out, X1, x2, y2, z1_zero)
    out_inf = ~z1_zero & h_zero & ~r_zero
    needs_dbl = ~z1_zero & h_zero & r_zero
    return out + (out_inf, needs_dbl, ratio)


def _add_core(X1, Y1, Z1, X2, Y2, Z2, inf1):
    """Generic add-2007-bl formula + exceptional-case masks."""
    Z1Z1 = fe_sqr(Z1)
    Z2Z2 = fe_sqr(Z2)
    U1 = fe_mul(X1, Z2Z2)
    U2 = fe_mul(X2, Z1Z1)
    S1 = fe_mul(Y1, fe_mul(Z2, Z2Z2))
    S2 = fe_mul(Y2, fe_mul(Z1, Z1Z1))
    H = fe_sub(U2, U1)
    Rsub = fe_sub(S2, S1)
    h_zero, r_zero = fe_is_zero_many((H, Rsub))
    z1_zero = inf1

    I = fe_sqr(fe_mul_small(H, 2))
    J = fe_mul(H, I)
    r = fe_mul_small(Rsub, 2)
    V = fe_mul(U1, I)
    X3 = fe_sub(fe_sqr(r), fe_add(J, fe_mul_small(V, 2)))
    Y3 = fe_sub(fe_mul(r, fe_sub(V, X3)), fe_mul_small(fe_mul(S1, J), 2))
    Z3 = fe_mul(fe_sub(fe_sqr(fe_add(Z1, Z2)), fe_add(Z1Z1, Z2Z2)), H)
    return (X3, Y3, Z3), h_zero, r_zero, z1_zero


def jacobian_add_flagged(X1, Y1, Z1, X2, Y2, Z2, inf2, inf1):
    """Jacobian + Jacobian addition without the doubling fallback.
    `inf2` / `inf1`: caller-tracked infinity masks. Returns
    (X, Y, Z, out_inf, needs_dbl)."""
    out, h_zero, r_zero, z1_zero = _add_core(X1, Y1, Z1, X2, Y2, Z2, inf1)
    out = _select(h_zero & ~r_zero, _inf_like(X1), out)
    out = _select(z1_zero, (X2, Y2, Z2), out)
    out = _select(inf2, (X1, Y1, Z1), out)
    out_inf = (z1_zero & inf2) | (~z1_zero & ~inf2 & h_zero & ~r_zero)
    needs_dbl = ~z1_zero & ~inf2 & h_zero & r_zero
    return out + (out_inf, needs_dbl)


def scalar_bits(limbs: torch.Tensor) -> torch.Tensor:
    """(n, ...) scalar limbs -> (n*13, ...) bits, LSB first."""
    shifts = torch.arange(RADIX, dtype=torch.int32, device=limbs.device)
    shifts = shifts.reshape((1, RADIX) + (1,) * (limbs.dim() - 1))
    bits = (limbs[:, None] >> shifts) & 1
    return bits.reshape((limbs.shape[0] * RADIX,) + limbs.shape[1:])


def _window_sum(bits: torch.Tensor, count: int, width: int) -> torch.Tensor:
    b = bits[: count * width].reshape((count, width) + bits.shape[1:])
    weights = torch.tensor([1 << i for i in range(width)], dtype=torch.int32,
                           device=bits.device)
    weights = weights.reshape((1, width) + (1,) * (bits.dim() - 1))
    return (b * weights).sum(dim=1, dtype=torch.int32)


def _digits(limbs: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """(20, ...) scalar limbs -> (count, ...) window digits, LSB first."""
    return _window_sum(scalar_bits(limbs)[:256], count, width)


def _digits128(limbs10: torch.Tensor, count: int = GLV_WINDOWS,
               width: int = P_WINDOW_BITS) -> torch.Tensor:
    """(10, ...) limbs of a < 2^130 value -> (count, ...) window digits,
    LSB first (only bits 0..count*width-1 are consumed)."""
    return _window_sum(scalar_bits(limbs10), count, width)


@lru_cache(maxsize=1)
def _g_table_np() -> Tuple[np.ndarray, np.ndarray]:
    from .gen_gtable import build_tables

    return build_tables()


def g_table(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy): the (32, 255, 20) int32 affine G window table on `device`
    (row k-1 of window w holds k·256^w·G), built at first use."""
    gx, gy = _g_table_np()
    return (torch.as_tensor(gx, device=device),
            torch.as_tensor(gy, device=device))
