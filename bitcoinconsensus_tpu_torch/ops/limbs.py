"""Batched 256-bit field arithmetic mod p (secp256k1) as torch ops.

The port's plain counterpart of `bitcoinconsensus_tpu/ops/limbs.py`, kept
limb for limb identical to it so the two can be compared exactly. A field
element is 20 little-endian limbs in radix 2^13, dtype int32, limb axis
first: shape ``(20, ...)`` with the batch in the trailing axes.

Every routine carries static Python-int per-limb upper bounds beside the
tensors, so the number of carry passes and folds is a function of those
bounds alone, exactly as in the JAX module. Weak form (the `W2` bounds) is
accepted and returned by every op; `fe_canon` gives the unique
representative in [0, p).

Where the JAX module wraps int32 on purpose (its Karatsuba sum-convolution
exceeds 2^31 and relies on two's-complement wraparound), this module forms
the schoolbook column sums directly: every true column is statically below
2^31 (asserted below), so int32 holds them without wrapping, and the settle
runs on the same static bounds the Karatsuba bookkeeping produces.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "NLIMB",
    "RADIX",
    "MASK",
    "P_INT",
    "W2",
    "int_to_limbs",
    "limbs_to_int",
    "bytes_to_limbs",
    "fe_add",
    "fe_sub",
    "fe_mul",
    "fe_sqr",
    "fe_mul_small",
    "fe_canon",
    "fe_is_zero",
    "fe_is_zero_many",
    "fe_pow_runs",
    "fe_inv_chain",
    "fe_sqrt_chain",
]

NLIMB = 20
RADIX = 13
MASK = (1 << RADIX) - 1

P_INT = 2**256 - 2**32 - 977
# 2^260 mod p = 16C = 2^36 + 15632 -> radix-2^13 limbs [7440, 1, 1024].
_FOLD260 = (7440, 1, 1024)

# Weak bounds: fixpoint of the wrap-around pass (see _pass).
W2 = [MASK + 7440, MASK + 2, MASK + 1025] + [MASK + 1] * (NLIMB - 3)

Bounds = List[int]


def int_to_limbs(x: int, n: int = NLIMB) -> np.ndarray:
    """Host helper: Python int -> little-endian radix-2^13 limb vector."""
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= RADIX
    if x:
        raise ValueError("value does not fit limb vector")
    return out


def limbs_to_int(limbs) -> int:
    """Host helper: limb vector (FIRST axis) -> Python int."""
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(v) << (RADIX * i) for i, v in enumerate(arr))


_P_LIMBS = int_to_limbs(P_INT)


def _col(vec: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Constant (20,) limb vector -> (20, 1, ..., 1) tensor beside `like`."""
    t = torch.as_tensor(vec, dtype=torch.int32, device=like.device)
    return t.reshape((NLIMB,) + (1,) * (like.dim() - 1))


def bytes_to_limbs(u8: torch.Tensor, nlimb: int = NLIMB) -> torch.Tensor:
    """(..., K) uint8 little-endian values -> limb-major (nlimb, ...) int32
    (K*8 <= nlimb*RADIX; default 32 bytes -> 20 limbs)."""
    nbytes = u8.shape[-1]
    if nbytes * 8 > nlimb * RADIX:
        raise ValueError(f"{nbytes} bytes do not fit {nlimb} limbs")
    x = u8.to(torch.int32)
    # Top limb windows may span past the last byte: zero-pad.
    pad_n = (RADIX * (nlimb - 1) >> 3) + 3 - nbytes
    if pad_n > 0:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad_n,))], dim=-1)
    limbs = []
    for i in range(nlimb):
        bitpos = RADIX * i
        k, sh = bitpos >> 3, bitpos & 7
        window = x[..., k] | (x[..., k + 1] << 8) | (x[..., k + 2] << 16)
        limbs.append((window >> sh) & MASK)
    return torch.stack(limbs, dim=0)


# ---------------------------------------------------------------------------
# Carry passes. The op sequence is a function of the static bounds only, so
# each distinct bounds vector is planned once (lru_cache) and replayed.


def _pass_bounds(bounds: Bounds) -> Tuple[Bounds, str]:
    """Bounds after one parallel carry pass, and what the top carry does:
    'none' (provably zero), 'wrap' (into limbs 0..2 via 16C) or 'append'."""
    assert all(0 <= b < 2**31 for b in bounds)
    n = len(bounds)
    cb = [b >> RADIX for b in bounds]
    b2 = [min(bounds[0], MASK)] + [
        min(bounds[i], MASK) + cb[i - 1] for i in range(1, n)
    ]
    if cb[-1] == 0:
        return b2, "none"
    if n == NLIMB:
        for j, f in enumerate(_FOLD260):
            b2[j] += cb[-1] * f
            assert b2[j] < 2**31
        return b2, "wrap"
    b2.append(cb[-1])
    return b2, "append"


def _fold_bounds(bounds: Bounds) -> Bounds:
    """Bounds after folding limbs at positions >= NLIMB via 2^260 ≡ 16C."""
    n_hi = len(bounds) - NLIMB
    assert n_hi > 0
    out_len = max(NLIMB, n_hi + len(_FOLD260) - 1)
    b2 = bounds[:NLIMB] + [0] * (out_len - NLIMB)
    for j, f in enumerate(_FOLD260):
        for i in range(n_hi):
            b2[i + j] += bounds[NLIMB + i] * f
            assert b2[i + j] < 2**31
    return b2


_FOLD_COLS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _fold_col(x: torch.Tensor) -> torch.Tensor:
    """_FOLD260 as a (3, 1, ..., 1) int32 tensor on x's device, made once
    per device and rank (no host-to-device copy per carry pass). A column
    made while `x` is being traced (a fake or functional tensor, as the
    prover's `make_fx` gives) is used and not kept."""
    key = (x.device, x.dim())
    col = _FOLD_COLS.get(key)
    if col is None:
        col = torch.tensor(_FOLD260, dtype=torch.int32, device=x.device)
        col = col.reshape((3,) + (1,) * (x.dim() - 1))
        if torch._guards.detect_fake_mode(x) is None:
            col = _FOLD_COLS.setdefault(key, col)
    return col


def _pass(x: torch.Tensor, top: str) -> torch.Tensor:
    c = x >> RADIX
    out = x & MASK
    out[1:] += c[:-1]
    if top == "wrap":
        out[:3] += c[NLIMB - 1][None] * _fold_col(x)
    elif top == "append":
        out = torch.cat([out, c[-1:]], dim=0)
    return out


def _fold_high(x: torch.Tensor) -> torch.Tensor:
    n_hi = x.shape[0] - NLIMB
    out_len = max(NLIMB, n_hi + len(_FOLD260) - 1)
    acc = x.new_zeros((out_len,) + x.shape[1:])
    acc[:NLIMB] = x[:NLIMB]
    hi = x[NLIMB:]
    for j, f in enumerate(_FOLD260):
        acc[j : j + n_hi] += hi * f
    return acc


def _settled(bounds: Bounds) -> bool:
    return len(bounds) == NLIMB and all(
        b <= w for b, w in zip(bounds, W2, strict=True)
    )


@lru_cache(maxsize=None)
def _settle_plan(bounds: Tuple[int, ...]) -> Tuple[str, ...]:
    """The `_settle` schedule of `ops/limbs.py` for these static bounds:
    a sequence of 'fold' and 'pass:<top>' steps."""
    b = list(bounds)
    plan = []
    while not _settled(b):
        assert len(plan) < 24, "settle failed to converge (static bounds bug)"
        if len(b) > NLIMB and all(v * _FOLD260[0] < 2**30 for v in b[NLIMB:]):
            b = _fold_bounds(b)
            plan.append("fold")
        else:
            b, top = _pass_bounds(b)
            plan.append("pass:" + top)
    return tuple(plan)


def _run_plan(x: torch.Tensor, plan: Sequence[str]) -> torch.Tensor:
    for step in plan:
        x = _fold_high(x) if step == "fold" else _pass(x, step[5:])
    return x


def _settle(x: torch.Tensor, bounds: Bounds) -> torch.Tensor:
    """Drive any nonnegative limb vector into weak (W2-bounded) form."""
    assert x.shape[0] == len(bounds)
    return _run_plan(x, _settle_plan(tuple(bounds)))


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p (weak in, weak out)."""
    return _settle(a + b, [2 * w for w in W2])


_SUB_K = 32  # bias = 32p, encoded with every limb >= W2


def _sub_bias_limbs() -> np.ndarray:
    """Encode 32p in 20 limbs with limb i >= W2[i], so a + bias - b is
    nonnegative per limb for any weak a, b (bias value ≡ 0 mod p)."""
    d = [int(v) for v in int_to_limbs(_SUB_K * P_INT, 21)]
    d[19] += d[20] << RADIX
    d = d[:20]
    for i in range(NLIMB - 1):
        while d[i] < W2[i]:
            d[i] += 1 << RADIX
            d[i + 1] -= 1
    assert all(d[i] >= W2[i] for i in range(NLIMB)), d
    assert all(d[i] + W2[i] < 2**31 for i in range(NLIMB))
    assert sum(v << (RADIX * i) for i, v in enumerate(d)) == _SUB_K * P_INT
    return np.asarray(d, dtype=np.int32)


_SUB_BIAS = _sub_bias_limbs()
_SUB_BOUNDS = [int(d) + w for d, w in zip(_SUB_BIAS, W2, strict=True)]


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p (weak in/out): a + 32p (in >=W2-limb form) - b >= 0."""
    return _settle(a + _col(_SUB_BIAS, a) - b, list(_SUB_BOUNDS))


def fe_mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k mod p for a small static k (k * W2[0] must fit int32)."""
    assert 0 < k and k * W2[0] < 2**31
    return _settle(a * k, [w * k for w in W2])


# --- multiplication ----------------------------------------------------------
# The JAX module splits fe_mul into two Karatsuba levels (20 = 10 + 10, and
# each real-weight half 10 = 5 + 5). Its assembled columns are exactly the
# schoolbook column sums, and its static bounds are the sums the functions
# below re-derive; _settle's pass count depends on those bounds, so they are
# reproduced here by the same bookkeeping.

_KARA_LO = 10


def _conv_bounds(aw: Bounds, bw: Bounds) -> Bounds:
    out = [0] * (len(aw) + len(bw) - 1)
    for i, x in enumerate(aw):
        for j, y in enumerate(bw):
            out[i + j] += x * y
    return out


def _cross_bounds(wa: Bounds, wb: Bounds, h: int) -> Bounds:
    z1b = [0] * (2 * h - 1)
    for i in range(h):
        for j in range(h):
            z1b[i + j] += wa[i] * wb[h + j] + wa[h + i] * wb[j]
    return z1b


def _kara_bounds(aw: Bounds, bw: Bounds, levels: int) -> Bounds:
    """Static column bounds of the JAX module's `levels`-deep Karatsuba
    convolution (`_conv_rows_kara` / `_kara_combine`)."""
    nl = len(aw)
    if levels == 0:
        return _conv_bounds(aw, bw)
    h = nl // 2
    b0 = _kara_bounds(aw[:h], bw[:h], levels - 1)
    b2 = _kara_bounds(aw[h:], bw[h:], levels - 1)
    z1b = _cross_bounds(aw, bw, h)
    bounds = [0] * (2 * nl - 1)
    for k in range(2 * h - 1):
        bounds[k] += b0[k]
        bounds[k + h] += z1b[k]
        bounds[k + 2 * h] += b2[k]
    assert all(0 <= b < 2**31 for b in bounds)
    return bounds


_MUL_BOUNDS = _kara_bounds(W2, W2, 2)
assert _MUL_BOUNDS == _conv_bounds(W2, W2)  # columns never wrap int32


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook convolution over the limb axis: (20, ...) x (20, ...) ->
    (39, ...) column sums, each < 2^31 for weak operands.

    Row i of the outer product is skewed i places right by re-reading the
    zero-padded (20, 40) product with a row stride of 39, so one sum over
    rows gives every column."""
    prod = a[:, None] * b[None, :]  # (20, 20, ...)
    rest = prod.shape[2:]
    padded = torch.cat([prod, torch.zeros_like(prod)], dim=1)
    skew = padded.reshape((2 * NLIMB * NLIMB,) + rest)[: NLIMB * (2 * NLIMB - 1)]
    return skew.reshape((NLIMB, 2 * NLIMB - 1) + rest).sum(dim=0, dtype=torch.int32)


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p (weak in, weak out)."""
    return _settle(_conv(a, b), _MUL_BOUNDS)


def fe_sqr(a: torch.Tensor) -> torch.Tensor:
    """a^2 mod p. The JAX module's squaring convolution has the same
    columns and the same static bounds as its product, so this is fe_mul."""
    return fe_mul(a, a)


# --- exactness -----------------------------------------------------------------

_KS_MAX = (1 << (RADIX + 1)) - 2  # per-limb cap for single-bit carries


def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """Rows moved d positions up the limb axis, zeros shifted in."""
    return torch.cat([x.new_zeros((d,) + x.shape[1:]), x[:-d]], dim=0)


def _lookahead(g: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """Kogge-Stone prefix over the limb axis: carry (or borrow) out of each
    limb given generate `g` and propagate `pr` (int32 0/1)."""
    d = 1
    while d < NLIMB:
        g = g | (pr & _shift_up(g, d))
        pr = pr & _shift_up(pr, d)
        d *= 2
    return g


def _ks_exact(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact carry propagation for limbs <= _KS_MAX: (exact 13-bit limbs,
    carry-out of limb 19 in {0, 1})."""
    g = _lookahead((x > MASK).to(torch.int32), (x == MASK).to(torch.int32))
    exact = (x + _shift_up(g, 1)) & MASK
    return exact, g[NLIMB - 1]


def _exact_lt_2p(x: torch.Tensor, bounds: Bounds) -> torch.Tensor:
    """Weak-ish x -> exact 13-bit limbs of a value v ≡ x (mod p), v < 2p."""
    while len(bounds) > NLIMB or any(b > _KS_MAX for b in bounds):
        if len(bounds) > NLIMB:
            x, bounds = _fold_high(x), _fold_bounds(bounds)
        else:
            bounds, top = _pass_bounds(bounds)
            x = _pass(x, top)
    assert sum(b << (RADIX * i) for i, b in enumerate(bounds)) < 2**261
    e, cout = _ks_exact(x)
    # v1 = e + cout*2^260; fold cout*2^260 ≡ cout*16C and the top 4 bits
    # of limb 19 (2^256..2^259) ≡ hi4*C = hi4*(977 + 64*2^26).
    hi4 = e[NLIMB - 1] >> 9
    f0 = e[0] + cout * _FOLD260[0] + hi4 * 977
    f1 = e[1] + cout * _FOLD260[1] + (f0 >> RADIX)
    f2 = e[2] + cout * _FOLD260[2] + hi4 * 64
    x2 = torch.cat(
        [torch.stack([f0 & MASK, f1, f2]), e[3 : NLIMB - 1],
         (e[NLIMB - 1] & 0x1FF)[None]],
        dim=0,
    )
    e2, _cout2 = _ks_exact(x2)  # value < 2^256 + 31C < 2^260: no carry out
    return e2


def fe_canon(a: torch.Tensor, bounds: Bounds = None) -> torch.Tensor:
    """Weak -> canonical representative in [0, p), exact 13-bit limbs."""
    e = _exact_lt_2p(a, list(W2) if bounds is None else list(bounds))
    d = e - _col(_P_LIMBS, a)
    borrow = _lookahead((d < 0).to(torch.int32), (d == 0).to(torch.int32))
    sub = (d - _shift_up(borrow, 1)) & MASK
    ge = borrow[NLIMB - 1] == 0  # no net borrow -> e >= p
    return torch.where(ge[None], sub, e)


def fe_is_zero(a: torch.Tensor, bounds: Bounds = None) -> torch.Tensor:
    """a ≡ 0 mod p? Returns (...,) bool (batch shape without limb axis)."""
    e = _exact_lt_2p(a, list(W2) if bounds is None else list(bounds))
    return (e == 0).all(dim=0) | (e == _col(_P_LIMBS, a)).all(dim=0)


def fe_is_zero_many(vals: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Zero tests for k same-shape elements in one widened pass along the
    lane axis."""
    k = len(vals)
    z = fe_is_zero(torch.cat(list(vals), dim=-1))
    n = z.shape[-1] // k
    return tuple(z[..., i * n : (i + 1) * n] for i in range(k))


def _sqr_n(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = fe_sqr(x)
    return x


def fe_pow_runs(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a static exponent by an addition chain over its runs of ones
    (the schedule of `ops/limbs.py::fe_pow_runs`, so results are limb for
    limb identical)."""
    assert e > 0
    rep = {1: (x, 1)}  # rep[k] = (x^(2^k - 1), 2^k - 1)

    def get_rep(k: int):
        if k not in rep:
            a = k // 2
            b = k - a
            va, ea = get_rep(a)
            vb, eb = get_rep(b)
            ee = (ea << b) + eb
            assert ee == (1 << k) - 1
            rep[k] = (fe_mul(_sqr_n(va, b), vb), ee)
        return rep[k]

    runs = []  # (bit, length), MSB-first
    for ch in bin(e)[2:]:
        bit = int(ch)
        if runs and runs[-1][0] == bit:
            runs[-1][1] += 1
        else:
            runs.append([bit, 1])
    acc, e_acc = get_rep(runs[0][1])
    pending = 0
    for bit, length in runs[1:]:
        if bit == 0:
            pending += length
            continue
        blk, eb = get_rep(length)
        acc = fe_mul(_sqr_n(acc, pending + length), blk)
        e_acc = (e_acc << (pending + length)) + eb
        pending = 0
    acc = _sqr_n(acc, pending)
    e_acc <<= pending
    assert e_acc == e, "power chain bookkeeping broke"
    return acc


def fe_inv_chain(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2) (0 -> 0)."""
    return fe_pow_runs(a, P_INT - 2)


def fe_sqrt_chain(a: torch.Tensor) -> torch.Tensor:
    """Candidate square root a^((p+1)/4); the caller checks its square."""
    return fe_pow_runs(a, (P_INT + 1) // 4)
