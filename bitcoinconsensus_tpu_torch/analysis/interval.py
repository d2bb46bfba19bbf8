"""Interval abstract interpretation and determinism gate over aten graphs.

The port's counterpart of `bitcoinconsensus_tpu/analysis/interval.py`. The
port's field pipeline rests on the same claim as the JAX package's: every
intermediate of the radix-2^13 arithmetic fits a signed int32 lane.
`ops/limbs.py` tracks that claim by hand, with static per-limb bounds beside
the tensors; this module re-derives per-element integer intervals for every
aten operation of a traced function, with no access to that bookkeeping.

How a function is read:

- It is traced with `make_fx(functionalize(fn), tracing_mode="fake")`: fake
  tensors of the argument shapes, no data, and a graph of aten operations
  without in-place updates (`out[1:] += c` becomes `slice_scatter`).
- A function that branches on tensor values cannot be traced without data;
  that is reported as a `determinism` violation (the counterpart of the JAX
  engine rejecting a `while` whose trip count depends on data). Python loops
  unroll in the trace, so no fixpoint or widening is needed.
- The allowlist IS the rule registry `RULES`, keyed by aten overload: an
  operation without a transfer rule is an `allowlist` violation.

The theorem, and one deliberate difference from the JAX engine. The JAX
engine lets int32 add, sub, mul and shl wrap transiently and demands the
lane range only at observations (shifts right, compares, converts,
outputs), because XLA's int32 ring operations wrap by definition. PyTorch
gives no such guarantee for int32 overflow, and the port's `limbs.py` forms
its schoolbook columns below 2^31 on purpose. So the port's rule is
stricter: EVERY signed integer intermediate must fit its lane; a result
that may leave it is an `overflow` violation, clamped so that one failure
does not cascade. Unsigned values (uint8 bytes) wrap by definition and are
reduced mod 2^w; bools are 0/1.

The abstraction. An `AbstractArray` holds (lo, hi) bounds of the TRUE
integer value for a grid of cells: each axis of the tensor is either
tracked (one cell per row) or joined (one cell for the whole axis). Axis 0
is the limb axis in this code base, so `rows0()` is directly comparable to
the hand-tracked bounds. A grid holds at most `CELL_CAP` cells, the size of
the JAX engine's two-axis grid at `ROW_CAP` rows each; the cells may lie on
any axes, which keeps `limbs._conv` exact: it re-cuts its (20, 40) product
grid into 800 rows and back into (20, 39) columns. Beyond the cap the
trailing tracked axes are joined. Cells read from `torch.empty` scratch
that was never written carry an `undef` mark; a use of such a value is a
`ref` violation (`analysis/kernel_check.py` builds on this).

Exact floats. A float32 value carries a certificate, `exactf`: every element
is an integer of magnitude at most 2^24, so the float holds it exactly (the
JAX engine's carried exact-float domain). Its bounds are those of the
integer. `FLOAT_CHECKS` maps each vetted operation to a check that grants
the certificate: an int -> float32 convert of values within 2^24; add, sub
and mul whose result stays within 2^24; a sum or a matrix product whose
accumulated bound (terms x largest |term|, whatever the order of the
partial sums) stays within 2^24; operations that only move values. An
operation producing a float without a check (`pow`, say), or failing its
check, is a `float` violation and demotes the certificate; the demotion's
site rides along (`fwhy`), and every later observation of the value cites
it: a float -> int convert, a compare, an output. A float value that loses
its certificate through an operand travels on without a new violation until
it is observed. Only float32 carries the certificate. `Report.exactness`
records each float value with its bound and whether it is exact.
"""

from __future__ import annotations

import math
import operator
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = [
    "AbstractArray",
    "Report",
    "TensorSpec",
    "Violation",
    "analyze",
    "prove",
    "uninitialised",
    "RULES",
    "FLOAT_CHECKS",
    "EXACT_F32",
    "ROW_CAP",
    "CELL_CAP",
]

ROW_CAP = 64
CELL_CAP = ROW_CAP * ROW_CAP
EXACT_F32 = 1 << 24  # integers up to 2^24 are exact in a float32 mantissa
_TRACE_CAP = 4096  # entries kept in Report.exactness
# A reshape may materialise a grid this large before it is collapsed again.
_SCRATCH_CAP = 16 * CELL_CAP

aten = torch.ops.aten


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one argument (the counterpart of
    `jax.ShapeDtypeStruct`)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _kind(dtype: torch.dtype) -> Tuple[str, int]:
    if dtype == torch.bool:
        return "bool", 1
    if dtype.is_floating_point or dtype.is_complex:
        return "float", 0
    info = torch.iinfo(dtype)
    return ("int" if info.min < 0 else "uint"), info.bits


def _lane(dtype: torch.dtype) -> Tuple[int, int]:
    kind, bits = _kind(dtype)
    if kind == "bool":
        return 0, 1
    if kind == "float":  # beyond any float32 value
        return -(1 << 128), 1 << 128
    if kind == "uint":
        return 0, (1 << bits) - 1
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def _obj(x) -> np.ndarray:
    if isinstance(x, np.ndarray) and x.dtype == object:
        return x
    a = np.asarray(x)
    if a.dtype == object:
        return a
    out = np.empty(a.shape, dtype=object)
    out[...] = a.tolist() if a.ndim else a.item()
    return out


class AbstractArray:
    """Bounds (lo, hi) of the true integer value of every element, kept per
    cell of a grid. `lo` and `hi` are numpy object arrays of Python ints with
    one axis per tensor axis, each of size 1 (joined) or the tensor's size
    (tracked). `undef` is None or a bool grid marking cells of scratch never
    written; `src` names that scratch. For a float value, `exactf` is its
    exact-integer certificate and `fwhy` where it was lost."""

    __slots__ = ("shape", "dtype", "lo", "hi", "undef", "src", "exactf", "fwhy")

    def __init__(self, shape, dtype, lo, hi, undef=None, src=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.lo = lo
        self.hi = hi
        self.undef = undef
        self.src = src
        self.exactf = False
        self.fwhy: Optional[str] = None

    def joined(self) -> Tuple[int, int]:
        return int(self.lo.min()), int(self.hi.max())

    def rows0(self) -> List[Tuple[int, int]]:
        """Per-axis-0 row hulls, one entry per row of the tensor."""
        if not self.shape:
            return [self.joined()]
        n = self.shape[0]
        if n == 0:
            return []
        if self.lo.shape[0] == 1:
            return [self.joined()] * n
        rest = tuple(range(1, self.lo.ndim))
        lo = self.lo.min(axis=rest) if rest else self.lo
        hi = self.hi.max(axis=rest) if rest else self.hi
        return [(int(a), int(b)) for a, b in zip(lo, hi)]

    def __repr__(self):
        return (f"AbstractArray({self.shape}, {self.dtype}, grid={self.lo.shape}, "
                f"hull={self.joined()})")


def _wrap_mod(lo, hi, bits):
    m = 1 << bits

    def cell(a, b):
        if b - a >= m:
            return 0, m - 1
        a2 = a % m
        b2 = a2 + (b - a)
        return (0, m - 1) if b2 >= m else (a2, b2)

    return np.frompyfunc(cell, 2, 2)(lo, hi)


def mk(shape, dtype, lo, hi, undef=None, src=None) -> AbstractArray:
    """Normalise and build: broadcast the bounds to one grid, reduce unsigned
    values mod 2^w, clamp bools, join uniform axes, keep the cell cap."""
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    if math.prod(shape) == 0:
        z = _obj(np.zeros((1,) * nd, dtype=np.int64))
        return AbstractArray(shape, dtype, z, z.copy())
    arrs = [_obj(lo), _obj(hi)]
    if undef is not None:
        arrs.append(np.asarray(undef, dtype=bool))
    arrs = [a.reshape((1,) * (nd - a.ndim) + a.shape) if a.ndim < nd else a
            for a in arrs]
    grid = np.broadcast_shapes(*(a.shape for a in arrs))
    if len(grid) != nd or any(g not in (1, s) for g, s in zip(grid, shape)):
        raise ValueError(f"bounds grid {grid} does not fit shape {shape}")
    arrs = [np.broadcast_to(a, grid) for a in arrs]
    lo, hi = arrs[0], arrs[1]
    und = arrs[2] if undef is not None else None
    kind, bits = _kind(dtype)
    if kind == "bool":
        lo = np.minimum(np.maximum(lo, 0), 1)
        hi = np.maximum(np.minimum(hi, 1), 0)
    elif kind == "uint":
        lo, hi = _wrap_mod(lo, hi, bits)
    for d in range(nd):
        if lo.shape[d] > 1:
            first = (slice(None),) * d + (slice(0, 1),)
            if ((lo == lo[first]).all() and (hi == hi[first]).all()
                    and (und is None or (und == und[first]).all())):
                lo, hi = lo[first], hi[first]
                und = und[first] if und is not None else None
    d = nd - 1
    while lo.size > CELL_CAP and d >= 0:
        if lo.shape[d] > 1:
            lo = lo.min(axis=d, keepdims=True)
            hi = hi.max(axis=d, keepdims=True)
            und = und.any(axis=d, keepdims=True) if und is not None else None
        d -= 1
    if und is not None and not und.any():
        und, src = None, None
    return AbstractArray(shape, dtype, np.array(lo, dtype=object),
                         np.array(hi, dtype=object),
                         None if und is None else np.array(und), src)


def const(value, dtype=None) -> AbstractArray:
    if isinstance(value, bool):
        dtype = dtype or torch.bool
        value = int(value)
    dtype = dtype or torch.int64
    return mk((), dtype, value, value)


def full_range(shape, dtype) -> AbstractArray:
    lo, hi = _lane(dtype)
    return mk(shape, dtype, lo, hi)


def uninitialised(shape, dtype, name: str) -> AbstractArray:
    """Scratch as `torch.empty` gives it: any value, and every cell marked
    as never written."""
    lo, hi = _lane(dtype)
    av = mk(shape, dtype, lo, hi, undef=np.ones((1,) * len(shape), bool),
            src=name)
    av.fwhy = f"scratch `{name}` never written"
    return av


def _certify(av: AbstractArray, why: str) -> AbstractArray:
    """Grant a float value the exact-integer certificate where its bounds
    allow it."""
    if _kind(av.dtype)[0] == "float":
        lo, hi = av.joined()
        av.exactf = av.dtype == torch.float32 and max(-lo, hi) <= EXACT_F32
        av.fwhy = None if av.exactf else why
    return av


def from_bounds(spec: TensorSpec, bounds) -> AbstractArray:
    """None: the dtype's lane; (lo, hi): every element; a list of (lo, hi):
    one per axis-0 row; an AbstractArray: as given. A float argument with
    bounds holds those integers exactly when they lie within 2^24; without
    bounds it is uncertified."""
    if isinstance(bounds, AbstractArray):
        return bounds
    if bounds is None:
        if _kind(spec.dtype)[0] == "float":
            av = mk(spec.shape, spec.dtype, -(1 << 128), 1 << 128)
            av.fwhy = "an argument without declared bounds"
            return av
        return full_range(spec.shape, spec.dtype)
    if isinstance(bounds, tuple):
        av = mk(spec.shape, spec.dtype, int(bounds[0]), int(bounds[1]))
    else:
        rows = np.array([[int(lo), int(hi)] for lo, hi in bounds], dtype=object)
        g = (len(rows),) + (1,) * (len(spec.shape) - 1)
        av = mk(spec.shape, spec.dtype, rows[:, 0].reshape(g), rows[:, 1].reshape(g))
    return _certify(av, "declared argument bounds beyond 2^24")


def from_concrete(t: torch.Tensor) -> AbstractArray:
    """A constant tensor of the graph, bounded exactly per cell; a float
    constant is certified when every value is an integer within 2^24."""
    a = t.detach().cpu()
    if a.dtype == torch.bool:
        a = a.to(torch.int64)
    integral = True
    if a.dtype.is_floating_point:
        f = a.double().numpy()
        integral = bool(np.isfinite(f).all() and (f == np.round(f)).all())
        v = np.clip(np.nan_to_num(f), -2.0 ** 126, 2.0 ** 126)
        lo, hi = np.floor(v).astype(object), np.ceil(v).astype(object)
    else:
        v = a.numpy().astype(np.int64) if a.numel() else np.zeros(a.shape, np.int64)
        lo = hi = v
    d = lo.ndim - 1
    while lo.size > CELL_CAP and d >= 0:
        lo, hi = lo.min(axis=d, keepdims=True), hi.max(axis=d, keepdims=True)
        d -= 1
    av = mk(tuple(t.shape), t.dtype, lo, hi)
    if not integral:
        av.fwhy = "a constant that is not an integer"
        return av
    return _certify(av, "a constant beyond 2^24")


@dataclass
class Violation:
    kind: str  # overflow | allowlist | determinism | float | ref | grid | smem | internal
    where: str
    msg: str

    def __str__(self):
        return f"[{self.kind}] {self.where}: {self.msg}"


@dataclass
class Report:
    name: str
    ok: bool = True
    violations: List[Violation] = field(default_factory=list)
    prim_counts: Dict[str, int] = field(default_factory=dict)
    n_nodes: int = 0
    out_bounds: List[List[Tuple[int, int]]] = field(default_factory=list)
    max_observed: int = 0  # largest |bound| proven for a signed intermediate
    notes: List[str] = field(default_factory=list)
    # Launch-contract facts (analysis/kernel_check.py): the grid and the
    # shared memory one block declares.
    grid: Optional[Tuple[int, ...]] = None
    smem_peak_bytes: Optional[int] = None
    # One entry per float value: {where, op, exact, bound[, reason]}.
    exactness: List[dict] = field(default_factory=list)
    n_float: int = 0  # float values seen (entries beyond the cap included)

    def violate(self, kind: str, where: str, msg: str) -> None:
        self.ok = False
        self.violations.append(Violation(kind, where, msg))

    def to_dict(self) -> dict:
        d = {
            "kernel": self.name,
            "ok": self.ok,
            "violations": [{"kind": v.kind, "where": v.where, "msg": v.msg}
                           for v in self.violations],
            "n_nodes": self.n_nodes,
            "prim_counts": dict(sorted(self.prim_counts.items())),
            "max_observed": int(self.max_observed),
            "out_bounds": [[[int(lo), int(hi)] for lo, hi in rows]
                           for rows in self.out_bounds],
            "notes": self.notes,
        }
        if self.grid is not None:
            d["grid"] = [int(g) for g in self.grid]
        if self.smem_peak_bytes is not None:
            d["smem_peak_bytes"] = int(self.smem_peak_bytes)
        if self.n_float:
            d["n_float"] = self.n_float
            d["exactness"] = self.exactness
        return d


# ---------------------------------------------------------------------------
# Transfer rules. RULES maps an aten overload to fn(o, *args, **kwargs) ->
# AbstractArray (or a tuple of them), where `o` carries the node's output
# shape and dtype; tensor arguments arrive as AbstractArrays, the rest as
# they are in the graph. The keys double as the op allowlist.

RULES: Dict[object, Callable] = {}
# Rules that move values without using them: scratch never written may pass
# through these; any other rule reading it is a `ref` violation.
MOVES = set()


@dataclass
class _Out:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    report: Optional[Report] = None
    where: str = ""

    def violate(self, kind: str, msg: str) -> None:
        if self.report is not None:
            self.report.violate(kind, self.where, msg)


def _rule(*ops, moves=False):
    def deco(fn):
        for op in ops:
            RULES[op] = fn
            if moves:
                MOVES.add(op)
        return fn
    return deco


def _av(x) -> AbstractArray:
    if isinstance(x, AbstractArray):
        return x
    if isinstance(x, (bool, int)):
        return const(x)
    raise TypeError(f"unsupported scalar operand {x!r}")


def _ew(o, fn, *xs) -> AbstractArray:
    xs = [_av(x) for x in xs]
    lo, hi = fn(*[b for x in xs for b in (x.lo, x.hi)])
    return mk(o.shape, o.dtype, lo, hi)


def _cells(fn, n_in):
    return np.frompyfunc(fn, n_in, 2)


def _add(alo, ahi, blo, bhi):
    return alo + blo, ahi + bhi


def _sub(alo, ahi, blo, bhi):
    return alo - bhi, ahi - blo


def _mul(alo, ahi, blo, bhi):
    ps = [alo * blo, alo * bhi, ahi * blo, ahi * bhi]
    return (np.minimum(np.minimum(ps[0], ps[1]), np.minimum(ps[2], ps[3])),
            np.maximum(np.maximum(ps[0], ps[1]), np.maximum(ps[2], ps[3])))


def _scaled(x, alpha):
    x = _av(x)
    if alpha == 1:
        return x
    lo, hi = _mul(x.lo, x.hi, alpha, alpha)
    return mk(x.shape, x.dtype, lo, hi)


@_rule(aten.add.Tensor)
def _r_add(o, a, b, alpha=1):
    return _ew(o, _add, a, _scaled(b, alpha))


@_rule(aten.sub.Tensor)
def _r_sub(o, a, b, alpha=1):
    return _ew(o, _sub, a, _scaled(b, alpha))


@_rule(aten.mul.Tensor)
def _r_mul(o, a, b):
    return _ew(o, _mul, a, b)


@_rule(aten.abs.default)
def _r_abs(o, a):
    def cell(lo, hi):
        if lo >= 0:
            return lo, hi
        if hi <= 0:
            return -hi, -lo
        return 0, max(-lo, hi)
    return _ew(o, _cells(cell, 2), a)


@_rule(aten.clamp.default)
def _r_clamp(o, a, min=None, max=None):  # noqa: A002 (aten's names)
    lo, hi = a.lo, a.hi
    if min is not None:
        lo, hi = np.maximum(lo, min), np.maximum(hi, min)
    if max is not None:
        lo, hi = np.minimum(lo, max), np.minimum(hi, max)
    return mk(o.shape, o.dtype, lo, hi)


def _up2m1(v: int) -> int:
    return (1 << max(v, 0).bit_length()) - 1


def _bitwise(o, op, a, b):
    kind, bits = _kind(o.dtype)
    lane = _lane(o.dtype)
    if kind == "bool":
        a, b = _to_bool(a), _to_bool(b)

    def cell(alo, ahi, blo, bhi):
        if alo == ahi and blo == bhi:
            v = op(alo, blo)
            return v, v
        if kind == "bool":
            if op is operator.and_:
                return min(alo, blo), min(ahi, bhi)
            if op is operator.or_:
                return max(alo, blo), max(ahi, bhi)
            return 0, 1
        a_nn, b_nn = alo >= 0, blo >= 0
        if op is operator.and_:
            # x & y <= y for any x when y >= 0 (two's complement).
            if a_nn and b_nn:
                return 0, min(ahi, bhi)
            if a_nn:
                return 0, ahi
            if b_nn:
                return 0, bhi
        elif a_nn and b_nn:
            return 0, _up2m1(max(ahi, bhi))
        return lane
    return _ew(o, _cells(cell, 4), a, b)


@_rule(aten.bitwise_and.Tensor, aten.bitwise_and.Scalar)
def _r_and(o, a, b):
    return _bitwise(o, operator.and_, a, b)


@_rule(aten.bitwise_or.Tensor)
def _r_or(o, a, b):
    return _bitwise(o, operator.or_, a, b)


@_rule(aten.bitwise_xor.Tensor)
def _r_xor(o, a, b):
    return _bitwise(o, operator.xor, a, b)


@_rule(aten.bitwise_not.default)
def _r_not(o, a):
    if _kind(o.dtype)[0] == "bool":
        return _ew(o, lambda lo, hi: (1 - hi, 1 - lo), _to_bool(a))
    return _ew(o, lambda lo, hi: (-hi - 1, -lo - 1), a)


def _shift(o, a, s, left):
    bits = _kind(o.dtype)[1]
    s = _av(s)
    slo, shi = s.joined()
    if slo < 0 or shi >= bits:
        raise ValueError(f"shift amount [{slo}, {shi}] outside [0, {bits})")

    def f(x, k):
        return x << k if left else x >> k

    def cell(alo, ahi, klo, khi):
        vs = [f(x, k) for x in (alo, ahi) for k in (klo, khi)]
        return min(vs), max(vs)
    return _ew(o, _cells(cell, 4), a, s)


@_rule(aten.__rshift__.Scalar, aten.__rshift__.Tensor)
def _r_rshift(o, a, s):
    return _shift(o, a, s, left=False)


@_rule(aten.__lshift__.Scalar)
def _r_lshift(o, a, s):
    return _shift(o, a, s, left=True)


def _cmp(o, a, b, name):
    def lt(alo, ahi, blo, bhi):  # (surely true, surely false)
        return ahi < blo, alo >= bhi

    def le(alo, ahi, blo, bhi):
        return ahi <= blo, alo > bhi

    def eq(alo, ahi, blo, bhi):
        return alo == ahi == blo == bhi, ahi < blo or bhi < alo

    def cell(alo, ahi, blo, bhi):
        if name in ("gt", "ge"):
            alo, ahi, blo, bhi = blo, bhi, alo, ahi
        t, f = {"lt": lt, "gt": lt, "le": le, "ge": le, "eq": eq,
                "ne": eq}[name](alo, ahi, blo, bhi)
        if name == "ne":
            t, f = f, t
        return (1 if t else 0), (0 if f else 1)
    return _ew(o, _cells(cell, 4), a, b)


for _name in ("lt", "le", "gt", "ge", "eq", "ne"):
    _rule(getattr(aten, _name).Tensor, getattr(aten, _name).Scalar)(
        lambda o, a, b, _n=_name: _cmp(o, a, b, _n))


def _to_bool(a) -> AbstractArray:
    a = _av(a)
    if a.dtype == torch.bool:
        return a

    def cell(lo, hi):
        return (1 if lo > 0 or hi < 0 else 0), (0 if lo == hi == 0 else 1)
    lo, hi = _cells(cell, 2)(a.lo, a.hi)
    return mk(a.shape, torch.bool, lo, hi)


@_rule(aten.where.self)
def _r_where(o, c, a, b):
    c = _to_bool(c)

    def cell(clo, chi, alo, ahi, blo, bhi):
        if clo == 1:
            return alo, ahi
        if chi == 0:
            return blo, bhi
        return min(alo, blo), max(ahi, bhi)
    a, b = _av(a), _av(b)
    lo, hi = _cells(cell, 6)(c.lo, c.hi, a.lo, a.hi, b.lo, b.hi)
    return mk(o.shape, o.dtype, lo, hi)


def _convert(o, a) -> AbstractArray:
    a = _av(a)
    if o.dtype == torch.bool:
        b = _to_bool(a)
        return mk(o.shape, o.dtype, b.lo, b.hi, b.undef, b.src)
    return mk(o.shape, o.dtype, a.lo, a.hi, a.undef, a.src)


@_rule(aten._to_copy.default, moves=True)
def _r_to_copy(o, a, **_kw):
    return _convert(o, a)


@_rule(aten.alias.default, aten.clone.default, aten.detach.default,
       aten.lift_fresh_copy.default, aten.view.default,
       aten._unsafe_view.default, moves=True)
def _r_view(o, a, *_args, **_kw):
    return _reshape(a, o.shape)


def _materialise(a: AbstractArray, axes) -> Tuple[np.ndarray, ...]:
    """The grid of `a` with `axes` expanded to the tensor's full size."""
    g = list(a.lo.shape)
    for d in axes:
        g[d] = a.shape[d]
    und = a.undef if a.undef is not None else np.zeros(a.lo.shape, bool)
    return tuple(np.broadcast_to(x, g) for x in (a.lo, a.hi, und))


def _reshape(a: AbstractArray, shape) -> AbstractArray:
    a = _av(a)
    shape = tuple(int(s) for s in shape)
    src = a.shape
    if src == shape:
        return mk(shape, a.dtype, a.lo, a.hi, a.undef, a.src)
    # Keep the longest common trailing run of axes as it is; re-cut the
    # leading axes, expanding their grid (bounded by _SCRATCH_CAP).
    for k in range(len(src) + 1):
        m = len(shape) - (len(src) - k)
        if m < 0 or src[k:] != shape[m:]:
            continue
        if math.prod(src[:k]) != math.prod(shape[:m]):
            continue
        keep = a.lo.shape[k:]
        if math.prod(src[:k]) * math.prod(keep) > _SCRATCH_CAP:
            break
        lo, hi, und = _materialise(a, range(k))
        g = shape[:m] + keep
        return mk(shape, a.dtype, lo.reshape(g), hi.reshape(g),
                  und.reshape(g) if a.undef is not None else None, a.src)
    lo, hi = a.joined()
    und = None if a.undef is None else np.array(a.undef.any())
    return mk(shape, a.dtype, lo, hi, und, a.src)


@_rule(aten.unsqueeze.default, moves=True)
def _r_unsqueeze(o, a, dim):
    return _reshape(a, o.shape)


@_rule(aten.expand.default, moves=True)
def _r_expand(o, a, size, implicit=False):
    a = _av(a)
    pad = len(o.shape) - len(a.shape)
    g = (1,) * pad + a.lo.shape
    und = None if a.undef is None else a.undef.reshape(g)
    return mk(o.shape, a.dtype, a.lo.reshape(g), a.hi.reshape(g), und, a.src)


@_rule(aten.permute.default, moves=True)
def _r_permute(o, a, dims):
    und = None if a.undef is None else np.transpose(a.undef, dims)
    return mk(o.shape, a.dtype, np.transpose(a.lo, dims),
              np.transpose(a.hi, dims), und, a.src)


@_rule(aten.t.default, moves=True)
def _r_t(o, a):
    return _r_permute(o, a, list(range(len(a.shape)))[::-1])


@_rule(aten.mm.default)
def _r_mm(o, a, b):
    """(M, K) @ (K, N): each output cell is K times the product interval of
    its row of `a` and column of `b`, joined over K."""
    K = a.shape[1]
    alo, ahi = a.lo.min(axis=1), a.hi.max(axis=1)  # (M or 1,)
    blo, bhi = b.lo.min(axis=0), b.hi.max(axis=0)  # (N or 1,)
    lo, hi = _mul(alo[:, None], ahi[:, None], blo[None, :], bhi[None, :])
    return mk(o.shape, o.dtype, lo * K, hi * K)


def mm_sum_abs_bound(a: AbstractArray, b: AbstractArray) -> int:
    """K x max|a| x max|b|: a bound on every partial sum of a product's
    accumulation, whatever its order."""
    (alo, ahi), (blo, bhi) = a.joined(), b.joined()
    return a.shape[1] * max(-alo, ahi) * max(-blo, bhi)


@_rule(aten.pow.Tensor_Scalar)
def _r_pow(o, a, exponent):
    if not isinstance(exponent, int) or exponent < 0:
        raise ValueError(f"exponent {exponent!r} is not a non-negative integer")

    def cell(lo, hi):
        ends = (lo ** exponent, hi ** exponent)
        if exponent % 2 == 0 and lo <= 0 <= hi:
            return 0, max(ends)
        return min(ends), max(ends)
    return _ew(o, _cells(cell, 2), a)


@_rule(aten.remainder.Scalar)
def _r_remainder(o, a, other):
    """`a % d` for a positive integer constant d (the verdict checksum's
    weights): a value already in [0, d) is kept; any other lands in
    [0, d - 1], the sign of a positive divisor's remainder."""
    if not isinstance(other, int) or other <= 0:
        raise ValueError(f"divisor {other!r} is not a positive integer")

    def cell(lo, hi):
        return (lo, hi) if 0 <= lo and hi < other else (0, other - 1)
    return _ew(o, _cells(cell, 2), a)


def _index_grid(x: np.ndarray, d: int, idx) -> np.ndarray:
    """Index axis d of a grid: tracked axes take `idx`, joined ones row 0."""
    if x.shape[d] == 1:
        idx = 0 if isinstance(idx, int) else slice(0, 1)
    return x[(slice(None),) * d + (idx,)]


@_rule(aten.select.int, moves=True)
def _r_select(o, a, dim, index):
    dim %= len(a.shape)
    index %= a.shape[dim]
    und = None if a.undef is None else _index_grid(a.undef, dim, index)
    return mk(o.shape, a.dtype, _index_grid(a.lo, dim, index),
              _index_grid(a.hi, dim, index), und, a.src)


def _slice_of(n: int, start, end, step) -> slice:
    return slice(*slice(start, end, step or 1).indices(n))


@_rule(aten.slice.Tensor, moves=True)
def _r_slice(o, a, dim=0, start=None, end=None, step=1):
    dim %= len(a.shape)
    sl = _slice_of(a.shape[dim], start, end, step)
    und = None if a.undef is None else _index_grid(a.undef, dim, sl)
    return mk(o.shape, a.dtype, _index_grid(a.lo, dim, sl),
              _index_grid(a.hi, dim, sl), und, a.src)


@_rule(aten.cat.default, moves=True)
def _r_cat(o, tensors, dim=0):
    parts = [_av(t) for t in tensors if math.prod(_av(t).shape)]
    if not parts:
        return mk(o.shape, o.dtype, 0, 0)
    nd = len(o.shape)
    dim %= nd
    grids = []
    for p in parts:
        lo, hi, und = _materialise(p, [dim])
        grids.append((lo, hi, und))
    g = [max(x[0].shape[d] for x in grids) if d != dim else None
         for d in range(nd)]
    full = []
    for lo, hi, und in grids:
        gg = tuple(lo.shape[d] if d == dim else g[d] for d in range(nd))
        full.append([np.broadcast_to(x, gg) for x in (lo, hi, und)])
    lo, hi, und = (np.concatenate([f[i] for f in full], axis=dim)
                   for i in range(3))
    src = next((p.src for p in parts if p.src), None)
    return mk(o.shape, o.dtype, lo, hi, und if und.any() else None, src)


@_rule(aten.stack.default, moves=True)
def _r_stack(o, tensors, dim=0):
    dim %= len(o.shape)
    parts = []
    for t in tensors:
        t = _av(t)
        shp = t.shape[:dim] + (1,) + t.shape[dim:]
        parts.append(_reshape(t, shp))
    return _r_cat(o, parts, dim)


@_rule(aten.copy.default, moves=True)
def _r_copy(o, dst, src, non_blocking=False):
    src = _av(src)
    pad = len(o.shape) - len(src.shape)
    g = (1,) * pad + src.lo.shape
    und = None if src.undef is None else src.undef.reshape(g)
    return _convert(o, AbstractArray(o.shape, src.dtype, src.lo.reshape(g),
                                     src.hi.reshape(g), und, src.src))


@_rule(aten.slice_scatter.default, moves=True)
def _r_slice_scatter(o, base, src, dim=0, start=None, end=None, step=1):
    """`base` with the rows start:end:step of axis `dim` replaced by `src`."""
    base, src = _av(base), _av(src)
    nd = len(o.shape)
    dim %= nd
    region = _slice_of(o.shape[dim], start, end, step)
    blo, bhi, bund = _materialise(base, [dim])
    g = [blo.shape[d] if d == dim else max(blo.shape[d], src.lo.shape[d])
         for d in range(nd)]
    if math.prod(g) > _SCRATCH_CAP:
        (blo_, bhi_), (slo_, shi_) = base.joined(), src.joined()
        und = base.undef is not None or src.undef is not None
        return mk(o.shape, o.dtype, min(blo_, slo_), max(bhi_, shi_),
                  np.array(und) if und else None, base.src or src.src)
    lo, hi, und = (np.array(np.broadcast_to(x, g)) for x in (blo, bhi, bund))
    slo, shi, sund = _materialise(src, [])
    idx = (slice(None),) * dim + (region,)
    lo[idx], hi[idx], und[idx] = slo, shi, sund
    return mk(o.shape, o.dtype, lo, hi, und if und.any() else None,
              base.src or src.src)


@_rule(aten.sum.dim_IntList)
def _r_sum(o, a, dim=None, keepdim=False, dtype=None):
    a = _av(a)
    nd = len(a.shape)
    dims = sorted({d % nd for d in (dim if dim else range(nd))})
    lo, hi = a.lo, a.hi
    for d in dims:
        if lo.shape[d] == a.shape[d]:
            lo, hi = lo.sum(axis=d, keepdims=True), hi.sum(axis=d, keepdims=True)
        else:
            lo, hi = lo * a.shape[d], hi * a.shape[d]
    if not keepdim:
        keep = [d for d in range(nd) if d not in dims]
        lo = lo.reshape([lo.shape[d] for d in keep])
        hi = hi.reshape([hi.shape[d] for d in keep])
    return mk(o.shape, o.dtype, lo, hi)


@_rule(aten.all.dim)
def _r_all(o, a, dim, keepdim=False):
    """True where every element is surely nonzero; false where one surely
    is zero."""
    b = _to_bool(a)
    dim %= len(b.shape)
    lo, hi = b.lo.min(axis=dim, keepdims=keepdim), b.hi.min(axis=dim, keepdims=keepdim)
    return mk(o.shape, o.dtype, lo, hi)


@_rule(aten.zeros_like.default, aten.new_zeros.default)
def _r_zeros(o, *_args, **_kw):
    return mk(o.shape, o.dtype, 0, 0)


@_rule(aten.ones_like.default)
def _r_ones(o, *_args, **_kw):
    return mk(o.shape, o.dtype, 1, 1)


@_rule(aten.arange.default)
def _r_arange(o, end, **_kw):
    return mk(o.shape, o.dtype, 0, max(end - 1, 0))


def _check_index(o, idx: AbstractArray, n: int) -> None:
    lo, hi = idx.joined()
    if lo < -n or hi > n - 1:
        o.violate("ref", f"index interval [{lo}, {hi}] is out of bounds for "
                  f"an axis of {n} rows")


@_rule(aten.index.Tensor)
def _r_index(o, a, indices):
    """Advanced indexing: each indexed axis is joined, the other axes keep
    their cells, and the broadcast index axes go where torch puts them (in
    place of adjacent indexed axes, else first)."""
    a = _av(a)
    adv = [d for d, ix in enumerate(indices) if ix is not None]
    for d in adv:
        _check_index(o, _av(indices[d]), a.shape[d])
    lo, hi = a.lo, a.hi
    for d in adv:
        lo, hi = lo.min(axis=d, keepdims=True), hi.max(axis=d, keepdims=True)
    keep = [lo.shape[d] for d in range(len(a.shape)) if d not in adv]
    n_idx = len(o.shape) - len(keep)
    pos = adv[0] if adv == list(range(adv[0], adv[-1] + 1)) else 0
    g = keep[:pos] + [1] * n_idx + keep[pos:]
    return mk(o.shape, o.dtype, lo.reshape(g), hi.reshape(g))



def _intersect(a: AbstractArray, b: AbstractArray) -> AbstractArray:
    """Cells bounded by both (both bound the same values)."""
    out = mk(a.shape, a.dtype, np.maximum(a.lo, b.lo), np.minimum(a.hi, b.hi),
             a.undef, a.src)
    out.exactf, out.fwhy = a.exactf, a.fwhy
    return out


# ---------------------------------------------------------------------------
# Exact-float checks. FLOAT_CHECKS maps an operation whose float32 result
# may keep the certificate to fn(result, *args, **kwargs) -> None when the
# result is exact, else the reason it may have rounded. Every operand must
# be certified too (checked by the walk).


def _fits_f32(res: AbstractArray) -> Optional[str]:
    lo, hi = res.joined()
    if max(-lo, hi) <= EXACT_F32:
        return None
    return (f"float result interval [{lo}, {hi}] exceeds the 2^24 "
            "exact-integer range of a float32 mantissa")


def _check_convert(res, a, **_kw) -> Optional[str]:
    if _kind(a.dtype)[0] == "float":
        return None
    lo, hi = a.joined()
    if max(-lo, hi) <= EXACT_F32:
        return None
    return (f"convert to float of interval [{lo}, {hi}] exceeds the 2^24 "
            "exact-integer float32 range")


def _check_sum(res, a, dim=None, keepdim=False, dtype=None) -> Optional[str]:
    nd = len(a.shape)
    dims = {d % nd for d in (dim if dim else range(nd))}
    terms = math.prod(a.shape[d] for d in dims)
    lo, hi = a.joined()
    bound = terms * max(-lo, hi)
    if bound <= EXACT_F32:
        return None
    return (f"accumulated sum bound {terms} x {max(-lo, hi)} = {bound} exceeds "
            "2^24: a float32 partial sum may round, whatever the result")


def _check_mm(res, a, b) -> Optional[str]:
    bound = mm_sum_abs_bound(a, b)
    if bound <= EXACT_F32:
        return None
    return (f"accumulated product bound K x max|a| x max|b| = {bound} exceeds "
            "2^24: a float32 partial sum may round, whatever the result")


FLOAT_CHECKS: Dict[object, Callable] = {
    op: (lambda res, *a, **k: None) for op in MOVES}
FLOAT_CHECKS.update({
    aten._to_copy.default: _check_convert,
    aten.add.Tensor: lambda res, *a, **k: _fits_f32(res),
    aten.sub.Tensor: lambda res, *a, **k: _fits_f32(res),
    aten.mul.Tensor: lambda res, *a, **k: _fits_f32(res),
    aten.abs.default: lambda res, *a, **k: None,
    aten.where.self: lambda res, *a, **k: None,
    aten.zeros_like.default: lambda res, *a, **k: None,
    aten.new_zeros.default: lambda res, *a, **k: None,
    aten.ones_like.default: lambda res, *a, **k: None,
    aten.sum.dim_IntList: _check_sum,
    aten.mm.default: _check_mm,
})


def _refiner(holds_lo, holds_hi, fails_lo, fails_hi):
    """x restricted to the values where cmp(x, k) holds (or fails): each
    entry maps k to a new bound, or is None (no bound). Returns None when no
    element can take the branch, and x unrefined when only some cells
    cannot (a cell has no empty form)."""
    def refine(x: AbstractArray, k: int, holds: bool):
        new_lo, new_hi = (holds_lo, holds_hi) if holds else (fails_lo, fails_hi)
        lo = x.lo if new_lo is None else np.maximum(x.lo, new_lo(k))
        hi = x.hi if new_hi is None else np.minimum(x.hi, new_hi(k))
        empty = np.asarray(lo > hi, dtype=bool)
        if empty.all():
            return None
        return x if empty.any() else mk(x.shape, x.dtype, lo, hi)
    return refine


_CMP_REFINE = {
    aten.ge.Scalar: _refiner(lambda k: k, None, None, lambda k: k - 1),
    aten.gt.Scalar: _refiner(lambda k: k + 1, None, None, lambda k: k),
    aten.le.Scalar: _refiner(None, lambda k: k, lambda k: k + 1, None),
    aten.lt.Scalar: _refiner(None, lambda k: k - 1, lambda k: k, None),
}
_ELEMENTWISE = {
    aten.add.Tensor, aten.sub.Tensor, aten.mul.Tensor, aten.abs.default,
    aten.bitwise_and.Scalar, aten.__rshift__.Scalar, aten.__lshift__.Scalar,
}


# ---------------------------------------------------------------------------
# The graph walk.


class _Walk:
    def __init__(self, report: Report, where: str, scratch: Sequence[int] = ()):
        self.report = report
        self.where = where
        self.scratch = set(scratch)

    def _fit(self, av: AbstractArray, where: str, what: str) -> AbstractArray:
        """The strict rule: a signed integer value must fit its lane."""
        if _kind(av.dtype)[0] != "int":
            return av
        llo, lhi = _lane(av.dtype)
        lo, hi = av.joined()
        if lo >= llo and hi <= lhi:
            if av.dtype == torch.int32:
                self.report.max_observed = max(self.report.max_observed,
                                               -lo, hi)
            return av
        self.report.violate(
            "overflow", where,
            f"{what}: derived interval [{lo}, {hi}] exceeds the "
            f"{av.dtype} lane range [{llo}, {lhi}]")
        return mk(av.shape, av.dtype, np.maximum(np.minimum(av.lo, lhi), llo),
                  np.minimum(np.maximum(av.hi, llo), lhi), av.undef, av.src)

    def run(self, gm: torch.fx.GraphModule, inputs: List[AbstractArray]):
        env: Dict[torch.fx.Node, object] = {}
        placeholders = {}
        args_iter = iter(inputs)
        rep = self.report

        def read(x):
            return env[x] if isinstance(x, torch.fx.Node) else x

        for node in gm.graph.nodes:
            w = f"{self.where}/{node.name}"
            if node.op == "placeholder":
                placeholders[node] = len(placeholders)
                env[node] = next(args_iter)
            elif node.op == "get_attr":
                env[node] = from_concrete(getattr(gm, node.target))
            elif node.op == "output":
                return pytree.tree_flatten(pytree.tree_map(read, node.args[0]))[0]
            elif node.op == "call_function":
                target = node.target
                if target is operator.getitem:
                    env[node] = read(node.args[0])[node.args[1]]
                    continue
                name = str(target)
                w = f"{w}:{name}"
                rep.n_nodes += 1
                rep.prim_counts[name] = rep.prim_counts.get(name, 0) + 1
                if (target is aten.copy_.default
                        and placeholders.get(node.args[0]) in self.scratch):
                    env[node] = None  # the functional graph writes scratch back
                    continue
                env[node] = self._call(node, target, name, w, read)
                if target is aten.where.self and env[node] is not None:
                    refined = self._where_refined(node, env)
                    if refined is not None:
                        env[node] = _intersect(env[node], refined)
            else:
                raise ValueError(f"unexpected graph node {node.op} {node}")
        raise ValueError("graph has no output")

    def _where_refined(self, node, env) -> Optional[AbstractArray]:
        """where(cmp(x, k), a, b): a is re-derived with x refined by the
        comparison holding, b with it failing, along elementwise paths of
        x's own shape (so every element of a reads the element of x that
        the condition tested). The signed-digit recoder's `where(t >= 16,
        t - 32, t)` is [-16, 15] this way, and not [-32, 32]."""
        c, a, b = node.args
        if not (isinstance(c, torch.fx.Node) and c.target in _CMP_REFINE):
            return None
        x, k = c.args
        shape = tuple(node.meta["val"].shape)
        if not (isinstance(x, torch.fx.Node) and isinstance(k, int)
                and tuple(x.meta["val"].shape) == shape
                and tuple(c.meta["val"].shape) == shape):
            return None
        branches = []
        for val, holds in ((a, True), (b, False)):
            xr = _CMP_REFINE[c.target](env[x], k, holds)
            if xr is None:  # this branch is never taken
                continue
            branches.append(_av(self._reeval(val, x, xr, env, shape, 6)))
        if not branches:
            return None
        out = branches[0]
        for br in branches[1:]:
            out = mk(shape, out.dtype, np.minimum(out.lo, br.lo),
                     np.maximum(out.hi, br.hi))
        return mk(shape, node.meta["val"].dtype, out.lo, out.hi)

    def _reeval(self, n, x, xr, env, shape, depth):
        if n is x:
            return xr
        if (not isinstance(n, torch.fx.Node) or depth == 0
                or n.op != "call_function" or n.target not in _ELEMENTWISE):
            return env[n] if isinstance(n, torch.fx.Node) else n
        args = [self._reeval(v, x, xr, env, shape, depth - 1) for v in n.args]
        if all(r is (env[v] if isinstance(v, torch.fx.Node) else v)
               for r, v in zip(args, n.args)):
            return env[n]  # does not read x
        meta = n.meta["val"]
        if tuple(meta.shape) != shape:
            return env[n]
        out = RULES[n.target](_Out(shape, meta.dtype), *args, **n.kwargs)
        return _intersect(env[n], out)

    def _call(self, node, target, name, w, read):
        rep = self.report
        val = node.meta.get("val")
        outs = val if isinstance(val, (tuple, list)) else [val]
        metas = [_Out(tuple(v.shape), v.dtype, rep, w) for v in outs
                 if isinstance(v, torch.Tensor)]
        if not metas:
            rep.violate("allowlist", w, f"`{name}` yields no tensor; it is not "
                        "on the allowlist")
            return None
        args = pytree.tree_map(read, node.args)
        kwargs = pytree.tree_map(read, dict(node.kwargs))
        kwargs.pop("device", None)
        kwargs.pop("layout", None)
        kwargs.pop("pin_memory", None)
        # A copy overwrites its destination: only the source's values count.
        read_args = (args[1:], kwargs) if target is aten.copy.default else (args, kwargs)
        operands = [a for a in pytree.tree_flatten(read_args)[0]
                    if isinstance(a, AbstractArray)]
        inexact = next((a for a in operands if _kind(a.dtype)[0] == "float"
                        and not a.exactf), None)
        if inexact is not None and any(_kind(m.dtype)[0] != "float"
                                       for m in metas):
            what = ("float->int convert of a non-exact float (the value may "
                    "have rounded; only exact-integer floats are vetted)"
                    if target is aten._to_copy.default else
                    f"`{name}` observes a non-exact float")
            rep.violate("float", w, f"{what} [{inexact.fwhy}]")
            res = [full_range(m.shape, m.dtype) for m in metas]
            return res if isinstance(val, (tuple, list)) else res[0]
        rule = RULES.get(target)
        if rule is not None and target not in MOVES:
            for a in operands:
                if a.undef is not None:
                    rep.violate("ref", w, f"read of scratch `{a.src}` before "
                                "any write: uninitialised shared memory must "
                                "not feed a consensus verdict")
                    break
        if rule is None:
            rep.violate("allowlist", w, f"`{name}` is not on the allowlist (no "
                        "vetted transfer rule); add a rule to "
                        "analysis/interval.py RULES once its soundness is checked")
            res = [full_range(m.shape, m.dtype) for m in metas]
        else:
            try:
                out = rule(metas[0] if len(metas) == 1 else metas, *args, **kwargs)
            except Exception as e:  # an analyzer bug never passes silently
                rep.violate("internal", w, f"transfer rule for `{name}` raised "
                            f"{type(e).__name__}: {e}")
                out = [full_range(m.shape, m.dtype) for m in metas]
            res = list(out) if isinstance(out, (tuple, list)) else [out]
            res = [self._fit(r, w, name) for r in res]
        for r in res:
            if _kind(r.dtype)[0] == "float":
                self._float(r, target, name, w, inexact, args, kwargs)
        return res if isinstance(val, (tuple, list)) else res[0]

    def _float(self, r: AbstractArray, target, name: str, w: str,
               inexact: Optional[AbstractArray], args, kwargs) -> None:
        """Decide the certificate of the float result `r` (see the module
        docstring), and record it in the report's exactness trace."""
        rep = self.report
        check = FLOAT_CHECKS.get(target)
        if r.dtype != torch.float32:
            why = (f"`{name}` yields {r.dtype}: only float32 carries the "
                   "exact-float certificate")
        elif check is None:
            why = (f"`{name}` has no vetted exact-float transfer: the value "
                   "may have rounded, so its certificate is demoted here")
        elif inexact is not None:
            why = None
        else:
            try:
                why = check(r, *args, **kwargs)
            except Exception as e:  # an analyzer bug never passes silently
                why = f"exact-float check raised {type(e).__name__}: {e}"
        r.exactf = why is None and inexact is None
        if why is not None:
            rep.violate("float", w, why)
            r.fwhy = f"certificate demoted at {w}: {why}"
        elif inexact is not None:
            r.fwhy = inexact.fwhy
        else:
            r.fwhy = None
        rep.n_float += 1
        if len(rep.exactness) < _TRACE_CAP:
            lo, hi = r.joined()
            entry = {"where": w, "op": name, "exact": r.exactf,
                     "bound": int(min(max(-lo, hi), 1 << 128))}
            if not r.exactf:
                entry["reason"] = r.fwhy
            rep.exactness.append(entry)


def _trace(fn, specs: Sequence[TensorSpec]) -> torch.fx.GraphModule:
    from torch.fx.experimental.proxy_tensor import make_fx

    example = [torch.zeros(s.shape, dtype=s.dtype) for s in specs]
    # Real tensors the function keeps (cached constants) enter the graph as
    # constants.
    return make_fx(torch.func.functionalize(lambda *a: fn(*a)),
                   tracing_mode="fake", _allow_non_fake_inputs=True)(*example)


def prove(fn, specs: Sequence[TensorSpec], inputs: Sequence[AbstractArray],
          report: Report, where: str, scratch: Sequence[int] = ()):
    """Trace `fn` at `specs` and run the interval walk from `inputs`,
    recording into `report`. Returns the output AbstractArrays, or None when
    the function could not be traced."""
    try:
        gm = _trace(fn, specs)
    except Exception as e:
        text = f"{type(e).__name__}: {e}".splitlines()[0]
        if "DataDependent" in type(e).__name__ or "data-dependent" in text:
            report.violate("determinism", where, "control flow depends on "
                           f"tensor values, so no single graph covers every "
                           f"input ({text})")
        else:
            report.violate("internal", where, f"trace failed: {text}")
        return None
    outs = _Walk(report, where, scratch).run(gm, list(inputs))
    for i, o in enumerate(outs):
        if isinstance(o, AbstractArray) and o.undef is not None:
            report.violate("ref", f"{where}/out{i}", f"output {i} carries "
                           f"scratch `{o.src}` that was never written")
        if (isinstance(o, AbstractArray) and _kind(o.dtype)[0] == "float"
                and not o.exactf):
            report.violate("float", f"{where}/out{i}", "inexact float value "
                           f"written to output {i} [{o.fwhy}]")
    return [o for o in outs if isinstance(o, AbstractArray)]


def check_within(report: Report, where: str, out: AbstractArray, hand) -> None:
    """Hold the derived rows of an output against a hand-tracked bound."""
    derived = out.rows0()
    hand = [hand] * len(derived) if isinstance(hand, tuple) else list(hand)
    if len(hand) != len(derived):
        report.violate("internal", where, f"hand bound has {len(hand)} rows, "
                       f"derived has {len(derived)}")
        return
    for r, ((lo, hi), (hlo, hhi)) in enumerate(zip(derived, hand)):
        if lo < hlo or hi > hhi:
            report.violate(
                "overflow", f"{where}[{r}]",
                f"hand-tracked bound [{hlo}, {hhi}] understates derived "
                f"interval [{lo}, {hi}]: the static bounds in ops/limbs.py "
                "are wrong for this op; fix the hand bound, not the analyzer")


def analyze(fn, arg_specs: Sequence[TensorSpec], name: str, in_bounds=None,
            out_within=None) -> Report:
    """Prove `fn` over inputs within `in_bounds` (flat argument index ->
    bounds, see `from_bounds`); `out_within` holds one hand bound (or None)
    per output."""
    report = Report(name=name)
    inputs = [from_bounds(s, (in_bounds or {}).get(i))
              for i, s in enumerate(arg_specs)]
    outs = prove(fn, arg_specs, inputs, report, name)
    for i, o in enumerate(outs or []):
        report.out_bounds.append(o.rows0())
        if out_within is not None and i < len(out_within) \
                and out_within[i] is not None:
            check_within(report, f"{name}/out{i}", o, out_within[i])
    return report
