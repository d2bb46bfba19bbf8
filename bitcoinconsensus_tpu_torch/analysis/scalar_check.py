"""Scalar-schedule prover: machine-checked certificates for the port's
scalar pipeline and for the CUDA kernel's recoder and ladder.

The port's counterpart of `bitcoinconsensus_tpu/analysis/scalar_check.py`.
The interval prover (`interval.py`) certifies limb-level arithmetic; this
module certifies the scalar-level semantics above it (the digit recoders,
the GLV lattice split and the window schedules), so a window-order swap or
a carry off-by-one is a FAIL instead of a silent consensus bug. Where the
reference certifies a Pallas kernel body, this module certifies the CUDA
kernel that replaced it, `csrc/verify_tiles.cu`. Four legs, all fail-closed
(an unproven or unevaluable claim is FAIL, never VACUOUS):

1. **Bit-slice recombination theorems** (`Lin`, `_sym_eval_graph`): each
   recoder (`scalar_bits`-based `_digits`, `_digits128`, the raw digits
   feeding `_signed_digits128`, and the `bytes_to_limbs` packing) is traced
   to an aten graph, with the tracer of `interval.py`, and evaluated over
   symbolic bit variables b_i. Every window digit must equal
   Σ_{i<width} 2^i · b_{w·width+i} exactly, which makes the radix
   recombination an identity, not a sampled test. The same evaluator holds
   SHA-256's digest unpack (`ops/sha256._bytes_from_words`) to the exact
   big-endian byte slices of its words. An aten operation the
   evaluator has no rule for raises `SymUnsupported`, and the target FAILs.
   (The reference also proves plane congruences inside its interval
   domain; the port's interval domain has no congruence facts yet.)

2. **Carry automaton** of the signed recoder: (a) every transition of the
   2 x 32-state spec δ keeps d + 32·c' = v + c with d ∈ [-16, 15], and the
   top window never carries out; the traced torch recoder is one forward
   carry chain of 26 steps; (c) three recoders run through all 1,584
   reachable (window, value, carry) states and are compared with an
   independent host recoder: the port's torch `_signed_digits128`, the
   `.cu`'s own `signed_carries` / `signed_digit` compiled for the host with
   g++ (`csrc/verify_tiles_host.cpp`), and, on a CUDA device, the same
   device functions through `vt_recode` (`ops/verify_tiles.recode`).

3. **Exact GLV certificate** for `crypto/glv.py`: λ³ ≡ 1 (mod n), β³ ≡ 1
   (mod p), λ·G = (β·x, y), the adjugate basis with determinant n, the
   bound |k1|, |k2| < 2^128, and a structured-k panel through
   `split_lambda`.

4. **Schedule ledger** over the two ladders of the verify kernel. The plain
   version (`verify_tiles_reference`, plain Python loops) runs under spies
   on its `jacobian_*` calls, digit reads and table reads; the CUDA lane
   program (`verify_lane_slots`) runs in its host build with the `VT_TRACE`
   hooks recording each doubling, mixed add, join, digit (with its
   effective sign) and P- and G-table read. From either record the ledger
   accumulates R ← 2·R per doubling and R ← R + d·P per add, and asserts
   coefficient(w) == 2^(5·w) for each of the 26 signed windows of both GLV
   halves: the ledger sum equals the recoder's radix decomposition, which
   catches a swapped window order, a dropped doubling and doubling-count
   drift in one identity. Doublings the kernel skips while R is infinity
   are credited as doublings of the identity, and the ledger checks R is
   the identity there. The G loop must read window i at table row d - 1
   (d·256^i·G) with no doublings. Source checks on the `.cu` text pin what
   the walk cannot see (the P table read at 2 * (d - 1), the sign
   sgn ^ neg, β on the λ half only, the hooks compiling to nothing under
   nvcc), and each walk doubles as a differential: the lane must verify.

`NEGATIVES` holds planted-unsound variants (wrong carry fold, swapped
window order, dropped doubling, out-of-range digit weights, corrupted GLV
constant, and the port's own: a little-endian digest unpack);
`analyze_negative` must REJECT each one.

Registering a new recoder or schedule: add the function name to
`REGISTERED_RECODERS` (the host lint's scalar-coverage rule requires it),
add a `_target_*` entry to `TARGETS` and a `ScheduleSpec` to
`registry.py`, and give it a planted negative if it brings a new failure
mode. `certify_all` emits no metric: the counter comes with the port's
`obs/`.
"""

from __future__ import annotations

import ctypes
import functools
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..crypto import glv as glv_mod
from ..crypto import secp_host as host
from ..ops import _build
from ..ops import curve as curve_mod
from ..ops import limbs as limbs_mod
from ..ops import sha256 as sha_mod
from ..ops import verify_tiles as vt_mod
from . import interval

RADIX = limbs_mod.RADIX
MASK = limbs_mod.MASK
NLIMB = limbs_mod.NLIMB
SGLV_WINDOWS = vt_mod.SGLV_WINDOWS
SGLV_WIDTH = vt_mod.SGLV_WIDTH
VT_SOURCE = _build.CSRC / "verify_tiles.cu"


# --------------------------------------------------------------------------
# results
# --------------------------------------------------------------------------

@dataclass
class CertResult:
    """One certificate: THEOREM (proved, with facts), VACUOUS (ran but
    proved nothing), or FAIL (refuted or unevaluable: fail closed)."""

    name: str
    status: str                      # THEOREM | VACUOUS | FAIL
    facts: Dict[str, Any] = field(default_factory=dict)
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.status == "THEOREM"

    def to_dict(self) -> dict:
        return {"name": self.name, "status": self.status, "ok": self.ok,
                "facts": self.facts, "failures": self.failures}


def _finish(name: str, facts: Dict[str, Any],
            failures: List[str]) -> CertResult:
    if failures:
        return CertResult(name, "FAIL", facts, failures)
    if not facts:
        return CertResult(name, "VACUOUS", facts, ["no facts proven"])
    return CertResult(name, "THEOREM", facts, [])


# --------------------------------------------------------------------------
# Leg 1: symbolic bit-slice evaluator over aten graphs
# --------------------------------------------------------------------------

class SymUnsupported(Exception):
    """An aten operation or operand the bit-slice domain cannot model
    exactly. Callers turn this into FAIL, never into a skip."""


class Lin:
    """Exact integer-linear form  const + Σ coeff_b · b  over bit
    variables b ∈ {0, 1}. All arithmetic is exact Python-int; any operation
    that cannot be represented exactly raises SymUnsupported.

    The *packed* normal form (const == 0, every coefficient a distinct
    power of two, at most one term per bit) is what justifies the
    nonlinear ops: `x >> c` drops positions < c exactly (their sum is
    < 2^c), `x & (2^t - 1)` keeps positions < t, and `x | y` with
    disjoint position sets is addition."""

    __slots__ = ("terms", "const")

    def __init__(self, terms: Optional[Dict[int, int]] = None,
                 const: int = 0):
        self.terms = {b: c for b, c in (terms or {}).items() if c != 0}
        self.const = const

    @property
    def is_const(self) -> bool:
        return not self.terms

    def value_bounds(self) -> Tuple[int, int]:
        lo = self.const + sum(c for c in self.terms.values() if c < 0)
        hi = self.const + sum(c for c in self.terms.values() if c > 0)
        return lo, hi

    def packed(self) -> Optional[Dict[int, int]]:
        """{bit-position: bit-id} if in packed normal form, else None."""
        if self.const != 0:
            return None
        pos: Dict[int, int] = {}
        for b, c in self.terms.items():
            if c <= 0 or (c & (c - 1)) != 0:
                return None
            p = c.bit_length() - 1
            if p in pos:
                return None
            pos[p] = b
        return pos

    def __eq__(self, other):
        if isinstance(other, int):
            return self.is_const and self.const == other
        if not isinstance(other, Lin):
            return NotImplemented
        return self.const == other.const and self.terms == other.terms

    def __hash__(self):
        return hash((self.const, tuple(sorted(self.terms.items()))))

    def __repr__(self):
        ts = " + ".join(f"{c}*b{b}" for b, c in sorted(self.terms.items()))
        return f"Lin({self.const}{' + ' + ts if ts else ''})"

    @staticmethod
    def _coerce(x) -> "Lin":
        if isinstance(x, Lin):
            return x
        if isinstance(x, (bool, int, np.integer)):
            return Lin(const=int(x))
        raise SymUnsupported(f"cannot coerce {type(x).__name__}")

    def __add__(self, other):
        o = Lin._coerce(other)
        t = dict(self.terms)
        for b, c in o.terms.items():
            t[b] = t.get(b, 0) + c
        return Lin(t, self.const + o.const)

    __radd__ = __add__

    def __neg__(self):
        return Lin({b: -c for b, c in self.terms.items()}, -self.const)

    def __sub__(self, other):
        return self + (-Lin._coerce(other))

    def __rsub__(self, other):
        return (-self) + Lin._coerce(other)

    def __mul__(self, other):
        o = Lin._coerce(other)
        if o.is_const:
            k = o.const
            return Lin({b: c * k for b, c in self.terms.items()},
                       self.const * k)
        if self.is_const:
            k = self.const
            return Lin({b: c * k for b, c in o.terms.items()}, o.const * k)
        raise SymUnsupported("nonlinear product of two symbolic forms")

    __rmul__ = __mul__

    def __lshift__(self, other):
        o = Lin._coerce(other)
        if not o.is_const or o.const < 0:
            raise SymUnsupported("symbolic/negative shift amount")
        return self * (1 << o.const)

    def __rshift__(self, other):
        o = Lin._coerce(other)
        if not o.is_const or o.const < 0:
            raise SymUnsupported("symbolic/negative shift amount")
        c = o.const
        if self.is_const:
            if self.const < 0:
                raise SymUnsupported("rshift of negative constant")
            return Lin(const=self.const >> c)
        pos = self.packed()
        if pos is None:
            raise SymUnsupported("rshift of non-packed form")
        return Lin({b: 1 << (p - c) for p, b in pos.items() if p >= c})

    def __and__(self, other):
        o = Lin._coerce(other)
        if self.is_const and o.is_const:
            if self.const < 0 or o.const < 0:
                raise SymUnsupported("bitand of negative constants")
            return Lin(const=self.const & o.const)
        if o.is_const:
            sym, mask = self, o.const
        elif self.is_const:
            sym, mask = o, self.const
        else:
            raise SymUnsupported("bitand of two symbolic forms")
        if mask < 0 or (mask & (mask + 1)) != 0:
            raise SymUnsupported(f"bitand with non-low-mask {mask:#x}")
        t = mask.bit_length()          # mask == 2^t - 1
        pos = sym.packed()
        if pos is None:
            raise SymUnsupported("bitand of non-packed form")
        return Lin({b: 1 << p for p, b in pos.items() if p < t})

    __rand__ = __and__

    def __or__(self, other):
        o = Lin._coerce(other)
        if self.is_const and self.const == 0:
            return o
        if o.is_const and o.const == 0:
            return self
        if self.is_const and o.is_const:
            if self.const < 0 or o.const < 0:
                raise SymUnsupported("bitor of negative constants")
            return Lin(const=self.const | o.const)
        pa, pb = self.packed(), o.packed()
        if pa is None or pb is None or (set(pa) & set(pb)):
            raise SymUnsupported("bitor of overlapping/non-packed forms")
        return self + o

    __ror__ = __or__


def _sym_const(arr) -> np.ndarray:
    src = np.asarray(arr)
    out = np.empty(src.shape, dtype=object)
    flat = out.reshape(-1)
    for i, v in enumerate(src.reshape(-1)):
        flat[i] = Lin(const=int(v))
    return out


def _sym(x):
    """An operand as an object array of Lin (python scalars become 0-d)."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, (bool, int, np.integer)):
        return _sym_const(np.asarray(int(x)))
    raise SymUnsupported(f"operand of type {type(x).__name__}")


def _int_dtype(dtype) -> None:
    if dtype is not None and (dtype.is_floating_point or dtype.is_complex):
        raise SymUnsupported(f"convert to non-integer {dtype}")


def _ew(fn):
    def rule(a, b, **_kw):
        x, y = np.broadcast_arrays(_sym(a), _sym(b))
        out = np.empty(x.shape, dtype=object)
        fo, fx, fy = out.reshape(-1), x.reshape(-1), y.reshape(-1)
        for i in range(fo.shape[0]):
            fo[i] = fn(fx[i], fy[i])
        return out
    return rule


def _slice(x, dim=0, start=None, end=None, step=1):
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(start, end, step)
    return x[tuple(sl)]


def _sum(x, dims=None, keepdim=False, dtype=None):
    _int_dtype(dtype)
    axes = tuple(range(x.ndim)) if not dims else tuple(d % x.ndim for d in dims)
    out = np.sum(x, axis=axes, keepdims=keepdim)
    return out if isinstance(out, np.ndarray) else np.asarray(out, dtype=object)


def _to_copy(x, dtype=None, **_kw):
    _int_dtype(dtype)
    return x


def _shape(x, shape):
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = x.size // known
    return tuple(shape)


def _const_tensor(shape):
    return _sym_const(np.zeros(tuple(shape), dtype=np.int64))


# Transfer rules, keyed by aten overload name: the operations the recoders
# and packers trace to, and the ring operations. Integer conversions are the
# identity on this domain: every theorem also proves the range it needs.
SYM_RULES: Dict[str, Callable[..., Any]] = {
    "aten.view.default": lambda x, s: np.reshape(x, _shape(x, s)),
    "aten._unsafe_view.default": lambda x, s: np.reshape(x, _shape(x, s)),
    "aten.unsqueeze.default": lambda x, d: np.expand_dims(
        x, d if d >= 0 else d + x.ndim + 1),
    "aten.permute.default": lambda x, dims: np.transpose(x, dims),
    "aten.slice.Tensor": _slice,
    "aten.select.int": lambda x, d, i: np.take(x, i, axis=d),
    "aten.cat.default": lambda ts, dim=0: np.concatenate(
        [_sym(t) for t in ts], axis=dim),
    "aten.stack.default": lambda ts, dim=0: np.stack(
        [_sym(t) for t in ts], axis=dim),
    "aten.clone.default": lambda x, **_k: x,
    "aten.detach.default": lambda x: x,
    "aten.lift_fresh_copy.default": lambda x: x,
    "aten._to_copy.default": _to_copy,
    "aten.arange.default": lambda end, **_k: _sym_const(np.arange(end)),
    "aten.new_zeros.default": lambda x, s, **_k: _const_tensor(s),
    "aten.add.Tensor": lambda a, b, alpha=1: _ew(lambda p, q: p + q * alpha)(a, b),
    "aten.sub.Tensor": lambda a, b, alpha=1: _ew(lambda p, q: p - q * alpha)(a, b),
    "aten.mul.Tensor": _ew(lambda p, q: p * q),
    "aten.bitwise_and.Scalar": _ew(lambda p, q: p & q),
    "aten.bitwise_or.Tensor": _ew(lambda p, q: p | q),
    "aten.__rshift__.Tensor": _ew(lambda p, q: p >> q),
    "aten.__rshift__.Scalar": _ew(lambda p, q: p >> q),
    "aten.__lshift__.Scalar": _ew(lambda p, q: p << q),
    "aten.sum.dim_IntList": _sum,
}


def _sym_eval_graph(gm: torch.fx.GraphModule, args: Sequence[np.ndarray]):
    """Interpret a traced aten graph over numpy object arrays of `Lin`."""
    env: Dict[Any, Any] = {}
    placeholders = iter(args)

    def load(a):
        return torch.fx.node.map_arg(a, lambda n: env[n])

    out = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = np.asarray(next(placeholders), dtype=object)
        elif node.op == "get_attr":
            env[node] = _sym_const(getattr(gm, node.target).detach().numpy())
        elif node.op == "call_function":
            name = str(node.target)
            rule = SYM_RULES.get(name)
            if rule is None:
                raise SymUnsupported(f"aten op `{name}` outside the bit-slice "
                                     "domain")
            env[node] = rule(*load(node.args), **load(node.kwargs))
        elif node.op == "output":
            out = load(node.args[0])
        else:
            raise SymUnsupported(f"graph node kind `{node.op}`")
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _sym_eval(fn, spec: interval.TensorSpec, seed: np.ndarray):
    return _sym_eval_graph(interval._trace(fn, [spec]), [seed])


def _seed_limb_bits(nlimb: int) -> np.ndarray:
    """(nlimb, 1) object array: limb l = Σ_{i<RADIX} 2^i · b_{RADIX·l+i}.
    Bit id == absolute bit position of the packed integer."""
    out = np.empty((nlimb, 1), dtype=object)
    for l in range(nlimb):
        out[l, 0] = Lin({RADIX * l + i: 1 << i for i in range(RADIX)})
    return out


def _seed_byte_bits(nbytes: int) -> np.ndarray:
    """(1, nbytes) object array: byte k = Σ_{i<8} 2^i · b_{8k+i}."""
    out = np.empty((1, nbytes), dtype=object)
    for k in range(nbytes):
        out[0, k] = Lin({8 * k + i: 1 << i for i in range(8)})
    return out


def _expected_window(w: int, width: int) -> Lin:
    return Lin({w * width + i: 1 << i for i in range(width)})


def _prove_digit_slices(name: str, fn, seed: np.ndarray,
                        count: int, width: int,
                        facts: Dict[str, Any],
                        failures: List[str]) -> None:
    """Core recombination theorem: fn(seed)[w] == Σ 2^i b_{w·width+i}."""
    try:
        spec = interval.TensorSpec(tuple(int(d) for d in seed.shape),
                                   torch.int32)
        (digits,) = _sym_eval(fn, spec, seed)
    except SymUnsupported as e:
        failures.append(f"{name}: symbolic evaluation failed: {e}")
        return
    except Exception as e:  # noqa: BLE001 (unevaluable is FAIL)
        failures.append(f"{name}: {type(e).__name__}: {e}")
        return
    if digits.shape[0] != count:
        failures.append(f"{name}: expected {count} windows, traced "
                        f"{digits.shape[0]}")
        return
    max_digit = 0
    recomb = Lin()
    for w in range(count):
        d = digits[w].reshape(-1)[0]
        want = _expected_window(w, width)
        if d != want:
            failures.append(
                f"{name}: window {w} is {d!r}, not the exact bit slice "
                f"{want!r}: recombination broken")
            continue
        lo, hi = d.value_bounds()
        max_digit = max(max_digit, hi)
        if not (0 <= lo and hi <= (1 << width) - 1):
            failures.append(f"{name}: window {w} range [{lo},{hi}] "
                            f"outside [0, 2^{width}-1]")
        recomb = recomb + d * (1 << (w * width))
    want_total = Lin({i: 1 << i for i in range(count * width)})
    if recomb != want_total:
        failures.append(f"{name}: Σ d_w·2^(w·width) != Σ 2^i·b_i over the "
                        f"consumed {count * width} bits")
    if not failures:
        facts[name] = {
            "windows": count, "width": width,
            "bits_consumed": count * width,
            "max_digit": max_digit,
            "recombination": "sum(d_w * 2^(w*width)) == sum(2^i * b_i)",
        }


def _prove_bytes_to_limbs(nbytes: int, nlimb: int,
                          facts: Dict[str, Any],
                          failures: List[str]) -> None:
    name = f"bytes_to_limbs[{nbytes}B->{nlimb}L]"
    try:
        (limbs,) = _sym_eval(
            lambda u8: limbs_mod.bytes_to_limbs(u8, nlimb=nlimb),
            interval.TensorSpec((1, nbytes), torch.uint8),
            _seed_byte_bits(nbytes))
    except SymUnsupported as e:
        failures.append(f"{name}: symbolic evaluation failed: {e}")
        return
    except Exception as e:  # noqa: BLE001
        failures.append(f"{name}: {type(e).__name__}: {e}")
        return
    nbits = nbytes * 8
    recomb = Lin()
    for l in range(limbs.shape[0]):
        got = limbs[l].reshape(-1)[0]
        want = Lin({RADIX * l + i: 1 << i for i in range(RADIX)
                    if RADIX * l + i < nbits})
        if got != want:
            failures.append(f"{name}: limb {l} is {got!r}, expected the "
                            f"exact bit slice {want!r}")
            continue
        recomb = recomb + got * (1 << (RADIX * l))
    if recomb != Lin({i: 1 << i for i in range(nbits)}):
        failures.append(f"{name}: Σ limb_l·2^(13·l) != Σ 2^i·b_i")
    if not failures:
        facts[name] = {"bytes": nbytes, "limbs": nlimb,
                       "recombination":
                       "sum(limb_l * 2^(13*l)) == sum(2^i * b_i)"}


def _int_limbs_panel() -> List[int]:
    vals = [0, 1, (1 << 256) - 1, host.P - 1, host.N - 1]
    vals += [1 << i for i in range(256)] + [(1 << i) - 1 for i in range(1, 257)]
    rng = np.random.default_rng(19)
    vals += [int.from_bytes(rng.bytes(32), "little") for _ in range(64)]
    return vals


def _prove_int_limbs(facts: Dict[str, Any], failures: List[str]) -> None:
    """The host packers `int_to_limbs` / `limbs_to_int` are plain Python
    over ints, not aten graphs: they are held, on every single-bit value,
    every all-ones prefix and seeded values, to the packing proven above
    (limb for limb) and to each other (round trip)."""
    vals = _int_limbs_panel()
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    u8 = torch.from_numpy(np.frombuffer(raw, np.uint8).reshape(-1, 32).copy())
    packed = limbs_mod.bytes_to_limbs(u8).numpy()
    bad = 0
    for j, v in enumerate(vals):
        got = limbs_mod.int_to_limbs(v)
        if not np.array_equal(got, packed[:, j]) or limbs_mod.limbs_to_int(got) != v:
            bad += 1
            if bad <= 3:
                failures.append(f"int_to_limbs/limbs_to_int: value {v:#x} "
                                "disagrees with bytes_to_limbs or does not "
                                "round-trip")
    if not bad:
        facts["int_to_limbs[panel]"] = {
            "values": len(vals),
            "rule": "int_to_limbs(v) == bytes_to_limbs(v) limb for limb, "
                    "limbs_to_int(int_to_limbs(v)) == v"}


def _target_digits() -> CertResult:
    facts: Dict[str, Any] = {}
    failures: List[str] = []
    _prove_digit_slices("_digits[w4,c64]",
                        lambda l: curve_mod._digits(l, 4, 64),
                        _seed_limb_bits(NLIMB), 64, 4, facts, failures)
    _prove_digit_slices("_digits[w8,c32]",
                        lambda l: curve_mod._digits(l, 8, 32),
                        _seed_limb_bits(NLIMB), 32, 8, facts, failures)
    return _finish("scalar._digits", facts, failures)


def _target_digits128() -> CertResult:
    facts: Dict[str, Any] = {}
    failures: List[str] = []
    _prove_digit_slices("_digits128[w4,c32]",
                        lambda l: curve_mod._digits128(l, 32, 4),
                        _seed_limb_bits(10), 32, 4, facts, failures)
    _prove_digit_slices("_digits128[w5,c26]",
                        lambda l: curve_mod._digits128(l, 26, 5),
                        _seed_limb_bits(10), 26, 5, facts, failures)
    # Composed with the unpack of a 16-byte (< 2^128) value, the top 5-bit
    # window must touch only bits 125..127: the premise of the no-carry-out
    # claim the automaton leg discharges.
    try:
        (raw,) = _sym_eval(
            lambda u8: curve_mod._digits128(
                limbs_mod.bytes_to_limbs(u8, nlimb=10), 26, 5),
            interval.TensorSpec((1, 16), torch.uint8), _seed_byte_bits(16))
        top = raw[25].reshape(-1)[0]
        want = Lin({125: 1, 126: 2, 127: 4})
        if top != want:
            failures.append(f"top window of _digits128(bytes16) is "
                            f"{top!r}, expected bits 125..127 only")
        else:
            facts["top_window"] = {"bits": [125, 126, 127], "max": 7}
    except SymUnsupported as e:
        failures.append(f"top-window slice: {e}")
    except Exception as e:  # noqa: BLE001
        failures.append(f"top-window slice: {type(e).__name__}: {e}")
    return _finish("scalar._digits128", facts, failures)


def _target_bytes_to_limbs() -> CertResult:
    facts: Dict[str, Any] = {}
    failures: List[str] = []
    _prove_bytes_to_limbs(32, NLIMB, facts, failures)
    _prove_bytes_to_limbs(16, 10, facts, failures)
    _prove_int_limbs(facts, failures)
    return _finish("scalar.bytes_to_limbs", facts, failures)


def _prove_bytes_from_words(fn, cert_name: str) -> CertResult:
    """Byte j of `fn`'s (32,) output over 8 symbolic words must be the exact
    big-endian 8-bit slice of word j // 4: bits 8·(3 - j % 4) .. + 8."""
    facts: Dict[str, Any] = {}
    failures: List[str] = []
    name = "bytes_from_words[8W->32B]"
    seed = np.empty((8,), dtype=object)
    for w in range(8):
        seed[w] = Lin({32 * w + i: 1 << i for i in range(32)})
    try:
        (out,) = _sym_eval(fn, interval.TensorSpec((8,), torch.uint32), seed)
    except SymUnsupported as e:
        failures.append(f"{name}: symbolic evaluation failed: {e}")
        return _finish(cert_name, facts, failures)
    except Exception as e:  # noqa: BLE001 (unevaluable is FAIL)
        failures.append(f"{name}: {type(e).__name__}: {e}")
        return _finish(cert_name, facts, failures)
    flat = np.asarray(out, dtype=object).reshape(-1)
    if flat.shape[0] != 32:
        failures.append(f"{name}: {flat.shape[0]} output bytes, expected 32")
        return _finish(cert_name, facts, failures)
    for j in range(32):
        word, pos = j // 4, j % 4
        sh = 8 * (3 - pos)  # big-endian byte order within each word
        want = Lin({32 * word + sh + i: 1 << i for i in range(8)})
        if flat[j] != want:
            failures.append(f"{name}: byte {j} is {flat[j]!r}, expected the "
                            f"big-endian slice {want!r}")
    if not failures:
        facts[name] = {"words": 8, "bytes": 32, "order": "big-endian",
                       "rule": "byte j == bits 8*(3-j%4)..+8 of word j//4"}
    return _finish(cert_name, facts, failures)


def _target_bytes_from_words() -> CertResult:
    """SHA-256's digest unpack `ops/sha256._bytes_from_words`: the host
    lint's scalar-coverage rule flags its `(w >> shifts) & 0xFF` extraction,
    so it is certified as the limb packers are. The message pack
    `_words_from_bytes` is held too (a fact of the port's own): word w of
    32 symbolic bytes must be bytes 4w .. 4w + 3, the first the most
    significant."""
    cert = _prove_bytes_from_words(sha_mod._bytes_from_words,
                                   "sha256.bytes_from_words")
    name = "words_from_bytes[32B->8W]"
    try:
        (out,) = _sym_eval(sha_mod._words_from_bytes,
                           interval.TensorSpec((32,), torch.uint8),
                           _seed_byte_bits(32).reshape(32))
        flat = np.asarray(out, dtype=object).reshape(-1)
        want = [Lin({8 * (4 * w + k) + i: 1 << (8 * (3 - k) + i)
                     for k in range(4) for i in range(8)}) for w in range(8)]
        if flat.shape[0] != 8 or any(g != x for g, x in zip(flat, want)):
            cert.failures.append(f"{name}: the words are not the big-endian "
                                 f"packs of their four bytes: {list(flat)!r}")
    except Exception as e:  # noqa: BLE001 (unevaluable is FAIL)
        cert.failures.append(f"{name}: {type(e).__name__}: {e}")
    if not cert.failures:
        cert.facts[name] = {"bytes": 32, "words": 8, "order": "big-endian",
                            "rule": "word w == sum 2^(8*(3-k)) byte(4w+k)"}
    return _finish(cert.name, cert.facts, cert.failures)


# --------------------------------------------------------------------------
# Leg 2: carry automaton of the signed recoder
# --------------------------------------------------------------------------

def _ref_signed_recode(x: int, *, threshold: int = 16,
                       wrap: int = 32) -> List[int]:
    """Independent host recoder: 26 signed 5-bit windows, LSB first."""
    assert 0 <= x < 1 << 128
    digits = []
    carry = 0
    for w in range(SGLV_WINDOWS):
        t = ((x >> (5 * w)) & 31) + carry
        carry = 1 if t >= threshold else 0
        digits.append(t - wrap * carry)
    assert carry == 0, "top window carried out"
    return digits


def automaton_lanes() -> List[Tuple[int, int, int, int]]:
    """All 1,584 reachable (x, window, value, carry-in) configurations. The
    lane x = v·32^w (+ 16·32^(w-1) to force carry-in 1) reaches window w
    with value v and carry c: windows < w-1 hold 0, window w-1 holds 16
    (digit -16, carry 1)."""
    lanes = []
    for w in range(SGLV_WINDOWS):
        vmax = 8 if w == SGLV_WINDOWS - 1 else 32
        for v in range(vmax):
            for c in (0, 1):
                if c == 1 and w == 0:
                    continue
                x = v * 32 ** w + (16 * 32 ** (w - 1) if c else 0)
                if x < 1 << 128:
                    lanes.append((x, w, v, c))
    return lanes


def values_to_words(xs: Sequence[int]) -> np.ndarray:
    """Values below 2^128 -> (n, 4) int32 little-endian words."""
    raw = b"".join(int(x).to_bytes(16, "little") for x in xs)
    return np.frombuffer(raw, dtype="<u4").view(np.int32).reshape(-1, 4).copy()


def signed_digits(mag, sgn) -> np.ndarray:
    """(n, 26) magnitudes and signs -> (n, 26) int64 signed digits (the sign
    of a zero digit carries no meaning: the kernel's recoder reports a window
    of 31 plus a carry as |0| with sign 1, and adds nothing for it)."""
    mag = np.asarray(mag, dtype=np.int64)
    return np.where(np.asarray(sgn) != 0, -mag, mag)


def _host_lib() -> ctypes.CDLL:
    """The `.cu`'s host build (`csrc/verify_tiles_host.cpp`), typed."""
    lib = _build.load(_build.VT_HOST)
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.vt_host_recode.argtypes = [vp, vp, vp, ctypes.c_int]
    lib.vt_host_recode.restype = None
    lib.vt_host_trace.argtypes = [vp] + [i32] * 6 + [vp, vp, vp, ctypes.c_int]
    lib.vt_host_trace.restype = ctypes.c_int
    return lib


def host_recode(words: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The `.cu` recoder compiled for the host: (n, 4) int32 words ->
    (n, 26) mags and signs."""
    lib = _host_lib()
    words = np.ascontiguousarray(words, dtype=np.int32)
    if words.ndim != 2 or words.shape[1] != 4:
        raise ValueError("host_recode takes (n, 4) int32 words")
    n = words.shape[0]
    mag = np.zeros((n, SGLV_WINDOWS), np.int32)
    sgn = np.zeros_like(mag)
    lib.vt_host_recode(words.ctypes.data, mag.ctypes.data, sgn.ctypes.data, n)
    return mag, sgn


def _carry_chain(gm: torch.fx.GraphModule) -> Dict[str, Any]:
    """The traced torch recoder is one forward carry chain: digit w compares
    raw[w] + carry_w against 16 and folds by 32, carry_0 is zeros and carry_w
    (w > 0) is the previous comparison. Returns the reference's `structure`
    fact, or raises ValueError naming the first deviation."""
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    ges = [n for n in nodes if str(n.target) == "aten.ge.Scalar"]
    if len(ges) != SGLV_WINDOWS:
        raise ValueError(f"{len(ges)} compares, expected {SGLV_WINDOWS}")
    raw = None
    prev = None
    for w, ge in enumerate(ges):
        add, thr = ge.args
        if thr != 16 or str(add.target) != "aten.add.Tensor":
            raise ValueError(f"compare {w} is not (raw + carry) >= 16")
        sel, carry = add.args
        if str(sel.target) != "aten.select.int" or sel.args[1:] != (0, w):
            raise ValueError(f"step {w} does not read raw window {w} "
                             "(carries must propagate LSB first)")
        if raw is None:
            raw = sel.args[0]
        elif sel.args[0] is not raw:
            raise ValueError(f"step {w} reads another digit tensor")
        if w == 0:
            if str(carry.target) != "aten.zeros_like.default":
                raise ValueError("carry-in of window 0 is not zero")
        elif not (str(carry.target) == "aten._to_copy.default"
                  and carry.args[0] is prev):
            raise ValueError(f"carry-in of window {w} is not compare {w - 1}")
        folds = [u for u in ge.users if str(u.target) == "aten.where.self"]
        if len(folds) != 1 or folds[0].args[2] is not add or \
                folds[0].args[1].args != (add, 32):
            raise ValueError(f"digit {w} is not where(t >= 16, t - 32, t)")
        prev = ge
    return {"scans": 1, "length": SGLV_WINDOWS, "num_carry": 1,
            "reverse": False}


def _enumerate(label: str, digits: np.ndarray, lanes, failures) -> bool:
    bad = 0
    for j, (x, w, v, c) in enumerate(lanes):
        got = [int(d) for d in digits[j]]
        ref = _ref_signed_recode(x)
        if got != ref:
            bad += 1
            if bad <= 3:
                failures.append(f"{label}: (w={w}, v={v}, c={c}) recodes to "
                                f"{got[:4]}…, host reference {ref[:4]}…")
        if sum(d * 32 ** i for i, d in enumerate(got)) != x:
            bad += 1
            if bad <= 6:
                failures.append(f"{label}: Σ d_i·32^i != x (w={w}, v={v}, "
                                f"c={c})")
        if any(abs(d) > 16 for d in got):
            bad += 1
            if bad <= 9:
                failures.append(f"{label}: digit outside [-16,16] at "
                                f"(w={w}, v={v}, c={c})")
    if bad > 9:
        failures.append(f"{label}: …{bad - 9} more mismatching lanes")
    return bad == 0


def prove_carry_automaton(step_fn=None) -> CertResult:
    """Exhaustive proof of the signed-digit recoder.

    `step_fn(t) -> (carry', digit)` defaults to the production fold
    (t >= 16 → t − 32); negatives pass a corrupted fold. The kernel's
    recoder runs through `vt_recode` on cuda:0 when a card is present; on
    the CPU alone that leg is not driven, and its fact is absent."""
    facts: Dict[str, Any] = {}
    failures: List[str] = []

    def default_step(t: int) -> Tuple[int, int]:
        c = 1 if t >= 16 else 0
        return c, t - 32 * c

    step = step_fn or default_step

    # (a) every transition of the 2 x 32 automaton, and the top window
    for c in (0, 1):
        for v in range(32):
            cp, d = step(v + c)
            if d + 32 * cp != v + c:
                failures.append(
                    f"automaton: δ({c},{v}) = (c'={cp}, d={d}) breaks the "
                    f"telescoping invariant d + 32·c' = v + c")
            if not (-16 <= d <= 15) or cp not in (0, 1):
                failures.append(
                    f"automaton: δ({c},{v}) digit {d} / carry {cp} "
                    "outside [-16,15] x {0,1}")
    # top window: raw digit 25 ∈ [0,7] (proven by leg 1), so t = v+c <= 8
    for c in (0, 1):
        for v in range(8):
            cp, _ = step(v + c)
            if cp != 0:
                failures.append(
                    f"automaton: top window carries out at (c={c}, v={v}): "
                    "the no-carry-out claim of the recoders is refuted")
    if not failures:
        facts["transitions"] = {"states": 2 * 32, "invariant":
                                "d + 32·c' = v + c, d ∈ [-16,15]",
                                "top_window_no_carry": "t = v+c <= 8 < 16"}

    # (b) the traced torch recoder is one forward length-26 carry chain
    try:
        gm = interval._trace(vt_mod._signed_digits128,
                             [interval.TensorSpec((10, 1), torch.int32)])
        facts["structure"] = _carry_chain(gm)
    except Exception as e:  # noqa: BLE001
        failures.append(f"structure: {type(e).__name__}: {e}")

    # (c) all 1,584 reachable configurations through each recoder
    lanes = automaton_lanes()
    words = values_to_words([x for x, _, _, _ in lanes])
    checked = ("device == host reference, Σ d·32^w == x, |d| <= 16, all "
               "(window, value, carry) states")
    try:
        mag, sgn = vt_mod._signed_digits128(
            vt_mod.words_to_limbs10(torch.from_numpy(words)))
        if _enumerate("device", signed_digits(mag.T.numpy(), sgn.T.numpy()),
                      lanes, failures):
            facts["device_enumeration"] = {"lanes": len(lanes),
                                           "checked": checked}
    except Exception as e:  # noqa: BLE001
        failures.append(f"device: {type(e).__name__}: {e}")
    try:
        if _enumerate("cu-host", signed_digits(*host_recode(words)), lanes,
                      failures):
            facts["cu_host_enumeration"] = {
                "lanes": len(lanes),
                "recoder": "signed_carries/signed_digit of "
                           "csrc/verify_tiles.cu, built with g++",
                "checked": checked}
    except Exception as e:  # noqa: BLE001 (no compiler is FAIL too)
        failures.append(f"cu-host: {type(e).__name__}: {e}")
    if torch.cuda.is_available():
        device = torch.device("cuda:0")
        try:
            mag, sgn = vt_mod.recode(torch.from_numpy(words).to(device))
            if _enumerate("cuda", signed_digits(mag.cpu().numpy(),
                                                sgn.cpu().numpy()),
                          lanes, failures):
                facts["cuda_enumeration"] = {
                    "lanes": len(lanes),
                    "recoder": "vt_recode on "
                               + torch.cuda.get_device_name(device),
                    "checked": checked}
        except Exception as e:  # noqa: BLE001
            failures.append(f"cuda: {type(e).__name__}: {e}")
    return _finish("scalar._signed_digits128", facts, failures)


def _target_signed_digits128() -> CertResult:
    return prove_carry_automaton()


# --------------------------------------------------------------------------
# Leg 3: exact GLV certificate
# --------------------------------------------------------------------------

def _minrep(x: int, n: int) -> int:
    """Minimal signed representative of x mod n (in (-n/2, n/2])."""
    x %= n
    return x - n if x > n // 2 else x


def prove_glv_constants(B1: Optional[int] = None,
                        B2: Optional[int] = None) -> CertResult:
    """Exact host-side certificate for crypto/glv.py's lattice split.

    With E1 = n·c1 − B2·k and E2 = n·c2 + B1·k (the exact rounding
    errors, |E_i| ≤ n/2 by the round-half-up in split_lambda), the split
    satisfies  n·k2 = −(B1·E1 + B2·E2)  and  n·k1' = −(A1·E1 + A2·E2)
    where A_i = minrep(−λ·B_i mod n) and k1' is the minimal
    representative of k − λ·k2. Hence |k2| ≤ (|B1|+|B2|)/2 + 1 and
    |k1| ≤ (|A1|+|A2|)/2 + 1, both < 2^128: derived, not asserted.
    The determinant A1·B2 − A2·B1 = n pins the basis to the curve order:
    corrupting any of B1/B2/λ/n breaks it (or a cube identity)."""
    facts: Dict[str, Any] = {}
    failures: List[str] = []
    n = host.N
    p = host.P
    lam = glv_mod.LAMBDA
    beta = curve_mod.BETA
    b1 = glv_mod._B1 if B1 is None else B1
    b2 = glv_mod._B2 if B2 is None else B2

    if pow(lam, 3, n) != 1 or lam in (1, n - 1):
        failures.append("λ is not a primitive cube root of 1 mod n")
    if pow(beta, 3, p) != 1 or beta in (1, p - 1):
        failures.append("β is not a primitive cube root of 1 mod p")
    if (lam * lam + lam + 1) % n != 0:
        failures.append("λ² + λ + 1 != 0 mod n")
    ep = host.G.mul(lam).to_affine()
    if ep != (beta * host.G_X % p, host.G_Y):
        failures.append("endomorphism λ·G != (β·x_G, y_G) on the "
                        "generator: β and λ are not paired")
    if not failures:
        facts["identities"] = {"lambda_cubed": 1, "beta_cubed": 1,
                               "endomorphism": "λ·G == (β·x_G, y_G)"}

    if (b2 + b1 * lam) % n != 0:      # row (b2, b1): b2 ≡ -b1·λ
        failures.append("basis row (B2, B1) not in the GLV lattice: "
                        "B2 + B1·λ != 0 mod n")
    a1 = _minrep(-lam * b1, n)
    a2 = _minrep(-lam * b2, n)
    det = a1 * b2 - a2 * b1
    if det != n:
        failures.append(f"adjugate determinant A1·B2 − A2·B1 = {det} "
                        f"!= n: lattice constants corrupted")
    bound_k2 = (abs(b1) + abs(b2)) // 2 + 1
    bound_k1 = (abs(a1) + abs(a2)) // 2 + 1
    if bound_k2 >= 1 << 128:
        failures.append(f"|k2| worst case {bound_k2} >= 2^128")
    if bound_k1 >= 1 << 128:
        failures.append(f"|k1| worst case {bound_k1} >= 2^128")
    if not failures:
        facts["lattice"] = {
            "det": "A1·B2 − A2·B1 == n",
            "k1_bound_bits": bound_k1.bit_length(),
            "k2_bound_bits": bound_k2.bit_length(),
        }

    # structured-k panel through the real split, against the exact theory
    panel = [0, 1, 2, n - 1, lam, (n - lam) % n, (1 << 128) - 1, 1 << 128,
             n // 2, n // 2 + 1, lam - 1, lam + 1]
    for k in panel:
        try:
            s_a1, neg1, s_a2, neg2 = glv_mod.split_lambda(k)
        except Exception as e:  # noqa: BLE001
            failures.append(f"split_lambda({k}) raised "
                            f"{type(e).__name__}: {e}")
            continue
        k1 = -s_a1 if neg1 else s_a1
        k2 = -s_a2 if neg2 else s_a2
        if (k1 + lam * k2 - k) % n != 0:
            failures.append(f"split_lambda({k}): k1 + λ·k2 != k mod n")
        if s_a1 >= 1 << 128 or s_a2 >= 1 << 128:
            failures.append(f"split_lambda({k}): half >= 2^128")
        kk = k % n
        c1 = (b2 * kk + n // 2) // n
        c2 = (-b1 * kk + n // 2) // n
        e1 = n * c1 - b2 * kk
        e2 = n * c2 + b1 * kk
        if abs(e1) > n // 2 + 1 or abs(e2) > n // 2 + 1:
            failures.append(f"split_lambda({k}): rounding error exceeds "
                            "n/2: round-half-up broken")
        want_k2 = -(c1 * glv_mod._B1 + c2 * glv_mod._B2) if B1 is None \
            else -(c1 * b1 + c2 * b2)
        if (k2 - want_k2) % n != 0:
            failures.append(f"split_lambda({k}): k2 disagrees with the "
                            "exact lattice formula")
    if not any("split_lambda" in f for f in failures):
        facts["panel"] = {"cases": len(panel),
                          "checked": "k1 + λ·k2 ≡ k (mod n), halves "
                                     "< 2^128, exact formula match"}
    return _finish("glv.split_lambda", facts, failures)


def _target_glv() -> CertResult:
    return prove_glv_constants()


# --------------------------------------------------------------------------
# Leg 4: schedule ledger
# --------------------------------------------------------------------------

def _ledger(stream, *, halves: int, count: int, width: int, label: str,
            failures: List[str]) -> Optional[Dict[str, Any]]:
    """The weight ledger of a recorded ladder, in order of execution:
    ("double",) R ← 2·R; ("skip", n) n doublings skipped, which must be of
    the identity; ("digit", h, w, d) half h reads window w with signed
    contribution d; ("add", h) R ← R + d·P for the last digit of half h.

    Returns {"values": the per-half scalars accumulated, "skipped": n} after
    asserting coefficient(h, w) == 2^(width·w) for every window of every
    half, or None with failures. The GLV halves are recombined as
    v0 + λ·v1 (mod n) to decide whether R is the identity."""
    coeff: Dict[Tuple[int, int], int] = {}
    vals = [0] * halves
    pending: Dict[int, int] = {}
    skipped = 0
    lam, n = glv_mod.LAMBDA, host.N
    for ev in stream:
        kind = ev[0]
        if kind in ("double", "skip"):
            k = 1 if kind == "double" else ev[1]
            if kind == "skip":
                if (vals[0] + (lam * vals[1] if halves > 1 else 0)) % n:
                    failures.append(f"{label}: {k} doublings skipped while R "
                                    "is not the identity")
                    return None
                skipped += k
            for key in coeff:
                coeff[key] <<= k
            vals = [v << k for v in vals]
        elif kind == "digit":
            _, h, w, d = ev
            if (h, w) in coeff:
                failures.append(f"{label}: window {w} of half {h} read twice")
                return None
            coeff[(h, w)] = 1
            pending[h] = d
        elif kind == "add":
            h = ev[1]
            if h not in pending:
                failures.append(f"{label}: an add of half {h} with no digit "
                                "read before it")
                return None
            vals[h] += pending.pop(h)
    for h in range(halves):
        for w in range(count):
            got, want = coeff.get((h, w)), 1 << (width * w)
            if got != want:
                failures.append(
                    f"{label}: ledger coefficient of half {h} window {w} is "
                    f"{'absent' if got is None else hex(got)}, the radix "
                    f"decomposition requires 2^{width * w}: window order or "
                    "doubling schedule broken")
                return None
    return {"values": vals, "skipped": skipped}


def _iterations(events, per_iter: int, count: int):
    """Cut a region of (name, meta) events into `count` iterations of
    `per_iter` non-read events each (reads stay with the iteration they fall
    in); returns (iterations, the rest)."""
    iters, cur, k = [], [], 0
    for i, ev in enumerate(events):
        cur.append(ev)
        if ev[0] != "read":
            k += 1
            if k == per_iter:
                iters.append(cur)
                cur, k = [], 0
                if len(iters) == count:
                    return iters, events[i + 1:]
    return iters + ([cur] if cur else []), []


def _check_ladder(events, *, count: int, width: int, digit_arrays, sign_arrays,
                  expect_events: List[str], label: str, failures: List[str],
                  digit_value) -> Optional[Tuple[Dict[str, Any], List[int]]]:
    """The per-iteration schedule and the weight ledger of a spied window
    loop (the plain version's and the toy's): every iteration runs exactly
    `expect_events`, reads one window of each digit array (and its sign in
    lockstep), and the ledger holds. `digit_value(array, w)` is the signed
    contribution the read stands for. Returns (facts, the per-array
    scalars the ledger accumulated), or None with failures."""
    iters, _rest = _iterations(events, len(expect_events), count)
    if len(iters) != count:
        failures.append(f"{label}: {len(iters)} window iterations, expected "
                        f"{count}")
        return None
    doubles_seen = set()
    stream = []
    for i, it in enumerate(iters):
        names = [e[0] for e in it if e[0] != "read"]
        if names != expect_events:
            failures.append(f"{label}: iteration {i} schedule {names} != "
                            f"expected {expect_events}")
            return None
        doubles_seen.add(names.count("jacobian_double"))
        reads = [e[1] for e in it if e[0] == "read"]
        digit_reads = [(a, w) for a, w in reads if a in digit_arrays]
        if [a for a, _ in digit_reads] != list(digit_arrays):
            failures.append(f"{label}: iteration {i} reads {digit_reads}, "
                            f"want one window of each of {list(digit_arrays)}")
            return None
        for sa, da in zip(sign_arrays, digit_arrays):
            w = dict(digit_reads)[da]
            if [x for a, x in reads if a == sa] != [w]:
                failures.append(f"{label}: iteration {i} reads {sa} "
                                f"{[x for a, x in reads if a == sa]}, not in "
                                f"lockstep with {da}[{w}]")
                return None
        h = 0
        for e in it:
            if e[0] == "jacobian_double":
                stream.append(("double",))
            elif e[0] == "read" and e[1][0] in digit_arrays:
                stream.append(("digit", digit_arrays.index(e[1][0]), e[1][1],
                               digit_value(*e[1])))
            elif e[0] in ("jacobian_madd_flagged", "jacobian_add_flagged"):
                stream.append(("add", h))
                h += 1
    if doubles_seen != {width}:
        failures.append(f"{label}: doublings per window {doubles_seen} != "
                        f"recoder width {width}: ledger weight mismatch")
        return None
    led = _ledger(stream, halves=len(digit_arrays), count=count, width=width,
                  label=label, failures=failures)
    if led is None:
        return None
    return ({"windows": count, "doubles_per_window": width,
             "order": "descending (w = count-1-i)",
             "ledger": "coeff(w) == 2^(width*w) for every window"},
            led["values"])


class _Recorder:
    def __init__(self):
        self.events: List[tuple] = []
        self.depth = 0

    def read(self, array_name: str, index):
        if self.depth == 0:
            self.events.append(("read", (array_name, index)))


def _spy(rec: _Recorder, name: str, fn):
    def wrapper(*a, **k):
        slot = None
        if rec.depth == 0:      # nested calls are not counted again
            rec.events.append((name, {"in": tuple(id(x) for x in a)}))
            slot = len(rec.events) - 1
        rec.depth += 1
        try:
            out = fn(*a, **k)
        finally:
            rec.depth -= 1
        if slot is not None:
            outs = out if isinstance(out, tuple) else (out,)
            rec.events[slot][1]["out"] = tuple(id(x) for x in outs)
        return out
    return wrapper


class _SpyArray:
    """Wraps a digit (or table) tensor; records integer row reads."""

    def __init__(self, arr, name: str, rec: _Recorder, rows: bool = False):
        self._a, self._name, self._rec, self._rows = arr, name, rec, rows

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            self._rec.read(self._name, int(idx))
            if self._rows:  # a table window: record the rows read from it
                return _SpyArray(self._a[idx], f"row:{self._name}", self._rec)
        elif isinstance(idx, torch.Tensor):
            self._rec.read(self._name, tuple(int(v) for v in idx.reshape(-1)))
        return self._a[idx]


class _Patched:
    """Context manager: swap module attributes, restore on exit."""

    def __init__(self, mapping: Dict[Tuple[Any, str], Any]):
        self.mapping = mapping
        self.saved: Dict[Tuple[Any, str], Any] = {}

    def __enter__(self):
        for (mod, attr), val in self.mapping.items():
            self.saved[(mod, attr)] = getattr(mod, attr)
            setattr(mod, attr, val)
        return self

    def __exit__(self, *exc):
        for (mod, attr), val in self.saved.items():
            setattr(mod, attr, val)
        return False


_JAC = ("jacobian_double", "jacobian_madd_flagged",
        "jacobian_madd_flagged_ratio", "jacobian_add_flagged")


def _spies(rec: _Recorder, mod, names=_JAC + ("fe_mul", "fe_sub")):
    return {(mod, n): _spy(rec, n, getattr(mod, n)) for n in names
            if hasattr(mod, n)}


def _affine_of(X, Y, Z) -> Optional[Tuple[int, int]]:
    z = limbs_mod.limbs_to_int(np.asarray(Z)[:, 0])
    if z % host.P == 0:
        return None
    x = limbs_mod.limbs_to_int(np.asarray(X)[:, 0])
    y = limbs_mod.limbs_to_int(np.asarray(Y)[:, 0])
    zi = pow(z, host.P - 2, host.P)
    return (x * zi * zi % host.P, y * zi * zi * zi % host.P)


def _limb_col(x: int, n: int = NLIMB) -> torch.Tensor:
    return torch.from_numpy(limbs_mod.int_to_limbs(x, n)).reshape(n, 1)


def certify_g_table() -> Tuple[Dict[str, Any], List[str]]:
    """Host certificate of the G window tables both verify paths read: row
    (w, j) of the plain version's limbs (`curve.g_table`) and of the
    kernel's words (`verify_tiles.gtable_words`) is affine((j+1)·256^w·G),
    walked incrementally with exact host point arithmetic."""
    failures = list(_g_table_failures())
    fact = {"g_table": {"rows": 32 * 255, "tables": ["limbs", "words"],
                        "rule": "row (w,j) == (j+1)·256^w·G"}}
    return ({} if failures else fact), failures


@functools.lru_cache(maxsize=1)
def _g_table_failures() -> Tuple[str, ...]:
    """The walk of `certify_g_table`, once per process (the tables are
    constants)."""
    failures: List[str] = []
    gx, gy = (t.numpy() for t in curve_mod.g_table("cpu"))
    words = vt_mod.gtable_words("cpu").numpy().reshape(-1, 8)
    wint = vt_mod.words_to_ints(words)
    base = host.G
    for w in range(curve_mod.G_WINDOWS):
        ba = base.to_affine()
        acc = host.PointJ.from_affine(*ba)
        for j in range(255):
            a = acc.to_affine() if j else ba
            limbs = (limbs_mod.limbs_to_int(gx[w, j]),
                     limbs_mod.limbs_to_int(gy[w, j]))
            e = 2 * (w * 255 + j)
            if limbs != a or (wint[e], wint[e + 1]) != a:
                failures.append(f"G table row ({w}, {j}) != ({j + 1})·256^{w}·G")
                if len(failures) > 4:
                    return tuple(failures)
            acc = acc.add_affine(*ba)
        for _ in range(8):
            base = base.double()
    return tuple(failures)


def _schedule_lane(a_int: int, k_int: int, q_int: int):
    """One packed lane for R = a·G + k·Q, Q = q·G, targeting R's x: it must
    verify. Returns (fields (1, 4, 32) uint8, flags, the GLV split)."""
    qx, qy = host.G.mul(q_int).to_affine()
    a1, neg1, a2, neg2 = glv_mod.split_lambda(k_int)
    rx, _ry = host.G.mul(a_int).add(
        host.PointJ.from_affine(qx, qy).mul(k_int)).to_affine()
    raw = (a_int.to_bytes(32, "little") + a1.to_bytes(16, "little")
           + a2.to_bytes(16, "little") + qx.to_bytes(32, "little")
           + rx.to_bytes(32, "little"))
    fields = np.frombuffer(raw, np.uint8).reshape(1, 4, 32).copy()
    flags = (qy & 1, -1, 0, neg1, neg2, 1)  # want_odd, parity_req, has_t2, neg1, neg2, valid
    return fields, flags, (a1, neg1, a2, neg2)


# (a, k, q): a lane with random-looking scalars, and one whose small k leaves
# the λ half zero and the b1 half one window, so the kernel skips the
# doublings of 25 windows while R is infinity.
SCHEDULE_LANES = (
    (0x1234567890ABCDEF1234567890ABCDEF0DDBA11FEEDFACE8BADF00D5EED,
     0xBADC0DE0DDF00D0D15EA5E0BEEFFACE0CADFACE0DEAD0FAB0FEED0ACE, 0xC0FFEE),
    (0xFACE0FF1CE0DDBA11, 7, 0xD1CE),
)


def _signed_halves(split) -> Tuple[int, int]:
    a1, neg1, a2, neg2 = split
    return (-a1 if neg1 else a1), (-a2 if neg2 else a2)


def _plain_walk(a_int, k_int, q_int, facts, failures, first: bool) -> None:
    """One lane of `verify_tiles_reference` under spies."""
    rec = _Recorder()
    fields, flags, split = _schedule_lane(a_int, k_int, q_int)
    arrays: Dict[str, torch.Tensor] = {}
    orig_preamble, orig_gtable = vt_mod._preamble, vt_mod.g_table

    def preamble_spy(f):
        px, t1, t1n, da, db1, ds1, db2, ds2 = orig_preamble(f)
        arrays.update(da=da, db1=db1, ds1=ds1, db2=db2, ds2=ds2)
        return (px, t1, t1n) + tuple(_SpyArray(arrays[n], n, rec) for n in
                                     ("da", "db1", "ds1", "db2", "ds2"))

    def gtable_spy(device):
        gx, gy = orig_gtable(device)
        return _SpyArray(gx, "gx", rec, rows=True), _SpyArray(gy, "gy", rec, rows=True)

    patches = _spies(rec, vt_mod)
    patches[(vt_mod, "_preamble")] = preamble_spy
    patches[(vt_mod, "g_table")] = gtable_spy
    args = [torch.from_numpy(fields)] + [torch.tensor([v], dtype=torch.int32)
                                         for v in flags[:5]] \
        + [torch.tensor([bool(flags[5])])]
    try:
        with _Patched(patches):
            ok, needs = vt_mod.verify_tiles_reference(*args)
    except Exception as e:  # noqa: BLE001
        failures.append(f"plain walk: {type(e).__name__}: {e}")
        return
    ev = rec.events
    label = f"plain ladder (k={k_int:#x})"

    # -- table build: object-flow chain. jacobian_double(px, py, 1), then 14
    # ratio madds whose base arguments are px, py every time and whose
    # (X, Y, Z) are the previous call's outputs: row k holds (k+1)·P.
    jac = [(n, m) for n, m in ev if n in _JAC]
    names = [n for n, _ in jac[:15]]
    if names != ["jacobian_double"] + ["jacobian_madd_flagged_ratio"] * 14:
        failures.append(f"plain: table build {names} != [double, 14 ratio "
                        "madds]")
        return
    base = jac[0][1]["in"][:2]
    prev = jac[0][1]["out"][:3]
    for _, m in jac[1:15]:
        if m["in"][3:5] != base or m["in"][:3] != prev:
            failures.append("plain: the table build is not one madd chain of "
                            "a single base: row k is not (k+1)·P")
            return
        prev = m["out"][:3]
    pick = vt_mod._pick(torch.arange(16).reshape(16, 1, 1).expand(16, 1, 16),
                        torch.arange(1, 17))
    if pick.reshape(-1).tolist() != list(range(16)):
        failures.append("plain: _pick(table, d) does not read row d - 1")
        return

    # -- the signed ladder: from the first doubling after the table to the
    # first G digit read.
    table_end = [i for i, e in enumerate(ev) if e[0] in _JAC][14]
    start = next(i for i, e in enumerate(ev)
                 if i > table_end and e[0] == "jacobian_double")
    gstart = next(i for i, e in enumerate(ev) if e[0] == "read" and e[1][0] == "da")
    neg = {"db1": flags[3], "db2": flags[4]}

    def value(arr, w):
        d = int(arrays[arr][w][0])
        s = int(arrays["ds" + arr[-1]][w][0]) ^ neg[arr]
        return -d if s else d

    got = _check_ladder(
        ev[start:gstart], count=SGLV_WINDOWS, width=SGLV_WIDTH,
        digit_arrays=["db1", "db2"], sign_arrays=["ds1", "ds2"],
        expect_events=["jacobian_double"] * SGLV_WIDTH
        + ["fe_sub", "jacobian_madd_flagged", "fe_mul", "fe_sub",
           "jacobian_madd_flagged"],
        label=label, failures=failures, digit_value=value)
    if got is None:
        return
    wl, values = got
    if values != list(_signed_halves(split)):
        failures.append(f"{label}: the ledger's halves are not ±|k1|, ±|k2|")
        return
    wl["beta"] = "fe_mul(table x, β) precedes only the λ-half madd"

    # -- the G loop: window i reads da[i], then rows d - 1 of gx[i], gy[i],
    # one madd and no doubling; then the one join.
    g = ev[gstart:]
    iters, rest = _iterations(g, 1, 32)
    for i, it in enumerate(iters):
        names = [e[0] for e in it if e[0] != "read"]
        reads = [e[1] for e in it if e[0] == "read"]
        d = int(arrays["da"][i][0])
        want_reads = [("da", i), ("gx", i), ("row:gx", (max(d - 1, 0),)),
                      ("gy", i), ("row:gy", (max(d - 1, 0),))]
        if names != ["jacobian_madd_flagged"] or reads != want_reads:
            failures.append(f"plain: G loop iteration {i} runs {names} reading "
                            f"{reads}, expected one madd reading {want_reads}")
            return
    if len(iters) != 32 or [e[0] for e in rest if e[0] in _JAC] != ["jacobian_add_flagged"]:
        failures.append("plain: G loop is not 32 windows and one join")
        return
    if not (bool(ok[0]) and not bool(needs[0])):
        failures.append(f"plain: the lane for a·G + k·P (k={k_int:#x}) does "
                        "not verify")
        return
    if first:
        facts["signed_ladder"] = wl
        facts["g_loop"] = {"windows": 32, "doubles_per_window": 0,
                           "order": "ascending, table row (j+1)·256^w·G",
                           "rows": "window i reads row d - 1"}
        facts["table"] = {"rows": 16, "rule": "row k == (k+1)·P (object-flow "
                          "chain: double + 14 madds of the same base)",
                          "pick": "row d - 1"}
    facts.setdefault("differential", {"lanes": 0, "rule": "the walked lane "
                                      "verifies: x(a·G + k·P) == target"})
    facts["differential"]["lanes"] += 1


def _target_plain_schedule(quick: bool = False) -> CertResult:
    facts: Dict[str, Any] = {}
    failures: List[str] = []
    for j, lane in enumerate(SCHEDULE_LANES):
        _plain_walk(*lane, facts, failures, first=j == 0)
        if failures:
            break
    if not quick and not failures:
        f3, fail3 = certify_g_table()
        facts.update(f3)
        failures.extend(fail3)
    return _finish("verify_tiles.plain_schedule", facts, failures)


_TRACE_CAP = 4096


def cuda_lane_trace(fields, flags) -> Tuple[Tuple[int, int], List[tuple]]:
    """One lane through the `.cu` lane program's host build:
    ((ok, needs_host), the hook events as (name, a, b, c, d), the names
    those of the `.cu`'s `VT_EV_*` defines without the prefix)."""
    lib = _host_lib()
    names = {code: name for name, code in re.findall(
        r"#define VT_EV_(\w+) (\d+)", VT_SOURCE.read_text())}
    w = np.ascontiguousarray(np.asarray(fields, np.uint8).reshape(128))
    gtab = np.ascontiguousarray(vt_mod.gtable_words("cpu").numpy())
    out = np.zeros(2, np.int32)
    buf = np.zeros((_TRACE_CAP, 5), np.int32)
    n = lib.vt_host_trace(w.ctypes.data, *(int(v) for v in flags),
                          gtab.ctypes.data, out.ctypes.data, buf.ctypes.data,
                          _TRACE_CAP)
    if n > _TRACE_CAP:
        raise RuntimeError(f"the lane raised {n} hook events, more than "
                           f"{_TRACE_CAP}")
    return ((int(out[0]), int(out[1])),
            [(names[str(r[0])],) + tuple(int(x) for x in r[1:]) for r in buf[:n]])


def _cuda_walk(a_int, k_int, q_int, facts, failures, first: bool) -> None:
    fields, flags, split = _schedule_lane(a_int, k_int, q_int)
    try:
        (ok, needs), ev = cuda_lane_trace(fields, flags)
    except Exception as e:  # noqa: BLE001 (no compiler is FAIL too)
        failures.append(f"cuda walk: {type(e).__name__}: {e}")
        return
    label = f"cuda ladder (k={k_int:#x})"
    # -- table: entry 0 = P, one doubling for entry 1, entries 2..15 by the
    # madd chain, each into slot 2k
    want_table = [("TABLE_ROW", 0, 0), ("DOUBLE", 0, 0), ("TABLE_ROW", 1, 2)] \
        + [("TABLE_ROW", k, 2 * k) for k in range(2, 16)]
    if [e[:3] for e in ev[:17]] != want_table:
        failures.append(f"cuda: table build {ev[:17]} != entry 0, a doubling, "
                        "then entries 1..15 at slots 2k")
        return
    # -- the 26 signed windows
    pos = 17
    stream = []
    skips = 0
    for i in range(SGLV_WINDOWS):
        w = SGLV_WINDOWS - 1 - i
        if ev[pos][:3] != ("WINDOW", i, w):
            failures.append(f"{label}: iteration {i} starts with {ev[pos]}, "
                            f"expected window {w}")
            return
        pos += 1
        if ev[pos][0] == "SKIP_DOUBLES":
            if ev[pos][1:3] != (SGLV_WIDTH, 1):
                failures.append(f"{label}: iteration {i} skips {ev[pos]}")
                return
            stream.append(("skip", SGLV_WIDTH))
            skips += 1
            pos += 1
        else:
            if [e[0] for e in ev[pos:pos + SGLV_WIDTH]] != ["DOUBLE"] * SGLV_WIDTH \
                    or ev[pos + SGLV_WIDTH][0] == "DOUBLE":
                failures.append(f"{label}: iteration {i} does not double "
                                f"{SGLV_WIDTH} times: doublings per window "
                                "!= recoder width")
                return
            stream += [("double",)] * SGLV_WIDTH
            pos += SGLV_WIDTH
        for h in (0, 1):
            e = ev[pos]
            if e[0] != "DIGIT" or e[1:3] != (h, w):
                failures.append(f"{label}: iteration {i} reads {e}, expected "
                                f"half {h} window {w}")
                return
            d, sign = e[3], e[4]
            stream.append(("digit", h, w, -d if sign else d))
            pos += 1
            if d > 0:
                if ev[pos][:4] != ("PREAD", h, w, 2 * (d - 1)) or ev[pos + 1][0] != "MADD":
                    failures.append(f"{label}: digit {d} of half {h} window {w}"
                                    f" reads {ev[pos]} then {ev[pos + 1]}, "
                                    f"expected slot {2 * (d - 1)} and a madd")
                    return
                stream.append(("add", h))
                pos += 2
    led = _ledger(stream, halves=2, count=SGLV_WINDOWS, width=SGLV_WIDTH,
                  label=label, failures=failures)
    if led is None:
        return
    if led["values"] != list(_signed_halves(split)):
        failures.append(f"{label}: the ledger's halves are not ±|k1|, ±|k2|")
        return
    # -- the G loop: window i, digit = byte i of a, row d - 1, no doubling
    for i in range(32):
        d = (a_int >> (8 * i)) & 0xFF
        if ev[pos][:3] != ("GWINDOW", i, d):
            failures.append(f"cuda: G iteration {i} is {ev[pos]}, expected "
                            f"window {i} digit {d}")
            return
        pos += 1
        if d > 0:
            if ev[pos][:3] != ("GREAD", i, d - 1) or ev[pos + 1][0] != "MADD":
                failures.append(f"cuda: G window {i} digit {d} reads "
                                f"{ev[pos]}, expected table {i} row {d - 1} "
                                "then a madd")
                return
            pos += 2
    if [e[0] for e in ev[pos:]] != ["JOIN"]:
        failures.append(f"cuda: after the G loop {ev[pos:pos + 3]}, expected "
                        "the one join")
        return
    if (ok, needs) != (1, 0):
        failures.append(f"cuda: the lane for a·G + k·P (k={k_int:#x}) gives "
                        f"(ok, needs_host) = {(ok, needs)}")
        return
    if first:
        facts["signed_ladder"] = {
            "windows": SGLV_WINDOWS, "doubles_per_window": SGLV_WIDTH,
            "order": "descending (w = count-1-i)",
            "ledger": "coeff(w) == 2^(width*w) for every window",
            "p_table": "slot 2 * (d - 1), sign sgn ^ neg"}
        facts["g_loop"] = {"windows": 32, "doubles_per_window": 0,
                           "order": "ascending, table row (j+1)·256^w·G",
                           "rows": "window i reads row d - 1"}
        facts["table"] = {"rows": 16, "rule": "entry 0 = P, a doubling, then "
                          "15 madds of P into slots 2k"}
    facts.setdefault("identity_doubles", {"windows_skipped": 0, "rule":
                     "skipped only while R is the identity, credited as "
                     "doublings of it"})
    facts["identity_doubles"]["windows_skipped"] += skips
    facts.setdefault("differential", {"lanes": 0, "rule": "the traced lane "
                                      "verifies: x(a·G + k·P) == target"})
    facts["differential"]["lanes"] += 1


# (name, pattern, what it pins) over the `.cu` text.
CUDA_SOURCE_CHECKS = (
    ("p_table_row", r"int slot = 2 \* \(d - 1\);\s*VT_TRACE\(VT_EV_PREAD, h, "
     r"wdw, slot, 0\);\s*fe sx = slot_get\(s, slot\);\s*fe sy = slot_get\(s, "
     r"slot \+ 1\);", "the P table is read at slot 2 * (d - 1): entry d - 1 "
     "holds d·P"),
    ("sign_wiring", r"uint32_t neg = sgn \^ \(uint32_t\)\(h \? neg2 : neg1\);"
     r"[^}]*if \(neg == 1u\) sy = fe_neg\(sy\);",
     "the digit sign is xored with the GLV half's sign before negating y"),
    ("beta", r"if \(h\) sx = fe_mul\(sx, fe_from\(VT_BETA\)\);",
     "β multiplies x on the λ half only"),
    ("g_row", r"VT_FN size_t gtab_offset\(int i, int d\) \{\s*return \(\(size_t\)"
     r"\(i \* VT_G_ENTRIES \+ d - 1\) \* 2\) \* 8;",
     "the G table is read at row d - 1 of window i"),
    ("g_row_both_builds", r"(?s)gtab \+ gtab_offset\(i, d\).*gtab \+ "
     r"gtab_offset\(i, d\)", "both builds of gtab_entry read through "
     "gtab_offset"),
    ("hooks_off_on_card", r"#ifdef __CUDACC__[^#]*#include <cuda_runtime.h>"
     r"(?:[^\n]*\n){1,6}#undef VT_TRACE\n#define VT_TRACE\(ev, a, b, c, d\) "
     r"\(\(void\)0\)", "the hooks compile to nothing under nvcc"),
)


def cuda_source_checks(facts: Dict[str, Any], failures: List[str],
                       text: Optional[str] = None) -> None:
    text = VT_SOURCE.read_text() if text is None else text
    missing = [f"cuda source: {name}: {what} (pattern not found)"
               for name, pat, what in CUDA_SOURCE_CHECKS
               if not re.search(pat, text)]
    failures.extend(missing)
    if not missing:
        facts["source"] = {name: what for name, _, what in CUDA_SOURCE_CHECKS}


def _target_cuda_schedule(quick: bool = False) -> CertResult:
    facts: Dict[str, Any] = {}
    failures: List[str] = []
    cuda_source_checks(facts, failures)
    for j, lane in enumerate(SCHEDULE_LANES):
        _cuda_walk(*lane, facts, failures, first=j == 0)
        if failures:
            break
    if not quick and not failures:
        f3, fail3 = certify_g_table()
        facts.update(f3)
        failures.extend(fail3)
    return _finish("verify_tiles.cuda_schedule", facts, failures)


# --------------------------------------------------------------------------
# target registry / public API
# --------------------------------------------------------------------------

TARGETS: Dict[str, Callable[..., CertResult]] = {
    "scalar._digits": lambda quick=False: _target_digits(),
    "scalar._digits128": lambda quick=False: _target_digits128(),
    "scalar.bytes_to_limbs": lambda quick=False: _target_bytes_to_limbs(),
    "scalar._signed_digits128":
        lambda quick=False: _target_signed_digits128(),
    "glv.split_lambda": lambda quick=False: _target_glv(),
    "sha256.bytes_from_words": lambda quick=False: _target_bytes_from_words(),
    "verify_tiles.plain_schedule": _target_plain_schedule,
    "verify_tiles.cuda_schedule": _target_cuda_schedule,
}

# Function names the host lint's scalar-coverage rule accepts as registered
# with the schedule prover, mapped to the target that certifies them: the
# port's Python recoders and the `.cu`'s recoder and lane program.
REGISTERED_RECODERS: Dict[str, str] = {
    "scalar_bits": "scalar._digits",
    "_window_sum": "scalar._digits",
    "_digits": "scalar._digits",
    "_digits128": "scalar._digits128",
    "_signed_digits128": "scalar._signed_digits128",
    "bytes_to_limbs": "scalar.bytes_to_limbs",
    "int_to_limbs": "scalar.bytes_to_limbs",
    "limbs_to_int": "scalar.bytes_to_limbs",
    "words_to_limbs10": "scalar._signed_digits128",
    "recode": "scalar._signed_digits128",
    "split_lambda": "glv.split_lambda",
    "window5": "scalar._signed_digits128",
    "signed_carries": "scalar._signed_digits128",
    "signed_digit": "scalar._signed_digits128",
    "verify_lane_slots": "verify_tiles.cuda_schedule",
    "verify_lane": "verify_tiles.cuda_schedule",
    "_bytes_from_words": "sha256.bytes_from_words",
    "_words_from_bytes": "sha256.bytes_from_words",
}

# Targets whose certificate walks a whole verify lane (the plain version's
# thousands of torch ops, or a g++ build of the `.cu`): the test suite
# certifies only the fast set, `lint --schedule` runs everything.
HEAVY_TARGETS = {
    "verify_tiles.plain_schedule",
    "verify_tiles.cuda_schedule",
}


def all_targets(include_heavy: bool = True) -> List[str]:
    names = list(TARGETS)
    if not include_heavy:
        names = [n for n in names if n not in HEAVY_TARGETS]
    return names


def certify(name: str, quick: bool = False) -> CertResult:
    try:
        return TARGETS[name](quick=quick)
    except Exception as e:  # noqa: BLE001 (unevaluable is FAIL)
        return CertResult(name, "FAIL", {}, [f"{type(e).__name__}: {e}"])


_CERT_COUNTER = None


def emit_certificates(results: List[CertResult]) -> None:
    """Count each certificate in `consensus_scalar_certificates{target,
    status}` (registered at the first call)."""
    global _CERT_COUNTER
    if _CERT_COUNTER is None:
        from ..obs import counter
        _CERT_COUNTER = counter(
            "consensus_scalar_certificates",
            "Scalar-schedule prover certificates by target and status",
            ("target", "status"))
    for r in results:
        _CERT_COUNTER.inc(target=r.name, status=r.status)


def certify_all(quick: bool = False,
                emit_metrics: bool = True,
                include_heavy: bool = True) -> List[CertResult]:
    """Every target's certificate, each counted by `emit_certificates`
    unless `emit_metrics` is False."""
    results = [certify(n, quick=quick)
               for n in all_targets(include_heavy=include_heavy)]
    if emit_metrics:
        emit_certificates(results)
    return results


# --------------------------------------------------------------------------
# planted-unsound negatives: the prover must REJECT every one
# --------------------------------------------------------------------------

def _toy_bad_weights_recoder() -> CertResult:
    """Out-of-range digit: weights [1, 2, 4, 9] instead of [1, 2, 4, 8];
    windows can exceed 2^width − 1 and recombination is broken."""

    def bad_digits(limbs):
        bits = curve_mod.scalar_bits(limbs)[:256]
        b = bits.reshape((64, 4) + tuple(limbs.shape[1:]))
        weights = torch.tensor([1, 2, 4, 9], dtype=torch.int32).reshape(
            (1, 4) + (1,) * (limbs.dim() - 1))
        return (b * weights).sum(dim=1, dtype=torch.int32)

    facts: Dict[str, Any] = {}
    failures: List[str] = []
    _prove_digit_slices("toy_bad_weights", bad_digits,
                        _seed_limb_bits(NLIMB), 64, 4, facts, failures)
    return _finish("negative.scalar-digit-range", facts, failures)


def _toy_bad_carry() -> CertResult:
    """Wrong carry fold: digit = t − 31 on carry instead of t − 32; the
    telescoping invariant (and hence reconstruction) breaks."""
    return prove_carry_automaton(
        step_fn=lambda t: ((1 if t >= 16 else 0),
                           t - 31 * (1 if t >= 16 else 0)))


def _toy_ladder(order_desc: bool, doubles: int) -> CertResult:
    """4-window width-2 ladder over an 8-bit scalar on the port's group ops
    and a host table {1, 2, 3}·P, run through the same checker as the plain
    version's ladder. order_desc=True, doubles=2 is the sound schedule (the
    checker's self-test); ascending order or doubles != width must FAIL."""
    facts: Dict[str, Any] = {}
    failures: List[str] = []
    rec = _Recorder()
    scalar = 0b10110110
    rows = [host.G.mul(k).to_affine() for k in (1, 2, 3)]
    tx = torch.stack([_limb_col(x) for x, _ in rows])  # (3, 20, 1)
    ty = torch.stack([_limb_col(y) for _, y in rows])
    raw = torch.tensor([[(scalar >> (2 * w)) & 3] for w in range(4)],
                       dtype=torch.int32)
    digits = _SpyArray(raw, "digits0", rec)

    def ladder():
        C = curve_mod
        R = C._inf_like(tx[0])
        r_inf = torch.ones(1, dtype=torch.bool)
        for i in range(4):
            w = (3 - i) if order_desc else i
            for _ in range(doubles):
                R = C.jacobian_double(*R)
            d = digits[w]
            idx = (d - 1).clamp(min=0).long()
            Xa, Ya, Za, inf_a, _nd = C.jacobian_madd_flagged(
                *R, tx[idx[0]], ty[idx[0]], inf1=r_inf)
            app = d > 0
            R = C._select(app, (Xa, Ya, Za), R)
            r_inf = torch.where(app, inf_a, r_inf)
        return R

    try:
        with _Patched(_spies(rec, curve_mod, _JAC)):
            R = ladder()
    except Exception as e:  # noqa: BLE001
        failures.append(f"toy ladder walk: {type(e).__name__}: {e}")
        return _finish("negative.toy-ladder", facts, failures)
    got = _check_ladder(
        rec.events, count=4, width=2, digit_arrays=["digits0"],
        sign_arrays=[], expect_events=["jacobian_double"] * doubles
        + ["jacobian_madd_flagged"], label="toy ladder", failures=failures,
        digit_value=lambda arr, w: int(raw[w][0]))
    if got is not None:
        if got[1] != [scalar]:
            failures.append("toy ladder: the ledger's scalar is not the "
                            "recoded one")
        else:
            facts["toy_ladder"] = got[0]
    if _affine_of(*R) != host.G.mul(scalar).to_affine():
        failures.append("toy ladder differential: result != scalar·P")
    elif got is not None:
        facts["differential"] = {"rule": "toy walk == scalar·P"}
    return _finish("negative.toy-ladder", facts, failures)


def _toy_little_endian_digest() -> CertResult:
    """A digest unpack that writes each word's bytes little-endian (shifts
    0, 8, 16, 24): every byte lands in the wrong slot of its word."""

    def le_bytes_from_words(words):
        w = words.to(torch.int64).movedim(0, -1)
        shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64)
        b = (w.unsqueeze(-1) >> shifts) & 0xFF
        return b.reshape(b.shape[:-2] + (32,)).to(torch.uint8)

    return _prove_bytes_from_words(le_bytes_from_words,
                                   "negative.sha256-byte-order")


def _cert_to_report(name: str, cert: CertResult) -> interval.Report:
    rep = interval.Report(name=f"negative.{name}", ok=cert.ok)
    for f in cert.failures:
        rep.violations.append(
            interval.Violation(kind="schedule", where=cert.name, msg=f))
    rep.notes.append(f"scalar-schedule prover verdict: {cert.status}")
    return rep


NEGATIVES: Dict[str, Callable[[], CertResult]] = {
    "scalar-carry-fold": _toy_bad_carry,
    "scalar-window-order": lambda: _toy_ladder(order_desc=False, doubles=2),
    "scalar-dropped-doubling": lambda: _toy_ladder(order_desc=True, doubles=1),
    "scalar-digit-range": _toy_bad_weights_recoder,
    "scalar-glv-constant": lambda: prove_glv_constants(B2=glv_mod._B2 + 2),
    "scalar-sha256-byte-order": _toy_little_endian_digest,
}


def toy_ladder_selftest() -> CertResult:
    """The sound toy schedule must PASS through the same checker the
    negatives fail: the gate is alive, not trivially rejecting."""
    return _toy_ladder(order_desc=True, doubles=2)


def analyze_negative(name: str) -> interval.Report:
    return _cert_to_report(name, NEGATIVES[name]())
