"""Kernel prover: launch contracts of the port's hand-written kernels.

The port's counterpart of `bitcoinconsensus_tpu/analysis/pallas_check.py`.
A Pallas kernel is traced and its `BlockSpec` program and Ref semantics are
checked; a kernel of the port is CUDA, which no tracer reads, so it is
checked through the `LaunchContract` declared beside its wrapper
(`ops/contract.py`). Three checks, each for the contract at given input
shapes:

1. The contract, concretely, for every block of the grid:
   - every window lies inside its array, or is clipped only where
     `masked_edge` is declared (a `grid` violation names the block);
   - every output element is written by exactly one block, and none is left
     unwritten (`grid`);
   - the shared memory a block declares (its scratch and its dynamic
     shared memory) stays at or under `SMEM_LIMIT_BYTES`, the per-block
     limit of an H100 (`smem`), and the threads per block at or under 1,024.
2. The body, by interval proof (`analysis/interval.py`) of its aten graph on
   one block's windows, with the inputs' bounds cut to the window. A body is
   proven once per distinct window shape: the full blocks, and the ragged
   edge where there is one. It must not branch on the block index beyond
   that: the index maps carry the block's position.
3. Scratch reads: scratch is made with `torch.empty`, so a read of it before
   any write in the same block is a `ref` violation. Nothing carries from
   one block to the next on this card, so there is no other way to fill it.

Mosaic's ref-discipline lint (captured constants, i1 vectors and 64-bit
values through loop carries; `pallas_check.py:574-635`) has no Hopper
counterpart: a CUDA kernel reads constants from `__constant__` memory or its
arguments, and keeps masks in registers across loops. It is not ported.

`NEGATIVES` holds the Pallas prover's planted defects, re-declared as
contracts (an out-of-bounds index map, a scratch read before any write, a
`fe_mul` on 14-bit limbs, a double-written output block, a TF32 product, a
float32 accumulation that can reach 2^25, a float `pow` converted back to
int32), and `analyze_positive_toy` the clean one. `csrc/toy_kernels.cu` has
each of them as a CUDA kernel, launched through a wrapper here (plain
version on a CPU tensor, the kernel on a CUDA tensor, with a launch count):
`toy_positive`, `toy_mul`, `toy_f32_dot_tf32`, `toy_f32_dot`,
`toy_f32_square`, and `toy_f32_write` (the reference's inexact float output
fixture). The out-of-bounds, read-before-write and double-write kernels
would have no defined result as written, so they launch instrumented
(`toy_oob_index_map`, `toy_read_before_write`, `toy_double_write`): their
window offsets come from the contract's index maps, and they report each
output element's write count and each block's faults, which the card must
show exactly where the prover finds them.

The Hopper counterpart of a float32 dot without Precision.HIGHEST is a TF32
product: `mm_tf32`, an operator of its own so that the trace shows it (a
`torch.mm` of float32 runs in full float32 unless a global flag says
otherwise, and a flag is not in the graph). It has no exact-float transfer
that keeps the certificate: TF32 keeps 10 mantissa bits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import launch
from ..ops import limbs as L
from ..ops.contract import LaunchContract, Window, cdiv, run_contract, window_span
from . import interval as IV

__all__ = [
    "SMEM_LIMIT_BYTES",
    "check_contract",
    "NEGATIVES",
    "NEGATIVE_KINDS",
    "analyze_negative",
    "analyze_positive_toy",
    "mm_tf32",
    "run_checked",
    "toy_positive",
    "toy_mul",
    "toy_f32_dot_tf32",
    "toy_f32_dot",
    "toy_f32_square",
    "toy_f32_write",
    "toy_oob_index_map",
    "toy_read_before_write",
    "toy_double_write",
    "POSITIVE_CONTRACT",
    "MUL_CONTRACT",
]

SMEM_LIMIT_BYTES = 232_448  # shared memory one block may use on an H100
MAX_THREADS = 1024


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits; nearest, ties away from
    zero), as `cvt.rna.tf32.f32` does: add half of the 13 dropped bits to
    the magnitude, then clear them."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


@torch.library.custom_op("bitcoinconsensus_tpu_torch::mm_tf32", mutates_args=())
def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each operand rounded to TF32 and float32 accumulation: the
    product the tensor cores compute in TF32."""
    return torch.mm(tf32_round(a), tf32_round(b))


@mm_tf32.register_fake
def _(a, b):
    return a.new_empty((a.shape[0], b.shape[1]))


_MM_TF32 = torch.ops.bitcoinconsensus_tpu_torch.mm_tf32.default
IV.RULES[_MM_TF32] = IV.RULES[IV.aten.mm.default]
IV.FLOAT_CHECKS[_MM_TF32] = lambda res, a, b: (
    "TF32 product: the tensor cores round each operand to 10 mantissa bits "
    "(the counterpart of a float32 dot without Precision.HIGHEST), so its "
    "exactness certificate is demoted")


def _window_rows(bounds, span0: Tuple[int, int]):
    """Cut an input's bounds to the rows its window covers on axis 0."""
    return bounds[span0[0]:span0[1]] if isinstance(bounds, list) else bounds


def _check_windows(rep: IV.Report, c: LaunchContract, name: str, blocks,
                   in_shapes, out_shapes) -> Dict[tuple, tuple]:
    """Check every window of every block; return the clipped input window
    shapes -> the first block that has them (the body's proof cases)."""
    owner = [np.full(s, -1, dtype=np.int64) for s in out_shapes]
    cases: Dict[tuple, tuple] = {}
    for bi, block in enumerate(blocks):
        block_ok = True
        clipped = []
        for kind, wins, shapes in (("input", c.ins, in_shapes),
                                   ("output", c.outs, out_shapes)):
            for i, (win, shape) in enumerate(zip(wins, shapes)):
                where = f"{name}/{kind}{i}"
                try:
                    span = window_span(win, block)
                except Exception as e:
                    rep.violate("grid", where, f"index map failed at block "
                                f"{block}: {type(e).__name__}: {e}")
                    block_ok = False
                    continue
                if len(span) != len(shape):
                    rep.violate("grid", where, f"a {len(span)}-axis window "
                                f"for a {len(shape)}-axis array")
                    block_ok = False
                    continue
                ok = True
                for d, ((st, sp), n) in enumerate(zip(span, shape)):
                    if st < 0 or st >= n or (sp > n and not c.masked_edge):
                        rep.violate(
                            "grid", where,
                            f"index map sends block {block} to offset {st} on "
                            f"axis {d}: window [{st}, {sp}) escapes the array "
                            f"extent {n}" + ("" if c.masked_edge else
                                             " (the edge is not masked)"))
                        ok = False
                block_ok = block_ok and ok
                if not ok:
                    continue
                region = tuple(slice(st, min(sp, n)) for (st, sp), n in zip(span, shape))
                if kind == "input":
                    clipped.append(tuple(r.stop - r.start for r in region))
                    continue
                own = owner[i][region]
                prev = own[own >= 0]
                if prev.size:
                    rep.violate(
                        "grid", where,
                        f"output elements at offset {tuple(st for st, _ in span)} "
                        f"are written by blocks {blocks[int(prev[0])]} and "
                        f"{block}: every output element must be written "
                        "exactly once")
                own[...] = bi
        if block_ok:
            cases.setdefault(tuple(clipped), block)
    for i, own in enumerate(owner):
        missing = int((own < 0).sum())
        if missing:
            rep.violate("grid", f"{name}/output{i}",
                        f"{missing} of {own.size} elements of output {i} are "
                        "never written: the grid's windows do not cover it")
    return cases


def check_contract(contract: LaunchContract, arg_specs: Sequence[IV.TensorSpec],
                   name: str, in_bounds=None, out_within=None,
                   prove_body: bool = True,
                   report: Optional[IV.Report] = None) -> IV.Report:
    """Check `contract` at the shapes of `arg_specs`; `in_bounds` and
    `out_within` are per array, as for `interval.analyze` (output bounds per
    row of an output window)."""
    rep = report or IV.Report(name=name)
    in_shapes = [tuple(s.shape) for s in arg_specs]
    grid = tuple(int(g) for g in contract.grid(*in_shapes))
    outs = contract.out_arrays(*in_shapes)
    smem = contract.smem_bytes()
    if rep.grid is None:
        rep.grid, rep.smem_peak_bytes = grid, smem
    rep.smem_peak_bytes = max(rep.smem_peak_bytes, smem)
    if not 1 <= contract.threads <= MAX_THREADS:
        rep.violate("grid", f"{name}/launch", f"{contract.threads} threads per "
                    f"block; a block holds 1 to {MAX_THREADS}")
    if smem > SMEM_LIMIT_BYTES:
        rep.violate("smem", f"{name}/launch", f"a block declares {smem} bytes "
                    f"of shared memory; an H100 block may use {SMEM_LIMIT_BYTES}")
    blocks = [tuple(int(b) for b in blk) for blk in np.ndindex(*grid)]
    cases = _check_windows(rep, contract, name, blocks, in_shapes,
                           [s for s, _ in outs])
    if not prove_body:
        return rep
    nin = len(arg_specs)
    for clipped, block in cases.items():
        specs = [IV.TensorSpec(shape, s.dtype) for shape, s in zip(clipped, arg_specs)]
        avs = []
        for i, (spec, win) in enumerate(zip(specs, contract.ins)):
            b = _window_rows((in_bounds or {}).get(i), window_span(win, block)[0])
            avs.append(IV.from_bounds(spec, b))
        for j, (shape, dt) in enumerate(contract.scratch):
            specs.append(IV.TensorSpec(shape, dt))
            avs.append(IV.uninitialised(shape, dt, f"scratch{j}"))
        res = IV.prove(lambda *t, _b=block: contract.body(_b, *t), specs, avs,
                       rep, f"{name}/body", scratch=range(nin, len(specs)))
        if res is None:
            continue
        if not rep.out_bounds:  # those of the first block
            rep.out_bounds = [o.rows0() for o in res]
        for i, o in enumerate(res):
            if out_within is not None and i < len(out_within) \
                    and out_within[i] is not None:
                IV.check_within(rep, f"{name}/out{i}", o, out_within[i])
    return rep


# ---------------------------------------------------------------------------
# Toy kernels: the gate must demonstrably fire. Each contract has its CUDA
# kernel in csrc/toy_kernels.cu (same names), one block per 128 columns.

TOY_TILE = 128
TOY_ROWS = 8
_TOY_COLS = 2 * TOY_TILE  # the shapes the Pallas toys are traced at


def _tile(rows: int, index_map=None) -> Window:
    return Window((rows, TOY_TILE), index_map or (lambda b: (0, TOY_TILE * b[0])))


def _tiles_grid(x):
    return (cdiv(x[1], TOY_TILE),)


def _same_as_input(x):
    return ((x, torch.int32),)


def _positive_body(block, x, tile):
    # The window is staged through shared memory, as a Pallas block sits in
    # VMEM; a ragged edge fills only its first columns.
    w = x.shape[1]
    tile[:, :w].copy_(x)
    return tile[:, :w] + 1


def _mul_body(block, x):
    # fe_mul's columns fit int32 only under the W2 weak contract; 14-bit
    # limbs without a canon overflow them.
    return L.fe_mul(x, x)


def _rbw_body(block, x, s):
    # Row 0 of the scratch is read and never written.
    return x + s[0][None, :]


def _copy_body(block, x):
    return x.clone()


def _dot_col0(prod, tile, y):
    # o[r, :] = int(y[r, 0]), as the Pallas toys broadcast column 0; the
    # kernel keeps column 0 in a shared (8,) vector.
    y.copy_(prod[:, 0])
    return y.to(torch.int32)[:, None].expand(tile.shape)


def _f32_dot_tf32_body(block, x, tile, y):
    # No Precision.HIGHEST: the product runs in TF32.
    tile.copy_(x.to(torch.float32))
    return _dot_col0(mm_tf32(tile, tile.t()), tile, y)


def _f32_dot_body(block, x, tile, y):
    # Full float32 products, every one exact (512^2 = 2^18), but 128 of them
    # sum to 2^25, beyond the float32 mantissa.
    tile.copy_(x.to(torch.float32))
    return _dot_col0(tile @ tile.t(), tile, y)


def _f32_square_body(block, x):
    # `pow` has no vetted exact-float transfer: the certificate is demoted
    # there, and the convert back to int32 cites it.
    return (x.to(torch.float32) ** 2).to(torch.int32)


def _f32_write_body(block, x):
    return x.to(torch.float32) ** 2


POSITIVE_CONTRACT = LaunchContract(
    "toy.positive", grid=_tiles_grid, threads=TOY_ROWS * TOY_TILE,
    ins=(_tile(TOY_ROWS),), outs=(_tile(TOY_ROWS),), out_arrays=_same_as_input,
    body=_positive_body, masked_edge=True,
    scratch=(((TOY_ROWS, TOY_TILE), torch.int32),))

MUL_CONTRACT = LaunchContract(
    "toy.mul", grid=_tiles_grid, threads=TOY_TILE,
    ins=(_tile(L.NLIMB),), outs=(_tile(L.NLIMB),), out_arrays=_same_as_input,
    body=_mul_body, masked_edge=True)

OOB_CONTRACT = LaunchContract(
    "toy.oob_index_map", grid=_tiles_grid, threads=TOY_ROWS * TOY_TILE,
    # Off by one block: the last block's input window escapes.
    ins=(_tile(TOY_ROWS, lambda b: (0, TOY_TILE * (b[0] + 1))),),
    outs=(_tile(TOY_ROWS),), out_arrays=_same_as_input, body=_copy_body)

RBW_CONTRACT = LaunchContract(
    "toy.read_before_write", grid=_tiles_grid, threads=TOY_ROWS * TOY_TILE,
    ins=(_tile(TOY_ROWS),), outs=(_tile(TOY_ROWS),), out_arrays=_same_as_input,
    body=_rbw_body, scratch=(((4, TOY_TILE), torch.int32),))

DOUBLE_WRITE_CONTRACT = LaunchContract(
    "toy.double_write", grid=_tiles_grid, threads=TOY_ROWS * TOY_TILE,
    ins=(_tile(TOY_ROWS),),
    # Both blocks write output block 0; block 1 is never written.
    outs=(_tile(TOY_ROWS, lambda b: (0, 0)),), out_arrays=_same_as_input,
    body=_copy_body)

_DOT_SCRATCH = (((TOY_ROWS, TOY_TILE), torch.float32), ((TOY_ROWS,), torch.float32))

F32_DOT_TF32_CONTRACT = LaunchContract(
    "toy.f32_dot_tf32", grid=_tiles_grid, threads=TOY_ROWS * TOY_TILE,
    ins=(_tile(TOY_ROWS),), outs=(_tile(TOY_ROWS),), out_arrays=_same_as_input,
    body=_f32_dot_tf32_body, scratch=_DOT_SCRATCH)

F32_DOT_CONTRACT = LaunchContract(
    "toy.f32_dot", grid=_tiles_grid, threads=TOY_ROWS * TOY_TILE,
    ins=(_tile(TOY_ROWS),), outs=(_tile(TOY_ROWS),), out_arrays=_same_as_input,
    body=_f32_dot_body, scratch=_DOT_SCRATCH)

F32_SQUARE_CONTRACT = LaunchContract(
    "toy.f32_square", grid=_tiles_grid, threads=TOY_ROWS * TOY_TILE,
    ins=(_tile(TOY_ROWS),), outs=(_tile(TOY_ROWS),), out_arrays=_same_as_input,
    body=_f32_square_body)

# The reference's inexact-float-output fixture (tests/test_pallas_check.py).
F32_WRITE_CONTRACT = LaunchContract(
    "toy.f32_write", grid=_tiles_grid, threads=TOY_ROWS * TOY_TILE,
    ins=(_tile(TOY_ROWS),), outs=(_tile(TOY_ROWS),),
    out_arrays=lambda x: ((x, torch.float32),), body=_f32_write_body)


def _toy_spec(rows: int) -> List[IV.TensorSpec]:
    return [IV.TensorSpec((rows, _TOY_COLS), torch.int32)]


NEGATIVES = {
    "oob-index-map": lambda: (OOB_CONTRACT, _toy_spec(TOY_ROWS), {0: (0, 100)}),
    "read-before-write": lambda: (RBW_CONTRACT, _toy_spec(TOY_ROWS), {0: (0, 100)}),
    "mul-overflow-no-canon": lambda: (MUL_CONTRACT, _toy_spec(L.NLIMB),
                                      {0: [(0, (1 << 14) - 1)] * L.NLIMB}),
    "double-write": lambda: (DOUBLE_WRITE_CONTRACT, _toy_spec(TOY_ROWS),
                             {0: (0, 100)}),
    # 128 x 100^2 stays far below 2^24: the only defect is the TF32 product.
    "f32-default-precision-dot": lambda: (F32_DOT_TF32_CONTRACT,
                                          _toy_spec(TOY_ROWS), {0: (0, 100)}),
    "f32-accum-overflow": lambda: (F32_DOT_CONTRACT, _toy_spec(TOY_ROWS),
                                   {0: (0, 1 << 9)}),
    "f32-unvetted-roundtrip": lambda: (F32_SQUARE_CONTRACT, _toy_spec(TOY_ROWS),
                                       {0: (0, 100)}),
}
# The violation kind each negative must raise.
NEGATIVE_KINDS = {"oob-index-map": "grid", "read-before-write": "ref",
                  "mul-overflow-no-canon": "overflow", "double-write": "grid",
                  "f32-default-precision-dot": "float",
                  "f32-accum-overflow": "float",
                  "f32-unvetted-roundtrip": "float"}


def analyze_negative(name: str) -> IV.Report:
    """Check one deliberately broken toy; it must come back not ok or the
    gate is dead."""
    contract, specs, in_bounds = NEGATIVES[name]()
    return check_contract(contract, specs, f"toy.negative.{name}",
                          in_bounds=in_bounds)


def analyze_positive_toy() -> IV.Report:
    """A minimal clean kernel: proves the machinery end to end."""
    return check_contract(POSITIVE_CONTRACT, _toy_spec(TOY_ROWS), "toy.positive",
                          in_bounds={0: (0, 100)})


# ---------------------------------------------------------------------------
# Wrappers: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
# the plain version.


def _check_input(contract: LaunchContract, x: torch.Tensor, rows: int) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{contract.name} takes a ({rows}, W) int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not contract.masked_edge and x.shape[1] % TOY_TILE:
        raise ValueError(f"{contract.name} does not mask a ragged edge: W must "
                         f"be a multiple of {TOY_TILE}, got {x.shape[1]}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"{contract.name} runs on CUDA or the CPU, not {x.device}")


# The lean launch path (`ops/launch.py`): a plan per (kernel, shape, dtype,
# device) is resolved once, with the input's checks, from the contract; a
# call then checks contiguity, allocates the output and launches the
# launcher `tk_<kernel>` with its arguments packed.
_plans: Dict[tuple, launch.Plan] = {}


def _plan(kernel: str, contract: LaunchContract, x: torch.Tensor,
          rows: int) -> launch.Plan:
    key = (kernel, x.shape, x.dtype, x.device)
    plan = _plans.get(key)
    if plan is None:
        _check_input(contract, x, rows)
        shape = tuple(x.shape)
        (grid,) = contract.grid(shape)
        ((out_shape, out_dtype),) = contract.out_arrays(shape)
        plan = launch.Plan(launch.bind("toy_kernels", f"tk_{kernel}"),
                           grid, contract.threads, tuple(out_shape), out_dtype,
                           like_input=(tuple(out_shape) == shape
                                       and out_dtype == x.dtype))
        _plans[key] = plan
    if not x.is_contiguous():
        raise ValueError(f"{contract.name}: the input must be contiguous")
    return plan


def _toy(wrapper, kernel: str, contract: LaunchContract, x: torch.Tensor,
         rows: int = TOY_ROWS):
    if x.is_cuda:
        p = _plan(kernel, contract, x, rows)
        out = (torch.empty_like(x) if p.like_input
               else x.new_empty(p.out_shape, dtype=p.out_dtype))
        launch.call(p.fn, x.get_device(), x.data_ptr(), out.data_ptr(),
                    x.shape[1], p.grid, p.threads)
        wrapper.launches += 1
        return out
    _check_input(contract, x, rows)
    return run_contract(contract, x)


def toy_positive(x: torch.Tensor) -> torch.Tensor:
    """o = x + 1 on an (8, W) int32 tensor (`tk_positive`)."""
    return _toy(toy_positive, "positive", POSITIVE_CONTRACT, x)


def toy_mul(x: torch.Tensor) -> torch.Tensor:
    """o = fe_mul(x, x) per column of a (20, W) int32 tensor of W2-bounded
    limbs (`tk_mul`)."""
    return _toy(toy_mul, "mul", MUL_CONTRACT, x, L.NLIMB)


def toy_f32_dot_tf32(x: torch.Tensor) -> torch.Tensor:
    """Per 128-column block, o[r, :] = int(y[r, 0]) for y = X X^T in TF32 on
    the tensor cores (`tk_f32_dot_tf32`); (8, W) int32, W a multiple of
    128."""
    return _toy(toy_f32_dot_tf32, "f32_dot_tf32", F32_DOT_TF32_CONTRACT, x)


def toy_f32_dot(x: torch.Tensor) -> torch.Tensor:
    """As `toy_f32_dot_tf32`, in full float32 (`tk_f32_dot`)."""
    return _toy(toy_f32_dot, "f32_dot", F32_DOT_CONTRACT, x)


def toy_f32_square(x: torch.Tensor) -> torch.Tensor:
    """o = int(float(x) ** 2) (`tk_f32_square`); (8, W) int32."""
    return _toy(toy_f32_square, "f32_square", F32_SQUARE_CONTRACT, x)


def toy_f32_write(x: torch.Tensor) -> torch.Tensor:
    """o = float(x) ** 2 as float32 (`tk_f32_write`); (8, W) int32 in."""
    return _toy(toy_f32_write, "f32_write", F32_WRITE_CONTRACT, x)


# -- the planted defects, instrumented ------------------------------------------


def _affine_cols(win: Window, grid: int) -> Tuple[int, int]:
    """(step, first): the window's column offset is first + step * block at
    every block of the grid, its row offset 0; anything else is refused."""
    offs = [tuple(int(o) for o in win.index_map((b,))) for b in range(grid)]
    first = offs[0][1] if offs else 0
    step = offs[1][1] - first if grid > 1 else 0
    if any(o != (0, first + step * b) for b, o in enumerate(offs)):
        raise ValueError(f"index map {offs} is not (0, first + step * block)")
    return step, first


_UNWRITTEN: Dict[str, int] = {}


def _reads_unwritten_scratch(contract: LaunchContract, shape) -> int:
    """1 where the prover finds the body reading scratch before any write
    (the same body runs in every block), else 0."""
    if not contract.scratch:
        return 0
    if contract.name not in _UNWRITTEN:
        rep = check_contract(contract, [IV.TensorSpec(tuple(shape), torch.int32)],
                             contract.name)
        _UNWRITTEN[contract.name] = int(any(v.kind == "ref" for v in rep.violations))
    return _UNWRITTEN[contract.name]


def run_checked(contract: LaunchContract, x: torch.Tensor):
    """Plain version of an instrumented copy kernel: (o, writes, faults).
    A block whose window leaves its array writes nothing and sets fault 0;
    each output element counts the blocks that wrote it; fault 1 marks a
    block whose body reads scratch no thread wrote (that scratch reads as 0).
    Output elements written by no block are 0."""
    shape = tuple(x.shape)
    (grid,) = contract.grid(shape)
    o = torch.zeros_like(x)
    writes = torch.zeros(shape, dtype=torch.int32, device=x.device)
    faults = torch.zeros((grid, 2), dtype=torch.int32, device=x.device)
    unwritten = _reads_unwritten_scratch(contract, (shape[0], TOY_TILE))
    for b in range(grid):
        spans = [window_span(w, (b,)) for w in contract.ins + contract.outs]
        if any(st < 0 or sp > n for span in spans
               for (st, sp), n in zip(span, shape)):
            faults[b, 0] = 1
            continue
        src, dst = (tuple(slice(st, sp) for st, sp in span) for span in spans)
        scratch = [torch.zeros(s, dtype=dt, device=x.device)
                   for s, dt in contract.scratch]
        o[dst] = contract.body((b,), x[src], *scratch)
        writes[dst] += 1
        faults[b, 1] = unwritten
    return o, writes, faults


def _checked(wrapper, kernel: str, contract: LaunchContract, x: torch.Tensor):
    if not x.is_cuda:
        _check_input(contract, x, TOY_ROWS)
        return run_checked(contract, x)
    p = _plan(kernel, contract, x, TOY_ROWS)
    cols = (_affine_cols(contract.ins[0], p.grid)
            + _affine_cols(contract.outs[0], p.grid))
    o = torch.zeros_like(x)
    writes = torch.zeros_like(x)
    faults = torch.zeros((p.grid, 2), dtype=torch.int32, device=x.device)
    launch.call(p.fn, x.get_device(), x.data_ptr(), o.data_ptr(), x.shape[1],
                p.grid, p.threads, *cols, writes.data_ptr(), faults.data_ptr())
    wrapper.launches += 1
    return o, writes, faults


def toy_oob_index_map(x: torch.Tensor):
    """The out-of-bounds index map, instrumented: (o, writes, faults)."""
    return _checked(toy_oob_index_map, "oob_index_map", OOB_CONTRACT, x)


def toy_read_before_write(x: torch.Tensor):
    """The scratch read before any write, instrumented: (o, writes, faults)."""
    return _checked(toy_read_before_write, "read_before_write", RBW_CONTRACT, x)


def toy_double_write(x: torch.Tensor):
    """The double-written output block, instrumented: (o, writes, faults)."""
    return _checked(toy_double_write, "double_write", DOUBLE_WRITE_CONTRACT, x)


TOY_WRAPPERS = (toy_positive, toy_mul, toy_f32_dot_tf32, toy_f32_dot,
                toy_f32_square, toy_f32_write, toy_oob_index_map,
                toy_read_before_write, toy_double_write)
for _w in TOY_WRAPPERS:
    _w.launches = 0
