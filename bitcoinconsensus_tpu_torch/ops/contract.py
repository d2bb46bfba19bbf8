"""Launch contracts: what a hand-written kernel's launch does, in Python.

A Pallas kernel is a body plus `BlockSpec` index maps over a grid, and
`pallas_call` cuts the arrays into blocks for it. On Hopper a kernel
computes its own offsets from `blockIdx`, its blocks run in no order, and
nothing carries from one block to the next. So each hand-written kernel of
the port declares its launch beside its wrapper as a `LaunchContract`:

- the grid, as a function of the input shapes, and the threads per block;
- for each input and output, a window shape and an index map from the block
  index to the window's element offsets;
- `masked_edge`: whether the kernel masks a ragged last block itself;
- the shared-memory scratch, as shapes and dtypes, handed to the body;
- `dynamic_smem`: shared memory the kernel carves for itself at launch
  (dynamic shared memory, the launch's third argument), as shapes and
  dtypes. The body does not see it: it is the kernel's own working set,
  and the plain version keeps the same values in tensors of its own. The
  wrapper passes its bytes to the launcher, which refuses any other size;
- `body(block, *in_windows, *scratch) -> out_windows`, one block's work in
  plain torch.

`run_contract(contract, *inputs)` is the kernel's plain version, the
counterpart of Pallas's interpret mode: it walks the grid, cuts the windows,
makes scratch with `torch.empty`, runs the body and writes the outputs. The
CUDA kernel computes the same thing by hand. `analysis/kernel_check.py`
checks a contract: windows inside their arrays, every output element written
exactly once, shared bytes within a block's limit, and the body by interval
proof.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Window", "LaunchContract", "window_span", "run_contract", "cdiv"]

Shape = Tuple[int, ...]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Window:
    """One operand's block: its shape, and the element offsets of the block
    at each block index."""

    shape: Shape
    index_map: Callable[[Tuple[int, ...]], Tuple[int, ...]]


@dataclass(frozen=True)
class LaunchContract:
    name: str
    grid: Callable[..., Shape]  # input shapes -> grid
    threads: int  # per block
    ins: Tuple[Window, ...]
    outs: Tuple[Window, ...]
    out_arrays: Callable[..., Tuple[Tuple[Shape, torch.dtype], ...]]  # input shapes -> outputs
    body: Callable
    masked_edge: bool = False
    scratch: Tuple[Tuple[Shape, torch.dtype], ...] = ()
    dynamic_smem: Tuple[Tuple[Shape, torch.dtype], ...] = ()

    def dynamic_smem_bytes(self) -> int:
        """Dynamic shared memory one block takes at launch."""
        return _nbytes(self.dynamic_smem)

    def smem_bytes(self) -> int:
        """Shared memory one block declares: its scratch and its dynamic
        shared memory."""
        return _nbytes(self.scratch) + self.dynamic_smem_bytes()


def _nbytes(arrays) -> int:
    return sum(int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
               for shape, dt in arrays)


def window_span(win: Window, block: Tuple[int, ...]) -> List[Tuple[int, int]]:
    """[start, stop) of the window on each axis, before any clipping."""
    offs = tuple(int(o) for o in win.index_map(block))
    if len(offs) != len(win.shape):
        raise ValueError(f"index map gives {len(offs)} offsets for a "
                         f"{len(win.shape)}-axis window")
    return [(o, o + w) for o, w in zip(offs, win.shape)]


def _cut(win: Window, block, extent: Sequence[int], masked: bool,
         what: str) -> Tuple[slice, ...]:
    out = []
    for d, ((st, sp), n) in enumerate(zip(window_span(win, block), extent)):
        if st < 0 or st >= n or (sp > n and not masked):
            raise ValueError(f"{what}: block {block} window [{st}, {sp}) on "
                             f"axis {d} escapes the array extent {n}")
        out.append(slice(st, min(sp, n)))
    return tuple(out)


def run_contract(contract: LaunchContract, *inputs: torch.Tensor):
    """The plain version of the contract's kernel, on the inputs' device."""
    if len(inputs) != len(contract.ins):
        raise ValueError(f"{contract.name} takes {len(contract.ins)} inputs, "
                         f"got {len(inputs)}")
    shapes = [tuple(t.shape) for t in inputs]
    device = inputs[0].device
    outs = [torch.empty(shape, dtype=dt, device=device)
            for shape, dt in contract.out_arrays(*shapes)]
    for block in np.ndindex(*contract.grid(*shapes)):
        block = tuple(int(b) for b in block)
        wins = [t[_cut(w, block, t.shape, contract.masked_edge,
                       f"{contract.name} input {i}")]
                for i, (w, t) in enumerate(zip(contract.ins, inputs))]
        scratch = [torch.empty(shape, dtype=dt, device=device)
                   for shape, dt in contract.scratch]
        res = contract.body(block, *wins, *scratch)
        res = res if isinstance(res, (tuple, list)) else (res,)
        for i, (w, o, r) in enumerate(zip(contract.outs, outs, res)):
            o[_cut(w, block, o.shape, contract.masked_edge,
                   f"{contract.name} output {i}")] = r
    return outs[0] if len(outs) == 1 else tuple(outs)
