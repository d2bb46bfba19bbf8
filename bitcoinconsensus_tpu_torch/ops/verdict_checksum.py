"""The device verdict checksum: (count, position-weighted) sums of a verdict
buffer.

Counterpart of `bitcoinconsensus_tpu/crypto/jax_backend.py::_verdict_checksum`
(:379-396), an XLA program of the reference that its verifier chains onto
every in-flight verdict buffer; the settle seam recomputes the two sums from
the buffer the host received (`resilience/guards.check_checksum`), so any
single-lane flip in transit is caught. Over a padded `ok` (B,) bool:

    (sum_i ok[i], sum_i ok[i] * (i % 251 + 1))

- `verdict_checksum(ok)`, the wrapper: a CUDA tensor launches the
  hand-written kernel `csrc/verdict_checksum.cu` (built at first use by
  `_build.py`), counting each launch in `verdict_checksum.launches`, and a
  launch that fails raises; a CPU tensor runs the plain version. Either way
  the result is a (2,) int32 tensor on the input's device.
- `verdict_checksum_reference(ok)`, the plain version: the reference's
  arithmetic in torch int64.
- `VERDICT_CHECKSUM_CONTRACT`, the kernel's launch as the prover checks it
  (`analysis/registry.py`, `cuda.verdict_checksum`): a grid of one block of
  1,024 threads over the whole buffer, the edge masked, the two output
  words written once; its body is the same sums in int32, which the
  interval prover holds inside int32 up to `MAX_LANES`.

It is a launch of its own after the verify kernel, as in the reference: the
verify kernel stays as proven, and the checksum covers exactly what it
wrote.
"""

from __future__ import annotations

import torch

from . import launch
from .contract import LaunchContract, Window

__all__ = ["verdict_checksum", "verdict_checksum_reference",
           "VERDICT_CHECKSUM_CONTRACT", "CHECKSUM_MOD", "MAX_LANES"]

CHECKSUM_MOD = 251
THREADS = 1024  # csrc/verdict_checksum.cu VC_THREADS
# csrc/verdict_checksum.cu VC_MAX_LANES: 251 * 2^23 < 2^31, so the weighted
# sum fits int32 (the reference's bound: about 8.5M lanes).
MAX_LANES = 1 << 23


def _weights(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device) % CHECKSUM_MOD + 1


def verdict_checksum_reference(ok: torch.Tensor) -> torch.Tensor:
    """Plain version: (count, weighted) as a (2,) int64 tensor."""
    v = ok.to(torch.int64)
    w = _weights(v.shape[0], torch.int64, v.device)
    return torch.stack((v.sum(), (v * w).sum()))


def _contract_body(block, ok):
    # The kernel's int32 arithmetic over the window: the prover holds every
    # intermediate, and both sums, inside int32.
    v = ok.to(torch.int32)
    w = _weights(v.shape[0], torch.int32, v.device)
    return torch.stack((v.sum(dim=0, dtype=torch.int32),
                        (v * w).sum(dim=0, dtype=torch.int32)))


# One block reads the whole buffer (a window of MAX_LANES lanes from 0,
# masked past B) and writes both output words.
VERDICT_CHECKSUM_CONTRACT = LaunchContract(
    "verdict_checksum",
    grid=lambda ok: (1,),
    threads=THREADS,
    ins=(Window((MAX_LANES,), lambda b: (0,)),),
    outs=(Window((2,), lambda b: (0,)),),
    out_arrays=lambda ok: (((2,), torch.int32),),
    body=_contract_body,
    masked_edge=True,
)


def _check(ok: torch.Tensor) -> int:
    if ok.dtype != torch.bool or ok.dim() != 1 or not ok.is_contiguous():
        raise ValueError(f"ok must be a contiguous (B,) bool tensor, got "
                         f"{tuple(ok.shape)} {ok.dtype}")
    if ok.shape[0] > MAX_LANES:
        raise ValueError(f"{ok.shape[0]} lanes: the checksum's int32 sums "
                         f"hold at most {MAX_LANES}")
    return ok.shape[0]


def verdict_checksum(ok: torch.Tensor) -> torch.Tensor:
    """(count, weighted) of a (B,) bool verdict buffer as (2,) int32 on its
    device. CUDA tensors run the hand-written kernel (or raise); CPU tensors
    run `verdict_checksum_reference`."""
    B = _check(ok)
    if not ok.is_cuda:
        if ok.device.type != "cpu":
            raise ValueError(f"verdict_checksum runs on CUDA or the CPU, not "
                             f"{ok.device}")
        return verdict_checksum_reference(ok).to(torch.int32)
    c = VERDICT_CHECKSUM_CONTRACT
    fn = launch.bind("verdict_checksum", "vc_verdict_checksum")
    ((shape, dtype),) = c.out_arrays((B,))
    out = torch.empty(shape, dtype=dtype, device=ok.device)
    (grid,) = c.grid((B,))
    launch.call(fn, ok.get_device(), ok.data_ptr(), out.data_ptr(), B, grid,
                c.threads)
    verdict_checksum.launches += 1
    return out


verdict_checksum.launches = 0
