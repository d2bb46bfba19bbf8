"""The sharded step's epilogue: each device shard's failure count and verdict
checksum pair, in one launch for all the shards on one device.

Counterpart of the device half of `bitcoinconsensus_tpu/parallel/mesh.py::
make_sharded_step`'s `local_step` (:201-223), an XLA program of the
reference that runs inside `shard_map` after each shard's verify kernel.
Over flat (B,) bool buffers `ok`, `needs` and `live` holding `n_shards`
shards of S = B / n_shards contiguous rows, shard s's int32 triple is

    (sum_i ok[i],  sum_i ok[i] * (i % 251 + 1),  sum_i live[i] & ~ok[i] & ~needs[i])

over its rows, i the shard-local row, as column s of a (3, n_shards)
result (counts, weighted sums, failures): the count and weighted sum of the
reference's `_verdict_checksum` applied to the shard's slice, and the
failures its `psum` reduces into the block verdict.

- `shard_epilogue(ok, needs, live, n_shards)`, the wrapper: CUDA tensors
  launch the hand-written kernel `csrc/shard_step.cu` (built at first use by
  `_build.py`), counting each launch in `shard_epilogue.launches`, and a
  launch that fails raises; CPU tensors run the plain version. Either way
  the result is a (3, n_shards) int32 tensor on the inputs' device.
- `shard_epilogue_reference(ok, needs, live, n_shards)`, the plain version,
  in torch int64.
- `SHARD_EPILOGUE_CONTRACT`, the kernel's launch as the prover checks it
  (`analysis/registry.py`, `cuda.shard_step`): the buffers seen as
  (n_shards, S), one block of 1,024 threads a shard over a window of
  `MAX_LANES` rows masked past S, the shard's three output words written
  once (its column); its body is the same sums in int32, which the interval
  prover holds
  inside int32 up to `MAX_LANES` rows a shard.
"""

from __future__ import annotations

import torch

from . import launch
from .contract import LaunchContract, Window

__all__ = ["shard_epilogue", "shard_epilogue_reference", "SHARD_EPILOGUE_CONTRACT",
           "CHECKSUM_MOD", "MAX_LANES", "MAX_SHARDS"]

CHECKSUM_MOD = 251
THREADS = 1024  # csrc/shard_step.cu SS_THREADS
# csrc/shard_step.cu SS_MAX_LANES: 251 * 2^23 < 2^31, so a shard's weighted
# sum fits int32.
MAX_LANES = 1 << 23
MAX_SHARDS = 65535  # the launcher's bound on the grid


def _weights(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device) % CHECKSUM_MOD + 1


def shard_epilogue_reference(ok: torch.Tensor, needs: torch.Tensor,
                             live: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Plain version: the (3, n_shards) int64 triples."""
    rows = ok.shape[0] // n_shards
    v, nd, lv = (t.reshape(n_shards, rows) for t in (ok, needs, live))
    vi = v.to(torch.int64)
    w = _weights(rows, torch.int64, ok.device)
    fails = (lv & ~v & ~nd).to(torch.int64)
    return torch.stack((vi.sum(1), (vi * w).sum(1), fails.sum(1)))


def _contract_body(block, ok, needs, live):
    # The kernel's int32 arithmetic over one shard's window (1, S), as the
    # column (3, 1): the prover holds every intermediate, and the three
    # sums, inside int32.
    v = ok.to(torch.int32)
    w = _weights(v.shape[1], torch.int32, v.device)
    fails = (live & ~ok & ~needs).to(torch.int32)
    return torch.stack((v.sum(dim=1, dtype=torch.int32),
                        (v * w).sum(dim=1, dtype=torch.int32),
                        fails.sum(dim=1, dtype=torch.int32)))


def _shard_rows() -> Window:
    return Window((1, MAX_LANES), lambda b: (b[0], 0))


# One block a shard reads its shard's row of each (n_shards, S) input (a
# window of MAX_LANES rows from 0, masked past S) and writes its triple.
SHARD_EPILOGUE_CONTRACT = LaunchContract(
    "shard_epilogue",
    grid=lambda ok, needs, live: (ok[0],),
    threads=THREADS,
    ins=(_shard_rows(),) * 3,
    outs=(Window((3, 1), lambda b: (0, b[0])),),
    out_arrays=lambda ok, *_: (((3, ok[0]), torch.int32),),
    body=_contract_body,
    masked_edge=True,
)


def _check(ok: torch.Tensor, needs: torch.Tensor, live: torch.Tensor,
           n_shards: int) -> int:
    for name, t in (("ok", ok), ("needs", needs), ("live", live)):
        if t.dtype != torch.bool or t.dim() != 1 or not t.is_contiguous() \
                or t.shape != ok.shape or t.device != ok.device:
            raise ValueError(f"{name} must be a contiguous (B,) bool tensor on "
                             f"ok's device, got {tuple(t.shape)} {t.dtype} {t.device}")
    if not 1 <= n_shards <= MAX_SHARDS or ok.shape[0] % n_shards:
        raise ValueError(f"{ok.shape[0]} lanes do not split into {n_shards} shards")
    rows = ok.shape[0] // n_shards
    if rows > MAX_LANES:
        raise ValueError(f"{rows} lanes a shard: the epilogue's int32 sums hold "
                         f"at most {MAX_LANES}")
    return rows


def shard_epilogue(ok: torch.Tensor, needs: torch.Tensor, live: torch.Tensor,
                   n_shards: int) -> torch.Tensor:
    """(count, weighted, failures) of each of `n_shards` contiguous shards of
    (B,) bool buffers, as (3, n_shards) int32 on their device. CUDA tensors
    run the hand-written kernel (or raise); CPU tensors run
    `shard_epilogue_reference`."""
    rows = _check(ok, needs, live, n_shards)
    if not ok.is_cuda:
        if ok.device.type != "cpu":
            raise ValueError(f"shard_epilogue runs on CUDA or the CPU, not {ok.device}")
        return shard_epilogue_reference(ok, needs, live, n_shards).to(torch.int32)
    c = SHARD_EPILOGUE_CONTRACT
    fn = launch.bind("shard_step", "ss_shard_epilogue")
    shape = (n_shards, rows)
    ((out_shape, dtype),) = c.out_arrays(shape, shape, shape)
    out = torch.empty(out_shape, dtype=dtype, device=ok.device)
    (grid,) = c.grid(shape, shape, shape)
    launch.call(fn, ok.get_device(), ok.data_ptr(), needs.data_ptr(),
                live.data_ptr(), out.data_ptr(), rows, n_shards, grid, c.threads)
    shard_epilogue.launches += 1
    return out


shard_epilogue.launches = 0
