"""Named regions for device-time attribution.

The port of `bitcoinconsensus_tpu/ops/regions.py`. On the TPU every kernel
runs under a `jax.named_scope` whose name carries the ``region:`` prefix,
and the profiler's op names carry that scope. A hand-written CUDA kernel
has no name stack: one launch is one region, as one `pallas_call` is on the
TPU, and its region is looked up by the kernel's symbol in
`KERNEL_REGIONS`. Host scopes (`settle`, `dispatch`) are
`torch.profiler.record_function("region:<name>")` ranges: with no profiler
attached they cost a few microseconds; under a capture they show on the
host track as a `user_annotation` and on the device track as a
`gpu_user_annotation` enclosing the kernels launched inside them, which is
what `obs/xprof.py` reads. NVTX ranges are not used: `nsys` does not run on
the card machine, and the capture reads `record_function`.

`lint_kernel_regions` (`analysis/host_lint.py`) holds the table to the
sources: every `__global__` kernel of `csrc/*.cu`, and every kernel a
launcher bound in `ops/` launches, must map to a region here.

This module lives in `ops/`, not `obs/`: the wrappers may import it, and
`obs/xprof.py` does. It imports torch lazily. Region names are stable
identifiers: an xprof report compares shares per region name across runs.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Dict

__all__ = [
    "KERNEL_REGIONS",
    "REGION_PREFIX",
    "extract_region",
    "extract_regions",
    "kernel_region",
    "kernel_symbol",
    "named_region",
    "region_name",
    "region_scope",
]

# Prefix distinguishing consensus regions from incidental annotations in a
# trace event's name.
REGION_PREFIX = "region:"

# CUDA kernel symbol (the `__global__` function's name) -> region. The
# verify kernel keeps the reference's region (`ops/pallas_kernel.py:432`),
# and so does its checked launch, whose epilogue (the checksum's partials)
# rides inside the verify kernel; the standalone checksum keeps the
# reference's (`crypto/jax_backend.py:379`); each toy of
# `csrc/toy_kernels.cu` gets its own (`tk_window_copy_kernel` serves the
# out-of-bounds and double-write launchers alike); the two probes of
# `verify_tiles.cu`'s device functions get theirs. The mesh's epilogue keeps
# the region of the reference's sharded step (`parallel/mesh.py:205`). The
# SHA-256 kernels keep
# the reference's regions (`ops/sha256.py:79`, `:205`): the compression, the
# fixed-length hashes and the merkle levels all ran inside
# `sha256_compress`'s scope there (the port's tree and its one-level
# counterpart too), and the challenge inside `sighash_prep`.
KERNEL_REGIONS: Dict[str, str] = {
    "vt_verify_kernel": "verify_tiles",
    "vt_verify_checked_kernel": "verify_tiles",
    "vc_checksum_kernel": "verdict_checksum",
    "ss_epilogue_kernel": "shard_step",
    "vt_recode_kernel": "vt_recode",
    "vt_field_kernel": "vt_field_op",
    "sh_compress_kernel": "sha256_compress",
    "sh_fixed_kernel": "sha256_compress",
    "sh_merkle_level_kernel": "sha256_compress",
    "sh_merkle_tree_kernel": "sha256_compress",
    "sh_challenge_kernel": "sighash_prep",
    "tk_positive_kernel": "toy_positive",
    "tk_mul_kernel": "toy_mul",
    "tk_f32_dot_tf32_kernel": "toy_f32_dot_tf32",
    "tk_f32_dot_kernel": "toy_f32_dot",
    "tk_f32_square_kernel": "toy_f32_square",
    "tk_f32_write_kernel": "toy_f32_write",
    "tk_window_copy_kernel": "toy_window_copy",
    "tk_read_before_write_kernel": "toy_read_before_write",
}


def region_name(name: str) -> str:
    """The fully-qualified annotation name of a region."""
    return REGION_PREFIX + name


def kernel_symbol(event_name: str) -> str:
    """The bare kernel symbol of a profiler kernel event's name: CUPTI
    reports the demangled signature (`vt_verify_kernel(unsigned int const*,
    ...)`, `void at::native::vectorized_elementwise_kernel<4, ...>(...)`), so
    the name is cut at its template or argument list, and its return type
    and namespaces dropped."""
    cut = min((i for i in (event_name.find("<"), event_name.find("(")) if i >= 0),
              default=len(event_name))
    head = event_name[:cut].strip()
    return head.rsplit(" ", 1)[-1].split("::")[-1]


def kernel_region(event_name: str):
    """The region of a kernel event by its symbol, or None if unmapped."""
    return KERNEL_REGIONS.get(kernel_symbol(event_name))


@contextmanager
def region_scope(name: str):
    """``with region_scope("settle"): ...``: a `record_function` range named
    ``region:<name>``."""
    from torch.profiler import record_function

    with record_function(region_name(name)):
        yield


def named_region(name: str):
    """Decorator: run the wrapped callable inside `region_scope(name)`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with region_scope(name):
                return fn(*args, **kwargs)

        wrapper.__consensus_region__ = name
        return wrapper

    return deco


def extract_regions(scope_name: str) -> list:
    """Every region frame in a name string, outermost first
    (``jit(step)/region:point_decode/region:fe_mul`` -> point_decode, fe_mul)."""
    out = []
    idx = scope_name.find(REGION_PREFIX)
    while idx >= 0:
        tail = scope_name[idx + len(REGION_PREFIX):]
        for sep in ("/", '"', "'", ";", ",", " "):
            cut = tail.find(sep)
            if cut >= 0:
                tail = tail[:cut]
        if tail:
            out.append(tail)
        idx = scope_name.find(REGION_PREFIX, idx + len(REGION_PREFIX))
    return out


def extract_region(scope_name: str) -> str | None:
    """The innermost (last) region frame in a name string, or None."""
    idx = scope_name.rfind(REGION_PREFIX)
    if idx < 0:
        return None
    tail = scope_name[idx + len(REGION_PREFIX):]
    for sep in ("/", '"', "'", ";", ",", " "):
        cut = tail.find(sep)
        if cut >= 0:
            tail = tail[:cut]
    return tail or None
