"""Build the port's native sources into shared libraries and load them.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface, bound with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The host core `csrc/native/` (the name `nat`) is compiled by g++ with the
flags of the reference's `native/Makefile`, its warnings left out:

    g++ -O3 -std=c++17 -fPIC -shared csrc/native/nat.cpp

and so are the host builds of two kernels' lane functions: the verify
kernel's (`csrc/verify_tiles_host.cpp`, which includes `verify_tiles.cu`;
the name `verify_tiles_host`), which the scalar-schedule prover runs, and
SHA-256's (`csrc/sha256_host.cpp` with `sha256.cu`; `sha256_host`), which
the tests hold to hashlib.

A library lands in `build/torch_kernels/` at the root of the checkout,
named by a hash of its sources and flags (all seven of the host core's, so
a changed header rebuilds too), and an unchanged one loads at once. The
compiler's output (`-Xptxas -v`: registers, spills) is kept beside the
library. Sources build independently: two threads may compile two of them
at once, and processes that want the same library take turns on a file
lock. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

__all__ = ["Built", "build", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_CORE = "nat"
HOST_CORE_SOURCES = ("nat.cpp", "secp.hpp", "sha256.hpp", "hash_extra.hpp",
                     "interp.hpp", "eval.hpp", "block.hpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
VT_HOST = "verify_tiles_host"
SH_HOST = "sha256_host"
# g++ builds of a `.cu` source's lane functions: name -> the `.cu` included.
HOST_BUILDS = {VT_HOST: "verify_tiles.cu", SH_HOST: "sha256.cu"}


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float  # compile time in this process (0.0 when reused)
    log: str  # the compiler's output (nvcc: ptxas -v) for `path`


_lock = threading.Lock()  # guards the three dicts
_name_locks: Dict[str, threading.Lock] = {}
_built: Dict[str, Built] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the native host core builds with g++")


def _recipe(name: str) -> Tuple[Callable[[], str], Sequence[str], List[Path]]:
    """(compiler lookup, flags, sources: the compiled one first)."""
    if name == HOST_CORE:
        return _gxx, GXX_FLAGS, [CSRC / "native" / s for s in HOST_CORE_SOURCES]
    if name in HOST_BUILDS:
        return _gxx, GXX_FLAGS, [CSRC / f"{name}.cpp", CSRC / HOST_BUILDS[name]]
    return _nvcc, NVCC_FLAGS, [CSRC / f"{name}.cu"]


def build(name: str) -> Built:
    """Compile `csrc/<name>.cu` (or a g++ source: the host core, `nat`, or
    a host build of `HOST_BUILDS`) unless a library of the same source hash
    is already in the build directory."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _built:
            return _built[name]
        find_compiler, flags, srcs = _recipe(name)
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in srcs) + " ".join(flags).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"{name}-{digest}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        with open(BUILD_DIR / f"{name}.lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)  # released when closed
            if not out.exists():
                t0 = time.perf_counter()
                compiler = find_compiler()
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    try:
                        proc = subprocess.run(
                            [compiler, *flags, "-o", tmp, str(srcs[0])],
                            capture_output=True, text=True,
                        )
                    except OSError as e:
                        raise RuntimeError(
                            f"{compiler} could not run on {srcs[0]}: {e}"
                        ) from e
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"{compiler} failed on {srcs[0]} "
                            f"(rc={proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
                        )
                    log_path.write_text(proc.stdout + proc.stderr)
                    os.replace(tmp, out)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                seconds = time.perf_counter() - t0
        log = log_path.read_text() if log_path.exists() else ""
        built = Built(out, seconds, log)
        with _lock:
            _built[name] = built
        return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (or of a g++ source), built at
    first use."""
    built = build(name)
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(built.path))
        return _libs[name]
