"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface, bound with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The library lands in `build/torch_kernels/` at the root of the checkout,
named by a hash of its source and flags, so a changed source rebuilds and an
unchanged one loads at once. The compiler's output (`-Xptxas -v`: registers,
spills) is kept beside the library. Sources build independently: two
threads may compile two of them at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

__all__ = ["Built", "build", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float  # compile time in this process (0.0 when reused)
    log: str  # nvcc/ptxas output of the build that made `path`


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


def build(name: str) -> Built:
    """Compile `csrc/<name>.cu` unless a library of the same source hash is
    already in the build directory."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _built:
            return _built[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"{name}-{digest}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src} (rc={proc.returncode}):\n"
                        f"{proc.stdout}\n{proc.stderr}"
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
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    built = build(name)
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(built.path))
        return _libs[name]
