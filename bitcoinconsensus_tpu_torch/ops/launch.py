"""The host side of a kernel launch, kept lean.

A wrapper's per-call host cost is what a caller waits for when a kernel is
small: a toy kernel runs about 1 µs on the card and its wrapper took tens
of µs. Three pieces take that cost out of the call:

- `bind(source, symbol)`: the C launcher of `csrc/<source>.cu`, built at
  first use and bound once.
- `Plan`: what a launch at one (kernel, shape, dtype, device) needs, resolved
  once from the kernel's `LaunchContract` and kept by the caller.
- `call(fn, index, *args)`: the launch on device `index`'s current stream.
  Every launcher takes its arguments packed as one array of 64-bit words
  (the stream last), which ctypes passes as one pointer instead of
  converting each argument. The array is the calling thread's own: ctypes
  releases the GIL during the call. The device guard is entered only when
  `index` is not the current device, and the stream's handle is read
  without building a `Stream` object.

The launcher returns cudaGetLastError() after its launch; `call` raises on
anything but 0. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from . import _build

__all__ = ["bind", "Plan", "call"]

_lock = threading.Lock()
_bound: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def bind(source: str, symbol: str) -> ctypes._CFuncPtr:
    """`symbol` of the library built from `csrc/<source>.cu`: a launcher
    that takes one array of 64-bit words and returns a CUDA error code."""
    key = (source, symbol)
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(_build.load(source), symbol)
        fn.restype = ctypes.c_int
        with _lock:
            fn = _bound.setdefault(key, fn)
    return fn


@dataclass(frozen=True)
class Plan:
    """One resolved launch: the bound launcher, grid, threads, and the
    output's shape and dtype (`like_input`: the input's, so the output is
    made by `empty_like`)."""

    fn: ctypes._CFuncPtr
    grid: int
    threads: int
    out_shape: Tuple[int, ...]
    out_dtype: torch.dtype
    like_input: bool = False


_device_of = None  # torch's current-device and raw-stream readers,
_stream_of = None  # resolved at the first launch


def _resolve() -> None:
    global _device_of, _stream_of
    _device_of = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    _stream_of = raw or (lambda i: torch.cuda.current_stream(i).cuda_stream)


def _check(fn, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


_tls = threading.local()


def call(fn, index: int, *args) -> None:
    """fn(args..., stream) on device `index`'s current stream, the integers
    packed into the thread's own array of 64-bit words; raises if the
    launcher reports a CUDA error."""
    if _device_of is None:
        _resolve()
    try:
        words = _tls.words
    except AttributeError:
        words = _tls.words = (ctypes.c_int64 * 24)()
    n = len(args)
    words[:n] = args
    if index == _device_of():
        words[n] = _stream_of(index)
        _check(fn, fn(words))
    else:
        with torch.cuda.device(index):
            words[n] = _stream_of(index)
            _check(fn, fn(words))
