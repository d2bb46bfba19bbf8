"""Pause the cyclic garbage collector across an allocation-heavy section.

A `verify_batch` call allocates hundreds of thousands of short-lived
objects (prep records, check tuples, cache keys), which drives CPython's
generational collector into repeated collections that each scan the
heap. Reference counting still frees the acyclic bulk at once; only cycle
collection waits, and a young-generation sweep runs at exit. Nested and
concurrent pauses are safe: the collector comes back when the last paused
section exits, and a caller who had disabled it keeps it disabled; that
sweep runs in the obs span `gc.sweep`. Port of
`bitcoinconsensus_tpu/utils/gcpause.py`.
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager

from ..obs.spans import span as _span

__all__ = ["gc_paused"]

_lock = threading.Lock()
_depth = 0
_reenable = False


@contextmanager
def gc_paused():
    global _depth, _reenable
    with _lock:
        if _depth == 0:
            _reenable = gc.isenabled()
            gc.disable()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            sweep = _depth == 0 and _reenable
            if sweep:
                gc.enable()
        if sweep:
            with _span("gc.sweep"):
                gc.collect(0)
