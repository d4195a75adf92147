"""The cohort pool's row copies in native code, off the GIL.

``pool_rows.cpp`` (built at first use with g++ into ``_build/``, as the
graph generators are) copies rows between the host pool's leaves and the
staging buffers: :func:`gather`, :func:`scatter` (which also marks and
counts the touched rows) and :func:`patch` (the rows two sorted id lists
share) run in the caller's thread with the GIL released for the whole
copy; :class:`Worker` runs gathers and scatters in order on a native
thread that never takes the GIL, so a round's thread that launches op
after op is not slowed by them, nor are they starved by it. A leaf is a
C-contiguous numpy array or CPU tensor with its rows along axis 0.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import build_library

SRC = Path(__file__).resolve().parent / "pool_rows.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def load() -> ctypes.CDLL:
    """The library, built and bound at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(SRC, "pool_rows",
                                                ("-pthread",))))
            ptrs = ctypes.POINTER(_P)
            i64p = ctypes.POINTER(_I64)
            sigs = {
                "rows_gather": ([ctypes.c_int, ptrs, ptrs, i64p, i64p, _I64],
                                _I64),
                "rows_scatter": ([ctypes.c_int, ptrs, ptrs, i64p, i64p, _I64,
                                  _P], _I64),
                "rows_patch": ([ctypes.c_int, ptrs, ptrs, i64p, i64p, _I64,
                                i64p, _I64, _P], _I64),
                "rows_worker_start": ([], _P),
                "rows_worker_stop": ([_P], None),
                "rows_worker_enqueue": ([_P, ctypes.c_int, ctypes.c_int,
                                         ptrs, ptrs, i64p, i64p, _I64, _P],
                                        _I64),
                "rows_worker_wait": ([_P, _I64, i64p], None),
            }
            for name, (args, res) in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib


def _ptr(a) -> int:
    """The address of a C-contiguous numpy array or CPU tensor."""
    if isinstance(a, np.ndarray):
        if not a.flags.c_contiguous:
            raise ValueError("a leaf must be C-contiguous")
        return a.ctypes.data
    if not a.is_contiguous() or a.device.type != "cpu":
        raise ValueError("a leaf must be a contiguous CPU tensor")
    return a.data_ptr()


def _row_bytes(a) -> int:
    if isinstance(a, np.ndarray):
        return int(a.itemsize * int(np.prod(a.shape[1:], dtype=np.int64)))
    return int(a.element_size() * int(np.prod(a.shape[1:], dtype=np.int64)))


class Leaves:
    """Two aligned lists of leaves (``a[l]`` and ``b[l]`` rows of the same
    bytes) as the pointer and row-size arrays the library takes; it keeps
    the leaves alive."""

    def __init__(self, a: Sequence, b: Sequence):
        if len(a) != len(b):
            raise ValueError("leaf lists differ in length")
        sizes = [_row_bytes(x) for x in a]
        if sizes != [_row_bytes(y) for y in b]:
            raise ValueError("leaf rows differ in size")
        self.keep = (list(a), list(b))
        self.n = len(a)
        self.a = (_P * self.n)(*[_ptr(x) for x in a])
        self.b = (_P * self.n)(*[_ptr(y) for y in b])
        self.rb = (_I64 * self.n)(*sizes)


def _ids(idx: np.ndarray):
    if idx.dtype != np.int64 or not idx.flags.c_contiguous:
        raise TypeError("row ids must be a C-contiguous int64 array")
    return idx.ctypes.data_as(ctypes.POINTER(_I64))


def gather(pool: Sequence, bufs: Sequence, idx: np.ndarray) -> None:
    """``bufs[l][i] = pool[l][idx[i]]`` for every leaf."""
    lv = Leaves(pool, bufs)
    if load().rows_gather(lv.n, lv.a, lv.b, lv.rb, _ids(idx), idx.size):
        raise ValueError("too many leaves")


def scatter(pool: Sequence, bufs: Sequence, idx: np.ndarray,
            touched: Optional[np.ndarray] = None) -> int:
    """``pool[l][idx[i]] = bufs[l][i]`` for every leaf; with ``touched``
    (a uint8 or bool array over the pool's rows) marks the rows and
    returns how many were not marked before."""
    lv = Leaves(pool, bufs)
    out = load().rows_scatter(lv.n, lv.a, lv.b, lv.rb, _ids(idx), idx.size,
                              None if touched is None else _ptr(touched))
    if out < 0:
        raise ValueError("too many leaves")
    return int(out)


def patch(dst: Sequence, dst_idx: np.ndarray, src: Sequence,
          src_idx: np.ndarray, hit: Optional[np.ndarray] = None) -> int:
    """The rows of ``dst`` (ids ``dst_idx``, ascending) whose ids are also
    in ``src_idx`` (ascending) take the ``src`` rows; ``hit`` (uint8, one
    a dst row) is set where written. Returns how many were written."""
    lv = Leaves(dst, src)
    out = load().rows_patch(lv.n, lv.a, lv.b, lv.rb, _ids(dst_idx),
                            dst_idx.size, _ids(src_idx), src_idx.size,
                            None if hit is None else _ptr(hit))
    if out < 0:
        raise ValueError("too many leaves")
    return int(out)


class Worker:
    """A native thread running gathers and scatters in the order they are
    queued; :meth:`wait` blocks (without the GIL) until a job has run and
    gives its start and end on the ``perf_counter`` clock (seconds) and
    its result (a scatter's newly touched rows)."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.rows_worker_start()
        self._jobs: dict = {}

    def _enqueue(self, kind: int, pool, bufs, idx: np.ndarray,
                 touched) -> int:
        lv = Leaves(pool, bufs)
        job = self._lib.rows_worker_enqueue(
            self._h, kind, lv.n, lv.a, lv.b, lv.rb, _ids(idx), idx.size,
            None if touched is None else _ptr(touched))
        if job < 0:
            raise ValueError("too many leaves")
        self._jobs[job] = (lv, idx, touched)   # alive until waited for
        return job

    def gather(self, pool, bufs, idx: np.ndarray) -> int:
        return self._enqueue(0, pool, bufs, idx, None)

    def scatter(self, pool, bufs, idx: np.ndarray, touched=None) -> int:
        return self._enqueue(1, pool, bufs, idx, touched)

    def wait(self, job: int) -> tuple[float, float, int]:
        out = (_I64 * 3)()
        self._lib.rows_worker_wait(self._h, job, out)
        self._jobs.pop(job, None)
        return out[0] * 1e-9, out[1] * 1e-9, int(out[2])

    def close(self) -> None:
        if self._h is not None:
            self._lib.rows_worker_stop(self._h)
            self._h = None
