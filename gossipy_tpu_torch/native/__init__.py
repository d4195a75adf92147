"""The native graph generators, loaded through ctypes.

Counterpart of ``gossipy_tpu/native``: ``graphgen.cpp`` is a copy of the
JAX package's source, byte for byte, so the same ``(n, k | m | p, seed)``
gives the same edge set in both packages. It holds the dense-adjacency
generators (``gen_erdos_renyi``, ``gen_random_regular``,
``gen_barabasi_albert``, ``gen_ring``), which write a ``uint8`` ``[n, n]``
buffer, and the edge-list ones (``gen_*_edges``), which write an
undirected ``[E, 2]`` int32 list in O(E) memory: those build the sparse
topologies at population scale.

The library is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``gossipy_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, as
``ops/_build.py`` names the CUDA kernels; nothing is built at import.
:func:`available` says whether it could be built; every other entry point
raises when it cannot.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "graphgen.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgraphgen-{digest[:16]}.so"


def _build() -> Path:
    """Compile the library unless this source's build is there already;
    raises with the compiler's output when it fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native graph generators are "
                           "built with the host's C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, ndim=2,
                                 flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, ndim=2,
                                  flags="C_CONTIGUOUS")
    i32, i64, u64, f64 = (ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,
                          ctypes.c_double)
    sigs = {
        "gen_erdos_renyi": ([i32, f64, u64, u8p], None),
        "gen_random_regular": ([i32, i32, u64, u8p], i32),
        "gen_barabasi_albert": ([i32, i32, u64, u8p], None),
        "gen_ring": ([i32, i32, u8p], None),
        "gen_random_regular_edges": ([i32, i32, u64, i32p], i64),
        "gen_erdos_renyi_edges": ([i32, f64, u64, i32p, i64], i64),
        "gen_barabasi_albert_edges": ([i32, i32, u64, i32p], i64),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def load() -> ctypes.CDLL:
    """The generators' library, built and bound at first use; raises when
    it cannot be built (the first failure is kept and raised again)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            _lib = _bind(ctypes.CDLL(str(_build())))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _error = f"native graph generators unavailable: {exc}"
            raise RuntimeError(_error) from exc
        return _lib


def available() -> bool:
    """Whether the library is built, or can be."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _dense(fill) -> np.ndarray:
    return fill.view(bool)   # the same itemsize: no copy


def erdos_renyi(n: int, p: float, seed: int = 42) -> np.ndarray:
    """Bool ``[n, n]`` adjacency of G(n, p)."""
    adj = np.zeros((n, n), dtype=np.uint8)
    load().gen_erdos_renyi(n, float(p), seed, adj)
    return _dense(adj)


def _regular_rc(rc: int, n: int, k: int) -> None:
    """Raise for the pairing model's error codes: -1 for an impossible
    ``(n, k)``, -2 when no simple graph was found."""
    if rc == -1:
        raise ValueError(f"no {k}-regular graph on {n} nodes (n*k must be "
                         "even and k < n)")
    if rc < 0:
        raise RuntimeError("pairing model failed to find a simple graph")


def random_regular(n: int, k: int, seed: int = 42) -> np.ndarray:
    """Bool ``[n, n]`` adjacency of a random k-regular graph (the pairing
    model)."""
    adj = np.zeros((n, n), dtype=np.uint8)
    _regular_rc(load().gen_random_regular(n, k, seed, adj), n, k)
    return _dense(adj)


def _check_ba(n: int, m: int) -> None:
    if not 1 <= m < n:
        raise ValueError(f"Barabasi-Albert needs 1 <= m < n, got m = {m}, "
                         f"n = {n}")


def barabasi_albert(n: int, m: int, seed: int = 42) -> np.ndarray:
    """Bool ``[n, n]`` adjacency of a Barabasi-Albert graph."""
    _check_ba(n, m)
    adj = np.zeros((n, n), dtype=np.uint8)
    load().gen_barabasi_albert(n, m, seed, adj)
    return _dense(adj)


def ring(n: int, k: int = 1) -> np.ndarray:
    """Bool ``[n, n]`` adjacency of a ring lattice, ``k`` neighbours a
    side."""
    adj = np.zeros((n, n), dtype=np.uint8)
    load().gen_ring(n, k, adj)
    return _dense(adj)


def random_regular_edges(n: int, k: int, seed: int = 42) -> np.ndarray:
    """Undirected edge list ``[E, 2]`` int32 of a random k-regular graph,
    in O(E) memory."""
    edges = np.empty((n * k // 2 + 1, 2), dtype=np.int32)
    m = load().gen_random_regular_edges(n, k, seed, edges)
    _regular_rc(m, n, k)
    return edges[:m]


def erdos_renyi_edges(n: int, p: float, seed: int = 42) -> np.ndarray:
    """Undirected edge list ``[E, 2]`` int32 of G(n, p) by skip sampling.
    The buffer holds the mean plus six deviations; a draw that needs more
    is made again, from the same seed, into a buffer of its exact size."""
    lib = load()
    mean = p * n * (n - 1) / 2
    cap = int(mean + 6 * np.sqrt(mean + 1) + 64)
    while True:
        edges = np.empty((cap, 2), dtype=np.int32)
        m = lib.gen_erdos_renyi_edges(n, float(p), seed, edges, cap)
        if m <= cap:
            return edges[:m]
        cap = int(m) + 64


def barabasi_albert_edges(n: int, m: int, seed: int = 42) -> np.ndarray:
    """Undirected edge list ``[E, 2]`` int32 of a Barabasi-Albert graph."""
    _check_ba(n, m)
    edges = np.empty((m * (n - m - 1) + m + 1, 2), dtype=np.int32)
    cnt = load().gen_barabasi_albert_edges(n, m, seed, edges)
    return edges[:cnt]
