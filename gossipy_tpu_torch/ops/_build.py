"""Build the CUDA kernels in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is a file with a plain C interface; the headers
beside it (``csrc/*.cuh``) hold device code the sources share. A source is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``_build/`` (listed in ``.gitignore``), named by a hash of the source, the
headers and the flags, and loaded with ``ctypes``. Nothing is built at import: the
first wrapper call on a CUDA tensor builds what it needs. :func:`build`
starts one ``nvcc`` per source, all at once, and waits for them together.
A build is safe across processes (the ranks of a process group that
reach a kernel together): each source's build holds a file lock
(``_build/<name>.lock``) while it checks for, compiles and renames the
library into place, so one process compiles and the others wait and
load what it wrote; a library appears only whole (an atomic rename).

The wrappers bind an entry point with :func:`function`, launch on
PyTorch's current stream (:func:`stream`), raise on a launch error
(:func:`raise_if_failed`) and count each launch in :data:`LAUNCHES`, one
counter per kernel, shared by every kernel of the package.

Each kernel's dispatch function (the public wrapper that picks the
kernel on a CUDA tensor and the plain version on a CPU tensor) calls
:func:`kernel_entry` as it is entered, on both routes: :data:`ENTRIES`
counts those calls per kernel, and every listener added with
:func:`add_entry_listener` hears them in call order. On the card
``LAUNCHES`` equals ``ENTRIES`` for every kernel; on the host only
``ENTRIES`` counts. The kernels are bound through ``ctypes``, so a
``TorchDispatchMode`` never sees them: the entry log is how the op trace
of ``analysis.program`` sees a kernel.

Flags: ``-O3 --fmad=false`` (no multiply-add contraction, so a kernel
rounds as its plain PyTorch version does) and ``-Xptxas -v`` (registers,
shared memory and spills per kernel, kept in ``_build/<name>.log``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_LOADED: dict = {}

# Kernel launches per kernel, counted where a wrapper launches its kernel
# and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()


# Calls of each kernel's dispatch function, on the card and on the host.
ENTRIES: collections.Counter = collections.Counter()

_ENTRY_LISTENERS: list = []


def reset_launch_counts() -> None:
    """Set :data:`LAUNCHES` and :data:`ENTRIES` to 0."""
    LAUNCHES.clear()
    ENTRIES.clear()


def kernel_entry(name: str) -> None:
    """Count one call of kernel ``name``'s dispatch function and tell the
    listeners, in call order."""
    ENTRIES[name] += 1
    for fn in _ENTRY_LISTENERS:
        fn(name)


def add_entry_listener(fn) -> None:
    """Call ``fn(kernel name)`` at every :func:`kernel_entry`."""
    _ENTRY_LISTENERS.append(fn)


def remove_entry_listener(fn) -> None:
    _ENTRY_LISTENERS.remove(fn)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else the toolkit's default
    location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


@contextlib.contextmanager
def _locked(names):
    """Hold the build lock of every named source (taken in sorted order,
    so two processes never wait on each other)."""
    files = []
    try:
        for name in sorted(set(names)):
            f = open(BUILD_DIR / f"{name}.lock", "a")
            files.append(f)
            fcntl.flock(f, fcntl.LOCK_EX)
        yield
    finally:
        for f in reversed(files):
            fcntl.flock(f, fcntl.LOCK_UN)
            f.close()


def build(names) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together, under the sources' build locks (a
    process that finds a source locked waits, then finds its library).
    Returns ``{name: library path}``; raises with the compiler's output
    when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    if all(path.exists() for path in paths.values()):
        return paths
    with _locked(paths):
        procs = {}
        for name, path in paths.items():
            if path.exists():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name} (rc {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib


def build_log(name: str) -> str:
    """What ``nvcc`` printed for ``name`` when it was last built here."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def function(source: str, entry: str, argtypes: list):
    """The C entry point ``entry`` of ``csrc/<source>.cu``, built and
    loaded at first use, with its ctypes signature (returns a CUDA error
    code)."""
    fn = getattr(load(source), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the kernels take it
    (so a launch can be captured in a CUDA graph)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_if_failed(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
