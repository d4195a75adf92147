"""K3/K4 (``gossipy_tpu_torch/csrc/gather_merge_flat.cu``) timed beside an
earlier ``gather_merge_flat.cu``, in one process on one card. Not part of
the smoke run. From the repo root, on a host with a card, with an earlier
source and its header in a directory::

    mkdir -p _archive/old_flat
    for f in gather_merge_flat.cu wire_rows.cuh; do
      git show <commit>:gossipy_tpu_torch/csrc/$f > _archive/old_flat/$f
    done
    python3 tools/flat_ab.py --old _archive/old_flat [--out FILE]

The earlier source is one with the int32-index C interface
(``gather_merge_flat(p, h, idx32, ws, wp, out, n, f, stream)`` and its
``_dq`` form), as the repo had it before K3/K4 read the int64 table;
``nvcc`` builds it with the port's flags into a temporary directory
outside the repo.

Shapes: the token north star's (100 rows of LogReg's 116 columns, a
2-cell ring, one slot) and phase 4's CIFAR10Net rows (64 x 73,420, its 10
leaves), each on float32, bfloat16 and int8 rings. At each, every variant
is first held bit for bit to the plain version; then each is timed as
``chip_smoke.time_ms`` times a call (a CUDA graph of 20 calls back to
back, the median of 50 replays) and, where a call moves more than a
quarter of the L2, as ``chip_smoke.time_ms_cold`` times it (the calls
rotate over copies of the inputs, so none finds them in the L2, as a
round's merge does), TURNS times in turns (the list below, then the list
reversed), and the median of the turns kept:

- ``old``: the earlier kernel through what its wrapper did, the int64 ->
  int32 index cast and the kernel; ``old_kernel``: the kernel alone on an
  int32 table made outside the timed call;
- ``new``: ``gather_merge_flat``;
- ``torch.add`` (float32 rings): PyTorch's elementwise add of ``p`` and
  the named ring rows gathered beforehand, a yardstick of what the card
  streams at this read and write mix without the gather (it computes
  another function and is used nowhere in the port).

Prints a line per (shape, ring, variant, timing) and one JSON object of
them all (also written to ``--out``), then the card's name and power
limit.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TURNS = 2   # each variant is timed TURNS times, in turns with the others


def build_old(src_dir: str):
    """The earlier source built into a temporary directory, loaded."""
    from gossipy_tpu_torch.ops import _build
    out_dir = tempfile.mkdtemp(prefix="old_flat_")
    lib = os.path.join(out_dir, "libold_flat.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
           os.path.join(src_dir, "gather_merge_flat.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier source:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib)


def old_launcher(torch, lib, merge, k3: bool, scale, starts, cast: bool):
    """A call of the earlier kernel (``k3``: its float32 entry point, else
    its ``_dq`` one) on ``(p, h, tab, ws, wp)``: with ``cast``, ``tab`` is
    the int64 table, cast to int32 inside the call as its wrapper did;
    else ``tab`` is an int32 table made beforehand."""
    from gossipy_tpu_torch.ops import _build
    n_leaves = 0 if scale is None else scale.shape[1]
    fn = lib.gather_merge_flat if k3 else lib.gather_merge_flat_dq
    fn.restype = ctypes.c_int
    if k3:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2
                       + [ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 5
                       + [ctypes.c_int64, ctypes.c_void_p]
                       + [ctypes.c_int64] * 2 + [ctypes.c_void_p])

    def launch(p, h, tab, ws, wp):
        n, f = p.shape
        if cast:
            tab = tab.to(torch.int32).contiguous()
        out = torch.empty_like(p)
        if k3:
            rc = fn(p.data_ptr(), h.data_ptr(), tab.data_ptr(),
                    ws.data_ptr(), wp.data_ptr(), out.data_ptr(), n, f,
                    _build.stream(p))
        else:
            rc = fn(p.data_ptr(), h.data_ptr(), merge.WIRE_FORMATS[h.dtype],
                    tab.data_ptr(), ws.data_ptr(), wp.data_ptr(),
                    None if scale is None else scale.data_ptr(),
                    None if starts is None else starts.data_ptr(), n_leaves,
                    out.data_ptr(), n, f, _build.stream(p))
        _build.raise_if_failed("old gather_merge_flat", rc)
        return out
    return launch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", required=True,
                        help="directory holding the earlier "
                             "gather_merge_flat.cu and wire_rows.cuh")
    parser.add_argument("--out", default=None,
                        help="also write the JSON object to this file")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flat_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gossipy_tpu_torch.handlers import SGDHandler, losses
    from gossipy_tpu_torch.models import CIFAR10Net, LogisticRegression
    from gossipy_tpu_torch.ops import _build, merge

    smi = cs.nvidia_smi_line()
    rate = cs.memory_rate(torch.cuda.get_device_name(0))
    _build.build([merge.SOURCES[merge.KERNEL_FLAT]])
    for line in _build.build_log(merge.SOURCES[merge.KERNEL_FLAT]) \
            .splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}", flush=True)
    old = build_old(opts.old)
    shapes = []
    for label, model, shape, n in (
            ("token", LogisticRegression(57, 2), None, 100),
            ("flagship row", CIFAR10Net(), (32, 32, 3), 64)):
        layout = SGDHandler(model, losses.cross_entropy,
                            **({"input_shape": shape} if shape else {})
                            ).layout
        shapes.append((label, n, layout.stride,
                       [layout.offsets[leaf] for leaf, _ in layout.leaves]))
    results = []
    for seed, (label, n, f, starts) in enumerate(shapes, start=300):
        for wire in ("float32", "bfloat16", "int8"):
            rng = np.random.default_rng(seed)
            dev = torch.device("cuda")
            p = rng.normal(size=(n, f)).astype(np.float32)
            p[::3, f // 2] = -0.0
            p = torch.from_numpy(p).to(dev)
            h, scale = cs.wire_ring(torch, rng, 2 * n, f, len(starts), wire,
                                    dev)
            idx, ws, wp = cs.merge_tables(rng, n, 2, 1)
            args = (p, h, *(torch.from_numpy(a[:, 0]).to(dev)
                            for a in (idx, ws, wp)))
            sc = None if scale is None else torch.from_numpy(scale).to(dev)
            st = None if sc is None else torch.tensor(starts,
                                                      dtype=torch.int32,
                                                      device=dev)
            k3 = merge._flat_kernel(h, sc) == merge.KERNEL_FLAT
            want = merge.gather_merge_reference(*args, sc, st)
            idx32 = (args[2].to(torch.int32),)
            calls = {   # name: (function, its arguments)
                "old": (old_launcher(torch, old, merge, k3, sc, st, True),
                        args),
                "old_kernel": (old_launcher(torch, old, merge, k3, sc, st,
                                            False),
                               args[:2] + idx32 + args[3:]),
                "new": (lambda *a: merge.gather_merge_flat(*a, sc, st),
                        args)}
            for name, (call, a) in calls.items():
                cs.check_equal(torch, f"{label} [{wire}] {name}", call(*a),
                               want, (n, f))
            if wire == "float32":
                calls["torch.add"] = (torch.add, (p, h[args[2]].contiguous()))
            n_scales = 0 if sc is None else len(starts)
            rows = len(np.unique(idx[:, 0]))
            nbytes = (4 * f * 2 * n + cs.ITEMSIZE[wire] * f * rows
                      + n * (8 + 4 + 4) + 4 * n_scales * (rows + 1))
            flops = f * 3 * n + (0 if sc is None else f * n)
            bound_ms, bound_by = cs.bound(nbytes, flops, rate)
            timings = {"ms": lambda fn, a: cs.time_ms(torch,
                                                     lambda: fn(*a))}
            if nbytes > cs.L2_BYTES // 4:
                timings["cold_ms"] = lambda fn, a: cs.time_ms_cold(
                    torch, fn, a, nbytes)
            times = {(name, t): [] for name in calls for t in timings}
            order = list(times)
            for turn in range(TURNS):
                for name, t in (order if turn % 2 == 0 else order[::-1]):
                    times[(name, t)].append(timings[t](*calls[name]))
            row = {"shape": label, "n": n, "f": f, "wire": wire,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "plan": merge.flat_plan(n, f, h.dtype, True,
                                           sc is not None)._asdict(),
                   **{t: {} for t in timings}}
            for (name, t), ts in times.items():
                ms = statistics.median(ts)
                row[t][name] = {"median": ms, "turns": ts,
                                "share": bound_ms / ms}
                print(f"[flat_ab] {label} n={n} f={f} [{wire}] {name} {t}: "
                      f"{ms:.5f} ms (turns {', '.join(f'{x:.5f}' for x in ts)}"
                      f") share {bound_ms / ms:.3f} of {bound_ms:.5f} "
                      f"({bound_by})", flush=True)
            results.append(row)
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "results": results}
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(report), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
