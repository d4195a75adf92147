"""The ring collectives across processes: two gloo processes on the CPU,
each owning 2 positions of a 4-position mesh, run ``ring_all_gather``,
``ring_mixed_matmul`` and ``sharded_gather_merge_multi``; every rank's
rows are bit-equal to the same rows of the single-process 4-position
virtual mesh. The chunks cross processes by
``torch.distributed.batch_isend_irecv`` (one send and one receive a rank a
hop here), and within a process pass as they are.

The workers reach each other on ``localhost`` at a free port; the test
gives them 120 s.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from gossipy_tpu_torch import parallel
from gossipy_tpu_torch.parallel.collectives import (ring_all_gather,
                                                    ring_mixed_matmul,
                                                    sharded_gather_merge_multi)

REPO = Path(__file__).resolve().parents[1]
N, F, DEPTH, K = 16, 6, 3, 4
TIMEOUT_S = 120

WORKER = textwrap.dedent("""
    import datetime, sys
    import numpy as np
    import torch
    sys.path.insert(0, {repo!r})
    import test_torch_multiprocess as t
    from gossipy_tpu_torch import parallel
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    parallel.init_distributed(f"localhost:{{port}}", 2, rank,
                              backend="gloo",
                              timeout=datetime.timedelta(seconds=60))
    try:
        positions = [parallel.Position(p.device, p.rank, 2 * p.id + j)
                     for p in parallel.devices("cpu") for j in range(2)]
        mesh = parallel.make_mesh(devices=positions)
        rows = slice(rank * t.N // 2, (rank + 1) * t.N // 2)
        got = t.compute(mesh, rows)
        np.savez(out, **{{k: v.numpy() for k, v in got.items()}})
    finally:
        torch.distributed.destroy_process_group()
""")


def inputs():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(N, F)).astype(np.float32)
    w = rng.normal(size=(N, N)).astype(np.float32)
    p = rng.normal(size=(N, F)).astype(np.float32)
    h = rng.normal(size=(DEPTH, N, F)).astype(np.float32)
    idx = rng.integers(0, DEPTH * N, size=(N, K)).astype(np.int64)
    wp = np.where(rng.random((N, K)) < 0.6, 0.4, 0.0).astype(np.float32)
    return x, w, p, h, idx, wp


def compute(mesh, rows) -> dict:
    """The three collectives on this process's ``rows`` of the inputs."""
    x, w, p, h, idx, wp = (torch.from_numpy(a) for a in inputs())
    ws = 1.0 - wp
    return {
        "gather": ring_all_gather(x[rows], mesh),
        "matmul": ring_mixed_matmul(w[rows], x[rows], mesh),
        "merge": sharded_gather_merge_multi(
            p[rows], h[:, rows].contiguous(), idx[rows], ws[rows],
            wp[rows], mesh),
    }


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_equal_one_virtual_mesh(tmp_path):
    want = compute(parallel.make_mesh(4, devices=["cpu"] * 4), slice(None))
    port = free_port()
    script = WORKER.format(repo=str(REPO / "tests"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(port),
         str(tmp_path / f"rank{rank}.npz")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    half = N // 2
    for rank in (0, 1):
        got = np.load(tmp_path / f"rank{rank}.npz")
        rows = slice(rank * half, (rank + 1) * half)
        np.testing.assert_array_equal(got["gather"], want["gather"].numpy())
        np.testing.assert_array_equal(got["matmul"],
                                      want["matmul"][rows].numpy())
        np.testing.assert_array_equal(got["merge"],
                                      want["merge"][rows].numpy())
