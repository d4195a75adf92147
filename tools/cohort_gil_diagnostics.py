"""Which steps of the cohort pipeline's host copies hold the GIL, on a
host with a CUDA card: the diagnosis behind the cohort pipeline's native
row worker (``gossipy_tpu_torch/native/pool_rows.cpp``). Not part of the
smoke run. From the repo root::

    python3 tools/cohort_gil_diagnostics.py

It builds K1 from the repo's sources (the cohort round's merge), then
prints ``[cohort-gil]`` lines: each step's wall and thread CPU time
alone, the round's thread ms a round idle and beside each helper form,
and the card's name and power limit."""
import os
import statistics
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (COHORT_NOMINAL, COHORT_SIZE, cohort_sim,  # noqa: E402
                        log, nvidia_smi_line)


def cohort_gil_diagnostics(torch) -> dict:
    """Which steps of the cohort pipeline's helpers hold the GIL on the
    card's host. At ``chip_smoke.py`` phase 16's
    configuration (nominal COHORT_NOMINAL, C = COHORT_SIZE), one stage
    job (gather a cohort's pool rows, lay an output's rows over them) and
    one flush job (scatter an output, count the newly touched rows) in
    three forms: "numpy", the pipeline's earlier form (the cohort
    drawn in the job, ``np.take`` into a new pinned buffer a leaf,
    ``searchsorted`` and fancy assignments, ``count_nonzero``); "torch"
    (``index_select(out=)`` into a reused pinned slot, the patch and the
    scatter as torch calls); "native" (``native/pool_rows.cpp`` through
    ctypes, which releases the GIL for the whole copy). Each timed alone
    with ``perf_counter`` and ``time.thread_time`` (median of 20). Then
    the round's thread (``_run_round`` of one [C] state, 20 rounds,
    synchronised): idle, beside a Python thread looping each form's stage
    and flush, and beside the native row worker (the pipeline's own,
    which takes no GIL) working through 400 queued jobs: the round's ms
    in each case. A step that holds the GIL slows the round's thread."""
    from gossipy_tpu_torch.native import rows as native_rows
    from gossipy_tpu_torch.simulation import cohort as tcohort
    sim = cohort_sim(torch, COHORT_NOMINAL, "cuda")
    pool = sim.init_cohort_pool(torch.Generator().manual_seed(42))
    n, c = COHORT_NOMINAL, COHORT_SIZE
    material = sim.draws.cohort_seed_material()
    leaves = tcohort._leaves(pool.model) + [pool.phase]
    views = [torch.from_numpy(l) for l in leaves]
    touched = pool.touched.copy()
    touched_t = torch.from_numpy(touched)
    slots = tcohort._Slots(leaves, c, 2, True)
    ids = [tcohort.sample_cohort(material, r, n, c) for r in range(64)]
    ids_t = [torch.from_numpy(i) for i in ids]
    outs = [[torch.empty((c,) + tuple(l.shape[1:]),
                         dtype=v.dtype).pin_memory() for l, v in
             zip(leaves, views)] for _ in range(2)]
    outs_np = [o.numpy() for o in outs[0]]

    def numpy_stage(r):
        idx = tcohort.sample_cohort(material, r, n, c)
        bufs = []
        for l in leaves:
            buf = torch.empty((idx.size,) + tuple(l.shape[1:]),
                              dtype=torch.from_numpy(l[:0]).dtype,
                              pin_memory=True)
            np.take(l, idx, axis=0, out=buf.numpy())
            bufs.append(buf.numpy())
        other = ids[(r + 1) % 64]
        pos = np.minimum(np.searchsorted(other, idx), other.size - 1)
        hit = other[pos] == idx
        for dst, row in zip(bufs, outs_np):
            dst[hit] = row[pos[hit]]
        return idx

    def numpy_flush(r):
        idx = ids[r % 64]
        for dst, src in zip(leaves, outs[r % 2]):
            dst[idx] = src.numpy()
        newly = int(np.count_nonzero(~touched[idx]))
        touched[idx] = True
        return newly

    def torch_stage(r):
        idx_t = ids_t[r % 64]
        _, bufs = slots.take(r)
        for view, buf in zip(views, bufs):
            torch.index_select(view, 0, idx_t, out=buf)
        other = ids_t[(r + 1) % 64]
        pos = torch.searchsorted(other, idx_t).clamp_(max=other.numel() - 1)
        hit = other.index_select(0, pos) == idx_t
        rows = hit.nonzero().squeeze(1)
        src = pos.index_select(0, rows)
        for dst, row in zip(bufs, outs[0]):
            dst.index_copy_(0, rows, row.index_select(0, src))
        return idx_t

    def torch_flush(r):
        idx_t = ids_t[r % 64]
        for view, src in zip(views, outs[r % 2]):
            view.index_copy_(0, idx_t, src)
        newly = int(touched_t.index_select(0, idx_t).logical_not_().sum())
        touched_t.index_fill_(0, idx_t, True)
        return newly

    def native_stage(r):
        _, bufs = slots.take(r)
        native_rows.gather(leaves, bufs, ids[r % 64])
        return native_rows.patch(bufs, ids[r % 64], outs[0],
                                 ids[(r + 1) % 64])

    def native_flush(r):
        return native_rows.scatter(leaves, outs[r % 2], ids[r % 64],
                                   touched)

    steps = {"numpy stage": numpy_stage, "numpy flush": numpy_flush,
             "torch stage": torch_stage, "torch flush": torch_flush,
             "native stage": native_stage, "native flush": native_flush,
             "sample_cohort": lambda r: tcohort.sample_cohort(
                 material, r, n, c)}
    alone = {}
    for label, fn in steps.items():
        walls, cpus = [], []
        for r in range(20):
            t0, c0 = time.perf_counter(), time.thread_time()
            fn(r)
            walls.append((time.perf_counter() - t0) * 1e3)
            cpus.append((time.thread_time() - c0) * 1e3)
        alone[label] = (statistics.median(walls), statistics.median(cpus))
        log(f"[cohort-gil] {label} alone: {alone[label][0]:.4f} ms wall, "
            f"{alone[label][1]:.4f} ms thread CPU")

    model = tcohort._unleaves([t.cuda() for t in
                               slots.take(0)[1][:len(leaves) - 1]])
    state0 = sim.init_state(model, slots.bufs[0][-1].cuda())

    def rounds_ms(helper=None, worker_jobs=0) -> float:
        stop = threading.Event()

        def loop():
            r = 0
            while not stop.is_set():
                helper(r)
                r += 1

        th = threading.Thread(target=loop) if helper else None
        worker = native_rows.Worker() if worker_jobs else None
        state = sim.init_state(state0.model, state0.phase)
        data_saved = sim.data
        sim.data = {k: v[:c] if k not in ("x_eval", "y_eval") else v
                    for k, v in data_saved.items()}
        try:
            sim._run_round(state, 10_000)
            torch.cuda.synchronize()
            if th is not None:
                th.start()
            jobs = [worker.gather(leaves, slots.bufs[1], ids[i % 64])
                    if i % 2 else worker.scatter(leaves, outs[1],
                                                 ids[i % 64], touched)
                    for i in range(worker_jobs)]
            t0 = time.perf_counter()
            for _ in range(20):
                sim._run_round(state, 10_000)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 20 * 1e3
            if worker is not None:
                spans = [worker.wait(j) for j in jobs]
                busy = sum(b - a for a, b, _ in spans)
                log(f"[cohort-gil] the native worker ran {len(jobs)} jobs, "
                    f"{busy * 1e3:.3f} ms of copies, from "
                    f"{(spans[0][0] - t0) * 1e3:.3f} to "
                    f"{(spans[-1][1] - t0) * 1e3:.3f} ms of the "
                    f"{ms * 20:.3f} ms of rounds")
            return ms
        finally:
            stop.set()
            if th is not None:
                th.join()
            if worker is not None:
                worker.close()
            sim.data = data_saved

    def both(stage, flush):
        return lambda r: (stage(r), flush(r))

    rounds = {"idle": rounds_ms(),
              "numpy helper": rounds_ms(both(numpy_stage, numpy_flush)),
              "torch helper": rounds_ms(both(torch_stage, torch_flush)),
              "native helper": rounds_ms(both(native_stage, native_flush)),
              "native worker": rounds_ms(worker_jobs=400),
              "idle again": rounds_ms()}
    log("[cohort-gil] the round's thread, ms a round: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rounds.items()))
    log(nvidia_smi_line())
    return {"alone": alone, "rounds": rounds}


if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        sys.exit("cohort_gil_diagnostics: no CUDA device")
    from gossipy_tpu_torch.ops import _build
    _build.build(["gather_merge_multi"])
    cohort_gil_diagnostics(torch)
