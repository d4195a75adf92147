"""Whether gloo carries tensors that lie on a CUDA card: the finding
behind the host buffers that ``gossipy_tpu_torch/parallel/collectives.py``
stages a card's chunks through when ranks are joined by gloo. Not part
of the smoke run. From the repo root, on a host with a card::

    python3 tools/gloo_cuda_probe.py

It starts two ranks on ``cuda:0`` joined by gloo and tries, on a
1,024-float tensor on the card, ``batch_isend_irecv``, then
``all_gather``, then ``all_reduce``, each rank printing each outcome
(``ok`` with the values received, or the exception). A rank that the
transport aborts exits with a signal; the parent prints both exit
codes and the card's name and power limit."""
import datetime
import socket
import subprocess
import sys

OPS = ("batch_isend_irecv", "all_gather", "all_reduce")


def rank_main(rank: int, port: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    t = torch.full((1024,), float(rank + 1), device="cuda")

    def p2p():
        buf = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, 1 - rank),
               dist.P2POp(dist.irecv, buf, 1 - rank)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [float(buf[0])]

    def gather():
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        return [float(p[0]) for p in parts]

    def reduce():
        x = t.clone()
        dist.all_reduce(x)
        return [float(x[0])]

    try:
        for name, fn in zip(OPS, (p2p, gather, reduce)):
            try:
                out = fn()
                torch.cuda.synchronize()
                print(f"[gloo-cuda] rank {rank} {name}: ok {out}", flush=True)
            except RuntimeError as e:
                print(f"[gloo-cuda] rank {rank} {name}: {type(e).__name__}: "
                      f"{str(e)[:300]}", flush=True)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port)])
             for r in (0, 1)]
    try:
        rcs = [p.wait(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[gloo-cuda] exit codes {rcs}; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3:
        rank_main(int(sys.argv[1]), sys.argv[2])
    else:
        sys.exit(main())
