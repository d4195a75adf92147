"""One gossip run across two processes: two gloo ranks on the CPU, each
holding its own rows of a 2-position mesh, run ``GossipSimulator(mesh=)``
(``parallel.init_distributed``, then ``make_mesh()`` over every rank's
positions), against the same runs in one process on a 2-position virtual
mesh and against the JAX package's mesh run.

One spawn of two ranks serves every check; each rank runs these legs
(``run_legs``) and saves what it holds:

- ``northstar``: the north star's shape at a small size (16 nodes, 8
  features, ``random_regular(16, 4)``, ``LogisticRegression``, SGD 0.1,
  batch 32, PUSH, MERGE_UPDATE, the multi deliver), 10 rounds: both
  ranks' reports equal, equal to the virtual mesh run's, and every rank's
  rows of every leaf equal to the same rows of the virtual mesh run's
  state, bit for bit (accounting, mailboxes and ages among them); the
  gather functions bring the whole state back on every rank;
- ``network``: the examples' network model across ranks (PUSH_PULL,
  async nodes, delays, drops, 80% online, sampled eval, an int8 ring), 8
  rounds: the replies cross ranks; the same checks;
- ``oracle``: under the JAX draw oracle, from the JAX ``init_nodes``
  state, 6 rounds against the JAX engine's run on a 2-device mesh:
  accounting exact, params and metrics within PERF.md section 2's
  tolerances (``torch_pairs.assert_same_run``);
- ``ring``: ``ring_attention`` across the ranks (causal, S = 32, D = 8),
  K5's plain version and the plain hop, against the one-process rings
  (bit for bit) and the JAX package's ``ring_attention`` (1e-6);
- ``nohang``: every peer lies on rank 0, so rank 1's receivers never
  get a message; both ranks finish and equal the virtual mesh run;
- ``telemetry``: the oracle leg's configuration with ``probes=True``,
  ``sentinels=True``, a chaos scenario (an outage of every node of rank
  0, a partition whose components straddle the ranks) and a live
  ``CallbackReceiver``, 10 rounds; ``a2a-ring`` and ``a2a-dense``:
  All2All with uniform mixing on its ring and dense forms, probes and
  sentinels on, 8 rounds (and ``a2a-sparse``, its segment mix over the
  CSR form of the same graph). Under the oracle, every rank's rows, report
  (every ``probe_*``/``health_*``/``chaos_*`` array among them) and live
  rows equal the virtual mesh run's bit for bit, and the run matches the
  JAX engine's on a 2-device mesh (``torch_pairs.assert_same_telemetry``);
- ``variant`` and ``variant-oracle``: a user's subclass that keeps the
  base receive path (``Quota``: ``_init_aux``, ``_pre_send`` and a
  ``_send_gate`` that reads a per-node ``aux`` value) on the north
  star's shape, bit-equal to the virtual mesh run, and under the oracle
  against its JAX twin (``JQuota``) on a 2-device mesh, ``aux`` included;
- ``refusals``: what a mesh across ranks still refuses (a subclass that
  overrides a receive hook, as every mesh refuses it; one process's
  positions on two devices) raises naming why; ``lifted``: the uses the
  refusal list no longer holds (a checkpoint's save, load and
  ``restore_checkpoint(mesh=)``, ``perf=``, ``metrics=``, ``ledger=``,
  ``tracing=``, a user's subclass of the engine and of All2All, a
  cohort's ``start(mesh=)``, the service and a disk-backed cohort pool)
  each run a round or a round trip (``test_torch_multiprocess_persist.py``,
  ``..._cohort.py``, ``..._service.py`` and ``..._pool.py`` hold them to
  the one-process runs).

The ranks reach each other on ``localhost`` at a free port; the spawn
has TIMEOUT_S and is reaped whatever happens.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gossipy_tpu import core as jcore
from gossipy_tpu import parallel as jparallel
from gossipy_tpu import simulation as jsimulation
from gossipy_tpu.parallel.collectives import \
    ring_attention as jring_attention
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import parallel
from gossipy_tpu_torch.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu_torch.handlers import ModelState, SGDHandler, losses
from gossipy_tpu_torch.models import LogisticRegression
from gossipy_tpu_torch.parallel import rules
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import All2AllGossipSimulator, \
    GossipSimulator

REPO = Path(__file__).resolve().parents[1]
N, FEAT, ROUNDS = 16, 8, 10
ORACLE_ROUNDS = 6
TELEMETRY_ROUNDS, A2A_ROUNDS = 10, 8
ATTN_S, ATTN_D = 32, 8
TIMEOUT_S = 150

WORKER = textwrap.dedent("""
    import datetime, sys
    import torch
    sys.path.insert(0, {tests!r})
    import test_torch_multiprocess_engine as t
    from gossipy_tpu_torch import parallel
    rank, port, workdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    backend = parallel.init_distributed(
        f"localhost:{{port}}", 2, rank, device="cpu",
        timeout=datetime.timedelta(seconds=90))
    try:
        mesh = parallel.make_mesh(devices=parallel.devices("cpu"))
        out = t.run_legs(mesh, workdir)
        out["backend"] = backend
        out["repr"] = repr(mesh)
        torch.save(out, f"{{workdir}}/rank{{rank}}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
""")


# -- the configurations, in both the ranks and the parent -----------------------

def dataset_arrays(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=FEAT)
    X = rng.normal(size=(N * 48, FEAT)).astype(np.float32)
    return X, (X @ w > 0).astype(np.int64)


def dataset(seed=0):
    X, y = dataset_arrays(seed)
    dh = ClassificationDataHandler(X, y, test_size=0.2, seed=42)
    return DataDispatcher(dh, n=N, eval_on_user=False).stacked()


def northstar(mesh, adjacency=None, rounds=ROUNDS, cls=GossipSimulator,
              **kw):
    """The north star's shape at N = 16: ``(sim, state)`` on ``mesh``
    (the state placed), draws from ``TorchDraws(7)``, weights from a
    generator seeded 0; ``cls`` the simulator class."""
    handler = SGDHandler(LogisticRegression(FEAT, 2), losses.cross_entropy,
                         learning_rate=0.1, local_epochs=1, batch_size=32,
                         n_classes=2, input_shape=(FEAT,),
                         create_model_mode=tcore.CreateModelMode.MERGE_UPDATE)
    topo = (tcore.Topology.random_regular(N, 4, seed=0) if adjacency is None
            else tcore.Topology(adjacency))
    kw = {"delta": 100, "protocol": tcore.AntiEntropyProtocol.PUSH, **kw}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sim = cls(handler, topo, parallel.shard_data(dataset(), mesh),
                  fused_merge="multi", mesh=mesh, draws=TorchDraws(7),
                  device="cpu", **kw)
    state = parallel.shard_state(
        sim.init_nodes(torch.Generator().manual_seed(0)), mesh)
    return sim, state


NETWORK = dict(protocol=tcore.AntiEntropyProtocol.PUSH_PULL, sync=False,
               delta=20, delay=tcore.UniformDelay(0, 30), drop_prob=0.1,
               online_prob=0.8, sampling_eval=0.5, history_dtype="int8",
               mailbox_slots=6)


def one_sided():
    """Every node's only peers are nodes 0-7 (rank 0's rows)."""
    adj = np.zeros((N, N), dtype=bool)
    adj[:, : N // 2] = True
    np.fill_diagonal(adj, False)
    return adj


class Quota(GossipSimulator):
    """A user's subclass that keeps the base receive path: a node earns a
    send credit each round, up to its cap ``1 + id % 3``, and sends only
    while it holds two, which a send costs; before the snapshot every
    param decays by a factor 0.999. ``_init_aux`` builds this rank's rows
    (``self._own``); the other hooks see the whole population."""

    def _init_aux(self, model):
        ids = torch.arange(self.n_nodes, device=model.params.device)
        cap = self._own(1 + ids % 3).to(torch.int32)
        return {"credit": torch.zeros_like(cap), "cap": cap}

    def _pre_send(self, state, r):
        credit = state.aux["credit"]
        credit.add_(1)                                   # in place
        torch.minimum(credit, state.aux["cap"], out=credit)
        m = state.model
        state.model = ModelState(m.params * 0.999, m.opt_state,
                                 m.n_updates)            # replaced

    def _send_gate(self, state, active, peers, r, f):
        send = active & (state.aux["credit"] >= 2)
        state.aux["credit"] = state.aux["credit"] - 2 * send.to(torch.int32)
        return send


class JQuota(jsimulation.GossipSimulator):
    """:class:`Quota` in the JAX engine."""

    def _init_aux(self, model, key):
        cap = (1 + jax.numpy.arange(self.n_nodes) % 3).astype("int32")
        return {"credit": jax.numpy.zeros_like(cap), "cap": cap}

    def _pre_send(self, state, base_key, r):
        aux = dict(state.aux)
        aux["credit"] = jax.numpy.minimum(aux["credit"] + 1, aux["cap"])
        model = state.model._replace(params=jax.tree.map(
            lambda p: p * 0.999, state.model.params))
        return state._replace(model=model, aux=aux)

    def _send_gate(self, state, active, peers, base_key, r):
        send = active & (state.aux["credit"] >= 2)
        aux = dict(state.aux)
        aux["credit"] = aux["credit"] - 2 * send.astype("int32")
        return send, state._replace(aux=aux)


def variant_sim(mesh):
    """:class:`Quota` on the north star's shape (``northstar``'s
    configuration): ``(sim, state)``."""
    return northstar(mesh, cls=Quota)


def variant_oracle_sim(mesh):
    """:class:`Quota` on the oracle leg's configuration."""
    return oracle_sim(mesh, cls=Quota)


def attention_inputs():
    rng = np.random.default_rng(5)
    return tuple(torch.from_numpy(rng.normal(size=(ATTN_S, ATTN_D)).astype(
        np.float32)) for _ in range(3))


def oracle_sim(mesh, cls=GossipSimulator):
    """The JAX pair's port side (``torch_pairs.logreg``, 16 nodes of
    ``small_data``, ``random_regular(16, 4)``) under the oracle; ``cls``
    the simulator class."""
    from torch_oracle import JaxDraws
    from torch_pairs import logreg, small_data
    _, th = logreg()
    key = jax.random.PRNGKey(3)
    topo = tcore.Topology.random_regular(N, 4, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls(
            th, topo, parallel.shard_data(small_data(n=N), mesh), delta=100,
            fused_merge="multi", mailbox_slots=4, mesh=mesh,
            draws=JaxDraws(key, init_key=key), device="cpu")


def telemetry_kw():
    """Probes, sentinels and chaos: an outage of rank 0's every node
    (rounds 2-4: rank 0's receivers get nothing while rank 1's do), and
    from round 5 a partition into even and odd nodes (each component on
    both ranks)."""
    from gossipy_tpu_torch.simulation import ChaosConfig, OutageEpisode, \
        PartitionEpisode
    return dict(probes=True, sentinels=True, chaos=ChaosConfig(
        outages=(OutageEpisode(nodes=tuple(range(N // 2)), start=2,
                               stop=5),),
        partitions=(PartitionEpisode(components=(
            tuple(range(0, N, 2)), tuple(range(1, N, 2))), start=5,
            stop=8),), horizon=TELEMETRY_ROUNDS))


def telemetry_sim(mesh):
    """The oracle leg's configuration with every round telemetry on."""
    from torch_oracle import JaxDraws
    from torch_pairs import logreg, small_data
    _, th = logreg()
    key = jax.random.PRNGKey(3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return GossipSimulator(
            th, tcore.Topology.random_regular(N, 4, seed=0),
            parallel.shard_data(small_data(n=N), mesh), delta=100,
            fused_merge="multi", mailbox_slots=4, mesh=mesh,
            draws=JaxDraws(key, init_key=key), device="cpu",
            **telemetry_kw())


def a2a_topology(form):
    """``random_regular(16, 4)``, dense, or as a CSR ``SparseTopology``
    for the sparse (segment) mix."""
    from gossipy_tpu_torch.simulation import faults
    topo = tcore.Topology.random_regular(N, 4, seed=0)
    if form != "sparse":
        return topo
    pairs = np.stack(faults._undirected_pairs(topo), axis=1)
    return tcore.SparseTopology(N, pairs)


def a2a_sim(mesh, form):
    """All2All with uniform mixing over ``random_regular(16, 4)`` on its
    ``form`` (``ring``, ``dense`` or ``sparse``), probes and sentinels
    on, under the oracle."""
    from torch_oracle import JaxDraws
    from torch_pairs import logreg, small_data
    _, th = logreg()
    key = jax.random.PRNGKey(4)
    topo = a2a_topology(form)
    return All2AllGossipSimulator(
        th, topo, parallel.shard_data(small_data(n=N), mesh), delta=100,
        mixing=tcore.uniform_mixing(topo), mesh=mesh,
        ring_mix=form == "ring", probes=True, sentinels=True,
        draws=JaxDraws(key, init_key=key), device="cpu")


def oracle_legs(mesh, init) -> dict:
    """The telemetry and All2All legs on ``mesh`` from the oracle leg's
    initial state: each one's rows, whole state, report and live rows."""
    from gossipy_tpu_torch.simulation import CallbackReceiver
    out = {}
    for leg, rounds in (("telemetry", TELEMETRY_ROUNDS),
                        ("a2a-ring", A2A_ROUNDS), ("a2a-dense", A2A_ROUNDS),
                        ("a2a-sparse", A2A_ROUNDS)):
        sim = telemetry_sim(mesh) if leg == "telemetry" else \
            a2a_sim(mesh, leg[4:])
        rows = []
        if leg == "telemetry":
            sim.add_receiver(CallbackReceiver(rows.append, live=True))
        state = parallel.shard_state(sim.init_state(*init), mesh)
        state, rep = run(sim, state, rounds)
        out[leg] = dict(leaves=leaves(state), report=rep.to_dict(), run=rep,
                        whole=gathered(state, mesh), live=rows)
    return out


def run(sim, state, rounds):
    state, rep = sim.start(state, n_rounds=rounds)
    return state, rep


def leaves(state) -> dict:
    return {p: x.clone() for p, x in rules.named_leaves(state)
            if isinstance(x, torch.Tensor)}


def gathered(state, mesh) -> dict:
    """The whole state on this rank, by the gather functions."""
    _, gather = parallel.make_shard_and_gather_fns(state, mesh)
    fns = dict(rules.named_leaves(gather))
    return {p: fns[p](x) for p, x in rules.named_leaves(state)
            if isinstance(x, torch.Tensor)}


class ReceiveHook(GossipSimulator):
    """A subclass that overrides a receive hook the multi deliver
    replaces: refused on every mesh, as in the JAX package."""

    def _post_receive_slot(self, state, valid, ty, sender, send_round,
                           extra, r, k):
        pass


class A2AVariant(All2AllGossipSimulator):
    """A user's subclass of All2All: it runs across ranks as its base
    does."""


def logreg_handler():
    return SGDHandler(LogisticRegression(FEAT, 2), losses.cross_entropy,
                      input_shape=(FEAT,))


def cohort_sim(mesh, **cohort):
    """A small cohort simulator on ``mesh``: nominal 64 nodes, C = 8."""
    from gossipy_tpu_torch.simulation import CohortConfig
    return GossipSimulator(
        logreg_handler(), tcore.Topology.clique(4 * N), dataset(),
        fused_merge="multi", cohort=CohortConfig(size=8, **cohort),
        mesh=mesh, draws=TorchDraws(7), device="cpu")


# What a mesh across ranks still refuses: (exception, what its message
# names).
REFUSED = {
    "receive hook": ("ValueError", "_post_receive_slot is overridden"),
    "tokenized": ("ValueError", "is overridden by TokenizedGossip"),
    "one process on two devices": ("NotImplementedError",
                                   "positions of one process on several"),
}


def refusals(mesh, workdir) -> dict:
    """Every use a mesh across ranks still refuses: its exception and
    message."""
    from gossipy_tpu_torch.flow_control import SimpleTokenAccount
    from gossipy_tpu_torch.simulation import TokenizedGossipSimulator

    def receive_hook():
        ReceiveHook(logreg_handler(), tcore.Topology.clique(N), dataset(),
                    fused_merge="multi", mesh=mesh, device="cpu")

    def tokenized():
        TokenizedGossipSimulator(
            logreg_handler(), tcore.Topology.clique(N), dataset(),
            fused_merge="multi", mesh=mesh, device="cpu",
            token_account=SimpleTokenAccount(C=1))

    def two_devices():
        me = torch.distributed.get_rank()
        GossipSimulator(
            logreg_handler(), tcore.Topology.clique(N), dataset(),
            fused_merge="multi", device="cpu", mesh=parallel.make_mesh(
                devices=[parallel.Position(torch.device("cpu"), me, 0),
                         parallel.Position(torch.device("cuda", 1), me,
                                           1)]))

    return outcomes(dict(zip(REFUSED, (receive_hook, tokenized,
                                       two_devices))))


def outcomes(cases: dict) -> dict:
    """Each case's result, or its exception and message."""
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = f"ok: {fn()}"
        except Exception as e:     # every outcome is reported, not raised
            out[name] = f"{type(e).__name__}: {e}"
    return out


LIFTED = ("checkpoint save", "checkpoint load", "restore_checkpoint(mesh=)",
          "perf", "metrics", "ledger", "tracing", "variant",
          "all2all variant", "cohort start(mesh=)", "service", "disk pool")


def lifted(mesh, workdir) -> dict:
    """The uses the refusal list no longer holds, each on a round of the
    north star across the ranks: what each gave, or its exception."""
    from gossipy_tpu_torch import checkpoint
    from gossipy_tpu_torch.telemetry import RunLedger, Tracer
    path = f"{workdir}/lifted.pt"

    def one_round(**kw):
        sim, state = northstar(mesh, rounds=1, **kw)
        sim.start(state, n_rounds=1)
        return sim

    def same_rows(state):
        _, want = northstar(mesh)
        got = dict(rules.named_leaves(state))
        return all(torch.equal(got[p], x)
                   for p, x in rules.named_leaves(want)
                   if isinstance(x, torch.Tensor))

    def save():
        sim, state = northstar(mesh)
        return sim.save(path, state) == path

    def load():
        state, _ = northstar(mesh)[0].load(path)
        return same_rows(state)

    def restore():
        sim, template = northstar(mesh)
        state, _ = checkpoint.restore_checkpoint(path, template, sim.draws,
                                                 mesh=mesh)
        return same_rows(state)

    def ledger():
        one_round(ledger=f"{workdir}/lifted.jsonl")
        torch.distributed.barrier()
        return len(RunLedger(f"{workdir}/lifted.jsonl").rows())

    def tracing():
        tracer = Tracer()
        one_round(tracing=tracer)
        return sum(e.get("name") == "engine.start"
                   for e in tracer.snapshot()["traceEvents"])

    def variant():
        sim, state = variant_sim(mesh)
        _, rep = sim.start(state, n_rounds=2)   # a credit of 2 at round 1
        return int(rep.sent_messages)

    def a2a_variant():
        topo = tcore.Topology.clique(N)
        sim = A2AVariant(logreg_handler(), topo, dataset(),
                  mixing=tcore.uniform_mixing(topo), mesh=mesh,
                  device="cpu")
        _, rep = sim.start(sim.init_nodes(), n_rounds=1)
        return int(rep.sent_messages)

    def cohort():
        sim = cohort_sim(mesh)
        _, rep = sim.start(sim.init_cohort_pool(), n_rounds=1, mesh=mesh)
        return int(rep.sent_messages)

    def disk_pool():
        sim = cohort_sim(mesh, pool_dir=f"{workdir}/pool")
        _, rep = sim.start(sim.init_cohort_pool(), n_rounds=1, mesh=mesh)
        return int(rep.sent_messages)

    def service():
        from gossipy_tpu_torch.config import ExperimentConfig
        from gossipy_tpu_torch.service import GossipService, RunRequest
        from gossipy_tpu_torch.telemetry.metrics import MetricsRegistry
        svc = GossipService(f"{workdir}/service", slice_rounds=1,
                            registry=MetricsRegistry(), mesh=mesh,
                            device="cpu")
        cfg = ExperimentConfig(n_nodes=N, model="logreg", handler="sgd",
                               topology="random_regular",
                               topology_params={"degree": 4}, delta=20,
                               n_rounds=1, batch_size=8)
        X, y = dataset_arrays()
        summary = svc.run([RunRequest("t", cfg, data=(X, y))])
        return summary["tenants"][0]["status"]

    return outcomes(dict(zip(LIFTED, (
        save, load, restore,
        lambda: one_round(perf=True).perf_summary()["last_run"]["rounds"],
        lambda: one_round(metrics=True).metrics_enabled,
        ledger, tracing, variant, a2a_variant, cohort, service,
        disk_pool))))


def run_legs(mesh, workdir) -> dict:
    """Every leg on this rank: what it holds after each."""
    out = {}
    sim, state = northstar(mesh)
    state, rep = run(sim, state, ROUNDS)
    out["northstar"] = dict(leaves=leaves(state), report=rep.to_dict(),
                            whole=gathered(state, mesh),
                            budget=sim.memory_budget())
    sim, state = northstar(mesh, **NETWORK)
    state, rep = run(sim, state, 8)
    out["network"] = dict(leaves=leaves(state), report=rep.to_dict())
    sim, state = northstar(mesh, adjacency=one_sided())
    state, rep = run(sim, state, 3)
    out["nohang"] = dict(leaves=leaves(state), report=rep.to_dict())
    sim, state = variant_sim(mesh)
    state, rep = run(sim, state, ROUNDS)
    out["variant"] = dict(leaves=leaves(state), report=rep.to_dict())
    sim = variant_oracle_sim(mesh)
    vinit = torch.load(f"{workdir}/variant_init.pt", weights_only=False)
    state, rep = run(sim, parallel.shard_state(sim.init_state(*vinit), mesh),
                     ORACLE_ROUNDS)
    out["variant-oracle"] = dict(whole=gathered(state, mesh), report=rep)
    init = torch.load(f"{workdir}/oracle_init.pt", weights_only=False)
    sim = oracle_sim(mesh)
    state = parallel.shard_state(sim.init_state(*init), mesh)
    state, rep = run(sim, state, ORACLE_ROUNDS)
    out["oracle"] = dict(whole=gathered(state, mesh), report=rep)
    out.update(oracle_legs(mesh, init))
    from gossipy_tpu_torch.parallel.collectives import TRANSFERS, \
        ring_attention
    q, k, v = attention_inputs()
    rows = mesh.node_rows(ATTN_S)
    out["ring"] = {f"flash={flash}": ring_attention(
        q[rows], k[rows], v[rows], mesh, causal=True, flash=flash)
        for flash in (True, False)}
    out["transfers"] = dict(TRANSFERS)
    out["refusals"] = refusals(mesh, workdir)
    out["lifted"] = lifted(mesh, workdir)
    return out


# -- the parent -----------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(workdir: Path) -> list:
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]), OMP_NUM_THREADS="1")
    script = WORKER.format(tests=str(REPO / "tests"))
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(port), str(workdir)],
        cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]


def reap(procs, timeout) -> list:
    """Every rank's (stdout, stderr), drained together (a full pipe on one
    rank must not stall the other mid-collective); a rank still running
    at the limit is killed."""
    outs = [("", "")] * len(procs)

    def drain(i):
        outs[i] = procs[i].communicate()

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in threads:
        t.join(timeout=5)
    return outs


def virtual():
    return parallel.make_mesh(2, devices=["cpu"] * 2)


def rank_rows(x: torch.Tensor, path: str, rank: int) -> torch.Tensor:
    """Rank ``rank``'s rows of a whole leaf of the virtual mesh's state."""
    dim = 1 if path.startswith(("history", "mailbox", "reply_box")) else 0
    half = x.shape[dim] // 2
    return x.narrow(dim, rank * half, half)


def jax_legs(jmesh) -> dict:
    """The telemetry and All2All legs in the JAX engine on ``jmesh``:
    ``{leg: (simulator, run key, rounds)}``."""
    from torch_pairs import jax_kw, jax_topology, logreg, small_data
    jh, _ = logreg()
    jtopo = jcore.Topology(tcore.Topology.random_regular(N, 4,
                                                         seed=0).adjacency)
    data = jparallel.shard_data(small_data(n=N), jmesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = {"telemetry": (jsimulation.GossipSimulator(
            jh, jtopo, data, delta=100, fused_merge="multi",
            mailbox_slots=4, mesh=jmesh, **jax_kw(telemetry_kw())),
            jax.random.PRNGKey(3), TELEMETRY_ROUNDS)}
        for form in ("ring", "dense", "sparse"):
            topo = jax_topology(a2a_topology(form))
            out[f"a2a-{form}"] = (jsimulation.All2AllGossipSimulator(
                jh, topo, data, delta=100,
                mixing=jcore.uniform_mixing(topo), mesh=jmesh,
                ring_mix=form == "ring", probes=True, sentinels=True),
                jax.random.PRNGKey(4), A2A_ROUNDS)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks, run the parent's references while they run,
    and return ``(rank outputs, references)``."""
    from torch_pairs import logreg, small_data, to_port_state
    workdir = tmp_path_factory.mktemp("ranks")
    jh, th = logreg()
    key = jax.random.PRNGKey(3)
    adj = tcore.Topology.random_regular(N, 4, seed=0).adjacency
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmesh = jparallel.make_mesh(2)
        jsim = jsimulation.GossipSimulator(
            jh, jcore.Topology(adj), jparallel.shard_data(small_data(n=N),
                                                          jmesh),
            delta=100, fused_merge="multi", mailbox_slots=4, mesh=jmesh)
    jst0 = jsim.init_nodes(key, common_init=True)
    tsim = oracle_sim(virtual())
    st0 = to_port_state(tsim, jst0)
    torch.save((st0.model, st0.phase), workdir / "oracle_init.pt")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jvsim = JQuota(jh, jcore.Topology(adj),
                       jparallel.shard_data(small_data(n=N), jmesh),
                       delta=100, fused_merge="multi", mailbox_slots=4,
                       mesh=jmesh)
    jvst0 = jvsim.init_nodes(key, common_init=True)
    tvsim = variant_oracle_sim(virtual())
    vst0 = to_port_state(tvsim, jvst0)
    torch.save((vst0.model, vst0.phase), workdir / "variant_init.pt")
    procs = spawn(workdir)
    try:
        refs = {}
        for leg, kw, rounds in (("northstar", {}, ROUNDS),
                                ("network", NETWORK, 8),
                                ("nohang", {"adjacency": one_sided()}, 3),
                                ("variant", {"cls": Quota}, ROUNDS)):
            sim, state = northstar(virtual(), **kw)
            state, rep = run(sim, state, rounds)
            refs[leg] = (leaves(state), rep.to_dict(), sim)
        jvst, jvrep = jvsim.start(jparallel.shard_state(jvst0, jmesh),
                                  n_rounds=ORACLE_ROUNDS, key=key,
                                  donate_state=False)
        refs["variant-jax"] = (jvsim, tvsim, vst0, jvst, jvrep)
        jst, jrep = jsim.start(jparallel.shard_state(jst0, jmesh),
                               n_rounds=ORACLE_ROUNDS, key=key,
                               donate_state=False)
        refs["jax"] = (jsim, tsim, st0, jst, jrep)
        virt = oracle_legs(virtual(), (st0.model, st0.phase))
        for leg, (jleg, run_key, rounds) in jax_legs(jmesh).items():
            want = virt[leg]
            refs[leg] = (want["leaves"], want["report"], None)
            refs[f"{leg}-live"] = want["live"]
            tleg = telemetry_sim(virtual()) if leg == "telemetry" else \
                a2a_sim(virtual(), leg[4:])
            jst, jrep = jleg.start(
                jparallel.shard_state(jleg.init_nodes(key, common_init=True),
                                      jmesh),
                n_rounds=rounds, key=run_key, donate_state=False)
            refs[f"{leg}-jax"] = (jleg, tleg, tleg.init_state(
                st0.model, st0.phase), jst, jrep)
    finally:
        outs = reap(procs, TIMEOUT_S)
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
    got = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
           for r in (0, 1)]
    return got, refs


@pytest.mark.parametrize("leg", ["northstar", "network", "nohang",
                                 "telemetry", "a2a-ring", "a2a-dense",
                                 "a2a-sparse", "variant"])
def test_ranks_equal_the_virtual_mesh_run(ranks, leg):
    """Both ranks report the whole population's run, equal to each other
    and to the one-process run on a 2-position virtual mesh; each rank
    holds its rows of every leaf, bit-equal to the same rows there."""
    got, refs = ranks
    want_leaves, want_report, _ = refs[leg]
    for rank in (0, 1):
        mine = got[rank][leg]
        assert json.dumps(mine["report"], sort_keys=True) == \
            json.dumps(want_report, sort_keys=True), rank
        assert sorted(mine["leaves"]) == sorted(want_leaves)
        for path, x in want_leaves.items():
            torch.testing.assert_close(mine["leaves"][path],
                                       rank_rows(x, path, rank), rtol=0,
                                       atol=0, msg=f"{leg} {path} r{rank}")
    rep = got[0][leg]["report"]
    assert sum(rep["sent_per_round"]) > 0
    if leg == "network":
        causes = rep["failed_per_cause"]
        assert sum(causes["offline"]) > 0 and sum(causes["drop"]) > 0
    if leg == "telemetry":
        assert sum(rep["failed_per_cause"]["chaos"]) > 0
        assert max(rep["chaos_active_components"]) == 2
    if leg == "variant":
        # The nodes of cap 1 never hold two credits: a third of the
        # population never sends.
        assert max(rep["sent_per_round"]) < N


@pytest.mark.parametrize("leg", ["telemetry", "a2a-ring", "a2a-dense",
                                 "a2a-sparse"])
def test_telemetry_legs_match_the_jax_mesh_run(ranks, leg):
    """Under the JAX draw oracle, each rank's run of the telemetry and
    All2All legs against the JAX engine on a 2-device mesh: accounting
    exact, params and metrics within 1e-5, every probe, health and chaos
    array within ``torch_pairs.assert_same_telemetry``'s tolerance."""
    from torch_pairs import assert_same_run, assert_same_telemetry
    got, refs = ranks
    jsim, tsim, st0, jst, jrep = refs[f"{leg}-jax"]
    for rank in (0, 1):
        mine = got[rank][leg]
        whole = mine["whole"]
        tst = rules.tree_map_with_path(
            lambda p, x: torch.as_tensor(whole[p])
            if isinstance(x, torch.Tensor) else x, st0)
        tst.round = jst.round
        assert_same_run(jsim, tsim, jst, tst, jrep, mine["run"])
        seen = assert_same_telemetry(jrep, mine["run"])
        assert "probe_consensus_mean" in seen and "health_trip" in seen


def test_live_rows_across_ranks(ranks):
    """A live receiver on each rank sees every round as it ends, with the
    whole population's counts (the receiver counts summed over the ranks
    each round) and payloads: each rank's rows equal the virtual mesh
    run's, and an outage of every node of rank 0 did not hang."""
    got, refs = ranks
    want = refs["telemetry-live"]
    assert len(want) == TELEMETRY_ROUNDS
    assert sum(row["failed_by_cause"]["chaos"] for row in want) > 0
    assert all("probes" in row and "health" in row and "chaos" in row
               for row in want)
    for rank in (0, 1):
        assert json.dumps(got[rank]["telemetry"]["live"], sort_keys=True,
                          default=float) == json.dumps(
            want, sort_keys=True, default=float), rank


def test_gather_brings_back_the_whole_state(ranks):
    """``make_shard_and_gather_fns``' gathers on a mesh across ranks give
    every rank the whole leaf; ``memory_budget`` counts a rank's share."""
    got, refs = ranks
    want_leaves, _, sim = refs["northstar"]
    for rank in (0, 1):
        whole = got[rank]["northstar"]["whole"]
        for path, x in want_leaves.items():
            np.testing.assert_array_equal(whole[path], x.numpy(), path)
        budget = got[rank]["northstar"]["budget"]
        full = sim.memory_budget()
        assert budget["mailbox_bytes"] * 2 == full["mailbox_bytes"]
        assert budget["model_and_opt_bytes"] * 2 == \
            full["model_and_opt_bytes"]


def test_ranks_match_the_jax_mesh_run(ranks):
    """Under the JAX draw oracle, the 2-rank run against the JAX engine on
    a 2-device mesh from the same ``init_nodes`` state: accounting exact,
    boxes and ages equal, params within 1e-5, metrics within 1e-5."""
    from torch_pairs import assert_same_run
    got, refs = ranks
    jsim, tsim, st0, jst, jrep = refs["jax"]
    assert jrep.sent_messages > 0
    for rank in (0, 1):
        whole = got[rank]["oracle"]["whole"]
        tst = rules.tree_map_with_path(
            lambda p, x: torch.as_tensor(whole[p])
            if isinstance(x, torch.Tensor) else x, st0)
        tst.round = ORACLE_ROUNDS
        assert_same_run(jsim, tsim, jst, tst, jrep,
                        got[rank]["oracle"]["report"])


def test_variant_matches_the_jax_mesh_run(ranks):
    """Under the JAX draw oracle, a user's subclass across the ranks
    (``Quota``: its hooks see the whole population, ``_init_aux`` this
    rank's rows) against its JAX twin on a 2-device mesh from the same
    ``init_nodes`` state: accounting exact, params and metrics within
    1e-5, ``aux`` exactly."""
    from torch_pairs import assert_same_aux, assert_same_run
    got, refs = ranks
    jsim, tsim, st0, jst, jrep = refs["variant-jax"]
    assert jrep.sent_messages > 0
    for rank in (0, 1):
        whole = got[rank]["variant-oracle"]["whole"]
        tst = rules.tree_map_with_path(
            lambda p, x: torch.as_tensor(whole[p])
            if isinstance(x, torch.Tensor) else x, st0)
        tst.round = ORACLE_ROUNDS
        assert_same_run(jsim, tsim, jst, tst, jrep,
                        got[rank]["variant-oracle"]["report"])
        assert_same_aux(tsim, jst, tst)


def test_ring_attention_across_ranks(ranks):
    """``ring_attention`` across the ranks (causal, S = 32, D = 8): each
    rank's query rows equal the one-process ring's (K5's plain version
    and the plain hop), and the JAX package's ring within 1e-6."""
    from gossipy_tpu_torch.parallel.collectives import ring_attention
    got, _ = ranks
    q, k, v = attention_inputs()
    jmesh = jparallel.make_mesh(2)
    want_jax = np.asarray(jring_attention(*(jax.numpy.asarray(t.numpy())
                                            for t in (q, k, v)), jmesh,
                                          causal=True))
    for flash in (True, False):
        want = ring_attention(q, k, v, virtual(), causal=True, flash=flash)
        mine = torch.cat([got[r]["ring"][f"flash={flash}"] for r in (0, 1)])
        torch.testing.assert_close(mine, want, rtol=0, atol=0)
        np.testing.assert_allclose(mine.numpy(), want_jax, rtol=0, atol=1e-6)


def test_transport_and_hop_bytes(ranks):
    """Both ranks chose gloo (ranks on the CPU), the mesh records it, and
    the ring's hops crossed the process boundary."""
    got, _ = ranks
    for rank in (0, 1):
        assert got[rank]["backend"] == "gloo"
        assert "transport='gloo'" in got[rank]["repr"]
        moved = got[rank]["transfers"]
        assert moved["ring_hops"] > 0 and moved["ring_bytes"] > 0
        assert moved["gathers"] > 0 and moved["reduces"] > 0
        assert moved.get("staged_bytes", 0) == 0    # host tensors


@pytest.mark.parametrize("name", list(REFUSED))
def test_refusals_across_ranks(ranks, name):
    """What a mesh across ranks still refuses raises, naming why: a
    subclass that overrides a receive hook the multi deliver replaces
    (the package's token variant among them; every mesh refuses it, as
    the JAX package does) with ``ValueError``; one process's positions
    on two devices with ``NotImplementedError`` naming the entry of
    ROADMAP.md queue 1 item 13 it waits for."""
    kind, what = REFUSED[name]
    got, _ = ranks
    for rank in (0, 1):
        refused = got[rank]["refusals"][name]
        assert refused.startswith(kind), (name, refused)
        assert what in refused, (name, refused)


@pytest.mark.parametrize("name", LIFTED)
def test_lifted_refusals_run_across_ranks(ranks, name):
    """What the refusal list held before now runs on a mesh across ranks:
    a checkpoint saved by both ranks loads back (``load`` and
    ``restore_checkpoint(mesh=)``) into each rank's own rows, a round
    runs with each host option (the ledger then holds one row a rank, the
    tracer its span), a user's subclass of the engine and of All2All
    sends, a cohort's ``start(mesh=)`` runs a round, with its pool in RAM
    and on disk, and the service serves a tenant to the end."""
    want = {"checkpoint save": "ok: True", "checkpoint load": "ok: True",
            "restore_checkpoint(mesh=)": "ok: True", "perf": "ok: 1",
            "metrics": "ok: True", "ledger": "ok: 2", "tracing": "ok: 1",
            "service": "ok: done"}
    got, _ = ranks
    for rank in (0, 1):
        seen = got[rank]["lifted"][name]
        if name in want:
            assert seen == want[name], (rank, seen)
        else:
            assert seen.startswith("ok: ") and int(seen[4:]) > 0, \
                (rank, seen)
    assert got[0]["lifted"][name] == got[1]["lifted"][name]


def test_init_distributed_runs_on_the_card_unless_the_cpu_is_named(
        monkeypatch):
    """Without ``device=`` a rank joins on the card, as every entry point
    runs: with no card visible it raises before it forms a group, and
    never falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.init_distributed(f"localhost:{free_port()}", 1, 0)
    assert not torch.distributed.is_initialized()


def test_choose_transport():
    """NCCL only when every rank has a card of its own."""
    assert parallel.choose_transport(["cuda-a", "cuda-b"]) == "nccl"
    assert parallel.choose_transport(["cuda-a", "cuda-a"]) == "gloo"
    assert parallel.choose_transport(["cpu", "cpu"]) == "gloo"
    assert parallel.choose_transport(["cuda-a", "cpu"]) == "gloo"


def test_build_is_safe_across_processes(tmp_path, monkeypatch):
    """Two builds of one source at once: one compiles, the other waits
    on the source's lock and finds the library whole."""
    import time

    from gossipy_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        open({str(calls)!r}, "a").write("x")
        time.sleep(0.5)
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "w").write("library")
        """))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(
        _build.build(["k"])["k"])) for _ in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert time.perf_counter() - t0 < 30
    assert len(paths) == 2 and paths[0] == paths[1]
    assert paths[0].read_text() == "library"
    assert calls.read_text() == "x"
