"""The port's partition-rule registry (``gossipy_tpu_torch/parallel/
rules.py``): coverage and derivation, against the JAX package's.

Each test of ``tests/test_rules.py`` has a counterpart here; its AST check
of hand-placed specs becomes the same check over the port's
``parallel/`` (no ``PartitionSpec(...)`` built outside ``rules.py``). The
cross-package tests hold the rule table to the JAX one row for row, and
each state field's ``describe()`` strings and node-axis positions of a
resolved port ``SimState`` (PENS's aux, the int8 sidecars,
``batch_dims=1``) to the JAX ones. The port keeps a node's parameters in
one flat ``[N, stride]`` row where the JAX state has a leaf per layer, so
the fields are compared, not the leaves.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gossipy_tpu import parallel as jparallel
from gossipy_tpu.core import AntiEntropyProtocol, CreateModelMode, Topology
from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.handlers import SGDHandler, losses
from gossipy_tpu.models import MLP
from gossipy_tpu.parallel import rules as jrules
from gossipy_tpu.simulation import GossipSimulator, PENSGossipSimulator
from gossipy_tpu_torch import core as tcore
from gossipy_tpu_torch import parallel
from gossipy_tpu_torch.handlers import SGDHandler as TSGDHandler
from gossipy_tpu_torch.handlers import losses as tlosses
from gossipy_tpu_torch.models import MLP as TMLP
from gossipy_tpu_torch.parallel import (
    STATE_RULES,
    UnmatchedLeafError,
    make_mesh,
    make_shard_and_gather_fns,
    match_partition_rules,
    partition_specs,
    shard_data,
    sharding_of,
    state_shardings,
)
from gossipy_tpu_torch.parallel.rules import (
    named_leaves,
    resolved_rules_table,
    rules_table,
    tree_map_with_path,
)
from gossipy_tpu_torch.random import TorchDraws
from gossipy_tpu_torch.simulation import GossipSimulator as TGossipSimulator
from gossipy_tpu_torch.simulation import PENSGossipSimulator as TPENS

REPO = Path(__file__).resolve().parents[1]
N, D = 16, 6


def dataset():
    rng = np.random.default_rng(0)
    w = rng.normal(size=D)
    X = rng.normal(size=(N * 12, D)).astype(np.float32)
    y = (X @ w > 0).astype(np.int64)
    return DataDispatcher(ClassificationDataHandler(X, y, test_size=0.25),
                          n=N).stacked()


def tbuild(history_dtype="float32", pens=False):
    mode = tcore.CreateModelMode.MERGE_UPDATE if pens else \
        tcore.CreateModelMode.UPDATE_MERGE
    handler = TSGDHandler(TMLP(D, 2, hidden_dims=(8,)), tlosses.cross_entropy,
                          learning_rate=0.2, local_epochs=1, batch_size=4,
                          n_classes=2, input_shape=(D,),
                          create_model_mode=mode)
    if pens:
        return TPENS(handler, tcore.Topology.clique(N), dataset(), delta=10,
                     n_sampled=4, m_top=2, step1_rounds=3,
                     draws=TorchDraws(0), device="cpu")
    return TGossipSimulator(handler, tcore.Topology.clique(N), dataset(),
                            delta=10, protocol=tcore.AntiEntropyProtocol.PUSH,
                            history_dtype=history_dtype, draws=TorchDraws(0),
                            device="cpu")


def jbuild(history_dtype="float32", pens=False):
    mode = CreateModelMode.MERGE_UPDATE if pens else \
        CreateModelMode.UPDATE_MERGE
    handler = SGDHandler(model=MLP(D, 2, hidden_dims=(8,)),
                         loss=losses.cross_entropy, optimizer=optax.sgd(0.2),
                         local_epochs=1, batch_size=4, n_classes=2,
                         input_shape=(D,), create_model_mode=mode)
    if pens:
        return PENSGossipSimulator(handler, Topology.clique(N), dataset(),
                                   delta=10, n_sampled=4, m_top=2,
                                   step1_rounds=3)
    return GossipSimulator(handler, Topology.clique(N), dataset(), delta=10,
                           protocol=AntiEntropyProtocol.PUSH,
                           history_dtype=history_dtype)


def tstate(**kw):
    return tbuild(**kw).init_nodes(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=["cpu"] * 8)


# -- counterparts of tests/test_rules.py ---------------------------------------

class TestCoverage:
    def test_every_state_leaf_matches_a_rule(self):
        st = tstate()
        specs = match_partition_rules(STATE_RULES, st)
        assert [p for p, _ in named_leaves(specs)] == \
            [p for p, _ in named_leaves(st)]

    def test_int8_sidecar_and_aux_leaves_covered(self):
        table = dict(resolved_rules_table(tstate(history_dtype="int8")))
        scale_rows = [p for p in table if p.startswith("history_scale")]
        assert scale_rows and all(table[p] == "node_axis@1"
                                  for p in scale_rows)
        table_p = dict(resolved_rules_table(tstate(pens=True)))
        aux_rows = [p for p in table_p if p.startswith("aux/")]
        assert aux_rows and all(table_p[p] == "node_axis@0"
                                for p in aux_rows)

    def test_unmatched_leaf_raises(self):
        tree = {"model": {"params": {"w": torch.zeros((4, 2))}},
                "mystery_field": torch.zeros((4,))}
        with pytest.raises(UnmatchedLeafError, match="mystery_field"):
            match_partition_rules(STATE_RULES, tree)

    def test_state_shardings_fails_on_unknown_state_leaf(self, mesh):
        with pytest.raises(UnmatchedLeafError):
            partition_specs({"new_sidecar": torch.zeros((4, 4))}, mesh)


class TestDerivation:
    def test_state_shardings_equal_rule_resolution(self, mesh):
        sh = state_shardings(tstate(), mesh)
        assert sh.model.params.spec[0] == "nodes"
        assert sh.mailbox.sender.spec[1] == "nodes"
        assert sh.history_ages.spec[1] == "nodes"
        assert sh.round.spec == ()
        assert sh.phase.spec[0] == "nodes"

    def test_batch_dims_shift(self, mesh):
        """A leading lane axis stays replicated; the node axis moves one
        right (the service's placement)."""
        st = tstate()
        batched = tree_map_with_path(
            lambda _, x: (x[None].expand((3,) + tuple(x.shape))
                          if isinstance(x, torch.Tensor) else x), st)
        sh = state_shardings(batched, mesh, batch_dims=1)
        assert sh.model.params.spec[0] is None
        assert sh.model.params.spec[1] == "nodes"
        assert sh.mailbox.sender.spec[2] == "nodes"

    def test_shard_and_gather_fns_roundtrip(self, mesh):
        st = tstate()
        shard_fns, gather_fns = make_shard_and_gather_fns(st, mesh)
        fns = dict(named_leaves(shard_fns))
        gfns = dict(named_leaves(gather_fns))
        leaves = dict(named_leaves(st))
        placed = {p: fns[p](x) for p, x in leaves.items()}
        assert sharding_of(placed["model/params"]).positions == 8
        assert sharding_of(placed["model/params"]).device_set == \
            {torch.device("cpu")}
        for p, x in leaves.items():
            back = gfns[p](placed[p])
            want = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            np.testing.assert_array_equal(back, want, err_msg=p)

    def test_rules_table_stamp_shape(self):
        table = rules_table()
        assert all(len(row) == 2 for row in table)
        pats = [p for p, _ in table]
        assert any("history_scale" in p for p in pats)
        assert any("mailbox" in p for p in pats)

    def test_data_rules(self, mesh):
        data = {"xtr": np.zeros((16, 3, 4), np.float32),
                "x_eval": np.zeros((40, 4), np.float32)}
        out = shard_data(data, mesh)
        assert sharding_of(out["xtr"]).spec[0] == "nodes"
        assert all(e is None for e in sharding_of(out["x_eval"]).spec)


class TestNoHandPlacedSpecs:
    def test_parallel_package_constructs_specs_only_in_rules(self):
        """No ``PartitionSpec(...)`` / ``P(...)`` call in the port's
        ``parallel/`` outside ``rules.py``."""
        import ast
        pkg = REPO / "gossipy_tpu_torch" / "parallel"
        files = sorted(pkg.glob("*.py"))
        assert {f.name for f in files} >= {"__init__.py", "rules.py",
                                           "collectives.py"}
        for f in files:
            if f.name == "rules.py":
                continue
            for node in ast.walk(ast.parse(f.read_text())):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = (fn.id if isinstance(fn, ast.Name)
                        else fn.attr if isinstance(fn, ast.Attribute)
                        else None)
                assert name not in ("P", "PartitionSpec"), \
                    f"hand-placed PartitionSpec at {f.name}:{node.lineno}"


class TestSchedulerMeshPlacement:
    def test_service_megabatch_places_via_registry(self, tmp_path):
        """GossipService(mesh=): each lane's state on the mesh with the
        rule-derived placement, the bucket's recorded with batch_dims=1,
        and the tenant finishes with a report."""
        from gossipy_tpu_torch.config import ExperimentConfig
        from gossipy_tpu_torch.service import GossipService, RunQueue, \
            RunRequest
        from gossipy_tpu_torch.telemetry.metrics import MetricsRegistry

        rng = np.random.default_rng(1)
        X = rng.normal(size=(240, 8)).astype(np.float32)
        y = (X @ rng.normal(size=8) > 0).astype(np.int64)
        cfg = ExperimentConfig(
            n_nodes=16, model="logreg", topology="random_regular",
            topology_params={"degree": 4}, n_rounds=4, delta=10,
            eval_every=4, seed=1, batch_size=8)
        svc = GossipService(out_dir=str(tmp_path), slice_rounds=2,
                            events_jsonl=False, mesh=make_mesh(
                                8, devices=["cpu"] * 8),
                            registry=MetricsRegistry(), device="cpu")
        q = RunQueue()
        h = q.submit(RunRequest("alice", cfg, data=(X, y)))
        session = svc.session(q)
        session.admit_pending()
        rt = session.runtimes[0]
        assert rt.placement.model.params.spec[:2] == (None, "nodes")
        assert rt.placement.model.params.positions == 8
        assert sharding_of(rt.states[0].model.params).spec[0] == "nodes"
        assert rt.data_placement["xtr"].spec[1] == "nodes"
        assert rt.sim.mesh is not None
        while session.poll():
            pass
        session.finish()
        assert h.status.value == "done"
        assert h.report is not None


# -- the JAX package's registry -------------------------------------------------

def test_rules_tables_equal_jax():
    assert rules_table() == jrules.rules_table()
    assert rules_table(parallel.DATA_RULES) == \
        jrules.rules_table(jrules.DATA_RULES)
    for name in ("NODE_AXIS", "DCN_AXIS", "MODEL_AXIS"):
        assert getattr(parallel, name) == getattr(jparallel, name)
    for rule in (parallel.RuleSpec(), parallel.RuleSpec(1, True),
                 parallel.rules.REPLICATED):
        assert rule.describe() == jrules.RuleSpec(
            rule.node_pos, rule.tp).describe()


def _field(path: str) -> str:
    """The state family a leaf belongs to: ``model/<part>``,
    ``mailbox``/``reply_box`` and ``aux`` by their first component."""
    parts = path.split("/")
    return "/".join(parts[:2]) if parts[0] == "model" else parts[0]


def _by_field(table) -> dict:
    out: dict = {}
    for path, desc in table:
        out.setdefault(_field(path), set()).add(desc)
    return out


@pytest.mark.parametrize("kind", ["float32", "int8", "pens"])
def test_resolved_fields_describe_as_jax(kind):
    """Each state field's placement strings of a resolved port state
    equal the JAX ones (float32 and int8 rings, PENS's aux)."""
    kw = {"pens": True} if kind == "pens" else {"history_dtype": kind}
    jst = jbuild(**kw).init_nodes(jax.random.PRNGKey(0))
    want = _by_field(jrules.resolved_rules_table(jst))
    got = _by_field(resolved_rules_table(tstate(**kw)))
    assert got == want
    if kind == "pens":
        assert any(f == "aux" for f in got)
    if kind == "int8":
        assert got["history_scale"] == {"node_axis@1"}


@pytest.mark.parametrize("batch_dims", [0, 1])
def test_resolved_node_positions_as_jax(mesh, batch_dims):
    """The node axis lands on the same dimension of every field as in the
    JAX resolution, with and without a leading lane axis."""
    jmesh = jparallel.make_mesh(8)
    jst = jbuild(history_dtype="int8").init_nodes(jax.random.PRNGKey(0))
    st = tstate(history_dtype="int8")
    if batch_dims:
        jst = jax.tree.map(lambda x: jnp.broadcast_to(x[None],
                                                      (2,) + x.shape), jst)
        st = tree_map_with_path(
            lambda _, x: (x[None].expand((2,) + tuple(x.shape))
                          if isinstance(x, torch.Tensor) else x), st)
    jspecs = jrules.partition_specs(jst, jmesh, batch_dims=batch_dims)
    want: dict = {}
    for path, spec in zip((p for p, _ in jrules.named_leaves(jst)),
                          jax.tree_util.tree_leaves(
                              jspecs, is_leaf=lambda s: isinstance(
                                  s, jax.sharding.PartitionSpec))):
        pos = [i for i, e in enumerate(spec) if e == "nodes"]
        want.setdefault(_field(path), set()).add(tuple(pos))
    got: dict = {}
    for path, spec in named_leaves(partition_specs(st, mesh,
                                                   batch_dims=batch_dims)):
        pos = [i for i, e in enumerate(spec) if e == "nodes"]
        got.setdefault(_field(path), set()).add(tuple(pos))
    assert got == want
