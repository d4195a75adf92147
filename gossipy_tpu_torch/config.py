"""Experiment configuration: dataclass + JSON, one file per experiment.

Counterpart of ``gossipy_tpu/config.py``, with the same fields, defaults,
validation and JSON schema, so one file runs in either package::

    cfg = ExperimentConfig.from_json("examples/configs/spambase_100.json")
    state, report = run_experiment(cfg)              # on the card
    state, report = run_experiment(cfg, device="cpu")

The device is an argument of :func:`build_experiment` and
:func:`run_experiment`, not a field: ``cuda`` unless ``"cpu"`` is passed,
and without a card they raise. The registries map the names onto the
port's pieces: the optax rules onto :mod:`gossipy_tpu_torch.optim`
(``sgd``, ``add_decayed_weights``, ``chain``), ``bf16`` onto
``compute_dtype=torch.bfloat16``, the partitioned handler's template onto
the model's :class:`~gossipy_tpu_torch.models.nn.ParamLayout`, and
``metropolis`` mixing onto :func:`~gossipy_tpu_torch.core.
metropolis_hastings_mixing`. The ``cohort`` field builds a
:class:`~gossipy_tpu_torch.simulation.cohort.CohortConfig` (the base
simulator only), and :func:`run_experiment` then inits a resident pool
(``init_cohort_pool``) in place of ``init_nodes``.

Seeding: the simulator draws from ``TorchDraws(cfg.seed)`` and
``init_nodes`` from the generator ``set_seed(cfg.seed)`` gives, so one
config gives one run. ``repetitions = R > 1`` runs the seeds ``cfg.seed,
cfg.seed + 1, ..., cfg.seed + R - 1`` one after another
(``run_repetitions``), where the JAX package splits its key ``R`` ways.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np

from .core import (
    AntiEntropyProtocol,
    ConstantDelay,
    CreateModelMode,
    LinearDelay,
    SparseTopology,
    Topology,
    UniformDelay,
    uniform_mixing,
)

# --------------------------------------------------------------------------
# Registries
# --------------------------------------------------------------------------


def _topology(kind: str, n: int, params: dict, backend: str, sparse: bool):
    if sparse:
        factories = {
            "ring": SparseTopology.ring,
            "random_regular": SparseTopology.random_regular,
            "barabasi_albert": SparseTopology.barabasi_albert,
            "erdos_renyi": SparseTopology.erdos_renyi,
        }
        if kind not in factories:
            raise ValueError(f"no sparse factory for topology {kind!r}; "
                             f"options: {sorted(factories)}")
        return factories[kind](n, **params)

    def clique(n, **kw):
        if kw:
            raise ValueError("topology 'clique' accepts no params, got "
                             f"{sorted(kw)}")
        return Topology.clique(n)

    factories = {
        "clique": clique,
        "ring": Topology.ring,
        "random_regular": lambda n, **kw: Topology.random_regular(
            n, backend=backend, **kw),
        "barabasi_albert": lambda n, **kw: Topology.barabasi_albert(
            n, backend=backend, **kw),
        "erdos_renyi": lambda n, **kw: Topology.erdos_renyi(
            n, backend=backend, **kw),
    }
    if kind not in factories:
        raise ValueError(f"unknown topology {kind!r}; "
                         f"options: {sorted(factories)}")
    return factories[kind](n, **params)


def _model(name: str, params: dict, input_dim, n_classes: int):
    from . import models

    name = name.lower()
    if isinstance(input_dim, tuple):
        # An image set under a dense model: flax's Dense acts on the last
        # axis, so the JAX model's first kernel is [channels, width].
        input_dim = input_dim[-1]

    def no_params():
        if params:
            raise ValueError(f"model {name!r} accepts no model_params, got "
                             f"{sorted(params)}")

    def only(*keys):
        unknown = set(params) - set(keys)
        if unknown:
            raise ValueError(f"unknown model_params for {name!r}: "
                             f"{sorted(unknown)}; valid: {sorted(keys)}")

    if name in ("logreg", "logistic_regression"):
        no_params()
        return models.LogisticRegression(input_dim, n_classes)
    if name == "mlp":
        only("hidden_dims")
        return models.MLP(input_dim, n_classes,
                          hidden_dims=tuple(params.get("hidden_dims", (64,))))
    if name == "perceptron":
        no_params()
        return models.Perceptron(input_dim)
    if name in ("linreg", "linear_regression"):
        only("out_dim")
        return models.LinearRegression(input_dim, params.get("out_dim", 1))
    if name == "cifar10net":
        only("conv_impl")
        # The JAX model's choice of convolution lowering; the port always
        # lowers by im2col and a batched product, so it checks the name only.
        impl = params.get("conv_impl", "auto")
        if impl not in ("auto", "einsum", "conv"):
            raise ValueError(f"unknown conv_impl {impl!r}; "
                             "options: auto, einsum, conv")
        return models.CIFAR10Net()
    raise ValueError(f"unknown model {name!r}; options: logreg, mlp, "
                     "perceptron, linreg, cifar10net")


def _delay(kind: str, params: dict):
    factories = {"constant": ConstantDelay, "uniform": UniformDelay,
                "linear": LinearDelay}
    if kind not in factories:
        raise ValueError(f"unknown delay {kind!r}; options: {sorted(factories)}")
    return factories[kind](**params)


def _handler(cfg: "ExperimentConfig", model, input_shape, n_classes,
             n_items: int = 0):
    import torch

    from . import handlers, optim

    kinds = {
        "sgd": handlers.SGDHandler,
        "weighted": handlers.WeightedSGDHandler,
        "limited_merge": handlers.LimitedMergeSGDHandler,
        "sampling": handlers.SamplingSGDHandler,
        "partitioned": handlers.PartitionedSGDHandler,
        "adaline": handlers.AdaLineHandler,
        "pegasos": handlers.PegasosHandler,
        "kmeans": handlers.KMeansHandler,
        "mf": handlers.MFHandler,
    }
    if cfg.handler not in kinds:
        raise ValueError(f"unknown handler {cfg.handler!r}; "
                         f"options: {sorted(kinds)}")
    cls = kinds[cfg.handler]
    mode = CreateModelMode[cfg.create_model_mode]
    params = dict(cfg.handler_params)
    if cfg.handler in ("adaline", "pegasos"):
        from .models import AdaLine
        return cls(net=AdaLine(input_shape[0]),
                   learning_rate=cfg.learning_rate, **params)
    if cfg.handler == "kmeans":
        # k defaults to the label count (main_berta_2014).
        return cls(k=params.pop("k", n_classes), dim=input_shape[0],
                   create_model_mode=mode, **params)
    if cfg.handler == "mf":
        # One user a node, item factors travel (main_hegedus_2020).
        return cls(dim=params.pop("dim", 5), n_items=n_items,
                   learning_rate=cfg.learning_rate, create_model_mode=mode,
                   **params)
    losses = {"cross_entropy": handlers.losses.cross_entropy,
              "mse": handlers.losses.mse}
    if cfg.loss not in losses:
        raise ValueError(f"unknown loss {cfg.loss!r}; "
                         f"options: {sorted(losses)}")
    opt = optim.sgd(cfg.learning_rate)
    if cfg.weight_decay:
        opt = optim.chain(optim.add_decayed_weights(cfg.weight_decay), opt)
    common = dict(model=model, loss=losses[cfg.loss], optimizer=opt,
                  local_epochs=cfg.local_epochs, batch_size=cfg.batch_size,
                  n_classes=n_classes, input_shape=input_shape,
                  create_model_mode=mode,
                  compute_dtype=torch.bfloat16 if cfg.bf16 else None)
    if cfg.handler == "partitioned":
        # The partition's index sets derive from the model's leaves;
        # only n_parts is a config knob.
        from .compression import ModelPartition
        from .models import ParamLayout
        partition = ModelPartition(ParamLayout(model.leaves),
                                   params.pop("n_parts", 4))
        return cls(partition, **common, **params)
    return cls(**common, **params)


def _token_account(cfg: "ExperimentConfig"):
    """The configured token account (default kind: simple)."""
    from . import flow_control
    accounts = {
        "purely_proactive": flow_control.PurelyProactiveTokenAccount,
        "purely_reactive": flow_control.PurelyReactiveTokenAccount,
        "simple": flow_control.SimpleTokenAccount,
        "generalized": flow_control.GeneralizedTokenAccount,
        "randomized": flow_control.RandomizedTokenAccount,
    }
    acc_kind = cfg.token_account or "simple"
    if acc_kind not in accounts:
        raise ValueError(f"unknown token account {acc_kind!r}; "
                         f"options: {sorted(accounts)}")
    return accounts[acc_kind](**cfg.token_account_params)


def _simulator(cfg: "ExperimentConfig", handler, topology, data, device):
    from .random import TorchDraws
    from .simulation import (
        All2AllGossipSimulator,
        CacheNeighGossipSimulator,
        GossipSimulator,
        PartitioningGossipSimulator,
        PassThroughGossipSimulator,
        PENSGossipSimulator,
        SamplingGossipSimulator,
        SequentialGossipSimulator,
        TokenizedGossipSimulator,
        TokenizedPartitioningGossipSimulator,
    )

    common = dict(
        delta=cfg.delta,
        protocol=AntiEntropyProtocol[cfg.protocol],
        delay=_delay(cfg.delay, dict(cfg.delay_params)),
        drop_prob=cfg.drop_prob, online_prob=cfg.online_prob,
        sampling_eval=cfg.sampling_eval, sync=cfg.sync,
        eval_every=cfg.eval_every,
    )
    if cfg.chaos is not None:
        # Validated here (ChaosConfig.from_dict raises on unknown fields),
        # so a mistyped chaos spec fails at build.
        from .simulation.faults import ChaosConfig
        common["chaos"] = ChaosConfig.from_dict(cfg.chaos)
    if cfg.cohort is not None:
        # Validated at build; only the base engine drives the resident
        # pool's segment loop.
        if cfg.simulator != "gossip":
            raise ValueError("cohort mode requires simulator 'gossip' "
                             f"(got {cfg.simulator!r})")
        from .simulation.cohort import CohortConfig
        common["cohort"] = CohortConfig.from_dict(cfg.cohort)
    common.update(cfg.simulator_params)
    common.update(draws=TorchDraws(cfg.seed), device=device)
    kind = cfg.simulator
    if kind == "gossip":
        return GossipSimulator(handler, topology, data, **common)
    if kind == "sequential":
        # Reference tick-loop semantics: evaluation every round.
        ev = common.pop("eval_every", 1)
        if ev != 1:
            raise ValueError(
                "the sequential simulator evaluates every round "
                "(reference tick-loop semantics); eval_every must be 1")
        account = _token_account(cfg) if cfg.token_account else None
        return SequentialGossipSimulator(handler, topology, data,
                                         token_account=account, **common)
    if kind in ("tokenized", "tokenized_partitioning"):
        account = _token_account(cfg)
        sim_cls = (TokenizedPartitioningGossipSimulator
                   if kind == "tokenized_partitioning"
                   else TokenizedGossipSimulator)
        return sim_cls(handler, topology, data, token_account=account,
                       **common)
    if kind == "all2all":
        from .core import metropolis_hastings_mixing
        mixers = {"uniform": uniform_mixing,
                  "metropolis": metropolis_hastings_mixing}
        mix_name = common.pop("mixing", "uniform")
        if mix_name not in mixers:
            raise ValueError(f"unknown mixing {mix_name!r}; "
                             f"options: {sorted(mixers)}")
        return All2AllGossipSimulator(handler, topology, data,
                                      mixing=mixers[mix_name](topology),
                                      **common)
    simple = {"passthrough": PassThroughGossipSimulator,
              "cache_neigh": CacheNeighGossipSimulator,
              "sampling": SamplingGossipSimulator,
              "partitioning": PartitioningGossipSimulator,
              "pens": PENSGossipSimulator}
    if kind not in simple:
        raise ValueError(
            f"unknown simulator {kind!r}; options: "
            f"{sorted(simple) + ['gossip', 'sequential', 'tokenized', 'all2all', 'tokenized_partitioning']}")
    return simple[kind](handler, topology, data, **common)


# --------------------------------------------------------------------------
# The config dataclass
# --------------------------------------------------------------------------

# The fields a service tenant may vary without changing the round program
# (the JAX package's service packer buckets runs by the rest).
TENANT_VARIABLE_FIELDS = ("seed", "drop_prob", "online_prob", "n_rounds",
                          "repetitions", "chaos")


@dataclasses.dataclass
class ExperimentConfig:
    """One gossip-learning experiment, declaratively: data, model and
    handler, topology, protocol timing, faults and run length, with the
    JAX package's fields and defaults."""

    # data
    task: str = "classification"         # "classification" | "clustering" | "recsys"
    dataset: str = "spambase"            # classification names, the image sets
    n_nodes: int = 100                   # "cifar10"/"fashion_mnist", "femnist",
    assignment: str = "uniform"          # or (task="recsys") "ml-100k"/"ml-1m".
                                         # n_nodes=0 = one node per sample;
                                         # recsys derives it from the users.
    assignment_params: dict = dataclasses.field(default_factory=dict)
    eval_on_user: bool = False
    test_size: float = 0.2               # tabular split (images ship a test set)
    subsample: int = 0                   # cap train samples (0 = all)
    flip_half: bool = False              # vertically flip the 2nd half of an
                                         # image set (main_onoszko_2021)
    # model + handler
    model: str = "logreg"
    model_params: dict = dataclasses.field(default_factory=dict)
    handler: str = "sgd"
    handler_params: dict = dataclasses.field(default_factory=dict)
    loss: str = "cross_entropy"
    learning_rate: float = 0.1
    weight_decay: float = 0.0
    local_epochs: int = 1
    batch_size: int = 32
    create_model_mode: str = "MERGE_UPDATE"
    bf16: bool = False
    # topology
    topology: str = "random_regular"
    topology_params: dict = dataclasses.field(default_factory=lambda: {"degree": 20})
    topology_backend: str = "networkx"
    sparse_topology: bool = False
    # protocol / timing / faults
    simulator: str = "gossip"            # gossip | sequential | tokenized |
                                         # tokenized_partitioning | all2all |
                                         # passthrough | cache_neigh |
                                         # sampling | partitioning | pens
    simulator_params: dict = dataclasses.field(default_factory=dict)
                                         # extra constructor kwargs (e.g.
                                         # compact_deliver, mailbox_slots,
                                         # fused_merge, history_dtype, mixing)
    protocol: str = "PUSH"
    delta: int = 100
    delay: str = "constant"
    delay_params: dict = dataclasses.field(default_factory=dict)
    drop_prob: float = 0.0
    online_prob: float = 1.0
    chaos: Optional[dict] = None         # ChaosConfig.to_dict() form
    cohort: Optional[dict] = None        # CohortConfig.to_dict() form:
                                         # sampled active-cohort mode
                                         # (simulation.cohort); n_nodes
                                         # is the NOMINAL population, a
                                         # round puts cohort["size"] on
                                         # the device
    sampling_eval: float = 0.0
    sync: bool = True
    eval_every: int = 1
    token_account: Optional[str] = None
    token_account_params: dict = dataclasses.field(default_factory=dict)
    # run
    n_rounds: int = 100
    seed: int = 42
    repetitions: int = 1  # >1 = the seeds seed, seed+1, ... one after another
    common_init: bool = False  # same initial weights on every node (CIFAR CNN)

    def __post_init__(self):
        if self.repetitions < 1:
            raise ValueError(
                f"repetitions must be >= 1, got {self.repetitions}")
        if self.task not in ("classification", "clustering", "recsys"):
            raise ValueError(f"unknown task {self.task!r}; options: "
                             "classification, clustering, recsys")
        if self.task == "recsys" and self.handler != "mf":
            raise ValueError("task 'recsys' requires handler 'mf' "
                             "(one user-row per node, MF factors travel)")
        if self.task != "recsys" and self.handler == "mf":
            raise ValueError("handler 'mf' requires task 'recsys'")
        if self.cohort is not None and self.repetitions > 1:
            raise ValueError("cohort mode is host-driven per segment and "
                             "cannot ride the repetition vmap; run seeds "
                             "as separate experiments")

    # -- serialization ------------------------------------------------------

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @staticmethod
    def from_json(path_or_str: str) -> "ExperimentConfig":
        if path_or_str.lstrip().startswith("{"):
            d = json.loads(path_or_str)
        else:
            with open(path_or_str) as f:
                d = json.load(f)
        return ExperimentConfig.from_dict(d)

    @staticmethod
    def from_dict(d: dict) -> "ExperimentConfig":
        fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown config fields: {sorted(unknown)}; "
                             f"valid fields: {sorted(fields)}")
        return ExperimentConfig(**d)

    def shape_fields(self) -> dict:
        """Every field except :data:`TENANT_VARIABLE_FIELDS`: two configs
        with equal ``shape_fields()`` build simulators of the same shapes."""
        d = dataclasses.asdict(self)
        for f in TENANT_VARIABLE_FIELDS:
            d.pop(f, None)
        return d


# --------------------------------------------------------------------------
# Build + run
# --------------------------------------------------------------------------

def build_experiment(cfg: ExperimentConfig, data: Optional[tuple] = None,
                     device=None) -> tuple[Any, Any]:
    """Instantiate ``(simulator, dispatcher)`` from a config, the
    simulator on ``device`` (``cuda`` unless ``"cpu"`` is given).

    ``data``: optional pre-loaded ``(X, y)`` (``(ratings, n_users,
    n_items)`` for recsys) overriding ``cfg.dataset``.
    """
    from . import resolve_device
    from .data import (
        AssignmentHandler,
        ClassificationDataHandler,
        ClusteringDataHandler,
        DataDispatcher,
        RecSysDataDispatcher,
        RecSysDataHandler,
        load_classification_dataset,
        load_recsys_dataset,
    )

    device = resolve_device(device)
    known = {"gossip", "sequential", "tokenized", "tokenized_partitioning",
             "all2all", "passthrough", "cache_neigh", "sampling",
             "partitioning", "pens"}
    if cfg.simulator not in known:
        raise ValueError(f"unknown simulator {cfg.simulator!r}; "
                         f"options: {sorted(known)}")

    if cfg.task == "recsys":
        ratings, n_users, n_items = (data if data is not None
                                     else load_recsys_dataset(cfg.dataset))
        dh = RecSysDataHandler(ratings, n_users, n_items,
                               test_size=cfg.test_size, seed=cfg.seed)
        disp = RecSysDataDispatcher(dh)
        disp.assign(cfg.seed)
        handler = _handler(cfg, None, (n_items,), 0, n_items=n_items)
        topology = _topology(cfg.topology, n_users,
                             dict(cfg.topology_params), cfg.topology_backend,
                             cfg.sparse_topology)
        return _simulator(cfg, handler, topology, disp.stacked(),
                          device), disp

    def subsample(X, y, n):
        # A seeded shuffle before slicing (some loaders sort by class).
        order = np.random.default_rng(cfg.seed).permutation(len(X))[:n]
        return X[order], y[order]

    writer_assignment = None  # femnist: the writers' own shards
    image_sets = {"cifar10": "get_CIFAR10", "fashion_mnist": "get_FashionMNIST"}
    if cfg.task == "clustering" and (cfg.dataset in image_sets
                                     or cfg.dataset == "femnist"):
        raise ValueError("task 'clustering' supports tabular datasets only "
                         f"(got {cfg.dataset!r})")
    if data is None and cfg.dataset == "femnist":
        from . import data as data_mod
        (Xtr, ytr, tr_a), (Xte, yte, te_a) = data_mod.get_FEMNIST(
            n_writers=cfg.n_nodes or 100)
        mu, sd = Xtr.mean(), Xtr.std() + 1e-8
        X = (Xtr - mu) / sd
        dh = ClassificationDataHandler(X, ytr, (Xte - mu) / sd, yte)
        y = np.concatenate([ytr, yte])
        writer_assignment = (tr_a, te_a)
    elif data is None and cfg.dataset in image_sets:
        from . import data as data_mod
        (Xtr, ytr), (Xte, yte) = getattr(data_mod, image_sets[cfg.dataset])()
        if cfg.subsample:
            Xtr, ytr = subsample(Xtr, ytr, cfg.subsample)
            Xte, yte = subsample(Xte, yte, cfg.subsample // 5 or 1)
        # Both splits normalised with the TRAIN statistics (the flagship
        # recipe).
        mu, sd = Xtr.mean(), Xtr.std() + 1e-8
        X = (Xtr - mu) / sd
        Xte = (Xte - mu) / sd
        if cfg.flip_half:
            # main_onoszko_2021's cluster non-IID: the second half of each
            # split sees vertically flipped images.
            X = X.copy()
            Xte = Xte.copy()
            X[len(X) // 2:] = X[len(X) // 2:, ::-1, :, :]
            Xte[len(Xte) // 2:] = Xte[len(Xte) // 2:, ::-1, :, :]
        dh = ClassificationDataHandler(X, ytr, Xte, yte)
        y = np.concatenate([ytr, yte])
    else:
        X, y = data if data is not None \
            else load_classification_dataset(cfg.dataset)
        if cfg.subsample:
            X, y = subsample(X, y, cfg.subsample)
        if cfg.handler in ("adaline", "pegasos"):
            # The linear-threshold handlers train on ±1 labels.
            y = (2 * y - 1).astype(np.float32)
        if cfg.task == "clustering":
            dh = ClusteringDataHandler(X, y)   # eval set == train set
        else:
            dh = ClassificationDataHandler(X, y, test_size=cfg.test_size,
                                           seed=cfg.seed)
    n_classes = int(np.max(y)) + 1
    assignment = None
    if cfg.assignment == "contiguous":
        # main_onoszko_2021's contiguous equal blocks.
        n_tr = len(dh.get_train_set()[0])
        n_for_blocks = cfg.n_nodes or n_tr
        per = -(-n_tr // n_for_blocks)
        writer_assignment = ([np.arange(i * per, min((i + 1) * per, n_tr))
                              for i in range(n_for_blocks)], None)
    elif cfg.assignment != "uniform":
        if not hasattr(AssignmentHandler, cfg.assignment):
            raise ValueError(f"unknown assignment {cfg.assignment!r}")
        assignment = getattr(AssignmentHandler, cfg.assignment)
    # The config's seed draws the partition, once (auto_assign=False).
    # n_nodes=0 = one node per (train) sample.
    n_nodes = len(writer_assignment[0]) if writer_assignment is not None \
        else cfg.n_nodes
    disp = DataDispatcher(dh, n=n_nodes, eval_on_user=cfg.eval_on_user,
                          auto_assign=False,
                          **({} if assignment is None
                             else {"assignment": assignment}),
                          **cfg.assignment_params)
    if writer_assignment is not None:
        disp.set_assignments(*writer_assignment)
    else:
        disp.assign(cfg.seed)
    n_nodes = disp.size()

    input_shape = X.shape[1:]
    model = None if cfg.handler in ("kmeans", "adaline", "pegasos") else \
        _model(cfg.model, dict(cfg.model_params), input_shape[0]
               if len(input_shape) == 1 else input_shape, n_classes)
    handler = _handler(cfg, model, input_shape, n_classes)
    topology = _topology(cfg.topology, n_nodes,
                         dict(cfg.topology_params), cfg.topology_backend,
                         cfg.sparse_topology)
    sim = _simulator(cfg, handler, topology, disp.stacked(), device)
    return sim, disp


def repetition_seeds(cfg: ExperimentConfig) -> list[int]:
    """The seeds of ``cfg.repetitions`` runs: ``cfg.seed + i``."""
    return [cfg.seed + i for i in range(cfg.repetitions)]


def run_experiment(cfg: ExperimentConfig, data: Optional[tuple] = None,
                   device=None):
    """Build and run the experiment on ``device`` (``cuda`` unless
    ``"cpu"`` is given).

    Returns ``(state, SimulationReport)``; with ``cfg.repetitions > 1``,
    ``(states, [SimulationReport])``: repetition ``i`` runs the seed
    ``cfg.seed + i`` (:func:`repetition_seeds`) through the simulator's
    ``run_repetitions``, one after another.
    """
    from . import set_seed

    generator = set_seed(cfg.seed)
    sim, _ = build_experiment(cfg, data, device)
    if cfg.repetitions > 1:
        return sim.run_repetitions(cfg.n_rounds, repetition_seeds(cfg),
                                   common_init=cfg.common_init)
    if getattr(sim, "cohort", None) is not None:
        pool = sim.init_cohort_pool(generator, common_init=cfg.common_init)
        return sim.start(pool, n_rounds=cfg.n_rounds)
    state = sim.init_nodes(generator, common_init=cfg.common_init)
    return sim.start(state, n_rounds=cfg.n_rounds)
