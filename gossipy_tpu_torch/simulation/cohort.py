"""Sampled active-cohort rounds: population size decoupled from round cost.

Counterpart of ``gossipy_tpu/simulation/cohort.py``. The engine holds
every node on the device every round (``[N, ...]`` state). Cohort mode
keeps the population of NOMINAL size N in a host-resident pool of
per-node durable state (:class:`CohortPool`), and each round only a
sampled **cohort** of C nodes is on the card: gather the cohort's rows,
run the engine's standard round at width C, scatter the updates back.
Per-round cost is a function of C; N only prices the pool::

    sim = GossipSimulator(handler, NominalTopology(1_000_000), data,
                          cohort=CohortConfig(size=1024))
    pool = sim.init_cohort_pool()
    pool, report = sim.start(pool, n_rounds=500)

What persists per node is the pool: model params, optimizer state and
ages, the phase, ``node_key`` and the touched mask the coverage reads.
Round-scoped state (mailbox, history ring, reply box) is rebuilt per
cohort from the gathered params: cohort rotation drains in-flight
traffic.

Peer sampling inside a cohort round (``CohortConfig.peer_mode``):

- ``"resample"`` (default): a uniform peer over the cohort
  (:meth:`~gossipy_tpu_torch.random.DrawProvider.cohort_peers`, no
  ``[C, C]`` clique); no O(N) structure is read, so a
  :class:`NominalTopology` may stand for the population;
- ``"induced"``: the topology's subgraph on the cohort, a uniform draw
  over each node's neighbours that are also in the cohort (the padded
  table ``state.aux["cohort_nbr"]``, ``-1`` where absent; a node with
  none sends nothing).

Draws: the cohorts come from the provider's seed material
(:meth:`~gossipy_tpu_torch.random.DrawProvider.cohort_seed_material`)
and the absolute round (:func:`sample_cohort`, a numpy ``SeedSequence``,
the JAX package's schedule for the same material), never from the
provider's stream; the rounds draw as the engine's do, keyed on the
absolute round (a restored pool continues the same schedule).

The streaming driver (``CohortConfig(prefetch=k)``) keeps the host out
of the round's way. The eager round gives up and takes back the GIL at
every op, so a Python helper thread either waits for the GIL for as long
as the round launches, or makes each op wait for it: the former stager
and flusher threads did both (on one card host a streamed run hid almost
none of its host work behind the rounds). Now the pool's row copies (the
gathers into pinned stage slots allocated once, the scatters, the
touched count) run
on the native row worker (:mod:`gossipy_tpu_torch.native.rows`), a C++
thread that never takes the GIL, in the order they are queued: as a
segment's rounds start, the previous segment's scatter and the gathers of
the next ``k`` cohorts are queued, so they run behind the rounds. Once a
segment's rounds are launched, and before the host waits for them, the
round's thread stages the next cohort (its rows to the card, its [C]
state, its data rows), taking the rows the two cohorts share from the
finished segment's state on the card. The run's cohort schedule is drawn
up front. A gather sees every output scattered before it; the newer ones
are laid over it at staging, newest last, so the streamed run is
bit-identical to the serial one.

Disk-backed pools (``CohortConfig(pool_dir=...)``, :class:`PoolStore`):
every pool leaf is an ``np.memmap`` over a sparse file, rows are
initialized the first time they are sampled, deterministic per (store
seed, node id), and a checkpoint is a hole-preserving copy of the files.
The store's format is the port's own.

A disk-backed pool on a mesh across ranks is one replica of the store a
rank, kept equal as the ranks' RAM pools are: rank 0's store is
``pool_dir`` itself (one process can resume it), rank ``r``'s is
``<pool_dir>.rank<r>`` (:func:`rank_pool_dir`), so no two ranks write
one file. Every rank initializes the lazy rows of the whole cohort in
its replica and scatters the whole gathered cohort into it. A rank that
lacks its replica while rank 0 holds a store (a store another layout
wrote) copies rank 0's files, holes kept; the ranks' manifests must
agree on ``round`` and ``seed_word``, or every rank raises
``ValueError`` naming both paths. A checkpoint is rank 0's copy of its
files (every rank flushes, the draw states are held equal, a barrier
follows); a restore copies the one checkpoint into each rank's own work
directory (``<path>.live`` on rank 0, ``<path>.live.rank<r>``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch

from ..handlers.base import ModelState
from ..telemetry.tracing import WAIT_CAT, attach_device_spans, span

# Report keys this layer adds (report.PER_ROUND_FIELDS).
COHORT_STAT_KEYS = ("cohort_coverage", "cohort_active_nodes")

_PEER_MODES = ("resample", "induced")


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    """Active-cohort mode configuration.

    - ``size``: C, the number of nodes on the card per round.
    - ``rounds_per_cohort``: consecutive rounds one sampled cohort runs
      before rotating (1: a fresh cohort every round).
    - ``peer_mode``: ``"resample"`` | ``"induced"`` (module doc).
    - ``prefetch``: depth of the streaming driver. 0 runs segments
      serially; ``k >= 1`` stages up to ``k`` future cohorts while the
      current one runs and scatters finished cohorts asynchronously,
      bit-identical to the serial schedule.
    - ``pool_dir``: a directory for a disk-backed pool (:class:`PoolStore`):
      nominal N is bounded by storage, not host RAM.
    """

    size: int
    rounds_per_cohort: int = 1
    peer_mode: str = "resample"
    prefetch: int = 0
    pool_dir: Optional[str] = None

    def __post_init__(self):
        if int(self.size) < 2:
            raise ValueError(f"cohort size must be >= 2, got {self.size}")
        if int(self.rounds_per_cohort) < 1:
            raise ValueError("rounds_per_cohort must be >= 1, got "
                             f"{self.rounds_per_cohort}")
        if self.peer_mode not in _PEER_MODES:
            raise ValueError(f"unknown peer_mode {self.peer_mode!r}; "
                             f"options: {_PEER_MODES}")
        if int(self.prefetch) < 0:
            raise ValueError(
                f"prefetch must be >= 0, got {self.prefetch}")
        if self.pool_dir is not None and not isinstance(self.pool_dir,
                                                        str):
            raise ValueError("pool_dir must be a directory path string "
                             f"or None, got {type(self.pool_dir).__name__}")

    @staticmethod
    def coerce(value: Union[None, int, dict, "CohortConfig"]
               ) -> Optional["CohortConfig"]:
        """None | C | dict | CohortConfig -> Optional[CohortConfig]."""
        if value is None or isinstance(value, CohortConfig):
            return value
        if isinstance(value, bool):
            raise ValueError("cohort= takes a size/config, not a bool")
        if isinstance(value, int):
            return CohortConfig(size=value)
        if isinstance(value, dict):
            return CohortConfig.from_dict(value)
        raise ValueError(f"cannot coerce {type(value).__name__} to "
                         "CohortConfig")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "CohortConfig":
        fields = {f.name for f in dataclasses.fields(CohortConfig)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown cohort fields: {sorted(unknown)}; "
                             f"valid: {sorted(fields)}")
        return CohortConfig(**d)


class NominalTopology:
    """A population SIZE standing in for a topology.

    Resample-mode cohorts never read edges, so a 10M-node run need not
    build a 10M-node graph. This stand-in carries only ``num_nodes``;
    every structural query raises, so it cannot reach a path that needs
    real edges (``peer_mode="induced"``, chaos, the engine without
    ``cohort=``)."""

    def __init__(self, n: int):
        self.num_nodes = int(n)

    def __getattr__(self, name):
        raise AttributeError(
            f"NominalTopology has no {name!r}: it is a population size "
            "for resample-mode cohort runs, not a graph — use a real "
            "Topology/SparseTopology for edge-dependent features")

    def __repr__(self):
        return f"NominalTopology({self.num_nodes})"


class _CohortRoundTopology:
    """The inner round's C-node world, where everyone may talk to
    everyone: every node has C - 1 neighbours and no ``[C, C]`` adjacency
    exists. The engine draws its peers through
    :meth:`~gossipy_tpu_torch.random.DrawProvider.cohort_peers` and
    sizes its mailbox from a fan-in of F per node."""

    def __init__(self, c: int):
        self.num_nodes = int(c)
        self.degrees = np.full(self.num_nodes, self.num_nodes - 1,
                               dtype=np.int64)

    def __repr__(self):
        return f"_CohortRoundTopology({self.num_nodes})"


class CohortPool(NamedTuple):
    """The resident per-node durable state of the nominal population.

    Every array leaf is a host numpy array (or an ``np.memmap`` of a
    disk-backed pool) with leading axis N: the pool is what must NOT live
    in the card's memory.

    - ``model``: the stacked :class:`~gossipy_tpu_torch.handlers.base.
      ModelState`, params ``[N, stride]`` float32, the optimizer state's
      per-node arrays, ages ``[N]`` int32;
    - ``phase``: ``[N]`` int32 send offsets (sync) or periods (async);
    - ``node_key``: ``[N, 2]`` uint32, node ``i``'s ``(seed word, i)``:
      the seed word is a 32-bit word of the init's seed material (the
      generator's seed for a RAM pool, the store's seed for a disk pool),
      and for a disk pool the pair seeds the numpy generator that row's
      lazy init draws from;
    - ``touched``: ``[N]`` bool, the coverage accounting's mask;
    - ``round``: the absolute round counter (an int): the rounds' draws
      and the cohort schedule key off it, so a restored pool continues
      bit for bit.
    """

    model: Any
    phase: Any
    node_key: Any
    touched: Any
    round: Any


def setup_cohort(sim, topology):
    """Constructor-side wiring (``GossipSimulator.__init__`` with
    ``cohort=``): validate, remember the nominal population, and return
    the C-node round topology the rest of construction sizes against."""
    from .engine import GossipSimulator

    if type(sim) is not GossipSimulator:
        raise ValueError(
            f"cohort mode supports the base GossipSimulator only; "
            f"{type(sim).__name__} variants drive their own state shapes")
    cfg: CohortConfig = sim.cohort
    n = int(topology.num_nodes)
    if cfg.size > n:
        raise ValueError(f"cohort size {cfg.size} exceeds the nominal "
                         f"population {n}")
    sim.nominal_topology = topology
    sim.nominal_n = n
    sim._cohort_nbr_global = None
    if cfg.peer_mode == "induced":
        if isinstance(topology, NominalTopology):
            raise ValueError("peer_mode='induced' needs a real topology "
                             "(NominalTopology carries no edges)")
        from .nodes import build_neighbor_table
        sim._cohort_nbr_global = np.asarray(build_neighbor_table(topology),
                                            dtype=np.int32)
    return _CohortRoundTopology(cfg.size)


# -- the pool's leaves -------------------------------------------------------

def _leaves(model: ModelState) -> list:
    """A model state's arrays in order: params, the optimizer state's,
    ages."""
    return [model.params, *model.opt_state, model.n_updates]


def _unleaves(leaves: list) -> ModelState:
    return ModelState(leaves[0], tuple(leaves[1:-1]), leaves[-1])


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _model_spec(sim) -> list:
    """``[(per-node shape, numpy dtype)]`` of the pool's model leaves."""
    h = sim.handler
    stride = h.layout.stride
    opt = h.init_opt_state(torch.zeros(1, stride))
    age = h.init(torch.Generator(), "cpu").n_updates
    return ([((stride,), np.dtype(np.float32))]
            + [(tuple(t.shape[1:]), _np_dtype(t.dtype)) for t in opt]
            + [(tuple(age.shape), np.dtype(np.int32))])


def pool_template(sim) -> CohortPool:
    """A zero-filled pool of the simulator's shapes: the checkpoint
    restore's template (structure and dtypes), cheap at any nominal N
    (numpy zeros, no init)."""
    n = sim.nominal_n
    model = _unleaves([np.zeros((n,) + shape, dt)
                       for shape, dt in _model_spec(sim)])
    return CohortPool(model=model, phase=np.zeros(n, np.int32),
                      node_key=np.zeros((n, 2), np.uint32),
                      touched=np.zeros(n, bool), round=0)


def pool_bytes(sim) -> int:
    """Pool-residency bytes: the durable per-node state times nominal N
    (``memory_budget``'s cohort block). The params count the port's
    padded row (``stride``)."""
    per_node = sum(int(np.prod(shape)) * dt.itemsize
                   for shape, dt in _model_spec(sim))
    per_node += 4            # phase (int32)
    per_node += 8            # node_key (2 x uint32)
    per_node += 1            # touched (bool)
    return per_node * sim.nominal_n


def _seed_word(material) -> int:
    """One 32-bit word of seed material (a ``node_key`` column)."""
    return int(np.random.SeedSequence(
        [int(x) & 0xFFFFFFFF for x in material]).generate_state(1)[0])


def _node_keys(word: int, ids: np.ndarray) -> np.ndarray:
    out = np.empty((ids.shape[0], 2), np.uint32)
    out[:, 0] = np.uint32(word)
    out[:, 1] = ids.astype(np.uint32)
    return out


def _generator_material(g: torch.Generator) -> list:
    seed = int(g.initial_seed())
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF]


# -- pool construction -------------------------------------------------------

def _init_block(sim, g: torch.Generator, b: int) -> list:
    """``b`` nodes' initial model leaves (numpy) under ``g``: one blocked
    draw where the handler admits it (:meth:`~gossipy_tpu_torch.handlers.
    base.BaseHandler.init_rows`), else ``b`` inits one after another;
    both give what ``b`` sequential ``handler.init(g)`` calls give."""
    h = sim.handler
    st = h.init_rows(b, lambda count, dtype: torch.rand(
        (b, count), generator=g, dtype=dtype))
    if st is None:
        rows = [h.init(g, "cpu") for _ in range(b)]
        params = torch.stack([m.params for m in rows])
        st = ModelState(params, h.init_opt_state(params),
                        torch.stack([m.n_updates for m in rows]))
    return [t.numpy().astype(dt, copy=False)
            for t, (_, dt) in zip(_leaves(st), _model_spec(sim))]


def init_cohort_pool(sim, generator: Optional[torch.Generator] = None,
                     common_init: bool = False, local_train: bool = False,
                     block: Optional[int] = None) -> CohortPool:
    """The resident pool (the cohort-mode ``init_nodes``).

    Model init runs on the host in blocks of ``block`` nodes (default
    ``max(C, 65536)``), each one draw from ``generator`` (default seeded
    with 0): the rows equal ``init_nodes(generator, local_train=False)``
    of the same population bit for bit. The phases come from the draw
    provider's ``init_phase`` (sync) or ``init_period`` (async).

    ``local_train`` defaults to **False** (unlike ``init_nodes``): a
    node takes its first local update the first time it is sampled. With
    True each block takes one pre-training pass on the run's device, its
    shard orders from ``init_permutations`` of the block.

    With ``CohortConfig(pool_dir=...)`` no row is initialized here: the
    pool's leaves are sparse-file memmaps (:class:`PoolStore`), rows
    materialize the first time they are sampled, an existing store
    directory is re-opened (resume), a missing one created. On a mesh
    across ranks every rank calls it with the same generator and opens
    its own replica of the store (:func:`rank_pool_dir`, the module
    doc)."""
    n = sim.nominal_n
    cfg = sim.cohort
    g = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    if cfg.pool_dir:
        if local_train:
            raise ValueError(
                "local_train is not supported with pool_dir= (the lazy "
                "per-row init has no blocked pre-training pass)")
        material = _generator_material(g)
        if _across(sim):
            store = _replica_store(sim, cfg.pool_dir, material, common_init)
        elif is_pool_store_dir(cfg.pool_dir):
            store = open_pool_store(sim, cfg.pool_dir)
        else:
            store = create_pool_store(sim, material, cfg.pool_dir,
                                      common_init=common_init)
        sim._pool_store = store
        return store.pool()
    block = int(block or max(cfg.size, 65536))
    spec = _model_spec(sim)
    leaves = [np.empty((n,) + shape, dt) for shape, dt in spec]
    if common_init:
        one = _init_block(sim, g, 1)
        for dst, src in zip(leaves, one):
            dst[...] = src
    else:
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            for dst, src in zip(leaves, _init_block(sim, g, hi - lo)):
                dst[lo:hi] = src
    if local_train:
        _pretrain_blocks(sim, leaves, block)
    if sim.sync:
        phase = sim.draws.init_phase(n, sim.delta, "cpu")
    else:
        phase = sim.draws.init_period(n, sim.delta, "cpu")
    return CohortPool(
        model=_unleaves(leaves),
        phase=phase.to(torch.int32).numpy().copy(),
        node_key=_node_keys(_seed_word(_generator_material(g)),
                            np.arange(n)),
        touched=np.zeros(n, bool), round=0)


def _pretrain_blocks(sim, leaves: list, block: int) -> None:
    """One local pre-training pass over the pool, block by block on the
    run's device (node ``i`` reads data row ``i % P``)."""
    h = sim.handler
    dev = sim.device
    p = _pool_data_rows(sim)
    n = leaves[0].shape[0]
    epochs = h.orders_per_update()
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        idx = torch.arange(lo, hi, device=dev) % p
        model = _unleaves([torch.from_numpy(l[lo:hi]).to(dev)
                           for l in leaves])
        data = tuple(sim.data[k][idx] for k in ("xtr", "ytr", "mtr"))
        perms = None if epochs is None else sim.draws.init_permutations(
            hi - lo, epochs, sim.data["mtr"].shape[1], dev)
        out = h.update(model, data, perms)
        for dst, src in zip(leaves, _leaves(out)):
            dst[lo:hi] = src.cpu().numpy()


def _host_pool(pool: CohortPool, copy: bool = False) -> CohortPool:
    """A pool with writable host numpy leaves; ``copy`` copies every one
    (the caller's pool keeps its value: ``start`` does not mutate it).
    Memmap leaves (disk-backed pools) pass through: the file IS the
    pool."""
    def h(leaf):
        if isinstance(leaf, np.memmap):
            return leaf
        a = np.asarray(leaf)  # tracelint: disable=np-in-round (host pool)
        return a.copy() if copy or not a.flags.writeable else a
    return CohortPool(model=_unleaves([h(l) for l in _leaves(pool.model)]),
                      phase=h(pool.phase), node_key=h(pool.node_key),
                      touched=h(pool.touched), round=int(pool.round))


def _pool_data_rows(sim) -> int:
    """P, the leading axis of the per-node data: node ``i`` reads row
    ``i % P``, so a pool of nominal N rides a bank of P << N shards."""
    return int(sim.data["xtr"].shape[0])


# -- disk-backed pools (CohortConfig.pool_dir) -------------------------------

_POOL_MANIFEST = "pool_manifest.json"
_POOL_DRAWS = "draws.pt"
_POOL_FIXED_LEAVES = (("phase.bin", np.int32, 1),
                      ("node_key.bin", np.uint32, 2),
                      ("touched.bin", np.bool_, 1),
                      ("inited.bin", np.uint8, 1))
# The port's own store format (neither package reads the other's stores).
_POOL_SCHEMA = "gossipy_tpu_torch.pool/1"


def is_mmap_pool(pool) -> bool:
    """True when any pool leaf is an ``np.memmap`` (a disk-backed pool)."""
    return any(isinstance(l, np.memmap)
               for l in _leaves(pool.model) + [pool.phase, pool.node_key,
                                              pool.touched])


def is_pool_store_dir(path) -> bool:
    """True when ``path`` is a :class:`PoolStore` directory (a live pool or
    a checkpoint): the ``load``/``init`` dispatch predicate."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, _POOL_MANIFEST))


def _write_manifest(path: str, manifest: dict):
    tmp = os.path.join(path, _POOL_MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(path, _POOL_MANIFEST))


def _read_manifest(path: str) -> dict:
    with open(os.path.join(path, _POOL_MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("schema") != _POOL_SCHEMA:
        raise ValueError(f"{path}: not a pool store of this package "
                         f"(schema {manifest.get('schema')!r})")
    return manifest


def fs_keeps_holes(path: str) -> bool:
    """Whether the filesystem under the directory ``path`` keeps a
    sparse file's holes: a 64 MiB probe with one 4 KiB block written
    must allocate under 1 MiB (``st_blocks``). Where it does not (a
    9p mount reports the apparent size), a disk pool still writes only
    its sampled rows, but ``st_blocks`` cannot show it."""
    fp = os.path.join(path, ".hole_probe")
    try:
        with open(fp, "wb") as f:
            f.truncate(64 << 20)
            f.seek(32 << 20)
            f.write(b"\1" * 4096)
        return os.stat(fp).st_blocks * 512 < (1 << 20)
    finally:
        if os.path.exists(fp):
            os.remove(fp)


def _alloc_sparse(fp: str, nbytes: int):
    """A hole-only file of ``nbytes`` apparent size (ftruncate): no block
    on disk until a row is written."""
    with open(fp, "wb") as f:
        f.truncate(int(nbytes))


def _sparse_copy(src: str, dst: str, chunk: int = 16 << 20):
    """Copy a file preserving holes (SEEK_DATA/SEEK_HOLE), so a pool
    checkpoint costs the written rows, not the apparent size; a dense
    copy where the OS lacks hole enumeration."""
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        size = os.fstat(fi.fileno()).st_size
        fo.truncate(size)
        if not hasattr(os, "SEEK_DATA"):
            shutil.copyfileobj(fi, fo, chunk)
            return
        pos = 0
        while pos < size:
            try:
                data = fi.seek(pos, os.SEEK_DATA)
            except OSError:  # ENXIO: no data past pos, a trailing hole
                break
            hole = fi.seek(data, os.SEEK_HOLE)
            fi.seek(data)
            fo.seek(data)
            left = hole - data
            while left > 0:
                buf = fi.read(min(chunk, left))
                if not buf:
                    break
                fo.write(buf)
                left -= len(buf)
            pos = hole


class PoolStore:
    """A :class:`CohortPool` whose leaves live in sparse files.

    Every leaf is an ``np.memmap`` (mode ``r+``) over a file under
    ``path``; the apparent size is the full nominal-N footprint, but disk
    blocks exist only for rows written, so nominal 100M is bounded by
    storage, not RAM. Gather and scatter touch the C sampled rows;
    :meth:`ensure_rows` initializes never-seen rows (tracked by the
    ``inited`` mask), each from its own numpy generator seeded with its
    ``node_key`` ``(store seed word, node id)``: deterministic per (store
    seed, id) and independent of the sampling order, but not the values
    of a RAM pool's blocked init. The pool object updates in place: a
    run's returned pool aliases the same files."""

    def __init__(self, sim, path: str, manifest: dict):
        self.path = os.path.abspath(path)
        n = int(manifest["nominal_n"])
        if n != int(sim.nominal_n):
            raise ValueError(
                f"pool store {self.path!r} holds nominal_n={n}, "
                f"simulator expects {sim.nominal_n}")
        for fld in ("sync", "delta"):
            if manifest[fld] != getattr(sim, fld):
                raise ValueError(
                    f"pool store {self.path!r} was built with "
                    f"{fld}={manifest[fld]!r}, simulator has "
                    f"{getattr(sim, fld)!r} (phase init would diverge)")
        self.manifest = manifest
        spec = _model_spec(sim)
        specs = manifest["model_leaves"]
        if len(specs) != len(spec):
            raise ValueError(
                f"pool store {self.path!r} holds {len(specs)} model "
                f"leaves, simulator's model has {len(spec)}")
        maps = []
        for s, (shape, dt) in zip(specs, spec):
            shape = (n,) + shape
            if tuple(s["shape"]) != shape or np.dtype(s["dtype"]) != dt:
                raise ValueError(
                    f"pool store leaf {s['file']} is "
                    f"{s['shape']}/{s['dtype']}; simulator expects "
                    f"{list(shape)}/{dt.name}")
            maps.append(self._open(s["file"], dt, shape))
        self.model = _unleaves(maps)
        self.phase = self._open("phase.bin", np.int32, (n,))
        self.node_key = self._open("node_key.bin", np.uint32, (n, 2))
        self.touched = self._open("touched.bin", np.bool_, (n,))
        self.inited = self._open("inited.bin", np.uint8, (n,))
        self.word = int(manifest["seed_word"])
        self._lock = threading.Lock()

    def _open(self, name: str, dtype, shape) -> np.memmap:
        return np.memmap(os.path.join(self.path, name), dtype=dtype,
                         mode="r+", shape=shape)

    def files(self) -> list[str]:
        return _store_files(self.manifest)

    def pool(self) -> CohortPool:
        return CohortPool(model=self.model, phase=self.phase,
                          node_key=self.node_key, touched=self.touched,
                          round=int(self.manifest["round"]))

    def _rows(self, sim, ids: np.ndarray):
        """The initial model leaves, node keys and phases of the rows
        ``ids``: row ``i`` from ``default_rng(SeedSequence(node_key))``,
        its model's uniforms (:meth:`~gossipy_tpu_torch.handlers.base.
        BaseHandler.init_rows`) then its phase; a handler that cannot
        block inits from a ``torch.Generator`` seeded by that numpy
        generator."""
        h = sim.handler
        keys = _node_keys(self.word, ids)
        rngs = [np.random.default_rng(np.random.SeedSequence(
            [int(a), int(b)])) for a, b in keys]
        b = len(ids)
        if self.manifest["common_init"]:
            g = torch.Generator().manual_seed(int(self.manifest[
                "common_seed"]))
            one = _init_block(sim, g, 1)
            model = [np.repeat(l, b, axis=0) for l in one]
        else:
            st = h.init_rows(b, lambda count, dtype: torch.from_numpy(
                np.stack([r.random(count, dtype=_np_dtype(dtype).type)
                          for r in rngs])) if count else
                torch.empty((b, 0), dtype=dtype))
            if st is None:
                rows = [h.init(torch.Generator().manual_seed(
                    int(r.integers(2 ** 63))), "cpu") for r in rngs]
                params = torch.stack([m.params for m in rows])
                st = ModelState(params, h.init_opt_state(params),
                                torch.stack([m.n_updates for m in rows]))
            model = [t.numpy().astype(dt, copy=False) for t, (_, dt) in
                     zip(_leaves(st), _model_spec(sim))]
        delta = int(self.manifest["delta"])
        if self.manifest["sync"]:
            phase = np.array([r.integers(0, delta) for r in rngs], np.int32)
        else:
            raw = np.array([delta + (delta / 10.0) * r.standard_normal()
                            for r in rngs])
            phase = np.maximum(raw.astype(np.int32), 1)
        return model, keys, phase

    def ensure_rows(self, sim, idx: np.ndarray) -> int:
        """Initialize the not-yet-initialized rows among ``idx`` (lazy
        init); returns how many."""
        idx = np.asarray(idx)
        with self._lock:
            need = idx[self.inited[idx] == 0]
            if need.size == 0:
                return 0
            model, keys, phase = self._rows(sim, need)
            for dst, src in zip(_leaves(self.model), model):
                dst[need] = src
            self.node_key[need] = keys
            self.phase[need] = phase
            self.inited[need] = 1
        return int(need.size)

    def rows_written(self) -> int:
        """Rows that hold data (initialized rows): what the files hold
        beyond their holes."""
        return int(np.count_nonzero(self.inited))

    def row_bytes(self) -> int:
        """Bytes one node takes across the store's files."""
        return sum(int(np.prod(l.shape[1:])) * l.dtype.itemsize
                   for l in _leaves(self.model) + [
                       self.phase, self.node_key, self.touched,
                       self.inited])

    def flush(self):
        for l in _leaves(self.model):
            l.flush()
        for l in (self.phase, self.node_key, self.touched, self.inited):
            l.flush()

    def set_round(self, r: int):
        self.manifest["round"] = int(r)
        _write_manifest(self.path, self.manifest)


def create_pool_store(sim, material, path: str,
                      common_init: bool = False) -> PoolStore:
    """A fresh disk-backed pool under ``path`` (sparse files and a
    manifest; no row is initialized until it is first sampled).
    ``material``: the seed's 32-bit words (the init generator's seed)."""
    n = int(sim.nominal_n)
    if n >= 2 ** 31:
        raise ValueError(f"pool store node ids are int32; nominal_n={n} "
                         "exceeds 2**31-1")
    os.makedirs(path, exist_ok=True)
    model_specs = []
    for i, (shape, dt) in enumerate(_model_spec(sim)):
        shape = (n,) + shape
        fname = f"model_{i:03d}.bin"
        _alloc_sparse(os.path.join(path, fname),
                      int(np.prod(shape)) * dt.itemsize)
        model_specs.append({"file": fname, "shape": list(shape),
                            "dtype": dt.name})
    for fname, dt, width in _POOL_FIXED_LEAVES:
        _alloc_sparse(os.path.join(path, fname),
                      n * width * np.dtype(dt).itemsize)
    material = [int(x) & 0xFFFFFFFF for x in material]
    manifest = {
        "schema": _POOL_SCHEMA,
        "nominal_n": n,
        "round": 0,
        "key_material": material,
        "seed_word": _seed_word(material),
        "common_init": bool(common_init),
        "common_seed": material[0] | (material[1] << 32)
        if len(material) > 1 else material[0],
        "sync": bool(sim.sync),
        "delta": int(sim.delta),
        "cohort": sim.cohort.to_dict(),
        "model_leaves": model_specs,
    }
    _write_manifest(path, manifest)
    return PoolStore(sim, path, manifest)


def open_pool_store(sim, path: str) -> PoolStore:
    """Open an existing store directory in place (writes go to its
    files): the resume path of ``init_cohort_pool``."""
    return PoolStore(sim, path, _read_manifest(path))


def _store_files(manifest: dict) -> list[str]:
    """The files of a store (or a checkpoint) beside its manifest."""
    return ([s["file"] for s in manifest["model_leaves"]]
            + [name for name, _, _ in _POOL_FIXED_LEAVES])


def _copy_store(src: str, dst: str, manifest: dict) -> None:
    """Hole-preserving copies of a store's files from ``src`` into
    ``dst``, the manifest written last (a half copy is no store)."""
    os.makedirs(dst, exist_ok=True)
    for name in _store_files(manifest):
        _sparse_copy(os.path.join(src, name), os.path.join(dst, name))
    _write_manifest(dst, manifest)


# -- a disk-backed pool on a mesh across ranks: one replica a rank -----------

def rank_pool_dir(path: str, rank: int) -> str:
    """Where rank ``rank`` of a mesh across ranks keeps its replica of the
    pool store (or the restored work directory) ``path``: ``path`` itself
    on rank 0, so that one process can resume it, and
    ``<path>.rank<rank>`` on every other rank."""
    path = os.path.abspath(path)
    return path if rank == 0 else f"{path}.rank{rank}"


def _across(sim) -> bool:
    """Whether ``sim`` runs on a mesh across ranks (it holds its rows)."""
    return getattr(sim, "_rows", None) is not None


def _on_every_rank(fn, mesh):
    """``fn()``, its failure made every rank's on a mesh across ranks:
    when it raises ``OSError`` or ``ValueError`` on any rank, every rank
    raises (that rank its own exception, the others a ``ValueError``
    naming it), so no rank waits in a later collective for one that
    left."""
    from ..parallel import every_rank
    try:
        out, err = fn(), None
    except (OSError, ValueError) as e:
        out, err = None, e
    seen = every_rank(None if err is None else
                      f"{type(err).__name__}: {err}", mesh)
    if err is not None:
        raise err
    for r, what in enumerate(seen):
        if what is not None:
            raise ValueError(f"the pool store failed on rank {r}: {what}")
    return out


def _rank0_is_store(sim, path: str) -> bool:
    """:func:`is_pool_store_dir` as rank 0 sees ``path`` on a mesh across
    ranks (every rank then takes the same restore path), as this process
    sees it otherwise."""
    from ..parallel import every_rank
    return bool(every_rank(is_pool_store_dir(path), sim.mesh)[0])


def _replica_store(sim, path: str, material, common_init: bool
                   ) -> PoolStore:
    """This rank's replica of the disk-backed pool ``path`` on a mesh
    across ranks (:func:`rank_pool_dir`): opened where it exists; else,
    when rank 0 holds a store, a hole-preserving copy of rank 0's files
    (the first collective is the barrier before it); else created from
    ``material``, as every rank creates its own. A rank that cannot see
    rank 0's store raises ``ValueError`` on every rank, and so does a
    replica whose manifest disagrees with rank 0's on ``round`` or
    ``seed_word``: it is never used."""
    from ..parallel import every_rank
    rank = torch.distributed.get_rank()
    mine, first = rank_pool_dir(path, rank), rank_pool_dir(path, 0)
    held = every_rank(is_pool_store_dir(mine), sim.mesh)

    def replica() -> PoolStore:
        if held[rank]:
            return open_pool_store(sim, mine)
        if rank and held[0]:
            if not is_pool_store_dir(first):
                raise ValueError(
                    f"rank {rank} cannot see rank 0's pool store {first!r} "
                    f"to make its replica {mine!r} from it (ranks without "
                    "a shared filesystem need their replicas in place)")
            _copy_store(first, mine, _read_manifest(first))
            return open_pool_store(sim, mine)
        return create_pool_store(sim, material, mine,
                                 common_init=common_init)

    store = _on_every_rank(replica, sim.mesh)
    seen = every_rank((store.path, int(store.manifest["round"]),
                       int(store.manifest["seed_word"])), sim.mesh)
    path0, round0, word0 = seen[0]
    for r, (p, rnd, word) in enumerate(seen):
        if (rnd, word) != (round0, word0):
            raise ValueError(
                f"the pool store replica {p!r} (rank {r}: round {rnd}, seed "
                f"word {word}) disagrees with rank 0's {path0!r} (round "
                f"{round0}, seed word {word0}); remove the stale replica, "
                "and the rank copies rank 0's store when it opens the pool")
    return store


def save_pool_store(sim, pool: CohortPool, path: str, draws=None) -> str:
    """Checkpoint a disk-backed pool: flush the memmaps, hole-preserving
    copies of its files into ``path``, the manifest stamped with the
    pool's round, and the draw state of ``draws`` beside it
    (``draws.pt``, as ``save_checkpoint`` keeps it).

    On a mesh across ranks every rank calls it: each flushes its replica,
    the ranks' draw states and rounds are held equal, rank 0 alone copies
    its files into ``path``, and every rank returns after a barrier."""
    from ..checkpoint import _digest, _same_on_every_rank, draw_record
    from ..parallel import is_writer, rank_barrier
    store: Optional[PoolStore] = getattr(sim, "_pool_store", None)
    if store is None:
        raise ValueError("no live PoolStore on this simulator; disk-"
                         "backed pools come from init_cohort_pool/load "
                         "with CohortConfig(pool_dir=...)")
    dst = os.path.abspath(path)
    mesh = sim.mesh

    def distinct():
        if dst == store.path:
            raise ValueError("pool checkpoint dir must differ from the "
                             f"live pool_dir {store.path!r}")

    _on_every_rank(distinct, mesh)
    with span("checkpoint.save", cat="checkpoint",
              tracer=getattr(sim, "tracer", None), path=str(path),
              pool_store=True):
        store.flush()
        rec = draw_record(draws)
        if _across(sim):
            _same_on_every_rank(f"{_digest(rec)} round {int(pool.round)}",
                                "draw state and pool round")
        if is_writer(mesh):
            os.makedirs(dst, exist_ok=True)
            if rec is not None:
                torch.save({"draws": rec}, os.path.join(dst, _POOL_DRAWS))
            _copy_store(store.path, dst,
                        dict(store.manifest, round=int(pool.round)))
        rank_barrier(mesh)
    return dst


def load_pool_checkpoint(sim, path: str, workdir: Optional[str] = None):
    """Restore ``(pool, draws)`` from a pool-store checkpoint directory.

    The files are hole-preserving-copied into ``workdir`` (default
    ``<path>.live``, replaced if present) and the store opened there, so
    continuing the run never mutates the checkpoint. A saved draw state
    goes into the simulator's own provider, returned as ``draws`` (None
    when the checkpoint kept none). On a mesh across ranks every rank
    reads the one checkpoint into its own work directory
    (:func:`rank_pool_dir` of ``workdir``); a rank that fails makes every
    rank raise."""
    src = os.path.abspath(path)
    rank = torch.distributed.get_rank() if _across(sim) else 0

    def restore() -> PoolStore:
        manifest = _read_manifest(src)
        dst = rank_pool_dir(workdir or (src.rstrip("/\\") + ".live"), rank)
        if dst != src:
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            _copy_store(src, dst, manifest)
        return PoolStore(sim, dst, dict(manifest))

    store = _on_every_rank(restore, sim.mesh)
    sim._pool_store = store
    draws = None
    rec_path = os.path.join(src, _POOL_DRAWS)
    if os.path.exists(rec_path):
        rec = torch.load(rec_path, weights_only=True)["draws"]
        sim.draws.set_state(rec["state"])
        draws = sim.draws
    elif sim.draws.get_state() is not None:
        raise ValueError(
            f"pool checkpoint {path} keeps no draw state, and "
            f"{type(sim.draws).__name__} cannot resume without it: save "
            "with draws= (as sim.save does)")
    return store.pool(), draws


# -- cohort sampling ---------------------------------------------------------

def sample_cohort(material, round0: int, n: int, c: int) -> np.ndarray:
    """The round-``round0`` cohort: C distinct node ids, deterministic in
    ``(material, round0)`` (a list of integers, the draw provider's
    ``cohort_seed_material``), sorted ascending. The JAX package's
    ``sample_cohort`` for the same material gives the same ids: at C <<
    N rejection-sampled uniques (no O(N) permutation), at ``8 C >= N``
    numpy's exact choice, at ``C >= N`` everyone."""
    ss = np.random.SeedSequence([int(x) for x in material] + [int(round0)])
    rng = np.random.default_rng(ss)
    if c >= n:
        return np.arange(n, dtype=np.int64)
    if c * 8 >= n:
        return np.sort(rng.choice(n, c, replace=False).astype(np.int64))
    out = np.unique(rng.integers(0, n, int(c * 1.1) + 16))
    while out.size < c:
        out = np.unique(np.concatenate(
            [out, rng.integers(0, n, c)]))
    rng.shuffle(out)  # drop the unique-sort's small-id bias before cutting
    return np.sort(out[:c])


def _local_neighbor_table(sim, idx: np.ndarray) -> np.ndarray:
    """``[C, max_deg]`` cohort-LOCAL neighbour slots for
    ``peer_mode='induced'``: the global table's cohort rows, keeping the
    entries that are themselves in the cohort, every other ``-1``."""
    n = sim.nominal_n
    nbr = sim._cohort_nbr_global[idx]  # [C, max_deg] global ids / -1
    pos = np.full(n, -1, dtype=np.int32)
    pos[idx] = np.arange(idx.size, dtype=np.int32)
    local = np.where(nbr >= 0, pos[np.clip(nbr, 0, n - 1)], -1)
    return local.astype(np.int32)


# -- the driver --------------------------------------------------------------

class _Staged:
    """One staged cohort: its ids (``whole``, and ``idx`` those of this
    rank's rows), the slot of host buffers its pool rows are gathered
    into, and the gather's job on the row worker (None once waited for,
    or when it ran inline)."""

    __slots__ = ("s", "r0", "seg", "whole", "idx", "idx_t", "slot", "host",
                 "job", "base", "ts_us")


class _Out:
    """One segment's durable outputs on the host: ``(idx, model leaves,
    phase)`` as CPU tensors in a slot of host buffers; on the card the
    copies are in flight until :meth:`wait` (the event recorded after
    them)."""

    __slots__ = ("r0", "seg", "idx", "host", "event", "job", "ts_us")

    def wait(self) -> "_Out":
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self


class _Slots:
    """Host buffers allocated once and reused segment after segment:
    ``n`` slots of one ``[rows, ...]`` buffer a leaf (pinned on the card,
    the source or the target of an asynchronous copy), and for each slot
    the event after the last copy that reads it, waited on before the slot
    is written again."""

    def __init__(self, leaves: list, rows: int, n: int, pinned: bool):
        self.bufs = [[torch.empty((rows,) + tuple(l.shape[1:]),
                                  dtype=_torch_dtype(l.dtype),
                                  pin_memory=pinned) for l in leaves]
                     for _ in range(n)]
        self.events: list = [None] * n

    def take(self, s: int) -> tuple[int, list]:
        i = s % len(self.bufs)
        ev = self.events[i]
        if ev is not None:
            ev.synchronize()
            self.events[i] = None
        return i, self.bufs[i]


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _mesh_fingerprint(mesh):
    """Hashable mesh identity: its axes and its positions (device, rank,
    id)."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names),
            tuple((str(p.device), int(p.rank), int(p.id))
                  for p in np.ravel(mesh.devices)))


def _validate_cohort_mesh(sim, mesh) -> None:
    """Cohort rounds on a mesh need C to split evenly over the node axis
    (the registry's rules put every [C]-leading leaf there)."""
    from ..parallel import rules as _rules
    span_sz = _rules.node_axis_size(mesh)
    c = int(sim.cohort.size)
    if c % span_sz:
        raise ValueError(
            f"cohort size {c} is not divisible by the mesh node-axis "
            f"extent {span_sz} (axes {_rules.node_axis_entry(mesh)!r}); "
            "sharded gather/scatter needs equal per-device rows")


# The trace track of the native row worker's gathers and scatters.
_ROWS_TID = 1000


def _worker_span(tr, name: str, t0: float, t1: float, r0: int) -> None:
    """A span of the row worker, whose ``t0``/``t1`` are on the
    ``perf_counter`` clock, on the tracer's timeline."""
    if tr is None:
        return
    now = time.perf_counter()
    tr.add_complete(name, tr._now_us() + (t0 - now) * 1e6, (t1 - t0) * 1e6,
                    cat="cohort", tid=_ROWS_TID, args={"window": r0})


def cohort_start(sim, pool: CohortPool, n_rounds: int, mesh=None):
    """Run ``n_rounds`` active-cohort rounds against the resident pool.

    A host-driven segment loop: per segment, take the cohort
    (deterministic in the seed material and the absolute round; the run's
    schedule is drawn up front), gather its pool rows, build the ``[C]``
    state (``init_state`` at round ``r0``, the ring holding the gathered
    params), run the segment's rounds (the run's last absolute round
    evaluates), copy the durable outputs off the card and scatter them
    into the pool. Returns ``(pool, SimulationReport)``: the engine's
    per-round arrays at cohort width plus ``cohort_coverage`` and
    ``cohort_active_nodes``. The caller's RAM pool is not mutated; a
    disk-backed pool updates in place.

    ``CohortConfig(prefetch=k)`` pipelines the loop (module doc), with
    the same result bit for bit. ``mesh`` places each segment's ``[C]``
    state and data rows per the partition-rule registry
    (:func:`~gossipy_tpu_torch.parallel.shard_state`); C must divide its
    node axis.

    On a mesh across ranks (the simulator's own: ``GossipSimulator(
    cohort=..., mesh=)``, whose rounds then run the ring deliver) every
    rank holds the whole pool, built from the same generator (a
    disk-backed pool: its own replica of the store, whose lazy rows it
    initializes for the whole cohort), and draws the same schedule. A
    rank stages only its rows of each cohort
    (``sim._rows`` of the ``[C]`` axis) and runs the segment's rounds on
    them; the durable outputs are gathered whole in one all-gather
    (:func:`~gossipy_tpu_torch.parallel.gather_rows`), and every rank
    scatters the whole cohort into its own pool, so the pools stay
    equal. The rows a staged cohort shares with the one in flight are
    taken from those gathered outputs. Every collective is issued from
    this thread, in the same order on every rank; the row worker issues
    none.
    """
    from ..native import rows as native_rows
    from ..ops import _build

    if not isinstance(pool, CohortPool):
        raise TypeError(
            "cohort mode takes the resident CohortPool (init_cohort_pool), "
            f"got {type(pool).__name__}")
    cfg: CohortConfig = sim.cohort
    c, n = cfg.size, sim.nominal_n
    across = sim._rows is not None
    if across or (mesh is not None and mesh.spans_ranks()):
        from ..parallel import _same_mesh
        if not across or (mesh is not None
                          and not _same_mesh(mesh, sim.mesh)):
            raise ValueError(
                "a cohort's rounds across ranks run on the simulator's own "
                "mesh: build it with GossipSimulator(cohort=..., mesh=) "
                "and pass that mesh (or none) to start")
        mesh = sim.mesh
    if mesh is not None:
        _validate_cohort_mesh(sim, mesh)
        from .. import parallel as _parallel
    # This rank's rows of each cohort (every row off a mesh across ranks).
    mine = sim._rows if across else slice(None)
    p_rows = _pool_data_rows(sim)
    first_round = int(pool.round)
    last_round = first_round + n_rounds - 1
    depth = int(cfg.prefetch)
    dev = sim.device
    cuda = dev.type == "cuda"

    if sim.has_live_receivers():
        warnings.warn("cohort mode has no in-run host callback path; live "
                      "event receivers fall back to post-run replay")

    store: Optional[PoolStore] = getattr(sim, "_pool_store", None)
    if is_mmap_pool(pool):
        if store is None:
            raise ValueError(
                "mmap-backed pool has no live PoolStore on this "
                "simulator; obtain the pool from init_cohort_pool/load "
                "with CohortConfig(pool_dir=...) — the store owns lazy "
                "row init")
    else:
        store = None

    pool = _host_pool(pool, copy=store is None)
    model_leaves = _leaves(pool.model)
    leaves = model_leaves + [pool.phase]
    k = len(model_leaves)
    touched = pool.touched
    touched_count = int(np.count_nonzero(touched))
    rows_all: list = []
    coverage: list[float] = []
    tr = sim.tracer
    induced = cfg.peer_mode == "induced"
    material = sim.draws.cohort_seed_material()
    bank = dict(sim.data)
    pernode_keys = [key for key in bank if key not in ("x_eval", "y_eval")]
    eval_data = {key: v for key, v in bank.items()
                 if key in ("x_eval", "y_eval")}
    if sim.sentinels is not None and sim._health_carry is None:
        sim._health_carry = sim._health_zero_carry()
    loaded = len(_build._LOADED)

    plan: list[tuple[int, int]] = []
    done = 0
    while done < n_rounds:
        seg = min(cfg.rounds_per_cohort, n_rounds - done)
        plan.append((first_round + done, seg))
        done += seg
    # The run's cohort schedule, drawn up front before the first launch
    # (it depends on the seed material and the round alone).
    with span("cohort.schedule", cat="cohort", tracer=tr,
              segments=len(plan)):
        schedule = [sample_cohort(material, r0, n, c) for r0, _ in plan]
    rows_c = schedule[0].size if schedule else 0
    # Host buffers a slot: the staged gathers (up to depth + 1 cohorts
    # staged at once; a rank's rows of each) and the outputs (the whole
    # cohort; kept until scattered and past the launch-time patches of
    # the next depth + 1 segments).
    stage_slots = _Slots(leaves, len(range(rows_c)[mine]), depth + 2, cuda)
    out_slots = _Slots(leaves, rows_c, depth + 3, cuda)
    worker = native_rows.Worker() if depth > 0 else None
    if worker is not None and tr is not None:
        tr._meta(tr.pid, _ROWS_TID, "thread_name", {"name": "cohort-rows"})

    def data_rows(idx_t: torch.Tensor) -> dict:
        """The cohort's per-node data: row ``i % P`` of the bank."""
        rows = idx_t % p_rows
        return {key: bank[key][rows] for key in pernode_keys}

    def gather(s: int) -> _Staged:
        """Take segment ``s``'s cohort and gather its pool rows into a
        stage slot: inline when serial, else queued on the row worker,
        behind every scatter queued before it."""
        st = _Staged()
        st.s, (st.r0, st.seg) = s, plan[s]
        with span("cohort.sample", cat="cohort", tracer=tr,
                  window=st.r0) as sp_s:
            st.whole = schedule[s]
            st.idx = st.whole[mine]
            st.idx_t = torch.from_numpy(st.idx)
            if store is not None:
                # The whole cohort, not only this rank's rows: every rank
                # scatters the whole cohort into its replica, and a row
                # left uninitialized there would be initialized over its
                # trained values when a later cohort gives it to this rank.
                store.ensure_rows(sim, st.whole)
            # The slot's last upload must have read it.
            st.slot, st.host = stage_slots.take(s)
        st.ts_us = sp_s.ts_us
        st.job = None
        if worker is None:
            with span("cohort.gather", cat="cohort", tracer=tr,
                      window=st.r0):
                native_rows.gather(leaves, st.host, st.idx)
        else:
            st.job = worker.gather(leaves, st.host, st.idx)
        return st

    def prepare(st: _Staged, newer: list, carry=None) -> tuple:
        """Patch in the outputs ``newer`` than the gather (ascending, so
        the newest write wins, as in the serial loop), copy the rows to the
        card and build the [C] state and its data rows:
        ``(state, data)``. ``carry``, ``(prev_leaves, prev_idx)``, is the
        cohort whose rounds are still in flight: the rows it shares with
        this one are taken from its final durable leaves on the device
        (the whole cohort's, gathered, on a mesh across ranks), the rows a
        serial gather would read from the pool after its scatter."""
        if st.job is not None:
            t0, t1, _ = worker.wait(st.job)
            _worker_span(tr, "cohort.gather", t0, t1, st.r0)
            st.job = None
        with span("cohort.stage", cat="cohort", tracer=tr, window=st.r0):
            for out in newer:
                native_rows.patch(st.host, st.idx, out.wait().host, out.idx)
            host = st.host + [st.idx_t] + (
                [torch.from_numpy(_local_neighbor_table(sim, st.whole)[mine])]
                if induced else [])
            vals = [t.to(dev, non_blocking=cuda) for t in host]
            if cuda:
                # The slot is free again once these copies have read it.
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                stage_slots.events[st.slot] = ev
            if carry is not None:
                prev_leaves, prev_idx = carry
                # Host ids of the two cohorts (no tensor).
                found = np.intersect1d(  # tracelint: disable=np-in-round
                    st.idx, prev_idx, assume_unique=True,
                    return_indices=True)
                _, pos, pos_prev = found
                if pos.size:
                    at = torch.from_numpy(pos.astype(np.int64)).to(dev)
                    src = torch.from_numpy(pos_prev.astype(np.int64)).to(dev)
                    for v, t in zip(vals[:k + 1], prev_leaves):
                        v.index_copy_(0, at, t.index_select(0, src).to(
                            v.dtype))
            state = sim.init_state(_unleaves(vals[:k]), vals[k])
            state.round = st.r0
            if induced:
                state.aux["cohort_nbr"] = vals[k + 2]
            data_c = dict(eval_data)
            data_c.update(data_rows(vals[k + 1]))
            if mesh is not None and not across:
                # (Across ranks init_state records this rank's rows.)
                state = _parallel.shard_state(state, mesh)
                data_c = _parallel.shard_data(data_c, mesh)
        return state, data_c

    def run(st: _Staged, state, data_c, on_run=None, ahead=None) -> _Out:
        """Run the segment's rounds and start the copy of the durable
        outputs off the card. ``on_run`` is called as the rounds start,
        ``ahead`` once they are launched, before the host waits for them
        (where streaming stages the next cohort), with the durable leaves
        of the whole cohort (gathered on a mesh across ranks)."""
        r0, seg = st.r0, st.seg
        if on_run is not None:
            on_run()
        with span("cohort.run", cat=WAIT_CAT, tracer=tr,
                  window=r0) as sp_r:
            sim.data = data_c
            try:
                for _ in range(seg):
                    rows_all.append(sim._run_round(state, last_round))
            finally:
                sim.data = bank
            final = _leaves(state.model) + [state.phase]
            if across:
                with span("cohort.gather_outputs", cat="cohort", tracer=tr,
                          window=r0):
                    final = _parallel.gather_rows(final, mesh)
            if ahead is not None:
                ahead(final)
            if tr is not None and cuda:
                # The run span closes at the execution's end, not at
                # the last launch.
                torch.cuda.synchronize(dev)
        if tr is not None:
            attach_device_spans(tr, sp_r.ts_us, sp_r.dur_us,
                                args={"segment_rounds": seg, "window": r0})
        out = _Out()
        out.r0, out.seg, out.idx, out.ts_us = r0, seg, st.whole, st.ts_us
        out.job = out.event = None
        with span("cohort.fetch", cat="cohort", tracer=tr, window=r0):
            _, out.host = out_slots.take(st.s)
            for b, t in zip(out.host, final):
                b.copy_(t, non_blocking=cuda)
            if cuda:
                out.event = torch.cuda.Event()
                out.event.record(torch.cuda.current_stream(dev))
        return out

    def count(out: _Out, newly: int) -> None:
        """A scattered segment's coverage (in segment order)."""
        nonlocal touched_count
        touched_count += newly
        coverage.extend([touched_count / float(n)] * out.seg)

    sp_all = span("cohort.start", cat="cohort", tracer=tr,
                  total_rounds=n_rounds, cohort_size=c, prefetch=depth)
    with sp_all:
        if worker is None:
            for s, (r0, seg) in enumerate(plan):
                with span("cohort.segment", cat="cohort", tracer=tr,
                          round_start=r0, rounds=seg):
                    st = gather(s)
                    out = run(st, *prepare(st, []))
                    out.wait()
                    with span("cohort.scatter", cat="cohort", tracer=tr,
                              window=r0):
                        newly = native_rows.scatter(leaves, out.host,
                                                    out.idx, touched)
                    count(out, newly)
        else:
            try:
                _stream(plan, depth, worker, gather, prepare, run,
                        count, leaves, touched, out_slots, tr)
            finally:
                worker.close()

    extra = {"cohort_coverage": np.asarray(coverage, np.float32),
             "cohort_active_nodes": np.full((n_rounds,), c, np.int32)}
    perf_timing = sim.perf is not None and sim.perf.timing
    report = sim._finish_run(
        first_round, rows_all, n_rounds,
        sp_all.duration if perf_timing else None,
        len(_build._LOADED) != loaded, extra=extra, include_live=True)

    if store is not None:
        # A live disk-backed pool keeps its round counter, so a re-opened
        # pool_dir resumes where the run left off.
        store.flush()
        store.set_round(first_round + n_rounds)
    new_pool = CohortPool(model=pool.model, phase=pool.phase,
                          node_key=pool.node_key, touched=touched,
                          round=first_round + n_rounds)
    return new_pool, report


def _stream(plan, depth, worker, gather, prepare, run, count, leaves,
            touched, out_slots, tr) -> None:
    """The streaming loop. The row worker runs gathers and scatters in the
    order they are queued, on a native thread that never takes the GIL;
    this thread stages each cohort while the previous segment's rounds
    are in flight.

    At segment ``s``: the scatter of ``s - 1`` (its copy off the card
    done) and the gathers of the cohorts up to ``s + depth`` are queued as
    ``s``'s rounds start, so they run behind the rounds; a gather sees
    every output scattered before it (``base``, the last such segment).
    Once ``s``'s rounds are launched, and before the host waits for them,
    cohort ``s + 1`` is staged: its gather waited for, the host outputs
    newer than its ``base`` patched in (newest last), its [C] state built,
    and the rows it shares with cohort ``s`` taken from ``s``'s final
    durable leaves on the device (``prepare``'s ``carry``; on a mesh
    across ranks the whole cohort's, gathered), so the staged state is
    what a serial gather would build: the streaming ≡ serial bit-identity
    hinges on it. Scatters finish in order; each adds its coverage and
    closes its segment's trace window."""
    n_seg = len(plan)
    staged: dict = {}
    outs: dict = {}          # segment -> _Out, until no stage needs it
    scattered = -1           # the last segment whose scatter is queued
    collected = -1           # the last segment whose scatter is waited for
    gathered = -1            # the last segment whose gather is queued

    def collect(upto: int) -> None:
        nonlocal collected
        while collected < min(upto, scattered):
            collected += 1
            out = outs[collected]
            t0, t1, newly = worker.wait(out.job)
            _worker_span(tr, "cohort.scatter", t0, t1, out.r0)
            count(out, newly)
            if tr is not None and out.ts_us is not None:
                # Streaming windows overlap in time: each is one complete
                # event, [sample start, scatter end].
                end = tr._now_us() + (t1 - time.perf_counter()) * 1e6
                tr.add_complete("cohort.segment", out.ts_us,
                                end - out.ts_us, cat="cohort",
                                args={"round_start": out.r0,
                                      "rounds": out.seg, "streaming": True})

    def queue(s: int) -> None:
        """Queue the scatter of ``s - 1``, then the gathers up to
        ``s + depth``."""
        nonlocal scattered, gathered
        if s > 0:
            out = outs[s - 1].wait()
            out.job = worker.scatter(leaves, out.host, out.idx, touched)
            scattered = s - 1
        while gathered < min(s + depth, n_seg - 1):
            gathered += 1
            staged[gathered] = gather(gathered)
            staged[gathered].base = scattered

    def stage(j: int, carry=None) -> tuple:
        st = staged.pop(j)
        return st, prepare(st, [outs[o] for o in sorted(outs)
                                if st.base < o < j - 1], carry)

    queue(0)
    st, (state, data_c) = stage(0)
    for s in range(n_seg):
        nxt = {}

        def ahead(final, s=s, st=st, nxt=nxt):
            # Stage cohort s + 1 behind s's rounds.
            if s + 1 < n_seg:
                st1, (state1, data1) = stage(s + 1, (final, st.whole))
                nxt["staged"] = (st1, state1, data1)

        collect(s - len(out_slots.bufs))
        outs[s] = run(st, state, data_c, on_run=lambda s=s: queue(s),
                      ahead=ahead)
        for o in [o for o in outs if o <= collected and o < s - depth - 1]:
            del outs[o]
        if s + 1 < n_seg:
            st, state, data_c = nxt["staged"]
    queue(n_seg)
    collect(n_seg - 1)
