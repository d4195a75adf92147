"""Meshes of positions and node-axis placement.

Counterpart of ``gossipy_tpu/parallel/__init__.py``. A :class:`Mesh` is
an array of **positions** with named axes: a position is a
``torch.device`` and the rank of the process that owns it (0 without a
process group). The node axis of the simulator's state is a mesh axis:
:func:`state_shardings` resolves every state leaf's placement from the
rule registry (:mod:`~gossipy_tpu_torch.parallel.rules`), and the ring
collectives (:mod:`~gossipy_tpu_torch.parallel.collectives`) run the
gossip exchange and ring attention over the positions, one hop at a
time, with the chunks rotating from position to position.

A **virtual mesh** is one whose positions repeat one device
(``make_mesh(4, devices=["cuda"] * 4)``): the counterpart of the JAX
package's test mesh of virtual CPU devices
(``--xla_force_host_platform_device_count``), and how a mesh runs on a
machine with one card. The ring algorithms, their per-hop kernels and
their numerics are the real ones there; only the speed of a link
between cards is not.

A **mesh across ranks** is one whose positions belong to several
processes of a process group (:func:`init_distributed`, then
``make_mesh()`` over :func:`devices`): the counterpart of the JAX
package's multi-controller mesh. Each rank owns a contiguous run of the
node axis (:meth:`Mesh.node_rows`) on its one device
(:meth:`Mesh.local_device`), and the chunks cross processes over the
group's transport (:attr:`Mesh.transport`: NCCL for ranks on cards of
their own, gloo for ranks that share a card or run on the CPU).

Placement: on a virtual mesh :func:`shard_state` and :func:`shard_data`
keep every leaf a whole tensor on the mesh's device; on a mesh across
ranks they keep this rank's rows of every node-axis leaf (``[N, ...]``
becomes ``[N/R, ...]``, ``[D, N, ...]`` becomes ``[D, N/R, ...]``) and
every replicated leaf whole. Either way each leaf's resolved placement
and global shape are recorded (:func:`sharding_of`). The positions of
ONE process on several cards are refused: that needs a machine with
several cards (ROADMAP.md queue 1 item 13).

A mesh across ranks may take the JAX package's multi-controller
layouts: a ``(nodes, model)`` mesh from :func:`make_mesh_tp` (each
model-axis row within one rank; the model axis places the parameter
leaves and every rank keeps its nodes' whole rows) and a ``(dcn,
nodes)`` mesh from :func:`make_mesh_2d` (the node axis is the flattened
pair, each rank a contiguous run of it). A rank may own several
positions of either, as ``Position(device, rank, id)`` entries of one
device.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import weakref
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import rules
from .rules import (  # re-exported: the registry is the placement API
    DATA_RULES,
    DCN_AXIS,
    MODEL_AXIS,
    NODE_AXIS,
    NamedSharding,
    PartitionSpec,
    RuleSpec,
    STATE_RULES,
    UnmatchedLeafError,
    make_shard_and_gather_fns,
    match_partition_rules,
    partition_specs,
    tree_map_with_path,
)

__all__ = [
    "NODE_AXIS", "DCN_AXIS", "MODEL_AXIS",
    "STATE_RULES", "DATA_RULES", "RuleSpec", "UnmatchedLeafError",
    "match_partition_rules", "partition_specs", "make_shard_and_gather_fns",
    "init_distributed", "make_mesh", "make_mesh_2d", "make_mesh_tp",
    "state_shardings", "shard_state", "shard_data",
    "Mesh", "Position", "PartitionSpec", "NamedSharding", "devices",
    "sharding_of", "ring_positions", "record_local_state",
    "choose_transport", "ACROSS_RANKS_LEFT", "gather_state", "is_writer",
    "rank_barrier", "every_rank", "gather_rows", "local_state",
]

# What is left of ROADMAP.md queue 1 item 13, in its order: each use
# still refused on a mesh across ranks names the entry it waits for.
ACROSS_RANKS_LEFT = {
    "cards": "4, NCCL ranks on cards of their own and one process on "
             "several cards",
}

# What a mesh of one process on several devices waits for.
_ACROSS_CARDS = ("the positions of one process on several devices (or on "
                 "another device than the simulator's) are not ported "
                 "(ROADMAP.md queue 1 item 13, left "
                 + ACROSS_RANKS_LEFT["cards"] + ": several cards need a "
                 "machine with several cards); use make_mesh(n, "
                 "devices=[dev] * n) in one process, or one device a rank "
                 "across processes")


class Position(NamedTuple):
    """One mesh position: its device, the rank of the process that owns
    it, and its index in the device list the mesh was made from."""

    device: torch.device
    rank: int = 0
    id: int = 0

    @property
    def process_index(self) -> int:
        return self.rank


def canonical_device(dev) -> torch.device:
    """``dev`` as a ``torch.device`` with its index (``cuda`` is the
    current card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _group_up() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """Positions laid out over named axes (``jax.sharding.Mesh``'s
    counterpart): ``devices`` is the ndarray of :class:`Position`,
    ``axis_names`` the axes, ``shape`` the axis sizes as a dict.
    ``transport`` is how chunks cross processes on a mesh across ranks
    (the process group's backend, ``"gloo"`` or ``"nccl"``; None on a
    one-process mesh, or with no process group up)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for ix, p in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[ix] = p if isinstance(p, Position) else Position(
                canonical_device(p), _rank(), int(np.ravel_multi_index(
                    ix, arr.shape)) if arr.shape else 0)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D positions for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.transport = (torch.distributed.get_backend()
                          if self.spans_ranks() and _group_up() else None)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def positions(self) -> list:
        return list(self.devices.ravel())

    def ranks(self) -> list:
        """The ranks that own positions, sorted."""
        return sorted({p.rank for p in self.positions})

    def spans_ranks(self) -> bool:
        """True when the positions belong to more than one process."""
        return len(self.ranks()) > 1

    def is_virtual(self) -> bool:
        """True when every position names one device of this process."""
        me = _rank()
        return (len({p.device for p in self.positions}) == 1
                and all(p.rank == me for p in self.positions))

    def device(self) -> torch.device:
        """The one device of a virtual mesh; raises on any other mesh (on a
        mesh across ranks, :meth:`local_device` is this rank's)."""
        if not self.is_virtual():
            raise NotImplementedError(_ACROSS_CARDS)
        return self.positions[0].device

    def local_positions(self) -> list:
        """This process's positions, in mesh order."""
        me = _rank()
        return [p for p in self.positions if p.rank == me]

    def local_device(self) -> torch.device:
        """The one device of this process's positions: the device of a
        virtual mesh, or this rank's on a mesh across ranks. One process's
        positions on several devices are refused."""
        devs = {p.device for p in self.local_positions()}
        if not devs:
            raise ValueError(f"this process (rank {_rank()}) owns no "
                             "position of the mesh")
        if len(devs) > 1:
            raise NotImplementedError(_ACROSS_CARDS)
        return devs.pop()

    def node_rows(self, n: int, axis_name=None) -> slice:
        """This rank's rows of an ``n``-row node axis: its positions'
        rows, a contiguous run in ring order (every row on a one-process
        mesh)."""
        ring = ring_positions(self, axis_name)
        if n % len(ring):
            raise ValueError(f"{n} rows do not split over the "
                             f"{len(ring)} positions of the node axis")
        me = _rank()
        mine = [m for m, p in enumerate(ring) if p.rank == me]
        if not mine:
            raise ValueError(f"this process (rank {me}) owns no position "
                             "of the node axis")
        if mine != list(range(mine[0], mine[0] + len(mine))):
            raise ValueError(f"rank {me}'s positions {mine} are not "
                             "contiguous along the node axis")
        per = n // len(ring)
        return slice(mine[0] * per, (mine[-1] + 1) * per)

    def check_across_ranks(self) -> None:
        """Raise unless this mesh across ranks can run here: a process
        group up and owning every rank, a transport that carries this
        rank's device, one device a rank, the same count of node-axis
        positions on every rank, and every row of a model axis within one
        rank (as :func:`make_mesh_tp` lays it out: a rank then holds whole
        rows of every node, each model-axis position among its own)."""
        if not _group_up():
            raise RuntimeError(
                f"{self!r} spans ranks {self.ranks()} but no process group "
                "is up: call parallel.init_distributed(address, world, "
                "rank) first")
        world = torch.distributed.get_world_size()
        if self.ranks() != list(range(world)):
            raise ValueError(f"{self!r} spans ranks {self.ranks()}, the "
                             f"process group has {world}")
        model = rules.model_axis_entry(self)
        if model is not None:
            ax = self.axis_names.index(model)
            lines = np.moveaxis(self.devices, ax, -1).reshape(
                -1, self.devices.shape[ax])
            if any(len({p.rank for p in line}) > 1 for line in lines):
                raise ValueError(f"{self!r}: a row of the model axis spans "
                                 "two ranks; build the mesh with "
                                 "make_mesh_tp, which keeps each row "
                                 "within one process")
        dev = self.local_device()
        transport = torch.distributed.get_backend()
        if transport == "nccl" and dev.type != "cuda":
            raise ValueError(f"the NCCL transport cannot carry {dev}; "
                             "ranks on the CPU join by gloo")
        ring = ring_positions(self)
        counts = {r: sum(p.rank == r for p in ring) for r in self.ranks()}
        if len(set(counts.values())) != 1:
            raise ValueError(f"node-axis positions a rank {counts}: every "
                             "rank must own as many")
        self.node_rows(len(ring))

    def __repr__(self) -> str:
        devs = sorted({str(p.device) for p in self.positions})
        extra = "" if self.transport is None else \
            f", transport={self.transport!r}"
        return (f"Mesh({self.shape}, devices={devs}, "
                f"ranks={self.ranks()}{extra})")


def ring_positions(mesh: Mesh, axis_name=None) -> list:
    """The positions a ring over the node axis (``axis_name``, default the
    mesh-derived node placement) visits, in ring order: the flattened
    order of the ring's axes, at index 0 along any other axis."""
    entry = rules.node_axis_entry(mesh, axis_name)
    names = entry if isinstance(entry, tuple) else (entry,)
    axes = [mesh.axis_names.index(a) for a in names]
    rest = [i for i in range(len(mesh.axis_names)) if i not in axes]
    arr = np.transpose(mesh.devices, axes + rest)
    arr = arr.reshape((-1,) + arr.shape[len(axes):])
    return list(arr[(slice(None),) + (0,) * len(rest)])


def _card_identity(dev: torch.device) -> str:
    """A name of ``dev`` that two processes on one card share and two
    cards never do: the card's UUID (its host and bus id where torch does
    not give one), or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return f"cuda-{uuid}"
    bus = getattr(props, "pci_bus_id", dev.index)
    return f"cuda-{socket.gethostname()}-{bus}"


def choose_transport(identities: Sequence[str]) -> str:
    """The backend for ranks on these devices (:func:`_card_identity`, one
    a rank): NCCL when every rank has a card of its own, gloo when two
    share a card or one runs on the CPU (NCCL refuses two ranks on one
    card)."""
    ids = list(identities)
    if all(i != "cpu" for i in ids) and len(set(ids)) == len(ids):
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None, **kwargs) -> str:
    """Join (or form) a process group before building a mesh over several
    processes, and return its backend.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there),
    ``num_processes`` the world size and ``process_id`` this process's
    rank; ``device`` is the device this rank runs on (default: the
    package's device, the current card, which raises when none is
    visible; pass ``device="cpu"`` for ranks on the host; a card is made
    the current one). Unless ``backend=`` names one, the backend follows
    where the ranks are: every rank's device is exchanged over a store at
    the address first, then NCCL when each rank has a card of its own,
    gloo when ranks share a card or run on the CPU
    (:func:`choose_transport`). ``timeout=`` (a ``timedelta``) bounds the
    exchange and the group's operations; other keywords pass through to
    ``torch.distributed.init_process_group``. After it, :func:`devices`
    lists every rank's positions."""
    dist = torch.distributed
    backend = kwargs.pop("backend", None)
    timeout = kwargs.get("timeout") or datetime.timedelta(minutes=10)
    from .. import resolve_device
    dev = canonical_device(resolve_device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        # The launcher's environment (MASTER_ADDR, RANK, ...) forms the
        # group; the backend follows this rank's device alone.
        dist.init_process_group(backend or (
            "nccl" if dev.type == "cuda" else "gloo"), **kwargs)
        return dist.get_backend()
    addr = coordinator_address.split("://")[-1]
    host, port = addr.rsplit(":", 1)
    world, rank = int(num_processes), int(process_id)
    store = dist.TCPStore(host, int(port), world, rank == 0, timeout=timeout)
    store.set(f"gossipy/device/{rank}", _card_identity(dev))
    keys = [f"gossipy/device/{r}" for r in range(world)]
    store.wait(keys, timeout)
    ids = [store.get(k).decode() for k in keys]
    fits = choose_transport(ids)
    if backend is None:
        backend = fits
    elif backend == "nccl" and fits != "nccl":
        raise ValueError(f"NCCL cannot join ranks on {ids}: two ranks share "
                         "a card or one runs on the CPU; use gloo")
    dist.init_process_group(backend, store=dist.PrefixStore("group", store),
                            world_size=world, rank=rank, **kwargs)
    return backend


def _local_devices(device=None) -> list:
    if device is not None:
        return [canonical_device(device)]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass devices('cpu') "
                           "or device='cpu' to run on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def devices(device=None) -> list:
    """The visible positions: every card of this process (``device=None``)
    or ``device`` alone (``"cpu"``); with a process group up, every
    rank's, in rank order."""
    local = _local_devices(device)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in local])
        out = []
        for rank, devs in enumerate(gathered):
            for d in devs:
                out.append(Position(torch.device(d), rank, len(out)))
        return out
    return [Position(d, 0, i) for i, d in enumerate(local)]


_visible = devices


def _positions(devs) -> list:
    """A device list as positions (devices and strings owned by this
    process), ids by list order."""
    out = []
    for i, d in enumerate(devs):
        if isinstance(d, Position):
            out.append(d)
        else:
            out.append(Position(canonical_device(d), _rank(), i))
    return out


def make_mesh(n_devices: Optional[int] = None, axis_name: str = NODE_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` positions of ``devices``
    (default :func:`devices`). A list that repeats one device makes a
    virtual mesh: ``make_mesh(4, devices=["cuda"] * 4)``."""
    devs = _positions(devices if devices is not None else _visible())
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have "
                             f"{len(devs)}")
        devs = devs[:n_devices]
    arr = np.empty(len(devs), dtype=object)
    for i, p in enumerate(devs):
        arr[i] = p
    return Mesh(arr, (axis_name,))


def _by_rank(devs) -> list:
    by_host: dict = {}
    for d in devs:
        by_host.setdefault(d.rank, []).append(d)
    return [sorted(v, key=lambda d: d.id) for _, v in sorted(by_host.items())]


def make_mesh_2d(n_hosts: int, devices_per_host: Optional[int] = None,
                 axis_names: tuple = (DCN_AXIS, NODE_AXIS),
                 devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ``(dcn, nodes)`` mesh: the outer axis over processes (hosts),
    the inner over the positions within one. With several processes the
    positions are grouped by rank, and a row that would straddle two
    processes raises; in one process the list is reshaped as it is."""
    devs = _positions(devices if devices is not None else _visible())
    per = devices_per_host or len(devs) // n_hosts
    if n_hosts * per > len(devs):
        raise ValueError(f"requested {n_hosts}x{per} devices, have "
                         f"{len(devs)}")
    if len({d.rank for d in devs}) > 1:
        hosts = _by_rank(devs)
        flat = [d for h in hosts for d in h][: n_hosts * per]
        rows = [flat[i * per:(i + 1) * per] for i in range(n_hosts)]
        if any(len({d.rank for d in row}) != 1 for row in rows):
            raise ValueError(
                f"make_mesh_2d({n_hosts}, {per}): an inner-axis row would "
                "straddle a process boundary (processes have "
                f"{[len(h) for h in hosts]} devices); choose "
                "devices_per_host dividing the per-process count")
    else:
        flat = devs[: n_hosts * per]
    arr = np.empty((n_hosts, per), dtype=object)
    for i, p in enumerate(flat):
        arr[i // per, i % per] = p
    return Mesh(arr, axis_names)


def _tp_device_grid(devices, n_node_devices: int,
                    n_model_devices: int) -> np.ndarray:
    """Rank-contiguous ``(nodes, model)`` grid: positions grouped by the
    rank that owns them (``rank``; the JAX package groups by
    ``process_index``), so every model-axis row lies within one process
    and the node axis spans processes. Pure placement logic."""
    by_host: dict = {}
    for d in devices:
        by_host.setdefault(d.rank, []).append(d)
    hosts = [sorted(v, key=lambda d: d.id) for _, v in sorted(by_host.items())]
    sizes = {len(h) for h in hosts}
    if len(sizes) != 1:
        raise ValueError(
            f"uneven device count per host: {sorted(len(h) for h in hosts)}")
    per_host = sizes.pop()
    if per_host % n_model_devices != 0:
        raise ValueError(
            f"model axis ({n_model_devices}) must divide the per-host device "
            f"count ({per_host}) so tensor-parallel groups stay on one host")
    rows = [h[i:i + n_model_devices]
            for h in hosts for i in range(0, per_host, n_model_devices)]
    if len(rows) != n_node_devices:
        raise ValueError(f"device layout yields {len(rows)} node rows, "
                         f"requested {n_node_devices}")
    arr = np.empty((len(rows), n_model_devices), dtype=object)
    for i, row in enumerate(rows):
        for j, d in enumerate(row):
            arr[i, j] = d
    return arr


def make_mesh_tp(n_node_devices: int, n_model_devices: int,
                 axis_names: tuple = (NODE_AXIS, MODEL_AXIS),
                 devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D ``(nodes, model)`` mesh: the node population over the first
    axis and tensor parallelism over the second (:func:`_tp_device_grid`
    keeps each model-axis row within one process)."""
    devs = _positions(devices if devices is not None else _visible())
    need = n_node_devices * n_model_devices
    if need > len(devs):
        raise ValueError(f"requested {need} devices, have {len(devs)}")
    if len({d.rank for d in devs}) > 1 and need != len(devs):
        raise ValueError("multi-host TP mesh must use every attached device: "
                         f"requested {need} of {len(devs)}")
    return Mesh(_tp_device_grid(devs[:need], n_node_devices,
                                n_model_devices), axis_names)


# Mesh-axis resolution lives in the rule registry; the underscored names
# are the collectives' and the engine's spelling.
_node_axis_entry = rules.node_axis_entry
_model_axis_entry = rules.model_axis_entry

# Each placed tensor's resolved placement: id -> (weak ref, sharding).
_PLACEMENTS: dict = {}


def _record(t: torch.Tensor, sharding: NamedSharding) -> None:
    key = id(t)
    _PLACEMENTS[key] = (weakref.ref(t, lambda _, k=key: _PLACEMENTS.pop(
        k, None)), sharding)


def sharding_of(leaf) -> Optional[NamedSharding]:
    """The placement :func:`shard_state`, :func:`shard_data` or a shard
    function recorded for ``leaf`` (None for a tensor never placed)."""
    hit = _PLACEMENTS.get(id(leaf))
    if hit is None or hit[0]() is not leaf:
        return None
    return hit[1]


def _same_mesh(a, b) -> bool:
    return a is b or (a.axis_names == b.axis_names
                      and a.positions == b.positions)


def _place_leaf(x, sharding: NamedSharding):
    """One leaf where its placement says, its placement and global shape
    recorded: a whole tensor on the mesh's device (a virtual mesh), or on
    a mesh across ranks this rank's rows of a node-axis leaf, in a
    tensor of their own (the whole leaf is not kept alive; a leaf already
    placed on this mesh stays as it is), and a replicated leaf whole, on
    this rank's device."""
    mesh = sharding.mesh
    if not isinstance(x, torch.Tensor):
        if isinstance(x, (int, float, bool)):
            return x
        x = torch.as_tensor(np.asarray(x))
    if not mesh.spans_ranks():
        out = x.to(mesh.device())
        _record(out, dataclasses.replace(sharding,
                                         global_shape=tuple(x.shape)))
        return out
    placed = sharding_of(x)
    if placed is not None and _same_mesh(placed.mesh, mesh):
        return x
    out = rules.local_rows(x, sharding).to(
        mesh.local_device(), memory_format=torch.contiguous_format,
        copy=True)
    _record(out, dataclasses.replace(sharding, global_shape=tuple(x.shape)))
    return out


def state_shardings(state, mesh: Mesh, axis_name=None, model_axis=None,
                    batch_dims: int = 0):
    """A SimState-shaped tree of :class:`NamedSharding`, DERIVED from the
    rule registry (:data:`STATE_RULES`): model, phase and aux leaves
    node-leading; history and mailbox leaves (the int8 scale sidecar
    included) ``[D, N, ...]`` with the node axis second; the round
    replicated; on a TP mesh the parameter, optimizer and ring leaves also
    take the model axis. ``batch_dims`` shifts every node position right
    past that many leading lane axes (the service passes 1). An unmatched
    leaf raises :class:`UnmatchedLeafError`."""
    return rules.named_shardings(state, mesh, rules=STATE_RULES,
                                 axis_name=axis_name, model_axis=model_axis,
                                 batch_dims=batch_dims)


def record_local_state(state, mesh: Mesh, axis_name=None) -> None:
    """Record the placement of a state built on a mesh across ranks whose
    node-axis leaves already hold this rank's rows (the engine's
    ``init_state``), so that :func:`shard_state` keeps it as it is."""
    ring = ring_positions(mesh, axis_name)
    share = len(ring) // sum(p.rank == _rank() for p in ring)
    shardings = dict(rules.named_leaves(state_shardings(state, mesh,
                                                        axis_name)))
    for path, leaf in rules.named_leaves(state):
        if not isinstance(leaf, torch.Tensor):
            continue
        sh = shardings[path]
        shape = list(leaf.shape)
        dim = rules.node_dim(sh.spec, mesh)
        if dim is not None:
            shape[dim] *= share
        _record(leaf, dataclasses.replace(sh, global_shape=tuple(shape)))


def _check_placeable(mesh: Mesh) -> None:
    if mesh.spans_ranks():
        mesh.check_across_ranks()
    elif not mesh.is_virtual():
        raise NotImplementedError(_ACROSS_CARDS)


def shard_state(state, mesh: Mesh, axis_name=None, model_axis=None,
                batch_dims: int = 0):
    """Place a SimState onto the mesh per the rule registry. On a virtual
    mesh each leaf stays whole on the mesh's device; on a mesh across
    ranks each node-axis leaf keeps this rank's rows (``[N, ...]`` ->
    ``[N/R, ...]``, ``[D, N, ...]`` -> ``[D, N/R, ...]``; a leaf already
    placed on this mesh, as ``init_nodes`` leaves it, stays as it is) and
    the replicated ones stay whole. Placements are recorded
    (:func:`sharding_of`). One process's positions on several cards
    raise."""
    _check_placeable(mesh)
    shardings = state_shardings(state, mesh, axis_name, model_axis,
                                batch_dims)
    leaves = dict(rules.named_leaves(shardings))
    return tree_map_with_path(lambda p, x: _place_leaf(x, leaves[p]), state)


def shard_data(data: dict, mesh: Mesh, axis_name=None,
               batch_dims: int = 0) -> dict:
    """Place stacked data per :data:`DATA_RULES`: per-node arrays on the
    node axis (this rank's rows on a mesh across ranks), the shared eval
    set replicated; whole tensors on a virtual mesh's device, as
    :func:`shard_state`."""
    _check_placeable(mesh)
    arrs = {k: v if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v)) for k, v in data.items()}
    shardings = rules.named_shardings(arrs, mesh, rules=DATA_RULES,
                                      axis_name=axis_name,
                                      batch_dims=batch_dims)
    return {k: _place_leaf(arrs[k], shardings[k]) for k in arrs}


# -- what a mesh across ranks writes once ------------------------------------

def is_writer(mesh=None) -> bool:
    """Whether this process writes what a mesh across ranks writes once (a
    checkpoint, a flight-recorder bundle): rank 0 there, any process off
    such a mesh."""
    return mesh is None or not mesh.spans_ranks() or _rank() == 0


def rank_barrier(mesh=None) -> None:
    """Wait until every rank of a mesh across ranks arrives (after the
    writer's file is whole); nothing off such a mesh."""
    if mesh is not None and mesh.spans_ranks():
        torch.distributed.barrier()


def every_rank(obj, mesh=None) -> list:
    """Every rank's ``obj`` (a picklable value), in rank order: a
    collective every rank of a mesh across ranks calls (``[obj]`` off
    such a mesh), so that each can apply one rule to the same list."""
    if mesh is None or not mesh.spans_ranks():
        return [obj]
    seen = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(seen, obj)
    return seen


_ALIGN = 8   # bytes: every leaf's piece of the gathered buffer starts here


def gather_rows(tensors: Sequence[torch.Tensor], mesh: Mesh,
                dims: Optional[Sequence[int]] = None) -> list:
    """Every rank's rows of each tensor (its node axis ``dims[i]``,
    default 0), in node order, in new tensors on this rank's device:
    ONE all-gather of their bytes, whatever their dtypes (a collective
    every rank calls; under gloo a card's buffer is staged through the
    host). Off a mesh across ranks, the tensors themselves."""
    tensors = list(tensors)
    if mesh is None or not mesh.spans_ranks() or not tensors:
        return tensors
    from .collectives import _rank_order, rank_all_gather
    dims = [0] * len(tensors) if dims is None else list(dims)
    parts, cuts, offset = [], [], 0
    for x in tensors:
        raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % _ALIGN
        parts.append(raw)
        if pad:
            parts.append(raw.new_zeros(pad))
        cuts.append((offset, raw.numel()))
        offset += raw.numel() + pad
    ranks = len(_rank_order(mesh))
    whole = rank_all_gather(torch.cat(parts), mesh).reshape(ranks, offset)
    return [torch.cat([whole[r, start:start + size].view(x.dtype)
                       .reshape(x.shape) for r in range(ranks)], dim=dim)
            for x, (start, size), dim in zip(tensors, cuts, dims)]


def gather_state(state, mesh: Mesh, axis_name=None):
    """The whole population's state on every rank of a mesh across ranks:
    each node-axis leaf as every rank's rows in node order, each
    replicated tensor leaf copied, in new tensors on this rank's device.
    The node-axis leaves cross in ONE all-gather of their bytes
    (:func:`gather_rows`), whatever their dtypes (a bf16 or int8 ring and
    its scales among them). Off a mesh across ranks ``state`` itself."""
    if mesh is None or not mesh.spans_ranks():
        return state
    specs = dict(rules.named_leaves(state_shardings(state, mesh, axis_name)))
    node = {}
    for path, x in rules.named_leaves(state):
        if isinstance(x, torch.Tensor):
            dim = rules.node_dim(specs[path].spec, mesh)
            if dim is not None:
                node[path] = (x, dim)
    whole = dict(zip(node, gather_rows([x for x, _ in node.values()], mesh,
                                       [d for _, d in node.values()])))
    return tree_map_with_path(
        lambda path, x: whole[path] if path in whole else
        x.clone() if isinstance(x, torch.Tensor) else x, state)


def local_state(state, mesh: Mesh, axis_name=None):
    """This rank's rows of a whole-population state on a mesh across
    ranks, the inverse of :func:`gather_state`: each node-axis leaf cut
    along the dimension the rule registry gives it, in a tensor of its
    own; every other leaf as it is. Off a mesh across ranks ``state``
    itself."""
    if mesh is None or not mesh.spans_ranks():
        return state
    specs = dict(rules.named_leaves(state_shardings(state, mesh, axis_name)))

    def cut(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        mine = rules.local_rows(x, specs[path])
        return x if mine is x else mine.clone()
    return tree_map_with_path(cut, state)
