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

Placement: on a mesh whose positions all name one device of this
process, :func:`shard_state` and :func:`shard_data` keep every leaf a
whole tensor on that device and record its resolved placement
(:func:`sharding_of`). On a mesh over several distinct devices or
processes they raise: the round's state placed across cards is not
ported (ROADMAP.md queue 1 item 13). The collectives do run across
cards (``.to(device, non_blocking=True)``) and across processes
(``torch.distributed.batch_isend_irecv``) after :func:`init_distributed`.
"""

from __future__ import annotations

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
    "sharding_of",
]

# What a placement across several cards or processes waits for.
_ACROSS_CARDS = ("placing the round's state across several cards or "
                 "processes is not ported (ROADMAP.md queue 1 item 13); "
                 "use a mesh whose positions all name one device of this "
                 "process (make_mesh(n, devices=[dev] * n))")


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


class Mesh:
    """Positions laid out over named axes (``jax.sharding.Mesh``'s
    counterpart): ``devices`` is the ndarray of :class:`Position`,
    ``axis_names`` the axes, ``shape`` the axis sizes as a dict."""

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

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def positions(self) -> list:
        return list(self.devices.ravel())

    def is_virtual(self) -> bool:
        """True when every position names one device of this process."""
        me = _rank()
        return (len({p.device for p in self.positions}) == 1
                and all(p.rank == me for p in self.positions))

    def device(self) -> torch.device:
        """The one device of a virtual mesh; raises on any other mesh."""
        if not self.is_virtual():
            raise NotImplementedError(_ACROSS_CARDS)
        return self.positions[0].device

    def __repr__(self) -> str:
        devs = sorted({str(p.device) for p in self.positions})
        return (f"Mesh({self.shape}, devices={devs}, "
                f"ranks={sorted({p.rank for p in self.positions})})")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     **kwargs) -> None:
    """Join (or form) a process group before building a mesh over several
    processes: ``torch.distributed.init_process_group`` at
    ``tcp://<coordinator_address>`` with the world size and this
    process's rank (gloo on the CPU, NCCL with a card, unless
    ``backend=`` says otherwise; other keywords pass through). After it,
    :func:`devices` lists every rank's positions."""
    dist = torch.distributed
    backend = kwargs.pop("backend", None) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    addr = coordinator_address
    if addr is not None and "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id,
                            **kwargs)


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


def _place_leaf(x, sharding: NamedSharding):
    """One leaf where its placement says: a whole tensor on the mesh's
    device (a virtual mesh), its placement recorded."""
    dev = sharding.mesh.device()
    if not isinstance(x, torch.Tensor):
        if isinstance(x, (int, float, bool)):
            return x
        x = torch.as_tensor(np.asarray(x))
    out = x.to(dev)
    _record(out, sharding)
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


def shard_state(state, mesh: Mesh, axis_name=None, model_axis=None,
                batch_dims: int = 0):
    """Place a SimState onto the mesh per the rule registry. On a virtual
    mesh each leaf stays whole on the mesh's device, its placement
    recorded (:func:`sharding_of`); on any other mesh this raises."""
    if not mesh.is_virtual():
        raise NotImplementedError(_ACROSS_CARDS)
    shardings = state_shardings(state, mesh, axis_name, model_axis,
                                batch_dims)
    leaves = dict(rules.named_leaves(shardings))
    return tree_map_with_path(lambda p, x: _place_leaf(x, leaves[p]), state)


def shard_data(data: dict, mesh: Mesh, axis_name=None,
               batch_dims: int = 0) -> dict:
    """Place stacked data per :data:`DATA_RULES`: per-node arrays on the
    node axis, the shared eval set replicated; whole tensors on a virtual
    mesh's device, as :func:`shard_state`."""
    if not mesh.is_virtual():
        raise NotImplementedError(_ACROSS_CARDS)
    arrs = {k: v if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v)) for k, v in data.items()}
    shardings = rules.named_shardings(arrs, mesh, rules=DATA_RULES,
                                      axis_name=axis_name,
                                      batch_dims=batch_dims)
    return {k: _place_leaf(arrs[k], shardings[k]) for k in arrs}
