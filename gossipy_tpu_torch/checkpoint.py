"""Checkpoint and resume for simulation state.

Counterpart of ``gossipy_tpu/checkpoint.py``. A simulation's state is one
nest of tensors (:class:`~gossipy_tpu_torch.simulation.engine.SimState`,
or the sequential engine's
:class:`~gossipy_tpu_torch.simulation.sequential.SeqState`), so a
checkpoint is that nest flattened to ``{tree path: tensor}``
(``"model.params"``, ``"mailbox.sender"``, ``"aux.balance"``; numpy leaves
stored as tensors, ``round`` as an int) and written with ``torch.save``,
plus the draw state of the run. It is read back only with
``torch.load(..., weights_only=True)``: a checkpoint file never unpickles
an object.

The draw state is what the JAX package does not need: there every draw is
keyed on the absolute round, so the key alone resumes a run. The port's
default provider (:class:`~gossipy_tpu_torch.random.TorchDraws`) is one
stream, so a checkpoint keeps its generator's state
(:meth:`~gossipy_tpu_torch.random.DrawProvider.get_state`) beside the
state, and a run of 20 rounds equals 10 rounds, a save, a fresh
simulator's load and 10 more, bit for bit on one device. A provider keyed
on the round (the JAX draw oracle) keeps no state and resumes from the
round alone.

Usage::

    save_checkpoint(path, state, draws=sim.draws)
    state, draws = restore_checkpoint(path, sim.init_nodes(local_train=False),
                                      sim.draws)
    sim.start(state, n_rounds=50)   # continues from state.round

The restore builds the state in the template's structure, on the
template's device: ``torch.load(map_location=)`` that device, each saved
array checked against the template's leaf. A template whose structure, a
shape or a dtype differs is refused with ``ValueError`` naming the leaf:
a restore target must be built with the SAME simulator configuration,
``mailbox_slots`` included (the mailbox is a ``[D, N, K]`` state tensor),
and ``history_dtype`` too (the ring is checkpointed in its wire format,
bf16 and int8 rings at their reduced size, the int8 scales as
``history_scale``).

A mesh restore (``restore_checkpoint(..., mesh=)``, which
``GossipSimulator.load(mesh=)`` passes) places the restored state per the
partition-rule registry (:func:`gossipy_tpu_torch.parallel.shard_state`):
the placement is derived, never assembled here.

The file is the port's own format: a JAX (orbax) checkpoint is not
readable here, nor the reverse.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

CHECKPOINT_FORMAT = 1


# -- the state as {tree path: leaf} -----------------------------------------

def _is_leaf(x) -> bool:
    return x is None or isinstance(x, (torch.Tensor, np.ndarray, int, float,
                                       bool, str))


def _children(x) -> Optional[list]:
    """``[(name, child)]`` of a container, or None for a leaf."""
    if _is_leaf(x):
        return None
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return list(zip(x._fields, x))
    if isinstance(x, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(x)]
    if isinstance(x, dict):
        return [(str(k), x[k]) for k in sorted(x, key=str)]
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def flatten_state(tree: Any, path: str = "") -> dict:
    """``{tree path: leaf}`` of a state: tensors, numpy arrays, Python
    scalars and None, keyed by their dotted paths (an empty container
    keeps its place as ``<path>.{}``)."""
    kids = _children(tree)
    if kids is None:
        return {path: tree}
    out = {} if kids else {_join(path, "{}"): None}
    for name, child in kids:
        out.update(flatten_state(child, _join(path, name)))
    return out


def _join(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


def _stored(leaf):
    """A leaf as ``torch.save`` keeps it under ``weights_only``."""
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return leaf


def _restored(path: str, want, got):
    """The saved ``got`` in the form of the template leaf ``want``;
    ``ValueError`` naming ``path`` when they do not fit."""
    if isinstance(want, (torch.Tensor, np.ndarray)):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"checkpoint leaf {path!r}: saved "
                             f"{type(got).__name__}, the template has an "
                             "array")
        if isinstance(want, np.ndarray):
            arr = got.cpu().numpy()
            if arr.shape != want.shape or arr.dtype != want.dtype:
                raise ValueError(
                    f"checkpoint leaf {path!r}: saved {arr.dtype} "
                    f"{tuple(arr.shape)}, the template has {want.dtype} "
                    f"{tuple(want.shape)}")
            return arr.copy()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"checkpoint leaf {path!r}: saved {got.dtype} "
                f"{tuple(got.shape)}, the template has {want.dtype} "
                f"{tuple(want.shape)}")
        return got.to(want.device)
    if (want is None) != (got is None) or isinstance(got, torch.Tensor):
        raise ValueError(f"checkpoint leaf {path!r}: saved "
                         f"{type(got).__name__}, the template has "
                         f"{type(want).__name__}")
    return got


def _rebuild(tree: Any, flat: dict, path: str = ""):
    """``tree``'s structure with the leaves of ``flat``."""
    kids = _children(tree)
    if kids is None:
        return flat[path]
    vals = {name: _rebuild(child, flat, _join(path, name))
            for name, child in kids}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **vals)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**vals)
    if isinstance(tree, (tuple, list)):
        return type(tree)(vals[str(i)] for i in range(len(tree)))
    return {k: vals[str(k)] for k in tree}


def clone_state(tree: Any) -> Any:
    """A copy of a state whose tensors and arrays share nothing with it:
    what a chunked run keeps of a chunk's start, since ``start`` updates its
    state in place."""
    flat = flatten_state(tree)
    return _rebuild(tree, {
        k: (v.clone() if isinstance(v, torch.Tensor) else
            v.copy() if isinstance(v, np.ndarray) else v)
        for k, v in flat.items()})


def _first_device(tree) -> torch.device:
    for v in flatten_state(tree).values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def draw_record(draws) -> Optional[dict]:
    """The draw state :func:`save_checkpoint` keeps for ``draws`` (a
    provider, or a record already taken), taken now: ``{"kind",
    "state"}``, None for a provider that keeps none. A chunked run takes it at
    a chunk's start and saves it with that chunk's state (the flight
    recorder's last healthy state)."""
    if draws is None or isinstance(draws, dict):
        return draws
    state = draws.get_state()
    if state is None:
        return None
    return {"kind": type(draws).__name__, "state": state}


# -- save and restore --------------------------------------------------------

def save_checkpoint(path: str, state: Any, draws=None, force: bool = True,
                    meta: Optional[dict] = None) -> str:
    """Save a state (a ``SimState``, a ``SeqState`` or any nest of
    tensors) and the draw state of ``draws`` (a
    :class:`~gossipy_tpu_torch.random.DrawProvider`, or a record from
    :func:`draw_record`) to the file ``path``.

    ``meta`` (a JSON-able dict) is written as a ``<path>.meta.json``
    sidecar, host-readable context (round index, why the snapshot was
    taken) that a post-mortem can read without loading the checkpoint;
    the flight recorder stamps its bundles through it. ``force=False``
    refuses to overwrite. The file is written to a temporary name and
    renamed, so a reader never sees half a checkpoint. Returns the
    absolute path."""
    from .telemetry.tracing import span
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    with span("checkpoint.save", cat="checkpoint", path=path):
        payload = {"format": CHECKPOINT_FORMAT,
                   "state": {k: _stored(v)
                             for k, v in flatten_state(state).items()}}
        rec = draw_record(draws)
        if rec is not None:
            payload["draws"] = rec
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if meta is not None:
            with open(path + ".meta.json", "w") as fh:
                json.dump(meta, fh, indent=2)
                fh.write("\n")
    return path


def load_checkpoint_meta(path: str) -> Optional[dict]:
    """Read the ``meta`` sidecar written by :func:`save_checkpoint`, or
    None when the checkpoint has none."""
    sidecar = os.path.abspath(path) + ".meta.json"
    if not os.path.exists(sidecar):
        return None
    with open(sidecar) as fh:
        return json.load(fh)


def slice_lane(tree: Any, i: int) -> Any:
    """Lane ``i`` of a batched state (a leading batch axis on every array
    leaf) as host numpy arrays, the solo-shaped state a checkpoint or a
    bundle takes; 0-d leaves and Python scalars pass through. A list of
    states (``run_repetitions``' result in the port, the service's lanes)
    gives its ``i``-th entry on the host. A bfloat16 leaf (a bf16 ring),
    which numpy has no type for, stays a tensor, copied to the host."""
    if isinstance(tree, list):
        tree = tree[i]
        take = lambda a: a
    else:
        take = lambda a: a[i] if a.ndim else a
    flat = flatten_state(tree)
    out = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            out[k] = take(v.detach().cpu()).clone()
            continue
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = take(np.array(v)) if isinstance(v, np.ndarray) else v
    return _rebuild(tree, out)


def restore_checkpoint(path: str, template_state: Any, template_draws=None,
                       mesh=None):
    """Restore ``(state, draws)`` from ``path``.

    ``template_state`` (a fresh ``sim.init_nodes(local_train=False)``
    result) gives the structure, the dtypes and the device: the saved
    arrays are loaded onto its device and checked leaf by leaf (a
    ``ValueError`` names the first that differs). ``template_draws``
    receives the saved draw state (``set_state``) and is returned; without
    one a saved :class:`~gossipy_tpu_torch.random.TorchDraws` state comes
    back in a new provider. ``draws`` is None when the checkpoint kept
    none (a provider keyed on the round); a ``template_draws`` that has a
    draw state (a stream) is refused then with ``ValueError``, since the
    resumed run would draw from its fresh stream. With ``mesh`` the
    restored state is placed per the rule registry (:func:`~gossipy_tpu_
    torch.parallel.shard_state`)."""
    state, draws = _restore(path, template_state, template_draws)
    if mesh is not None:
        from .parallel import shard_state
        state = shard_state(state, mesh)
    return state, draws


def _restore(path: str, template_state: Any, template_draws):
    from .telemetry.tracing import span
    path = os.path.abspath(path)
    with span("checkpoint.restore", cat="checkpoint", path=path):
        payload = torch.load(path, map_location=_first_device(template_state),
                             weights_only=True)
        if payload.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(f"{path}: not a checkpoint of this package "
                             f"(format {payload.get('format')!r})")
        saved = payload["state"]
        want = flatten_state(template_state)
        missing, extra = sorted(set(want) - set(saved)), \
            sorted(set(saved) - set(want))
        if missing or extra:
            raise ValueError(
                f"checkpoint {path} does not fit the template: leaves "
                f"missing {missing}, unexpected {extra} (another simulator "
                "configuration?)")
        state = _rebuild(template_state, {
            k: _restored(k, want[k], saved[k]) for k in want})
        rec = payload.get("draws")
        if rec is None:
            if template_draws is not None and \
                    template_draws.get_state() is not None:
                raise ValueError(
                    f"checkpoint {path} keeps no draw state, and "
                    f"{type(template_draws).__name__} cannot resume without "
                    "it: save with draws= (as sim.save and "
                    "CheckpointManager do)")
            return state, None
        draws = template_draws
        if draws is None:
            if rec["kind"] != "TorchDraws":
                raise ValueError(f"{path} keeps {rec['kind']} draws: pass "
                                 "template_draws to restore them")
            from .random import TorchDraws
            draws = TorchDraws()
        draws.set_state(rec["state"])
        return state, draws


class CheckpointManager:
    """Periodic checkpointing over a chunked simulation run, with
    retention: every ``interval`` rounds the state and the draw state go
    to ``<directory>/round_<8 digits>``, and only the newest
    ``max_to_keep`` stay::

        mgr = CheckpointManager(dir, interval=100, max_to_keep=3)
        state = mgr.run(sim, state, until_round=1000)

    Drives :class:`~gossipy_tpu_torch.simulation.engine.GossipSimulator`
    and its variants and
    :class:`~gossipy_tpu_torch.simulation.sequential.SequentialGossipSimulator`
    alike.
    """

    def __init__(self, directory: str, interval: int = 100,
                 max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.interval = int(interval)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, rnd: int) -> str:
        return os.path.join(self.directory, f"round_{rnd:08d}")

    def checkpoints(self) -> list[int]:
        """Sorted round numbers with a checkpoint on disk."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("round_"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest(self) -> Optional[int]:
        cps = self.checkpoints()
        return cps[-1] if cps else None

    def _retain(self):
        cps = self.checkpoints()
        for rnd in cps[: max(0, len(cps) - self.max_to_keep)]:
            for p in (self._path(rnd), self._path(rnd) + ".meta.json"):
                if os.path.exists(p):
                    os.remove(p)

    def run(self, sim, state, until_round: int, draws=None,
            reports: Optional[list] = None):
        """Advance the simulation to ABSOLUTE round ``until_round``,
        checkpointing every ``interval`` rounds.

        If the directory already holds checkpoints, the newest is
        restored (``state`` is its template) with its draw state, and
        only the missing rounds run; a state at or past ``until_round``
        is returned as it is. ``draws`` is the run's provider, installed
        as ``sim.draws`` when given (default: ``sim.draws``). The
        caller's own ``state`` is never updated: the first chunk runs on
        a copy (``start`` updates its state in place). Per-chunk reports
        are appended to ``reports`` when given.
        """
        if draws is not None:
            sim.draws = draws
        newest = self.latest()
        if newest is not None:
            state, _ = restore_checkpoint(self._path(newest), state,
                                          sim.draws)
        else:
            state = clone_state(state)
        start_round = int(state.round)
        done = 0
        target = until_round - start_round
        while done < target:
            chunk = min(self.interval, target - done)
            state, report = sim.start(state, n_rounds=chunk)
            if reports is not None:
                reports.append(report)
            done += chunk
            save_checkpoint(self._path(start_round + done), state,
                            draws=sim.draws)
            self._retain()
        return state
