"""Regex partition-rule registry: every placement in the package, derived.

Counterpart of ``gossipy_tpu/parallel/rules.py``. The registry is the
single source of placement truth:

- a **rule table**: ordered ``(path regex, RuleSpec)`` pairs over
  slash-joined leaf paths (``model/params``, ``mailbox/sender``,
  ``history_scale``). First match wins; an unmatched leaf RAISES.
- a **RuleSpec**: where the node axis sits on the leaf (``node_pos``),
  whether the leaf takes the model axis of a tensor-parallel mesh
  (``tp``), or replicated outright. It is resolved against a mesh and a
  leaf's shape into a :class:`PartitionSpec`, a plain tuple of axis
  entries (``None`` for an unsharded dimension).
- :func:`make_shard_and_gather_fns`: per-leaf place and gather closures.

The leaf paths spell the JAX package's: :func:`named_leaves` walks the
port's :class:`~gossipy_tpu_torch.simulation.engine.SimState` and every
NamedTuple by their field names and dicts by sorted key, so the same
regexes match. One deliberate difference: the port keeps a node's
parameters in ONE flat ``[N, stride]`` row (``model/params``), where the
JAX state has a leaf per layer, so on a tensor-parallel mesh the model
axis lands on ``stride`` (when the model-axis size divides it) instead of
on a layer's feature dimension. Each family's ``describe()`` is the JAX
one.

``parallel.state_shardings`` / ``shard_data``, ``GossipSimulator.load(
mesh=)`` and the service's bucket placement (``GossipService(mesh=)``)
all derive from this table; no :class:`PartitionSpec` is built outside
this module.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional

import numpy as np
import torch

NODE_AXIS = "nodes"
DCN_AXIS = "dcn"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """Per-dimension mesh-axis entries of one leaf (``None`` = not
    sharded): the port's own spelling of ``jax.sharding.PartitionSpec``,
    a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    """Placement of one leaf family.

    - ``node_pos``: index of the leaf dimension carrying the node
      population (``None`` = fully replicated). A leaf with fewer than
      ``node_pos + 1`` dimensions resolves to replicated.
    - ``tp``: on a tensor-parallel mesh (an axis named ``"model"``), also
      shard the largest eligible trailing dimension over the model axis.
    """

    node_pos: Optional[int] = 0
    tp: bool = False

    def describe(self) -> str:
        if self.node_pos is None:
            return "replicated"
        return f"node_axis@{self.node_pos}" + ("+tp" if self.tp else "")


REPLICATED = RuleSpec(node_pos=None)

# The SimState rule table (the JAX package's, pattern for pattern). ORDER
# MATTERS: first match wins.
STATE_RULES: tuple[tuple[str, RuleSpec], ...] = (
    (r"^model/params(/|$)", RuleSpec(node_pos=0, tp=True)),
    (r"^model/opt_state(/|$)", RuleSpec(node_pos=0, tp=True)),
    (r"^model/n_updates(/|$)", RuleSpec(node_pos=0)),
    (r"^phase$", RuleSpec(node_pos=0)),
    (r"^history_params(/|$)", RuleSpec(node_pos=1, tp=True)),
    (r"^history_ages$", RuleSpec(node_pos=1)),
    (r"^history_scale(/|$)", RuleSpec(node_pos=1)),
    (r"^(mailbox|reply_box)/", RuleSpec(node_pos=1)),
    (r"^round$", REPLICATED),
    (r"^aux(/|$)", RuleSpec(node_pos=0)),
)

# Stacked-data rule table: the shared eval split replicated, every other
# array per node on its leading axis.
DATA_RULES: tuple[tuple[str, RuleSpec], ...] = (
    (r"^(x_eval|y_eval)$", REPLICATED),
    (r"^", RuleSpec(node_pos=0)),
)

def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool, RuleSpec, PartitionSpec, NamedSharding)) \
        or callable(x)


def _children(tree) -> Optional[list]:
    """``(name, child)`` pairs of an inner node, or None for a leaf."""
    if tree is None or _is_leaf(tree):
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree, key=str)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _rebuild(tree, values: list):
    """``tree``'s container with its children replaced by ``values`` (in
    :func:`_children` order)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*values)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: v for f, v in zip(dataclasses.fields(tree),
                                               values)})
    if isinstance(tree, dict):
        keys = sorted(tree, key=str)
        return {k: v for k, v in zip(keys, values)}
    return type(tree)(values)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``; ``None``
    children (an absent sidecar) stay None, as an empty subtree does in
    JAX."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [
        tree_map_with_path(fn, child, f"{prefix}/{name}" if prefix else name)
        for name, child in kids])


def leaf_path(path) -> str:
    """Slash-joined name of a key path (a sequence of components)."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


def named_leaves(tree) -> list[tuple[str, object]]:
    """``(path, leaf)`` pairs for every leaf, with slash-joined paths."""
    out: list = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


class UnmatchedLeafError(ValueError):
    """A leaf no partition rule covers — the coverage contract."""


def _matcher(rules) -> Callable[[str], RuleSpec]:
    """The ordered table as a function of a leaf's path: the first rule
    whose regex matches, or :class:`UnmatchedLeafError`."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def pick(name: str) -> RuleSpec:
        for pat, spec in compiled:
            if pat.search(name):
                return spec
        raise UnmatchedLeafError(
            f"no partition rule matches leaf {name!r}; add a rule to the "
            "table (parallel/rules.py) — unmatched leaves are an error, "
            "not a replicate-by-default")

    return pick


def match_partition_rules(rules, tree, *, prefix: str = ""):
    """A tree of :class:`RuleSpec` matching ``tree``'s structure: each
    leaf's path (optionally prefixed) against the ordered table, first
    match wins; an unmatched leaf raises :class:`UnmatchedLeafError`."""
    pick = _matcher(rules)
    return tree_map_with_path(lambda path, _: pick(prefix + path), tree)


# -- mesh-axis resolution ------------------------------------------------------

def node_axis_entry(mesh, axis_name=None):
    """The spec entry for the node dimension: ``axis_name`` as given, else
    the single non-model axis of the mesh, or all of them as a tuple."""
    if axis_name is not None:
        return axis_name
    names = tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
    if not names:
        raise ValueError("mesh has only a model axis; no axis left for nodes")
    if len(names) > 1:
        return names
    return names[0]


def node_axis_size(mesh, axis_name=None) -> int:
    """Total extent of the node axis (the product over a combined entry)."""
    entry = node_axis_entry(mesh, axis_name)
    names = entry if isinstance(entry, tuple) else (entry,)
    size = 1
    for a in names:
        size *= int(mesh.shape[a])
    return size


def model_axis_entry(mesh, model_axis=None):
    """The tensor-parallel axis: ``model_axis`` as given, else an axis
    named ``"model"``, else None."""
    if model_axis is not None:
        return model_axis
    return MODEL_AXIS if MODEL_AXIS in mesh.axis_names else None


def node_leading_spec(ndim: int, entry, pos: int = 0) -> PartitionSpec:
    """The node entry at ``pos``, every other dimension unsharded."""
    dims: list = [None] * ndim
    if pos < ndim:
        dims[pos] = entry
    return PartitionSpec(*dims)


def replicated_spec(ndim: int) -> PartitionSpec:
    return PartitionSpec(*([None] * ndim))


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def resolve_spec(rule: RuleSpec, leaf, mesh, node_entry, model_entry=None,
                 batch_dims: int = 0) -> PartitionSpec:
    """One rule against a leaf and a mesh: the node entry at ``node_pos +
    batch_dims``; with ``rule.tp`` on a mesh with a model axis, the
    largest trailing dimension the model-axis size divides takes it (ties
    toward the last dimension)."""
    ndim = _ndim(leaf)
    if rule.node_pos is None:
        return replicated_spec(ndim)
    pos = rule.node_pos + batch_dims
    if ndim <= pos:
        return replicated_spec(ndim)
    dims: list = [None] * ndim
    dims[pos] = node_entry
    if rule.tp and model_entry is not None:
        size = int(mesh.shape[model_entry])
        shape = tuple(leaf.shape)
        cands = [i for i in range(pos + 1, ndim)
                 if shape[i] >= size and shape[i] % size == 0]
        if cands and size > 1:
            dims[max(cands, key=lambda i: (shape[i], i))] = model_entry
    return PartitionSpec(*dims)


def partition_specs(tree, mesh, rules=STATE_RULES, axis_name=None,
                    model_axis=None, batch_dims: int = 0):
    """``tree``-shaped tree of :class:`PartitionSpec`: the rule table
    matched, each rule resolved against the mesh and the leaf's shape."""
    node_entry = node_axis_entry(mesh, axis_name)
    model_entry = model_axis_entry(mesh, model_axis)
    pick = _matcher(rules)
    return tree_map_with_path(
        lambda path, leaf: resolve_spec(pick(path), leaf, mesh, node_entry,
                                        model_entry, batch_dims), tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: the mesh and its resolved spec. ``device_set``
    holds the mesh's distinct devices (one on a virtual mesh over a
    single card); ``global_shape`` is the whole leaf's shape where a leaf
    was placed (on a mesh across ranks each rank holds a slice of it)."""

    mesh: Any
    spec: PartitionSpec
    global_shape: Optional[tuple] = dataclasses.field(default=None,
                                                      compare=False)

    @property
    def device_set(self) -> set:
        return {p.device for p in self.mesh.positions}

    @property
    def positions(self) -> int:
        """How many mesh positions hold a piece of the leaf."""
        size = 1
        for e in self.spec:
            if e is None:
                continue
            for a in (e if isinstance(e, tuple) else (e,)):
                size *= int(self.mesh.shape[a])
        return size


def node_dim(spec: PartitionSpec, mesh) -> Optional[int]:
    """The leaf dimension a resolved spec puts the node axis on (None for
    a replicated leaf)."""
    model = model_axis_entry(mesh)
    for i, e in enumerate(spec):
        if e is not None and e != model:
            return i
    return None


def local_rows(x, sharding: "NamedSharding"):
    """This rank's slice of a whole leaf under its placement: the rows
    :meth:`Mesh.node_rows` gives along the spec's node dimension (the
    leaf itself when it is replicated)."""
    dim = node_dim(sharding.spec, sharding.mesh)
    if dim is None:
        return x
    entry = sharding.spec[dim]
    rows = sharding.mesh.node_rows(x.shape[dim], entry)
    return x.narrow(dim, rows.start, rows.stop - rows.start)


def named_shardings(tree, mesh, rules=STATE_RULES, axis_name=None,
                    model_axis=None, batch_dims: int = 0):
    """``tree``-shaped tree of :class:`NamedSharding` (the resolved
    table)."""
    specs = partition_specs(tree, mesh, rules, axis_name, model_axis,
                            batch_dims)
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), specs)


def make_shard_and_gather_fns(tree, mesh, rules=STATE_RULES, axis_name=None,
                              model_axis=None, batch_dims: int = 0):
    """Per-leaf place and gather closures from the resolved table:
    ``(shard_fns, gather_fns)``, two trees matching ``tree``. A shard
    function puts a leaf where its placement says (the mesh's device: on
    a mesh whose positions all name one device the leaf stays whole
    there; on a mesh across ranks this rank's rows); a gather function
    returns the whole leaf as a host numpy array (on a mesh across ranks
    every rank's rows brought together in node order, a collective that
    every rank calls)."""
    from . import _place_leaf

    shardings = named_shardings(tree, mesh, rules, axis_name, model_axis,
                                batch_dims)

    def make_shard(sh):
        return lambda x: _place_leaf(x, sh)

    def make_gather(sh):
        dim = node_dim(sh.spec, mesh)
        if not mesh.spans_ranks() or dim is None:
            return _to_host
        from .collectives import rank_all_gather
        return lambda x: _to_host(rank_all_gather(x, mesh, dim=dim))

    return (tree_map_with_path(lambda _, sh: make_shard(sh), shardings),
            tree_map_with_path(lambda _, sh: make_gather(sh), shardings))


def _to_host(x) -> np.ndarray:
    """A leaf as a host numpy array (bfloat16, which numpy lacks, widened
    to float32)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def rules_table(rules=STATE_RULES) -> list[list[str]]:
    """The rule table as ``[pattern, placement]`` string rows (the
    manifest stamp)."""
    return [[pat, spec.describe()] for pat, spec in rules]


def resolved_rules_table(tree, rules=STATE_RULES) -> list[list[str]]:
    """``[leaf path, placement]`` for every leaf of ``tree`` (raises on an
    unmatched leaf)."""
    rule_tree = match_partition_rules(rules, tree)
    return [[path, spec.describe()]
            for path, spec in named_leaves(rule_tree)]
