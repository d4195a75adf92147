"""tracelint: an AST linter for the eager gossip round's host syncs.

Counterpart of ``gossipy_tpu/analysis/tracelint.py``, with its machinery
(the module and repo model, call resolution with subclass overrides, the
pragmas, the content-hash baseline) copied and its rules kept where they
still mean something for eager PyTorch. Pure stdlib (``ast`` +
``json``): importing this module never pulls in torch.

What it knows that a generic linter does not:

- **Which functions are on the round's path.** The JAX linter finds its
  roots at jit, scan and loop sites; the port has none, so the roots are
  named here (:data:`ROOTS`): the engine's round and run loop
  (``GossipSimulator._round``, ``_run_rounds``), its phase methods
  (``_snapshot``, ``_send_phase``, ``_deliver_phase``, ``_eval_phase``),
  the read of the run's rows at the end of ``start`` (``_finish_run``),
  All2All's round and the token variants' round hooks, the sequential
  engine's tick loop (``SequentialGossipSimulator.start``), the cohort's
  segment loop (``cohort_start``) and the service's slice stepper
  (``_BucketRuntime._run_lanes``). The call graph then propagates through
  repo-internal calls (module functions, ``self.`` methods including
  subclass overrides: a variant's ``_round`` is on the path as the
  base's is). Calls into the host-side modules (:data:`_HOST_MODULES`:
  the report, the events, the metrics, tracing, ledger, sink and
  manifest) do not propagate: they run on host data after the rounds.

- **Which values are tensors.** Inside a function on the path, the
  parameters (minus ``self``/``cls``/``sim``, config objects and
  parameters annotated with a Python scalar or container type) may hold
  tensors; so does any ``torch.*`` call's result (``torch.cuda.*``,
  ``torch.device`` and the like aside), and any call fed one. Reads that
  stay on the host do not: ``x.shape``, ``x.dtype``, ``x.device``,
  ``x.numel()``, ``len(x)``, ``is None`` tests, and ``.round`` (the
  state's host round counter). The result of a host sync is a host value.

Rules (ids are stable, grep-able, and the suppression currency):

=================== =====================================================
id                  fires on
=================== =====================================================
host-sync           on the round's path, a read that waits for the card:
                    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``
                    or ``.to("cpu")`` of a tensor, ``float()``/``int()``/
                    ``bool()`` of a tensor, ``if``/``while``/
                    ``assert``/ternary on a tensor, and any
                    ``torch.cuda.synchronize()``
np-in-round         on the round's path, ``np.*`` called on a tensor:
                    numpy copies it to the host (a sync), and on a CUDA
                    tensor raises
registry-field      a ``probe_*``/``health_*``/``chaos_*``/``perf_*``/
                    ``cohort_*`` per-round stat key that is missing from
                    the report registry (``PER_ROUND_FIELDS``/
                    ``STATIC_FIELDS``): it would silently vanish from
                    save/load/concatenate
schema-tolerance    ``JSONLinesReceiver.SCHEMA`` was bumped past the
                    versions ``parse_line`` tolerates
=================== =====================================================

The JAX linter's ``traced-slice`` and ``use-after-donate`` are not
ported: eager shapes are concrete, and nothing is donated. Its
``metrics-in-trace``, ``trace-in-trace`` and ``ledger-in-trace`` are not
either: an eager round is host code, so a call into those sinks is not a
concretized tracer; that the options add no op to the round is what the
program gate's identity pairs hold (:mod:`.program`).

Not seen: syncs inside a data-dependent-shape op (a boolean-mask index,
``nonzero``), and a sync inside a library function.

Suppression: append ``# tracelint: disable=<rule>[,<rule>...]`` (or
``disable=all``) to the offending line. Today's deliberate syncs live in
the committed ``analysis/baseline.json`` (finding identity = rule + file +
hash of the stripped source line, so baselined findings survive
line-number drift): it is the inventory of the round's host syncs, and
``python -m gossipy_tpu_torch.analysis`` fails only on NEW findings.
"""

from __future__ import annotations

import ast
import functools
import hashlib
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

ALL_RULES = {
    "host-sync": "host sync (.item/.tolist/.cpu/.numpy, float/int/bool, "
                 "if/while/assert on a tensor, cuda.synchronize) on the "
                 "round's path",
    "np-in-round": "np.* call on a tensor on the round's path",
    "registry-field": "per-round stat key missing from the report registry",
    "schema-tolerance": "JSONL SCHEMA bumped past parse_line's tolerance",
}

_PKG = "gossipy_tpu_torch"
_REPORT_MODULE = _PKG + "/simulation/report.py"
_EVENTS_MODULE = _PKG + "/simulation/events.py"

# The round's path: (module, qualname) of each root. A test asserts that
# each resolves to a function of the port.
ROOTS = (
    (_PKG + "/simulation/engine.py", "GossipSimulator._round"),
    (_PKG + "/simulation/engine.py", "GossipSimulator._run_rounds"),
    (_PKG + "/simulation/engine.py", "GossipSimulator._snapshot"),
    (_PKG + "/simulation/engine.py", "GossipSimulator._send_phase"),
    (_PKG + "/simulation/engine.py", "GossipSimulator._deliver_phase"),
    (_PKG + "/simulation/engine.py", "GossipSimulator._eval_phase"),
    (_PKG + "/simulation/engine.py", "GossipSimulator._finish_run"),
    (_PKG + "/simulation/variants.py", "All2AllGossipSimulator._round"),
    (_PKG + "/simulation/variants.py", "TokenizedGossipSimulator._send_gate"),
    (_PKG + "/simulation/variants.py",
     "TokenizedGossipSimulator._post_receive_slot"),
    (_PKG + "/simulation/variants.py",
     "TokenizedGossipSimulator._post_deliver"),
    (_PKG + "/simulation/sequential.py", "SequentialGossipSimulator.start"),
    (_PKG + "/simulation/cohort.py", "cohort_start"),
    (_PKG + "/service/scheduler.py", "_BucketRuntime._run_lanes"),
)

# Host-side modules: they run on host data after the rounds (the report,
# the event receivers, the metrics registry, the span tracer, the run
# ledger, the telemetry sink, the manifest) and the native host helpers.
# A call into them does not propagate the round's path.
_HOST_MODULES = frozenset(_PKG + "/" + m for m in (
    "simulation/report.py", "simulation/events.py",
    "telemetry/metrics.py", "telemetry/tracing.py", "telemetry/ledger.py",
    "telemetry/sink.py", "telemetry/manifest.py",
    # numpy and ctypes over host memory (the graph generator, the pool's
    # row copies on the native worker thread).
    "native/__init__.py", "native/rows.py"))

# Host reads of a tensor that do not wait for the card.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "itemsize", "names",
                 # SimState.round / CohortPool.round: a host int; the
                 # sequential engine's queued message: its host record
                 # and reply flag.
                 "round", "rec", "is_reply"}
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "is_contiguous", "data_ptr", "stride", "get_device",
                   "is_floating_point", "storage_offset"}
# Calls that read a tensor onto the host (their result is a host value).
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_COERCIONS = {"float", "int", "bool"}
# torch calls that make a new tensor on the host unless given ``device=``
# (or that always do: from_numpy); a call with ``generator=`` and no
# ``device=`` draws from the CPU generators the port's draws use.
_TORCH_CREATE = {"empty", "zeros", "ones", "full", "arange", "rand", "randn",
                 "randint", "randperm", "linspace", "eye", "from_numpy",
                 "empty_strided", "tensor"}
# torch.* results that are not tensors.
_TORCH_HOST = {"cuda", "device", "Generator", "is_tensor", "finfo", "iinfo",
               "no_grad", "enable_grad", "inference_mode", "profiler",
               "get_default_dtype", "is_floating_point", "dtype", "Size"}

# Generic container/str method names: an ``obj.m(...)`` call with one of
# these names never resolves to a repo method (keeps ``stats.update(...)``
# from pulling every handler ``update`` onto the path).
_METHOD_DENYLIST = {
    "append", "add", "extend", "insert", "pop", "remove", "clear", "copy",
    "get", "items", "keys", "values", "setdefault", "update", "split",
    "join", "strip", "startswith", "endswith", "format", "encode", "decode",
    "write", "read", "close", "flush", "sum", "mean", "max", "min", "all",
    "any", "astype", "reshape", "tolist", "item", "index", "count", "sort",
    "total", "cpu", "numpy", "to", "copy_", "clone", "view", "long", "int",
    "float", "bool", "wait", "record", "synchronize", "set", "start", "run",
}

_STAT_KEY_RE = re.compile(r"^(probe|health|chaos|perf|cohort)_[a-z0-9_]+$")
_SUPPRESS_RE = re.compile(r"#\s*tracelint:\s*disable=([a-z\-,\s]+|all)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*tracelint:\s*disable-file=([a-z\-,\s]+|all)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, posix separators
    line: int
    col: int
    message: str
    snippet: str       # stripped source line (finding identity basis)

    @property
    def key(self) -> str:
        digest = hashlib.sha1(self.snippet.encode()).hexdigest()[:12]
        return f"{self.rule}|{self.path}|{digest}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet, "key": self.key}

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


# ---------------------------------------------------------------------------
# Module model


@dataclass
class _Func:
    module: str                       # relpath
    qualname: str
    node: ast.AST                     # FunctionDef / AsyncFunctionDef / Lambda
    class_name: Optional[str]
    parent: Optional["_Func"]         # lexically enclosing function

    @property
    def uid(self) -> tuple:
        return (self.module, self.qualname)

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")


class _Module:
    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        # Qualnames are NOT unique (e.g. the same nested name defined in
        # both branches of an if) — every index maps to a list.
        self.funcs: dict[str, list] = {}
        self.by_node: dict[int, _Func] = {}
        self.classes: dict[str, dict] = {}   # name -> {bases, methods}
        self.imports: dict[str, str] = {}    # local name -> dotted module
        self.from_imports: dict[str, tuple] = {}  # name -> (module, orig)

    def dotted(self) -> str:
        return self.relpath[:-3].replace("/", ".")


def _resolve_relative(module_dotted: str, node: ast.ImportFrom) -> str:
    if node.level == 0:
        return node.module or ""
    parts = module_dotted.split(".")
    base = parts[: len(parts) - node.level]
    if node.module:
        base.append(node.module)
    return ".".join(base)


class _Indexer(ast.NodeVisitor):
    """One pass per module: functions (with lexical parents), classes,
    imports."""

    def __init__(self, mod: _Module):
        self.mod = mod
        self.class_stack: list[str] = []
        self.func_stack: list[_Func] = []

    def _qual(self, name: str) -> str:
        if self.func_stack:
            return self.func_stack[-1].qualname + ".<locals>." + name
        if self.class_stack:
            return ".".join(self.class_stack) + "." + name
        return name

    def _visit_func(self, node):
        fn = _Func(self.mod.relpath, self._qual(node.name), node,
                   self.class_stack[-1] if self.class_stack
                   and not self.func_stack else None,
                   self.func_stack[-1] if self.func_stack else None)
        self.mod.funcs.setdefault(fn.qualname, []).append(fn)
        self.mod.by_node[id(node)] = fn
        if fn.class_name is not None:
            self.mod.classes[fn.class_name]["methods"].setdefault(
                node.name, []).append(fn)
        self.func_stack.append(fn)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef):
        bases = [b.id if isinstance(b, ast.Name) else b.attr
                 for b in node.bases
                 if isinstance(b, (ast.Name, ast.Attribute))]
        self.mod.classes.setdefault(node.name,
                                    {"bases": bases, "methods": {}})
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            self.mod.imports[alias.asname or alias.name.split(".")[0]] = \
                alias.name

    def visit_ImportFrom(self, node: ast.ImportFrom):
        src = _resolve_relative(self.mod.dotted(), node)
        for alias in node.names:
            self.mod.from_imports[alias.asname or alias.name] = \
                (src, alias.name)


# ---------------------------------------------------------------------------
# Repo model: all modules, cross-module resolution, the round's path


class _Repo:
    def __init__(self, modules: list[_Module]):
        self.modules = {m.relpath: m for m in modules}
        self.by_dotted = {m.dotted(): m for m in modules}
        self.method_index: dict[str, list[_Func]] = {}
        self.subclasses: dict[str, set] = {}   # class name -> subclass names
        self.class_home: dict[str, _Module] = {}
        for m in modules:
            for cname, info in m.classes.items():
                self.class_home.setdefault(cname, m)
                for fns in info["methods"].values():
                    for fn in fns:
                        self.method_index.setdefault(fn.name,
                                                     []).append(fn)
        for m in modules:
            for cname, info in m.classes.items():
                for b in info["bases"]:
                    self.subclasses.setdefault(b, set()).add(cname)

    def transitive_subclasses(self, cname: str) -> set:
        out, todo = set(), [cname]
        while todo:
            c = todo.pop()
            for s in self.subclasses.get(c, ()):
                if s not in out:
                    out.add(s)
                    todo.append(s)
        return out

    def class_chain(self, cname: str) -> list:
        """cname + its repo base classes, transitively (MRO-ish order)."""
        out, todo = [], [cname]
        while todo:
            c = todo.pop(0)
            if c in out:
                continue
            out.append(c)
            home = self.class_home.get(c)
            if home is not None:
                todo.extend(home.classes[c]["bases"])
        return out

    def find_method(self, cname: str, mname: str) -> list:
        """Resolve ``self.mname`` inside class ``cname``: the defining class
        up the chain, PLUS every subclass override below ``cname`` (a base
        method on the round's path puts the variant overrides there too)."""
        hits = []
        for c in self.class_chain(cname):
            home = self.class_home.get(c)
            if home is not None and mname in home.classes[c]["methods"]:
                hits.extend(home.classes[c]["methods"][mname])
                break
        for sub in self.transitive_subclasses(cname):
            home = self.class_home.get(sub)
            if home is not None and mname in home.classes[sub]["methods"]:
                hits.extend(home.classes[sub]["methods"][mname])
        return hits

    def module_func(self, mod: _Module, name: str,
                    context: Optional[_Func]) -> list:
        # Lexical chain: nested defs of the context (and its ancestors),
        # then module level, then repo-internal imports.
        seen = context
        while seen is not None:
            q = seen.qualname + ".<locals>." + name
            if q in mod.funcs:
                return list(mod.funcs[q])
            seen = seen.parent
        if name in mod.funcs:
            return list(mod.funcs[name])
        if name in mod.from_imports:
            src, orig = mod.from_imports[name]
            target = self.by_dotted.get(src)
            if target is not None and orig in target.funcs:
                return list(target.funcs[orig])
            # ``from .x import SomeClass`` — methods resolve via attr calls.
        return []

    def resolve_call(self, mod: _Module, call: ast.Call,
                     context: Optional[_Func]) -> list:
        f = call.func
        if isinstance(f, ast.Name):
            return self.module_func(mod, f.id, context)
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name):
                root = f.value.id
                if root in ("self", "cls"):
                    cname = _enclosing_class(context)
                    if cname is not None:
                        return self.find_method(cname, f.attr)
                    return []
                if root in mod.imports:
                    # An imported module: resolve inside it when it is a
                    # repo module, NEVER fall through to the generic method
                    # index (torch.randint must not resolve to some
                    # repo method named ``randint``).
                    target = self.by_dotted.get(mod.imports[root])
                    if target is not None and f.attr in target.funcs:
                        return list(target.funcs[f.attr])
                    return []
                if root in mod.from_imports:  # imported repo class/submodule
                    src, orig = mod.from_imports[root]
                    target = self.by_dotted.get(src + "." + orig) \
                        or self.by_dotted.get(src)
                    if target is not None:
                        if f.attr in target.funcs:
                            return list(target.funcs[f.attr])
                        if orig in target.classes:
                            return self.find_method(orig, f.attr)
                    return []
            elif not isinstance(f.value, (ast.Attribute, ast.Call)):
                return []
            else:
                # Nested chain (a.b.m / f().m): external when it roots at
                # an imported non-repo module (torch.nn.functional.relu).
                root = f.value
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in mod.imports \
                        and mod.imports[root.id] not in self.by_dotted:
                    return []
            # obj.m(...): any repo method named m (heuristic; the generic
            # names in the denylist stay host-side).
            if f.attr not in _METHOD_DENYLIST:
                return self.method_index.get(f.attr, [])
        return []


def _enclosing_class(fn: Optional[_Func]) -> Optional[str]:
    while fn is not None:
        if fn.class_name is not None:
            return fn.class_name
        fn = fn.parent
    return None


def _callee_suffix(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_torch_chain(expr: ast.AST) -> bool:
    """Does this callee chain root at ``torch`` (and make a tensor: not
    ``torch.cuda.*``, ``torch.device`` and the like)?"""
    names = []
    while isinstance(expr, ast.Attribute):
        names.append(expr.attr)
        expr = expr.value
    if not (isinstance(expr, ast.Name) and expr.id == "torch"):
        return False
    return not names or names[-1] not in _TORCH_HOST


def _host_creation(call: ast.Call) -> bool:
    """A ``torch.*`` creation call that makes a host tensor: one of
    :data:`_TORCH_CREATE` without ``device=`` (``torch.tensor`` of a
    literal only), or any draw from a generator without ``device=``."""
    kws = {k.arg for k in call.keywords}
    if "device" in kws:
        return False
    suffix = _callee_suffix(call)
    if suffix == "tensor":
        return all(isinstance(a, (ast.List, ast.Tuple, ast.Constant))
                   for a in call.args)
    return suffix in _TORCH_CREATE or "generator" in kws


def _is_cuda_synchronize(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "synchronize"
            and isinstance(f.value, ast.Attribute) and f.value.attr == "cuda")


def _is_to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    vals = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu"
               for v in vals)


def _own_nodes(fn_node: ast.AST):
    """Walk a function's OWN code: descend lambdas (they run inline) but
    never nested ``def``s, which join the path only through the call
    graph."""
    todo = list(ast.iter_child_nodes(fn_node))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            todo.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# Taint-based rules inside one function on the round's path


# By name: the simulator and its config, devices and generators, the
# host report and tracer, and the round counters and sizes the port
# passes as Python ints.
_STATIC_PARAM_NAMES = {"self", "cls", "sim", "cfg", "config", "mesh",
                       "device", "dev", "generator", "report", "tracer",
                       "tr", "dtype", "r", "r0", "last_round", "first_round",
                       "n_rounds", "n", "k", "seg", "purpose", "sub",
                       "call_tag", "t", "e", "i", "count", "kernel",
                       "axis_name"}
# By annotation: Python scalars and containers, topologies and meshes,
# numpy arrays, and the host-resident records (the cohort pool and its
# store, the sequential engine's message records).
_STATIC_ANNOTATIONS = {"bool", "int", "float", "str", "bytes", "dict",
                       "list", "tuple", "set", "Mesh", "Topology",
                       "SparseTopology", "ndarray", "device",
                       "DrawProvider", "Tracer", "CohortPool", "PoolStore",
                       "MessageRecord", "_Ring"}


def _param_is_static(a: ast.arg) -> bool:
    """Parameters that hold no tensor by contract: config objects and
    parameters annotated with a Python scalar or container type."""
    if a.arg in _STATIC_PARAM_NAMES or a.arg.endswith("dtype"):
        return True
    if a.annotation is None:
        return False
    names = {n.id for n in ast.walk(a.annotation)
             if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(a.annotation)
              if isinstance(n, ast.Attribute)}
    for n in ast.walk(a.annotation):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            names.add(n.value)
    if "Tensor" in names:
        return False
    return any(n in _STATIC_ANNOTATIONS or n.endswith("Config")
               for n in names)


class _TaintLinter(ast.NodeVisitor):
    def __init__(self, mod: _Module, fn_node: ast.AST, findings: list):
        self.mod = mod
        self.findings = findings
        self.tainted: set = set()
        args = fn_node.args
        ordered = args.posonlyargs + args.args
        for a in (ordered + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            if not _param_is_static(a):
                self.tainted.add(a.arg)
        body = fn_node.body
        self._nodes = body if isinstance(body, list) else [body]

    def run(self):
        for stmt in self._nodes:
            self.visit(stmt)

    # -- taint query ------------------------------------------------------

    def _is_tainted(self, expr: ast.AST) -> bool:
        if expr is None:
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self.tainted
        if isinstance(expr, ast.Attribute):
            if expr.attr in _STATIC_ATTRS:
                return False
            return self._is_tainted(expr.value)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in expr.ops):
                return False  # identity and membership tests stay on host
            return self._is_tainted(expr.left) or \
                any(self._is_tainted(c) for c in expr.comparators)
        if isinstance(expr, ast.Call):
            suffix = _callee_suffix(expr)
            f = expr.func
            if isinstance(f, ast.Name) and suffix in {
                    "len", "isinstance", "getattr", "hasattr", "type", "id",
                    "repr", "str", "callable"} | _COERCIONS:
                return False
            if isinstance(f, ast.Attribute):
                if suffix in _SYNC_METHODS | _STATIC_METHODS:
                    return False
                if _is_to_cpu(expr):
                    return False
                root = f.value
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in (
                        "np", "numpy", "math"):
                    return False  # a host value
            if _is_torch_chain(f):
                return not _host_creation(expr)
            return self._is_tainted(f) or \
                any(self._is_tainted(a) for a in expr.args) or \
                any(self._is_tainted(k.value) for k in expr.keywords)
        if isinstance(expr, ast.BinOp):
            return self._is_tainted(expr.left) or self._is_tainted(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self._is_tainted(expr.operand)
        if isinstance(expr, ast.BoolOp):
            return any(self._is_tainted(v) for v in expr.values)
        if isinstance(expr, ast.IfExp):
            return self._is_tainted(expr.body) or \
                self._is_tainted(expr.orelse)
        if isinstance(expr, ast.Subscript):
            return self._is_tainted(expr.value)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self._is_tainted(e) for e in expr.elts)
        if isinstance(expr, ast.Dict):
            return any(self._is_tainted(v) for v in expr.values)
        if isinstance(expr, ast.Starred):
            return self._is_tainted(expr.value)
        if isinstance(expr, ast.NamedExpr):
            return self._is_tainted(expr.value)
        return False

    def _taint_target(self, target: ast.AST):
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._taint_target(el)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value)

    def _untaint_target(self, target: ast.AST):
        if isinstance(target, ast.Name):
            self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._untaint_target(el)

    # -- findings ---------------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, message: str):
        line = getattr(node, "lineno", 1)
        text = self.mod.lines[line - 1].strip() \
            if 0 < line <= len(self.mod.lines) else ""
        self.findings.append(Finding(
            rule=rule, path=self.mod.relpath, line=line,
            col=getattr(node, "col_offset", 0), message=message,
            snippet=text))

    # -- statements (visited in order; one flat scope) --------------------

    def visit_Assign(self, node: ast.Assign):
        self.visit(node.value)
        if self._is_tainted(node.value):
            for t in node.targets:
                self._taint_target(t)
        else:
            for t in node.targets:
                self._untaint_target(t)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self.visit(node.value)
            if self._is_tainted(node.value):
                self._taint_target(node.target)
            else:
                self._untaint_target(node.target)

    def visit_AugAssign(self, node: ast.AugAssign):
        self.visit(node.value)
        if self._is_tainted(node.value):
            self._taint_target(node.target)

    def visit_NamedExpr(self, node: ast.NamedExpr):
        self.visit(node.value)
        if self._is_tainted(node.value):
            self._taint_target(node.target)

    def visit_If(self, node: ast.If):
        if self._is_tainted(node.test):
            self._emit("host-sync", node,
                       "`if` on a tensor waits for the card to decide the "
                       "branch (keep the choice on the card with "
                       "torch.where, or read it once per run)")
        self.visit(node.test)
        for s in node.body + node.orelse:
            self.visit(s)

    def visit_While(self, node: ast.While):
        if self._is_tainted(node.test):
            self._emit("host-sync", node,
                       "`while` on a tensor waits for the card every "
                       "iteration")
        self.generic_visit(node)

    def visit_For(self, node: ast.For):
        # Iterating a tensor unbinds it on the card (no wait); the loop
        # variables carry the taint.
        if self._is_tainted(node.iter):
            self._taint_target(node.target)
        self.visit(node.iter)
        for s in node.body + node.orelse:
            self.visit(s)

    def visit_Assert(self, node: ast.Assert):
        if self._is_tainted(node.test):
            self._emit("host-sync", node,
                       "`assert` on a tensor waits for the card (assert "
                       "on shapes, or check after the run)")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp):
        if self._is_tainted(node.test):
            self._emit("host-sync", node,
                       "ternary on a tensor waits for the card (use "
                       "torch.where)")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        suffix = _callee_suffix(node)
        if _is_cuda_synchronize(node):
            self._emit("host-sync", node,
                       "`torch.cuda.synchronize()` on the round's path "
                       "waits for every queued kernel")
        elif isinstance(node.func, ast.Name) and \
                node.func.id in _COERCIONS and node.args and \
                self._is_tainted(node.args[0]):
            self._emit("host-sync", node,
                       f"`{node.func.id}()` of a tensor copies it to the "
                       "host and waits for the card")
        elif isinstance(node.func, ast.Attribute) and \
                (suffix in _SYNC_METHODS or _is_to_cpu(node)) and \
                self._is_tainted(node.func.value):
            self._emit("host-sync", node,
                       f"`.{suffix}()` of a tensor copies it to the host "
                       "and waits for the card")
        elif isinstance(node.func, ast.Attribute):
            root = node.func.value
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and \
                    root.id in ("np", "numpy") and \
                    (any(self._is_tainted(a) for a in node.args)
                     or any(self._is_tainted(k.value)
                            for k in node.keywords)):
                self._emit("np-in-round", node,
                           f"`{root.id}.{suffix}` on a tensor copies it to "
                           "the host (a sync; on a CUDA tensor numpy "
                           "raises): use torch")
        self.generic_visit(node)

    def _skip_nested(self, node):
        # Nested defs join the path through the call graph; lambdas are
        # linted as regions of their own.
        pass

    visit_FunctionDef = _skip_nested
    visit_AsyncFunctionDef = _skip_nested
    visit_Lambda = _skip_nested


# ---------------------------------------------------------------------------
# Registry rules (repo-level)


def _literal_str_tuples(mod: _Module) -> dict[str, tuple]:
    """Module-level ``NAME = ("a", "b", ...)`` assignments, resolving
    ``A + B`` concatenations of previously seen names."""
    out: dict[str, tuple] = {}

    def eval_expr(expr) -> Optional[tuple]:
        if isinstance(expr, (ast.Tuple, ast.List)):
            vals = []
            for el in expr.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    vals.append(el.value)
                else:
                    return None
            return tuple(vals)
        if isinstance(expr, ast.Name):
            return out.get(expr.id)
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            left, right = eval_expr(expr.left), eval_expr(expr.right)
            if left is not None and right is not None:
                return left + right
        return None

    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            val = eval_expr(node.value)
            if val is not None:
                out[node.targets[0].id] = val
    return out


def _registry_rule(modules: dict, findings: list):
    report = modules.get(_REPORT_MODULE)
    if report is None:
        return
    tuples = _literal_str_tuples(report)
    registry = set(tuples.get("PER_ROUND_FIELDS", ())) | \
        set(tuples.get("STATIC_FIELDS", ()))
    if not registry:
        return

    def check_key(key: str, mod: _Module, node: ast.AST):
        if _STAT_KEY_RE.match(key) and key not in registry:
            line = getattr(node, "lineno", 1)
            text = mod.lines[line - 1].strip() \
                if 0 < line <= len(mod.lines) else ""
            findings.append(Finding(
                rule="registry-field", path=mod.relpath, line=line,
                col=getattr(node, "col_offset", 0),
                message=f"per-round stat key {key!r} is not in "
                        "report.PER_ROUND_FIELDS/STATIC_FIELDS — it would "
                        "be silently dropped by "
                        "to_dict/from_dict/concatenate",
                snippet=text))

    for relpath, mod in modules.items():
        if not (relpath.startswith(_PKG + "/simulation/")
                or relpath.startswith(_PKG + "/telemetry/")):
            continue
        # (a) declared stat-key tuples (PROBE_STAT_KEYS & co.)
        for name, vals in _literal_str_tuples(mod).items():
            if name.endswith(("_KEYS", "_FIELDS")) and \
                    relpath != _REPORT_MODULE:
                for node in mod.tree.body:
                    if isinstance(node, ast.Assign) and \
                            isinstance(node.targets[0], ast.Name) and \
                            node.targets[0].id == name:
                        for key in vals:
                            check_key(key, mod, node)
        # (b) direct stores into the round stats dict:
        #     stats["health_x"] = ... / extras["probe_y"] = ...
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in ("stats", "extras") and \
                            isinstance(t.slice, ast.Constant) and \
                            isinstance(t.slice.value, str):
                        check_key(t.slice.value, mod, node)


def _schema_rule(modules: dict, findings: list):
    mod = modules.get(_EVENTS_MODULE)
    if mod is None:
        return
    schema_val, schema_node = None, None
    tolerated = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and \
                node.name == "JSONLinesReceiver":
            for item in node.body:
                if isinstance(item, ast.Assign) and \
                        isinstance(item.targets[0], ast.Name) and \
                        item.targets[0].id == "SCHEMA" and \
                        isinstance(item.value, ast.Constant):
                    schema_val, schema_node = item.value.value, item
                if isinstance(item, ast.FunctionDef) and \
                        item.name == "parse_line":
                    for cmp in ast.walk(item):
                        if isinstance(cmp, ast.Compare) and \
                                len(cmp.ops) == 1 and \
                                isinstance(cmp.ops[0], (ast.Lt, ast.LtE)):
                            c = cmp.comparators[0]
                            if isinstance(c, ast.Constant) and \
                                    isinstance(c.value, int):
                                bound = c.value
                                if isinstance(cmp.ops[0], ast.LtE):
                                    bound += 1
                                tolerated.append(bound)
    if schema_val is None:
        return
    max_tol = max(tolerated) if tolerated else 1
    if schema_val > max_tol:
        line = schema_node.lineno
        findings.append(Finding(
            rule="schema-tolerance", path=mod.relpath, line=line,
            col=schema_node.col_offset,
            message=f"JSONLinesReceiver.SCHEMA = {schema_val} but "
                    f"parse_line only tolerates versions < {max_tol + 1} "
                    f"(add an `if schema < {schema_val}:` defaulting branch "
                    "for the new fields)",
            snippet=mod.lines[line - 1].strip()))


# ---------------------------------------------------------------------------
# Driver


def _file_disabled(mod: _Module) -> set:
    """Rules disabled for the whole file via a ``# tracelint:
    disable-file=...`` pragma in the first 30 lines ({"all"} disables
    everything)."""
    out: set = set()
    for line in mod.lines[:30]:
        m = _SUPPRESS_FILE_RE.search(line)
        if m:
            rules = m.group(1).strip()
            if rules == "all":
                return {"all"}
            out |= {r.strip() for r in rules.split(",")}
    return out


def _suppressed(mod: _Module, finding: Finding) -> bool:
    disabled = _file_disabled(mod)
    if "all" in disabled or finding.rule in disabled:
        return True
    if not (0 < finding.line <= len(mod.lines)):
        return False
    m = _SUPPRESS_RE.search(mod.lines[finding.line - 1])
    if not m:
        return False
    rules = m.group(1).strip()
    if rules == "all":
        return True
    return finding.rule in {r.strip() for r in rules.split(",")}


@functools.lru_cache(maxsize=1024)
def _indexed_module(rel: str, text: str) -> _Module:
    """One module parsed and indexed (read-only afterwards: cached by its
    path and text)."""
    try:
        mod = _Module(rel, text)
    except SyntaxError as e:
        raise SyntaxError(f"{rel}: {e}") from e
    _Indexer(mod).visit(mod.tree)
    return mod


def _root_functions(modules: dict) -> list:
    """The :data:`ROOTS` that resolve to a function of the linted tree."""
    out = []
    for rel, qual in ROOTS:
        mod = modules.get(rel)
        if mod is not None:
            out.extend(mod.funcs.get(qual, []))
    return out


def resolve_roots(root) -> dict:
    """``{"module:qualname": resolved?}`` for every :data:`ROOTS` entry
    over the tree under ``root``."""
    root = Path(root)
    out = {}
    for rel, qual in ROOTS:
        path = root / rel
        ok = False
        if path.is_file():
            ok = qual in _indexed_module(rel, path.read_text()).funcs
        out[f"{rel}:{qual}"] = ok
    return out


def run_tracelint(root, sources: Optional[dict] = None,
                  package: str = _PKG, roots: Optional[list] = None) -> list:
    """Lint every ``.py`` under ``root/package``.

    ``sources`` maps repo-relative posix paths to replacement text (the
    tests inject violations through it without touching disk); ``roots``
    adds ``(module, qualname)`` roots to :data:`ROOTS`. Returns
    unsuppressed findings sorted by (path, line).
    """
    root = Path(root)
    texts: dict[str, str] = {}
    for p in sorted((root / package).rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        if "__pycache__" in rel:
            continue
        texts[rel] = p.read_text()
    if sources:
        texts.update(sources)

    modules = {rel: _indexed_module(rel, text) for rel, text in texts.items()}
    repo = _Repo(list(modules.values()))

    on_path: dict[int, _Func] = {}       # id(node) -> _Func
    worklist: list[_Func] = []

    def add(fn: _Func):
        if fn.module in _HOST_MODULES:
            return
        if id(fn.node) not in on_path:
            on_path[id(fn.node)] = fn
            worklist.append(fn)

    for fn in _root_functions(modules):
        add(fn)
    for rel, qual in roots or ():
        mod = modules.get(rel)
        for fn in (mod.funcs.get(qual, []) if mod is not None else []):
            add(fn)

    # Propagate through repo-internal calls. Only a function's OWN code
    # propagates; nested defs join through resolve_call.
    while worklist:
        fn = worklist.pop()
        mod = modules[fn.module]
        for node in _own_nodes(fn.node):
            if isinstance(node, ast.Call):
                for callee in repo.resolve_call(mod, node, fn):
                    add(callee)

    findings: list[Finding] = []
    lambdas = []
    for fn in on_path.values():
        mod = modules[fn.module]
        _TaintLinter(mod, fn.node, findings).run()
        for node in _own_nodes(fn.node):
            if isinstance(node, ast.Lambda):
                lambdas.append((mod, node))
    for mod, lam in lambdas:
        _TaintLinter(mod, lam, findings).run()
    _registry_rule(modules, findings)
    _schema_rule(modules, findings)

    out = [f for f in findings if not _suppressed(modules[f.path], f)]
    # The same (rule, path, line) can fire through several paths (a
    # method reached from two roots): report it once.
    seen, unique = set(), []
    for f in sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule)):
        k = (f.rule, f.path, f.line, f.col)
        if k not in seen:
            seen.add(k)
            unique.append(f)
    return unique


# ---------------------------------------------------------------------------
# Baseline


def baseline_from_findings(findings: list) -> dict:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.key] = counts.get(f.key, 0) + 1
    return {"version": 1, "findings": counts}


def load_baseline(path) -> dict:
    p = Path(path)
    if not p.exists():
        return {"version": 1, "findings": {}}
    return json.loads(p.read_text())


def filter_baselined(findings: list, baseline: dict) -> list:
    """Findings NOT covered by the baseline (per-key occurrence budget)."""
    budget = dict(baseline.get("findings", {}))
    new = []
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
        else:
            new.append(f)
    return new
