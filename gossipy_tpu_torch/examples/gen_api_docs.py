"""Generate the markdown API reference of the port into docs/api_torch/.

The twin of ``scripts/gen_api_docs.py``: one markdown page per public
module, made by introspection (``importlib`` and ``inspect``): the module
docstring, the public classes (constructor and public-method signatures
and docstrings) and the public functions, plus an index. ``MODULES`` is
the JAX script's list, module for module (``analysis.hlo`` becomes
``analysis.program``, its counterpart), then the port's own public
modules. It imports nothing of JAX. Regenerate after an API change:

    python -m gossipy_tpu_torch.examples.gen_api_docs [OUT_DIR]

``docs/api/`` holds the JAX package's pages and is not touched.
"""

from __future__ import annotations

import importlib
import inspect
import os
import re
import sys
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MODULES = [
    "gossipy_tpu_torch",
    "gossipy_tpu_torch.core",
    "gossipy_tpu_torch.data",
    "gossipy_tpu_torch.data.handler",
    "gossipy_tpu_torch.handlers.base",
    "gossipy_tpu_torch.handlers.sgd",
    "gossipy_tpu_torch.handlers.linear",
    "gossipy_tpu_torch.handlers.mf",
    "gossipy_tpu_torch.handlers.kmeans",
    "gossipy_tpu_torch.handlers.losses",
    "gossipy_tpu_torch.models.nn",
    "gossipy_tpu_torch.simulation.engine",
    "gossipy_tpu_torch.simulation.sequential",
    "gossipy_tpu_torch.simulation.nodes",
    "gossipy_tpu_torch.simulation.variants",
    "gossipy_tpu_torch.simulation.events",
    "gossipy_tpu_torch.simulation.faults",
    "gossipy_tpu_torch.simulation.cohort",
    "gossipy_tpu_torch.simulation.report",
    "gossipy_tpu_torch.telemetry.cost",
    "gossipy_tpu_torch.telemetry.metrics",
    "gossipy_tpu_torch.telemetry.tracing",
    "gossipy_tpu_torch.analysis.tracelint",
    "gossipy_tpu_torch.analysis.program",
    "gossipy_tpu_torch.flow_control",
    "gossipy_tpu_torch.compression",
    "gossipy_tpu_torch.checkpoint",
    "gossipy_tpu_torch.config",
    "gossipy_tpu_torch.service.spec",
    "gossipy_tpu_torch.service.packer",
    "gossipy_tpu_torch.service.scheduler",
    "gossipy_tpu_torch.service.slo",
    "gossipy_tpu_torch.parallel",
    "gossipy_tpu_torch.parallel.rules",
    "gossipy_tpu_torch.parallel.collectives",
    "gossipy_tpu_torch.ops.attention",
    "gossipy_tpu_torch.ops.merge",
    "gossipy_tpu_torch.utils",
    "gossipy_tpu_torch.native",
    # The port's own public modules.
    "gossipy_tpu_torch.convert",
    "gossipy_tpu_torch.optim",
    "gossipy_tpu_torch.random",
    "gossipy_tpu_torch.entry",
]


def _sig(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"
    # Default-value reprs of module-level sentinels embed live memory
    # addresses ("<... object at 0x7f...>"), and default paths the
    # checkout's location; strip both so that a regeneration changes no
    # page that the API did not change.
    sig = sig.replace(_REPO + os.sep, "")
    return re.sub(r" at 0x[0-9a-f]+", "", sig)


def _doc(obj) -> str:
    return inspect.getdoc(obj) or ""


def _is_public_member(name: str, obj, mod) -> bool:
    if name.startswith("_"):
        return False
    return getattr(obj, "__module__", None) == mod.__name__


def render_module(modname: str) -> tuple[str, str]:
    """Returns (markdown page, first docstring line for the index)."""
    mod = importlib.import_module(modname)
    first = ""
    out = [f"# `{modname}`", ""]
    if mod.__doc__:
        clean = inspect.cleandoc(mod.__doc__)
        first = clean.splitlines()[0]
        out += [clean, ""]

    classes = [(n, o) for n, o in inspect.getmembers(mod, inspect.isclass)
               if _is_public_member(n, o, mod)]
    funcs = [(n, o) for n, o in inspect.getmembers(mod, inspect.isfunction)
             if _is_public_member(n, o, mod)]

    for name, cls in classes:
        out += [f"## class `{name}{_sig(cls)}`", ""]
        d = _doc(cls)
        if d:
            out += [d, ""]
        for mname, meth in inspect.getmembers(cls, inspect.isfunction):
            if mname.startswith("_") or mname not in cls.__dict__:
                continue
            out += [f"### `{name}.{mname}{_sig(meth)}`", ""]
            md = _doc(meth)
            if md:
                out += [md, ""]

    for name, fn in funcs:
        out += [f"## `{name}{_sig(fn)}`", ""]
        d = _doc(fn)
        if d:
            out += [d, ""]
    return "\n".join(out).rstrip() + "\n", first


def page_name(modname: str) -> str:
    return modname.replace(".", "_") + ".md"


def main(out_dir: Optional[str] = None) -> int:
    """Write one page per module of ``MODULES`` and ``index.md`` into
    ``out_dir`` (default ``docs/api_torch/`` of the checkout); returns the
    number of module pages."""
    api_dir = out_dir or os.path.join(_REPO, "docs", "api_torch")
    os.makedirs(api_dir, exist_ok=True)
    index = ["# gossipy_tpu_torch API reference", "",
             "Generated by `python -m gossipy_tpu_torch.examples."
             "gen_api_docs` (regenerate after API changes). One page per "
             "module:", ""]
    for modname in MODULES:
        fname = page_name(modname)
        text, first = render_module(modname)
        with open(os.path.join(api_dir, fname), "w") as fh:
            fh.write(text)
        index.append(f"- [`{modname}`]({fname}) — {first}")
        print(f"wrote {fname}")
    with open(os.path.join(api_dir, "index.md"), "w") as fh:
        fh.write("\n".join(index) + "\n")
    print(f"wrote index.md ({len(MODULES)} modules)")
    return len(MODULES)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
