"""The API reference twin (``gossipy_tpu_torch/examples/gen_api_docs.py``)
against ``scripts/gen_api_docs.py``.

- Its ``MODULES`` is the JAX script's list mapped module for module
  (``analysis.hlo`` to ``analysis.program``), then the port's own public
  modules. The JAX script is loaded by path: it imports no JAX.
- ``main(out_dir=...)`` renders every page with JAX and the JAX package
  blocked (the isolation test's blocker), and the index lists every
  module.
- The committed pages (``docs/api_torch/``) are what the generator writes
  today, and none calls the sequential engine or the cohort "not ported".
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gossipy_tpu_torch.examples import gen_api_docs as twin

REPO = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "chex", "gossipy_tpu",
          "networkx", "sklearn")
OWN = ["gossipy_tpu_torch.convert", "gossipy_tpu_torch.optim",
       "gossipy_tpu_torch.random", "gossipy_tpu_torch.entry"]


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_api_docs", REPO / "scripts" / "gen_api_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin_name(jax_name: str) -> str:
    name = "gossipy_tpu_torch" + jax_name[len("gossipy_tpu"):]
    return {"gossipy_tpu_torch.analysis.hlo":
            "gossipy_tpu_torch.analysis.program"}.get(name, name)


def test_modules_map_the_jax_list_one_to_one():
    jmods = jax_script().MODULES
    assert twin.MODULES == [twin_name(m) for m in jmods] + OWN
    assert len(set(twin.MODULES)) == len(twin.MODULES)


def test_sig_strips_addresses_and_the_checkout():
    class Sentinel:
        pass

    def f(a=Sentinel(), p=os.path.join(twin._REPO, "x", "y.cpp")):
        pass

    sig = twin._sig(f)
    assert " at 0x" not in sig and twin._REPO not in sig
    assert os.path.join("x", "y.cpp") in sig
    assert twin._sig(len) in ("(obj, /)", "(...)")


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """Every page, rendered in a process where JAX, the JAX package and
    the other banned modules cannot import."""
    out = tmp_path_factory.mktemp("api_torch")
    code = ("import sys\n"
            f"for m in {BANNED!r}:\n"
            "    sys.modules[m] = None\n"
            "from gossipy_tpu_torch.examples import gen_api_docs\n"
            f"print(gen_api_docs.main(out_dir={str(out)!r}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == str(len(twin.MODULES))
    return out


def test_main_renders_every_page_with_jax_blocked(rendered):
    pages = sorted(p.name for p in rendered.iterdir())
    assert pages == sorted([twin.page_name(m) for m in twin.MODULES]
                           + ["index.md"])
    index = (rendered / "index.md").read_text()
    for m in twin.MODULES:
        assert f"- [`{m}`]({twin.page_name(m)}) — " in index
        page = (rendered / twin.page_name(m)).read_text()
        assert page.startswith(f"# `{m}`\n")


def test_entry_page_documents_the_contract(rendered):
    page = (rendered / "gossipy_tpu_torch_entry.md").read_text()
    for name in ("entry", "dryrun_multichip", "main_leg", "ring_leg",
                 "sparse_leg", "all2all_leg"):
        assert f"## `{name}(" in page
    core = (rendered / "gossipy_tpu_torch_core.md").read_text()
    assert "## `sample_peers(generator" in core
    assert "### `Topology.sample_peers(self, generator" in core
    assert "### `SparseTopology.sample_peers(self, generator" in core


def test_committed_pages_are_current(rendered):
    """``docs/api_torch/`` is the generator's output today (regenerate it
    after an API change)."""
    committed = REPO / "docs" / "api_torch"
    assert sorted(p.name for p in committed.iterdir()) == sorted(
        p.name for p in rendered.iterdir())
    stale = [p.name for p in rendered.iterdir()
             if (committed / p.name).read_text() != p.read_text()]
    assert not stale, stale


@pytest.mark.parametrize("engine", ["sequential", "cohort"])
def test_no_page_calls_a_ported_engine_not_ported(rendered, engine):
    for page in rendered.iterdir():
        for para in page.read_text().split("\n\n"):
            if "not ported" in para:
                assert engine not in para.lower(), (page.name, para)
    events = (rendered / "gossipy_tpu_torch_simulation_events.md").read_text()
    assert f"gossipy_tpu_torch.simulation.{engine}" in events


def test_jax_pages_are_the_jax_script_s():
    """``docs/api/`` keeps the JAX package's pages, one per JAX module."""
    jmods = jax_script().MODULES
    pages = {p.name for p in (REPO / "docs" / "api").iterdir()}
    assert pages == {m.replace(".", "_") + ".md" for m in jmods} | {
        "index.md"}
    assert json.dumps(sorted(pages)).count("gossipy_tpu_torch") == 0
