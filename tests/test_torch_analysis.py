"""The port's tracelint: its rules, roots, pragmas, baseline and CLI.

Mirrors ``tests/test_analysis.py``'s linter half for the rules that keep
their meaning for eager PyTorch (``gossipy_tpu_torch.analysis.tracelint``):

- ``host-sync`` fires on each read that waits for the card, on the
  round's path, and stays quiet on host reads (shapes, ``numel``, host
  tensors, identity tests, annotated ints) and off the path;
- ``np-in-round`` fires on numpy over a tensor and stays quiet on numpy
  over host values;
- the registry meta-test (an unregistered ``health_bogus`` field) and a
  simulated schema bump without a ``parse_line`` branch;
- every named root resolves to a function of the port; a subclass
  override of a root's callee is on the path;
- pragmas and the content-hash baseline waive exactly what they claim,
  across line drift; the committed baseline is today's inventory, each
  entry a finding of the tree;
- ``python -m gossipy_tpu_torch.analysis`` exits 0 on the tree and 1 on
  a seeded fixture.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gossipy_tpu_torch.analysis import (ROOTS, Finding,
                                        baseline_from_findings,
                                        filter_baselined, load_baseline,
                                        resolve_roots, run_tracelint)
from gossipy_tpu_torch.analysis.tracelint import ALL_RULES

REPO = Path(__file__).resolve().parents[1]
PKG = "gossipy_tpu_torch"
SEEDED = f"{PKG}/_seeded.py"


def lint(sources=None, roots=None):
    return run_tracelint(REPO, sources=sources, roots=roots)


def rules_of(findings):
    return sorted({f.rule for f in findings})


def seeded(src, fn="body"):
    """Lint a seeded module with its function ``fn`` as a root; only the
    seeded module's findings."""
    return [f for f in lint({SEEDED: src}, roots=[(SEEDED, fn)])
            if f.path == SEEDED]


# One fire case a form of host sync: (name, body line(s)).
SYNC_FIRES = {
    "item": "v = x.sum().item()",
    "tolist": "v = x.tolist()",
    "cpu": "v = x.cpu()",
    "numpy": "v = x.detach().numpy()",
    "to_cpu": "v = x.to('cpu')",
    "float": "v = float(x.max())",
    "int": "v = int(x[0])",
    "bool": "v = bool((x > 0).any())",
    "if": "if x.any():\n        x = x + 1",
    "while": "while x.sum() > 0:\n        x = x - 1",
    "assert": "assert (x >= 0).all()",
    "ternary": "x = x if x.any() else -x",
    "synchronize": "torch.cuda.synchronize()",
    "torch_result": "y = torch.zeros_like(x)\n    v = y.item()",
}

SYNC_QUIET = {
    "shape": "n = int(x.shape[0])",
    "numel": "n = int(x.numel())",
    "len": "n = len(x)",
    "identity": "if x is None:\n        return x",
    "annotated": "if r:\n        r = r + 1",
    "host_creation": "h = torch.zeros(3)\n    v = h.tolist()",
    "host_generator": "u = torch.rand((3,), generator=g)\n    v = u.tolist()",
    "round": "v = int(state.round)",
}


def _fn(body: str) -> str:
    return ("import numpy as np\nimport torch\n\n"
            "def body(x, state, g, r: int):\n"
            f"    {body}\n    return x\n")


@pytest.mark.parametrize("case", sorted(SYNC_FIRES))
def test_host_sync_fires(case):
    fs = seeded(_fn(SYNC_FIRES[case]))
    assert rules_of(fs) == ["host-sync"], fs
    assert len(fs) == 1, fs


@pytest.mark.parametrize("case", sorted(SYNC_QUIET))
def test_host_sync_quiet(case):
    assert seeded(_fn(SYNC_QUIET[case])) == []


def test_a_synced_value_is_a_host_value():
    """The sync itself fires once; branching on what it returned does
    not."""
    fs = seeded(_fn("v = x.tolist()\n    if v[0]:\n        v = v[1:]"))
    assert [f.snippet for f in fs] == ["v = x.tolist()"]


def test_np_in_round_fires_and_quiet():
    fs = seeded(_fn("v = np.asarray(x)"))
    assert rules_of(fs) == ["np-in-round"]
    assert "np.asarray" in fs[0].message
    assert seeded(_fn("v = np.arange(r)\n    w = np.log(v + 1)")) == []


def test_host_code_off_the_path_is_not_linted():
    src = _fn("v = x.item()") + "\ndef other(x):\n    return x.item()\n"
    assert [f.line for f in seeded(src)] == [5]
    # Without a root the module is off the path: nothing fires.
    assert [f for f in lint({SEEDED: src}) if f.path == SEEDED] == []


def test_call_graph_reaches_helpers_and_nested_defs():
    src = ("import torch\n\n"
           "def helper(a):\n    return a.tolist()\n\n"
           "def body(x):\n"
           "    def inner(y):\n        return float(y.sum())\n"
           "    return helper(x) + [inner(x)]\n")
    fs = seeded(src)
    assert [(f.rule, f.line) for f in fs] == [("host-sync", 4),
                                              ("host-sync", 8)]


def test_subclass_override_of_a_round_callee_is_on_the_path():
    """A variant's override of a method the engine's round calls is on the
    path (subclass overrides resolve as in the JAX linter)."""
    src = ("from .simulation.engine import GossipSimulator\n\n"
           "class _Seeded(GossipSimulator):\n"
           "    def _snapshot(self, state, r: int):\n"
           "        v = state.model.params.sum().item()\n"
           "        return super()._snapshot(state, r)\n")
    fs = [f for f in lint({SEEDED: src}) if f.path == SEEDED]
    assert [(f.rule, f.line) for f in fs] == [("host-sync", 5)]


def test_every_root_resolves_to_a_port_function():
    resolved = resolve_roots(REPO)
    assert len(resolved) == len(ROOTS) >= 10
    assert all(resolved.values()), [k for k, v in resolved.items() if not v]
    assert {r for r, _ in ROOTS} >= {
        f"{PKG}/simulation/engine.py", f"{PKG}/simulation/variants.py",
        f"{PKG}/simulation/sequential.py", f"{PKG}/simulation/cohort.py",
        f"{PKG}/service/scheduler.py"}



def test_a_root_renamed_away_is_reported(tmp_path):
    fixture = tmp_path / PKG / "simulation"
    fixture.mkdir(parents=True)
    text = (REPO / PKG / "simulation" / "cohort.py").read_text()
    (fixture / "cohort.py").write_text(
        text.replace("def cohort_start(", "def cohort_run("))
    resolved = resolve_roots(tmp_path)
    assert resolved[f"{PKG}/simulation/cohort.py:cohort_start"] is False


def test_rules_are_the_ported_ones():
    assert sorted(ALL_RULES) == ["host-sync", "np-in-round",
                                 "registry-field", "schema-tolerance"]


class TestRegistryRules:
    def test_unregistered_per_round_field_is_flagged(self):
        path = f"{PKG}/simulation/engine.py"
        src = (REPO / path).read_text() + (
            "\n\ndef _seeded_stats(stats):\n"
            "    stats[\"health_bogus\"] = 1\n")
        fs = [f for f in lint({path: src}) if f.rule == "registry-field"]
        assert len(fs) == 1 and "health_bogus" in fs[0].message

    def test_registered_fields_pass(self):
        assert [f for f in lint() if f.rule == "registry-field"] == []

    def test_schema_bump_without_parse_line_branch_is_flagged(self):
        path = f"{PKG}/simulation/events.py"
        src = (REPO / path).read_text().replace("SCHEMA = 8", "SCHEMA = 9")
        assert "SCHEMA = 9" in src
        fs = [f for f in lint({path: src}) if f.rule == "schema-tolerance"]
        assert len(fs) == 1 and "if schema < 9" in fs[0].message

    def test_schema_bump_with_branch_passes(self):
        path = f"{PKG}/simulation/events.py"
        src = (REPO / path).read_text().replace("SCHEMA = 8", "SCHEMA = 9")
        src = src.replace(
            "        if schema < 8:",
            "        if schema < 9:\n"
            "            row.setdefault(\"future\", None)\n"
            "        if schema < 8:")
        assert [f for f in lint({path: src})
                if f.rule == "schema-tolerance"] == []


class TestSuppressionAndBaseline:
    SRC = _fn("v = float(x.max())\n    w = x.tolist()")

    def test_line_suppression(self):
        src = self.SRC.replace("v = float(x.max())",
                               "v = float(x.max())  "
                               "# tracelint: disable=host-sync")
        fs = seeded(src)
        assert len(fs) == 1 and "tolist" in fs[0].snippet

    def test_file_pragma(self):
        assert seeded("# tracelint: disable-file=all\n" + self.SRC) == []

    def test_baseline_waives_by_identity_not_line_number(self):
        fs = seeded(self.SRC)
        base = baseline_from_findings(fs)
        assert filter_baselined(fs, base) == []
        shifted = seeded("\n\n\n" + self.SRC)
        assert [f.line for f in shifted] != [f.line for f in fs]
        assert filter_baselined(shifted, base) == []
        more = self.SRC.replace("return x", "q = bool(x.any())\n    return x")
        new = filter_baselined(seeded(more), base)
        assert len(new) == 1 and "bool" in new[0].snippet

    def test_committed_baseline_is_the_inventory(self):
        """Every host sync on the round's path is in the committed
        baseline, and every baseline entry is a finding of the tree."""
        fs = lint()
        base = load_baseline(REPO / PKG / "analysis" / "baseline.json")
        assert filter_baselined(fs, base) == []
        assert base["findings"] == baseline_from_findings(fs)["findings"]
        assert {f.rule for f in fs} == {"host-sync"}
        # The deliberate syncs the engine keeps: the live counts that pick
        # the deliver path and the one read of the rows at start's end.
        snippets = {(f.path.split("/")[-1], f.snippet) for f in fs}
        assert any(p == "engine.py" and "tolist" in s for p, s in snippets)
        assert any(p == "engine.py" and ".cpu().numpy()" in s
                   for p, s in snippets)


class TestCLI:
    def test_exits_zero_on_the_tree(self):
        proc = subprocess.run(
            [sys.executable, "-m", "gossipy_tpu_torch.analysis"],
            capture_output=True, text=True, cwd=REPO, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 new" in proc.stdout

    def test_exits_nonzero_on_seeded_violation(self, tmp_path):
        fixture = tmp_path / "repo"
        shutil.copytree(REPO / PKG, fixture / PKG,
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "_build"))
        target = fixture / PKG / "simulation" / "engine.py"
        target.write_text(target.read_text().replace(
            "        r = state.round\n",
            "        r = state.round\n"
            "        if state.model.params.isnan().any():\n"
            "            r = int(state.model.n_updates.max())\n", 1))
        proc = subprocess.run(
            [sys.executable, "-m", "gossipy_tpu_torch.analysis",
             "--root", str(fixture), "--json",
             str(tmp_path / "findings.json")],
            capture_output=True, text=True, cwd=REPO, timeout=120)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        out = json.loads((tmp_path / "findings.json").read_text())
        assert len(out["new"]) == 2
        assert {f["rule"] for f in out["new"]} == {"host-sync"}

    def test_write_baseline_round_trips(self, tmp_path):
        path = tmp_path / "b.json"
        proc = subprocess.run(
            [sys.executable, "-m", "gossipy_tpu_torch.analysis",
             "--baseline", str(path), "--write-baseline"],
            capture_output=True, text=True, cwd=REPO, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert json.loads(path.read_text()) == json.loads(
            (REPO / PKG / "analysis" / "baseline.json").read_text())


def test_finding_key_is_content_addressed():
    a = Finding("host-sync", "x.py", 10, 0, "m", "v = float(c)")
    b = Finding("host-sync", "x.py", 99, 4, "m2", "v = float(c)")
    c = Finding("host-sync", "x.py", 10, 0, "m", "w = float(c)")
    assert a.key == b.key
    assert a.key != c.key
