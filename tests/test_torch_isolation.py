"""The port stands alone, and its numpy copies equal the originals.

- No module of ``gossipy_tpu_torch`` (nor ``chip_smoke.py``) imports JAX,
  flax, optax, networkx, scikit-learn or anything of ``gossipy_tpu``: the
  machine with the card has none of them. Checked on the source (AST) and
  by importing the package with those modules blocked.
- The modules the port copies from the JAX package because they are numpy
  only (the data dispatcher, the report) give array-equal output on the
  same inputs (the partitioners and the synthetic images:
  ``test_torch_data.py``); the four it copies because they are standard
  library only (``telemetry/sink.py``, ``tracing.py``, ``metrics.py``,
  ``ledger.py``) hold the original's code after their docstrings, the
  tracer's default process name and the package in docstring
  cross-references aside (their results: ``test_torch_flight.py``,
  ``test_torch_metrics.py``, ``test_torch_ledger.py``).
- The flagship twin, the eight paper-example twins and the audit twin
  (plain and ``--tokenized``) run end to end on the host with those
  modules blocked and no socket able to connect; the
  flagship and All2All twins with ``--probes --sentinels --chaos`` too,
  and their summaries' ``probes``, ``health`` and ``chaos`` entries have
  the keys the JAX scripts' ``finish`` gives. The scale twin's two rows
  run so too, their sparse topology built by the native generator, and
  the ``profile_round``, ``ledger`` and ``trace_report`` twins, and the
  four service twins (``main_service``, ``serve``, ``loadgen``,
  ``service_top``), their stdout lines with the JAX scripts' keys.
- The port's ``telemetry``, ``simulation``, ``service`` and root
  packages export every name the JAX package's export, but for an
  allowance that names the queue item (ROADMAP.md) that ports each.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gossipy_tpu.data import ClassificationDataHandler, DataDispatcher
from gossipy_tpu.simulation.report import SimulationReport
from gossipy_tpu_torch import data as tdata
from gossipy_tpu_torch.simulation.report import \
    SimulationReport as TSimulationReport

REPO = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "chex", "gossipy_tpu",
          "networkx", "sklearn")


def port_sources():
    files = sorted((REPO / "gossipy_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_banned_import(path):
    for name in imported_modules(path):
        root = name.split(".")[0]
        assert root not in BANNED, f"{path.name} imports {name}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        "import gossipy_tpu_torch, gossipy_tpu_torch.simulation, "
        "gossipy_tpu_torch.ops, gossipy_tpu_torch.convert, "
        "gossipy_tpu_torch.models, gossipy_tpu_torch.handlers, "
        "gossipy_tpu_torch.ops.attention, gossipy_tpu_torch.optim, "
        "gossipy_tpu_torch.examples.demo_ring_attention, "
        "gossipy_tpu_torch.examples.main_cifar10_100nodes, "
        "gossipy_tpu_torch.examples.main_ormandi_2013, "
        "gossipy_tpu_torch.examples.main_berta_2014, "
        "gossipy_tpu_torch.examples.main_hegedus_2020, "
        "gossipy_tpu_torch.examples.main_danner_2023, "
        "gossipy_tpu_torch.handlers.linear, gossipy_tpu_torch.handlers.kmeans, "
        "gossipy_tpu_torch.handlers.mf, gossipy_tpu_torch.flow_control, "
        "gossipy_tpu_torch.compression, "
        "gossipy_tpu_torch.simulation.nodes, "
        "gossipy_tpu_torch.simulation.variants, "
        "gossipy_tpu_torch.examples.main_giaretta_2019, "
        "gossipy_tpu_torch.examples.main_hegedus_2021, "
        "gossipy_tpu_torch.examples.main_onoszko_2021, "
        "gossipy_tpu_torch.examples.main_all2all, "
        "gossipy_tpu_torch.simulation.events, "
        "gossipy_tpu_torch.simulation.faults, "
        "gossipy_tpu_torch.telemetry.probes, "
        "gossipy_tpu_torch.telemetry.health, "
        "gossipy_tpu_torch.telemetry.cost, gossipy_tpu_torch.native, "
        "gossipy_tpu_torch.examples.scale, "
        "gossipy_tpu_torch.simulation.sequential, "
        "gossipy_tpu_torch.examples.audit_fidelity, "
        "gossipy_tpu_torch.config, gossipy_tpu_torch.checkpoint, "
        "gossipy_tpu_torch.telemetry.sink, "
        "gossipy_tpu_torch.telemetry.tracing, "
        "gossipy_tpu_torch.telemetry.manifest, "
        "gossipy_tpu_torch.examples.main_from_config, "
        "gossipy_tpu_torch.examples.replay_bundle, "
        "gossipy_tpu_torch.telemetry.metrics, "
        "gossipy_tpu_torch.telemetry.ledger, "
        "gossipy_tpu_torch.telemetry.scopes, "
        "gossipy_tpu_torch.examples.profile_round, "
        "gossipy_tpu_torch.examples.ledger, "
        "gossipy_tpu_torch.examples.trace_report\n"
        # The north-star set-up, with no socket that may connect.
        "import socket, warnings\n"
        "class NoNet(socket.socket):\n"
        "    def connect(self, *a):\n"
        "        raise OSError('no network')\n"
        "socket.socket = NoNet\n"
        "from gossipy_tpu_torch.core import Topology\n"
        "from gossipy_tpu_torch.data import load_classification_dataset\n"
        "assert Topology.random_regular(100, 20).degrees.min() == 20\n"
        "warnings.simplefilter('ignore')\n"
        "assert load_classification_dataset('spambase')[0].shape == "
        "(4601, 57)\n"
        # The flagship twin end to end on the host, at a tiny size, with
        # a small synthetic set in place of the 60,000 images.
        "import gossipy_tpu_torch.examples.main_cifar10_100nodes as f\n"
        "from gossipy_tpu_torch.data import _synthetic_images as s\n"
        "f.get_CIFAR10 = lambda: (s('a', 96, (32, 32, 3), 10), "
        "s('b', 20, (32, 32, 3), 10))\n"
        "out = f.main(['--device', 'cpu', '--nodes', '4', '--rounds', '1', "
        "'--bf16', '--history-dtype', 'int8'])\n"
        "assert out['rounds'] == 1 and out['sent_messages'] == 4, out\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


# Each paper-example twin at a host size: (module, arguments, what its
# summary must show).
PAPER_TWINS = {
    "main_ormandi_2013": (["--nodes", "12", "--rounds", "2",
                           "--repetitions", "2"], "accuracy"),
    "main_berta_2014": (["--nodes", "12", "--rounds", "2"], "nmi"),
    "main_hegedus_2020": (["--rounds", "2"], "rmse"),
    "main_danner_2023": (["--nodes", "12", "--rounds", "2"], "accuracy"),
    "main_giaretta_2019": (["--nodes", "24", "--rounds", "2", "--variant",
                            "cacheneigh"], "accuracy"),
    "main_hegedus_2021": (["--nodes", "12", "--rounds", "2", "--variant",
                           "sampling"], "accuracy"),
    "main_all2all": (["--nodes", "12", "--rounds", "2", "--mixing",
                      "metropolis"], "accuracy"),
    "main_onoszko_2021": (["--nodes", "3", "--subsample", "48",
                           "--step1-rounds", "1", "--rounds", "2"],
                          "accuracy"),
}


@pytest.mark.parametrize("twin", sorted(PAPER_TWINS))
def test_paper_twin_runs_with_jax_blocked(twin):
    args, metric = PAPER_TWINS[twin]
    code = (
        "import sys, socket, json\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        "class NoNet(socket.socket):\n"
        "    def connect(self, *a):\n"
        "        raise OSError('no network')\n"
        "socket.socket = NoNet\n"
        f"import gossipy_tpu_torch.examples.{twin} as twin\n"
        # A small synthetic set in place of the 60,000 CIFAR-10 images.
        "from gossipy_tpu_torch.data import _synthetic_images as s\n"
        "twin.get_CIFAR10 = lambda: (s('a', 48, (32, 32, 3), 10), "
        "s('b', 10, (32, 32, 3), 10))\n"
        f"out = twin.main({args + ['--device', 'cpu']!r})\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["sent_messages"] > 0, summary
    assert np.isfinite(summary["final"][metric]), summary


@pytest.mark.parametrize("args", [[], ["--tokenized"]])
def test_audit_twin_runs_with_jax_blocked(args):
    """The audit twin (the bulk and the sequential engine, a few seeds
    each) at a host size, with the JAX modules blocked and no socket
    able to connect: its summary has the JAX script's keys."""
    argv = args + ["--device", "cpu", "--nodes", "8", "--rounds", "2",
                   "--seeds", "2"]
    code = (
        "import sys, socket, json\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        "class NoNet(socket.socket):\n"
        "    def connect(self, *a):\n"
        "        raise OSError('no network')\n"
        "socket.socket = NoNet\n"
        "import gossipy_tpu_torch.examples.audit_fidelity as twin\n"
        f"out = twin.main({argv!r})\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(summary) == ["final", "max_accuracy_gap", "max_sent_gap",
                               "nodes", "rounds", "seeds",
                               "tail_accuracy_gap", "tokenized"]
    assert summary["tokenized"] == bool(args)
    assert all(np.isfinite(v) for v in summary["final"].values()), summary


@pytest.mark.parametrize("args", [[], ["--all2all"],
                                  ["--all2all", "--sparse-mix-form",
                                   "padded"]])
def test_scale_twin_runs_with_jax_blocked(args):
    argv = args + ["--device", "cpu", "--nodes", "300", "--rounds", "3"]
    code = (
        "import sys, socket, json\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        "class NoNet(socket.socket):\n"
        "    def connect(self, *a):\n"
        "        raise OSError('no network')\n"
        "socket.socket = NoNet\n"
        "from gossipy_tpu_torch import native\n"
        "assert native.available()\n"
        "import gossipy_tpu_torch.examples.scale as twin\n"
        f"out = twin.main({argv!r})\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["nodes"] == 300 and summary["degree"] == 20
    assert summary["sent_messages"] > 0, summary
    assert np.isfinite(summary["final_global_accuracy"]), summary
    assert summary["rounds_per_s"] > 0


# The JAX scripts' summary of a run with probes, sentinels and chaos:
# ``examples/_common.finish`` over a JAX report carrying every array it
# reads, run in a child with its own HOME (the module turns on JAX's
# compilation cache there). Prints the key set of each entry.
JAX_FINISH = (
    "import sys, json, argparse\n"
    "import numpy as np\n"
    "sys.path.insert(0, 'examples')\n"
    "from _common import finish\n"
    "from gossipy_tpu.simulation.report import SimulationReport\n"
    "r, n = 6, 4\n"
    "f = np.linspace(1.0, 0.1, r).astype(np.float32)\n"
    "i = np.ones(r, np.int32)\n"
    "rep = SimulationReport(metric_names=['accuracy'], local_evals=None,\n"
    "    global_evals=np.full((r, 1), 0.5), sent=i, failed=i,\n"
    "    total_size=r, failed_by_cause={'drop': i, 'offline': 0 * i,\n"
    "    'overflow': 0 * i, 'chaos': 0 * i},\n"
    "    probe_consensus_mean=f, probe_consensus_max=f,\n"
    "    probe_stale_max=i, probe_accepted_per_node=np.ones((r, n), "
    "np.int32),\n"
    "    probe_merge_delta=f, probe_train_delta=f, health_trip=0 * i,\n"
    "    health_nonfinite_params=np.zeros((r, 2), np.int32),\n"
    "    health_diverged_per_node=np.zeros((r, n), np.int32),\n"
    "    health_delta_hwm=f, chaos_component_gap=f)\n"
    "args = argparse.Namespace(plot=None, _chaos_heal=4)\n"
    "out = finish(rep, args)\n"
    "print(json.dumps({k: sorted(out[k]) for k in ('probes', 'health', "
    "'chaos')}))\n")

TELEMETRY_TWINS = {
    "main_cifar10_100nodes": ["--nodes", "8", "--rounds", "6", "--bf16",
                              "--history-dtype", "bfloat16"],
    "main_all2all": ["--nodes", "12", "--rounds", "6"],
}


@pytest.fixture(scope="module")
def jax_finish_keys(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               HOME=str(tmp_path_factory.mktemp("home")))
    out = subprocess.run([sys.executable, "-c", JAX_FINISH], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("twin", sorted(TELEMETRY_TWINS))
def test_telemetry_twin_runs_with_jax_blocked(twin, jax_finish_keys):
    args = TELEMETRY_TWINS[twin] + ["--probes", "--sentinels", "--chaos",
                                    "--device", "cpu"]
    code = (
        "import sys, json\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        f"import gossipy_tpu_torch.examples.{twin} as twin\n"
        "from gossipy_tpu_torch.data import _synthetic_images as s\n"
        "twin.get_CIFAR10 = lambda: (s('a', 96, (32, 32, 3), 10), "
        "s('b', 20, (32, 32, 3), 10))\n"
        f"out = twin.main({args!r})\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    for entry in ("probes", "health", "chaos"):
        assert sorted(summary[entry]) == jax_finish_keys[entry], \
            (entry, summary[entry])
    assert summary["health"]["trips"] == 0
    assert summary["chaos"]["gap_peak"] > 0


def dataset(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(103, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 10, 103)
    return X, y


@pytest.mark.parametrize("eval_on_user", [True, False])
@pytest.mark.parametrize("pad_to", [None, 40])
def test_stacked_matches_original(eval_on_user, pad_to):
    X, y = dataset()
    a = DataDispatcher(ClassificationDataHandler(X, y, test_size=0.2,
                                                 seed=3),
                       n=7, eval_on_user=eval_on_user).stacked(pad_to)
    b = tdata.DataDispatcher(tdata.ClassificationDataHandler(
        X, y, test_size=0.2, seed=3), n=7,
        eval_on_user=eval_on_user).stacked(pad_to)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_to_device_keeps_values():
    X, y = dataset()
    st = tdata.DataDispatcher(tdata.ClassificationDataHandler(X, y), n=5,
                              eval_on_user=False).stacked()
    on = tdata.to_device(st, "cpu")
    for k, v in st.items():
        np.testing.assert_array_equal(on[k].numpy(), v, err_msg=k)


def report_args(seed=0, rounds=5):
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(rounds, 3))
    g[1] = np.nan
    return dict(metric_names=["accuracy", "f1_score", "precision"],
                local_evals=None, global_evals=g,
                sent=rng.integers(0, 9, rounds),
                failed=np.zeros(rounds, np.int64), total_size=1234,
                failed_by_cause={"drop": np.zeros(rounds, np.int64),
                                 "offline": np.zeros(rounds, np.int64),
                                 "overflow": np.zeros(rounds, np.int64)},
                mailbox_hwm=rng.integers(0, 4, rounds),
                compact_slots=np.zeros(rounds, np.int64),
                wide_slots=rng.integers(0, 4, rounds))


def test_report_matches_original():
    a = SimulationReport(**report_args())
    b = TSimulationReport(**report_args())
    assert json.dumps(a.to_dict()) == json.dumps(b.to_dict())
    assert a.final("accuracy") == b.final("accuracy")
    assert a.get_evaluation(False) == b.get_evaluation(False)
    c = TSimulationReport.concatenate([b, TSimulationReport(
        **report_args(seed=1))])
    d = SimulationReport.concatenate([a, SimulationReport(
        **report_args(seed=1))])
    assert json.dumps(c.to_dict()) == json.dumps(d.to_dict())
    # A report saved by one package loads in the other.
    e = SimulationReport.from_dict(b.to_dict())
    assert json.dumps(e.to_dict()) == json.dumps(a.to_dict())


def _body(path):
    """A module's code after its docstring."""
    src = path.read_text()
    return src[src.index('"""', 3) + 3:]


# The copies' only departures from the originals' code: the tracer's
# default process name, four comment words (a chunked run loop is a
# "runner" here, a bench row's file a "bench capsule"), and the package
# named in the docstrings' cross-references
# (``metrics.py``'s usage example, ``from gossipy_tpu.telemetry.metrics
# import get_registry``, sits in its module docstring, which the port
# writes anew).
COPY_EDITS = (('f"gossipy_tpu/{self.pid}"', 'f"gossipy_tpu_torch/{self.pid}"'),
              ("multi-tenant drivers tag", "multi-tenant runners tag"),
              ("the time a streaming driver would recover",
               "the time a streaming runner would recover"),
              ("for today's synchronous drivers,",
               "for today's synchronous runners,"),
              ("from gossipy_tpu.telemetry.metrics import",
               "from gossipy_tpu_torch.telemetry.metrics import"),
              ("~gossipy_tpu.telemetry.", "~gossipy_tpu_torch.telemetry."),
              ("bench row / driver capsule", "bench row / bench capsule"))


@pytest.mark.parametrize("name", ["sink", "tracing", "metrics", "ledger"])
def test_copied_stdlib_module_equals_original(name):
    port = _body(REPO / "gossipy_tpu_torch" / "telemetry" / f"{name}.py")
    orig = _body(REPO / "gossipy_tpu" / "telemetry" / f"{name}.py")
    for old, new in COPY_EDITS:
        orig = orig.replace(old, new)
    assert port == orig


def test_config_and_replay_twins_run_with_jax_blocked(tmp_path):
    """``main_from_config`` on the north-star config cut to 12 nodes and 3
    rounds, and ``replay_bundle --record`` (the demo's NaN run recorded,
    then replayed): no JAX module, no socket that may connect."""
    cfg = json.loads((REPO / "examples" / "configs" /
                      "spambase_100.json").read_text())
    cfg.update(n_nodes=12, subsample=600, n_rounds=3,
               topology_params={"degree": 4, "seed": 42})
    (tmp_path / "exp.json").write_text(json.dumps(cfg))
    code = (
        "import sys, socket, json\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        "class NoNet(socket.socket):\n"
        "    def connect(self, *a):\n"
        "        raise OSError('no network')\n"
        "socket.socket = NoNet\n"
        "import warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from gossipy_tpu_torch.examples import main_from_config, "
        "replay_bundle\n"
        f"out = main_from_config.main([{str(tmp_path / 'exp.json')!r}, "
        "'--device', 'cpu'])\n"
        f"v = replay_bundle.main(['--record', {str(tmp_path / 'fr')!r}, "
        "'--device', 'cpu'])\n"
        "print(json.dumps({'out': out, 'v': v}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["out"]["rounds"] == 3 and got["out"]["sent_messages"] > 0
    assert np.isfinite(got["out"]["final"]["accuracy"])
    assert got["v"]["matches_recorded"] is True


# Names of the JAX package's exports the port does not export yet, each
# with the queue item of ROADMAP.md that brings it: the root's device
# singleton and log filter (item 12); the compilation cache and ``jax``
# mean nothing to a package that compiles nothing.
EXPORT_ALLOWANCE = {
    "gossipy_tpu": {"GlobalSettings": 12, "DuplicateFilter": 12,
                    "compilation_cache_stats": None,
                    "enable_compilation_cache": None, "jax": None},
}


def _public_names(mod) -> list:
    """``__all__``, or, for a module without one, its public top-level
    names that are not its own subpackages."""
    import types
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items() if not n.startswith("_")
            and not (isinstance(v, types.ModuleType)
                     and v.__name__.startswith(mod.__name__ + "."))]


@pytest.mark.parametrize("ref", ["gossipy_tpu.telemetry",
                                 "gossipy_tpu.simulation", "gossipy_tpu",
                                 "gossipy_tpu.service"])
def test_package_exports_match_reference(ref):
    """Every name the JAX package exports from ``telemetry``,
    ``simulation`` and its root is exported by the port's counterpart,
    or stands in the allowance with the queue item that ports it; no name
    in the allowance is exported already."""
    import importlib
    jmod = importlib.import_module(ref)
    tmod = importlib.import_module(ref.replace("gossipy_tpu",
                                               "gossipy_tpu_torch", 1))
    allowed = EXPORT_ALLOWANCE.get(ref, {})
    missing = [n for n in _public_names(jmod)
               if not hasattr(tmod, n) and n not in allowed]
    assert missing == []
    assert [n for n in allowed if hasattr(tmod, n)] == []
    if hasattr(tmod, "__all__"):
        assert [n for n in tmod.__all__ if not hasattr(tmod, n)] == []


def _blocked(code: str) -> str:
    return ("import sys, socket, json\n"
            f"for m in {BANNED!r}:\n"
            "    sys.modules[m] = None\n"
            "class NoNet(socket.socket):\n"
            "    def connect(self, *a):\n"
            "        raise OSError('no network')\n"
            "socket.socket = NoNet\n"
            "import warnings\n"
            "warnings.simplefilter('ignore')\n" + code)


def _run_blocked(code: str):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("GOSSIPY_TPU_LEDGER", None)
    out = subprocess.run([sys.executable, "-c", _blocked(code)], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_profile_round_twin_runs_with_jax_blocked(tmp_path):
    """``profile_round`` on the host with ``--trace``: the JAX script's
    row keys, the three legs summing to the whole, the analytic cost, the
    four phases found in the trace and their ms."""
    trace = str(tmp_path / "trace")
    row = _run_blocked(
        "from gossipy_tpu_torch.examples import profile_round\n"
        "row = profile_round.main(['--device', 'cpu', '--nodes', '12', "
        f"'--rounds', '2', '--trace', {trace!r}, '--probes'])\n"
        "print(json.dumps(row))\n")
    for k in ("config", "backend", "device_kind", "n_nodes",
              "rounds_per_call", "ms_per_round", "note",
              "phase_scopes_in_hlo", "phase_scopes_expected",
              "xla_per_round", "hbm_peak_bytes", "achieved_gflops_per_s"):
        assert k in row, k
    assert row["backend"] == "cpu" and row["n_nodes"] == 12
    ms = row["ms_per_round"]
    legs = ms["eval"] + ms["train_one_epoch"] + ms["exchange_and_overhead"]
    assert abs(legs - ms["full"]) <= 0.05 * ms["full"] + 2e-3
    assert "probes_marginal" in ms
    assert row["analytic"]["flops_per_round"] > 0
    assert row["phase_scopes_in_trace"] == row["phase_scopes_expected"]
    assert sorted(row["trace_phase_ms_per_round"]) == \
        sorted(row["phase_scopes_expected"])
    assert row["trace_route"] == "cpu"


def test_ledger_and_trace_report_twins_run_with_jax_blocked(tmp_path):
    """A traced, ledgered north-star run at 12 nodes, then the ledger
    twin's list, show, diff, trend and merge over its rows, and the
    trace_report twin over its saved trace."""
    led, trace = str(tmp_path / "l.jsonl"), str(tmp_path / "trace.json")
    out = _run_blocked(
        "import torch\n"
        "from gossipy_tpu_torch.examples import ledger, trace_report\n"
        "from gossipy_tpu_torch.examples.profile_round import build_sim\n"
        "from gossipy_tpu_torch.telemetry import Tracer\n"
        "tr = Tracer()\n"
        "sim = build_sim(False, 12, device='cpu')\n"
        f"sim.ledger = __import__('gossipy_tpu_torch.telemetry', "
        f"fromlist=['x']).RunLedger({led!r})\n"
        "sim.tracer = tr\n"
        "st = sim.init_nodes()\n"
        "st, _ = sim.start(st, n_rounds=2)\n"
        "st, _ = sim.start(st, n_rounds=2)\n"
        f"tr.save({trace!r})\n"
        f"rc = [ledger.main(['list', {led!r}, '--out', "
        f"{str(tmp_path / 'list.md')!r}]),\n"
        f"      ledger.main(['show', {led!r}, '@-1']),\n"
        f"      ledger.main(['diff', {led!r}, '@0', '@1', '--json']),\n"
        f"      ledger.main(['trend', {led!r}, '--metric', "
        "'rounds_per_sec', '--max-regress', '10']),\n"
        f"      ledger.main(['merge', {str(tmp_path / 'm.jsonl')!r}, "
        f"{led!r}]),\n"
        f"      trace_report.main([{trace!r}])]\n"
        "print(json.dumps(rc))\n")
    assert out == [0, 0, 0, 0, 0, 0]
    assert "2 row(s)" in (tmp_path / "list.md").read_text()
    report = json.loads((tmp_path / "trace_report.json").read_text())
    assert report["n_windows"] == 2 and report["totals"]["rounds"] == 4


def _printed_keys(script: Path) -> list:
    """The keys of the dict literal a JAX script prints with
    ``json.dumps({...})``: its stdout line's keys."""
    tree = ast.parse(script.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return sorted(k.value for k in node.args[0].keys)
    raise AssertionError(f"{script}: no json.dumps of a dict literal")


def test_service_twins_run_with_jax_blocked(tmp_path):
    """The four service twins on the host at a tiny size, no JAX module
    and no socket that may connect: ``main_service`` (16 nodes, 4
    rounds), ``serve`` over a two-tenant spec file, ``loadgen`` (3
    tenants, time scale 0.001) and ``service_top --once`` on the metrics
    directory loadgen wrote. Their stdout lines have the JAX scripts'
    keys."""
    spec = {"tenants": [
        {"tenant": name, "config": {
            "n_nodes": 12, "subsample": 300, "n_rounds": 4, "delta": 20,
            "batch_size": 8, "topology_params": {"degree": 4},
            "seed": seed}} for name, seed in (("a", 1), ("b", 2))]}
    (tmp_path / "specs.json").write_text(json.dumps(spec))
    out = _run_blocked(
        "import contextlib, io\n"
        "from gossipy_tpu_torch.examples import main_service, serve, "
        "loadgen, service_top\n"
        "def line(fn, argv):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        rc = fn(argv)\n"
        "    return rc, buf.getvalue()\n"
        "d = " + repr(str(tmp_path)) + "\n"
        "rows = {}\n"
        "rc, o = line(main_service.main, ['--device', 'cpu', '--rounds', "
        "'4', '--nodes', '16', '--out', d + '/ms'])\n"
        "rows['main_service'] = json.loads(o.splitlines()[-1])\n"
        "rc, o = line(serve.main, [d + '/specs.json', '--out', d + '/sv', "
        "'--slice', '2', '--device', 'cpu'])\n"
        "rows['serve'] = [rc, json.loads(o.splitlines()[-1])]\n"
        "rc, o = line(loadgen.main, ['--out', d + '/lg', '--tenants', '3', "
        "'--time-scale', '0.001', '--device', 'cpu'])\n"
        "rows['loadgen'] = [rc, json.loads(o.splitlines()[-1])]\n"
        "rc, o = line(service_top.main, [d + '/lg/metrics', '--once'])\n"
        "rows['service_top'] = [rc, o]\n"
        "print(json.dumps(rows))\n")
    ms = out["main_service"]
    assert sorted(ms) == _printed_keys(REPO / "examples" / "main_service.py")
    assert ms["n_buckets"] == 2
    assert ms["tenants"]["mallory"]["status"] == "evicted"
    assert ms["tenants"]["mallory"]["bundle"]
    assert {ms["tenants"][t]["status"] for t in ("alice", "bob", "carol")} \
        == {"done"}
    rc, sv = out["serve"]
    assert rc == 0
    assert sorted(sv) == _printed_keys(REPO / "scripts" / "serve.py")
    assert sv["tenants"] == {"a": "done", "b": "done"}
    assert sv["n_buckets"] == 1
    rc, row = out["loadgen"]
    assert rc == 0
    from gossipy_tpu.service import RunQueue, slo_row
    from gossipy_tpu.telemetry.metrics import MetricsRegistry
    want = slo_row(RunQueue(), MetricsRegistry(), 1.0)
    added = re.findall(r'row\["raw"\]\["(\w+)"\]\s*=',
                       (REPO / "scripts" / "loadgen.py").read_text())
    assert sorted(row) == sorted(want)
    assert sorted(row["raw"]) == sorted(set(want["raw"]) | set(added))
    assert row["raw"]["ttfr_missing"] == [] and row["raw"]["n_done"] == 3
    rc, board = out["service_top"]
    assert rc == 0
    # One process: the board shows the three runs' shared registry.
    assert board.startswith("gossipy_tpu_torch service")
    assert "latency (ms)" in board
    assert all(t in board for t in ("t000-s0", "t001-s1", "t002-s0"))
