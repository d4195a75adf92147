"""The port stands alone, and its numpy copies equal the originals.

- No module of ``gossipy_tpu_torch`` (nor ``chip_smoke.py``) imports JAX,
  flax, optax, networkx, scikit-learn or anything of ``gossipy_tpu``: the
  machine with the card has none of them. Checked on the source (AST) and
  by importing the package with those modules blocked.
- The modules the port copies from the JAX package because they are numpy
  only (the data dispatcher, the report) give array-equal output on the
  same inputs (the partitioners and the synthetic images:
  ``test_torch_data.py``).
- The flagship twin and the eight paper-example twins run end to end on
  the host with those modules blocked and no socket able to connect.
"""

import ast
import json
import os
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
        "gossipy_tpu_torch.examples.main_all2all\n"
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
