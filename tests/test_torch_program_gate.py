"""The port's program gate: op traces, identity pairs, golden, launches.

Counterpart of the HLO half of ``tests/test_analysis.py``
(``gossipy_tpu_torch.analysis.program`` and
``examples/program_gate.py``), at the JAX gate's sizes (16 nodes, 6
features, 2 rounds):

- every identity pair of the JAX gate runs the identical op sequence;
  a perturbation (``mailbox_slots=2`` against 4) names the first
  divergent op;
- the fingerprints match the committed golden for this torch and
  device, and are deterministic;
- the case names are the JAX gate's;
- the launch gate's counts answer JAX ``pallas_launch_count`` through
  ``LAUNCH_MAP`` (the JAX count is static, both ``lax.cond`` branches;
  the port's is executed);
- the kernel-entry log counts each dispatch on the host route, in call
  order, and the trace carries it;
- canonicalization drops only the profiler's range ops.
"""

import json
import warnings
from pathlib import Path

import pytest
import torch

from gossipy_tpu.analysis import hlo as jhlo
from gossipy_tpu_torch.analysis import program
from gossipy_tpu_torch.examples import program_gate
from gossipy_tpu_torch.ops import _build, merge

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "gossipy_tpu_torch" / "analysis" / "program_golden.json"

warnings.filterwarnings("ignore", message=r".*may overflow.*")

CASES = program.gate_cases("cpu")
IDENTITY = {name: (a, b) for name, a, b in CASES["identity"]}
FINGERPRINT = dict(CASES["fingerprint"])


@pytest.mark.parametrize("name", sorted(IDENTITY))
def test_identity_pair_is_identical(name):
    build_a, build_b = IDENTITY[name]
    program.assert_identical_program(build_a(), build_b(), label=name)


def test_perturbation_names_the_first_divergent_op():
    with pytest.raises(AssertionError) as exc:
        program.assert_identical_program(
            program._make_sim(mailbox_slots=2, device="cpu"),
            program._make_sim(mailbox_slots=4, device="cpu"),
            label="seeded perturbation")
    msg = str(exc.value)
    assert "seeded perturbation" in msg and "canonical op" in msg
    assert "sim_a: aten::" in msg and "sim_b: aten::" in msg
    # The first divergence is the mailbox's own shape: [D, 16, 2] vs 4.
    a = program.program_text(program._make_sim(mailbox_slots=2,
                                               device="cpu"))
    b = program.program_text(program._make_sim(mailbox_slots=4,
                                               device="cpu"))
    div = program.first_divergence(a, b)
    assert div["op"] >= 1 and div["a"] != div["b"]
    assert ",2]" in div["a"] and ",4]" in div["b"]


@pytest.mark.parametrize("name", sorted(FINGERPRINT))
def test_fingerprint_matches_the_golden(name):
    golden = json.loads(GOLDEN.read_text())
    key = program_gate.golden_key(torch.device("cpu"))
    assert golden["n_rounds"] == 2
    want = golden["golden"].get(key)
    if want is None:
        pytest.skip(f"the golden has no entry for {key}")
    fp, _ = program.program_fingerprint(FINGERPRINT[name]())
    assert fp == want[name]


def test_fingerprint_is_deterministic():
    fp1, text1 = program.program_fingerprint(
        program._make_sim(device="cpu"))
    fp2, text2 = program.program_fingerprint(
        program._make_sim(device="cpu"))
    assert fp1 == fp2 and text1 == text2
    assert fp1 == program.fingerprint_text(text1)


def test_gate_cases_run_on_the_card_unless_the_host_is_named():
    """With no device the gate follows GlobalSettings: the card, which
    raises here rather than fall back to the host; named, the host."""
    import gossipy_tpu_torch
    settings = gossipy_tpu_torch.GlobalSettings()
    prev = settings._device
    try:
        settings.set_device(None)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                program.gate_cases()
            with pytest.raises(RuntimeError, match="no CUDA device"):
                program._make_sim()
        settings.set_device("cpu")
        build = program.gate_cases()["fingerprint"][0][1]
        assert build().device == torch.device("cpu")
        assert program._make_sim().device == torch.device("cpu")
    finally:
        settings._device = prev


def test_case_names_are_the_jax_gates():
    jcases = jhlo.gate_cases()
    for kind in ("identity", "fingerprint", "launch"):
        assert [c[0] for c in CASES[kind]] == [c[0] for c in jcases[kind]], \
            kind
    assert set(json.loads(GOLDEN.read_text())["golden"][
        program_gate.golden_key(torch.device("cpu"))]) == set(FINGERPRINT)


@pytest.mark.parametrize("name", sorted(program.LAUNCH_MAP))
def test_launch_gate_answers_the_jax_count(name):
    """The port's executed kernel entries a round against the JAX static
    pallas count of the same case, through LAUNCH_MAP."""
    jbuild, jwant = {c[0]: (c[1], c[2])
                     for c in jhlo.gate_cases()["launch"]}[name]
    jgot = jhlo.pallas_launch_count(jbuild(), n_rounds=2)
    tbuild, twant = {c[0]: (c[1], c[2]) for c in CASES["launch"]}[name]
    tgot = program.kernel_launch_count(tbuild(), n_rounds=2)
    assert (jgot, tgot) == program.LAUNCH_MAP[name] == (jwant, twant)


def test_kernel_entries_count_on_the_host_route_in_call_order():
    seen = []
    _build.add_entry_listener(seen.append)
    try:
        before = program.count_snapshot()
        g = torch.Generator().manual_seed(0)
        p = torch.randn(4, 8, generator=g)
        h = torch.randn(8, 8, generator=g)
        idx = torch.tensor([[0, 1], [2, 3], [4, 5], [6, 7]])
        ws, wp = torch.ones(4, 2) * 0.5, torch.ones(4, 2) * 0.5
        merge.gather_merge_multi(p, h, idx, ws, wp)
        merge.gather_merge_flat(p, h.to(torch.bfloat16), idx[:, 0], ws[:, 0],
                                wp[:, 0])
        merge.gather_merge_multi_reference(p, h, idx, ws, wp)  # no entry
        launches, entries = program.count_delta(before)
    finally:
        _build.remove_entry_listener(seen.append)
    assert seen == [merge.KERNEL, merge.KERNEL_FLAT_DQ]
    assert entries == {merge.KERNEL: 1, merge.KERNEL_FLAT_DQ: 1}
    assert launches == {}    # the host route launches nothing
    assert program.launch_mismatches(before) == {
        merge.KERNEL: (0, 1), merge.KERNEL_FLAT_DQ: (0, 1)}
    _build.reset_launch_counts()
    assert sum(_build.ENTRIES.values()) == sum(_build.LAUNCHES.values()) == 0


def test_hop_entries_count_the_dispatch_not_the_yardstick():
    from gossipy_tpu_torch.ops import attention
    q = torch.randn(2, 4, 8)
    before = program.count_snapshot()
    attention.flash_attention(q, q, q)              # two heads: two hops
    attention.flash_attention_reference(q, q, q)    # the yardstick: none
    _, entries = program.count_delta(before)
    assert entries == {attention.KERNEL: 2}


def test_the_trace_carries_kernel_entries_and_syncs():
    text = program.program_text(program._make_sim(
        fused_merge=True, mailbox_slots=4, device="cpu"))
    lines = text.splitlines()
    assert lines.count("kernel::gather_merge_multi") == 2
    assert any(line.startswith("aten::_local_scalar_dense") for line in lines)
    assert not any(line.startswith("profiler::") for line in lines)
    assert all("@cpu" in line or "@" not in line for line in lines)


def test_canonicalization_drops_only_the_profiler_ranges():
    raw = ["profiler::_record_function_enter_new.default(str, None)",
           "  aten::add.Tensor(float32[2]@cpu, float32[2]@cpu)  ", "",
           "profiler::_record_function_exit._RecordFunction(object)",
           "aten::_local_scalar_dense.default(bool[]@cpu)",
           "kernel::gather_merge_multi"]
    assert program.canonicalize_trace(raw).split("\n") == [
        "aten::add.Tensor(float32[2]@cpu, float32[2]@cpu)",
        "aten::_local_scalar_dense.default(bool[]@cpu)",
        "kernel::gather_merge_multi"]
    assert program.first_divergence("a\nb\nc", "a\nx\nc") == {
        "op": 2, "a": "b", "b": "x", "a_total": 3, "b_total": 3}
    assert program.first_divergence("a\nb", "a\nb") is None
    assert program.first_divergence("a", "a\nb")["a"] == "<end of program>"


def test_program_gate_cli_passes_and_reports(tmp_path):
    report = tmp_path / "gate.json"
    assert program_gate.main(["--device", "cpu", "--report",
                              str(report)]) == 0
    out = json.loads(report.read_text())
    assert out["failures"] == [] and not out.get("golden_skipped")
    assert all(v["identical"] for v in out["identity"].values())
    assert out["launch"]["engine/fused-compact"] == {
        "want": 1, "got": 1.0, "entries": {merge.KERNEL: 2}, "jax": 2}


def test_program_gate_cli_names_a_divergent_case(tmp_path, monkeypatch,
                                                 capsys):
    real = program.gate_cases

    def seeded(device=None):
        cases = real(device)
        cases["identity"] = [("engine/seeded-divergence",
                              lambda: program._make_sim(device=device),
                              lambda: program._make_sim(device=device,
                                                        mailbox_slots=3))]
        return cases
    monkeypatch.setattr(program, "gate_cases", seeded)
    golden = tmp_path / "golden.json"
    golden.write_text(GOLDEN.read_text())
    rc = program_gate.main(["--device", "cpu", "--golden", str(golden)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "identity engine/seeded-divergence: DIVERGED at canonical op" in out
    assert "FAILED identity:engine/seeded-divergence" in out


def test_update_golden_writes_this_processes_entry(tmp_path):
    golden = tmp_path / "golden.json"
    golden.write_text(json.dumps({"n_rounds": 2, "golden": {
        "0.0|cuda": {"engine/base": "x"}}}))
    assert program_gate.main(["--device", "cpu", "--golden", str(golden),
                              "--update-golden"]) == 0
    out = json.loads(golden.read_text())
    key = program_gate.golden_key(torch.device("cpu"))
    assert out["golden"]["0.0|cuda"] == {"engine/base": "x"}
    assert out["golden"][key] == json.loads(GOLDEN.read_text())["golden"][key]


def test_ledgered_start_runs_no_op_of_its_own(tmp_path):
    """The ledger's manifest reads memory_budget after every start(): its
    one-node terms are made with the state, so a ledgered start adds no
    op (the engine/ledger-on pair); the budget is unchanged."""
    plain = program._make_sim(device="cpu")
    led = program._make_sim(device="cpu", ledger=program._tmp_ledger())
    assert led._one_node is None and plain._one_node is None
    program._fresh_state(led)
    program._fresh_state(plain)
    assert led._one_node is not None and plain._one_node is not None
    assert led.memory_budget() == plain.memory_budget()
    lines, _ = program.record_trace(led.memory_budget)
    assert lines == []
