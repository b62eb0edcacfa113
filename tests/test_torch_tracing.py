"""The port's phase tracer (`stark_tpu_torch/utils/tracing.py`) against the
JAX package's (`stark_tpu/utils/tracing.py`), on the CPU:

* `report()` gives the JAX package's text character for character for the
  same nested sequence of phases, `time.perf_counter` patched to one
  deterministic clock for both, with and without the RSS column;
* the `compute` golden's proof is byte-identical with tracing off, under
  `--trace`, and under `--sync-phases --rss` (the CLI's `prove`), and the
  report names the prover's phases;
* with every switch off a phase neither synchronizes, nor touches the
  profiler, nor reads `/proc`, nor sets torch's sync debug mode or a
  warning hook;
* under `sync_phases` torch's sync warnings are counted into the innermost
  open phase (the root outside every phase), every other warning reaches
  the caller, and turning the switch off restores the warning handling
  (torch's debug mode stubbed: the CPU has no card);
* FRI's rounds open `fri_fold` and `fri_commit` inside `fri`, and a
  prove opens `trace_inputs` and `p_scan` inside `traces`;
* under `--trace` the worker's stdout holds only its protocol's lines (the
  reports, its own `read_witness` and `to_json` too, go to stderr), and
  `--sync-phases` logs one barrier an exit.

The phases' names and order against a JAX prove and verify are held in
`tests/test_torch_prove_many.py`, where the JAX stages are compiled
already. Tolerance: exact (text and bytes).
"""

import io
import json
import os
import sys
import time
import warnings

import pytest
import torch

from stark_tpu.utils import tracing as jtracing
from stark_tpu_torch import cli
from stark_tpu_torch.utils import profiling, tracing

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
R1CS = os.path.join(FIX, "compute.r1cs")
WTNS = os.path.join(FIX, "compute.wtns")
PROVER_PHASES = ["traces", "a_tree", "columns", "commits", "branches", "fri", "materialize"]
FRI_SPANS = ["fri_fold", "fri_commit"]
TRACES_SPANS = ["trace_inputs", "p_scan"]


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("STARK_TPU_TRACE", "STARK_TPU_PROFILE", "STARK_TPU_SYNC_PHASES",
                 "STARK_TPU_RSS"):
        monkeypatch.delenv(name, raising=False)
    previous = tracing.configure()
    tracing.reset()
    jtracing.reset()
    yield
    tracing.configure(**previous)
    tracing.reset()
    jtracing.reset()


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(FIX, "compute_proof_golden.json")) as f:
        return f.read()


def _sequence(mod):
    """Nested phases, a repeated one, a name wider than its column."""
    with mod.phase("prove"):
        with mod.phase("traces"):
            pass
        with mod.phase("a_tree"):
            with mod.phase("a_name_wider_than_the_report_column"):
                pass
        with mod.phase("traces"):
            pass
    with mod.phase("verify"):
        pass
    with mod.phase("prove"):
        pass


def _run_on_clock(mod, monkeypatch):
    ticks = iter(range(10_000))
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) ** 2 * 3.7e-4)
    mod.reset()
    _sequence(mod)
    return mod


def test_report_equals_the_jax_text(monkeypatch):
    _run_on_clock(tracing, monkeypatch)
    _run_on_clock(jtracing, monkeypatch)
    want = jtracing.report()
    assert tracing.report() == want
    assert "x2" in want and "a_name_wider_than_the_report_column" in want
    for name in ("prove", "verify"):
        assert tracing.report(tracing._root.children[name]) == \
            jtracing.report(jtracing._root.children[name])
    # the RSS column
    for mod in (tracing, jtracing):
        node = mod._root.children["prove"].children["a_tree"]
        node.rss_end_kb, node.rss_delta_kb = 1_234_567, -4_321
        mod._root.children["verify"].rss_end_kb = 2048
    assert tracing.report() == jtracing.report()
    assert "rss" in tracing.report()


def _cli_prove(tmp_path, *flags):
    pj = str(tmp_path / "proof.json")
    assert cli.main(["prove", R1CS, WTNS, pj, "--device", "cpu", *flags]) == 0
    with open(pj) as f:
        return f.read()


def test_tracing_never_changes_the_proof(golden, tmp_path, capsys):
    assert _cli_prove(tmp_path) == golden
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("prove: ") and "materialize" not in out
    assert tracing.top_names()[1:] == PROVER_PHASES

    tracing.reset()
    assert _cli_prove(tmp_path, "--trace") == golden
    out = capsys.readouterr().out
    for name in PROVER_PHASES:
        assert f"\n{name} " in "\n" + out, name
    assert out.splitlines()[-1].startswith("prove: ")

    tracing.reset()
    assert _cli_prove(tmp_path, "--sync-phases", "--rss") == golden
    names = tracing.top_names()
    rounds = golden.count('"Middle"')
    traces_at, fri_at = names.index("traces"), names.index("fri")
    assert tracing.exit_log() == (names[:traces_at] + TRACES_SPANS + names[traces_at:fri_at]
                                  + FRI_SPANS * rounds + names[fri_at:])
    assert names[1:] == PROVER_PHASES
    assert all(tracing._root.children[n].rss_end_kb > 0 for n in names)
    assert not tracing.enabled()  # the CLI restores the switches it set


def test_tracing_off_touches_no_barrier_profiler_or_proc(golden, tmp_path, monkeypatch):
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

    def untouched(*args, **kwargs):
        raise AssertionError("tracing off touched the device, the profiler or /proc")

    monkeypatch.setattr(tracing, "_vmrss_kb", untouched)
    monkeypatch.setattr(tracing, "_device_barrier", untouched)
    monkeypatch.setattr(tracing, "_start_profiler", untouched)
    monkeypatch.setattr(torch.cuda, "synchronize", untouched)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", untouched)
    monkeypatch.setattr(torch.profiler, "record_function", untouched)
    hook, filters = warnings.showwarning, list(warnings.filters)
    with open(R1CS, "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(WTNS, "rb") as f:
        witness = read_witness(f.read())
    from stark_tpu_torch.protocol import proof as proof_mod

    proof = runner.prove_with_witness(r1cs, witness, device="cpu")
    assert proof_mod.to_json(proof) == golden
    assert runner.verify_with_witness(r1cs, witness[: runner._n_pub(r1cs)], proof,
                                      device="cpu")
    assert tracing.top_names() == ["arithmetize", *PROVER_PHASES, "v_arithmetize", "v_fri",
                                   "v_branches", "v_lde"]
    assert tracing.exit_log() == []
    assert warnings.showwarning is hook and warnings.filters == filters
    assert profiling.phase_counts() == {}


def test_worker_stdout_stays_protocol_lines_under_trace(golden, tmp_path, monkeypatch,
                                                         capsys):
    pj = str(tmp_path / "proof.json")
    files = {"r1cs": R1CS, "wtns": WTNS}
    requests = [
        {"id": 1, "method": "prove", "params": {**files, "proof_json": pj}},
        {"id": 2, "method": "verify", "params": {**files, "proof_json": pj}},
        {"id": 3, "method": "shutdown"},
    ]
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in requests)))
    assert cli.main(["serve", "--device", "cpu", "--trace", "--sync-phases"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 4 and all(line.startswith("RPC ") for line in lines)
    replies = [json.loads(line[4:]) for line in lines]
    assert replies[2]["result"]["verified"] is True
    with open(pj) as f:
        assert f.read() == golden
    for name in ["arithmetize", *PROVER_PHASES, "v_arithmetize", "v_fri", "v_lde",
                 "read_witness", "to_json"]:
        assert f"\n{name} " in "\n" + captured.err, name
    for name in FRI_SPANS:
        assert f"\n  {name} " in captured.err, name


def test_fri_rounds_open_fold_and_commit_inside_fri(golden, tmp_path, capsys):
    assert _cli_prove(tmp_path, "--trace") == golden
    fri = tracing._root.children["fri"]
    rounds = golden.count('"Middle"')
    assert rounds >= 1 and list(fri.children) == FRI_SPANS
    assert [fri.children[n].calls for n in FRI_SPANS] == [rounds, rounds]
    assert sum(c.elapsed for c in fri.children.values()) <= fri.elapsed
    out = capsys.readouterr().out
    assert all(f"\n  {name} " in out for name in FRI_SPANS)
    assert tracing.top_names()[1:] == PROVER_PHASES
    walls = profiling.phase_walls(top_only=False)
    assert walls["fri_fold"] == fri.children["fri_fold"].elapsed


def _sync_warning(where: str) -> None:
    """torch's text, as its warning handler raises it in debug mode "warn"."""
    warnings.warn(f"{tracing.SYNC_WARNING} (Triggered internally at {where}.)")


@pytest.fixture
def fake_card(monkeypatch):
    """torch's sync debug mode on a card that the CPU lacks: the calls that
    set it, in order, and the mode it holds."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    return modes


def test_sync_warnings_count_in_the_innermost_phase(fake_card, recwarn):
    tracing.configure(sync_phases=True)
    assert fake_card == [0, "warn"]
    _sync_warning("outside")
    with tracing.phase("prove"):
        _sync_warning("prove")
        with tracing.phase("fri"):
            with tracing.phase("fri_fold"):
                for _ in range(3):
                    _sync_warning("fri_fold")
                warnings.warn("another warning", RuntimeWarning)
            _sync_warning("fri")
        with tracing.phase("fri_fold"):  # the same name elsewhere in the tree
            _sync_warning("prove/fri_fold")
        tracing.sync_point(torch.zeros(2))
        tracing.count_sync()
    tracing.configure()
    _sync_warning("after")  # the count is off: torch's debug mode is too
    prove = tracing._root.children["prove"]
    fri = prove.children["fri"]
    assert tracing._root.host_syncs == 1 and prove.host_syncs == 2
    assert fri.host_syncs == 1 and fri.children["fri_fold"].host_syncs == 3
    assert profiling.phase_counts() == {profiling.OUTSIDE: 1, "prove": 2, "fri": 1,
                                        "fri_fold": 4}
    assert "x1  syncs 2" in tracing.report(prove) and "x1  syncs 3" in tracing.report(fri)
    # the other warning, and the sync warning once the count was off, reach
    # the caller; the counted ones do not
    assert [str(w.message) for w in recwarn] == [
        "another warning", f"{tracing.SYNC_WARNING} (Triggered internally at after.)"]
    assert fake_card == [0, "warn", 0]
    tracing.reset()
    assert profiling.phase_counts() == {} and "syncs" not in tracing.report()


def test_counting_off_restores_the_warning_handling(fake_card):
    hook, filters = warnings.showwarning, list(warnings.filters)
    previous = tracing.configure(sync_phases=True)
    assert warnings.showwarning is not hook and warnings.filters != filters
    tracing.configure(**{**previous, "sync_phases": True, "trace": True})  # still on
    assert fake_card == [0, "warn"]
    tracing.configure(**previous)
    assert warnings.showwarning is hook and warnings.filters == filters
    assert fake_card == [0, "warn", 0]
    with pytest.warns(UserWarning, match=tracing.SYNC_WARNING):
        _sync_warning("shown again")


def test_no_card_no_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hook = warnings.showwarning
    tracing.configure(sync_phases=True)
    assert warnings.showwarning is hook
    with tracing.phase("prove"):
        tracing.count_sync()
    assert profiling.phase_counts() == {}


def test_a_mesh_synchronize_counts_itself(fake_card, monkeypatch):
    """`torch.cuda.synchronize` raises no sync warning in torch's debug mode
    (torch 2.11 on an H100), so the mesh's barrier before each collective
    counts itself."""
    from stark_tpu_torch.parallel.distributed import DomainMesh

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    mesh = DomainMesh(0, 2, torch.device("cuda"), None, "gloo", True)
    mesh._sync()  # the count is off
    tracing.configure(sync_phases=True)
    with tracing.phase("fri"):
        mesh._sync()
        mesh._sync()
    tracing.configure()
    assert len(calls) == 3
    assert profiling.phase_counts() == {"fri": 2}
