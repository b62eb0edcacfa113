"""The port's phase tracer (`stark_tpu_torch/utils/tracing.py`) against the
JAX package's (`stark_tpu/utils/tracing.py`), on the CPU:

* `report()` gives the JAX package's text character for character for the
  same nested sequence of phases, `time.perf_counter` patched to one
  deterministic clock for both, with and without the RSS column;
* the `compute` golden's proof is byte-identical with tracing off, under
  `--trace`, and under `--sync-phases --rss` (the CLI's `prove`), and the
  report names the prover's phases;
* with every switch off a phase neither synchronizes, nor touches the
  profiler, nor reads `/proc`;
* under `--trace` the worker's stdout holds only its protocol's lines (the
  reports go to stderr), and `--sync-phases` logs one barrier an exit.

The phases' names and order against a JAX prove and verify are held in
`tests/test_torch_prove_many.py`, where the JAX stages are compiled
already. Tolerance: exact (text and bytes).
"""

import io
import json
import os
import sys
import time

import pytest
import torch

from stark_tpu.utils import tracing as jtracing
from stark_tpu_torch import cli
from stark_tpu_torch.utils import tracing

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
R1CS = os.path.join(FIX, "compute.r1cs")
WTNS = os.path.join(FIX, "compute.wtns")
PROVER_PHASES = ["traces", "a_tree", "columns", "commits", "branches", "fri", "materialize"]


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
    assert tracing.exit_log() == names and names[1:] == PROVER_PHASES
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
    monkeypatch.setattr(torch.profiler, "record_function", untouched)
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
    for name in ["arithmetize", *PROVER_PHASES, "v_arithmetize", "v_fri", "v_lde"]:
        assert f"\n{name} " in "\n" + captured.err, name
