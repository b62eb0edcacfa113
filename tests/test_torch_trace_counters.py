"""The `traces` phase's spans and counters (`utils/tracing.py`,
`protocol/prove.py`, `protocol/core.py`) on CPU proves:

* on a ragged circuit of the port's generator (20 constraints, widths up
  to 32), `trace_inputs` and `p_scan` open inside `traces`, once a proof,
  and `traces` counts `scan_carries` (the live slots whose F1 gate is open)
  and `pad_slots` (the slots past their factor's terms) as the circuit's
  structure gives them, once a proof, on the route with the host library
  and on the pure-Python one; `profiling.phase_counters` reads them;
* on a squaring chain both read 0;
* under `sync_phases` the prover waits on K times S (`tracing.sync_point`)
  inside `traces` before `p_scan` opens, once a proof, and not with the
  switch off;
* with every switch off the spans and counters neither synchronize, nor
  touch the profiler or torch's sync debug mode, and no host sync is
  counted.

Tolerance: exact (counts).
"""

import random

import pytest
import torch

from benchmark.circuits import squaring_chain as sc
from stark_tpu_torch import native
from stark_tpu_torch.protocol import core, runner
from stark_tpu_torch.utils import profiling, tracing
from torch_ragged import TWENTY, lens, witnesses, write_circuit

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def clean():
    previous = tracing.configure()
    tracing.reset()
    yield
    tracing.configure(**previous)
    tracing.reset()


def _counts(sizes) -> dict:
    """The counts from the family's structure: each constraint takes its
    widest factor's slots in each of the three regions."""
    terms = lens(sizes)
    width = terms.max(axis=1)
    return {"scan_carries": int(3 * (width - 1).sum()),
            "pad_slots": int(3 * width.sum() - terms.sum())}


@pytest.mark.parametrize("host_library", [True, False])
def test_ragged_spans_and_counters(tmp_path, monkeypatch, host_library):
    if not host_library:
        monkeypatch.setattr(native, "available", lambda: False)
    circuit = runner.read_circuit(write_circuit(tmp_path, TWENTY))
    want = _counts(TWENTY)
    assert want["scan_carries"] > 0 and want["pad_slots"] > 0
    for k, rows in enumerate(witnesses(TWENTY), start=1):
        runner.prove_with_rows(circuit, rows, device="cpu")
        traces = tracing._root.children["traces"]
        assert list(traces.children) == ["trace_inputs", "p_scan"]
        assert [c.calls for c in traces.children.values()] == [k, k]
        assert sum(c.elapsed for c in traces.children.values()) <= traces.elapsed
        assert traces.counters == {name: k * v for name, v in want.items()}
    assert profiling.phase_counters() == {"traces": {n: 2 * v for n, v in want.items()}}
    walls = profiling.phase_walls(top_only=False)
    assert walls["p_scan"] == traces.children["p_scan"].elapsed
    assert "scan_carries" in tracing.report()


def test_a_chain_counts_nothing(tmp_path):
    path = str(tmp_path / "chain.r1cs")
    sc.write_r1cs(path, {"n_constraints": 40})
    rows = sc.witness({"n_constraints": 40}, random.Random(2**34 + 1))
    runner.prove_with_rows(runner.read_circuit(path), rows, device="cpu")
    assert profiling.phase_counters() == {"traces": {"scan_carries": 0, "pad_slots": 0}}
    assert list(tracing._root.children["traces"].children) == ["trace_inputs", "p_scan"]


def test_tracing_off_adds_no_sync_and_no_device_call(tmp_path, monkeypatch):
    def untouched(*args, **kwargs):
        raise AssertionError("tracing off touched the device, the profiler or /proc")

    for mod, name in ((tracing, "_vmrss_kb"), (tracing, "_device_barrier"),
                      (tracing, "_start_profiler"), (torch.cuda, "synchronize"),
                      (torch.cuda, "set_sync_debug_mode"), (torch.profiler, "record_function")):
        monkeypatch.setattr(mod, name, untouched)
    circuit = runner.read_circuit(write_circuit(tmp_path, TWENTY))
    proof = runner.prove_with_rows(circuit, witnesses(TWENTY)[0], device="cpu")
    assert proof is not None and tracing.exit_log() == []
    assert profiling.phase_counts() == {}
    assert list(tracing._root.children["traces"].children) == ["trace_inputs", "p_scan"]
    assert profiling.phase_counters() == {"traces": _counts(TWENTY)}


def test_p_scan_opens_after_a_sync_point_under_sync_phases(tmp_path, monkeypatch):
    seen = []

    def sync_point(value):
        seen.append(([n.name for n in tracing._stack], tuple(value.shape)))
        return value

    monkeypatch.setattr(core, "sync_point", sync_point)
    circuit = runner.read_circuit(write_circuit(tmp_path, TWENTY))
    rows = witnesses(TWENTY)[0]
    runner.prove_with_rows(circuit, rows, device="cpu")
    assert seen == []
    tracing.configure(sync_phases=True)
    runner.prove_with_rows(circuit, rows, device="cpu")
    steps = tracing._root.children["traces"].children["p_scan"]
    assert steps.calls == 2 and len(seen) == 1
    stack, shape = seen[0]
    assert stack == ["root", "traces"] and shape[1] == 256
