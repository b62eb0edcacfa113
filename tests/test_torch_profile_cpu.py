"""A real CPU-only `torch.profiler` run through the tracer, on the CPU: the
`compute` prove under `profile_dir` and `sync_phases`, inside one top-level
span, writes one Chrome trace, which `utils/profiling.py
parse_device_trace` reads with 0 device time; the trace holds the phases'
host ranges in order, `trace_inputs` and `p_scan` inside `traces`'s,
FRI's `fri_fold` and `fri_commit` inside `fri`'s, and one barrier range
an exit; the proof is the committed golden, byte for byte. (A file of its
own: the trace of this prove's ~700,000 host events takes ~25 s to
record, write and read.)
"""

import json
import os

import torch

from stark_tpu_torch.utils import profiling, tracing

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")


def test_a_real_cpu_profile_parses_with_no_device_time(tmp_path):
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner

    with open(os.path.join(FIX, "compute_proof_golden.json")) as f:
        golden = f.read()
    circuit = runner.read_circuit(os.path.join(FIX, "compute.r1cs"))
    rows = runner.read_witness_rows(os.path.join(FIX, "compute.wtns"), circuit)
    runner.prove_with_rows(circuit, rows, device="cpu")  # the stage set, outside the profile
    tracing.reset()
    previous = tracing.configure(profile_dir=str(tmp_path), sync_phases=True)
    try:
        with tracing.phase("prove"):
            proof = runner.prove_with_rows(circuit, rows, device="cpu")
    finally:
        tracing.configure(**previous)
    assert proof_mod.to_json(proof) == golden
    assert len(os.listdir(tmp_path)) == 1  # one top-level span, one trace
    rounds = golden.count('"Middle"')
    fri_spans = ["fri_fold", "fri_commit"] * rounds
    traces_spans = ["trace_inputs", "p_scan"]
    before = ["arithmetize", "traces", "a_tree", "columns", "commits", "branches"]
    assert tracing.exit_log() == (["arithmetize"] + traces_spans + before[1:] + fri_spans
                                  + ["fri", "materialize", "prove"])
    got = profiling.parse_device_trace(str(tmp_path), tracing.exit_log())
    assert got["device_busy_s"] == 0 and got["device_events"] == 0
    assert got["hand_kernel_s"] == 0 and got["phase_device_s"] == {}
    assert got["phase_attribution"] == "sync barriers"
    assert got["sync_barriers"] == len(tracing.exit_log())
    assert got["host_phases"] == (["prove"] + before[:2] + traces_spans + before[2:] + ["fri"]
                                  + fri_spans + ["materialize"])
    with open(os.path.join(tmp_path, got["trace"])) as f:
        ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    (fri_lo, fri_hi), = [(lo, hi) for lo, hi, name in ranges if name == "fri"]
    inner = [(lo, hi) for lo, hi, name in ranges if name in fri_spans]
    assert len(inner) == 2 * rounds
    assert all(fri_lo <= lo <= hi <= fri_hi for lo, hi in inner)
    tracing.reset()
