"""The ragged configuration's entries and its cell: the registry resolves
`ragged23-b2s-stream`, its configuration, family and the two span metrics;
a tiny copy of the cell (the family at depth 1: one copy of the
reference's Poseidon circuit, widths up to 61) runs through the harness on
the CPU, `correct` on the reference's ragged path, and its traced line
holds `p_scan_ms` and `trace_inputs_ms`, which a program without those
spans leaves out."""

from __future__ import annotations

import importlib
import json
import os

import pytest

from benchmark.tests.bench_tiny import REPO, make_root, run_cell

CELL, CONFIG = "ragged23-b2s-stream", "ragged-2p23-blake2s"
TINY = {"n_constraints": 234, "depth": 1}


def test_the_registry_resolves_the_cell():
    from benchmark import harness

    cell = harness.Cell(CELL)
    assert cell.config["name"] == CONFIG and cell.work["traffic"] == "stream"
    assert cell.chips == 1
    entry = {c["name"]: c for c in cell.bench["configs"]}[CONFIG]
    assert entry["reduced"] == cell.config["reduced"]
    assert harness.family(cell.config).__name__ == "benchmark.circuits.poseidon_tree"
    sizes = cell.config["circuit"]["sizes"]
    assert sizes == {"n_constraints": 29718, "depth": 7}
    names = [m["name"] for m in cell.metrics("per_layer")]
    for name in ("p_scan_ms", "trace_inputs_ms"):
        assert name in names
        assert callable(importlib.import_module(f"benchmark.metrics.{name}").read)
    for other in ("chain23-b2s-stream", "chain22-pos-stream", "chain23-b2s-worker"):
        got = [m["name"] for m in harness.Cell(other).metrics("per_layer")]
        assert {"p_scan_ms", "trace_inputs_ms"} <= set(got)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(str(tmp_path_factory.mktemp("bench")))
    path = os.path.join(root, "benchmark", "configs", CONFIG + ".json")
    with open(os.path.join(REPO, "benchmark", "configs", CONFIG + ".json")) as f:
        conf = json.load(f)
    conf.update({"circuit": {"family": "poseidon_tree", "sizes": TINY}, "n_constraints": 234,
                 "n_wires": 237, "steps": 8192, "precision": 65536})
    with open(path, "w") as f:
        json.dump(conf, f)
    return root


def test_a_tiny_ragged_cell_is_correct_and_reads_its_spans(root):
    rc, line, err = run_cell(root, CELL, trace=0, seconds=2)
    assert rc == 0, err
    assert line["correct"] is True and line["checks"]["compared"]["value"] >= 1, err
    rc, line, err = run_cell(root, CELL, trace=1)
    assert rc == 0, err
    assert line["correct"] is True, err
    metrics = line["metrics"]
    assert {"p_scan_ms", "trace_inputs_ms", "fri_ms"} <= set(metrics)
    assert 0 < metrics["p_scan_ms"]["value"] and 0 < metrics["trace_inputs_ms"]["value"]


def test_a_tree_without_the_spans_reads_nothing():
    from stark_tpu_torch.utils import tracing

    previous = tracing.configure()
    tracing.reset()
    try:
        with tracing.phase("traces"):
            pass
        ctx = {"layer": {"n": 1}}
        for name in ("p_scan_ms", "trace_inputs_ms"):
            assert importlib.import_module(f"benchmark.metrics.{name}").read(ctx) is None
    finally:
        tracing.configure(**previous)
        tracing.reset()
