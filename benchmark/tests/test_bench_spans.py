"""The readers of the program's nested spans, the worker's spans and the
host-sync count (`benchmark/spans.py`): traced lines of tiny cells on the
CPU hold the spans' metrics (the CPU counts no host syncs, so that one is
left out), and each reader, given a tree, returns its per-call sum."""

from __future__ import annotations

import importlib

import pytest

from benchmark.tests.bench_tiny import make_root, run_cell

SPANS = {"chain23-b2s-stream": {"fri_fold_ms", "fri_commit_ms"},
         "chain23-b2s-worker": {"fri_fold_ms", "fri_commit_ms", "witness_read_ms",
                                "to_json_ms"}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", sorted(SPANS))
def test_traced_line_holds_the_spans(root, workload):
    rc, line, err = run_cell(root, workload, trace=1)
    assert rc == 0, err
    assert line["correct"] is True, err
    metrics = line["metrics"]
    assert SPANS[workload] <= set(metrics)
    assert "host_syncs_per_proof" not in metrics
    assert metrics["fri_fold_ms"]["value"] + metrics["fri_commit_ms"]["value"] <= \
        metrics["fri_ms"]["value"]
    if workload == "chain23-b2s-stream":
        assert not {"witness_read_ms", "to_json_ms"} & set(metrics)


@pytest.fixture
def tree():
    """Two calls' tree: each a `read_witness`, a `fri` of two rounds and a
    `to_json`, with host syncs inside and outside the phases."""
    from stark_tpu_torch.utils import tracing

    previous = tracing.configure()
    tracing.reset()
    clock = iter(range(1000))
    real = tracing.time.perf_counter
    tracing.time.perf_counter = lambda: next(clock) * 1e-3  # one ms a tick
    try:
        for _ in range(2):
            tracing._root.host_syncs += 1
            with tracing.phase("read_witness"):
                pass
            with tracing.phase("fri") as fri:
                fri.host_syncs += 5
                for _ in range(2):
                    with tracing.phase("fri_fold") as node:
                        node.host_syncs += 7
                    with tracing.phase("fri_commit") as node:
                        node.host_syncs += 1
            with tracing.phase("to_json"):
                pass
    finally:
        tracing.time.perf_counter = real
    yield
    tracing.reset()
    tracing.configure(**previous)


@pytest.mark.parametrize("metric, want", [
    ("host_syncs_per_proof", 1 + 5 + 2 * (7 + 1)),
    ("fri_fold_ms", 2.0),  # two rounds of one tick
    ("fri_commit_ms", 2.0),
    ("witness_read_ms", 1.0),
    ("to_json_ms", 1.0),
])
def test_reader_returns_the_per_call_sum(tree, metric, want):
    read = importlib.import_module(f"benchmark.metrics.{metric}").read
    assert read({"layer": {"n": 2}}) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["host_syncs_per_proof", "fri_fold_ms", "to_json_ms"])
def test_reader_of_an_empty_tree_reads_nothing(metric):
    from stark_tpu_torch.utils import tracing

    tracing.reset()
    read = importlib.import_module(f"benchmark.metrics.{metric}").read
    assert read({"layer": {"n": 4}}) is None
