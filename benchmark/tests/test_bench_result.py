"""Whole runs of tiny cells on the CPU: the result line's keys, and
`correct` false when the timed path is broken underneath (an answer
altered where it is produced). The harness's look for a card is skipped
(`require_card=False`); everything else runs as on the card."""

from __future__ import annotations

import pytest

from benchmark.tests.bench_tiny import make_root, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", ["chain23-b2s-stream", "chain23-b2s-worker"])
def test_untraced_line(root, workload):
    rc, line, err = run_cell(root, workload, trace=0, seconds=2)
    assert rc == 0, err
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True, err
    assert set(line["metrics"]) == {"constraints_per_s", "prove_p90_s", "peak_device_gb",
                                    "setup_s"}
    assert "check mismatched_proofs = 0 (limit <= 0)" in err


def test_traced_line(root):
    rc, line, err = run_cell(root, "chain23-b2s-stream", trace=1)
    assert rc == 0, err
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert line["correct"] is True, err
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no device-side phase ranges exist: the rooflines read nothing
    assert {"outside_phases_ms", "arithmetize_ms", "materialize_ms", "fri_ms",
            "device_idle_pct", "launches_per_proof"} <= set(line["metrics"])


def _altered(real):
    """An answer altered where it is produced: one bit of the l-root."""
    def prove(*a, **k):
        proof = real(*a, **k)
        proof.l_root = bytes([proof.l_root[0] ^ 1]) + proof.l_root[1:]
        return proof
    return prove


def _stale(real):
    """A step that returns its state unchanged: every call proves, then
    answers with the first proof it made."""
    first = []

    def prove(*a, **k):
        proof = real(*a, **k)
        first.append(proof)
        return first[0]
    return prove


@pytest.mark.parametrize("fault", [_altered, _stale])
@pytest.mark.parametrize("workload", ["chain23-b2s-stream", "chain23-b2s-worker"])
def test_a_broken_timed_path_is_not_correct(root, workload, fault, monkeypatch):
    from stark_tpu_torch.protocol import runner

    monkeypatch.setattr(runner, "prove_with_rows", fault(runner.prove_with_rows))
    # a seed whose sampled witness is not the first: a stale answer is the
    # first witness's proof, right for that witness alone
    rc, line, err = run_cell(root, workload, trace=0, seconds=5, seed=4294967312)
    assert rc == 0, err
    assert line["correct"] is False
    assert line["checks"]["mismatched_proofs"]["value"] >= 1
    assert list(line)[-1] == "checks"
