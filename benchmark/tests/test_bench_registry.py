"""BENCHMARK.json against the format its checker takes, and every configuration,
mix, driver, circuit family and metric found by its name; a cell, mix and
metric added as files and entries alone is picked up."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.tests.bench_tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_entries_and_names(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in bench["configs"]}
        assert os.path.exists(os.path.join(REPO, "benchmark", "traffic", w["traffic"] + ".json"))
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(
        bench["workloads"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", m["name"] + ".py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["name"] not in names
        names.add(m["name"])


def test_every_name_resolves(bench):
    from benchmark import harness

    for w in bench["workloads"]:
        cell = harness.Cell(w["name"])
        harness.family(cell.config)
        __import__(f"benchmark.drivers.{cell.traffic['driver']}")
        assert cell.traffic["ref_sample"] >= 1 and cell.traffic["pool"] >= 2
        assert 2 * cell.traffic["trace_calls"] >= cell.traffic["pool"]


def test_a_cell_added_as_files_is_found(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and a
    cell by new files and new entries only; the copy's harness finds them."""
    from benchmark.tests.bench_tiny import make_root

    root = make_root(str(tmp_path), copy_code=True)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "chain-2p23-blake2s.json")) as f:
        conf = json.load(f)
    conf["name"] = "dummy-config"
    with open(os.path.join(b, "configs", "dummy-config.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(b, "traffic", "dummy.json"), "w") as f:
        json.dump({"driver": "stream", "pool": 2, "ref_sample": 1, "trace_calls": 1}, f)
    with open(os.path.join(b, "metrics", "dummy_ms.py"), "w") as f:
        f.write("def read(ctx):\n    return 1000.0 * ctx['layer']['call_wall_s']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dummy-config", "source": "x",
                             "file": "benchmark/configs/dummy-config.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "dummy", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "entry",
                               "moves": "constraints_per_s", "workloads": ["dummy-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import benchmark, importlib\n"
        "assert benchmark.__file__.startswith(sys.argv[1]), benchmark.__file__\n"
        "from benchmark import harness\n"
        "cell = harness.Cell('dummy-cell', sys.argv[1])\n"
        "assert cell.config['name'] == 'dummy-config' and cell.traffic['pool'] == 2\n"
        "names = [m['name'] for m in cell.metrics('per_layer')]\n"
        "assert 'dummy_ms' in names, names\n"
        "m = importlib.import_module('benchmark.metrics.dummy_ms')\n"
        "print(m.read({'layer': {'call_wall_s': 0.25}}))\n"
        "other = harness.Cell('chain23-b2s-stream', sys.argv[1])\n"
        "assert 'dummy_ms' not in [m['name'] for m in other.metrics('per_layer')]\n"
    )
    out = subprocess.run([sys.executable, "-c", code, root, REPO], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "250.0"
