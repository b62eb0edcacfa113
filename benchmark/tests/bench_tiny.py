"""A tiny copy of the benchmark for the CPU tests: `BENCHMARK.json`, the
configurations and the mixes under a temporary root, the cells cut to a
squaring chain of 40 constraints (steps 128, precision 1,024) and mixes of
2 witnesses and 1 traced call a part, and a cell of the worker's mix; the
harness runs them on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N = 40


def make_root(path: str, copy_code: bool = False) -> str:
    os.makedirs(os.path.join(path, "benchmark", "configs"), exist_ok=True)
    if copy_code:
        shutil.rmtree(os.path.join(path, "benchmark"))
        shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(path, "benchmark"),
                        ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    os.makedirs(os.path.join(path, "benchmark", "traffic"), exist_ok=True)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    confs = []
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        conf.update({"circuit": {"family": "squaring_chain", "sizes": {"n_constraints": N}},
                     "n_constraints": N, "n_wires": N + 2, "steps": 128, "precision": 1024})
        with open(os.path.join(path, c["file"]), "w") as f:
            json.dump(conf, f)
        confs.append(c)
    # the worker's mix has no cell of its own yet (PERF.md, Open questions)
    bench["workloads"].append({"name": "chain23-b2s-worker", "config": "chain-2p23-blake2s",
                               "traffic": "worker", "chips": 1, "why": "the worker"})
    for w in bench["workloads"]:
        with open(os.path.join(REPO, "benchmark", "traffic", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        mix.update({"pool": 2, "trace_calls": 1})
        with open(os.path.join(path, "benchmark", "traffic", w["traffic"] + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


def run_cell(root: str, workload: str, trace: int = 0, seed: int = 4294967311,
             seconds: float = 4.0):
    """The harness's main on the CPU: (return code, last stdout line as a
    dict or None, stderr)."""
    from benchmark import harness

    torch.set_num_threads(2)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(trace)], device="cpu",
                          require_card=False, root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
