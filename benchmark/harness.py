"""One run of one cell: set up, measure, check, print one result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one cell is data found by name:
`BENCHMARK.json` names the cell's configuration file and its traffic mix
(`benchmark/traffic/<mix>.json`); the configuration names its circuit
family (`benchmark/circuits/<family>.py`), the mix its driver
(`benchmark/drivers/<driver>.py`), and each per-layer metric has a reader
of its own name (`benchmark/metrics/<metric>.py`).

A run: set-up (the circuit file cached in `benchmark/.cache/`, the pool of
witnesses from the seed, the driver's set-up, one cold and one warm call);
then with `--trace 0` a closed loop of calls for `--seconds` seconds, which
gives the end-to-end metrics, and with `--trace 1` a profiled part and a
part with the program's phases synced, which give the per-layer metrics;
then the check: the plain reference (`benchmark/ref/`) proves the sampled
witnesses anew and every output of theirs from the timed path must equal
its proof to the byte. The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "stark_tpu")


def process_age() -> float:
    """Seconds since this process started, from /proc (the interpreter's
    own start included)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T0


_T0 = time.monotonic()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Cell:
    """The cell's entries of `BENCHMARK.json` and its data files."""

    def __init__(self, name: str, root: str = ROOT):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.work = cells[name]
        self.name = name
        conf = {c["name"]: c for c in self.bench["configs"]}[self.work["config"]]
        with open(os.path.join(root, conf["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(root, "benchmark", "traffic", self.work["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.chips = int(self.work["chips"])

    def metrics(self, kind: str) -> list[dict]:
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def family(config: dict):
    return importlib.import_module(f"benchmark.circuits.{config['circuit']['family']}")


def circuit_file(config: dict, cache: str = CACHE) -> str:
    """The configuration's `.r1cs`, written once into the fixed cache
    directory of the checkout and read by every later run."""
    c = config["circuit"]
    name = c["family"] + "-" + "-".join(f"{k}{v}" for k, v in sorted(c["sizes"].items()))
    path = os.path.join(cache, name + ".r1cs")
    if not os.path.exists(path):
        os.makedirs(cache, exist_ok=True)
        tmp = f"{path}.part"
        family(config).write_r1cs(tmp, c["sizes"])
        os.replace(tmp, path)
    return path


def witness_pool(config: dict, traffic: dict, seed: int) -> list[np.ndarray]:
    rng = random.Random(seed)
    mod = family(config)
    return [mod.witness(config["circuit"]["sizes"], rng) for _ in range(traffic["pool"])]


def sampled_witnesses(seed: int, traffic: dict) -> list[int]:
    """The pool witnesses whose outputs the reference checks, drawn from the
    seed."""
    rng = random.Random(seed ^ 0x5EED)
    return sorted(rng.sample(range(traffic["pool"]), traffic["ref_sample"]))


def quantile(values, q: float) -> float:
    """The q-quantile by `statistics.quantiles` (inclusive), 0 < q < 1."""
    if len(values) == 1:
        return float(values[0])
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return float(cuts[round(q * 100) - 1])


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def end_to_end(calls, window_s: float, n_constraints: int, peak_bytes: int,
               setup_s: float) -> dict:
    done = [c for c in calls if c["ok"]]
    lat = [c["end"] - c["start"] for c in done]
    return {
        "constraints_per_s": len(done) * n_constraints / window_s,
        "prove_p90_s": quantile(lat, 0.9) if lat else float("inf"),
        "peak_device_gb": peak_bytes / 1e9,
        "setup_s": setup_s,
    }


def _allocator_counts(dev) -> dict:
    if dev.type != "cuda":
        return {}
    import torch

    stats = torch.cuda.memory_stats(dev)
    return {k: stats.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc",
                                         "num_device_free")}


def _report_window(calls, window_s, before: dict, after: dict) -> None:
    """The window's calls on stderr: their count, quartiles and extremes,
    and what the caching allocator asked of the driver meanwhile."""
    lat = sorted(c["end"] - c["start"] for c in calls)
    q = statistics.quantiles(lat, n=4, method="inclusive") if len(lat) > 1 else lat * 3
    print(f"window: {len(calls)} calls in {window_s:.3f} s; wall min {lat[0]:.4f} "
          f"q1 {q[0]:.4f} median {q[1]:.4f} q3 {q[2]:.4f} max {lat[-1]:.4f} s; allocator "
          + ", ".join(f"{k} +{after[k] - before[k]}" for k in after), file=sys.stderr)
    print("walls ms: " + " ".join(f"{1e3 * (c['end'] - c['start']):.0f}" for c in calls),
          file=sys.stderr)


def main(argv=None, device: str = "cuda", require_card: bool = True, root: str = ROOT) -> int:
    """`device` and `require_card` are for the tests, which run a tiny cell
    on the CPU; a run on the command line always takes the card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, root)

    import torch

    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"the cell needs {cell.chips} CUDA device(s); this machine has {n}",
                  file=sys.stderr)
            return 3
    dev = torch.device(device)
    from benchmark import check, devtrace

    config, traffic = cell.config, cell.traffic
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    n_constraints = config["circuit"]["sizes"]["n_constraints"]
    cache = os.path.join(root, "benchmark", ".cache")
    r1cs_path = circuit_file(config, cache)
    pool = witness_pool(config, traffic, args.seed)
    sampled = sampled_witnesses(args.seed, traffic)
    run = driver.Driver(r1cs_path, pool, config, traffic, dev, keep=set(sampled))

    def session():
        """Set-up, then the window or the traced parts: on the client's side
        of the driver."""
        run.setup()  # one cold and one warm call
        setup_s = process_age()
        if args.trace == 0:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            alloc0 = _allocator_counts(dev)
            calls, window_s = run.window(args.seconds)
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
            _report_window(calls, window_s, alloc0, _allocator_counts(dev))
            e2e = end_to_end(calls, window_s, n_constraints, peak, setup_s)
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in cell.metrics("end_to_end")}
            return calls, metrics, peak, None, {}
        calls, layer = devtrace.traced_parts(run, traffic["trace_calls"], dev,
                                             os.path.join(cache, "trace"))
        peak = layer.pop("peak_bytes")
        ctx = {"layer": layer, "config": config, "cell": cell.name}
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": layer["busy_s"], "window_s": layer["window_s"]}
        return calls, metrics, peak, layer["breakdown"], extra

    try:
        calls, metrics, peak, breakdown, device_extra = run.execute(session)
        outputs = run.outputs()
    finally:
        run.close()
    del run
    failed = sum(not c["ok"] for c in calls)
    errors = [c["error"] for c in calls if not c["ok"]][:3]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(r1cs_path, pool, sampled, outputs, config, dev)
    numbers["failed_calls"] = {"value": failed, "limit": 0}
    correct = all(v["value"] <= v["limit"] for k, v in numbers.items() if k != "compared")
    correct = correct and numbers["compared"]["value"] >= numbers["compared"]["limit"]
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    for e in errors:
        print(f"failed call: {e}", file=sys.stderr)
    for k, v in numbers.items():
        rel = ">=" if k == "compared" else "<="
        print(f"check {k} = {v['value']} (limit {rel} {v['limit']})", file=sys.stderr)
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), cell.chips
    else:
        kind, count = "cpu", 1
    result = {
        "correct": bool(correct),
        "attempted": len(calls),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": count, "memory_peak_bytes": int(peak),
                   "power_limit": power_limit() if dev.type == "cuda" else "none",
                   **device_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = numbers
    print(json.dumps(result))
    return 0
