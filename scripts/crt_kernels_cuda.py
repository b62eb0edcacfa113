#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernel library and hold the three kernels of
the CRT LDE engine (`stark_tpu_torch/csrc/crt.cu`: `residues_in`,
`matmul_fold`, `reconstruct`) against their plain PyTorch versions on one
NVIDIA GPU, without the rest of `chip_smoke.py`.

    python3 scripts/crt_kernels_cuda.py [--out DIR] [--log-steps 17]

It runs `chip_smoke.phase_crt_kernels` alone: the engine's tables for
(steps, 8 * steps) are built (or loaded from the plan cache under
`stark_tpu_torch/_build/plans`), each kernel runs the four products of one
LDE and the small ragged shapes, and every output must equal the plain
version's (`torch.equal`). Printed: the card's name and power limit, what
`ptxas -v` said of the three kernels (registers, spills, shared memory),
and one JSON line per kernel and case with its median device time, the
plain version's, the bound and, for `matmul_fold`, the four bf16
`torch.bmm` of the same digit planes. Then one column's LDE runs on both
engines (`ops/ntt.py make_best_lde`) and must give equal planes; its
median device time on each is printed. With `--log-steps 18` or 19 the big
transform takes the three-level plan (precision 2^21, 2^22): the kernels'
cases, which are the two-level plan's, are skipped and only that LDE runs.
The quick check after a change to `crt.cu`; needs `nvcc` and a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def one_lde(spec, steps: int, precision: int) -> dict:
    """One random Montgomery column extended on both engines: equal planes,
    the set-up seconds of each engine (tables, plans) and the median device
    time of one LDE on each."""
    import numpy as np

    import chip_smoke
    from stark_tpu_torch.ops import ntt

    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    trace = chip_smoke.random_planes(np.random.default_rng(chip_smoke.SEED), spec, steps,
                                     "cuda")
    out = {"lde": f"{steps} -> {precision}"}
    planes = {}
    for engine in ntt.LDE_ENGINES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        lde = ntt.make_best_lde(spec, g1, g2, steps, precision, "cuda", engine)
        planes[engine] = lde(trace)
        torch.cuda.synchronize()
        out[f"{engine}_setup_s"] = time.time() - t0
        out[f"{engine}_ms"] = chip_smoke.median_ms(lambda: lde(trace), 10)
        out[f"{engine}_peak_bytes"] = torch.cuda.max_memory_allocated()
    if not torch.equal(planes["butterfly"], planes["crt"]):
        raise AssertionError("the two engines' LDEs differ")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/crt_kernels.json")
    ap.add_argument("--log-steps", type=int, default=17,
                    help="log2 of the trace length (default 17; precision is 8 times it)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("crt_kernels_cuda: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import build, mxu_ntt

    mxu_ntt.CACHE_DIR = chip_smoke.PLAN_CACHE
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    so = build.library_path()
    build.load()
    with open(os.path.join(os.path.dirname(so), "build.log")) as f:
        lines = [ln.strip() for ln in f]
    ptxas = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and any(
                k in ln for k in ("residues_in", "matmul_fold", "reconstruct")):
            ptxas.extend(lines[i : i + 4])
    records = [{"build_s": time.time() - t0, "ptxas": ptxas}]
    print(json.dumps(records[0]), flush=True)
    steps = 1 << args.log_steps
    precision = 8 * steps
    if precision <= 1 << 20:
        stats, tables_s = chip_smoke.phase_crt_kernels(spec, "cuda", steps, precision)
        records.append({"steps": steps, "precision": precision, "tables_s": tables_s})
        print(json.dumps(records[-1]), flush=True)
        for name, result in stats.items():
            chip_smoke.add_bounds(result, float(smi.split(",")[2].split()[0]) * 1e6)
            for label, case in result["cases"].items():
                records.append({"kernel": name, "case": label, **case})
                print(json.dumps(records[-1]), flush=True)
    records.append(one_lde(spec, steps, precision))
    print(json.dumps(records[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "crt_kernels.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
