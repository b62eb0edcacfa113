#!/usr/bin/env python3
"""The CLI's first prove in a fresh process after `cli warmup`, on one
NVIDIA GPU, with the PyTorch/CUDA port:

    python3 scripts/cold_start_cuda.py [--constraints 43690] [--out DIR]

Writes `squaring_chain(n)` as `.r1cs` and `.wtns` files, then runs, each in
a fresh process, `python -m stark_tpu_torch.cli warmup chain.r1cs`, then
`... prove chain.r1cs chain.wtns proof.json` and `... verify` of that proof.
Each child finds first on its PATH an `nvcc` that logs its arguments and
runs the real compiler, so the records count every `nvcc` call of each
process (the kernel library's key runs none). Run it first in a checkout
whose `stark_tpu_torch/_build/` holds no kernel library: the first record
lists what that directory held at the start. Prints one JSON line a record
(the card, the start, each child's wall, printed lines and `nvcc` calls);
the last line is a summary. Exits 1 without a card or where a child fails.
`--out DIR` also writes the records to DIR/cold_start.json. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import stat
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RECORDS: list[dict] = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--constraints", type=int, default=43690)
    ap.add_argument("--out", help="also write the records to DIR/cold_start.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("cold_start_cuda: no CUDA device", file=sys.stderr)
        return 1
    from stark_tpu_torch.ops import build
    from stark_tpu_torch.r1cs.synth import squaring_chain, write_circuit_files

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    held = sorted(os.listdir(build.BUILD_ROOT)) if os.path.isdir(build.BUILD_ROOT) else []
    libraries = [d for d in held
                 if os.path.exists(os.path.join(build.BUILD_ROOT, d, "libstark_kernels.so"))]
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "build_root_at_start": held, "kernel_libraries_at_start": libraries,
          "constraints": args.constraints})
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        shim_dir = os.path.join(tmp, "bin")
        os.makedirs(shim_dir)
        log = os.path.join(tmp, "nvcc.log")
        shim = os.path.join(shim_dir, "nvcc")
        with open(shim, "w") as f:
            f.write(f'#!/bin/sh\necho "$*" >> "{log}"\nexec "{build._nvcc()}" "$@"\n')
        os.chmod(shim, os.stat(shim).st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
        env = {**os.environ, "PATH": shim_dir + os.pathsep + os.environ.get("PATH", "")}
        files = [os.path.join(tmp, name) for name in ("chain.r1cs", "chain.wtns", "proof.json")]
        write_circuit_files(*squaring_chain(args.constraints), files[0], files[1])
        for name, argv_ in (("warmup", ["warmup", files[0]]), ("prove", ["prove", *files]),
                            ("verify", ["verify", *files])):
            before = 0
            if os.path.exists(log):
                with open(log) as f:
                    before = len(f.readlines())
            t0 = time.time()
            done = subprocess.run([sys.executable, "-m", "stark_tpu_torch.cli", *argv_,
                                   "--device", "cuda"], cwd=ROOT, env=env,
                                  capture_output=True, text=True, timeout=600)
            wall = time.time() - t0
            calls = []
            if os.path.exists(log):
                with open(log) as f:
                    calls = [ln.strip() for ln in f.readlines()[before:]]
            emit({"child": name, "wall_s": wall, "returncode": done.returncode,
                  "printed": done.stdout.splitlines(), "nvcc_calls": len(calls),
                  "nvcc_compiles": sum(" -c " in f" {c} " for c in calls),
                  "stderr_tail": done.stderr[-1500:] if done.returncode else ""})
            ok = ok and done.returncode == 0
    summary = {"ok": ok, "fresh_checkout": not libraries,
               "prove_nvcc_calls": next(r["nvcc_calls"] for r in RECORDS
                                        if r.get("child") == "prove")}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "cold_start.json"), "w") as f:
            json.dump({"records": RECORDS, "summary": summary}, f, indent=1)
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
