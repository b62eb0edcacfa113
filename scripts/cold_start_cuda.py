#!/usr/bin/env python3
"""The CLI's first prove in a fresh process after `cli warmup`, and after
`cli cache-unpack` into an empty `_build/`, on one NVIDIA GPU, with the
PyTorch/CUDA port:

    python3 scripts/cold_start_cuda.py [--constraints 43690] [--out DIR]

Writes `squaring_chain(n)` as `.r1cs` and `.wtns` files, then runs, each in
a fresh process, `python -m stark_tpu_torch.cli warmup chain.r1cs`, then
`... prove chain.r1cs chain.wtns proof.json` and `... verify` of that proof.
Then the cache round trip: `... cache-pack warm.tar.gz`, `_build/` emptied
(the kernel library and the host library; the default route builds no CRT
tables, and their cache lies outside the checkout, so it is left alone),
`... cache-unpack warm.tar.gz`, and a fresh `prove` and `verify`, whose
proof must equal the first. Each child finds first on its PATH an `nvcc`
and a `g++` that log their arguments and run the real compilers, so the
records count every compiler call of each process (the kernel library's
key runs none): after the unpack there must be none. Run it first in a
checkout whose `stark_tpu_torch/_build/` holds no kernel library: the
first record lists what that directory held at the start. Prints one JSON
line a record (the card, the start, each child's wall, printed lines and
compiler calls, the archive's bytes); the last line is a summary. Exits 1
without a card or where a child or a check fails. `--out DIR` also writes
the records to DIR/cold_start.json. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
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
        log = os.path.join(tmp, "compilers.log")
        for name, real in (("nvcc", build._nvcc()), ("g++", shutil.which("g++"))):
            shim = os.path.join(shim_dir, name)
            with open(shim, "w") as f:
                f.write(f'#!/bin/sh\necho "{name} $*" >> "{log}"\nexec "{real}" "$@"\n')
            os.chmod(shim, os.stat(shim).st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
        env = {**os.environ, "PATH": shim_dir + os.pathsep + os.environ.get("PATH", "")}
        files = [os.path.join(tmp, name) for name in ("chain.r1cs", "chain.wtns", "proof.json")]
        archive = os.path.join(tmp, "warm.tar.gz")
        write_circuit_files(*squaring_chain(args.constraints), files[0], files[1])

        def child(name, argv_):
            before = 0
            if os.path.exists(log):
                with open(log) as f:
                    before = len(f.readlines())
            t0 = time.time()
            done = subprocess.run([sys.executable, "-m", "stark_tpu_torch.cli", *argv_],
                                  cwd=ROOT, env=env, capture_output=True, text=True,
                                  timeout=600)
            wall = time.time() - t0
            calls = []
            if os.path.exists(log):
                with open(log) as f:
                    calls = [ln.strip() for ln in f.readlines()[before:]]
            nvcc = [c for c in calls if c.startswith("nvcc ")]
            emit({"child": name, "wall_s": wall, "returncode": done.returncode,
                  "printed": done.stdout.splitlines(), "nvcc_calls": len(nvcc),
                  "nvcc_compiles": sum(" -c " in f" {c} " for c in nvcc),
                  "gxx_calls": len(calls) - len(nvcc),
                  "stderr_tail": done.stderr[-1500:] if done.returncode else ""})
            return done.returncode == 0

        cuda = ["--device", "cuda"]
        for name, argv_ in (("warmup", ["warmup", files[0], *cuda]),
                            ("prove", ["prove", *files, *cuda]),
                            ("verify", ["verify", *files, *cuda])):
            ok = child(name, argv_) and ok
        with open(files[2]) as f:
            first_proof = f.read()
        ok = child("cache-pack", ["cache-pack", archive]) and ok
        archive_bytes = os.path.getsize(archive) if os.path.exists(archive) else None
        emit({"archive_bytes": archive_bytes,
              "emptied": os.path.relpath(build.BUILD_ROOT, ROOT)})
        shutil.rmtree(build.BUILD_ROOT, ignore_errors=True)
        os.remove(files[2])
        for name, argv_ in (("cache-unpack", ["cache-unpack", archive]),
                            ("prove after unpack", ["prove", *files, *cuda]),
                            ("verify after unpack", ["verify", *files, *cuda])):
            ok = child(name, argv_) and ok
        same = False
        if os.path.exists(files[2]):
            with open(files[2]) as f:
                same = f.read() == first_proof
        ok = ok and same
    by = {r["child"]: r for r in RECORDS if "child" in r}
    after = ("prove after unpack", "verify after unpack")
    summary = {"ok": ok, "fresh_checkout": not libraries,
               "prove_nvcc_calls": by["prove"]["nvcc_calls"],
               "archive_bytes": archive_bytes,
               "pack_s": by["cache-pack"]["wall_s"], "unpack_s": by["cache-unpack"]["wall_s"],
               "compiler_calls_after_unpack": sum(by[n]["nvcc_calls"] + by[n]["gxx_calls"]
                                                  for n in after),
               "prove_after_unpack_s": by["prove after unpack"]["wall_s"],
               "proof_after_unpack_equal": same}
    ok = ok and summary["compiler_calls_after_unpack"] == 0
    summary["ok"] = ok
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "cold_start.json"), "w") as f:
            json.dump({"records": RECORDS, "summary": summary}, f, indent=1)
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
