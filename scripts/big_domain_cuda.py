#!/usr/bin/env python3
"""Prove and verify, on one NVIDIA GPU, the largest `squaring_chain` that a
precision admits, with the PyTorch/CUDA port:

    python3 scripts/big_domain_cuda.py --log-precision 23 [--stages] [--file-route] [--out DIR]

`--log-precision` k (21-23) sets the domain: steps 2^(k-3) and the circuit
of floor(2^(k-3) / 3) constraints (87,381 at 2^21, 174,762 at 2^22,
349,525 at 2^23). Precision 2^23 is the largest the protocol proves
(`stark_tpu_torch/protocol/core.py MAX_PRECISION`: its index sampler takes
moduli below 2^24).

Prints one JSON line a record: the card (`nvidia-smi
--query-gpu=name,power.limit` and the torch build), the host's seconds
(synthesis of the circuit, its arithmetization, the witness rows), then a
cold prove (the stage set's build included), a warm prove and a verify,
each with its wall and `torch.cuda.max_memory_allocated` over it, and the
proof's sha256; with `--stages`, one more prove with a device synchronise
at the exit of each of the program's top-level phases and each phase's
wall and peak memory (`chip_smoke.stage_walls`: `utils/tracing.py`,
`utils/profiling.py phase_memory_peaks`). With `--file-route`, the circuit is written as
`.r1cs` and `.wtns` files (`synth.write_circuit_files`) and proved from
them: stage by stage on both routes in turns (`chip_smoke.file_route_stages`:
the native route's C++ readers, and the Python readers the file route took
before them; each stage's host wall), then the CLI's `prove`, `verify` and
`run` on each route, each command's wall; every proof must equal the cold
prove's byte for byte. The last line is a
summary. Exits 1 without a card or where the verifier rejects, 4 where the
card runs out of memory (the record names the bytes asked for, and those
allocated and reserved at that point). `--out DIR` also writes the records
to DIR/big_domain_<k>.json. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RECORDS: list[dict] = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def smi(query: str) -> str:
    done = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True)
    return (done.stdout or done.stderr).strip()


def timed(fn):
    """fn()'s result, its wall seconds and the peak device memory over it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, torch.cuda.max_memory_allocated()


def file_route(r1cs, witness, want_json: str) -> None:
    """The `--file-route` records (module docstring)."""
    import chip_smoke
    from stark_tpu_torch import cli
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness
    from stark_tpu_torch.r1cs.synth import write_circuit_files

    native_route = {name: getattr(runner, name)
                    for name in ("read_circuit", "read_witness_rows")}
    python_route = {
        "read_circuit": lambda path: read_r1cs(runner._read(path)),
        "read_witness_rows": lambda path, circuit: runner._witness_rows(
            circuit, read_witness(runner._read(path))),
    }
    with tempfile.TemporaryDirectory() as tmp:
        files = (os.path.join(tmp, "chain.r1cs"), os.path.join(tmp, "chain.wtns"))
        proof_path = os.path.join(tmp, "proof.json")
        t0 = time.time()
        write_circuit_files(r1cs, witness, *files)
        emit({"phase": "files", "write_s": time.time() - t0,
              "bytes": [os.path.getsize(path) for path in files]})
        for route in ("python", "native", "native", "python"):
            walls, text = chip_smoke.file_route_stages(*files, proof_path, "cuda", route)
            if text != want_json:
                raise AssertionError(f"the {route} route's proof differs")
            emit({"phase": "file_route_stages", **walls})
        for route, pieces in (("native", native_route), ("python", python_route),
                              ("python", python_route), ("native", native_route)):
            for name, fn in pieces.items():
                setattr(runner, name, fn)
            for cmd in ("prove", "verify", "run"):
                printed = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.time()
                with contextlib.redirect_stdout(printed):
                    rc = cli.main([cmd, *files, proof_path, "--device", "cuda"])
                torch.cuda.synchronize()
                wall = time.time() - t0
                with open(proof_path) as f:
                    same = f.read() == want_json
                if rc != 0 or not same:
                    raise AssertionError(f"cli {cmd} on the {route} route: rc {rc}, "
                                         f"proof equal {same}")
                emit({"phase": "file_route_cli", "route": route, "command": cmd,
                      "wall_s": wall, "printed": printed.getvalue().splitlines()})
        for name, fn in native_route.items():
            setattr(runner, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-precision", type=int, required=True, choices=range(21, 24))
    ap.add_argument("--stages", action="store_true",
                    help="also prove once with a synchronise after each stage")
    ap.add_argument("--file-route", action="store_true",
                    help="also prove from the circuit's files on both routes")
    ap.add_argument("--out", help="also write the records to DIR/big_domain_<k>.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("big_domain_cuda: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import build
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol.params import derive_params
    from stark_tpu_torch.r1cs.synth import squaring_chain

    precision = 1 << args.log_precision
    n = (precision // 8) // 3
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi("name,power.limit"),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "log_precision": args.log_precision, "constraints": n,
          "total_memory_bytes": torch.cuda.get_device_properties(0).total_memory})
    build.load()
    phase = "host"
    try:
        t0 = time.time()
        r1cs, witness = squaring_chain(n)
        synth_s = time.time() - t0
        t0 = time.time()
        arith = runner._static_arith(spec, r1cs)
        arith_s = time.time() - t0
        t0 = time.time()
        runner._witness_rows(r1cs, witness)
        rows_s = time.time() - t0
        params = derive_params(spec, arith.original_steps)
        if params.precision != precision:
            raise AssertionError(f"{n} constraints give precision {params.precision}")
        emit({"phase": "host", "synthesis_s": synth_s, "arithmetization_s": arith_s,
              "witness_rows_s": rows_s, "steps": params.steps, "precision": precision})

        def prove_once():
            return runner.prove_with_witness(r1cs, witness, device="cuda")

        proofs = {}
        for phase in ("prove_cold", "prove_warm"):
            proofs[phase], wall, peak = timed(prove_once)
            emit({"phase": phase, "wall_s": wall, "peak_bytes": peak})
        if proofs["prove_warm"] != proofs["prove_cold"]:
            raise AssertionError("the warm proof differs from the cold one")
        proof = proofs["prove_cold"]
        del proofs
        sha = hashlib.sha256(proof_mod.to_json(proof).encode()).hexdigest()
        phase = "verify"
        n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
        ok, wall, peak = timed(lambda: runner.verify_with_witness(
            r1cs, witness[:n_pub], proof, device="cuda", verify_cache=False))
        emit({"phase": "verify", "accepted": bool(ok), "wall_s": wall,
              "peak_bytes": peak, "proof_sha256": sha})
        if args.file_route:
            phase = "file_route"
            file_route(r1cs, witness, proof_mod.to_json(proof))
        if args.stages:
            phase = "stages"
            walls = chip_smoke.stage_walls(r1cs, witness, "cuda", proof, "dft", runs=1)[0]
            emit({"phase": "stages", **walls})
    except torch.cuda.OutOfMemoryError as e:
        asked = re.search(r"Tried to allocate ([0-9.]+ [KMGT]?i?B)", str(e))
        emit({"phase": phase, "out_of_memory": True,
              "asked": asked.group(1) if asked else None,
              "allocated_bytes": torch.cuda.memory_allocated(),
              "reserved_bytes": torch.cuda.memory_reserved(),
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "message": str(e).splitlines()[0]})
        ok = None
    summary = {"log_precision": args.log_precision, "constraints": n,
               "proved_and_verified": bool(ok), "out_of_memory": ok is None}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"big_domain_{args.log_precision}.json")
        with open(path, "w") as f:
            json.dump({"records": RECORDS, "summary": summary}, f, indent=1)
    print(json.dumps(summary))
    return 4 if ok is None else 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
