#!/usr/bin/env python3
"""Warm proves of `squaring_chain(n)` on one NVIDIA GPU by the port of a
given tree, on the defaults and with tracing off:

    python3 scripts/warm_prove_cuda.py [--tree DIR] [--constraints 43690] [--proves 8]

Imports `stark_tpu_torch` from DIR (default: this checkout), so that its
kernels are built and loaded there, proves once cold, then `--proves` times
warm, each wall from a device synchronise to the returned proof (which ends
in its materializing transfer). Prints one JSON line: the tree, the card's
name and power limit, the cold wall, each warm wall, their median and
minimum, the proof's sha256. To hold two commits against each other, run it
on both trees in one call, in turns (parent, change, change, parent): the
proof's sha256 must agree. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--constraints", type=int, default=43690)
    ap.add_argument("--proves", type=int, default=8)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("warm_prove_cuda: no CUDA device", file=sys.stderr)
        return 1
    import stark_tpu_torch
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.r1cs.synth import squaring_chain

    if not os.path.abspath(stark_tpu_torch.__file__).startswith(tree + os.sep):
        raise AssertionError(f"stark_tpu_torch came from {stark_tpu_torch.__file__}, not {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    r1cs, witness = squaring_chain(args.constraints)

    def prove():
        torch.cuda.synchronize()
        t0 = time.time()
        proof = runner.prove_with_witness(r1cs, witness, device="cuda")
        return time.time() - t0, proof_mod.to_json(proof)

    cold_s, want = prove()
    warm = []
    for _ in range(args.proves):
        wall, text = prove()
        if text != want:
            raise AssertionError("a warm proof differs from the cold one")
        warm.append(wall)
    print(json.dumps({"tree": tree, "nvidia_smi": smi, "constraints": args.constraints,
                      "cold_s": cold_s, "warm_s": warm, "median_s": statistics.median(warm),
                      "min_s": min(warm),
                      "proof_sha256": hashlib.sha256(want.encode()).hexdigest()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
