#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernel library and check the Poseidon tree
kernels (`stark_tpu_torch/csrc/poseidon.cu`: `poseidon_leaves`,
`poseidon_pairs`) on one NVIDIA GPU, without the rest of `chip_smoke.py`.

    python3 scripts/poseidon_kernels_cuda.py [--out DIR]

Printed, one JSON line each: the card's name, power limit and highest SM
clock; the build's seconds and what `ptxas -v` said of the two kernels
(registers, spills); then `chip_smoke.compare_poseidon`'s cases, each held
to its plain version with `torch.equal` (the l-tree's 2^20 leaves, a fold
level of 2^19 pairs, 2^17, 1 and 3 hashes; 0, 1, BN254's r - 1 and
BLS12-381's p - 1 among the inputs), with the median device time, the
plain version's time, the operations bound and its share, and the levels
of a 2^20 tree timed alone (`levels`, `tree_ms`). The quick check after a
change to `csrc/poseidon.cu` (about a minute of command, most of it the
plain versions at 2^20 and 2^19). Needs `nvcc` and a CUDA card; imports
nothing of JAX.
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

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/poseidon_kernels.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("poseidon_kernels_cuda: no CUDA device", file=sys.stderr)
        return 1
    from stark_tpu_torch.ops import build

    def smi(query: str) -> str:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()

    sm_mhz = float(smi("clocks.max.sm").split()[0])
    records = [{"device": torch.cuda.get_device_name(0), "nvidia_smi": smi("name,power.limit"),
                "clocks_max_sm_mhz": sm_mhz}]
    print(json.dumps(records[-1]), flush=True)
    t0 = time.time()
    build.load()
    records.append({"build_s": time.time() - t0, "ptxas": chip_smoke.ptxas_of("poseidon")})
    print(json.dumps(records[-1]), flush=True)
    t0 = time.time()
    results = chip_smoke.compare_poseidon("cuda", sm_mhz * 1e6)
    for result in results.values():
        chip_smoke.add_bounds(result, sm_mhz * 1e6)
    records.append({"results": results, "seconds": time.time() - t0})
    print(json.dumps(records[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "poseidon_kernels.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
