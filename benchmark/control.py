"""The control of the comparison that decides `correct`, and its readings.

The control is the plain reference put in the program's place, with its
committed values left in [0, 2p) where they fit in 32 bytes
(`Prover(..., lazy=True)`): the step below exact residues that a lazily
reducing kernel would tempt a change to take. For each seed the pool and
the sampled witness are drawn as a run draws them; the reference proves
the sampled witness, the control proves it too, and `mismatched_proofs`
counts the control's outputs that differ from the reference's, as many as
a run compares (`--outputs`). The program is not run. The benchmark's own
runs never run this.

    python3 benchmark/control.py --workload NAME --seeds N [N ...] [--outputs K]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(cell, seeds, outputs: int, device) -> list[dict]:
    from benchmark import check, harness
    from benchmark.ref import r1cs as rr
    from benchmark.ref.prover import Prover

    r1cs_path = harness.circuit_file(cell.config)
    rows = []
    for seed in seeds:
        pool = harness.witness_pool(cell.config, cell.traffic, seed)
        sampled = harness.sampled_witnesses(seed, cell.traffic)
        t0 = time.perf_counter()
        with open(r1cs_path, "rb") as f:
            lazy = Prover(rr.read_r1cs(f.read()), device, cell.config["digest"], lazy=True)
        control = {j: [lazy.prove(pool[j])] * outputs for j in sampled}
        numbers = check.compare(r1cs_path, pool, sampled, control, cell.config, device)
        rows.append({"seed": seed, "mismatched_proofs": numbers["mismatched_proofs"]["value"],
                     "compared": numbers["compared"]["value"],
                     "seconds": time.perf_counter() - t0})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--outputs", type=int, default=12)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload)
    for row in readings(cell, args.seeds, args.outputs, torch.device("cuda")):
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
