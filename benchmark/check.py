"""Whether the timed path's outputs are right: the plain reference
(`benchmark/ref/`) proves each sampled witness anew from the circuit's file
and the witness rows, and every output of that witness from the timed path
(the proof's JSON text) must equal its proof to the byte.

It runs after the window, once the program's state is freed, on the card
the run used. The numbers compared: `mismatched_proofs` (limit 0: an exact
comparison), `failed_calls` (limit 0, set by the harness), and `compared`
(at least 1: a run that compared nothing proved nothing)."""

from __future__ import annotations

import sys
import time


def compare(r1cs_path, pool, sampled, outputs, config, device, lazy: bool = False) -> dict:
    from benchmark.ref import r1cs as rr
    from benchmark.ref.prover import Prover

    t0 = time.perf_counter()
    with open(r1cs_path, "rb") as f:
        prover = Prover(rr.read_r1cs(f.read()), device, config["digest"], lazy=lazy)
    mismatched = compared = 0
    for j in sampled:
        texts = outputs.get(j, [])
        if not texts:
            continue
        ref = prover.prove(pool[j])
        print("reference stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                  prover.seconds.items()), file=sys.stderr)
        for text in texts:
            compared += 1
            mismatched += text != ref
    print(f"reference: {compared} output(s) of {len(sampled)} sampled witness(es) compared "
          f"in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return {"mismatched_proofs": {"value": mismatched, "limit": 0},
            "compared": {"value": compared, "limit": 1}}
