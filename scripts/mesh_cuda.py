#!/usr/bin/env python3
"""Prove the largest `squaring_chain` of a precision on a mesh of d ranks
sharing one NVIDIA GPU, with the PyTorch/CUDA port, and record each rank's
peak device memory against the single-device prove's:

    python3 scripts/mesh_cuda.py [--log-precision 23] [--ranks 4] [--out DIR]

`--log-precision` k (20-23) sets the domain (steps 2^(k-3), the circuit of
floor(2^(k-3) / 3) constraints: 349,525 at 2^23, the protocol's largest);
`--ranks` d (2 or 4) the mesh. The ranks are OS processes
(`parallel/distributed.py run_ranks`) over gloo, each collective staged
through pinned host buffers: d ranks on one card cannot take NCCL, which
needs a card a rank. So the walls measure that transport, not a multi-card
scaling. Each rank proves cold and warm (`chip_smoke.mesh_rank`: wall, the
rank's `torch.cuda.max_memory_allocated`, the collectives' calls, bytes and
synced seconds, launches of the cold prove); then this process proves the
same circuit on one device (cold and warm, with its peak) and verifies rank
0's proof, and every rank's proofs must equal the single-device proof.
Prints one JSON line a record, a summary last; `--out DIR` also writes them
to DIR/mesh_<k>_d<d>.json. Exits 1 without a card or where a proof differs
or is rejected. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-precision", type=int, default=23, choices=range(20, 24))
    ap.add_argument("--ranks", type=int, default=4, choices=(2, 4))
    ap.add_argument("--out", help="also write the records to DIR/mesh_<k>_d<d>.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_cuda: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from stark_tpu_torch.parallel import distributed
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner
    from stark_tpu_torch.r1cs.synth import squaring_chain

    n = (1 << args.log_precision) // 8 // 3
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi("name,power.limit"),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "log_precision": args.log_precision, "constraints": n, "ranks": args.ranks})
    t0 = time.time()
    ranks = distributed.run_ranks(chip_smoke.mesh_rank, args.ranks, device="cuda",
                                  backend="gloo", timeout=chip_smoke.MESH_TIMEOUT_S,
                                  args=(n, ()))
    proof_text = ranks[0].pop("proof")
    for rank in ranks:
        emit({"phase": "rank", **rank})
    emit({"phase": "mesh", "seconds": time.time() - t0})

    r1cs, witness = squaring_chain(n)
    single = {}
    for phase in ("single_cold", "single_warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        proof = runner.prove_with_witness(r1cs, witness, device="cuda")
        single[phase] = {"wall_s": time.time() - t0,
                         "peak_bytes": torch.cuda.max_memory_allocated()}
        emit({"phase": phase, **single[phase]})
    sha = hashlib.sha256(proof_mod.to_json(proof).encode()).hexdigest()
    equal = all(rank[key]["proof_sha256"] == sha for rank in ranks for key in ("cold", "warm"))
    accepted = runner.verify_with_witness(r1cs, witness[:2], proof_mod.from_json(proof_text),
                                          device="cuda", verify_cache=False)
    summary = {
        "log_precision": args.log_precision, "constraints": n, "ranks": args.ranks,
        "proof_sha256": sha, "proofs_equal": equal, "rank0_verified": bool(accepted),
        "rank_peak_bytes": [rank["cold"]["peak_bytes"] for rank in ranks],
        "single_peak_bytes": single["single_cold"]["peak_bytes"],
        "rank_warm_s": [rank["warm"]["wall_s"] for rank in ranks],
        "single_warm_s": single["single_warm"]["wall_s"],
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"mesh_{args.log_precision}_d{args.ranks}.json")
        with open(path, "w") as f:
            json.dump({"records": RECORDS, "summary": summary}, f, indent=1)
    print(json.dumps(summary))
    return 0 if equal and accepted else 1


if __name__ == "__main__":
    sys.exit(main())
