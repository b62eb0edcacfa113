"""Command-line interface of the port.

    python -m stark_tpu_torch.cli run c.r1cs w.wtns proof.json --device cuda
    python -m stark_tpu_torch.cli serve --device cuda --fri-fold lagrange
    python -m stark_tpu_torch.cli prove c.r1cs w.wtns proof.json --lde-engine crt
    python -m stark_tpu_torch.cli warmup c.r1cs --device cuda --lde-engine crt

`prove`, `verify`, `run` (prove then verify), `serve` (the long-lived
proving worker, line-delimited JSON-RPC on stdio: `stark_tpu_torch/serve.py`)
and `warmup` mirror `stark_tpu.cli`; the bare 3-argument form means `run`,
like the reference's binary. The files are read on the runner's native
route (the C++ readers of the host library, built with g++ at first use)
where that library builds. `warmup` fills what a later process finds on
disk, so that its first prove starts at once: the CUDA kernel library (on
a card), the host library and, on the crt engine, the residue tables
(`ops/mxu_ntt.py CACHE_DIR`). It reads the circuit and runs the worker's
warmup (`serve._warmup`: the stage set for the circuit's size) and prints
`warmed N stages (steps=S)`. `--fri-fold` names FRI's fold route for the proving
commands; `--lde-engine` names the engine of the low-degree extensions
(the butterfly NTT, or the CRT matrix-product engine of `ops/mxu_ntt.py`) for
every command. The proof is the same on either of each. `--digest` names
the tree digest of `prove`, `verify` and `run` (the worker takes it per
request): blake2s, or poseidon for the l-tree and FRI's trees.
"""

from __future__ import annotations

import argparse
import sys
import time

_COMMANDS = ("prove", "verify", "run", "serve", "warmup")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in _COMMANDS + ("-h", "--help"):
        argv = ["run"] + argv  # bare 3-arg form
    parser = argparse.ArgumentParser(prog="stark-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in _COMMANDS:
        sp = sub.add_parser(name)
        if name != "serve":
            sp.add_argument("r1cs")
        if name not in ("serve", "warmup"):
            sp.add_argument("wtns")
            sp.add_argument("proof_json")
            sp.add_argument("--digest", choices=("blake2s", "poseidon"), default="blake2s",
                            help="tree digest (the reference's H: Digest): poseidon "
                            "commits the l-tree and FRI's trees")
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default; needs a card) or cpu")
        if name not in ("verify", "warmup"):
            sp.add_argument("--fri-fold", choices=("dft", "lagrange"), default="dft",
                            help="FRI's fold route: the radix-4 inverse DFT (the "
                            "default) or the Lagrange fold kernels")
        sp.add_argument("--lde-engine", choices=("butterfly", "crt"), default="butterfly",
                        help="the engine of the low-degree extensions: the butterfly "
                        "NTT (the default) or the CRT matrix-product engine")
    args = parser.parse_args(argv)

    if args.cmd == "serve":
        from stark_tpu_torch.serve import serve

        return serve(device=args.device, fri_fold=args.fri_fold,
                     lde_engine=args.lde_engine)

    from stark_tpu_torch.protocol import runner

    t0 = time.time()
    if args.cmd == "warmup":
        from stark_tpu_torch import device as devmod
        from stark_tpu_torch.serve import _warmup

        warmed = _warmup(runner.read_circuit(args.r1cs), devmod.resolve(args.device),
                         args.lde_engine)
        print(f"warmed {warmed['warmed']} stages (steps={warmed['steps']})")
    elif args.cmd == "prove":
        runner.prove_with_file_path(args.r1cs, args.wtns, args.proof_json,
                                    digest=args.digest, device=args.device,
                                    fri_fold=args.fri_fold, lde_engine=args.lde_engine)
    elif args.cmd == "verify":
        runner.verify_with_file_path(args.r1cs, args.wtns, args.proof_json,
                                     digest=args.digest, device=args.device,
                                     lde_engine=args.lde_engine)
        print("Done proof verification")
    else:
        runner.run_with_file_path(args.r1cs, args.wtns, args.proof_json,
                                  digest=args.digest, device=args.device,
                                  fri_fold=args.fri_fold, lde_engine=args.lde_engine)
        print("Done proof verification")
    print(f"{args.cmd}: {time.time() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
