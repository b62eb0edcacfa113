"""Command-line interface of the port.

    python -m stark_tpu_torch.cli run c.r1cs w.wtns proof.json --device cuda

`prove`, `verify` and `run` (prove then verify) mirror `stark_tpu.cli`;
the bare 3-argument form means `run`, like the reference's binary.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in ("prove", "verify", "run", "-h", "--help"):
        argv = ["run"] + argv  # bare 3-arg form
    parser = argparse.ArgumentParser(prog="stark-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("prove", "verify", "run"):
        sp = sub.add_parser(name)
        sp.add_argument("r1cs")
        sp.add_argument("wtns")
        sp.add_argument("proof_json")
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default; needs a card) or cpu")
    args = parser.parse_args(argv)

    from stark_tpu_torch.protocol import runner

    t0 = time.time()
    if args.cmd == "prove":
        runner.prove_with_file_path(args.r1cs, args.wtns, args.proof_json,
                                    device=args.device)
    elif args.cmd == "verify":
        runner.verify_with_file_path(args.r1cs, args.wtns, args.proof_json,
                                     device=args.device)
        print("Done proof verification")
    else:
        runner.run_with_file_path(args.r1cs, args.wtns, args.proof_json,
                                  device=args.device)
        print("Done proof verification")
    print(f"{args.cmd}: {time.time() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
