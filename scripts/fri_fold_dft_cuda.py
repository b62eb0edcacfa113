#!/usr/bin/env python3
"""FRI's default fold round, `fri_fold_dft` (`stark_tpu_torch/csrc/fri.cu`),
on one NVIDIA GPU, without the rest of `chip_smoke.py`.

    python3 scripts/fri_fold_dft_cuda.py [--out DIR] [--reps 20] [--proves]

Printed, one JSON line each: the card's name and power limit; what
`ptxas -v` said of the kernel (registers, spill bytes, stack); the kernel
against its plain version (`fused_kernels.fri_fold_dft_plain`, the
composed PyTorch fold) at `chip_smoke.fold_dft_cases` (the rounds of a 2^23
prove and BLS12-381's field), bit for bit, with the median device ms of
both beside the bound (`bound_ms`, `bound_by`, `bound_share`); the whole
domain's table read at the round's stride against a contiguous copy of the
round's points (`strided`: rounds 1 and 2, the kernel alone and the copy
with it); and the 9 rounds of a 2^23 fold in a row (`chain`: each round's
column the next round's values, special_x from fixed root words), the
kernel's and the composition's synced host walls and device ms. With
`--proves`, `chip_smoke.phase_big_domain`: `squaring_chain(349525)` at
precision 2^23 cold and warm (9 launches a prove), the same on the
Lagrange route and `squaring_chain(174762)` at 2^22 under Poseidon on both
routes, each pair byte-identical. With `--out` the records also go to
DIR/fri_fold_dft.json. Exits non-zero without a card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ROUNDS = 9  # a 2^23 prove's


def synced_ms(fn, reps: int) -> float:
    """Median host wall of fn() followed by a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def strided_against_copy(spec, device, reps: int) -> dict:
    """Rounds 1 and 2 of a 2^23 fold on the whole table (strides 4, 16)
    against the same rows on a contiguous copy of the round's points."""
    from stark_tpu_torch.protocol import fused_kernels as fk

    rng = np.random.default_rng(cs.SEED + 25)
    xs = cs.random_planes(rng, spec, cs.BIG_PRECISION, device)
    root = torch.zeros(8, dtype=torch.int32, device=device)
    out = {}
    for r in (1, 2):
        stride = 4 ** r
        values = cs.random_planes(rng, spec, cs.BIG_PRECISION // stride, device)
        own = xs[:, ::stride].contiguous()
        if not torch.equal(fk.fri_fold_dft(spec, root, values, xs),
                           fk.fri_fold_dft(spec, root, values, own)):
            raise AssertionError(f"round {r}: the strided read differs from the copy's")
        out[f"round {r} stride {stride}"] = {
            "strided_ms": cs.median_ms(lambda: fk.fri_fold_dft(spec, root, values, xs), reps),
            "copy_ms": cs.median_ms(lambda: fk.fri_fold_dft(spec, root, values, own), reps),
            "copy_and_kernel_ms": cs.median_ms(
                lambda: fk.fri_fold_dft(spec, root, values, xs[:, ::stride].contiguous()),
                reps),
        }
    return out


def chain(spec, device, reps: int) -> dict:
    """The 9 rounds of a 2^23 fold in a row, kernel against composition:
    synced host wall and device ms (events around the whole chain)."""
    from stark_tpu_torch.protocol import fused_kernels as fk

    rng = np.random.default_rng(cs.SEED + 26)
    xs = cs.random_planes(rng, spec, cs.BIG_PRECISION, device)
    values = cs.random_planes(rng, spec, cs.BIG_PRECISION, device)
    root = torch.from_numpy(rng.integers(0, 1 << 32, 8, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(device)

    def run(fold):
        v = values
        for _ in range(ROUNDS):
            v = fold(spec, root, v, xs)
        return v

    got, want = run(fk.fri_fold_dft), run(fk.fri_fold_dft_plain)
    if not torch.equal(got, want):
        raise AssertionError("the 9-round chain differs from the composition's")
    before = fk.fri_fold_dft.launches
    out = {}
    for name, fold in (("kernel", fk.fri_fold_dft), ("plain", fk.fri_fold_dft_plain),
                       ("plain 2", fk.fri_fold_dft_plain), ("kernel 2", fk.fri_fold_dft)):
        out[name] = {"synced_ms": synced_ms(lambda: run(fold), reps),
                     "device_ms": cs.median_ms(lambda: run(fold), reps)}
    out["kernel_launches_a_chain"] = (fk.fri_fold_dft.launches - before) // (4 * reps + 4)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/fri_fold_dft.json")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--proves", action="store_true",
                    help="also prove at 2^23 and 2^22 on both fold routes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fri_fold_dft_cuda: no CUDA device", file=sys.stderr)
        return 1
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls, BN254_FR as spec
    from stark_tpu_torch.protocol import fused_kernels as fk

    device = "cuda"
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.time()
    from stark_tpu_torch.ops import build

    build.load()
    emit({"phase": "build", "seconds": time.time() - t0, "ptxas": cs.ptxas_of("fri_fold_dft")})
    t0 = time.time()
    result = cs.compare("fri_fold_dft", fk.fri_fold_dft, fk.fri_fold_dft_plain,
                        cs.fold_dft_cases(spec, bls, device), reps=(args.reps, 2))
    cs.add_bounds(result, sm_mhz * 1e6)
    emit({"phase": "cases", "seconds": time.time() - t0, **result})
    t0 = time.time()
    strided = strided_against_copy(spec, device, args.reps)
    emit({"phase": "strided", **strided, "seconds": time.time() - t0})
    t0 = time.time()
    emit({"phase": "chain", **chain(spec, device, max(3, args.reps // 4)),
          "seconds": time.time() - t0})
    if args.proves:
        t0 = time.time()
        emit({"phase": "proves", **cs.phase_big_domain(device), "seconds": time.time() - t0})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fri_fold_dft.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
