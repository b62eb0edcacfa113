#!/usr/bin/env python3
"""Hold `mmul` (`stark_tpu_torch/csrc/mmul.cu`) against its plain version at
(16, 2^20) on BN254 again and again on one NVIDIA GPU: the inputs that
`chip_smoke.py`'s kernels phase draws (its seed) and those of SEEDS fresh
seeds, the kernel ROUNDS times an input and the plain version twice. A
mismatch is printed word by word beside the value python ints give for
that element, so that it says which side was wrong. With `--other-csrc
DIR` (another tree's `stark_tpu_torch/csrc`), each tree's `mmul.cu` is
compiled against its own headers and the machine code of the two
`mmul_kernel`s compared: whether a change to a header changed the kernel.
The card's ECC mode and error counters are read before and after.

    python3 scripts/mmul_repeat_cuda.py [--other-csrc DIR]

Prints one JSON line a record; exits 1 on any mismatch or where the two
kernels' machine code differs. Needs a CUDA card (and `nvcc` and
`cuobjdump` for `--other-csrc`); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

N = 1 << 20
SEEDS = 20  # fresh seeds after chip_smoke's
ROUNDS = 100  # kernel launches an input
ECC = ("ecc.mode.current,ecc.errors.corrected.volatile.total,"
       "ecc.errors.uncorrected.volatile.total,ecc.errors.corrected.aggregate.total,"
       "ecc.errors.uncorrected.aggregate.total")


def smi(query: str) -> str:
    done = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True)
    return (done.stdout or done.stderr).strip()


def mismatches(spec, a, b, got, want, limit: int = 8) -> list:
    """The first `limit` differing elements: both sides' limbs, their xor,
    and which side equals a*b*R^-1 mod p on python ints."""
    cols = (got != want).any(dim=0).nonzero().flatten()[:limit].tolist()
    rinv = pow(1 << 16 * spec.num_limbs, -1, spec.p)
    out = []
    for j in cols:
        limbs = [t[:, j].tolist() for t in (a, b, got, want)]
        va, vb, vg, vw = (sum(v << 16 * i for i, v in enumerate(x)) for x in limbs)
        truth = va * vb * rinv % spec.p
        out.append({"column": j, "kernel": limbs[2], "plain": limbs[3],
                    "xor": [g ^ w for g, w in zip(limbs[2], limbs[3])],
                    "kernel_right": vg == truth, "plain_right": vw == truth})
    return out


def kernel_code(csrc: str, tmp: str, tag: str) -> list:
    """`mmul_kernel`'s instructions and encodings as `cuobjdump -sass` lists
    them, addresses dropped, from `csrc/mmul.cu` built as the library is."""
    from stark_tpu_torch.ops import build

    tool = lambda name: shutil.which(name) or f"/usr/local/cuda/bin/{name}"  # noqa: E731
    cubin = os.path.join(tmp, f"mmul_{tag}.cubin")
    subprocess.run([tool("nvcc"), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin", "-I", csrc,
                    "-o", cubin, os.path.join(csrc, "mmul.cu")],
                   check=True, capture_output=True, text=True)
    text = subprocess.run([tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    code, inside = [], False
    for ln in text.splitlines():
        if "Function :" in ln:
            inside = "mmul_kernel" in ln
        elif inside:
            code += re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", ln)
            code += re.findall(r"/\* (0x[0-9a-f]{16}) \*/", ln)
    if not code:
        raise RuntimeError(f"no mmul_kernel in {cubin}")
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other-csrc", help="another tree's csrc: compare the kernels' code")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mmul_repeat_cuda: no CUDA device", file=sys.stderr)
        return 1
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import build
    from stark_tpu_torch.ops import field_cuda as fc

    def emit(rec: dict) -> None:
        print(json.dumps(rec), flush=True)

    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi("name,power.limit"),
          "ecc_before": smi(ECC)})
    failed = False
    if args.other_csrc:
        with tempfile.TemporaryDirectory() as tmp:
            here, other = kernel_code(build.CSRC, tmp, "here"), kernel_code(args.other_csrc,
                                                                             tmp, "other")
        failed |= here != other
        emit({"mmul_kernel_code": {"instructions_here": len(here),
                                   "instructions_other": len(other), "equal": here == other}})
    build.load()
    dev = torch.device("cuda")
    for seed in [chip_smoke.SEED] + [chip_smoke.SEED + 1000 + k for k in range(SEEDS)]:
        rng = np.random.default_rng(seed)
        a, b = (chip_smoke.random_planes(rng, spec, N, dev) for _ in range(2))
        got = fc.mmul(spec, a, b)  # chip_smoke's order: the kernel, then the plain version
        want = fc.mmul_plain(spec, a, b)
        bad = {"kernel": 0, "plain": 0}
        report = []
        if not torch.equal(fc.mmul_plain(spec, a, b), want):
            bad["plain"] += 1
        for r in range(ROUNDS):
            if r:
                got = fc.mmul(spec, a, b)
            if not torch.equal(got, want):
                bad["kernel"] += 1
                if len(report) < 2:
                    report.append(mismatches(spec, a.cpu(), b.cpu(), got.cpu(), want.cpu()))
        torch.cuda.synchronize()
        failed |= any(bad.values())
        emit({"seed": seed, "kernel_launches": ROUNDS, "kernel_mismatches": bad["kernel"],
              "plain_runs": 2, "plain_mismatches": bad["plain"], "first_mismatches": report})
    emit({"ecc_after": smi(ECC), "ok": not failed})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
