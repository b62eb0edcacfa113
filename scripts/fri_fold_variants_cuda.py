#!/usr/bin/env python3
"""Time the launch-bound variants of the PyTorch/CUDA port's two FRI fold
kernels (`stark_tpu_torch/csrc/fri.cu`) on one NVIDIA GPU.

    python3 scripts/fri_fold_variants_cuda.py [--out DIR] [--log-q 18] [--reps 20]

`fri_fold_pre` and `fri_fold_post` are bound by occupancy: how many registers
a thread may take decides how many warps an SM holds while they wait on
memory. The source takes its block size and its `__launch_bounds__` from two
macros, `FRI_THREADS` and `FRI_MIN_BLOCKS` (0: no bound). This script builds
`fri.cu` alone once per variant (one `nvcc` each, all started together),
reads registers and spill bytes from `ptxas -v`, holds every variant's
output against the packaged library's with `torch.equal`, and prints the
median device time of each kernel at q = 2^log_q, in two passes over the
variants (forward, then backward) so the spread between passes shows.
One JSON line per variant, then a table; the card's name and power limit
first. Needs `nvcc` and a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (threads a block, least blocks an SM; 0 leaves the registers unbounded)
VARIANTS = [(128, 0), (128, 3), (128, 4), (128, 5), (128, 6), (128, 8),
            (64, 0), (64, 8), (256, 0), (256, 2)]
SEED = 20261016


def build_variants(out_dir: str) -> dict:
    """{variant: (library path, {kernel: (registers, spill store bytes)})}"""
    from stark_tpu_torch.ops import build

    nvcc = build._nvcc()
    src = os.path.join(build.CSRC, "fri.cu")
    procs = {}
    for threads, blocks in VARIANTS:
        so = os.path.join(out_dir, f"fri_{threads}_{blocks}.so")
        cmd = [nvcc, *build.NVCC_FLAGS, f"-DFRI_THREADS={threads}",
               f"-DFRI_MIN_BLOCKS={blocks}", "-shared", "-o", so, src]
        procs[threads, blocks] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for variant, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        built[variant] = (so, ptxas_usage(log))
    return built


def ptxas_usage(log: str) -> dict:
    """Registers and spill-store bytes of each entry function in a `ptxas -v`
    log, keyed by `pre` / `post`."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = "pre" if "fri_fold_pre" in m.group(1) else "post"
            usage[name] = [None, None]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and usage[name][1] is None:
            usage[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and usage[name][0] is None:
            usage[name][0] = int(m.group(1))
    return usage


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records to DIR/fri_fold_variants.json")
    ap.add_argument("--log-q", type=int, default=18)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import build
    from stark_tpu_torch.ops import field_cuda as fc
    from stark_tpu_torch.ops import modmath as mm
    from stark_tpu_torch.protocol import fused_kernels as fk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda")
    q = 1 << args.log_q
    rng = np.random.default_rng(SEED)
    xs4, ys4 = (chip_smoke.random_planes(rng, spec, 4 * q, device).reshape(16, 4, q)
                for _ in range(2))
    sx = chip_smoke.random_planes(rng, spec, 1, device)
    eqs, dens = fk.fri_fold_pre(spec, xs4)
    invs = mm.multi_inv(spec, dens.reshape(16, 4 * q)).reshape(16, 4, q)
    folded = fk.fri_fold_post(spec, sx, eqs, ys4, invs)
    words, np32, stream = fc.cuda_args(spec, xs4)

    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        built = build_variants(tmp)
        libs = {}
        for variant, (so, usage) in built.items():
            lib = ctypes.CDLL(so)
            for name in ("stark_fri_fold_pre", "stark_fri_fold_post"):
                getattr(lib, name).argtypes = build._SIGNATURES[name]
                getattr(lib, name).restype = ctypes.c_int
            libs[variant] = lib
            records[variant] = {"threads": variant[0], "min_blocks": variant[1],
                                "pre_regs": usage["pre"][0], "pre_spill": usage["pre"][1],
                                "post_regs": usage["post"][0], "post_spill": usage["post"][1],
                                "pre_ms": [], "post_ms": []}
        e2, d2, o2 = torch.empty_like(eqs), torch.empty_like(dens), torch.empty_like(folded)

        def run_pre(lib):
            build.check(lib.stark_fri_fold_pre(xs4.data_ptr(), e2.data_ptr(), d2.data_ptr(),
                                               q, words, np32, stream), "fri_fold_pre")

        def run_post(lib):
            build.check(lib.stark_fri_fold_post(sx.data_ptr(), eqs.data_ptr(), ys4.data_ptr(),
                                                invs.data_ptr(), o2.data_ptr(), q, words,
                                                np32, stream), "fri_fold_post")

        for order in (VARIANTS, VARIANTS[::-1]):
            for variant in order:
                lib = libs[variant]
                e2.zero_(), d2.zero_(), o2.zero_()
                run_pre(lib), run_post(lib)
                torch.cuda.synchronize()
                if not (torch.equal(e2, eqs) and torch.equal(d2, dens)
                        and torch.equal(o2, folded)):
                    raise AssertionError(f"variant {variant} differs from the packaged kernels")
                rec = records[variant]
                rec["pre_ms"].append(chip_smoke.median_ms(lambda: run_pre(lib), args.reps))
                rec["post_ms"].append(chip_smoke.median_ms(lambda: run_post(lib), args.reps))
        del libs

    for rec in records.values():
        print(json.dumps(rec), flush=True)
    print(f"q = {q}; median ms of {args.reps}, forward pass / backward pass")
    print("| threads | min blocks | pre regs (spill B) | pre ms | post regs (spill B) | post ms |")
    print("|---|---|---|---|---|---|")
    for r in records.values():
        print(f"| {r['threads']} | {r['min_blocks'] or 'none'} "
              f"| {r['pre_regs']} ({r['pre_spill']}) | {r['pre_ms'][0]:.4f} / {r['pre_ms'][1]:.4f} "
              f"| {r['post_regs']} ({r['post_spill']}) "
              f"| {r['post_ms'][0]:.4f} / {r['post_ms'][1]:.4f} |")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fri_fold_variants.json"), "w") as f:
            json.dump({"card": card, "q": q, "reps": args.reps,
                       "variants": list(records.values())}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
