#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernel library and hold `butterfly_fused`
(`stark_tpu_torch/csrc/ntt.cu`) against its plain PyTorch version on one
NVIDIA GPU, with the instruction floor of its butterflies, without the rest
of `chip_smoke.py`.

    python3 scripts/ntt_kernels_cuda.py [--out DIR] [--library PATH ...]

Printed: the card's name, power limit and highest SM clock; what `ptxas -v`
said of the NTT kernels; the SASS instructions of one butterfly of each
direction, read with `cuobjdump -sass` from a probe kernel that runs one
`fused_butterfly` on loaded operands (compiled beside the library from
`csrc/ntt.cu`; the probe's loads, stores and control flow are not counted),
of the canonical build's (`*_canonical`, the fields without 5p < 2^256),
and of `butterfly_stage`'s dit butterfly (`stage`, field.cuh's product,
which the first version of the fused pass ran too); the SASS instructions
of every `butterfly_fused` kernel of the library, and of any other build
named with `--library PATH` (a parent commit's, to show that a build's
code did not change);
then `chip_smoke.compare_fused`'s cases (dit and dif at 2^20, dif at 2^17
on BN254's scalar field; dit and dif at 2^17 and at one block on
BLS12-381's; all bit-identical to the plain version) with each one's median
device time, bounds and instruction floor: instructions of one butterfly x
the butterflies of the pass / (128 x the SMs x the highest SM clock), an SM
issuing at most one warp instruction of 32 lanes a clock on each of its
four schedulers. Both branches of a butterfly (the product by a twiddle
equal to Montgomery one is skipped) are in the static count.
Needs `nvcc`, `cuobjdump` and a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE = r"""
#include "ntt.cu"
template <bool DIT, bool LAZY>
__device__ void probe(const uint32_t* in, uint32_t* out, const stark::Field& f) {
  uint32_t u[stark::NW], v[stark::NW], w[stark::NW], p2[stark::NW];
  for (int i = 0; i < stark::NW; ++i) {
    u[i] = in[i]; v[i] = in[8 + i]; w[i] = in[16 + i]; p2[i] = in[24 + i];
  }
  fused_butterfly<DIT, LAZY>(f, p2, u, v, w);
  for (int i = 0; i < stark::NW; ++i) { out[i] = u[i]; out[8 + i] = v[i]; }
}
extern "C" __global__ void sass_probe_dit(const uint32_t* in, uint32_t* out, stark::Field f) {
  probe<true, true>(in, out, f);
}
extern "C" __global__ void sass_probe_dif(const uint32_t* in, uint32_t* out, stark::Field f) {
  probe<false, true>(in, out, f);
}
// the canonical build's butterflies (fields without 5p < 2^256)
extern "C" __global__ void sass_probe_dit_canonical(const uint32_t* in, uint32_t* out,
                                                    stark::Field f) {
  probe<true, false>(in, out, f);
}
extern "C" __global__ void sass_probe_dif_canonical(const uint32_t* in, uint32_t* out,
                                                    stark::Field f) {
  probe<false, false>(in, out, f);
}
// butterfly_stage's butterfly (field.cuh's CIOS, canonical at every step),
// which the first version of the fused pass also ran
extern "C" __global__ void sass_probe_stage(const uint32_t* in, uint32_t* out, stark::Field f) {
  uint32_t u[stark::NW], v[stark::NW], w[stark::NW], y0[stark::NW], y1[stark::NW];
  for (int i = 0; i < stark::NW; ++i) {
    u[i] = in[i]; v[i] = in[8 + i]; w[i] = in[16 + i];
  }
  butterfly<true>(f, u, v, w, y0, y1);
  for (int i = 0; i < stark::NW; ++i) { out[i] = y0[i]; out[8 + i] = y1[i]; }
}
"""
# opcodes of the probe's own loads, stores and control flow
NOT_COUNTED = ("LDG", "STG", "LDC", "ULDC", "EXIT", "BRA", "NOP", "S2R", "S2UR",
               "BSSY", "BSYNC", "RET")
ISSUE_PER_CLOCK = 128  # thread instructions an SM issues a clock: 4 schedulers x 32 lanes


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found")
    return path


def sass_opcodes(cubin: str, fun: str) -> collections.Counter:
    """Opcode counts of one function's SASS, as `cuobjdump -sass` lists it."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", "-fun", fun, cubin],
                          capture_output=True, text=True, check=True).stdout
    ops = collections.Counter()
    for ln in text.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)
        if m:
            ops[m.group(1).split(".")[0]] += 1
    return ops


def butterfly_instructions() -> dict:
    """SASS instructions of one fused butterfly of each direction."""
    from stark_tpu_torch.ops import build

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.cubin")
        with open(src, "w") as f:
            f.write(PROBE)
        subprocess.run([_tool("nvcc"), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin",
                        "-I", build.CSRC, "-o", cubin, src], check=True)
        for kind in ("dit", "dif", "dit_canonical", "dif_canonical", "stage"):
            ops = sass_opcodes(cubin, f"sass_probe_{kind}")
            counted = {k: v for k, v in ops.items() if k not in NOT_COUNTED}
            out[kind] = {"instructions": sum(counted.values()),
                         "all_static": sum(ops.values()),
                         "top": collections.Counter(counted).most_common(8)}
    return out


def kernel_instructions(library: str, pattern: str = "butterfly_fused") -> dict:
    """SASS instructions of each kernel of a built library whose (mangled)
    name holds `pattern`, as `cuobjdump -sass` lists them, all opcodes
    counted: the same count for two builds means the same code."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1) if pattern in m.group(1) else None
            if name:
                out[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", ln):
            out[name] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/ntt_kernels.json")
    ap.add_argument("--library", action="append", default=[],
                    help="also count the SASS of this library's butterfly_fused kernels "
                         "(another build, such as a parent commit's); repeatable")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ntt_kernels_cuda: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import build, ntt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sm_hz = float(smi.split(",")[2].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.time()
    so = build.library_path()
    build.load()
    with open(os.path.join(os.path.dirname(so), "build.log")) as f:
        log = f.read().splitlines()
    # `ptxas -v` prints an entry's name, then its stack and registers
    ptxas = [" ".join(x.strip() for x in log[i : i + 4]) for i, ln in enumerate(log)
             if "Compiling entry" in ln and "butterfly_" in ln]
    records = [{"build_s": time.time() - t0, "ptxas": ptxas}]
    print(json.dumps(records[-1]), flush=True)
    instr = butterfly_instructions()
    sass = {lib: kernel_instructions(lib) for lib in [so] + args.library}
    records.append({"sass_per_butterfly": instr, "sass_per_kernel": sass, "sms": sms,
                    "sm_hz": sm_hz})
    print(json.dumps(records[-1]), flush=True)

    steps, precision = 1 << 17, 1 << 20
    rng = np.random.default_rng(chip_smoke.SEED)
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    big = ntt.NttPlan(spec, g2, precision, "dit", "cuda")
    small = ntt.NttPlan(spec, spec.inv(g1), steps, "dif", "cuda")
    x_big = chip_smoke.random_planes(rng, spec, precision, "cuda")
    x_small = chip_smoke.random_planes(rng, spec, steps, "cuda")
    result = chip_smoke.compare_fused(spec, big, small, x_big, x_small)
    chip_smoke.add_bounds(result, sm_hz)
    for label, case in result["cases"].items():
        # "[bls12_381 ]dit n=... block=...": BLS12-381's cases run the canonical build
        *field, kind, n, block = label.split()
        n, block = int(n[2:]), int(block[6:])
        build_kind = f"{kind}_canonical" if field else kind
        butterflies = (block.bit_length() - 1) * n // 2
        case["floor_ms"] = (instr[build_kind]["instructions"] * butterflies
                            / (ISSUE_PER_CLOCK * sms * sm_hz) * 1e3)
        records.append({"kernel": "butterfly_fused", "case": label, **case})
        print(json.dumps(records[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ntt_kernels.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
