#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernel library and measure `scan_prod`
(`stark_tpu_torch/csrc/fieldops.cu`) and the prefix products around it on one
NVIDIA GPU, without the rest of `chip_smoke.py`.

    python3 scripts/scan_kernels_cuda.py [--out DIR] [--quick]

Printed, one JSON line each: the card's name, power limit and highest SM
clock; what `ptxas -v` said of the scan kernel; the SASS instructions of one
product, `field.cuh`'s `mont_mul_cc` (PTX carry chains) and `mont_mul` (C),
read with `cuobjdump -sass` from probe kernels compiled beside the library
(their loads, stores and control flow not counted; the PTX product is the
probe's own, the form of `ntt.cu`'s lazy product with one conditional
subtraction), and the device time of one dependent product of each: one
thread walking a chain of 4096 products, less a chain of none, over 4096.
Then `scan_prod` at `chip_smoke.py`'s cases and other shapes, under the
wrapper's team (`field_cuda.scan_team`, first) and every other team size T
(a power of two up to min(B, 256), its block width by the same rule): each
bit-identical to the plain version, with its median device time beside the
plan's model of it (`modmath._scan_us`).
Then (not with `--quick`) `prefix_prod` at 2^8, 2^12, 2^17, 2^18 and 2^20 under
the plan (`modmath.scan_levels`) and under other plans of the same length,
each equal to the plan's values, with its device time (`chip_smoke.py
device_busy_ms`) and median span. Needs `nvcc`, `cuobjdump` and a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

PROBE = r"""
#include "field.cuh"
// The canonical Montgomery product as PTX carry chains (the form of ntt.cu's
// lazy butterfly product plus one conditional subtraction), for a < p and
// any b < 2^256: measured here beside field.cuh's C `mont_mul`.
__device__ __forceinline__ void cc_row(uint32_t (&t)[9], const uint32_t (&a)[8], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b));
  asm("mad.hi.cc.u32 %0, %8, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
      "madc.hi.u32 %7, %15, %16, %7;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b));
}
__device__ __forceinline__ void mont_mul_cc(const stark::Field& f, const uint32_t (&a)[8],
                                            const uint32_t (&b)[8], uint32_t (&r)[8]) {
  uint32_t t[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cc_row(t, a, b[i]);
    const uint32_t m = t[0] * f.np;
    cc_row(t, f.p, m);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  uint32_t d[8], borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
        "=r"(d[6]), "=r"(d[7]), "=r"(borrow)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]),
        "r"(t[7]), "r"(f.p[0]), "r"(f.p[1]), "r"(f.p[2]), "r"(f.p[3]), "r"(f.p[4]),
        "r"(f.p[5]), "r"(f.p[6]), "r"(f.p[7]));
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = borrow ? t[i] : d[i];
}
__device__ void load8(const uint32_t* in, uint32_t (&w)[stark::NW]) {
  for (int i = 0; i < stark::NW; ++i) w[i] = in[i];
}
extern "C" __global__ void sass_probe_cc(const uint32_t* in, uint32_t* out, stark::Field f) {
  uint32_t a[stark::NW], b[stark::NW], r[stark::NW];
  load8(in, a); load8(in + 8, b);
  mont_mul_cc(f, a, b, r);
  for (int i = 0; i < stark::NW; ++i) out[i] = r[i];
}
extern "C" __global__ void sass_probe_cios(const uint32_t* in, uint32_t* out, stark::Field f) {
  uint32_t a[stark::NW], b[stark::NW], r[stark::NW];
  load8(in, a); load8(in + 8, b);
  stark::mont_mul(f, a, b, r);
  for (int i = 0; i < stark::NW; ++i) out[i] = r[i];
}
template <bool CC>
__global__ void chain(const uint32_t* in, uint32_t* out, int k, stark::Field f) {
  uint32_t a[stark::NW], b[stark::NW], r[stark::NW];
  load8(in, a); load8(in + 8, b);
#pragma unroll 1
  for (int i = 0; i < k; ++i) {
    if (CC) mont_mul_cc(f, a, b, r); else stark::mont_mul(f, a, b, r);
    stark::set_elem(a, r);
  }
  for (int i = 0; i < stark::NW; ++i) out[i] = a[i];
}
extern "C" int probe_chain(int cc, const void* in, void* out, int k,
                           const uint32_t* words, uint32_t np, void* stream) {
  stark::Field f = stark::make_field(words, np);
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const uint32_t*>(in);
  auto o = static_cast<uint32_t*>(out);
  if (cc) chain<true><<<1, 1, 0, s>>>(i, o, k, f); else chain<false><<<1, 1, 0, s>>>(i, o, k, f);
  return static_cast<int>(cudaGetLastError());
}
"""
CHAIN = 4096
# chip_smoke.py's scan cases at 43,690 constraints, and the plans' small levels
SHAPES = [(16, 65536), (256, 256), (256, 1), (32, 4096), (16, 256), (8, 32768),
          (128, 256), (64, 16384), (64, 2048), (32, 32768), (16, 8192), (32, 256),
          (16, 16384), (64, 256), (4, 256), (256, 4096), (64, 1)]
# other plans of the same lengths, beside the model's
PLANS = {
    1 << 8: [[(16, 16), (16, 1)], [(64, 4), (4, 1)]],
    1 << 12: [[(64, 64), (64, 1)], [(256, 16), (16, 1)], [(4096, 1)]],
    1 << 17: [[(64, 2048), (64, 32), (32, 1)], [(32, 4096), (16, 256), (256, 1)],
              [(64, 2048), (8, 256), (256, 1)]],
    1 << 18: [[(64, 4096), (64, 64), (64, 1)], [(8, 32768), (128, 256), (256, 1)],
              [(32, 8192), (32, 256), (256, 1)]],
    1 << 20: [[(64, 16384), (64, 256), (64, 4), (4, 1)], [(256, 4096), (256, 16), (16, 1)],
              [(32, 32768), (128, 256), (256, 1)], [(8, 131072), (512, 256), (256, 1)]],
}


def probe_records(spec) -> dict:
    """SASS instructions of one product of each form and the device time of
    one dependent product."""
    from ntt_kernels_cuda import NOT_COUNTED, _tool, sass_opcodes

    from stark_tpu_torch.ops import build, field_cuda as fc

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, so = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.so")
        with open(src, "w") as f:
            f.write(PROBE)
        subprocess.run([_tool("nvcc"), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-I", build.CSRC, "-o", so, src], check=True)
        for kind in ("cc", "cios"):
            ops = sass_opcodes(so, f"sass_probe_{kind}")
            counted = {k: v for k, v in ops.items() if k not in NOT_COUNTED}
            out[f"sass_{kind}"] = {"instructions": sum(counted.values()),
                                   "top": sorted(counted.items(), key=lambda kv: -kv[1])[:6]}
        lib = ctypes.CDLL(so)
        lib.probe_chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
                                    ctypes.c_uint32, ctypes.c_void_p]
        _, _, words, np32 = fc._consts(spec)
        words16 = np.array(fc._words8(spec.r_mod_p) + fc._words8(12345), dtype=np.uint32)
        buf = torch.from_numpy(words16.view(np.int32)).cuda()
        res = torch.empty(8, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for kind, cc in (("cc", 1), ("cios", 0)):
            times = {}
            for k in (0, CHAIN):
                ms = []
                for _ in range(5):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    rc = lib.probe_chain(cc, buf.data_ptr(), res.data_ptr(), k, words, np32,
                                         stream)
                    end.record()
                    end.synchronize()
                    if rc:
                        raise RuntimeError(f"probe_chain returned {rc}")
                    ms.append(start.elapsed_time(end))
                times[k] = sorted(ms)[2]
            out[f"dependent_product_us_{kind}"] = (times[CHAIN] - times[0]) / CHAIN * 1e3
    return out


def teams(B: int, C: int):
    """(T, CB) pairs to time: every team size T, each with the block width
    `field_cuda.scan_team` would give it, and the wrapper's own pair."""
    from stark_tpu_torch.ops import field_cuda as fc

    pairs = [fc.scan_team(B, C)]
    T = 1
    while T <= min(B, fc.SCAN_BLOCK):
        CB = 1
        while 2 * CB * T <= fc.SCAN_BLOCK and CB < 32 and CB < C:
            CB *= 2
        if (T, CB) not in pairs:
            pairs.append((T, CB))
        T *= 2
    return pairs


def team_sweep(spec, rng) -> list[dict]:
    """`scan_prod` at each shape under every team size, against the plain
    version; the first pair of each shape is the wrapper's."""
    import chip_smoke

    from stark_tpu_torch.ops import build, field_cuda as fc
    from stark_tpu_torch.ops import modmath as mm

    lib = build.load()
    words, np32, stream = fc.cuda_args(spec, torch.empty(1, device="cuda"))
    out = []
    for B, C in SHAPES:
        x = chip_smoke.with_edges(
            spec, chip_smoke.random_planes(rng, spec, B * C, "cuda").reshape(16, B, C))
        want = fc.scan_prod_plain(spec, x)
        row = {"shape": [16, B, C], "wrapper": list(fc.scan_team(B, C)),
               "bytes_bound_ms": 128 * B * C / chip_smoke.BYTES_PER_S * 1e3,
               "model_ms": mm._scan_us(B, C) / 1e3,
               "ms": {}}
        for T, CB in teams(B, C):
            got = torch.empty_like(x)

            def run():
                build.check(lib.stark_scan_prod(x.data_ptr(), got.data_ptr(), B, C, T, CB,
                                                words, np32, stream), "scan_prod")

            run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"scan_prod (16,{B},{C}) T={T} CB={CB}: kernel != plain")
            row["ms"][f"T={T} CB={CB}"] = chip_smoke.median_ms(run, 10)
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def plan_sweep(spec, rng) -> list[dict]:
    """`prefix_prod` under the model's plan and under others."""
    import chip_smoke

    from stark_tpu_torch.ops import modmath as mm

    model = mm.scan_levels
    out = []
    try:
        for n, others in PLANS.items():
            v = chip_smoke.with_edges(spec, chip_smoke.random_planes(rng, spec, n, "cuda"))
            mm.scan_levels = model
            want = mm.prefix_prod(spec, v)
            for levels in [model(n)] + others:
                table = {B * C: levels[i:] for i, (B, C) in enumerate(levels)}
                mm.scan_levels = lambda m, table=table: list(table[m])
                fn = lambda: mm.prefix_prod(spec, v)  # noqa: E731
                if not torch.equal(fn(), want):
                    raise AssertionError(f"prefix_prod n={n} plan {levels} differs")
                out.append({"n": n, "levels": levels, "model": levels == model(n),
                            "model_us": sum(mm._level_us(B, C) for B, C in levels),
                            "device_ms": chip_smoke.device_busy_ms(fn),
                            "ms": chip_smoke.median_ms(fn, 10)})
                print(json.dumps(out[-1]), flush=True)
    finally:
        mm.scan_levels = model
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/scan_kernels.json")
    ap.add_argument("--quick", action="store_true", help="leave out the plan sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_kernels_cuda: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    so = build.library_path()
    build.load()
    with open(os.path.join(os.path.dirname(so), "build.log")) as f:
        log = f.read().splitlines()
    # `ptxas -v` prints an entry's name, then its stack and registers
    ptxas = [" ".join(x.strip() for x in log[i : i + 4]) for i, ln in enumerate(log)
             if "Compiling entry" in ln and "scan_prod" in ln]
    records = [{"nvidia_smi": smi, "build_s": time.time() - t0, "ptxas": ptxas}]
    print(json.dumps(records[-1]), flush=True)
    records.append(probe_records(spec))
    print(json.dumps(records[-1]), flush=True)
    rng = np.random.default_rng(chip_smoke.SEED + 4)
    records.append({"team_sweep": team_sweep(spec, rng)})
    if not args.quick:
        records.append({"plan_sweep": plan_sweep(spec, rng)})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "scan_kernels.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
