#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernel library and check the Poseidon tree
kernels (`stark_tpu_torch/csrc/poseidon.cu`: `poseidon_leaves`,
`poseidon_pairs`, each in its two forms) on one NVIDIA GPU, without the rest
of `chip_smoke.py`.

    python3 scripts/poseidon_kernels_cuda.py [--out DIR] [--quick] [--probe]

Printed, one JSON line each: the card's name, power limit and highest SM
clock; the build's seconds and what `ptxas -v` said of the kernel's four
builds (registers, stack, spills). With `--quick`, only each form of both
entry points at 1, 3, 33 and 2^10 hashes against the plain versions
(`torch.equal`): the quick check after a change to `csrc/poseidon.cu`.
Otherwise then `chip_smoke.compare_poseidon`'s cases, each held to its
plain version (the l-tree's 2^20 leaves, a fold level of 2^19 pairs, 2^17,
1, 3, 33, 2^10, 2^13 hashes and both sides of `poseidon.LANE_FORM_BELOW`),
with the median device time, the plain version's time, the operations
bound and its share, and the levels of a 2^20 tree timed alone (`levels`,
with the narrow levels' latency model, `tree_ms`). Then `PARENT`, the
kernel before its redesign (a thread a hash, the textbook rounds, its
table in constant memory), built into a probe library and timed in turns
with the library's kernel (parent, new, new, parent) at 2^20 leaves and
each level width of a 2^20 tree, every output equal to the library's; and
each form of both entry points at widths 2^0 to 2^17 (`forms`), launched
through the C entry point with the form given, each equal to the other
form: the times that set `LANE_FORM_BELOW`. With `--probe` also the SASS
opcode counts of the library's four builds and the library's thread form
under other launch bounds (`OCCUPANCY`), each build compiled on its own and
timed in turns with the library's at 2^20 leaves, 2^19 and 2^16 pairs,
every output equal to the library's. Two to four minutes of command. Needs
`nvcc` and a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
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

import chip_smoke  # noqa: E402

# `csrc/poseidon.cu` before its redesign: one thread a hash, the 63 textbook
# rounds (807 CIOS products and 567 modular additions a pair), its table (the
# 189 round constants, the MDS matrix, R^2 and the tag, all but R^2 in
# Montgomery form) copied into constant memory ahead of each launch.
PARENT = r"""
#include "field.cuh"

namespace {

using stark::Field;
using stark::NW;

constexpr int T = 3, FULL = 8, PARTIAL = 55, ROUNDS = FULL + PARTIAL;
// table entries (8 words each): the round constants in consumption order,
// the MDS matrix row by row (M[i][j] at MDS0 + 3i + j), R^2 mod p, the tag
constexpr int MDS0 = T * ROUNDS;
constexpr int R2 = MDS0 + T * T;
constexpr int TAG = R2 + 1;
constexpr int ENTRIES = TAG + 1;
constexpr int THREADS = 128;

__constant__ uint32_t c_tab[ENTRIES * NW];

__device__ __forceinline__ void entry(int e, uint32_t w[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = c_tab[e * NW + k];
}

__device__ __forceinline__ void sbox(const Field& f, uint32_t x[NW]) {
  uint32_t x2[NW], x4[NW];
  stark::mont_mul(f, x, x, x2);
  stark::mont_mul(f, x2, x2, x4);
  stark::mont_mul(f, x4, x, x);
}

// s[j] <- sum_i M[i][j] s[i]
__device__ __forceinline__ void mds(const Field& f, uint32_t s[T][NW]) {
  uint32_t out[T][NW], m[NW], t[NW];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    entry(MDS0 + j, m);
    stark::mont_mul(f, s[0], m, out[j]);
#pragma unroll
    for (int i = 1; i < T; ++i) {
      entry(MDS0 + T * i + j, m);
      stark::mont_mul(f, s[i], m, t);
      stark::mod_add(f, out[j], t, out[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < T; ++j) stark::set_elem(s[j], out[j]);
}

template <bool PARTIAL_ROUND>
__device__ __forceinline__ void perm_round(const Field& f, int r, uint32_t s[T][NW]) {
  uint32_t c[NW];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    entry(T * r + i, c);
    stark::mod_add(f, s[i], c, s[i]);
  }
  if (PARTIAL_ROUND) {
    sbox(f, s[0]);
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) sbox(f, s[i]);
  }
  mds(f, s);
}

// n hashes; the inputs' rows are `ld` words apart, the output's n.
template <bool PAIRS>
__global__ void __launch_bounds__(THREADS)
poseidon_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int64_t n,
                int64_t ld, Field f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t col = PAIRS ? 2 * i : i;
  uint32_t s[T][NW], r2[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    s[1][k] = static_cast<uint32_t>(in[k * ld + col]);
    s[2][k] = PAIRS ? static_cast<uint32_t>(in[k * ld + col + 1]) : 0u;
  }
  entry(R2, r2);
  stark::mont_mul(f, s[1], r2, s[1]);
  if (PAIRS) stark::mont_mul(f, s[2], r2, s[2]);  // a leaf's 0 is 0 in either form
  entry(TAG, s[0]);
  int r = 0;
#pragma unroll 1
  for (; r < FULL / 2; ++r) perm_round<false>(f, r, s);
#pragma unroll 1
  for (; r < FULL / 2 + PARTIAL; ++r) perm_round<true>(f, r, s);
#pragma unroll 1
  for (; r < ROUNDS; ++r) perm_round<false>(f, r, s);
  uint32_t one[NW] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  stark::mont_mul(f, s[1], one, s[1]);
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k * n + i] = static_cast<int32_t>(s[1][k]);
}

template <bool PAIRS>
int launch(const void* in, void* out, long long n, long long ld, const uint32_t* table,
           const uint32_t* field_words, uint32_t np, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemcpyToSymbolAsync(c_tab, table, sizeof(c_tab), 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + THREADS - 1) / THREADS;
  poseidon_kernel<PAIRS><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), n, ld,
      stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: `kernel_table` on the device (ENTRIES x 8 words).
// leaf_words (W >= 8, ld) -> out (8, n): the leaf layer (n = ld).
extern "C" int parent_poseidon_leaves(const void* leaf_words, void* out, long long n,
                                     long long ld, const uint32_t* table,
                                     const uint32_t* field_words, uint32_t np,
                                     void* stream) {
  return launch<false>(leaf_words, out, n, ld, table, field_words, np, stream);
}

// layer (8, ld = 2n) -> out (8, n): one fold level.
extern "C" int parent_poseidon_pairs(const void* layer, void* out, long long n,
                                    long long ld, const uint32_t* table,
                                    const uint32_t* field_words, uint32_t np,
                                    void* stream) {
  return launch<true>(layer, out, n, ld, table, field_words, np, stream);
}
"""


# The library's thread form under other launch bounds than its MIN_BLOCKS (5):
# at least 4 (no bound on its registers: 116), 6 or 8 blocks an SM, built
# into a probe library that includes `csrc/poseidon.cu`: whether occupancy
# binds it.
OCCUPANCY = r"""
#include "poseidon.cu"

namespace {

template <bool PAIRS, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
occupancy_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int64_t n,
                 int64_t ld, const uint32_t* __restrict__ table, stark::Field f) {
  __shared__ __align__(16) uint32_t tab[ENTRIES * ENTRY_WORDS];
  for (int w = threadIdx.x; w < ENTRIES * ENTRY_WORDS / 4; w += THREADS)
    reinterpret_cast<uint4*>(tab)[w] = reinterpret_cast<const uint4*>(table)[w];
  __syncthreads();
  Sq29 q;
  stark::to_limbs29(f.p, q.p);
  q.np = f.np & stark::MASK29;
  thread_form<PAIRS>(in, out, n, ld, q, tab);
}

}  // namespace

#define OCC_ENTRY(NAME, PAIRS, BLOCKS)                                                      \
  extern "C" int NAME(const void* in, void* out, long long n, long long ld,                 \
                      const void* table, const uint32_t* field_words, uint32_t np,          \
                      void* stream) {                                                       \
    if (n <= 0) return 0;                                                                   \
    const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);             \
    occupancy_kernel<PAIRS, BLOCKS>                                                         \
        <<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(                        \
            static_cast<const int32_t*>(in), static_cast<int32_t*>(out), n, ld,             \
            static_cast<const uint32_t*>(table), stark::make_field(field_words, np));       \
    return static_cast<int>(cudaGetLastError());                                            \
  }
"""
OCCUPANCY_KERNELS = {f"occ_{kind}_min{b}": (pairs, b)
                     for kind, pairs in (("pairs", 1), ("leaves", 0)) for b in (4, 6, 8)}

def parent_table() -> torch.Tensor:
    """The parent kernel's table (`PARENT`'s layout) as int32 words on the card."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls
    from stark_tpu_torch.ops import poseidon as pos

    p, r = bls.p, bls.r_mod_p
    mds = pos.mds_matrix(p=p)
    vals = ([c * r % p for c in pos.round_constants(p=p)]
            + [mds[i][j] * r % p for i in range(pos.T) for j in range(pos.T)]
            + [bls.r2_mod_p, pos.DOMAIN_TAG * r % p])
    words = [(v >> 32 * k) & 0xFFFFFFFF for v in vals for k in range(8)]
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32), device="cuda")


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found")
    return path


def build_parent(tmp: str):
    """The probe library of `PARENT` and what `ptxas -v` said of it."""
    from stark_tpu_torch.ops import build

    src, so = os.path.join(tmp, "parent.cu"), os.path.join(tmp, "libparent.so")
    with open(src, "w") as f:
        f.write(PARENT)
    done = subprocess.run([_tool("nvcc"), *build.NVCC_FLAGS, "-shared", "-I", build.CSRC,
                           "-o", so, src], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on the parent:\n{done.stdout}{done.stderr}")
    log = (done.stdout + done.stderr).splitlines()
    ptxas = [" ".join(x.strip() for x in log[i : i + 4]) for i, ln in enumerate(log)
             if "Compiling entry" in ln]
    lib = ctypes.CDLL(so)
    vp, ll, u32p = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32)
    for fn in (lib.parent_poseidon_leaves, lib.parent_poseidon_pairs):
        fn.argtypes = [vp, vp, ll, ll, vp, u32p, ctypes.c_uint32, vp]
        fn.restype = ctypes.c_int
    return lib, ptxas


def build_each(tmp: str, source: str, macro: str, kernels: dict) -> dict:
    """Each build of `source` (`kernels`: name -> (pairs, the macro's third
    argument)) compiled on its own, all started together: {name: (entry
    point or None, seconds, ptxas's lines or the compiler's error)}."""
    from stark_tpu_torch.ops import build

    procs = {}
    for name, (pairs, v) in kernels.items():
        src, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"lib{name}.so")
        with open(src, "w") as f:
            f.write(source + f"{macro}({name}, {'true' if pairs else 'false'}, {v})\n")
        procs[name] = (so, time.time(), subprocess.Popen(
            [_tool("nvcc"), *build.NVCC_FLAGS, "-shared", "-I", build.CSRC, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, t0, proc) in procs.items():
        log = proc.communicate()[0]
        seconds = time.time() - t0
        if proc.returncode:
            out[name] = (None, seconds, log[-2000:])
            continue
        lines = log.splitlines()
        ptxas = [" ".join(x.strip() for x in lines[i : i + 4]) for i, ln in enumerate(lines)
                 if "Compiling entry" in ln]
        fn = getattr(ctypes.CDLL(so), name)
        vp, ll, u32p = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32)
        fn.argtypes = [vp, vp, ll, ll, vp, u32p, ctypes.c_uint32, vp]
        fn.restype = ctypes.c_int
        out[name] = (fn, seconds, ptxas)
    return out


def probe_launcher(fn, pairs: bool, table: torch.Tensor):
    """f(src) -> (8, n) words through a probe build (`build_each`)."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls
    from stark_tpu_torch.ops import build, field_cuda

    def run(src: torch.Tensor) -> torch.Tensor:
        n = src.shape[1] // 2 if pairs else src.shape[1]
        words, np32, stream = field_cuda.cuda_args(bls, src)
        out = torch.empty((8, n), dtype=torch.int32, device=src.device)
        build.check(fn(src.data_ptr(), out.data_ptr(), n, src.shape[1], table.data_ptr(),
                       words, np32, stream), "probe build")
        return out

    return run


def sass_counts(library: str, pattern: str) -> dict:
    """SASS instructions of each kernel of `library` whose (mangled) name
    matches `pattern`, as `cuobjdump -sass` lists them, with the 12 most
    frequent opcodes."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                out[name] = collections.Counter()
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
            if m:
                out[name][m.group(1).split(".")[0]] += 1
    return {k: {"instructions": sum(c.values()), "top": c.most_common(12)}
            for k, c in out.items()}


def launcher(entry: str, lanes: int | None):
    """f(src) -> (8, n) words through the library's C entry point `entry` in
    the form `lanes` gives (1: lanes, 0: a thread a hash), or, with lanes
    None, through the parent's (`PARENT`, set up by `use_parent`)."""
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls
    from stark_tpu_torch.ops import build, field_cuda
    from stark_tpu_torch.ops import poseidon as pos

    def run(src: torch.Tensor) -> torch.Tensor:
        n = src.shape[1] // 2 if entry.endswith("pairs") else src.shape[1]
        words, np32, stream = field_cuda.cuda_args(bls, src)
        out = torch.empty((8, n), dtype=torch.int32, device=src.device)
        if lanes is None:
            fn = getattr(_PARENT["lib"], entry.replace("stark_", "parent_"))
            rc = fn(src.data_ptr(), out.data_ptr(), n, src.shape[1],
                    _PARENT["table"].data_ptr(), words, np32, stream)
        else:
            rc = getattr(build.load(), entry)(
                src.data_ptr(), out.data_ptr(), n, src.shape[1],
                pos._device_table(src.device).data_ptr(), lanes, words, np32, stream)
        build.check(rc, entry)
        return out

    return run


_PARENT: dict = {}


def in_turns(cases: dict, fns: dict) -> dict:
    """Each case through each function, held equal to the first's output,
    timed in turns (the functions in order, then in reverse)."""
    out = {}
    for label, x in cases.items():
        want = None
        for name, fn in fns.items():
            got = fn(x)
            if want is None:
                want = got
            elif not torch.equal(got, want):
                raise AssertionError(f"{label}: {name} != {next(iter(fns))}")
        times = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(chip_smoke.median_ms(lambda: fns[name](x), 5))
        out[label] = times
        print(json.dumps({label: times}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/poseidon_kernels.json")
    ap.add_argument("--quick", action="store_true",
                    help="only the build and both forms at small widths against plain")
    ap.add_argument("--probe", action="store_true",
                    help="also the SASS counts and the thread form under other launch bounds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("poseidon_kernels_cuda: no CUDA device", file=sys.stderr)
        return 1
    from stark_tpu_torch.fields.field import BLS12_381_FR as bls, BN254_FR as bn
    from stark_tpu_torch.ops import build
    from stark_tpu_torch.ops import poseidon as pos

    def smi(query: str) -> str:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()

    sm_mhz = float(smi("clocks.max.sm").split()[0])
    records = [{"device": torch.cuda.get_device_name(0), "nvidia_smi": smi("name,power.limit"),
                "clocks_max_sm_mhz": sm_mhz}]
    print(json.dumps(records[-1]), flush=True)

    def emit(rec: dict) -> None:
        records.append(rec)
        print(json.dumps(rec), flush=True)

    t0 = time.time()
    build.load()
    emit({"build_s": time.time() - t0, "ptxas": chip_smoke.ptxas_of("poseidon")})
    rng = np.random.default_rng(chip_smoke.SEED + 15)
    entries = {"stark_poseidon_leaves": (16, 1, bn.p, pos.poseidon_leaves_plain),
               "stark_poseidon_pairs": (8, 2, bls.p, pos.poseidon_pairs_plain)}
    if args.quick:
        checks = {}
        for entry, (rows, per, bound, plain) in entries.items():
            for n in (1, 3, 33, 1 << 10):
                x = chip_smoke.poseidon_words(rng, rows, per * n, bound, "cuda")
                want = plain(x)
                for lanes in (0, 1):
                    got = launcher(entry, lanes)(x)
                    torch.cuda.synchronize()
                    checks[f"{entry} n={n} lanes={lanes}"] = bool(torch.equal(got, want))
        emit({"quick": checks})
        if not all(checks.values()):
            return 1
    else:
        t0 = time.time()
        results = chip_smoke.compare_poseidon("cuda", sm_mhz * 1e6)
        for result in results.values():
            chip_smoke.add_bounds(result, sm_mhz * 1e6)
        emit({"results": results, "seconds": time.time() - t0})
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            _PARENT["lib"], ptxas = build_parent(tmp)
            _PARENT["table"] = parent_table()
            emit({"parent_build_s": time.time() - t0, "parent_ptxas": ptxas})
            turns = {}
            for entry, (rows, per, bound, _) in entries.items():
                widths = ((1 << 20,) if per == 1 else tuple(1 << k for k in range(19, -1, -1)))
                cases = {f"{entry} n={n}": chip_smoke.poseidon_words(rng, rows, per * n, bound,
                                                                     "cuda") for n in widths}
                turns.update(in_turns(cases, {
                    "parent": launcher(entry, None),
                    "new": lambda x, e=entry: (pos.poseidon_pairs(x) if e.endswith("pairs")
                                               else pos.poseidon_leaves(x))}))
            emit({"parent_vs_new_ms": turns})
        forms = {}
        for entry, (rows, per, bound, _) in entries.items():
            cases = {f"{entry} n={1 << k}": chip_smoke.poseidon_words(rng, rows, per << k, bound,
                                                                      "cuda")
                     for k in (0, 4, *range(8, 18))}
            forms.update(in_turns(cases, {"thread": launcher(entry, 0),
                                          "lanes": launcher(entry, 1)}))
        emit({"forms_ms": forms, "lane_form_below": pos.LANE_FORM_BELOW})
    if args.probe:
        emit({"sass": sass_counts(build.library_path(), "poseidon")})
        with tempfile.TemporaryDirectory() as tmp:
            built = build_each(tmp, OCCUPANCY, "OCC_ENTRY", OCCUPANCY_KERNELS)
            emit({"occupancy_builds": {name: {"built": fn is not None, "seconds": sec, "log": log}
                                       for name, (fn, sec, log) in built.items()}})
            occupancy = {}
            for entry, (rows, per, bound, _) in entries.items():
                kind = "pairs" if per == 2 else "leaves"
                wide = (1 << 20,) if per == 1 else (1 << 19, 1 << 16)
                cases = {f"{entry} n={n}": chip_smoke.poseidon_words(rng, rows, per * n, bound,
                                                                     "cuda") for n in wide}
                occupancy.update(in_turns(cases, {"thread": launcher(entry, 0), **{
                    f"thread_min{b}_blocks": probe_launcher(
                        built[f"occ_{kind}_min{b}"][0], per == 2, pos._device_table("cuda"))
                    for b in (4, 6, 8) if built[f"occ_{kind}_min{b}"][0] is not None}}))
            emit({"occupancy_ms": occupancy})
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "poseidon_kernels.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
