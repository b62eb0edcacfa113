#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernel library and hold `butterfly_fused`
and `butterfly_pass` (`stark_tpu_torch/csrc/ntt.cu`) and their Shoup forms
against their plain PyTorch versions on one NVIDIA GPU, with the
instruction floor of their butterflies and the variants that were tried,
without the rest of `chip_smoke.py`.

    python3 scripts/ntt_kernels_cuda.py [--out DIR] [--library PATH ...]
        [--other-csrc DIR] [--shoup-only]

Printed: the card's name, power limit and highest SM clock; what `ptxas -v`
said of the NTT kernels; the SASS instructions of one butterfly of each
direction, read with `cuobjdump -sass` from a probe kernel that runs one
`fused_butterfly` on loaded operands (compiled beside the library from
`csrc/ntt.cu`; the probe's loads, stores and control flow are not counted),
of the canonical build's (`*_canonical`, the fields without 5p < 2^256),
and of `butterfly_stage`'s dit butterfly (`stage`, field.cuh's product,
which the first version of the fused pass ran too); the SASS instructions
of every `butterfly_fused` and `butterfly_pass` kernel of the library, and
of any other build
named with `--library PATH` (a parent commit's, to show that a build's
code did not change);
the SASS of `butterfly_fused_shoup`'s butterfly with each product (the
library's radix-2^29 form, alone and behind the test for the twiddle 1;
the word form's carry chains; field.cuh's); with `--other-csrc DIR`
(another tree's `stark_tpu_torch/csrc`), whether every `butterfly_fused_kernel`
and `butterfly_pass_kernel` build has the same SASS there (instructions and
encodings; exit 1 if not). Then `chip_smoke.compare_shoup`'s cases and the
fused Shoup run at block 2048 on the prover's shapes (2^20 dit and dif,
2^17 dif and dit), on the same inputs in one process: the library's
kernel, the kernel before its redesign (`SHOUP_VARIANTS`: one CTA a block,
a barrier a stage, twiddles from L2), the library's design with the word
form's products or with the twiddle 1 tested in every round
(`SHOUP_PRODUCTS`), and row 3's kernel, each held bit for bit against its
plain version and timed in turns (`--shoup-only` stops there).
Then `chip_smoke.compare_fused`'s cases (dit and dif at 2^20, dif at 2^17
on BN254's scalar field; dit and dif at 2^17 and at one block on
BLS12-381's; all bit-identical to the plain version) with each one's median
device time, bounds and instruction floor: instructions of one butterfly x
the butterflies of the pass / (128 x the SMs x the highest SM clock), an SM
issuing at most one warp instruction of 32 lanes a clock on each of its
four schedulers. Both branches of a butterfly (the product by a twiddle
equal to Montgomery one is skipped) are in the static count.
Then `chip_smoke.compare_pass`'s cases with the same floor, and the
variants of the multi-stage pass, each held bit for bit against the plain
version at the prover's passes (dit at 2^20, dif at 2^17, BN254) and timed
in turns (`pass_variants`): the library's kernel (`tile`: a shared-memory
tile of 2^r rows x 512 / 2^r columns that 256 threads run a stage at a
time between `__syncthreads`, 8-byte column accesses, twiddles as packed
words); its first build with scalar accesses and twiddles from limb planes
(`tile_planes`); one thread a group of 2^r elements in registers, every
twiddle from the largest stage's planes (`registers`) or each stage's
from its own (`registers_stage_tables`); the library's tile made
persistent, 2-4 CTAs an SM walking the tiles (or one CTA a tile, `_0`),
the next tile's limb planes copied into shared memory with `cp.async`
while the current one's stages run (`tile_async_<CTAs an SM>`); a
device copy of the column (`copy`), the yardstick of its bytes; then,
whole runs of the outer stages: in passes of three (the plan's), of at
most two, of 5 then 4 or 4 then 5 at 2^20 and 5 then 1 or 4 then 2 at
2^17 (the library's kernel built for 4 and 5 stages in the probe), and
the single stages (`butterfly_stage`). The probe kernels are compiled
into a library of their own that includes `ntt.cu`; their `ptxas -v`
lines are printed.
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
// @SHOUP_PRODUCTS@
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
// butterfly_fused_shoup's butterflies: the library's product (radix 2^29),
// alone and behind the test for the twiddle 1 (`_one`), the word form's
// carry chains (`_chain`) and field.cuh's (`_c`); the twiddle read as its
// staged vectors
template <bool DIT, class Mul>
__device__ void probe_shoup(const uint32_t* in, const uint4* tw, uint32_t* out,
                            const stark::Field& f, const ShoupOne& one) {
  uint32_t u[stark::NW], v[stark::NW], p2[stark::NW];
  for (int i = 0; i < stark::NW; ++i) { u[i] = in[i]; v[i] = in[8 + i]; p2[i] = in[16 + i]; }
  uint4 vecs[Mul::Layout::VECS];
  for (int c = 0; c < Mul::Layout::VECS; ++c) vecs[c] = tw[c];
  shoup_butterfly<DIT>(f, Mul{f, one}, p2, u, v, Mul::Layout::unpack(vecs), false);
  for (int i = 0; i < stark::NW; ++i) { out[i] = u[i]; out[8 + i] = v[i]; }
}
#define SASS_PROBE_SHOUP(NAME, DIT, MUL)                                                  \
  extern "C" __global__ void NAME(const uint32_t* in, const uint4* tw, uint32_t* out,     \
                                  stark::Field f, ShoupOne one) {                         \
    probe_shoup<DIT, MUL>(in, tw, out, f, one);                                           \
  }
SASS_PROBE_SHOUP(sass_probe_shoup_dit, true, ShoupMul29)
SASS_PROBE_SHOUP(sass_probe_shoup_dif, false, ShoupMul29)
SASS_PROBE_SHOUP(sass_probe_shoup_dit_one, true, SkipAll29)
SASS_PROBE_SHOUP(sass_probe_shoup_dif_one, false, SkipAll29)
SASS_PROBE_SHOUP(sass_probe_shoup_dit_chain, true, ShoupMulChain)
SASS_PROBE_SHOUP(sass_probe_shoup_dif_chain, false, ShoupMulChain)
SASS_PROBE_SHOUP(sass_probe_shoup_dit_c, true, CProduct)
SASS_PROBE_SHOUP(sass_probe_shoup_dif_c, false, CProduct)
"""
# Variants of the multi-stage pass, built into a probe library beside the
# port's (the library's kernel, `butterfly_pass_kernel`, is the one kept).
VARIANTS = r"""
#include "ntt.cu"
namespace {
constexpr int REG_THREADS = 128;
struct Tables {
  const int32_t* tw[PASS_MAX_STAGES];  // each stage's (16, l) limb planes
  int shift[PASS_MAX_STAGES];          // stage s reads entry i << shift[s]
};

// One thread a group of 2^R elements in registers (the pass's first build):
// the 2^R elements base + j l0, consecutive threads on consecutive k; stage
// s's twiddle t from tbl.tw[s] at (k + t l0) << tbl.shift[s], from limb planes
template <bool DIT, bool LAZY, int R>
__global__ void __launch_bounds__(REG_THREADS)
pass_registers_kernel(const int32_t* __restrict__ a, Tables tbl,
                      int32_t* __restrict__ out, int64_t n, int log_l0, stark::Field f) {
  constexpr int E = 1 << R;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n >> R) return;
  const int64_t l0 = int64_t(1) << log_l0;
  const int64_t k = idx & (l0 - 1), base = ((idx >> log_l0) << (log_l0 + R)) + k;
  uint32_t p2[stark::NW];
#pragma unroll
  for (int i = 0; i < stark::NW; ++i)
    p2[i] = (f.p[i] << 1) | (i > 0 ? f.p[i - 1] >> 31 : 0u);
  uint32_t x[E][stark::NW];
#pragma unroll
  for (int j = 0; j < E; ++j) stark::load_elem(a, n, base + j * l0, x[j]);
#pragma unroll
  for (int st = 0; st < R; ++st) {
    const int s = DIT ? st : R - 1 - st;
#pragma unroll
    for (int t = 0; t < (1 << s); ++t) {
      uint32_t w[stark::NW];
      stark::load_elem(tbl.tw[s], (l0 << s) << tbl.shift[s], (k + t * l0) << tbl.shift[s], w);
#pragma unroll
      for (int hi = 0; hi < E >> (s + 1); ++hi) {
        const int j = (hi << (s + 1)) | t;
        fused_butterfly<DIT, LAZY>(f, p2, x[j], x[j + (1 << s)], w);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    fused_canonical<DIT, LAZY>(f, p2, x[j]);
    stark::store_elem(out, n, base + j * l0, x[j]);
  }
}

// The tile of the library's kernel with scalar loads and stores, its
// twiddles from the largest stage's limb planes (the tile's first build)
constexpr int TILE_THREADS = PASS_TILE / 2;
template <bool DIT, bool LAZY, int R>
__global__ void __launch_bounds__(TILE_THREADS)
pass_tile_planes_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ tw,
                        int32_t* __restrict__ out, int64_t n, int log_l0, stark::Field f) {
  constexpr int E = 1 << R, K = PASS_TILE / E;
  __shared__ uint32_t xs[stark::NW][PASS_TILE];
  const int64_t l0 = int64_t(1) << log_l0, ntw = l0 << (R - 1), per_group = l0 / K;
  const int64_t g = blockIdx.x / per_group, k0 = (blockIdx.x % per_group) * K;
  const int64_t base = (g << (log_l0 + R)) + k0;
  uint32_t p2[stark::NW];
#pragma unroll
  for (int i = 0; i < stark::NW; ++i)
    p2[i] = (f.p[i] << 1) | (i > 0 ? f.p[i - 1] >> 31 : 0u);
  for (int e = threadIdx.x; e < PASS_TILE; e += TILE_THREADS) {
    uint32_t w[stark::NW];
    stark::load_elem(a, n, base + (e / K) * l0 + e % K, w);
#pragma unroll
    for (int q = 0; q < stark::NW; ++q) xs[q][e] = w[q];
  }
  __syncthreads();
  const int c = threadIdx.x % K, jj = threadIdx.x / K;
#pragma unroll
  for (int st = 0; st < R; ++st) {
    const int s = DIT ? st : R - 1 - st;
    const int j = ((jj >> s) << (s + 1)) | (jj & ((1 << s) - 1)), t = j & ((1 << s) - 1);
    uint32_t u[stark::NW], v[stark::NW], w[stark::NW];
#pragma unroll
    for (int q = 0; q < stark::NW; ++q) {
      u[q] = xs[q][j * K + c];
      v[q] = xs[q][(j + (1 << s)) * K + c];
    }
    stark::load_elem(tw, ntw, (k0 + c + t * l0) << (R - 1 - s), w);
    fused_butterfly<DIT, LAZY>(f, p2, u, v, w);
#pragma unroll
    for (int q = 0; q < stark::NW; ++q) {
      xs[q][j * K + c] = u[q];
      xs[q][(j + (1 << s)) * K + c] = v[q];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < PASS_TILE; e += TILE_THREADS) {
    uint32_t w[stark::NW];
#pragma unroll
    for (int q = 0; q < stark::NW; ++q) w[q] = xs[q][e];
    fused_canonical<DIT, LAZY>(f, p2, w);
    stark::store_elem(out, n, base + (e / K) * l0 + e % K, w);
  }
}
// The library's tile, persistent: a CTA walks tiles b, b + grid, ..., the
// next tile's raw limb planes copied into a second buffer with cp.async
// (16 bytes a copy) while the current one's stages run
constexpr int RAW_CHUNKS = stark::LIMBS * PASS_TILE / 4;  // 16-byte chunks a tile
template <bool DIT, bool LAZY, int R>
__device__ __forceinline__ void fetch_tile(const int32_t* __restrict__ a, int32_t* raw,
                                          int64_t n, int log_l0, int64_t b) {
  constexpr int K = PASS_TILE >> R, LOG_K = 9 - R;
  const int64_t l0 = int64_t(1) << log_l0;
  const int64_t k0 = (b << LOG_K) & (l0 - 1), g = b >> (log_l0 - LOG_K);
  const int64_t base = (g << (log_l0 + R)) + k0;
  for (int ch = threadIdx.x; ch < RAW_CHUNKS; ch += PASS_TILE / 2) {
    const int plane = ch / (PASS_TILE / 4), e = 4 * (ch % (PASS_TILE / 4));
    const int32_t* src = a + plane * n + base + (e / K) * l0 + (e % K);
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(raw + plane * PASS_TILE + e));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src));
  }
  asm volatile("cp.async.commit_group;");
}

template <bool DIT, bool LAZY, int R>
__global__ void __launch_bounds__(PASS_TILE / 2)
pass_tile_async_kernel(const int32_t* __restrict__ a, const uint4* __restrict__ tw,
                       int32_t* __restrict__ out, int64_t n, int log_l0, stark::Field f) {
  constexpr int K = PASS_TILE >> R, LOG_K = 9 - R;
  extern __shared__ __align__(16) uint32_t dyn[];
  uint32_t(*xs)[PASS_TILE] = reinterpret_cast<uint32_t(*)[PASS_TILE]>(dyn);
  int32_t* raw = reinterpret_cast<int32_t*>(dyn + stark::NW * PASS_TILE);
  const int64_t l0 = int64_t(1) << log_l0, tiles = n >> 9;
  uint32_t p2[stark::NW];
#pragma unroll
  for (int i = 0; i < stark::NW; ++i)
    p2[i] = (f.p[i] << 1) | (i > 0 ? f.p[i - 1] >> 31 : 0u);
  const int e = 2 * threadIdx.x;
  const int c = threadIdx.x & (K - 1), jj = threadIdx.x >> LOG_K;
  int64_t b = blockIdx.x;
  if (b < tiles) fetch_tile<DIT, LAZY, R>(a, raw, n, log_l0, b);
  for (; b < tiles; b += gridDim.x) {
    const int64_t k0 = (b << LOG_K) & (l0 - 1), g = b >> (log_l0 - LOG_K);
    const int64_t col = (g << (log_l0 + R)) + k0 + (e / K) * l0 + (e % K);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int i = 0; i < stark::NW; ++i) {
      const int2 lo = *reinterpret_cast<const int2*>(raw + 2 * i * PASS_TILE + e);
      const int2 hi = *reinterpret_cast<const int2*>(raw + (2 * i + 1) * PASS_TILE + e);
      *reinterpret_cast<uint2*>(&xs[i][e]) =
          make_uint2((static_cast<uint32_t>(lo.x) & 0xFFFFu) | (static_cast<uint32_t>(hi.x) << 16),
                     (static_cast<uint32_t>(lo.y) & 0xFFFFu) | (static_cast<uint32_t>(hi.y) << 16));
    }
    __syncthreads();
    if (b + gridDim.x < tiles) fetch_tile<DIT, LAZY, R>(a, raw, n, log_l0, b + gridDim.x);
#pragma unroll
    for (int st = 0; st < R; ++st) {
      const int s = DIT ? st : R - 1 - st;
      const int j = ((jj >> s) << (s + 1)) | (jj & ((1 << s) - 1));
      const int iu = j * K + c, iv = iu + (K << s);
      uint32_t u[stark::NW], v[stark::NW];
#pragma unroll
      for (int q = 0; q < stark::NW; ++q) {
        u[q] = xs[q][iu];
        v[q] = xs[q][iv];
      }
      const int64_t ti = (k0 + c + (j & ((1 << s) - 1)) * l0) << (R - 1 - s);
      const uint4 t0 = tw[2 * ti], t1 = tw[2 * ti + 1];
      const uint32_t w[stark::NW] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      fused_butterfly<DIT, LAZY>(f, p2, u, v, w);
#pragma unroll
      for (int q = 0; q < stark::NW; ++q) {
        xs[q][iu] = u[q];
        xs[q][iv] = v[q];
      }
      __syncthreads();
    }
    uint32_t y0[stark::NW], y1[stark::NW];
#pragma unroll
    for (int i = 0; i < stark::NW; ++i) {
      const uint2 x = *reinterpret_cast<const uint2*>(&xs[i][e]);
      y0[i] = x.x;
      y1[i] = x.y;
    }
    fused_canonical<DIT, LAZY>(f, p2, y0);
    fused_canonical<DIT, LAZY>(f, p2, y1);
#pragma unroll
    for (int i = 0; i < stark::NW; ++i) {
      *reinterpret_cast<int2*>(out + 2 * i * n + col) =
          make_int2(static_cast<int32_t>(y0[i] & 0xFFFFu), static_cast<int32_t>(y1[i] & 0xFFFFu));
      *reinterpret_cast<int2*>(out + (2 * i + 1) * n + col) =
          make_int2(static_cast<int32_t>(y0[i] >> 16), static_cast<int32_t>(y1[i] >> 16));
    }
  }
}
}  // namespace

// BN254's lazy build, 3 stages a pass, l0 >= 64; ctas_per_sm CTAs an SM
// persist (0: one CTA a tile)
extern "C" int probe_pass_tile_async(const void* a, const void* tw, void* out, long long n,
                                     long long l0, int dit, int ctas_per_sm,
                                     const uint32_t* p_words, uint32_t np, void* stream) {
  int log_l0 = 0;
  while ((1LL << log_l0) < l0) ++log_l0;
  if (l0 < PASS_TILE / 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (stark::NW + stark::LIMBS) * PASS_TILE * sizeof(uint32_t);
  auto kernel = dit ? pass_tile_async_kernel<true, true, 3> : pass_tile_async_kernel<false, true, 3>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = n / PASS_TILE;
  long long grid = ctas_per_sm > 0 ? static_cast<long long>(sms) * ctas_per_sm : tiles;
  if (grid > tiles) grid = tiles;
  const stark::Field f = stark::make_field(p_words, np);
  kernel<<<static_cast<unsigned>(grid), PASS_TILE / 2, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const uint4*>(tw), static_cast<int32_t*>(out),
      n, log_l0, f);
  return static_cast<int>(cudaGetLastError());
}

// The library's kernel on passes of 4 or 5 stages (BN254's lazy build)
extern "C" int probe_pass_wide(const void* a, const void* tw, void* out, long long n,
                               long long l0, int stages, int dit, const uint32_t* p_words,
                               uint32_t np, void* stream) {
  int log_l0 = 0;
  while ((1LL << log_l0) < l0) ++log_l0;
  int log_k = 0;
  while ((2 << log_k) << stages <= PASS_TILE && log_k < log_l0) ++log_k;
  const unsigned blocks = static_cast<unsigned>(n >> (stages + log_k));
  const unsigned threads = (1u << (stages + log_k)) / 2;
  const stark::Field f = stark::make_field(p_words, np);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ap = static_cast<const int32_t*>(a);
  const uint4* tp = static_cast<const uint4*>(tw);
  int32_t* op = static_cast<int32_t*>(out);
  if (stages == 4 && dit)
    butterfly_pass_kernel<true, true, 4><<<blocks, threads, 0, st>>>(ap, tp, op, n, log_l0, log_k, f);
  else if (stages == 4)
    butterfly_pass_kernel<false, true, 4><<<blocks, threads, 0, st>>>(ap, tp, op, n, log_l0, log_k, f);
  else if (stages == 5 && dit)
    butterfly_pass_kernel<true, true, 5><<<blocks, threads, 0, st>>>(ap, tp, op, n, log_l0, log_k, f);
  else if (stages == 5)
    butterfly_pass_kernel<false, true, 5><<<blocks, threads, 0, st>>>(ap, tp, op, n, log_l0, log_k, f);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// BN254's lazy build, 3 stages a pass; tables and shifts as Tables
extern "C" int probe_pass_registers(const void* a, const void* tw0, const void* tw1,
                                    const void* tw2, int shift0, int shift1, int shift2,
                                    void* out, long long n, long long l0, int dit,
                                    const uint32_t* p_words, uint32_t np, void* stream) {
  int log_l0 = 0;
  while ((1LL << log_l0) < l0) ++log_l0;
  const Tables tbl = {{static_cast<const int32_t*>(tw0), static_cast<const int32_t*>(tw1),
                       static_cast<const int32_t*>(tw2)}, {shift0, shift1, shift2}};
  const unsigned blocks = static_cast<unsigned>(((n >> 3) + REG_THREADS - 1) / REG_THREADS);
  const stark::Field f = stark::make_field(p_words, np);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* op = static_cast<int32_t*>(out);
  const int32_t* ap = static_cast<const int32_t*>(a);
  if (dit)
    pass_registers_kernel<true, true, 3><<<blocks, REG_THREADS, 0, st>>>(ap, tbl, op, n, log_l0, f);
  else
    pass_registers_kernel<false, true, 3><<<blocks, REG_THREADS, 0, st>>>(ap, tbl, op, n, log_l0, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_pass_tile_planes(const void* a, const void* tw, void* out, long long n,
                                      long long l0, int dit, const uint32_t* p_words,
                                      uint32_t np, void* stream) {
  int log_l0 = 0;
  while ((1LL << log_l0) < l0) ++log_l0;
  if (l0 < PASS_TILE / 8) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(n / PASS_TILE);
  const stark::Field f = stark::make_field(p_words, np);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* op = static_cast<int32_t*>(out);
  const int32_t* ap = static_cast<const int32_t*>(a);
  const int32_t* tp = static_cast<const int32_t*>(tw);
  if (dit)
    pass_tile_planes_kernel<true, true, 3><<<blocks, TILE_THREADS, 0, st>>>(ap, tp, op, n, log_l0, f);
  else
    pass_tile_planes_kernel<false, true, 3><<<blocks, TILE_THREADS, 0, st>>>(ap, tp, op, n, log_l0, f);
  return static_cast<int>(cudaGetLastError());
}
"""

# Products of the fused Shoup run other than the library's (`ShoupMul29`),
# built into the probes: the word form's PTX carry chains
# (`ShoupMulChain`: `mac_lo_words`, `shoup_mul_chain`) and field.cuh's C
# product (`CProduct`) on the table's words staged as they are
# (`WordsLayout`, 64 bytes an entry), and the radix-2^29 form that tests
# every twiddle for 1 (`SkipAll29`, the kernel's first build).
SHOUP_PRODUCTS = r"""
namespace {
// The word layout: a staged entry is the table's row as it is
struct WordsLayout {
  using Tw = TwWords;
  static constexpr int VECS = 4;
  __device__ static void stage(const uint4* __restrict__ row, uint4 (&v)[VECS]) {
#pragma unroll
    for (int c = 0; c < VECS; ++c) v[c] = row[c];
  }
  __device__ static Tw unpack(const uint4 (&v)[VECS]) {
    Tw t;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(v);
#pragma unroll
    for (int i = 0; i < stark::NW; ++i) {
      t.w[i] = s[i];
      t.wp[i] = s[stark::NW + i];
    }
    return t;
  }
};

// Whether a twiddle is 1 with its companion (by value)
__device__ __forceinline__ bool is_shoup_one(const ShoupOne& one, const TwWords& t) {
  bool eq = t.w[0] == 1u && t.wp[0] == one.wp[0];
#pragma unroll
  for (int i = 1; i < stark::NW; ++i) eq &= t.w[i] == 0u && t.wp[i] == one.wp[i];
  return eq;
}

// s += a b mod 2^256 in one carry chain a row: row i adds the low halves
// of a[j] b[i] at words i + j and the high halves at i + j + 1, each chain
// ending at word 7 (what leaves it lies above 2^256)
__device__ __forceinline__ void mac_lo_words(const uint32_t (&a)[stark::NW],
                                             const uint32_t (&b)[stark::NW],
                                             uint32_t (&s)[stark::NW]) {
  asm(
      "mad.lo.cc.u32 %0, %8, %16, %0;\n\tmadc.lo.cc.u32 %1, %9, %16, %1;\n\tmadc.lo.cc.u32 %2, %10, %16, %2;\n\t"
      "madc.lo.cc.u32 %3, %11, %16, %3;\n\tmadc.lo.cc.u32 %4, %12, %16, %4;\n\tmadc.lo.cc.u32 %5, %13, %16, %5;\n\t"
      "madc.lo.cc.u32 %6, %14, %16, %6;\n\tmadc.lo.u32 %7, %15, %16, %7;\n\t"
      "mad.hi.cc.u32 %1, %8, %16, %1;\n\tmadc.hi.cc.u32 %2, %9, %16, %2;\n\tmadc.hi.cc.u32 %3, %10, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %11, %16, %4;\n\tmadc.hi.cc.u32 %5, %12, %16, %5;\n\tmadc.hi.cc.u32 %6, %13, %16, %6;\n\t"
      "madc.hi.u32 %7, %14, %16, %7;\n\t"
      "mad.lo.cc.u32 %1, %8, %17, %1;\n\tmadc.lo.cc.u32 %2, %9, %17, %2;\n\tmadc.lo.cc.u32 %3, %10, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %17, %4;\n\tmadc.lo.cc.u32 %5, %12, %17, %5;\n\tmadc.lo.cc.u32 %6, %13, %17, %6;\n\t"
      "madc.lo.u32 %7, %14, %17, %7;\n\t"
      "mad.hi.cc.u32 %2, %8, %17, %2;\n\tmadc.hi.cc.u32 %3, %9, %17, %3;\n\tmadc.hi.cc.u32 %4, %10, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %17, %5;\n\tmadc.hi.cc.u32 %6, %12, %17, %6;\n\tmadc.hi.u32 %7, %13, %17, %7;\n\t"
      "mad.lo.cc.u32 %2, %8, %18, %2;\n\tmadc.lo.cc.u32 %3, %9, %18, %3;\n\tmadc.lo.cc.u32 %4, %10, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %11, %18, %5;\n\tmadc.lo.cc.u32 %6, %12, %18, %6;\n\tmadc.lo.u32 %7, %13, %18, %7;\n\t"
      "mad.hi.cc.u32 %3, %8, %18, %3;\n\tmadc.hi.cc.u32 %4, %9, %18, %4;\n\tmadc.hi.cc.u32 %5, %10, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %11, %18, %6;\n\tmadc.hi.u32 %7, %12, %18, %7;\n\t"
      "mad.lo.cc.u32 %3, %8, %19, %3;\n\tmadc.lo.cc.u32 %4, %9, %19, %4;\n\tmadc.lo.cc.u32 %5, %10, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %19, %6;\n\tmadc.lo.u32 %7, %12, %19, %7;\n\t"
      "mad.hi.cc.u32 %4, %8, %19, %4;\n\tmadc.hi.cc.u32 %5, %9, %19, %5;\n\tmadc.hi.cc.u32 %6, %10, %19, %6;\n\t"
      "madc.hi.u32 %7, %11, %19, %7;\n\t"
      "mad.lo.cc.u32 %4, %8, %20, %4;\n\tmadc.lo.cc.u32 %5, %9, %20, %5;\n\tmadc.lo.cc.u32 %6, %10, %20, %6;\n\t"
      "madc.lo.u32 %7, %11, %20, %7;\n\t"
      "mad.hi.cc.u32 %5, %8, %20, %5;\n\tmadc.hi.cc.u32 %6, %9, %20, %6;\n\tmadc.hi.u32 %7, %10, %20, %7;\n\t"
      "mad.lo.cc.u32 %5, %8, %21, %5;\n\tmadc.lo.cc.u32 %6, %9, %21, %6;\n\tmadc.lo.u32 %7, %10, %21, %7;\n\t"
      "mad.hi.cc.u32 %6, %8, %21, %6;\n\tmadc.hi.u32 %7, %9, %21, %7;\n\t"
      "mad.lo.cc.u32 %6, %8, %22, %6;\n\tmadc.lo.u32 %7, %9, %22, %7;\n\t"
      "mad.hi.u32 %7, %8, %22, %7;\n\t"
      "mad.lo.u32 %7, %8, %23, %7;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]),
        "+r"(s[6]), "+r"(s[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
}

// field.cuh's shoup_mul as PTX carry chains, the same value: q = floor(wp x
// / 2^256) exactly, from the whole product (mont_mul_lazy's rows: a 9-word
// window that takes wp x[i] and drops its low word, so its sums stay below
// 2^256 + wp 2^32 < 2^288), then r = (w x mod 2^256) - (q p mod 2^256),
// which is w x - q p < 2p for any x < 2^256.
__device__ __forceinline__ void shoup_mul_chain(const stark::Field& f,
                                                const uint32_t (&w)[stark::NW],
                                                const uint32_t (&wp)[stark::NW],
                                                const uint32_t (&x)[stark::NW],
                                                uint32_t (&r)[stark::NW]) {
  uint32_t t[stark::NW + 1], q[stark::NW], wx[stark::NW], qp[stark::NW];
#pragma unroll
  for (int i = 0; i <= stark::NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) wx[i] = qp[i] = 0;
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) {
    mad_lo_row(t, wp, x[i]);
    mad_hi_row(t, wp, x[i]);
#pragma unroll
    for (int j = 0; j < stark::NW; ++j) t[j] = t[j + 1];
    t[stark::NW] = 0;
  }
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) q[i] = t[i];
  mac_lo_words(w, x, wx);
  mac_lo_words(q, f.p, qp);
  sub_words(wx, qp, r);
}

struct ShoupMulChain {
  using Layout = WordsLayout;
  const stark::Field& f;
  const ShoupOne& one;
  __device__ __forceinline__ void operator()(const TwWords& t, const uint32_t (&x)[stark::NW],
                                             uint32_t (&r)[stark::NW]) const {
    shoup_mul_chain(f, t.w, t.wp, x, r);
  }
};

struct CProduct {
  using Layout = WordsLayout;
  const stark::Field& f;
  const ShoupOne& one;
  __device__ __forceinline__ void operator()(const TwWords& t, const uint32_t (&x)[stark::NW],
                                             uint32_t (&r)[stark::NW]) const {
    stark::shoup_mul(f, t.w, t.wp, x, r);
  }
};

struct SkipAll29 {
  using Layout = Limbs29Layout;
  const stark::Field& f;
  const ShoupOne& one;
  __device__ __forceinline__ void operator()(const Tw29& t, const uint32_t (&x)[stark::NW],
                                             uint32_t (&r)[stark::NW]) const {
    if (is_shoup_one(one, t))
      shoup_mul_one(f, one, x, r);
    else
      shoup_mul29(one, t, x, r);
  }
};
}  // namespace
"""

# The fused Shoup run before its redesign (`butterfly_fused_shoup_kernel` as
# it was: one CTA of 256 threads a block of up to 2048 elements in 64 KB of
# shared memory, a __syncthreads a stage, twiddles and companions read from
# L2) and the library's kernel on `SHOUP_PRODUCTS`' products, all held and
# timed beside the library's kernel and row 3's.
SHOUP_VARIANTS = r"""
#include "ntt.cu"
""" + SHOUP_PRODUCTS + r"""
namespace {
constexpr int FS_THREADS = 256;  // threads of a CTA of the parent's kernel

// The fused run of Shoup stages 2l <= block (l = 1 .. block/2; DIT
// ascending, DIF descending), one CTA a block: the block's elements word
// major in shared memory (element i's word q at xs[q * block + i]), each
// stage's block/2 butterflies strided over the threads, twiddle l - 1 + k of
// the (block - 1, 16) table read from global memory. With canon the last
// stage's outputs are reduced below p.
template <bool DIT>
__global__ void __launch_bounds__(FS_THREADS)
parent_fused_shoup_kernel(const int32_t* __restrict__ a, const uint4* __restrict__ tw,
                          int32_t* __restrict__ out, int64_t n, int log_block, int canon,
                          stark::Field f) {
  extern __shared__ __align__(16) uint32_t fs[];
  const int block = 1 << log_block, half = block >> 1;
  uint32_t p2[stark::NW];  // 2p
#pragma unroll
  for (int i = 0; i < stark::NW; ++i)
    p2[i] = (f.p[i] << 1) | (i > 0 ? f.p[i - 1] >> 31 : 0u);
  for (int64_t blk = blockIdx.x; blk < (n >> log_block); blk += gridDim.x) {
    const int64_t base = blk << log_block;
    __syncthreads();  // the last block's stores have read xs
    for (int i = threadIdx.x; i < block; i += blockDim.x) {
      uint32_t w[stark::NW];
      stark::load_elem(a, n, base + i, w);
#pragma unroll
      for (int q = 0; q < stark::NW; ++q) fs[q * block + i] = w[q];
    }
    __syncthreads();
    for (int st = 0; st < log_block; ++st) {
      const int s = DIT ? st : log_block - 1 - st, l = 1 << s;
      const bool last = canon && st == log_block - 1;
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int k = j & (l - 1), i0 = ((j >> s) << (s + 1)) + k, i1 = i0 + l;
        uint32_t u[stark::NW], v[stark::NW];
        TwWords t;
#pragma unroll
        for (int q = 0; q < stark::NW; ++q) {
          u[q] = fs[q * block + i0];
          v[q] = fs[q * block + i1];
        }
        load_shoup_tw(tw, l - 1 + k, t.w, t.wp);
        shoup_butterfly<DIT>(f, ShoupMul{f}, p2, u, v, t, last);
#pragma unroll
        for (int q = 0; q < stark::NW; ++q) {
          fs[q * block + i0] = u[q];
          fs[q * block + i1] = v[q];
        }
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < block; i += blockDim.x) {
      uint32_t w[stark::NW];
#pragma unroll
      for (int q = 0; q < stark::NW; ++q) w[q] = fs[q * block + i];
      stark::store_elem(out, n, base + i, w);
    }
  }
}
}  // namespace

extern "C" int probe_fused_shoup_parent(const void* a, const void* tw, void* out,
                                        long long n, int block, int dit, int canon,
                                        const uint32_t* p_words, uint32_t np, void* stream) {
  int log_block = 0;
  while ((1 << log_block) < block) ++log_block;
  if (block < 2 || (1 << log_block) != block || log_block > FB_MAX_LOG || n % block != 0 ||
      p_words[stark::NW - 1] >= 0x80000000u)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = n / block;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(block) * stark::NW * sizeof(uint32_t);
  auto kernel = dit ? parent_fused_shoup_kernel<true> : parent_fused_shoup_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FS_THREADS, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = static_cast<long long>(per_sm) * sms;  // persistent: a CTA walks blocks
  if (grid < 1 || grid > blocks) grid = blocks;
  const stark::Field f = stark::make_field(p_words, np);
  const int32_t* ap = static_cast<const int32_t*>(a);
  const uint4* tp = static_cast<const uint4*>(tw);
  int32_t* op = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = static_cast<unsigned>(grid);
  if (dit)
    parent_fused_shoup_kernel<true><<<g, FS_THREADS, smem, st>>>(ap, tp, op, n, log_block, canon, f);
  else
    parent_fused_shoup_kernel<false><<<g, FS_THREADS, smem, st>>>(ap, tp, op, n, log_block, canon, f);
  return static_cast<int>(cudaGetLastError());
}

// the library's kernel with the other products
#define PROBE_FUSED_SHOUP(NAME, MUL)                                                     \
  extern "C" int NAME(const void* a, const void* tw, void* out, long long n, int block,  \
                      int dit, int canon, const uint32_t* p_words, uint32_t np,          \
                      void* stream) {                                                    \
    int log_block = 0;                                                                   \
    while ((1 << log_block) < block) ++log_block;                                        \
    return static_cast<int>(launch_fused_shoup<MUL>(                                     \
        static_cast<const int32_t*>(a), static_cast<const uint4*>(tw),                   \
        static_cast<int32_t*>(out), n, log_block, dit, canon, p_words, np,               \
        static_cast<cudaStream_t>(stream)));                                             \
  }
PROBE_FUSED_SHOUP(probe_fused_shoup_chain, ShoupMulChain)
PROBE_FUSED_SHOUP(probe_fused_shoup_c, CProduct)
PROBE_FUSED_SHOUP(probe_fused_shoup_skipall, SkipAll29)
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
            f.write(PROBE.replace("// @SHOUP_PRODUCTS@", SHOUP_PRODUCTS))
        subprocess.run([_tool("nvcc"), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin",
                        "-I", build.CSRC, "-o", cubin, src], check=True)
        for kind in ("dit", "dif", "dit_canonical", "dif_canonical", "stage", "shoup_dit",
                     "shoup_dif", "shoup_dit_one", "shoup_dif_one", "shoup_dit_chain",
                     "shoup_dif_chain", "shoup_dit_c", "shoup_dif_c"):
            ops = sass_opcodes(cubin, f"sass_probe_{kind}")
            counted = {k: v for k, v in ops.items() if k not in NOT_COUNTED}
            out[kind] = {"instructions": sum(counted.values()),
                         "all_static": sum(ops.values()),
                         "top": collections.Counter(counted).most_common(8)}
    return out


def build_variants(tmp: str):
    """The probe library of the pass's variants (`VARIANTS`) and what
    `ptxas -v` said of it."""
    import ctypes

    from stark_tpu_torch.ops import build

    src, so = os.path.join(tmp, "variants.cu"), os.path.join(tmp, "libvariants.so")
    with open(src, "w") as f:
        f.write(VARIANTS)
    done = subprocess.run([_tool("nvcc"), *build.NVCC_FLAGS, "-shared", "-I", build.CSRC,
                           "-o", so, src], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on the variants:\n{done.stdout}{done.stderr}")
    log = (done.stdout + done.stderr).splitlines()
    ptxas = [" ".join(x.strip() for x in log[i : i + 4]) for i, ln in enumerate(log)
             if "Compiling entry" in ln and "pass_" in ln]
    lib = ctypes.CDLL(so)
    vp, ll, u32p = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32)
    lib.probe_pass_registers.argtypes = ([vp] * 4 + [ctypes.c_int] * 3 + [vp, ll, ll,
                                         ctypes.c_int, u32p, ctypes.c_uint32, vp])
    lib.probe_pass_tile_planes.argtypes = [vp] * 3 + [ll, ll, ctypes.c_int, u32p,
                                                      ctypes.c_uint32, vp]
    lib.probe_pass_tile_async.argtypes = [vp] * 3 + [ll, ll, ctypes.c_int, ctypes.c_int,
                                                     u32p, ctypes.c_uint32, vp]
    lib.probe_pass_wide.argtypes = [vp] * 3 + [ll, ll, ctypes.c_int, ctypes.c_int, u32p,
                                               ctypes.c_uint32, vp]
    return lib, ptxas


def pass_variants(lib, spec, big, small, x_big, x_small) -> list[dict]:
    """Each variant of the pass at the prover's passes, held against the
    plain version (`torch.equal`), timed in turns (variants in order, then
    in reverse): per pass, and the whole run of each transform's outer
    stages (`chip_smoke.median_ms`). The variants: the library's kernel
    (`tile`: a tile in shared memory, 8-byte column accesses, twiddles as
    packed words); the tile's first build (`tile_planes`: scalar accesses,
    twiddles from limb planes); one thread a group in registers, twiddles
    from the largest table's planes (`registers`, the pass's first build)
    or from each stage's own (`registers_stage_tables`)."""
    import chip_smoke
    from stark_tpu_torch.ops import build, ntt
    from stark_tpu_torch.ops import field_cuda as fc

    def call(name, fn, x, *args):
        words, np32, stream = fc.cuda_args(spec, x)
        out = torch.empty_like(x)
        i = args.index("out")
        build.check(fn(x.data_ptr(), *args[:i], out.data_ptr(), *args[i + 1:], words, np32,
                       stream), name)
        return out

    records = []
    for kind, x, plan in (("dit", x_big, big), ("dif", x_small, small)):
        n = x.shape[1]
        tables = {l: tw for (_, l, tw) in plan.singles}
        for l0, r, tw_words in plan.passes:
            if r != 3:  # the variants are built for 3 stages
                continue
            top = tables[l0 << 2]
            own = [tables[l0 << s].data_ptr() for s in range(3)]
            want = ntt.butterfly_pass_plain(spec, x, tw_words, l0, r, kind)
            dit = int(kind == "dit")
            variants = {
                "tile": lambda: ntt.butterfly_pass(spec, x, tw_words, l0, r, kind),
                "tile_planes": lambda: call("tile_planes", lib.probe_pass_tile_planes, x,
                                            top.data_ptr(), "out", n, l0, dit),
                **{f"tile_async_{c}": (lambda c=c: call(
                    "tile_async", lib.probe_pass_tile_async, x, tw_words.data_ptr(), "out", n,
                    l0, dit, c)) for c in (0, 2, 3, 4)},
                "registers": lambda: call("registers", lib.probe_pass_registers, x,
                                          *[top.data_ptr()] * 3, 2, 1, 0, "out", n, l0, dit),
                "registers_stage_tables": lambda: call(
                    "registers_stage_tables", lib.probe_pass_registers, x, *own, 0, 0, 0,
                    "out", n, l0, dit),
            }
            times = {name: [] for name in variants}
            for name, fn in variants.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"pass variant {name} [{kind} l0={l0}] != plain")
            for order in (list(variants), list(variants)[::-1]):
                for name in order:
                    times[name].append(chip_smoke.median_ms(variants[name], 10))
            records.append({"pass": f"{kind} n={n} l0={l0} r={r}", "ms": times})
            print(json.dumps(records[-1]), flush=True)
        # the yardstick of the column's bytes: a device copy, read once and written once
        y = torch.empty_like(x)
        records.append({"copy": f"(16, {n})", "bytes": 2 * x.numel() * 4,
                        "ms": chip_smoke.median_ms(lambda: y.copy_(x), 10)})
        print(json.dumps(records[-1]), flush=True)

    def run_time(fn):
        return chip_smoke.median_ms(fn, 10)

    # whole runs of the outer stages: passes of 3 and of 2 (the last shorter),
    # and the single stages
    for kind, x, plan in (("dit", x_big, big), ("dif", x_small, small)):
        want = x
        for l0, r, tw in plan.passes:
            want = ntt.butterfly_pass(spec, want, tw, l0, r, kind)
        tables = {l: tw for (_, l, tw) in plan.singles}
        twos = [(min(l for _, l, _ in c), len(c), ntt.pack_words(tables[max(l for _, l, _ in c)]))
                for c in (plan.singles[i : i + 2] for i in range(0, len(plan.singles), 2))]

        def passes(ps):
            def go():
                y = x
                for l0, r, tw in ps:
                    y = ntt.butterfly_pass(spec, y, tw, l0, r, kind)
                return y
            return go

        def stages():
            y = x
            for m, l, tw in plan.singles:
                y = ntt.butterfly_stage(spec, y, tw, m, l, kind)
            return y

        def wide(sizes):
            """The run in passes of the given numbers of stages, each pass of
            4 or 5 through the probe's build of the library's kernel."""
            ps, i = [], 0
            for r in sizes:
                run = plan.singles[i : i + r]
                i += r
                ps.append((min(l for _, l, _ in run), r,
                           ntt.pack_words(tables[max(l for _, l, _ in run)])))

            def go():
                y = x
                for l0, r, tw in ps:
                    y = (ntt.butterfly_pass(spec, y, tw, l0, r, kind) if r <= ntt.PASS_STAGES
                         else call("wide", lib.probe_pass_wide, y, tw.data_ptr(), "out",
                                   y.shape[1], l0, r, int(kind == "dit")))
                return y
            return go

        runs = {"passes_of_3": passes(plan.passes), "passes_of_2": passes(twos),
                "single_stages": stages}
        if len(plan.singles) == 9:
            runs.update({"passes_5_4": wide((5, 4)), "passes_4_5": wide((4, 5))})
        if len(plan.singles) == 6:
            runs.update({"passes_5_1": wide((5, 1)), "passes_4_2": wide((4, 2))})
        times = {name: [] for name in runs}
        for name, fn in runs.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"run {name} [{kind}] differs")
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                times[name].append(run_time(runs[name]))
        records.append({"run": f"{kind} n={x.shape[1]}", "launches": {
            "passes_of_3": len(plan.passes), "passes_of_2": len(twos),
            "single_stages": len(plan.singles), "passes_5_4": 2, "passes_4_5": 2,
            "passes_5_1": 2, "passes_4_2": 2}, "ms": times})
        print(json.dumps(records[-1]), flush=True)
    return records


def build_shoup_variants(tmp: str):
    """The probe library of `SHOUP_VARIANTS` and what `ptxas -v` said of it."""
    import ctypes

    from stark_tpu_torch.ops import build

    src, so = os.path.join(tmp, "shoup_variants.cu"), os.path.join(tmp, "libshoup_variants.so")
    with open(src, "w") as f:
        f.write(SHOUP_VARIANTS)
    done = subprocess.run([_tool("nvcc"), *build.NVCC_FLAGS, "-shared", "-I", build.CSRC,
                           "-o", so, src], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on the Shoup variants:\n{done.stdout}{done.stderr}")
    log = (done.stdout + done.stderr).splitlines()
    ptxas = [" ".join(x.strip() for x in log[i : i + 4]) for i, ln in enumerate(log)
             if "Compiling entry" in ln and "fused_shoup" in ln]
    lib = ctypes.CDLL(so)
    sig = build._SIGNATURES["stark_butterfly_fused_shoup"]
    for name in ("parent", "chain", "c", "skipall"):
        getattr(lib, f"probe_fused_shoup_{name}").argtypes = sig
    return lib, ptxas


def shoup_variants(lib, spec, x_big, x_small) -> list[dict]:
    """The fused Shoup run at block 2048 on the prover's shapes (2^20 dit and
    dif, 2^17 dif and dit), on the same canonical inputs: the library's
    kernel (`library`), the kernel before its redesign (`parent`), the
    library's with the word form's carry chains (`chain`) or field.cuh's
    product (`c_product`), and with the twiddle 1 tested in every round
    (`skip_all`), each held against
    `butterfly_fused_shoup_plain` (`torch.equal`), and row 3's kernel
    (`row3`, the Montgomery form) against `butterfly_fused_plain`; timed in
    turns, in order and then in reverse (`chip_smoke.median_ms`)."""
    import chip_smoke
    from stark_tpu_torch.ops import build, ntt
    from stark_tpu_torch.ops import field_cuda as fc

    def call(name, fn, x, tw, block, kind):
        words, np32, stream = fc.cuda_args(spec, x)
        out = torch.empty_like(x)
        build.check(fn(x.data_ptr(), tw.data_ptr(), out.data_ptr(), x.shape[1], block,
                       int(kind == "dit"), 0, words, np32, stream), name)
        return out

    precision, steps = x_big.shape[1], x_small.shape[1]
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    block = ntt.FUSED_BLOCK
    records = []
    for kind, x in (("dit", x_big), ("dif", x_big), ("dif", x_small), ("dit", x_small)):
        n = x.shape[1]
        root = g2 if n == precision else spec.inv(g1)
        stw = ntt.NttPlan(spec, root, n, "dit", x.device, block, shoup=True).fused_tw
        mtw = ntt.NttPlan(spec, root, n, "dit", x.device, block).fused_tw
        variants = {
            "library": lambda: ntt.butterfly_fused_shoup(spec, x, stw, block, kind),
            "parent": lambda: call("parent", lib.probe_fused_shoup_parent, x, stw, block, kind),
            "chain": lambda: call("chain", lib.probe_fused_shoup_chain, x, stw, block, kind),
            "c_product": lambda: call("c_product", lib.probe_fused_shoup_c, x, stw, block, kind),
            "skip_all": lambda: call("skip_all", lib.probe_fused_shoup_skipall, x, stw, block,
                                     kind),
            "row3": lambda: ntt.butterfly_fused(spec, x, mtw, block, kind),
        }
        want = ntt.butterfly_fused_shoup_plain(spec, x, stw, block, kind)
        for name, fn in variants.items():
            ref = ntt.butterfly_fused_plain(spec, x, mtw, block, kind) if name == "row3" else want
            if not torch.equal(fn(), ref):
                raise AssertionError(f"fused Shoup variant {name} [{kind} n={n}] != plain")
        times = {name: [] for name in variants}
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                times[name].append(chip_smoke.median_ms(variants[name], 10))
        records.append({"fused_shoup": f"{kind} n={n} block={block}", "ms": times})
        print(json.dumps(records[-1]), flush=True)
    return records


def kernel_code(csrc: str, tmp: str, tag: str,
                pattern: str = r"butterfly_(fused|pass)_kernel") -> dict:
    """The SASS of each kernel of `csrc/ntt.cu` whose (mangled) name matches
    `pattern`, built as the library builds it: instructions and encodings as
    `cuobjdump -sass` lists them, addresses dropped (`mmul_repeat_cuda.py`'s
    comparison of `mmul_kernel`)."""
    from stark_tpu_torch.ops import build

    cubin = os.path.join(tmp, f"ntt_{tag}.cubin")
    subprocess.run([_tool("nvcc"), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin", "-I", csrc,
                    "-o", cubin, os.path.join(csrc, "ntt.cu")],
                   check=True, capture_output=True, text=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    code, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            # the anonymous namespace's id in a mangled name hashes the file
            name = (re.sub(r"\d+_GLOBAL__N__\w+?_ntt_cu_[0-9a-f]{8}", "(anonymous)", m.group(1))
                    if re.search(pattern, m.group(1)) else None)
            if name:
                code[name] = []
        elif name:
            code[name] += re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", ln)
            code[name] += re.findall(r"/\* (0x[0-9a-f]{16}) \*/", ln)
    return code


def same_code(other_csrc: str) -> dict:
    """Row 2's and row 3's kernels (`butterfly_pass_kernel`,
    `butterfly_fused_kernel`, every build) here and in another tree's
    `csrc`: each kernel's SASS, and whether the two are equal."""
    from stark_tpu_torch.ops import build

    with tempfile.TemporaryDirectory() as tmp:
        here, other = kernel_code(build.CSRC, tmp, "here"), kernel_code(other_csrc, tmp, "other")
    return {"kernels": {name: {"instructions_here": len(code),
                               "instructions_other": len(other.get(name, [])),
                               "equal": code == other.get(name)}
                        for name, code in sorted(here.items())},
            "equal": bool(here) and here == other}


def kernel_instructions(library: str, pattern: str = "butterfly_(fused|pass)") -> dict:
    """SASS instructions of each kernel of a built library whose (mangled)
    name matches `pattern`, as `cuobjdump -sass` lists them, all opcodes
    counted: the same count for two builds means the same code."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                out[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", ln):
            out[name] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/ntt_kernels.json")
    ap.add_argument("--library", action="append", default=[],
                    help="also count the SASS of this library's butterfly_fused and "
                         "butterfly_pass kernels "
                         "(another build, such as a parent commit's); repeatable")
    ap.add_argument("--other-csrc", help="another tree's stark_tpu_torch/csrc (e.g. the "
                    "parent's `git archive`): compare butterfly_fused_kernel's and "
                    "butterfly_pass_kernel's SASS with it")
    ap.add_argument("--shoup-only", action="store_true",
                    help="after the build and the SASS counts, only the Shoup cases and the "
                         "fused Shoup variants")
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

    def write(records, failed):
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "ntt_kernels.json"), "w") as f:
                json.dump(records, f, indent=1)
        return int(failed)

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
    failed = False
    if args.other_csrc:
        records.append({"same_code_as_other": same_code(args.other_csrc)})
        print(json.dumps(records[-1]), flush=True)
        failed |= not records[-1]["same_code_as_other"]["equal"]

    steps, precision = 1 << 17, 1 << 20
    rng = np.random.default_rng(chip_smoke.SEED)
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    big = ntt.NttPlan(spec, g2, precision, "dit", "cuda")
    small = ntt.NttPlan(spec, spec.inv(g1), steps, "dif", "cuda")
    x_big = chip_smoke.random_planes(rng, spec, precision, "cuda")
    x_small = chip_smoke.random_planes(rng, spec, steps, "cuda")
    # the Shoup forms: chip_smoke's cases, then the fused run's variants
    shoup = chip_smoke.compare_shoup(spec, g2, spec.inv(g1), precision, steps, "cuda")
    for name, result in shoup.items():
        chip_smoke.add_bounds(result, sm_hz)
        for label, case in result["cases"].items():
            records.append({"kernel": name, "case": label, **case})
            print(json.dumps(records[-1]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        slib, sptxas = build_shoup_variants(tmp)
        records.append({"shoup_variants_ptxas": sptxas})
        print(json.dumps(records[-1]), flush=True)
        records += shoup_variants(slib, spec, x_big, x_small)
    if args.shoup_only:
        return write(records, failed)

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

    result = chip_smoke.compare_pass(spec, big, small, x_big, x_small)
    chip_smoke.add_bounds(result, sm_hz)
    for label, case in result["cases"].items():
        # "[edges |short |bls12_381 ]kind n=... l0=... r=..."
        *pre, kind, n, _, r = label.split()
        canonical = bool(pre) and pre[0].startswith("bls12_381")
        butterflies = int(r[2:]) * int(n[2:]) // 2
        case["floor_ms"] = (instr[f"{kind}_canonical" if canonical else kind]["instructions"]
                            * butterflies / (ISSUE_PER_CLOCK * sms * sm_hz) * 1e3)
        records.append({"kernel": "butterfly_pass", "case": label, **case})
        print(json.dumps(records[-1]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        lib, vptxas = build_variants(tmp)
        records.append({"variants_ptxas": vptxas})
        print(json.dumps(records[-1]), flush=True)
        records += pass_variants(lib, spec, big, small, x_big, x_small)
    return write(records, failed)


if __name__ == "__main__":
    sys.exit(main())
