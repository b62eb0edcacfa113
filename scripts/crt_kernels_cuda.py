#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernel library and hold the three kernels of
the CRT LDE engine (`stark_tpu_torch/csrc/crt.cu`: `residues_in`,
`matmul_fold`, `reconstruct`) against their plain PyTorch versions on one
NVIDIA GPU, without the rest of `chip_smoke.py`.

    python3 scripts/crt_kernels_cuda.py [--out DIR] [--log-steps 17]

It runs `chip_smoke.phase_crt_kernels` alone: the engine's tables for
(steps, 8 * steps) are built (or loaded from the plan cache under
`stark_tpu_torch/_build/plans`), each kernel runs the four products of one
LDE and the small ragged shapes, and every output must equal the plain
version's (`torch.equal`). Printed: the card's name and power limit, what
`ptxas -v` said of the three kernels (registers, spills, shared memory),
and one JSON line per kernel and case with its median device time, the
plain version's, the bound and, for `matmul_fold`, the four bf16
`torch.bmm` of the same digit planes. Then one column's LDE runs on both
engines (`ops/ntt.py make_best_lde`) and must give equal planes; its
median device time on each is printed. With `--log-steps 18` or 19 the big
transform takes the three-level plan (precision 2^21, 2^22): the kernels'
cases, which are the two-level plan's, are skipped and only that LDE runs.
Printed first: `ptxas -v`'s lines and the static SASS instruction count
(`cuobjdump -sass`) of the three kernels.
With `--probe` it then builds `PROBE` below, which includes `crt.cu`, and
times its variants of `residues_in` (with pre-table) and `reconstruct` at
the main-path cases, (16, 1024, 1024) and (57, 2^20), each with the blocks
an SM it takes: in full, memory only (loads and stores, a trivial combine
for the products and the epilogue) and compute only (products, epilogue and
stores on values made in registers), with the loads straight into
registers, through two cp.async stages a warp in shared memory, or after
an L2 prefetch of the next tile; the direct kernels built for at least 5
and 6 blocks an SM; `residues_in` with its first Barrett step left without
the subtraction and with the next prime tile's pre-table loaded ahead;
`reconstruct` with a thread loading its own lane's rows (the digit words
handed on through shared memory) and with the packing between its loads;
the library's own two kernels launched from the probe. Then `residues_in`'s
bytes alone, in 16-byte chunks in address order at tiles of 16, 32 and 64
lanes, and a device copy of as many bytes (`Tensor.copy_`): the bandwidth
this card reaches. Every full variant must equal the library's output
(`torch.equal`).
The quick check after a change to `crt.cu`; needs `nvcc` and a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def one_lde(spec, steps: int, precision: int) -> dict:
    """One random Montgomery column extended on both engines: equal planes,
    the set-up seconds of each engine (tables, plans) and the median device
    time of one LDE on each."""
    import numpy as np

    import chip_smoke
    from stark_tpu_torch.ops import ntt

    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    trace = chip_smoke.random_planes(np.random.default_rng(chip_smoke.SEED), spec, steps,
                                     "cuda")
    out = {"lde": f"{steps} -> {precision}"}
    planes = {}
    for engine in ntt.LDE_ENGINES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        lde = ntt.make_best_lde(spec, g1, g2, steps, precision, "cuda", engine)
        planes[engine] = lde(trace)
        torch.cuda.synchronize()
        out[f"{engine}_setup_s"] = time.time() - t0
        out[f"{engine}_ms"] = chip_smoke.median_ms(lambda: lde(trace), 10)
        out[f"{engine}_peak_bytes"] = torch.cuda.max_memory_allocated()
    if not torch.equal(planes["butterfly"], planes["crt"]):
        raise AssertionError("the two engines' LDEs differ")
    return out


PROBE = r'''// Probe kernels beside the library's (this file includes csrc/crt.cu), at
// residues_in with a pre-table (B % 4 == 0) and reconstruct. LOADS: DIRECT,
// straight into registers (residues_in: the library's order; reconstruct:
// each fragment register's four loads, then its packing); STAGED, through
// two cp.async stages a warp in shared memory; PREFETCH, straight into
// registers after an L2 prefetch of the warp's next tile or round; ROWS
// (reconstruct), a thread loading its own lane's rows and handing the digit
// words on through shared memory; AHEAD, all of a round's loads before any
// packing (reconstruct: the library's order) or the next prime tile's
// pre-table words loaded a tile ahead (residues_in); LIBRARY, the library's
// kernel. MODE: FULL, the kernel; MEM, its loads and stores with a trivial
// combine in place of the tensor-core products and the epilogue; COMP, its
// products, epilogue and stores on values made in registers in place of the
// loads.
#include "crt.cu"

namespace {

constexpr int FULL = 0, MEM = 1, COMP = 2;
constexpr int DIRECT = 0, STAGED = 1, PREFETCH = 2;
constexpr int ROWS = 3;  // reconstruct: a thread its own lane's rows, digit words handed on
constexpr int LIBRARY = 8;  // the library's kernel, launched from here
constexpr int AHEAD = 4;  // all of a round's loads (reconstruct) or the next prime tile's
                          // pre-table words (residues_in) issued before the arithmetic

// `BYTES` (4, 8 or 16) from global to shared memory without registers,
// zeros where !ok (the source is then not read); completion per thread.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(ok ? BYTES : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// residues_in's shared memory: the table, then (STAGED) two stages a warp
__host__ __device__ constexpr int rin_table_bytes(int mtiles) {
  return 16 * mtiles * TABLE_ROW * 4;
}
__host__ __device__ constexpr int rin_stage_bytes(int mtiles) {
  return 8 * 32 * 16 + mtiles * 8 * 32 * 8;
}
constexpr int REC_SLOTS = 65;  // words a lane stages a round: 64 residues and s_r

template <int MODE, int LOADS, int MINB = 1, bool LITE = false>
__global__ void __launch_bounds__(RIN_THREADS, MINB)
rin_probe(const int32_t* __restrict__ x, const int32_t* __restrict__ table,
          const int16_t* __restrict__ pre, int32_t* __restrict__ o0,
          int32_t* __restrict__ o1, int p1, int64_t K, int64_t K4, int64_t B,
          int64_t tiles_b, int64_t tiles) {
  extern __shared__ __align__(16) uint8_t rin_smem[];
  const int mtiles = (p1 + 15) / 16;
  int32_t* tab = reinterpret_cast<int32_t*>(rin_smem);
  for (int i = threadIdx.x; i < 16 * mtiles * TABLE_ROW; i += blockDim.x)
    tab[i] = i < p1 * TABLE_ROW ? table[i] : 0;
  __syncthreads();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int c = g / 2, par = g % 2;
  const int warps = blockDim.x / 32;
  const int64_t n = K * B, first = static_cast<int64_t>(blockIdx.x) * warps + threadIdx.x / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  const int stage_bytes = rin_stage_bytes(mtiles);
  uint8_t* stages = rin_smem + rin_table_bytes(mtiles) + (threadIdx.x / 32) * 2 * stage_bytes;
  auto xs = [&](int st) { return reinterpret_cast<int4*>(stages + st * stage_bytes); };
  auto ps = [&](int st) {
    return reinterpret_cast<uint2*>(stages + st * stage_bytes + 8 * 32 * 16);
  };
  auto xaddr = [&](int64_t k4, int64_t b0, int j, int r) {
    return x + (2 * (t + 4 * r) + par) * n + (4 * k4 + j) * B + b0 + 4 * c;
  };
  auto paddr = [&](int64_t k4, int64_t b0, int i, int j) {
    return pre + (static_cast<int64_t>(i) * K + 4 * k4 + j) * B + b0 + 4 * t;
  };
  // the 8 pre-table words of prime tile mt: [j][prime][word]
  auto load_pw = [&](int64_t k4, int64_t b0, int mt, uint32_t (&w)[4][2][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int i = 16 * mt + g + 8 * pr;
        int2 u = make_int2(0, 0);
        if (i < p1 && 4 * k4 + j < K && b0 + 4 * t < B)
          u = *reinterpret_cast<const int2*>(paddr(k4, b0, i, j));
        w[j][pr][0] = u.x, w[j][pr][1] = u.y;
      }
  };
  auto issue = [&](int64_t tile, int st) {
    const int64_t k4 = tile / tiles_b, b0 = (tile % tiles_b) * RIN_TB;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool ok = 4 * k4 + j < K && b0 + 4 * c < B;
        cp_async_zfill<16>(xs(st) + (2 * j + r) * 32 + lane, ok ? xaddr(k4, b0, j, r) : x, ok);
      }
    for (int mt = 0; mt < mtiles; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          const int i = 16 * mt + g + 8 * pr;
          const bool ok = i < p1 && 4 * k4 + j < K && b0 + 4 * t < B;
          cp_async_zfill<8>(ps(st) + ((mt * 4 + j) * 2 + pr) * 32 + lane,
                            ok ? paddr(k4, b0, i, j) : pre, ok);
        }
    cp_async_commit();
  };
  if (LOADS == STAGED && MODE != COMP && first < tiles) issue(first, 0);
  int st = 0;
  for (int64_t tile = first; tile < tiles; tile += stride, st ^= 1) {
    const int64_t k4 = tile / tiles_b, b0 = (tile % tiles_b) * RIN_TB;
    if (LOADS == STAGED && MODE != COMP) {
      if (tile + stride < tiles) issue(tile + stride, st ^ 1); else cp_async_commit();
      cp_async_wait<1>();
    }
    if (LOADS == PREFETCH && MODE != COMP && tile + stride < tiles) {
      const int64_t nk4 = (tile + stride) / tiles_b, nb0 = ((tile + stride) % tiles_b) * RIN_TB;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (4 * nk4 + j < K) prefetch_l2(xaddr(nk4, nb0, j, r));
      for (int mt = 0; mt < mtiles; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            const int i = 16 * mt + g + 8 * pr;
            if (i < p1 && 4 * nk4 + j < K) prefetch_l2(paddr(nk4, nb0, i, j));
          }
    }
    uint32_t pw_next[4][2][2];  // AHEAD
    uint32_t bf[4][2][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t v[4];
        if (MODE == COMP) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = (static_cast<uint32_t>(tile) * 40503u + lane * 977u + j * 31u + r * 7u + e) &
                   0xFFFFu;
        } else if (LOADS == STAGED) {
          const int4 u = xs(st)[(2 * j + r) * 32 + lane];
          v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
        } else {
          int4 u = make_int4(0, 0, 0, 0);
          if (4 * k4 + j < K && b0 + 4 * c < B)
            u = *reinterpret_cast<const int4*>(xaddr(k4, b0, j, r));
          v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
        }
        const uint32_t send = ((par ? v[0] : v[1]) & 0xFFFFu) | ((par ? v[2] : v[3]) << 16);
        const uint32_t recv = __shfl_xor_sync(0xFFFFFFFFu, send, 4);
        bf[j][0][r] = par ? (recv & 0xFFFFu) | (v[1] << 16) : (v[0] & 0xFFFFu) | (recv << 16);
        bf[j][1][r] = par ? (recv >> 16) | (v[3] << 16) : (v[2] & 0xFFFFu) | (recv & 0xFFFF0000u);
      }
    for (int mt = 0; mt < mtiles; ++mt) {
      const int i0 = 16 * mt + g, i1 = i0 + 8;
      const int32_t* r0 = tab + i0 * TABLE_ROW;
      const int32_t* r1 = tab + i1 * TABLE_ROW;
      const uint32_t a0[4] = {static_cast<uint32_t>(r0[t]), static_cast<uint32_t>(r1[t]),
                              static_cast<uint32_t>(r0[t + 4]), static_cast<uint32_t>(r1[t + 4])};
      const uint32_t a1[4] = {static_cast<uint32_t>(r0[NW + t]), static_cast<uint32_t>(r1[NW + t]),
                              static_cast<uint32_t>(r0[NW + t + 4]),
                              static_cast<uint32_t>(r1[NW + t + 4])};
      const uint32_t q[2] = {static_cast<uint32_t>(r0[16]), static_cast<uint32_t>(r1[16])};
      const uint32_t m[2] = {static_cast<uint32_t>(r0[17]), static_cast<uint32_t>(r1[17])};
      // pre-table words of the prime tile, all loaded before its products
      // (AHEAD: those of the next prime tile too, into pw_next)
      uint32_t pw[4][2][2];  // [j][prime][word]
      if (LOADS == AHEAD && MODE != COMP) {
        if (mt == 0) load_pw(k4, b0, 0, pw_next);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) pw[j][pr][0] = pw_next[j][pr][0], pw[j][pr][1] = pw_next[j][pr][1];
        if (mt + 1 < mtiles) load_pw(k4, b0, mt + 1, pw_next);
      } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          const int i = pr ? i1 : i0;
          if (MODE == COMP) {
            pw[j][pr][0] = (static_cast<uint32_t>(tile) * 2654435761u + lane * 13u + j) &
                           0x1FFF1FFFu;
            pw[j][pr][1] = pw[j][pr][0] ^ 0x01230321u;
          } else if (LOADS == STAGED) {
            const uint2 u = ps(st)[((mt * 4 + j) * 2 + pr) * 32 + lane];
            pw[j][pr][0] = u.x, pw[j][pr][1] = u.y;
          } else {
            int2 u = make_int2(0, 0);
            if (i < p1 && 4 * k4 + j < K && b0 + 4 * t < B)
              u = *reinterpret_cast<const int2*>(paddr(k4, b0, i, j));
            pw[j][pr][0] = u.x, pw[j][pr][1] = u.y;
          }
        }
      }
      uint32_t w0[2][4] = {}, w1[2][4] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (MODE == MEM) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w0[e / 2][2 * h + e % 2] ^= bf[j][h][e % 2] ^ pw[j][e / 2][h];
            continue;
          }
          int d0[4] = {static_cast<int>(q[0] << QBITS), static_cast<int>(q[0] << QBITS),
                       static_cast<int>(q[1] << QBITS), static_cast<int>(q[1] << QBITS)};
          int d1[4] = {0, 0, 0, 0};
          mma_s8u8(d0, a0, bf[j][h][0], bf[j][h][1]);
          mma_s8u8(d1, a1, bf[j][h][0], bf[j][h][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pr = e / 2, col = e % 2;
            const uint32_t v = static_cast<uint32_t>(d0[e]) + 128u * static_cast<uint32_t>(d1[e]);
            // LITE: v mod q up to one q (< 2q), enough for the product below
            uint32_t r = LITE ? v - __umulhi(v, m[pr]) * q[pr] : barrett(v, q[pr], m[pr]);
            const uint32_t tw = pw[j][pr][h];
            r = barrett(r * (col ? tw >> 16 : tw & 0xFFFFu), q[pr], m[pr]);
            w0[pr][2 * h + col] |= (r & 127u) << (8 * j);
            w1[pr][2 * h + col] |= (r >> 7) << (8 * j);
          }
        }
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int i = pr ? i1 : i0;
        if (i < p1) {
          const int64_t o = (static_cast<int64_t>(i) * K4 + k4) * B;
          store4<true>(o0 + o, b0 + 4 * t, B, w0[pr]);
          store4<true>(o1 + o, b0 + 4 * t, B, w1[pr]);
        }
      }
    }
  }
  if (LOADS == STAGED) cp_async_wait<0>();
}

template <int MODE, int LOADS, int MINB = 1>
__global__ void __launch_bounds__(REC_THREADS, MINB)
rec_probe(const int32_t* __restrict__ s, const int4* __restrict__ frags,
          int32_t* __restrict__ out, int P, int64_t n, int64_t rounds,
          uint32_t qr, uint32_t mr, uint32_t minv, NegMDigits negm, Field f) {
  extern __shared__ __align__(16) int32_t rec_smem[];
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warps = blockDim.x / 32;
  // STAGED: two stages a warp, the sums in the one just read; else one
  // region a warp for the sums
  int32_t* stages =
      rec_smem + (threadIdx.x / 32) * (LOADS == STAGED ? 2 * REC_SLOTS * 32 : 32 * REC_STRIDE);
  auto stage = [&](int st) { return stages + (LOADS == STAGED ? st : 0) * REC_SLOTS * 32; };
  auto issue = [&](int64_t round, int st) {
    const int64_t l0 = round * 32;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 16; ++v) {
        const int prime = 32 * (v / 8) + 16 * (v / 4 % 2) + 4 * t + v % 4;
        const int64_t col = l0 + 8 * nt + g;
        const bool ok = prime < P && col < n;
        cp_async_zfill<4>(stage(st) + (16 * nt + v) * 32 + lane, ok ? s + prime * n + col : s,
                          ok);
      }
    const bool ok = l0 + lane < n;
    cp_async_zfill<4>(stage(st) + 64 * 32 + lane, ok ? s + P * n + l0 + lane : s, ok);
    cp_async_commit();
  };
  uint32_t a[REC_MT][REC_KS][4];
#pragma unroll
  for (int mt = 0; mt < REC_MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < REC_KS; ++ks) {
      const int4 v = frags[(mt * REC_KS + ks) * 32 + lane];
      a[mt][ks][0] = v.x, a[mt][ks][1] = v.y, a[mt][ks][2] = v.z, a[mt][ks][3] = v.w;
    }
  const int64_t first = static_cast<int64_t>(blockIdx.x) * warps + threadIdx.x / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  if (LOADS == STAGED && MODE != COMP && first < rounds) issue(first, 0);
  int st = 0;
  for (int64_t round = first; round < rounds; round += stride, st ^= 1) {
    const int64_t l0 = round * 32;
    if (LOADS == STAGED && MODE != COMP) {
      if (round + stride < rounds) issue(round + stride, st ^ 1); else cp_async_commit();
      cp_async_wait<1>();
    }
    if (LOADS == PREFETCH && MODE != COMP && round + stride < rounds) {
      // the next round's 128-byte line of each residue row
      const int64_t nl0 = (round + stride) * 32;
      for (int row = lane; row <= P; row += 32) prefetch_l2(s + row * n + nl0);
    }
    int32_t* sh = stage(st);
    uint32_t b[4][2][REC_KS][2];
    if (LOADS == ROWS) {
      // lane l0 + lane's residues, a 128-byte line of each row an instruction,
      // packed as digit words: primes 32ks + 16r + 4u .. + 3 to word
      // 8u + 2(2ks + r) + plane of the lane's 36, read back by thread (g, t = u)
      const int64_t l = l0 + lane;
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int ks = 0; ks < REC_KS; ++ks) {
          uint32_t w[4];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            uint32_t v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int prime = 32 * ks + 16 * r + 4 * u + i;
              v[i] = prime < P && l < n ? s[prime * n + l] : 0;
            }
            const uint32_t u02 = v[0] | (v[2] << 16), u13 = v[1] | (v[3] << 16);
            w[2 * r] = (u02 & 0x007F007Fu) | ((u13 & 0x007F007Fu) << 8);
            w[2 * r + 1] = ((u02 >> 7) & 0x007F007Fu) | (((u13 >> 7) & 0x007F007Fu) << 8);
          }
          *reinterpret_cast<uint4*>(sh + lane * 36 + 8 * u + 4 * ks) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int ks = 0; ks < REC_KS; ++ks) {
          const uint4 w =
              *reinterpret_cast<const uint4*>(sh + (8 * nt + g) * 36 + 8 * t + 4 * ks);
          b[nt][0][ks][0] = w.x, b[nt][1][ks][0] = w.y, b[nt][0][ks][1] = w.z,
          b[nt][1][ks][1] = w.w;
        }
    } else if (LOADS == AHEAD) {
      uint32_t raw[4][REC_KS][2][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int ks = 0; ks < REC_KS; ++ks)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int prime = 32 * ks + 16 * r + 4 * t + i;
              const int64_t col = l0 + 8 * nt + g;
              raw[nt][ks][r][i] = prime < P && col < n ? s[prime * n + col] : 0;
            }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int ks = 0; ks < REC_KS; ++ks)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t* v = raw[nt][ks][r];
            const uint32_t u02 = v[0] | (v[2] << 16), u13 = v[1] | (v[3] << 16);
            b[nt][0][ks][r] = (u02 & 0x007F007Fu) | ((u13 & 0x007F007Fu) << 8);
            b[nt][1][ks][r] = ((u02 >> 7) & 0x007F007Fu) | (((u13 >> 7) & 0x007F007Fu) << 8);
          }
    } else {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int ks = 0; ks < REC_KS; ++ks)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int prime = 32 * ks + 16 * r + 4 * t + i;
            const int64_t col = l0 + 8 * nt + g;
            if (MODE == COMP)
              v[i] = (static_cast<uint32_t>(col) * 2654435761u + prime * 97u) % 15000u;
            else if (LOADS == STAGED)
              v[i] = sh[(16 * nt + 8 * ks + 4 * r + i) * 32 + lane];
            else
              v[i] = prime < P && col < n ? s[prime * n + col] : 0;
          }
          const uint32_t u02 = v[0] | (v[2] << 16), u13 = v[1] | (v[3] << 16);
          b[nt][0][ks][r] = (u02 & 0x007F007Fu) | ((u13 & 0x007F007Fu) << 8);
          b[nt][1][ks][r] = ((u02 >> 7) & 0x007F007Fu) | (((u13 >> 7) & 0x007F007Fu) << 8);
        }
    }
    int32_t s_r;  // (the library: after the loads, before the first __syncwarp)
    if (MODE == COMP)
      s_r = static_cast<int32_t>((l0 + lane) % 15000);
    else if (LOADS == STAGED)
      s_r = sh[64 * 32 + lane];
    else
      s_r = l0 + lane < n ? s[P * n + l0 + lane] : 0;
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < REC_MT; ++mt) {
        int d0[4] = {0, 0, 0, 0}, d1[4] = {0, 0, 0, 0};
        if (MODE == MEM) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d0[e] = b[nt][0][e % 2][e / 2] ^ b[nt][1][e % 2][e / 2] ^ a[mt][0][e];
        } else {
#pragma unroll
          for (int ks = 0; ks < REC_KS; ++ks) {
            mma_s8u8(d0, a[mt][ks], b[nt][0][ks][0], b[nt][0][ks][1]);
            mma_s8u8(d1, a[mt][ks], b[nt][1][ks][0], b[nt][1][ks][1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + 8 * (e / 2);
          if (row < ND + 2) sh[(8 * nt + 2 * t + e % 2) * REC_STRIDE + row] = d0[e] + 128 * d1[e];
        }
      }
    __syncwarp();
    int32_t es[ND + 2];
#pragma unroll
    for (int v = 0; v < 9; ++v) {
      const int4 w = *reinterpret_cast<const int4*>(sh + lane * REC_STRIDE + 4 * v);
      es[4 * v] = w.x, es[4 * v + 1] = w.y, es[4 * v + 2] = w.z, es[4 * v + 3] = w.w;
    }
    es[ND + 1] = sh[lane * REC_STRIDE + ND + 1];
    if (LOADS == STAGED) __syncwarp();  // read: the stage takes the copies two rounds on
    const int64_t l = l0 + lane;
    if (l < n) {
      if (MODE == MEM) {
#pragma unroll
        for (int i = 0; i < 16; ++i) out[i * n + l] = es[i] ^ es[i + 16] ^ s_r;
      } else {
        reconstruct_lane(es, s_r, qr, mr, minv, negm, f, out, n, l);
      }
    }
  }
  if (LOADS == STAGED) cp_async_wait<0>();
}

// The bytes of residues_in with pre-table, tile by tile (4 rows k x TBW lanes
// b), each warp's loads and stores cut into 16-byte chunks in address order
// (32 consecutive chunks an instruction): the floor of the data layout at
// that tile width, whatever the fragments want. No arithmetic.
template <int TBW>
__global__ void __launch_bounds__(128)
rin_bytes_probe(const int32_t* __restrict__ x, const int16_t* __restrict__ pre,
                int32_t* __restrict__ o0, int p1, int64_t K, int64_t B, int64_t tiles) {
  const int lane = threadIdx.x % 32;
  const int64_t tiles_b = B / TBW, n = K * B, K4 = K / 4;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * 4 + threadIdx.x / 32;
  for (int64_t tile = first; tile < tiles; tile += static_cast<int64_t>(gridDim.x) * 4) {
    const int64_t k4 = tile / tiles_b, b0 = (tile % tiles_b) * TBW;
    int4 acc = make_int4(0, 0, 0, 0);
    constexpr int XC = TBW / 4;  // 16-byte chunks of one x row
    for (int e = lane; e < 64 * XC; e += 32) {  // (plane, row j) x chunk
      const int pair = e / XC, ch = e % XC;
      const int4 v = *reinterpret_cast<const int4*>(
          x + (pair / 4) * n + (4 * k4 + pair % 4) * B + b0 + 4 * ch);
      acc.x ^= v.x, acc.y ^= v.y, acc.z ^= v.z, acc.w ^= v.w;
    }
    constexpr int PC = TBW / 8;  // 16-byte chunks of one pre-table row
    for (int e = lane; e < p1 * 4 * PC; e += 32) {  // (prime, row j) x chunk
      const int pair = e / PC, ch = e % PC;
      const int4 v = *reinterpret_cast<const int4*>(
          pre + (static_cast<int64_t>(pair / 4) * K + 4 * k4 + pair % 4) * B + b0 + 8 * ch);
      acc.x ^= v.x, acc.y ^= v.y, acc.z ^= v.z, acc.w ^= v.w;
    }
    for (int e = lane; e < 2 * p1 * XC; e += 32) {  // (plane, prime) x chunk
      const int pair = e / XC, ch = e % XC;
      *reinterpret_cast<int4*>(o0 + (static_cast<int64_t>(pair) * K4 + k4) * B + b0 + 4 * ch) =
          acc;
    }
  }
}

template <typename Kernel>
int occupancy(Kernel k, int threads, size_t shared) {
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, threads, shared);
  return b;
}

}  // namespace

#define PROBE_CASES(K)                                                                 \
  K(FULL, DIRECT) K(FULL, STAGED) K(FULL, PREFETCH) K(MEM, DIRECT) K(MEM, STAGED)      \
  K(MEM, PREFETCH) K(COMP, DIRECT) K(COMP, STAGED)
#define RIN_CASE(M, L) \
  if (mode == M && loads == L) kern = rin_probe<M, L>;
#define REC_CASE(M, L) \
  if (mode == M && loads == L) kern = rec_probe<M, L>;
// the direct kernels under other builds: `build` 5 or 6, at least that many
// blocks an SM (__launch_bounds__); 7, residues_in's first Barrett step
// without its subtraction; 3 (reconstruct), the ROWS loads

// residues_in's launch with probe kernel (mode, loads); pre non-null, B % 4 == 0
extern "C" int probe_rin(int mode, int loads, const void* x, const void* table, const void* pre,
                         void* o0, void* o1, int p1, long long K, long long B, int* blocks_per_sm,
                         void* stream) {
  void (*kern)(const int32_t*, const int32_t*, const int16_t*, int32_t*, int32_t*, int, int64_t,
               int64_t, int64_t, int64_t, int64_t) = nullptr;
  PROBE_CASES(RIN_CASE)
  if (mode == FULL && loads == 5) kern = rin_probe<FULL, DIRECT, 5>;
  if (mode == FULL && loads == 6) kern = rin_probe<FULL, DIRECT, 6>;
  if (mode == FULL && loads == 7) kern = rin_probe<FULL, DIRECT, 1, true>;
  if (mode == FULL && loads == AHEAD) kern = rin_probe<FULL, AHEAD>;
  if (mode == FULL && loads == LIBRARY) kern = residues_in_kernel<true, true>;
  if (mode == MEM && loads == AHEAD) kern = rin_probe<MEM, AHEAD>;
  if (kern == nullptr || B % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long K4 = (K + 3) / 4, tiles_b = (B + RIN_TB - 1) / RIN_TB, tiles = K4 * tiles_b;
  const int mtiles = (p1 + 15) / 16;
  const size_t shared =
      rin_table_bytes(mtiles) + (loads == STAGED ? RIN_WARPS * 2 * rin_stage_bytes(mtiles) : 0);
  *blocks_per_sm = occupancy(kern, RIN_THREADS, shared);
  kern<<<resident_grid(kern, RIN_THREADS, shared, tiles), RIN_THREADS, shared,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(table),
      static_cast<const int16_t*>(pre), static_cast<int32_t*>(o0), static_cast<int32_t*>(o1),
      p1, K, K4, B, tiles_b, tiles);
  return static_cast<int>(cudaGetLastError());
}

// rin_bytes_probe<tbw>; o0 holds (2 p1, K/4, B) words; K % 4 == 0, B % tbw == 0
extern "C" int probe_rin_bytes(int tbw, const void* x, const void* pre, void* o0, int p1,
                               long long K, long long B, int* blocks_per_sm, void* stream) {
  void (*kern)(const int32_t*, const int16_t*, int32_t*, int, int64_t, int64_t, int64_t) =
      tbw == 16 ? rin_bytes_probe<16> : tbw == 32 ? rin_bytes_probe<32>
      : tbw == 64 ? rin_bytes_probe<64> : nullptr;
  if (kern == nullptr || K % 4 || B % tbw) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = K / 4 * (B / tbw);
  *blocks_per_sm = occupancy(kern, 128, 0);
  kern<<<resident_grid(kern, 128, 0, tiles), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int16_t*>(pre),
      static_cast<int32_t*>(o0), p1, K, B, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_rec(int mode, int loads, const void* s, const void* frags, void* out,
                         int P, long long n, uint32_t qr, uint32_t minv, const int32_t* negm_digits,
                         const uint32_t* field_words, uint32_t np, int* blocks_per_sm,
                         void* stream) {
  void (*kern)(const int32_t*, const int4*, int32_t*, int, int64_t, int64_t, uint32_t, uint32_t,
               uint32_t, NegMDigits, Field) = nullptr;
  PROBE_CASES(REC_CASE)
  if (mode == FULL && loads == ROWS) kern = rec_probe<FULL, ROWS>;
  if (mode == FULL && loads == AHEAD) kern = rec_probe<FULL, AHEAD>;
  if (mode == FULL && loads == LIBRARY) kern = reconstruct_kernel;
  if (mode == MEM && loads == AHEAD) kern = rec_probe<MEM, AHEAD>;
  if (mode == MEM && loads == ROWS) kern = rec_probe<MEM, ROWS>;
  if (mode == FULL && loads == 5) kern = rec_probe<FULL, DIRECT, 5>;
  if (mode == FULL && loads == 6) kern = rec_probe<FULL, DIRECT, 6>;
  if (kern == nullptr || P > 32 * REC_KS) return static_cast<int>(cudaErrorInvalidValue);
  NegMDigits negm;
  for (int d = 0; d < ND; ++d) negm.d[d] = negm_digits[d];
  const long long rounds = (n + 31) / 32;
  const size_t shared =  // the library's kernel: static shared memory
      loads == LIBRARY ? 0
      : REC_WARPS * (loads == STAGED ? 2 * REC_SLOTS * 32 : 32 * REC_STRIDE) * sizeof(int32_t);
  *blocks_per_sm = occupancy(kern, REC_THREADS, shared);
  kern<<<resident_grid(kern, REC_THREADS, shared, rounds), REC_THREADS, shared,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s), static_cast<const int4*>(frags), static_cast<int32_t*>(out),
      P, n, rounds, qr, static_cast<uint32_t>((1ull << 32) / qr), minv, negm,
      stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}
'''

MODES = ("full", "memory only", "compute only")
LOADS = {0: "direct", 1: "staged", 2: "prefetch", 3: "rows", 4: "ahead", 8: "the library's",
         5: "direct, >= 5 blocks an SM",
         6: "direct, >= 6 blocks an SM", 7: "direct, first Barrett step without its subtraction"}
# (mode, loads) pairs the probe builds of each kernel: compute only reads
# nothing to prefetch
VARIANTS = ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (0, 5), (0, 6))
RIN_ONLY = ((0, 7),)
REC_ONLY = ((0, 3), (1, 3))
BOTH = ((0, 4), (1, 4), (0, 8))


def build_probe(tmp: str):
    """Compile `PROBE` beside `csrc/` into a shared library; returns it and
    the `ptxas -v` lines of its kernels."""
    import ctypes

    from stark_tpu_torch.ops import build

    src, so = os.path.join(tmp, "crt_probe.cu"), os.path.join(tmp, "crt_probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared", "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    u32, ip = ctypes.c_uint32, ctypes.POINTER(ctypes.c_int)
    lib.probe_rin.argtypes = [i32, i32, vp, vp, vp, vp, vp, i32, ll, ll, ip, vp]
    lib.probe_rin_bytes.argtypes = [i32, vp, vp, vp, i32, ll, ll, ip, vp]
    lib.probe_rec.argtypes = [i32, i32, vp, vp, vp, i32, ll, u32, u32,
                              ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(u32), u32, ip, vp]
    log = (proc.stdout + proc.stderr).splitlines()
    ptxas = [ln.strip() for k, ln in enumerate(log)
             if "probe" in "".join(log[max(0, k - 3): k + 1]) and
             ("Used" in ln or "spill" in ln or "Compiling entry" in ln)]
    return lib, ptxas


def run_probe(spec, steps: int, precision: int) -> list:
    """Each variant of `PROBE` at the main-path cases: its median device time,
    the blocks an SM it takes, and, for the full ones, equality with the
    library's output; then the copy yardstick."""
    import ctypes
    import tempfile

    import numpy as np

    import chip_smoke
    from stark_tpu_torch.ops import crt_cuda, mxu_ntt
    from stark_tpu_torch.ops import field_cuda as fc

    rng = np.random.default_rng(chip_smoke.SEED + 2)
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    _, big = mxu_ntt.make_lde_plans(spec, g1, g2, steps, precision, "cuda")
    basis, pre, K, B = big.basis_b, big.twiddle, big.plan_b.k, big.n1
    x = chip_smoke.with_edges(spec, chip_smoke.random_planes(rng, spec, K * B, "cuda"))
    x = x.reshape(16, K, B).contiguous()
    p1 = len(basis.qs_host)
    qs = np.asarray(basis.qs_host)[:, None]
    s = torch.from_numpy(rng.integers(0, qs, size=(p1, 1 << 20)).astype(np.int32)).cuda()
    table = basis.on("cuda")["kernel_table"]
    frags = basis.on("cuda")["rec_frags"]
    words, np32, stream = fc.cuda_args(spec, s)
    negm = basis.negm_digits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    want_rin = crt_cuda.residues_in(basis, x, pre)
    want_rec = crt_cuda.reconstruct(basis, s)
    with tempfile.TemporaryDirectory() as tmp:
        lib, ptxas = build_probe(tmp)
    records = [{"probe_ptxas": ptxas}]
    k4 = -(-K // 4)
    def rin_case(mode, loads):
        o0 = torch.empty((p1, k4, B), dtype=torch.int32, device="cuda")
        o1 = torch.empty_like(o0)
        blocks = ctypes.c_int(0)

        def rin():
            rc = lib.probe_rin(mode, loads, x.data_ptr(), table.data_ptr(), pre.data_ptr(),
                               o0.data_ptr(), o1.data_ptr(), p1, K, B, ctypes.byref(blocks),
                               stream)
            if rc:
                raise RuntimeError(f"probe_rin: CUDA error {rc}")

        rin()
        torch.cuda.synchronize()
        rec = {"kernel": "residues_in", "variant": MODES[mode], "loads": LOADS[loads],
               "case": f"(16,{K},{B}) pre, {p1} primes",
               "ms": chip_smoke.median_ms(rin, 10), "blocks_per_sm": blocks.value}
        if mode == 0:
            rec["equal"] = bool(torch.equal(o0, want_rin[0]) and torch.equal(o1, want_rin[1]))
        return rec

    def rec_case(mode, loads):
        out = torch.empty((16, s.shape[1]), dtype=torch.int32, device="cuda")
        blocks = ctypes.c_int(0)

        def recon():
            rc = lib.probe_rec(mode, loads, s.data_ptr(), frags.data_ptr(), out.data_ptr(),
                               basis.P, s.shape[1], basis.qr, basis.minv_qr, negm, words,
                               np32, ctypes.byref(blocks), stream)
            if rc:
                raise RuntimeError(f"probe_rec: CUDA error {rc}")

        recon()
        torch.cuda.synchronize()
        rec = {"kernel": "reconstruct", "variant": MODES[mode], "loads": LOADS[loads],
               "case": f"({p1},{s.shape[1]})", "ms": chip_smoke.median_ms(recon, 10),
               "blocks_per_sm": blocks.value}
        if mode == 0:
            rec["equal"] = bool(torch.equal(out, want_rec))
        return rec

    for case, variants in ((rin_case, VARIANTS + RIN_ONLY + BOTH),
                           (rec_case, VARIANTS + REC_ONLY + BOTH)):
        for mode, loads in variants:
            records.append(case(mode, loads))
            print(json.dumps(records[-1]), flush=True)
    wide = torch.empty((2 * p1, k4, B), dtype=torch.int32, device="cuda")
    for tbw in (16, 32, 64):
        blocks = ctypes.c_int(0)

        def nbytes_only():
            rc = lib.probe_rin_bytes(tbw, x.data_ptr(), pre.data_ptr(), wide.data_ptr(), p1, K,
                                     B, ctypes.byref(blocks), stream)
            if rc:
                raise RuntimeError(f"probe_rin_bytes: CUDA error {rc}")

        nbytes_only()
        records.append({"kernel": "residues_in", "variant": "bytes only, coalesced",
                        "tile_lanes": tbw, "ms": chip_smoke.median_ms(nbytes_only, 10),
                        "blocks_per_sm": blocks.value})
        print(json.dumps(records[-1]), flush=True)
    for name, nbytes in (("residues_in", 64 * K * B + 4 * p1 * K * B),
                         ("reconstruct", (4 * p1 + 64) * (1 << 20))):
        src_t = torch.empty(nbytes // 8, dtype=torch.int32, device="cuda")
        dst_t = torch.empty_like(src_t)
        records.append({"copy_of_bytes_of": name, "bytes": nbytes,
                        "ms": chip_smoke.median_ms(lambda: dst_t.copy_(src_t), 10)})
        print(json.dumps(records[-1]), flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/crt_kernels.json")
    ap.add_argument("--probe", action="store_true",
                    help="also time the probe variants of residues_in and reconstruct")
    ap.add_argument("--log-steps", type=int, default=17,
                    help="log2 of the trace length (default 17; precision is 8 times it)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("crt_kernels_cuda: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import build, plan_cache

    plan_cache.CACHE_DIR = chip_smoke.PLAN_CACHE
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    so = build.library_path()
    build.load()
    with open(os.path.join(os.path.dirname(so), "build.log")) as f:
        lines = [ln.strip() for ln in f]
    ptxas = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and any(
                k in ln for k in ("residues_in", "matmul_fold", "reconstruct")):
            ptxas.extend(lines[i : i + 4])
    import protocol_kernels_cuda as pkc

    sass = {k: v for k, v in pkc.sass_counts(so).items()
            if any(w in k for w in ("residues_in", "matmul_fold", "reconstruct"))}
    records = [{"build_s": time.time() - t0, "ptxas": ptxas, "sass_instructions": sass}]
    print(json.dumps(records[0]), flush=True)
    steps = 1 << args.log_steps
    precision = 8 * steps
    if precision <= 1 << 20:
        stats, tables_s = chip_smoke.phase_crt_kernels(spec, "cuda", steps, precision)
        records.append({"steps": steps, "precision": precision, "tables_s": tables_s})
        print(json.dumps(records[-1]), flush=True)
        for name, result in stats.items():
            chip_smoke.add_bounds(result, float(smi.split(",")[2].split()[0]) * 1e6)
            for label, case in result["cases"].items():
                records.append({"kernel": name, "case": label, **case})
                print(json.dumps(records[-1]), flush=True)
    records.append(one_lde(spec, steps, precision))
    print(json.dumps(records[-1]), flush=True)
    if args.probe:
        records.extend(run_probe(spec, steps, precision))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "crt_kernels.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
