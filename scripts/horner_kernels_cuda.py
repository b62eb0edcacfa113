#!/usr/bin/env python3
"""Measure `horner_eval` and `vanishing_eval` (`stark_tpu_torch/csrc/protocol.cu`)
before and after their redesign as grouped wide sums, every build of the
group length G, the pre-pass that forms the spans' coefficients, and what
the design's operations cost at full occupancy, on one NVIDIA GPU, without
the rest of `chip_smoke.py`.

    python3 scripts/horner_kernels_cuda.py [--out DIR] [--reps 10]

The probe source below includes `protocol.cu` and adds:
  `parent_horner_kernel`, `parent_vanishing_kernel`: the two kernels before
    the redesign, one CIOS product and one modular addition (subtraction) a
    term, from acc = 0 (R mod p);
  the kernels' templates built for G in `SWEEP` (the library builds
    `fused_kernels.GROUPS`), `horner_kernel` with G = 1 also under
    `__launch_bounds__(256, m)` for m in `MINB`;
  `horner_smem_kernel`: Horner's groups with the powers of x in dynamic
    shared memory instead of registers, for the (G, block) of `SMEM`;
  `group_vanishing_kernel`, `group_coeffs_kernel`: an earlier step of the
    vanishing product, groups of G points each valued by one wide sum and
    multiplied in by a CIOS product, their coefficients formed by a team
    of G lanes a group (the library: spans of 32 points valued by Horner in
    x^G, a warp a span);
  the cost of one operation at full occupancy: 2^20 threads, 256 a block,
    each a chain of `--chain` dependent steps of `mont_mul` (a CIOS
    product), `wide` (`mac_wide`: a 256 x 256 product summed into 17 words),
    `wide_redc` (a wide product then `redc_canonical`), `mod_sub`; the
    reduction's cost is `wide_redc` less `wide`. SM clocks a thread at the
    card's highest SM clock, the constants of `fused_kernels._COST`.
Cases, BN254's scalar field at n = 2^20 (`N`): `horner_eval` at each d of
`HORNER_D`, `vanishing_eval` at each count of `POINTS`; BLS12-381's at
n = 2^16 at d = 17, 1,062 and 17, 1,061 points; BN254's at the `bits`
golden's shape, n = 2^15 and 1,062 terms. Each case runs the parent,
every build whose G the field's bound allows (`fused_kernels.group_fits`)
and the wrapper (`kernel`: the build `horner_group`/`vanishing_group`
picks, with the pre-pass where it runs it); each output must equal the
parent's (`torch.equal`), and every variant of every case must equal the
plain version at n = 2^12 on the same coefficients or points. Each
variant's median device time over `--reps` runs, in two passes (forward,
then backward); beside it the product floor: the design's operations a
thread (`fused_kernels.horner_ops`, `vanishing_ops`; the parent's: d or
npts CIOS products and additions; the groups': `group_ops`) at this run's
measured clocks, over every SM at the highest SM clock. The pre-passes
alone at 17, 100 and 1,061 points. Printed first: the card's name and power
limit, and `ptxas -v`'s registers and spills and the resident blocks an SM
(`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) of every probe kernel.
With `--out` the records go to DIR/horner_kernels.json. Exits non-zero
without a card. Needs `nvcc`; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 20261019
N = 1 << 20
N_BLS = 1 << 16
N_BITS = 1 << 15  # the `bits` golden's precision
N_CHECK = 1 << 12
SWEEP = (1, 2, 3, 4, 6, 8, 12)  # builds of the library's templates
MINB = (6, 8)  # G = 1 under __launch_bounds__(256, m)
SMEM = ((4, 256), (8, 256), (8, 128), (12, 128), (16, 128))  # (G, block), powers in shared memory
HORNER_D = (1, 2, 3, 4, 5, 8, 9, 17, 33, 100, 1062)
POINTS = (0, 1, 2, 3, 5, 8, 9, 17, 33, 100, 1061)
BLS_CASES = ((17, 17), (1062, 1061))
COEFF_POINTS = (17, 100, 1061)
OPS = ("mont_mul", "wide", "wide_redc", "mod_sub")
THREADS_TPUT = 1 << 20

PROBE = r"""
#include "protocol.cu"

namespace {

// --- the parent kernels ------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
parent_horner_kernel(const int32_t* __restrict__ coeffs, int64_t d,
                     const int32_t* __restrict__ xs, int32_t* __restrict__ out,
                     int64_t n, Field f) {
  __shared__ uint32_t cs[SMALL_TILE][NW];
  int64_t i = global_index();
  bool live = i < n;
  uint32_t x[NW], acc[NW], t[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) acc[w] = 0;
  if (live) stark::load_elem(xs, n, i, x);
  for (int64_t hi = d; hi > 0;) {
    int count = static_cast<int>((hi - 1) % SMALL_TILE) + 1;
    int64_t base = hi - count;
    __syncthreads();
    stage_cols(coeffs, d, base, count, cs);
    __syncthreads();
    if (live) {
#pragma unroll 1
      for (int j = count - 1; j >= 0; --j) {
        stark::mont_mul(f, acc, x, t);
        stark::mod_add(f, t, cs[j], acc);
      }
    }
    hi = base;
  }
  if (live) stark::store_elem(out, n, i, acc);
}

__global__ void __launch_bounds__(THREADS)
parent_vanishing_kernel(const int32_t* __restrict__ pts, int64_t npts,
                        const int32_t* __restrict__ xs, int32_t* __restrict__ out,
                        int64_t n, Field f) {
  __shared__ uint32_t ps[SMALL_TILE][NW];
  int64_t i = global_index();
  bool live = i < n;
  uint32_t x[NW], acc[NW], t[NW], u[NW];
  stark::set_elem(acc, f.one);
  if (live) stark::load_elem(xs, n, i, x);
  for (int64_t base = 0; base < npts; base += SMALL_TILE) {
    int count = static_cast<int>(npts - base < SMALL_TILE ? npts - base : SMALL_TILE);
    __syncthreads();
    stage_cols(pts, npts, base, count, ps);
    __syncthreads();
    if (live) {
#pragma unroll 1
      for (int j = 0; j < count; ++j) {
        stark::mod_sub(f, x, ps[j], t);
        stark::mont_mul(f, acc, t, u);
        stark::set_elem(acc, u);
      }
    }
  }
  if (live) stark::store_elem(out, n, i, acc);
}

// --- the powers in shared memory ----------------------------------------------
//
// The same groups with x^1 .. x^G in dynamic shared memory, word-major (word
// w of power k of thread t at pw[(k*NW + w)*BLOCK + t]: a warp's reads are
// conflict-free), which frees 8G registers a thread for more resident warps.

template <int BLOCK>
__device__ __forceinline__ void smem_power(const uint32_t* pw, int k, uint32_t (&v)[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) v[w] = pw[(k * NW + w) * BLOCK + threadIdx.x];
}

template <int BLOCK>
__device__ __forceinline__ void smem_set(uint32_t* pw, int k, const uint32_t (&v)[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) pw[(k * NW + w) * BLOCK + threadIdx.x] = v[w];
}

template <int BLOCK>
__device__ __forceinline__ void smem_powers(const Field& f, int64_t m, const uint32_t (&x)[NW],
                                            uint32_t* pw) {
  uint32_t p[NW], t[NW];
  stark::set_elem(p, x);
  smem_set<BLOCK>(pw, 0, p);
#pragma unroll 1
  for (int k = 1; k < m; ++k) {
    stark::mont_mul(f, p, x, t);
    stark::set_elem(p, t);
    smem_set<BLOCK>(pw, k, p);
  }
}

template <int G>
constexpr size_t smem_bytes(int block) {
  return (static_cast<size_t>(group_tile<G>()) * NW + static_cast<size_t>(G) * NW * block) * 4;
}

template <int G, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
horner_smem_kernel(const int32_t* __restrict__ coeffs, int64_t d,
                   const int32_t* __restrict__ xs, int32_t* __restrict__ out,
                   int64_t n, Field f) {
  constexpr int TILE = group_tile<G>();
  extern __shared__ __align__(16) uint32_t dyn[];
  uint32_t (*cs)[NW] = reinterpret_cast<uint32_t (*)[NW]>(dyn);
  uint32_t* pw = dyn + TILE * NW;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool live = i < n;
  uint32_t x[NW], acc[NW], v[NW], k[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) acc[w] = 0;
  if (live && d > 1) stark::load_elem(xs, n, i, x);
  bool first = true;
  for (int64_t hi = d; hi > 0;) {
    const int64_t base = (hi - 1) / TILE * TILE;
    const int count = static_cast<int>(hi - base);
    __syncthreads();
    stage_cols(coeffs, d, base, count, cs);
    __syncthreads();
    if (live) {
      if (first && d > 1) smem_powers<BLOCK>(f, d - 1 < G ? d - 1 : G, x, pw);
#pragma unroll 1
      for (int top = count; top > 0;) {
        const int lo = (top - 1) / G * G, r = top - lo;
        if (first && r == 1) {
          row_words(cs[lo], acc);
        } else {
          uint32_t w[WIDE];
#pragma unroll
          for (int j = 0; j < WIDE; ++j) w[j] = 0;
          if (!first) {
            smem_power<BLOCK>(pw, G - 1, v);
            mac_wide(w, acc, v);
          }
#pragma unroll
          for (int j = 1; j < G; ++j) {
            if (j < r) {
              row_words(cs[lo + j], k);
              smem_power<BLOCK>(pw, j - 1, v);
              mac_wide(w, k, v);
            }
          }
          row_words(cs[lo], k);
          add_shifted(w, k);
          redc_canonical(f, w, acc);
        }
        first = false;
        top = lo;
      }
    }
    hi = base;
  }
  if (live) stark::store_elem(out, n, i, acc);
}

// --- an earlier step: groups of G points, each multiplied in -----------------

// The coefficients of each group of G points' monic product, a team of G
// lanes a group (32/G teams a warp), as `vanishing_coeffs_kernel` does a span.
template <int G>
__global__ void __launch_bounds__(THREADS)
group_coeffs_kernel(const int32_t* __restrict__ pts, int64_t npts,
                    int32_t* __restrict__ es, Field f) {
  constexpr int TEAMS = 32 / G;
  const int lane = static_cast<int>(threadIdx.x % 32), j = lane % G;
  const int64_t lo = (global_index() / 32 * TEAMS + lane / G) * G;
  const bool live = lane < TEAMS * G && lo < npts;
  const int r = live ? static_cast<int>(npts - lo < G ? npts - lo : G) : 0;
  uint32_t c[NW], q[NW], t[NW], below[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) c[w] = t[w] = 0;
  if (live) {
    stark::load_elem(pts, npts, lo, q);
    if (j == 0) stark::mod_sub(f, t, q, c);
    if (j == 1) stark::set_elem(c, f.one);
    if (r > 1) stark::load_elem(pts, npts, lo + 1, q);
  }
#pragma unroll 1
  for (int k = 1; k < G; ++k) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      below[w] = __shfl_up_sync(0xFFFFFFFFu, c[w], 1);
      if (j == 0) below[w] = 0;
    }
    if (k < r) {
      stark::mont_mul(f, q, c, t);
      if (k + 1 < r) stark::load_elem(pts, npts, lo + k + 1, q);
      stark::mod_sub(f, below, t, c);
    }
  }
  if (j < r) stark::store_elem(es, npts, lo + j, c);
}

// A group of r points' value from its coefficients: x - q for one point,
// else REDC(sum_{0<j<r} e_j*x^j + (x^r + e_0)*2^256).
template <int G>
__device__ __forceinline__ void group_value(const Field& f, uint32_t (&xp)[G][NW],
                                            uint32_t (*e)[NW], int r, uint32_t (&v)[NW]) {
  uint32_t k[NW];
  row_words(e[0], k);
  if (r == 1) {
    stark::mod_add(f, xp[0], k, v);
    return;
  }
  uint32_t w[WIDE];
#pragma unroll
  for (int j = 0; j < WIDE; ++j) w[j] = 0;
  add_shifted(w, k);
#pragma unroll
  for (int j = 1; j <= G; ++j) {
    if (j < r) {
      row_words(e[j], k);
      mac_wide(w, k, xp[j - 1]);
    } else if (j == r) {
      add_shifted(w, xp[j - 1]);
    }
  }
  redc_canonical(f, w, v);
}

template <int G>
__global__ void __launch_bounds__(THREADS)
group_vanishing_kernel(const int32_t* __restrict__ es, int64_t npts,
                       const int32_t* __restrict__ xs, int32_t* __restrict__ out,
                       int64_t n, Field f) {
  constexpr int TILE = group_tile<G>();
  __shared__ __align__(16) uint32_t cs[TILE][NW];
  const int64_t i = global_index();
  const bool live = i < n;
  uint32_t xp[G][NW], acc[NW], v[NW], t[NW];
  stark::set_elem(acc, f.one);
  if (live && npts > 0) stark::load_elem(xs, n, i, xp[0]);
  bool first = true;
  for (int64_t base = 0; base < npts; base += TILE) {
    const int count = static_cast<int>(npts - base < TILE ? npts - base : TILE);
    __syncthreads();
    stage_cols(es, npts, base, count, cs);
    __syncthreads();
    if (live) {
      if (first) powers<G>(f, npts < G ? npts : G, xp);
#pragma unroll 1
      for (int lo = 0; lo < count; lo += G) {
        group_value<G>(f, xp, cs + lo, count - lo < G ? count - lo : G, v);
        if (first) {
          stark::set_elem(acc, v);
        } else {
          stark::mont_mul(f, acc, v, t);
          stark::set_elem(acc, t);
        }
        first = false;
      }
    }
  }
  if (live) stark::store_elem(out, n, i, acc);
}

// --- one operation's cost at full occupancy ----------------------------------

// operands below 2^252 from the thread index (below p on both fields)
__device__ __forceinline__ void seed_elem(uint32_t x[NW], uint32_t s) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    s = s * 1664525u + 1013904223u;
    x[w] = s;
  }
  x[NW - 1] &= 0x0FFFFFFFu;
}

// KIND 0: mont_mul, 1: mac_wide, 2: mac_wide then redc_canonical, 3:
// mod_sub; DO = false leaves the operation out (the same kernel's other
// instructions, to subtract)
template <int KIND, bool DO>
__global__ void __launch_bounds__(THREADS)
op_kernel(uint32_t* __restrict__ out, int chain, Field f) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[NW], b[NW], r[NW], acc[WIDE];
  seed_elem(a, tid);
  seed_elem(b, tid ^ 0x5bd1e995u);
#pragma unroll
  for (int w = 0; w < WIDE; ++w) acc[w] = 0;
#pragma unroll 1
  for (int s = 0; s < chain; ++s) {
    if (DO) {
      if (KIND == 0) {
        stark::mont_mul(f, a, b, r);
      } else if (KIND == 1) {
        mac_wide(acc, a, b);
#pragma unroll
        for (int w = 0; w < NW; ++w) r[w] = acc[w + 4];
      } else if (KIND == 2) {
#pragma unroll
        for (int w = 0; w < WIDE; ++w) acc[w] = 0;
        mac_wide(acc, a, b);
        redc_canonical(f, acc, r);
      } else {
        stark::mod_sub(f, a, b, r);
      }
    } else {
#pragma unroll
      for (int w = 0; w < NW; ++w) r[w] = a[w] ^ b[w];
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) a[w] = r[w] & (w == NW - 1 ? 0x0FFFFFFFu : 0xFFFFFFFFu);
  }
  uint32_t h = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) h ^= a[w];
  out[tid] = h;
}

template <class K>
int occupancy(K kernel, int block, size_t smem) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, smem);
  return blocks;
}

}  // namespace

#define PROBE_BUILDS(X) X(1) X(2) X(3) X(4) X(6) X(8) X(12)
#define GROUP_BUILDS(X) X(2) X(3) X(4) X(6) X(8) X(12)
#define SMEM_BUILDS(X) X(4, 256) X(8, 256) X(8, 128) X(12, 128) X(16, 128)

// Launch a shared-memory variant: its dynamic shared memory allowed first.
#define SMEM_LAUNCH(kernel, G, BLOCK, ...)                                           \
  do {                                                                               \
    const size_t bytes = smem_bytes<G>(BLOCK);                                       \
    cudaFuncSetAttribute(kernel<G, BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         static_cast<int>(bytes));                                   \
    if (n > 0)                                                                       \
      kernel<G, BLOCK><<<static_cast<unsigned>((n + BLOCK - 1) / BLOCK), BLOCK, bytes, \
                         static_cast<cudaStream_t>(stream)>>>(__VA_ARGS__);           \
  } while (0)

// variant: 0 the parent; G < 100 the library's horner_kernel<G>; 100 + m
// horner_kernel<1, m> (m blocks an SM asked of ptxas); 1000*BLOCK/128 + G the
// powers in shared memory (horner_smem_kernel<G, BLOCK>)
extern "C" int probe_horner(int variant, const void* coeffs, long long d, const void* xs,
                            void* out, long long n, const uint32_t* field_words,
                            uint32_t np, void* stream) {
  const Field f = stark::make_field(field_words, np);
  switch (variant) {
    case 0: STARK_LAUNCH(parent_horner_kernel, n, stream, in(coeffs), d, in(xs), outp(out), n, f); break;
#define CASE(G) case G: STARK_LAUNCH(horner_kernel<G>, n, stream, in(coeffs), d, in(xs), outp(out), n, f); break;
    PROBE_BUILDS(CASE)
#undef CASE
    case 106: {
      auto* kernel = &horner_kernel<1, 6>;
      STARK_LAUNCH(kernel, n, stream, in(coeffs), d, in(xs), outp(out), n, f);
      break;
    }
    case 108: {
      auto* kernel = &horner_kernel<1, 8>;
      STARK_LAUNCH(kernel, n, stream, in(coeffs), d, in(xs), outp(out), n, f);
      break;
    }
#define CASE(G, B) case 1000 * (B / 128) + G: SMEM_LAUNCH(horner_smem_kernel, G, B, in(coeffs), d, in(xs), outp(out), n, f); break;
    SMEM_BUILDS(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// variant: 0 the parent (es: the points); G < 100 the library's
// vanishing_kernel<G> (es: the points for G = 1, else the spans'
// coefficients); 100 + G the earlier step, group_vanishing_kernel<G> (es:
// the groups' coefficients)
extern "C" int probe_vanishing(int variant, const void* es, long long npts, const void* xs,
                               void* out, long long n, const uint32_t* field_words,
                               uint32_t np, void* stream) {
  const Field f = stark::make_field(field_words, np);
  switch (variant) {
    case 0: STARK_LAUNCH(parent_vanishing_kernel, n, stream, in(es), npts, in(xs), outp(out), n, f); break;
#define CASE(G) case G: STARK_LAUNCH(vanishing_kernel<G>, n, stream, in(es), npts, in(xs), outp(out), n, f); break;
    PROBE_BUILDS(CASE)
#undef CASE
#define CASE(G) case 100 + G: STARK_LAUNCH(group_vanishing_kernel<G>, n, stream, in(es), npts, in(xs), outp(out), n, f); break;
    GROUP_BUILDS(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// group 0: the library's pre-pass (spans of 32); else group_coeffs_kernel<group>
extern "C" int probe_coeffs(int group, const void* pts, long long npts, void* es,
                            const uint32_t* field_words, uint32_t np, void* stream) {
  const Field f = stark::make_field(field_words, np);
  if (group == 0) return stark_vanishing_coeffs(pts, npts, es, field_words, np, stream);
  const long long per_warp = 32 / group * group;
  const long long threads = (npts + per_warp - 1) / per_warp * 32;
  switch (group) {
#define CASE(G) case G: STARK_LAUNCH(group_coeffs_kernel<G>, threads, stream, in(pts), npts, outp(es), f); break;
    GROUP_BUILDS(CASE)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_op(int kind, int with_op, void* out, long long threads, int chain,
                        const uint32_t* field_words, uint32_t np, void* stream) {
  const Field f = stark::make_field(field_words, np);
  auto* o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(threads);
  switch (kind * 2 + (with_op ? 1 : 0)) {
#define CASE(K) \
    case 2 * K: op_kernel<K, false><<<blocks, THREADS, 0, st>>>(o, chain, f); break; \
    case 2 * K + 1: op_kernel<K, true><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    CASE(0) CASE(1) CASE(2) CASE(3)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// resident blocks an SM: which 0 horner, 1 vanishing; variant as above
extern "C" int probe_occupancy(int which, int variant) {
  if (variant == 0) return which == 0 ? occupancy(parent_horner_kernel, THREADS, 0)
                                      : occupancy(parent_vanishing_kernel, THREADS, 0);
  switch (which * 10000 + variant) {
#define CASE(G) case G: return occupancy(horner_kernel<G>, THREADS, 0); \
                case 10000 + G: return occupancy(vanishing_kernel<G>, THREADS, 0);
    PROBE_BUILDS(CASE)
#undef CASE
#define CASE(G) case 10100 + G: return occupancy(group_vanishing_kernel<G>, THREADS, 0);
    GROUP_BUILDS(CASE)
#undef CASE
    case 106: return occupancy(horner_kernel<1, 6>, THREADS, 0);
    case 108: return occupancy(horner_kernel<1, 8>, THREADS, 0);
#define CASE(G, B) \
    case 1000 * (B / 128) + G: \
      cudaFuncSetAttribute(horner_smem_kernel<G, B>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                           static_cast<int>(smem_bytes<G>(B))); \
      return occupancy(horner_smem_kernel<G, B>, B, smem_bytes<G>(B));
    SMEM_BUILDS(CASE)
#undef CASE
    default: return -1;
  }
}
"""


def group_ops(npts: int, g: int) -> dict:
    """What the earlier step, `group_vanishing_kernel<g>`, does a thread:
    min(g, npts) - 1 CIOS products (the powers) and one for each group but
    the first; each group of r points a subtraction (r = 1) or r - 1 wide
    products and a reduction."""
    sizes = [g] * (npts // g) + ([npts % g] if npts % g else [])
    return {"cios": max(min(g, npts) - 1 + len(sizes) - 1, 0),
            "wide": sum(r - 1 for r in sizes if r > 1),
            "redc": sum(r > 1 for r in sizes), "sub": sum(r == 1 for r in sizes)}


def monic_coeffs(spec, q):
    """The monic product of (x - q_k) over k for many groups at once: q is a
    list of r (16, m) planes (point k of each of m groups); returns r planes,
    e_j the coefficient of x^j (x^r's is 1), multiplying in one point at a
    time: e_j <- e_(j-1) - q_k*e_j, the new e_k = e_(k-1) - q_k."""
    from stark_tpu_torch.ops import modmath as mm
    from stark_tpu_torch.protocol import fused_kernels as fk

    zero = torch.zeros_like(q[0])
    e = [mm.msub(spec, zero, q[0])]
    for k in range(1, len(q)):
        e.append(mm.msub(spec, e[k - 1], q[k]))
        for j in range(k - 1, 0, -1):
            e[j] = mm.msub(spec, e[j - 1], fk._mul(spec, q[k], e[j]))
        e[0] = mm.msub(spec, zero, fk._mul(spec, q[k], e[0]))
    return e


def group_coeffs_plain(spec, points_mont, g: int):
    """The earlier step's coefficients: each group of g points' monic
    product, in `vanishing_coeffs_plain`'s layout."""
    L, npts = points_mont.shape
    full = npts // g * g
    out = torch.empty_like(points_mont)
    if full:
        q = points_mont[:, :full].reshape(L, -1, g)
        e = monic_coeffs(spec, [q[:, :, k].contiguous() for k in range(g)])
        out[:, :full] = torch.stack(e, dim=2).reshape(L, full)
    if full < npts:
        e = monic_coeffs(spec, [points_mont[:, k : k + 1] for k in range(full, npts)])
        out[:, full:] = torch.cat(e, dim=1)
    return out


def build_probe(tmp: str):
    """Compile the probe beside `csrc/` into a shared library; returns it and
    {kernel: [registers, spill store bytes]} from `ptxas -v`."""
    import protocol_kernels_cuda as pkc
    from stark_tpu_torch.ops import build

    src, so = os.path.join(tmp, "horner_probe.cu"), os.path.join(tmp, "horner_probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared", "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    _vp, _ll, _u32p = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32)
    _i, _u = ctypes.c_int, ctypes.c_uint32
    lib.probe_horner.argtypes = [_i, _vp, _ll, _vp, _vp, _ll, _u32p, _u, _vp]
    lib.probe_vanishing.argtypes = [_i, _vp, _ll, _vp, _vp, _ll, _u32p, _u, _vp]
    lib.probe_coeffs.argtypes = [_i, _vp, _ll, _vp, _u32p, _u, _vp]
    lib.probe_op.argtypes = [_i, _i, _vp, _ll, _i, _u32p, _u, _vp]
    lib.probe_occupancy.argtypes = [_i, _i]
    usage = {k: v for k, v in pkc.ptxas_usage(proc.stdout + proc.stderr).items()
             if "horner" in k or "vanishing" in k}
    return lib, usage


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records to DIR/horner_kernels.json")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--chain", type=int, default=64,
                    help="dependent operations a thread in the cost probes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke
    from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR
    from stark_tpu_torch.ops import build
    from stark_tpu_torch.ops import field_cuda as fc
    from stark_tpu_torch.protocol import fused_kernels as fk

    smi = lambda q: subprocess.run(  # noqa: E731
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = smi("name,power.limit")
    sm_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(card, flush=True)
    device = torch.device("cuda")
    build.load()  # the kernel library, for the `kernel` variants
    with tempfile.TemporaryDirectory() as tmp:
        lib, usage = build_probe(tmp)
    horner_ids = ((0,) + SWEEP + tuple(100 + m for m in MINB)
                  + tuple(1000 * (b // 128) + g for g, b in SMEM))
    vanishing_ids = (0,) + SWEEP + tuple(100 + g for g in SWEEP[1:])
    occupancy = {f"{which} {v}": lib.probe_occupancy(w, v)
                 for w, (which, ids) in enumerate((("horner", horner_ids),
                                                   ("vanishing", vanishing_ids)))
                 for v in ids}
    print(json.dumps({"ptxas": usage, "blocks_per_sm": occupancy}), flush=True)

    # one operation's cost: SM clocks a thread at full occupancy
    words, np32, stream = fc.cuda_args(BN254_FR, torch.empty(16, 1, dtype=torch.int32,
                                                              device=device))
    scratch = torch.empty(THREADS_TPUT, dtype=torch.int32, device=device)
    clocks = {}
    for kind, name in enumerate(OPS):
        ms = {}
        for with_op in (0, 1):
            def run(kind=kind, with_op=with_op):
                rc = lib.probe_op(kind, with_op, scratch.data_ptr(), THREADS_TPUT, args.chain,
                                  words, np32, stream)
                if rc:
                    raise RuntimeError(f"op {name}: CUDA error {rc}")
            ms[with_op] = min(chip_smoke.median_ms(run, args.reps) for _ in range(2))
        clocks[name] = (ms[1] - ms[0]) * 1e-3 * sm_hz * sms / (THREADS_TPUT * args.chain)
    cost = {"cios": clocks["mont_mul"], "wide": clocks["wide"],
            "redc": clocks["wide_redc"] - clocks["wide"], "sub": clocks["mod_sub"]}
    print(json.dumps({"sm_clocks_a_thread": clocks, "cost": cost}), flush=True)

    def floor_ms(ops: dict, n: int) -> float:
        return sum(cost[k] * v for k, v in ops.items()) * n / (sms * sm_hz) * 1e3

    rng = np.random.default_rng(SEED)

    def planes(spec, n):
        return chip_smoke.with_edges(spec, chip_smoke.random_planes(rng, spec, n, device))

    def probe_call(fn, variant, spec, small, xs):
        """A call of probe kernel `variant` on (small operand, xs)."""
        w, np_, st = fc.cuda_args(spec, xs)
        out = torch.empty_like(xs)

        def run():
            rc = fn(variant, small.data_ptr(), small.shape[1], xs.data_ptr(), out.data_ptr(),
                    xs.shape[1], w, np_, st)
            if rc:
                raise RuntimeError(f"variant {variant}: CUDA error {rc}")
            return out
        return run

    def coeffs_call(spec, pts, g):
        """The library's pre-pass (g = 0) or the earlier step's, groups of g."""
        w, np_, st = fc.cuda_args(spec, pts)
        out = torch.empty_like(pts)

        def run():
            rc = lib.probe_coeffs(g, pts.data_ptr(), pts.shape[1], out.data_ptr(), w, np_, st)
            if rc:
                raise RuntimeError(f"coeffs G={g}: CUDA error {rc}")
            return out
        return run

    def variants(spec, kind, small, xs):
        """{label: (call, ops a thread)} for one case: the parent, every
        build within the field's bound, the wrapper."""
        count = small.shape[1]
        vanish = kind == "vanishing"
        fn = lib.probe_vanishing if vanish else lib.probe_horner
        # a CIOS product and an addition or subtraction a term
        out = {"parent": (probe_call(fn, 0, spec, small, xs), {"cios": count, "sub": count})}
        if vanish:
            spans = coeffs_call(spec, small, 0)().clone()
            builds = ([(f"G={g}", g, g) for g in SWEEP]
                      + [(f"groups G={g}", g, 100 + g) for g in SWEEP[1:]])
        else:
            builds = ([(f"G={g}", g, g) for g in SWEEP]
                      + [(f"G=1 minb={m}", 1, 100 + m) for m in MINB]
                      + [(f"smem G={g} block={b}", g, 1000 * (b // 128) + g) for g, b in SMEM])
        for name, g, variant in builds:
            if not (fk.group_fits(spec, g) and fk.group_fits(spec, g, lead=vanish)):
                continue
            if not vanish:
                ops, es = fk.horner_ops(count, g), small
            elif variant > 100:
                ops, es = group_ops(count, g), coeffs_call(spec, small, g)().clone()
            else:
                ops, es = fk.vanishing_ops(count, g), (spans if g > 1 else small)
            out[name] = (probe_call(fn, variant, spec, es, xs), ops)
        chosen = (fk.vanishing_group(spec, count, xs.shape[1]) if vanish
                  else fk.horner_group(spec, count))
        wrapper = ((lambda: fk.vanishing_eval(spec, xs, small)) if vanish
                   else (lambda: fk.horner_eval(spec, small, xs)))
        out[f"kernel (G={chosen})"] = (wrapper, out[f"G={chosen}"][1])
        return out

    cases = []  # (field, kind, count, n)
    for d in HORNER_D:
        cases.append((BN254_FR, "horner", d, N))
    for k in POINTS:
        cases.append((BN254_FR, "vanishing", k, N))
    for d, k in BLS_CASES:
        cases += [(BLS12_381_FR, "horner", d, N_BLS), (BLS12_381_FR, "vanishing", k, N_BLS)]
    # the `bits` golden's prove: 1,062 public wires at n = 2^15 (128 blocks)
    cases += [(BN254_FR, "horner", 1062, N_BITS), (BN254_FR, "vanishing", 1062, N_BITS)]

    records, calls = {}, {}
    for spec, kind, count, n in cases:
        small = planes(spec, count) if count else torch.empty(16, 0, dtype=torch.int32,
                                                              device=device)
        xs, xs_check = planes(spec, n), planes(spec, N_CHECK)
        label = f"{kind} {spec.name} n={n} {'points' if kind == 'vanishing' else 'd'}={count}"
        plain = (fk.vanishing_eval_plain(spec, xs_check, small) if kind == "vanishing"
                 else fk.horner_eval_plain(spec, small, xs_check))
        check = variants(spec, kind, small, xs_check)
        timed = variants(spec, kind, small, xs)
        want = timed["parent"][0]().clone()
        for v, (fn, _) in check.items():
            if not torch.equal(fn(), plain):
                raise AssertionError(f"{label} {v}: differs from the plain version at n={N_CHECK}")
        for v, (fn, _) in timed.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{label} {v}: differs from the parent")
        torch.cuda.synchronize()
        records[label] = {v: {"ops": ops, "floor_ms": floor_ms(ops, n), "ms": []}
                          for v, (_, ops) in timed.items()}
        for v, (fn, _) in timed.items():
            calls[(label, v)] = fn
        print(f"checked {label}", flush=True)

    for order in (list(calls), list(calls)[::-1]):
        for key in order:
            reps = max(3, args.reps // 3) if "1062" in key[0] or "1061" in key[0] else args.reps
            records[key[0]][key[1]]["ms"].append(chip_smoke.median_ms(calls[key], reps))

    prepass = {}
    for k in COEFF_POINTS:
        pts = planes(BN254_FR, k)
        for g in (0,) + SWEEP[1:]:
            run = coeffs_call(BN254_FR, pts, g)
            want = (fk.vanishing_coeffs_plain(BN254_FR, pts) if g == 0
                    else group_coeffs_plain(BN254_FR, pts, g))
            if not torch.equal(run(), want):
                raise AssertionError(f"coeffs points={k} G={g}: differs from the plain version")
            prepass[f"points={k} {'spans' if g == 0 else f'groups G={g}'}"] = (
                chip_smoke.median_ms(run, args.reps))
    del lib

    print(json.dumps({"times": records, "prepass_ms": prepass}), flush=True)
    print(f"median device ms of {args.reps}, forward / backward; {card}")
    for label, rec in records.items():
        for v, r in rec.items():
            print(f"| {label} | {v} | {r['ms'][0]:.4f} / {r['ms'][1]:.4f} | "
                  f"floor {r['floor_ms']:.4f} |")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "horner_kernels.json"), "w") as f:
            json.dump({"card": card, "sm_hz": sm_hz, "sms": sms, "reps": args.reps,
                       "chain": args.chain, "ptxas": usage, "blocks_per_sm": occupancy,
                       "sm_clocks_a_thread": clocks, "cost": cost, "times": records,
                       "prepass_ms": prepass}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
