#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernel library and measure `mpow_scalar`
(`stark_tpu_torch/csrc/fieldops.cu`, the Fermat inversion) and each step of
its design on one NVIDIA GPU, without the rest of `chip_smoke.py`.

    python3 scripts/mpow_kernels_cuda.py [--out DIR]

Printed, one JSON line each: the card's name, power limit and highest SM
clock; what `ptxas -v` said of the library's `mpow_scalar` kernel and of the
probe's kernels; the SASS instructions of one product (field.cuh's
`mont_mul`), of one 32-bit square (`mont_sqr_lazy`, alone and made
canonical) and of one radix-2^29 square (field.cuh's `mont_sqr29`, and the
product-scanning form `mont_sqr29_ps`), read with `cuobjdump -sass` from
probe kernels compiled beside the library (their loads, stores and control
flow not counted), and the device time of one dependent step of each: a
chain of 4096, less a chain of none, over 4096, on the vector datapath (32
threads, each its own operand) and with one operand for the warp
(`uniform`). Then the variants, at (16, 1) and (16, 8) with e = p - 2 on
BN254's scalar field (some at (16, 1) on BLS12-381's), each bit-identical
to `mpow_scalar_plain`, with its median device time:
  `msb`: the kernel before the redesign, MSB-first square-and-multiply with
      `mont_mul`, one thread a lane (381 dependent products for BN254);
  `window w=3..5`: step 1 alone, left-to-right sliding windows of odd
      digits, the odd powers a^1 .. a^(2^w - 1) in shared memory;
  `warps mul s=1,2`: step 2, a warp squaring with `mont_mul` beside s
      multiply warps (`field_cuda.mpow_streams`), a square handed over at a
      time behind a fenced counter; `warps sqr`: step 3, the squares by
      `mont_sqr_lazy` made canonical; `warps lazy`: step 4, below 2p;
      `warps sqr29`: the radix-2^29 square;
  `lanes s=1,2`: step 5, a square spread over 9 lanes of a warp;
  `ring s=1,2`: the library's kernel (tagged ring, no fence), s multiply
      warps; `kernel`: the wrapper `field_cuda.mpow_scalar` itself.
Last, the library's kernel on exponents that isolate its parts (2^253 and
2^254 - 1; its squaring warp alone). Needs `nvcc`, `cuobjdump` and a CUDA
card; imports nothing of JAX.
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
#include "fieldops.cu"
namespace stark {
// Montgomery square a*a*2^-256 mod p up to one p (SOS): the 28 cross
// products a_i a_j (i < j) once, doubled, plus the 8 squares a_i^2 (36 word
// products where `mont_mul` takes 64), then 8 reduction rows that each add
// m_i p 2^(32i) with m_i = t_i n'. For a < 2p with 4p < 2^256, or a < p
// (2p < 2^256, every field here), a*a < p 2^256, so t + m p < 2p 2^256 and
// the result is below 2p; no final subtraction (cond_sub_p makes it
// canonical).
__device__ __forceinline__ void mont_sqr_lazy(const Field& f, const uint32_t a[NW],
                                              uint32_t r[NW]) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < NW; ++j) {
      uint64_t s = static_cast<uint64_t>(a[i]) * a[j] + t[i + j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    t[i + NW] = static_cast<uint32_t>(c);
  }
  // the cross sum is below a*a / 2 < 2^511: doubling keeps it in 16 words
#pragma unroll
  for (int i = 2 * NW - 1; i > 0; --i) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t s = static_cast<uint64_t>(a[i]) * a[i] + t[2 * i] + c;
    t[2 * i] = static_cast<uint32_t>(s);
    s = (s >> 32) + t[2 * i + 1];
    t[2 * i + 1] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  // row i's carry out of word i + 8 enters word i + 9 with row i + 1
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * f.np;
    c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = static_cast<uint64_t>(m) * f.p[j] + t[i + j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[i + NW]) + c + carry;
    t[i + NW] = static_cast<uint32_t>(s);
    carry = static_cast<uint32_t>(s >> 32);
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = t[i + NW];
}

// The radix-2^29 square by product scanning (tried, slower than the
// library's operand scanning): y*y*2^-261 mod p up to one p, for y < 2p and 4p < 2^261 (every field here, 2p < 2^256),
// limbs below 2^29 in and out. Product scanning, a column at a time: column
// c sums the carry from column c - 1, its square terms (the cross terms
// against doubled limbs, 45 distinct limb products in all) and its
// reduction terms m_k p_(c-k) (81 in all); for c < 9 it then takes
// m_c = sum * n' mod 2^29, adds m_c p_0 and passes all but the (zero) low
// 29 bits on, for c >= 9 it keeps the low 29 bits as limb c - 9. A column
// holds at most 5 square terms below 2^59, 9 reduction terms below 2^58
// and a carry below 2^35: below 2^63, so each term is one IMAD.WIDE into a
// 64-bit sum with no carry between the terms. The square and reduction
// terms go to two sums, two chains the SM can interleave.
// p29: p in 29-bit limbs; np29: -p^-1 mod 2^29.
__device__ __forceinline__ void mont_sqr29_ps(const uint32_t p29[NL29], uint32_t np29,
                                           const uint32_t y[NL29], uint32_t r[NL29]) {
  uint32_t d[NL29], m[NL29];
#pragma unroll
  for (int i = 0; i < NL29; ++i) d[i] = y[i] << 1;
  uint64_t carry = 0;
#pragma unroll
  for (int c = 0; c < 2 * NL29; ++c) {
    uint64_t sq = 0, red = 0;
#pragma unroll
    for (int i = c >= NL29 ? c - NL29 + 1 : 0; 2 * i < c; ++i) {
      sq += static_cast<uint64_t>(y[i]) * d[c - i];
    }
    if (c % 2 == 0 && c / 2 < NL29) sq += static_cast<uint64_t>(y[c / 2]) * y[c / 2];
#pragma unroll
    for (int k = c >= NL29 ? c - NL29 + 1 : 0; k < c && k < NL29; ++k) {
      red += static_cast<uint64_t>(m[k]) * p29[c - k];
    }
    uint64_t acc = carry + sq + red;
    if (c < NL29) {
      m[c] = (static_cast<uint32_t>(acc) * np29) & MASK29;
      acc += static_cast<uint64_t>(m[c]) * p29[0];
    } else {
      r[c - NL29] = static_cast<uint32_t>(acc) & MASK29;
    }
    carry = acc >> 29;
  }
}

// The radix-2^29 Montgomery square spread over a group of 9 lanes of a
// warp, one limb a lane (R' = 2^261). Lane l of the group holds limb l of
// y and computes columns l and l + 9 of each product: at step i the limbs
// i (broadcast) and (l - i) mod 9 (rotated) meet in column l when i <= l,
// else in l + 9. Three products, each followed by carry rounds (a column
// keeps its low 29 bits and hands the rest to the next column, a shuffle
// each):
//   T = y^2 (17 columns, two rounds);
//   M = (T mod R') n' mod R' (the 9 low columns, two rounds, the carry out
//       of column 8 dropped);
//   T + M p (two rounds), whose low 9 columns then hold 0 or exactly R'
//       (below 2 R' after the rounds, and a multiple of R'), so one more
//       unit enters column 9 iff any of them is not 0 (a ballot).
// Limbs stay below 2^29 + 2^7 after two rounds, so every column sums at
// most 9 products of 60 bits below 2^64, and M < R' (1 + 2^-22). The
// result, the 9 high columns (the B column of each lane: no renumbering
// for the next square), is y^2 2^-261 mod p up to a small multiple of p:
// below y^2 / R' + 1.0001 p, so a chain from y < p stays below 1.1 p when
// 128 p < 2^261 (BN254) and 1.02 p when 70 p < 2^261 (BLS12-381). Every lane
// of the warp must take part (full-warp shuffles); lanes 27-31 compute
// nothing of use.
constexpr int LANES29 = NL29;  // lanes of a group
struct Lanes29 {
  int l, base, prev;   // limb, the group's first lane, the lane of limb l - 1 mod 9
  int rot[NL29];       // the lane of limb (l - i) mod 9
  uint32_t low[NL29];  // all ones where step i meets column l (i <= l), else 0
  uint32_t pA[NL29], pB[NL29];  // limb (l - i) mod 9 of p where it meets column l, l + 9
  uint32_t nA[NL29];   // limb (l - i) mod 9 of n' = -p^-1 mod 2^261 where it meets column l
  uint32_t first;      // all ones on limb 0, else 0
};

// A lane's rotations of p and n' (9 limbs each: p29, np29), split by the
// column each step meets, so that every product is one multiply-add into
// its column's 64-bit sum.
__device__ __forceinline__ Lanes29 make_lanes29(const uint32_t p29[NL29],
                                               const uint32_t np29[NL29], int lane) {
  Lanes29 g;
  const int group = lane / LANES29;
  g.l = lane - group * LANES29;
  g.base = group * LANES29;
  g.prev = g.base + (g.l + LANES29 - 1) % LANES29;
  g.first = g.l == 0 ? ~0u : 0u;
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    const int j = (g.l - i + LANES29) % LANES29;
    g.rot[i] = g.base + j;
    uint32_t pj = 0, nj = 0;
#pragma unroll
    for (int q = 0; q < NL29; ++q) {
      pj = q == j ? p29[q] : pj;
      nj = q == j ? np29[q] : nj;
    }
    g.low[i] = i <= g.l ? ~0u : 0u;
    g.pA[i] = pj & g.low[i];
    g.pB[i] = pj & ~g.low[i];
    g.nA[i] = nj & g.low[i];
  }
  return g;
}

// One carry round over a group's 18 columns: lane l's A is column l, its B
// column l + 9; column 17 (lane 8's B) keeps all it holds. `small`: every
// carry is below 2^16, so both travel in one 32-bit shuffle.
template <bool small>
__device__ __forceinline__ void carry_round18(const Lanes29& g, uint64_t& A, uint64_t& B) {
  const bool top = g.l == LANES29 - 1;
  const uint64_t cA = A >> 29, cB = top ? 0 : B >> 29;
  A &= MASK29;
  if (!top) B &= MASK29;
  uint64_t inA, inB;
  if (small) {
    const uint32_t in = __shfl_sync(0xffffffffu, static_cast<uint32_t>(cA | cB << 16), g.prev);
    inA = in & 0xFFFFu;
    inB = in >> 16;
  } else {
    inA = __shfl_sync(0xffffffffu, cA, g.prev);
    inB = __shfl_sync(0xffffffffu, cB, g.prev);
  }
  A += inA & ~static_cast<uint64_t>(g.first);
  B += g.first ? inA : inB;
}

// One carry round over the 9 low columns, modulo R'.
template <bool small>
__device__ __forceinline__ void carry_round9(const Lanes29& g, uint64_t& A) {
  const uint64_t c = A >> 29;
  A &= MASK29;
  const uint64_t in = small ? __shfl_sync(0xffffffffu, static_cast<uint32_t>(c), g.prev)
                            : __shfl_sync(0xffffffffu, c, g.prev);
  A += in & ~static_cast<uint64_t>(g.first);
}

// The 9 limbs of a group, each lane's value broadcast: all shuffles issued
// before any is used.
__device__ __forceinline__ void gather29(const Lanes29& g, uint32_t v, uint32_t (&all)[NL29]) {
#pragma unroll
  for (int i = 0; i < NL29; ++i) all[i] = __shfl_sync(0xffffffffu, v, g.base + i);
}

// limb l of y*y*2^-261 mod p up to a small multiple of p, from limb l of y
__device__ __forceinline__ uint32_t mont_sqr29_lanes(const Lanes29& g, uint32_t y) {
  uint32_t v[NL29], r[NL29];
  gather29(g, y, v);
#pragma unroll
  for (int i = 0; i < NL29; ++i) r[i] = __shfl_sync(0xffffffffu, y, g.rot[i]);
  uint64_t A = 0, B = 0, M = 0;
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    A += static_cast<uint64_t>(v[i]) * (r[i] & g.low[i]);
    B += static_cast<uint64_t>(v[i]) * (r[i] & ~g.low[i]);
  }
  carry_round18<false>(g, A, B);  // carries below 2^35
  carry_round18<true>(g, A, B);   // below 2^7
  gather29(g, static_cast<uint32_t>(A), v);
#pragma unroll
  for (int i = 0; i < NL29; ++i) M += static_cast<uint64_t>(v[i]) * g.nA[i];
  carry_round9<false>(g, M);
  carry_round9<true>(g, M);
  gather29(g, static_cast<uint32_t>(M), v);
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    A += static_cast<uint64_t>(v[i]) * g.pA[i];
    B += static_cast<uint64_t>(v[i]) * g.pB[i];
  }
  carry_round18<false>(g, A, B);
  carry_round18<true>(g, A, B);
  const uint32_t low = __ballot_sync(0xffffffffu, A != 0) >> g.base;
  if (g.first && (low & ((1u << LANES29) - 1))) B += 1;
  return static_cast<uint32_t>(B);
}

// 9 limbs below 2^30 each (a value below 2^256) -> 8 words
__device__ __forceinline__ void words_from_limbs29(const uint32_t u[NL29], uint32_t w[NW]) {
  uint32_t l[NL29];
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    const uint32_t v = u[i] + c;
    l[i] = v & MASK29;
    c = v >> 29;
  }
  from_limbs29(l, w);
}

}  // namespace stark
namespace {
constexpr int WARPS_RING = 8;  // slots of a multiply warp's ring
constexpr int WARPS_SLOT = stark::NL29;  // words of a slot: a value's limbs or words
struct Np29 { uint32_t w[stark::NL29]; };  // -p^-1 mod 2^261 in 29-bit limbs
// Steps 2-4 of the design as first built (two warps or more, the squares
// handed over one at a time behind counters). Warp 0 squares: x_0 = a mod p,
// x_{i+1} = x_i^2, and hands x_i to the
// multiply warp whose stream holds bit i, through that warp's ring of
// WARPS_RING slots in shared memory (word-major, a lane a column) behind a
// counter it bumps. Multiply warp m multiplies its accumulator by each x_i
// it is handed, with field.cuh's canonical `mont_mul` (acc < p, x < 2p:
// acc x < p 2^256), and bumps its own counter when a slot is free again.
// Warps 2.. hand their products to warp 1, which folds them in before its
// first bit above theirs and stores the result.
// SQ picks the squaring: 2, the radix-2^29 `mont_sqr29` (R' = 2^261: the
// values handed over are then x_i 2^(-5 (2^i - 1)), which warp 1's starting
// value 2^(5 (e - popcount e)) R mod p makes good); 1, `mont_sqr_lazy`, made
// canonical unless LAZY; 0, `mont_mul`. ONE: a launch of one column, every
// lane on column 0, so the compiler can keep the values warp-uniform.
template <int SQ, bool LAZY, bool ONE>
__global__ void __launch_bounds__(32 * (1 + MPOW_STREAMS))
    mpow_warps_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int k,
                       MpowStreams s, int streams, int nbits, stark::Field f) {
  __shared__ uint32_t ring[MPOW_STREAMS][WARPS_RING][WARPS_SLOT][32];
  __shared__ uint32_t accs[MPOW_STREAMS][stark::NW][32];
  __shared__ int produced[MPOW_STREAMS], consumed[MPOW_STREAMS], done[MPOW_STREAMS];
  constexpr int NV = SQ == 2 ? stark::NL29 : stark::NW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, col = ONE ? 0 : lane;
  if (threadIdx.x < MPOW_STREAMS) {
    produced[threadIdx.x] = consumed[threadIdx.x] = done[threadIdx.x] = 0;
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t x[stark::NW], v[WARPS_SLOT], y[WARPS_SLOT];
    if (col < k) {
      stark::load_elem(a, k, col, x);
      reduce_mod_p(f, x);
    } else {
#pragma unroll
      for (int w = 0; w < stark::NW; ++w) x[w] = 0;
    }
    uint32_t p29[stark::NL29];
    stark::to_limbs29(f.p, p29);
    const uint32_t np29 = f.np & stark::MASK29;
    if (SQ == 2) {
      stark::to_limbs29(x, v);
    } else {
#pragma unroll
      for (int w = 0; w < stark::NW; ++w) v[w] = x[w];
    }
    int sent[MPOW_STREAMS] = {};
    uint32_t cur[MPOW_STREAMS] = {};  // each stream's bits from bit i up
#pragma unroll 1
    for (int i = 0; i < nbits; ++i) {
      if ((i & 31) == 0) {
#pragma unroll
        for (int m = 0; m < MPOW_STREAMS; ++m) cur[m] = word_at(s.e[m], i >> 5);
      }
#pragma unroll
      for (int m = 0; m < MPOW_STREAMS; ++m) {
        const bool mine = cur[m] & 1u;
        cur[m] >>= 1;
        if (!mine) continue;
        if (sent[m] >= WARPS_RING) wait_above(&consumed[m], sent[m] - WARPS_RING);
        const int slot = sent[m] % WARPS_RING;
#pragma unroll
        for (int w = 0; w < NV; ++w) ring[m][slot][w][lane] = v[w];
        __syncwarp();
        if (lane == 0) store_release(&produced[m], sent[m] + 1);
        ++sent[m];
      }
      if (i + 1 < nbits) {
        if (SQ == 2) {
          stark::mont_sqr29(p29, np29, v, y);
        } else if (SQ == 1) {
          stark::mont_sqr_lazy(f, v, y);
          if (!LAZY) stark::cond_sub_p(f, 0, y);
        } else {
          stark::mont_mul(f, v, v, y);
        }
#pragma unroll
        for (int w = 0; w < NV; ++w) v[w] = y[w];
      }
    }
    return;
  }
  const int m = warp - 1;
  if (m >= streams) return;
  uint32_t e[stark::NW], acc[stark::NW], x[stark::NW], t[stark::NW];
#pragma unroll
  for (int w = 0; w < stark::NW; ++w) {
    e[w] = m == 0 ? s.e[0][w] : m == 1 ? s.e[1][w] : s.e[2][w];
    acc[w] = m == 0 ? s.start[w] : f.one[w];
  }
  // warp 1 folds the other warps' products in before its first bit at or
  // above `fold_at`, where they have all been handed their last value
  int fold_at = 0;
#pragma unroll
  for (int o = 1; o < MPOW_STREAMS; ++o) fold_at = max(fold_at, bit_length(s.e[o]));
  bool folded = m > 0 || streams == 1;
  int got = 0;
  uint32_t cur = 0;
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    if ((i & 31) == 0) cur = word_at(e, i >> 5);
    const bool mine = cur & 1u;
    cur >>= 1;
    if (!mine) continue;
    if (!folded && i >= fold_at) {
      fold_streams(f, accs, done, streams, col, acc);
      folded = true;
    }
    wait_above(&produced[m], got);
    const int slot = got % WARPS_RING;
    uint32_t v[WARPS_SLOT];
#pragma unroll
    for (int w = 0; w < NV; ++w) v[w] = ring[m][slot][w][col];
    __syncwarp();
    if (lane == 0) store_release(&consumed[m], got + 1);
    ++got;
    if (SQ == 2) {
      stark::from_limbs29(v, x);
    } else {
#pragma unroll
      for (int w = 0; w < stark::NW; ++w) x[w] = v[w];
    }
    stark::mont_mul(f, acc, x, t);
    stark::set_elem(acc, t);
  }
  if (m > 0) {
#pragma unroll
    for (int w = 0; w < stark::NW; ++w) accs[m][w][lane] = acc[w];
    __syncwarp();
    if (lane == 0) store_release(&done[m], 1);
    return;
  }
  if (!folded) fold_streams(f, accs, done, streams, col, acc);  // no bit of its own above
  if (lane < k) stark::store_elem(out, k, lane, acc);
}

constexpr int MPOW_COLS = 3;  // columns of a squaring warp: groups of 9 lanes
constexpr int MPOW_SQ_WARPS = (32 + MPOW_COLS - 1) / MPOW_COLS;

// Step 5 (lanes a product): squaring warps 0 .. S - 1 (S = ceil(k / 3)):
// a group of 9 lanes squares
// one column, a limb a lane (field.cuh's `mont_sqr29_lanes`), and hands each
// x_i to the multiply warp whose stream holds bit i, through that warp's
// ring (a slot holds 9 limbs of each column), each squaring warp adding one
// to the slot's counter. Multiply warps S .. S + streams - 1: one lane a
// column, as in the kernel above, the limbs made words first.
__global__ void __launch_bounds__(32 * (MPOW_SQ_WARPS + MPOW_STREAMS))
    mpow_lanes_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int k,
                      MpowStreams s, Np29 n29, int streams, int nbits, stark::Field f) {
  __shared__ uint32_t ring[MPOW_STREAMS][WARPS_RING][stark::NL29][32];
  __shared__ uint32_t accs[MPOW_STREAMS][stark::NW][32];
  __shared__ int produced[MPOW_STREAMS][MPOW_SQ_WARPS], consumed[MPOW_STREAMS],
      done[MPOW_STREAMS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sq_warps = (k + MPOW_COLS - 1) / MPOW_COLS;
  if (threadIdx.x < MPOW_STREAMS) consumed[threadIdx.x] = done[threadIdx.x] = 0;
  if (threadIdx.x < MPOW_STREAMS * MPOW_SQ_WARPS) (&produced[0][0])[threadIdx.x] = 0;
  __syncthreads();
  if (warp < sq_warps) {
    uint32_t p29[stark::NL29];
    stark::to_limbs29(f.p, p29);
    const stark::Lanes29 g = stark::make_lanes29(p29, n29.w, lane);
    const int group = lane / stark::LANES29, col = warp * MPOW_COLS + group;
    const bool live = group < MPOW_COLS && col < k;
    uint32_t y = 0;
    if (live) {
      uint32_t x[stark::NW], l29[stark::NL29];
      stark::load_elem(a, k, col, x);
      reduce_mod_p(f, x);
      stark::to_limbs29(x, l29);
#pragma unroll
      for (int q = 0; q < stark::NL29; ++q) y = q == g.l ? l29[q] : y;
    }
    int sent[MPOW_STREAMS] = {};
    uint32_t cur[MPOW_STREAMS] = {};  // each stream's bits from bit i up
#pragma unroll 1
    for (int i = 0; i < nbits; ++i) {
      if ((i & 31) == 0) {
#pragma unroll
        for (int m = 0; m < MPOW_STREAMS; ++m) cur[m] = word_at(s.e[m], i >> 5);
      }
#pragma unroll
      for (int m = 0; m < MPOW_STREAMS; ++m) {
        const bool mine = cur[m] & 1u;
        cur[m] >>= 1;
        if (!mine) continue;
        if (sent[m] >= WARPS_RING) wait_above(&consumed[m], sent[m] - WARPS_RING);
        if (live) ring[m][sent[m] % WARPS_RING][g.l][col] = y;
        __syncwarp();
        if (lane == 0) store_release(&produced[m][warp], sent[m] + 1);
        ++sent[m];
      }
      if (i + 1 < nbits) y = stark::mont_sqr29_lanes(g, y);
    }
    return;
  }
  const int m = warp - sq_warps;
  if (m >= streams) return;
  uint32_t e[stark::NW], acc[stark::NW], x[stark::NW], t[stark::NW];
#pragma unroll
  for (int w = 0; w < stark::NW; ++w) {
    e[w] = m == 0 ? s.e[0][w] : m == 1 ? s.e[1][w] : s.e[2][w];
    acc[w] = m == 0 ? s.start[w] : f.one[w];
  }
  int fold_at = 0;
#pragma unroll
  for (int o = 1; o < MPOW_STREAMS; ++o) fold_at = max(fold_at, bit_length(s.e[o]));
  bool folded = m > 0 || streams == 1;
  int got = 0;
  uint32_t cur = 0;
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    if ((i & 31) == 0) cur = word_at(e, i >> 5);
    const bool mine = cur & 1u;
    cur >>= 1;
    if (!mine) continue;
    if (!folded && i >= fold_at) {
      fold_streams(f, accs, done, streams, lane, acc);
      folded = true;
    }
    for (int w = 0; w < sq_warps; ++w) wait_above(&produced[m][w], got);
    const int slot = got % WARPS_RING;
    uint32_t u[stark::NL29];
#pragma unroll
    for (int q = 0; q < stark::NL29; ++q) u[q] = ring[m][slot][q][lane];
    __syncwarp();
    if (lane == 0) store_release(&consumed[m], got + 1);
    ++got;
    stark::words_from_limbs29(u, x);
    stark::mont_mul(f, acc, x, t);
    stark::set_elem(acc, t);
  }
  if (m > 0) {
#pragma unroll
    for (int w = 0; w < stark::NW; ++w) accs[m][w][lane] = acc[w];
    __syncwarp();
    if (lane == 0) store_release(&done[m], 1);
    return;
  }
  if (!folded) fold_streams(f, accs, done, streams, lane, acc);
  if (lane < k) stark::store_elem(out, k, lane, acc);
}

}  // namespace
namespace {
// the kernel before this redesign: MSB-first square-and-multiply, one thread a lane
__global__ void mpow_msb(const int32_t* a, int32_t* out, int k, MpowStreams e, int nbits,
                         stark::Field f) {
  int lane = threadIdx.x;
  if (lane >= k) return;
  uint32_t x[stark::NW], acc[stark::NW], t[stark::NW];
  stark::load_elem(a, k, lane, x);
  stark::set_elem(acc, f.one);
#pragma unroll 1
  for (int i = nbits - 1; i >= 0; --i) {
    stark::mont_mul(f, acc, acc, t);
    if ((e.e[0][i >> 5] >> (i & 31)) & 1u) {
      stark::mont_mul(f, t, x, acc);
    } else {
      stark::set_elem(acc, t);
    }
  }
  stark::store_elem(out, k, lane, acc);
}
// left-to-right sliding windows: ops[2j] squarings, then times a^ops[2j+1]
// (odd, or 0 for none); the odd powers a^1, a^3, .. in shared memory
__global__ void mpow_window(const int32_t* a, int32_t* out, int k, const int* ops, int nops,
                            int w, stark::Field f) {
  __shared__ uint32_t table[16][stark::NW][32];
  int lane = threadIdx.x;
  uint32_t x[stark::NW], x2[stark::NW], acc[stark::NW], t[stark::NW];
  if (lane < k) stark::load_elem(a, k, lane, x); else for (int i = 0; i < 8; ++i) x[i] = 0;
  stark::mont_mul(f, x, x, x2);
  stark::set_elem(acc, x);
  for (int j = 0; j < (1 << (w - 1)); ++j) {
    for (int i = 0; i < 8; ++i) table[j][i][lane] = acc[i];
    stark::mont_mul(f, acc, x2, t);
    stark::set_elem(acc, t);
  }
  stark::set_elem(acc, f.one);
#pragma unroll 1
  for (int j = 0; j < nops; ++j) {
#pragma unroll 1
    for (int s = 0; s < ops[2 * j]; ++s) {
      stark::mont_mul(f, acc, acc, t);
      stark::set_elem(acc, t);
    }
    const int d = ops[2 * j + 1];
    if (d) {
      for (int i = 0; i < 8; ++i) x[i] = table[d >> 1][i][lane];
      stark::mont_mul(f, acc, x, t);
      stark::set_elem(acc, t);
    }
  }
  if (lane < k) stark::store_elem(out, k, lane, acc);
}
// KIND 0: mont_mul(a, a); 1: mont_sqr_lazy; 2: mont_sqr_lazy + cond_sub_p;
// 3: mont_sqr29. VEC: each thread its own operand (the vector datapath);
// else one operand for all (the compiler may keep it warp-uniform).
template <int KIND, bool VEC>
__global__ void chain(const uint32_t* in, uint32_t* out, int n, stark::Field f) {
  const int off = VEC ? 8 * threadIdx.x : 0;
  uint32_t a[stark::NL29], r[stark::NL29];
  for (int i = 0; i < stark::NW; ++i) a[i] = in[off + i];
  uint32_t p29[stark::NL29];
  stark::to_limbs29(f.p, p29);
  if (KIND >= 3) {
    uint32_t w[stark::NW];
    for (int i = 0; i < stark::NW; ++i) w[i] = a[i];
    stark::to_limbs29(w, a);
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if (KIND == 0) stark::mont_mul(f, a, a, r);
    if (KIND == 1 || KIND == 2) stark::mont_sqr_lazy(f, a, r);
    if (KIND == 2) stark::cond_sub_p(f, 0, r);
    if (KIND == 3) stark::mont_sqr29(p29, f.np & stark::MASK29, a, r);
    if (KIND == 4) stark::mont_sqr29_ps(p29, f.np & stark::MASK29, a, r);
    for (int j = 0; j < stark::NL29; ++j) a[j] = r[j];
  }
  for (int i = 0; i < stark::NW; ++i) out[off + i] = a[i];
}
}  // namespace
extern "C" __global__ void sass_probe_mul(const uint32_t* in, uint32_t* out, stark::Field f) {
  uint32_t a[stark::NW], b[stark::NW], r[stark::NW];
  for (int i = 0; i < stark::NW; ++i) { a[i] = in[i]; b[i] = in[8 + i]; }
  stark::mont_mul(f, a, b, r);
  for (int i = 0; i < stark::NW; ++i) out[i] = r[i];
}
extern "C" __global__ void sass_probe_sqr(const uint32_t* in, uint32_t* out, stark::Field f) {
  uint32_t a[stark::NW], r[stark::NW];
  for (int i = 0; i < stark::NW; ++i) a[i] = in[i];
  stark::mont_sqr_lazy(f, a, r);
  for (int i = 0; i < stark::NW; ++i) out[i] = r[i];
}
extern "C" __global__ void sass_probe_sqr_canonical(const uint32_t* in, uint32_t* out,
                                                    stark::Field f) {
  uint32_t a[stark::NW], r[stark::NW];
  for (int i = 0; i < stark::NW; ++i) a[i] = in[i];
  stark::mont_sqr_lazy(f, a, r);
  stark::cond_sub_p(f, 0, r);
  for (int i = 0; i < stark::NW; ++i) out[i] = r[i];
}
extern "C" __global__ void sass_probe_sqr29(const uint32_t* in, uint32_t* out, stark::Field f) {
  uint32_t a[stark::NL29], r[stark::NL29], p29[stark::NL29];
  for (int i = 0; i < stark::NL29; ++i) { a[i] = in[i]; p29[i] = in[16 + i]; }
  stark::mont_sqr29(p29, f.np & stark::MASK29, a, r);
  for (int i = 0; i < stark::NL29; ++i) out[i] = r[i];
}
extern "C" __global__ void sass_probe_sqr29_ps(const uint32_t* in, uint32_t* out,
                                                stark::Field f) {
  uint32_t a[stark::NL29], r[stark::NL29], p29[stark::NL29];
  for (int i = 0; i < stark::NL29; ++i) { a[i] = in[i]; p29[i] = in[16 + i]; }
  stark::mont_sqr29_ps(p29, f.np & stark::MASK29, a, r);
  for (int i = 0; i < stark::NL29; ++i) out[i] = r[i];
}
extern "C" int probe_chain(int kind, int vec, const void* in, void* out, int n,
                           const uint32_t* words, uint32_t np, void* stream) {
  stark::Field f = stark::make_field(words, np);
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const uint32_t*>(in);
  auto o = static_cast<uint32_t*>(out);
  if (vec) {
    if (kind == 0) chain<0, true><<<1, 32, 0, s>>>(i, o, n, f);
    if (kind == 1) chain<1, true><<<1, 32, 0, s>>>(i, o, n, f);
    if (kind == 2) chain<2, true><<<1, 32, 0, s>>>(i, o, n, f);
    if (kind == 3) chain<3, true><<<1, 32, 0, s>>>(i, o, n, f);
    if (kind == 4) chain<4, true><<<1, 32, 0, s>>>(i, o, n, f);
  } else {
    if (kind == 0) chain<0, false><<<1, 32, 0, s>>>(i, o, n, f);
    if (kind == 1) chain<1, false><<<1, 32, 0, s>>>(i, o, n, f);
    if (kind == 2) chain<2, false><<<1, 32, 0, s>>>(i, o, n, f);
    if (kind == 3) chain<3, false><<<1, 32, 0, s>>>(i, o, n, f);
    if (kind == 4) chain<4, false><<<1, 32, 0, s>>>(i, o, n, f);
  }
  return static_cast<int>(cudaGetLastError());
}
// variant 0: msb; 1: window (ops, nops, w); 2: mpow_warps_kernel<sq, lazy,
// one> with 1 + streams warps; 3: its squaring warp alone; 4: the lanes
// kernel; 5: the library's kernel; 6: its squaring warp alone (no stream:
// no result). "Alone" variants are timed only, for exponents of one bit.
template <int SQ, bool LAZY, bool ONE>
void launch_warps(int warps, const int32_t* ap, int32_t* op, int k, MpowStreams s,
                  int streams, int nbits, stark::Field f, cudaStream_t st) {
  mpow_warps_kernel<SQ, LAZY, ONE><<<1, 32 * warps, 0, st>>>(ap, op, k, s, streams, nbits, f);
}
extern "C" int probe_mpow(int variant, int sq, int lazy, int one, const void* a, void* out,
                          int k, const uint32_t* stream_words, int streams, int nbits,
                          const int* ops, int nops, int w, const uint32_t* np29,
                          const uint32_t* words, uint32_t np, void* stream) {
  const stark::Field f = stark::make_field(words, np);
  auto st = static_cast<cudaStream_t>(stream);
  auto ap = static_cast<const int32_t*>(a);
  auto op = static_cast<int32_t*>(out);
  MpowStreams s = {};
  for (int m = 0; m < streams; ++m)
    for (int i = 0; i < stark::NW; ++i) s.e[m][i] = stream_words[m * stark::NW + i];
  for (int i = 0; i < stark::NW; ++i) s.start[i] = stream_words[streams * stark::NW + i];
  Np29 n29;
  for (int i = 0; i < stark::NL29; ++i) n29.w[i] = np29[i];
  if (variant == 0) mpow_msb<<<1, 32, 0, st>>>(ap, op, k, s, nbits, f);
  if (variant == 1) mpow_window<<<1, 32, 0, st>>>(ap, op, k, ops, nops, w, f);
  if (variant == 2 || variant == 3) {
    const int warps = variant == 3 ? 1 : 1 + streams, key = 4 * sq + 2 * lazy + one;
    if (key == 0) launch_warps<0, false, false>(warps, ap, op, k, s, streams, nbits, f, st);
    if (key == 4) launch_warps<1, false, false>(warps, ap, op, k, s, streams, nbits, f, st);
    if (key == 6) launch_warps<1, true, false>(warps, ap, op, k, s, streams, nbits, f, st);
    if (key == 7) launch_warps<1, true, true>(warps, ap, op, k, s, streams, nbits, f, st);
    if (key == 10) launch_warps<2, true, false>(warps, ap, op, k, s, streams, nbits, f, st);
    if (key == 11) launch_warps<2, true, true>(warps, ap, op, k, s, streams, nbits, f, st);
  }
  if (variant == 4) {
    const int sq_warps = (k + MPOW_COLS - 1) / MPOW_COLS;
    mpow_lanes_kernel<<<1, 32 * (sq_warps + streams), 0, st>>>(ap, op, k, s, n29, streams, nbits, f);
  }
  if (variant == 5) mpow_scalar_kernel<<<1, 32 * (1 + streams), 0, st>>>(ap, op, k, s, streams, nbits, f);
  if (variant == 6) mpow_scalar_kernel<<<1, 32, 0, st>>>(ap, op, k, s, 0, nbits, f);
  return static_cast<int>(cudaGetLastError());
}
"""
CHAIN = 4096
CHAIN_KINDS = {"mont_mul": 0, "mont_sqr_lazy": 1, "mont_sqr_lazy + cond_sub_p": 2,
               "mont_sqr29": 3, "mont_sqr29_ps": 4}


def window_ops(e: int, w: int) -> list[int]:
    """Left-to-right sliding windows of e: pairs (squarings, odd digit or 0)
    such that acc = 1; for (s, d): acc = acc^(2^s) * a^d gives a^e."""
    ops, i, pending = [], e.bit_length() - 1, 0
    while i >= 0:
        if not (e >> i) & 1:
            pending += 1
            i -= 1
            continue
        lo = max(i - w + 1, 0)
        while not (e >> lo) & 1:
            lo += 1
        d = (e >> lo) & ((1 << (i - lo + 1)) - 1)
        ops += [pending + i - lo + 1, d]
        pending, i = 0, lo - 1
    return ops + ([pending, 0] if pending else [])


def _load_probe(tmp: str):
    from stark_tpu_torch.ops import build
    from ntt_kernels_cuda import _tool

    src, so = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    done = subprocess.run([_tool("nvcc"), *build.NVCC_FLAGS, "-shared", "-I", build.CSRC,
                           "-o", so, src], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on the probe:\n{done.stdout}{done.stderr}")
    log = (done.stdout + done.stderr).splitlines()
    ptxas = [" ".join(x.strip() for x in log[i : i + 4]) for i, ln in enumerate(log)
             if "Compiling entry" in ln and ("mpow" in ln or "chain" in ln)]
    lib = ctypes.CDLL(so)
    vp, u32p, ci = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int
    lib.probe_chain.argtypes = [ci, ci, vp, vp, ci, u32p, ctypes.c_uint32, vp]
    lib.probe_mpow.argtypes = [ci, ci, ci, ci, vp, vp, ci, u32p, ci, ci, vp, ci, ci, u32p,
                               u32p, ctypes.c_uint32, vp]
    return lib, so, ptxas


def step_records(spec, lib, so) -> dict:
    """SASS instructions of a product and a square, and one dependent step
    of each on the vector datapath (32 threads, each its own operand) and
    with one operand for the warp (`uniform`: the compiler may use the
    warp-uniform datapath)."""
    from ntt_kernels_cuda import NOT_COUNTED, sass_opcodes

    from stark_tpu_torch.ops import field_cuda as fc

    out = {}
    for kind in ("mul", "sqr", "sqr_canonical", "sqr29", "sqr29_ps"):
        ops = sass_opcodes(so, f"sass_probe_{kind}")
        counted = {k: v for k, v in ops.items() if k not in NOT_COUNTED}
        out[f"sass_{kind}"] = {"instructions": sum(counted.values()),
                               "top": sorted(counted.items(), key=lambda kv: -kv[1])[:6]}
    _, _, words, np32 = fc._consts(spec)
    vals = [fc._words8((spec.r_mod_p + 12345 * (t + 1)) % spec.p) for t in range(32)]
    start = torch.tensor(np.array(vals, dtype=np.uint32).view(np.int32).reshape(-1),
                         device="cuda")
    res = torch.empty_like(start)
    stream = torch.cuda.current_stream().cuda_stream
    for name, kind in CHAIN_KINDS.items():
        for vec in (1, 0):
            times = {}
            for n in (0, CHAIN):
                ms = []
                for _ in range(5):
                    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    begin.record()
                    rc = lib.probe_chain(kind, vec, start.data_ptr(), res.data_ptr(), n, words,
                                         np32, stream)
                    end.record()
                    end.synchronize()
                    if rc:
                        raise RuntimeError(f"probe_chain returned {rc}")
                    ms.append(begin.elapsed_time(end))
                times[n] = sorted(ms)[2]
            form = "vector" if vec else "uniform"
            out[f"dependent_step_us {name} {form}"] = (times[CHAIN] - times[0]) / CHAIN * 1e3
    return out


def kernel_variants(spec, e: int) -> dict:
    """name -> (variant, sq, lazy, one, streams, ops, w): see the probe."""
    from stark_tpu_torch.fields.field import BN254_FR

    out = {}
    if spec is BN254_FR:
        out["msb"] = (0, 0, 0, 0, 1, [], 0)
        for w in (3, 4, 5):
            out[f"window w={w}"] = (1, 0, 0, 0, 1, window_ops(e, w), w)
        for st in (1, 2):
            out[f"warps mul s={st}"] = (2, 0, 0, 0, st, [], 0)
            out[f"warps sqr s={st}"] = (2, 1, 0, 0, st, [], 0)
            out[f"warps lazy s={st}"] = (2, 1, 1, 0, st, [], 0)
            out[f"warps sqr29 s={st}"] = (2, 2, 1, 0, st, [], 0)
    for st in (1, 2):
        out[f"lanes s={st}"] = (4, 2, 1, 0, st, [], 0)
    for st in (1, 2):
        out[f"ring s={st}"] = (5, 2, 1, 0, st, [], 0)
    return out


def run_variant(lib, spec, v, a, got, e: int):
    """A function of no arguments that launches variant v on a into got."""
    from stark_tpu_torch.ops import field_cuda as fc

    variant, sq, lazy, one, streams, ops, w = v
    _, _, words, np32 = fc._consts(spec)
    parts = [e] if variant < 2 else fc.mpow_streams(e, max(streams, 1))
    sw = fc.mpow_words(spec, e, parts)
    if sq < 2:  # the squarings of R = 2^256 start from Montgomery one
        sw[8 * len(parts) : 8 * len(parts) + 8] = fc._words8(spec.r_mod_p)
    n29 = (-pow(spec.p, -1, 1 << 261)) % (1 << 261)
    np29 = (ctypes.c_uint32 * 9)(*[(n29 >> (29 * i)) & ((1 << 29) - 1) for i in range(9)])
    dops = torch.tensor(ops or [0], dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        rc = lib.probe_mpow(variant, sq, lazy, one, a.data_ptr(), got.data_ptr(), a.shape[1],
                            sw, len(parts), max(e.bit_length(), 1), dops.data_ptr(),
                            len(ops) // 2, w, np29, words, np32, stream)
        if rc:
            raise RuntimeError(f"probe_mpow returned {rc}")

    return run


def variant_records(lib, rng) -> list[dict]:
    """Each variant at (16, 1) and (16, 8), e = p - 2, against the plain
    version (a variant of one column only at (16, 1))."""
    import chip_smoke

    from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR
    from stark_tpu_torch.ops import field_cuda as fc

    out = []
    for spec in (BN254_FR, BLS12_381_FR):
        e = spec.p - 2
        for k in ((1, 8) if spec is BN254_FR else (1,)):
            a = chip_smoke.with_edges(spec, chip_smoke.random_planes(rng, spec, k, "cuda"))
            want = fc.mpow_scalar_plain(spec, a, e)
            row = {"field": spec.name, "shape": [16, k], "e": "p-2", "ms": {}}
            variants = {"kernel": None, **kernel_variants(spec, e)}
            for name, v in variants.items():
                if v is not None and v[3] and k > 1:
                    continue
                got = torch.empty_like(a)
                if v is None:
                    run = lambda: fc.mpow_scalar(spec, a, e)  # noqa: E731
                    got = run()
                else:
                    run = run_variant(lib, spec, v, a, got, e)
                    run()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"mpow {name} {spec.name} (16,{k}): != plain")
                row["ms"][name] = chip_smoke.median_ms(run, 10)
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


def overhead_records(lib, rng) -> dict:
    """The library's kernel (BN254, (16, 1)) on exponents that isolate its
    parts: 2^253 (253 squarings, one value multiplied in) with one and three
    multiply warps and with the squaring warp alone (`alone`: no multiply
    warp, so no result: timed only), and 2^254 - 1 (every one of the 254
    values multiplied in); the squaring warp of the first design (counters,
    a square handed over at a time) alone beside it."""
    import chip_smoke

    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import field_cuda as fc

    a = chip_smoke.random_planes(rng, spec, 1, "cuda")
    got = torch.empty_like(a)
    out = {}
    for label, e, variant, streams in (("2^253 s=1", 1 << 253, 5, 1),
                                       ("2^253 s=2", 1 << 253, 5, 2),
                                       ("2^253 alone", 1 << 253, 6, 1),
                                       ("2^253 alone, counters", 1 << 253, 3, 1),
                                       ("2^254-1 s=1", (1 << 254) - 1, 5, 1),
                                       ("2^254-1 s=2", (1 << 254) - 1, 5, 2)):
        run = run_variant(lib, spec, (variant, 2, 1, 0, streams, [], 0), a, got, e)
        run()
        torch.cuda.synchronize()
        if variant == 5 and not torch.equal(got, fc.mpow_scalar_plain(spec, a, e)):
            raise AssertionError(f"mpow e={label}: kernel != plain")
        out[label] = chip_smoke.median_ms(run, 10)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records to DIR/mpow_kernels.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mpow_kernels_cuda: no CUDA device", file=sys.stderr)
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
             if "Compiling entry" in ln and "mpow" in ln]
    records = [{"nvidia_smi": smi, "build_s": time.time() - t0, "ptxas": ptxas}]
    print(json.dumps(records[-1]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        lib, probe_so, probe_ptxas = _load_probe(tmp)
        records.append({"probe_ptxas": probe_ptxas, **step_records(spec, lib, probe_so)})
        print(json.dumps(records[-1]), flush=True)
        rng = np.random.default_rng(chip_smoke.SEED + 5)
        records.append({"variants": variant_records(lib, rng)})
        records.append({"overhead_ms": overhead_records(lib, rng)})
        print(json.dumps(records[-1]), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "mpow_kernels.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
