#!/usr/bin/env python3
"""Measure the two protocol kernels redesigned for the H100
(`stark_tpu_torch/csrc/protocol.cu`: `linear_combination_shoup`, `q2_eval`),
each step of their design, and what a product costs at full occupancy, on
one NVIDIA GPU, without the rest of `chip_smoke.py`.

    python3 scripts/protocol_kernels_cuda.py [--out DIR] [--reps 20]

The probe source below includes `protocol.cu` and adds:
  `linear_combination_shoup` variants at (16, 2^20), a (16, 8) pattern:
    `parent`: the kernel before the redesign, 14 products (11 CIOS products
        by k_j, 3 Shoup products by x^steps) and 10 modular additions, each
        plane loaded just before its product;
    `coef`: step 1 alone, the x^steps terms folded into three coefficients
        per pattern column staged by the block (`stage_lincomb_shoup`): 8
        CIOS products and 7 additions;
    `lazy`: step 2, the 8 products summed wide and reduced once
        (`mac_wide`, `redc_wide`), each plane loaded just before its product;
    `prefetch`, `prefetch_b1`, `prefetch_b3`, `prefetch_b4`: step 3, the
        next plane's loads issued before the current product
        (`lincomb_lazy`, the kernel's sum) under `__launch_bounds__(256, m)`
        for m = 2, 1, 3 (the kernel's) and 4 blocks an SM;
    `kernel`: the wrapper `fused_kernels.linear_combination_shoup`;
  `q2_eval` at (16, 2^20), the prover's kshift 349,520 and kshift 0 (the
    three reads of P at one element):
    `parent`: one output a thread in order, P read at i, i + k, i + 2k;
    `triple`: three outputs a thread, g, g + k, g + 2k for g < k (3k <= n),
        P read at g .. g + 4k by one thread; `triple_wide`, `triple_cios`:
        the same with `mont_mul_wide` (the lazy sum's rows for one product)
        and `mont_mul_cios` (the CIOS product in PTX carry chains, as
        `ntt.cu` forms it) in place of field.cuh's `mont_mul`; `triple_b4`,
        `triple_wide_b4`, `triple_cios_b3`: under 4 or 3 blocks an SM;
        `triple_128`: blocks of 128;
    `kernel`: the wrapper, one output a thread in `fused_kernels.q2_plan`'s
        order (slices of three warps);
  the product at full occupancy: a grid of 2^20 threads, 256 a block, each
    thread a chain of `--chain` dependent products on its own operands:
    `mont_mul` (field.cuh's CIOS product), `wide` (`mac_wide`: a 256 x 256
    product summed into 17 words, no reduction), `shoup` (field.cuh's
    `shoup_mul`), `mont_mul_wide`, `mont_mul_cios`, each as thread products
    a second, SM clocks a thread product at the card's highest SM clock,
    and the SASS instructions of one product (the chain kernel's static
    count less that of the same kernel without the product).
Printed first: the card's name and power limit; what `ptxas -v` said of
every probe kernel (registers, spill bytes) and its static SASS count;
then each variant's median device time over `--reps` runs in two passes
(forward, then backward). Every variant is held against the plain version
(`torch.equal`) on random canonical planes with p - 1 and 0 at the edges
(`chip_smoke.with_edges`) and k with p - 1 among its columns. With `--out`
the records go to DIR/protocol_kernels.json and the SASS of the probe's
linear combination, q2 and product kernels to DIR/protocol_probe.sass.
Exits non-zero without a card. Needs `nvcc` and `cuobjdump`; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
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

SEED = 20261018
N = 1 << 20
KSHIFT = (1 << 17) // 3 * 8  # the prover's at steps 2^17, skips 8
SKIPS = 8
LINCOMB = ("parent", "coef", "lazy", "prefetch", "prefetch_b1", "prefetch_b3", "prefetch_b4",
           "kernel")
Q2 = ("parent", "triple", "triple_wide", "triple_b4", "triple_wide_b4", "triple_cios",
      "triple_cios_b3", "triple_128", "kernel")
THROUGHPUT = ("mont_mul", "wide", "shoup", "mont_mul_wide", "mont_mul_cios")
THREADS_TPUT = 1 << 20

PROBE = r"""
#include "protocol.cu"

namespace {

// --- the parent: 14 products, term by term -----------------------------------

__device__ __forceinline__ void parent_term(const Field& f, const uint32_t kj[NW],
                                            const uint32_t term[NW], uint32_t acc[NW]) {
  uint32_t t[NW], u[NW];
  stark::mont_mul(f, kj, term, t);
  stark::mod_add(f, acc, t, u);
  stark::set_elem(acc, u);
}

__global__ void __launch_bounds__(THREADS)
parent_lincomb_kernel(const int32_t* __restrict__ k, const int32_t* __restrict__ xw_pat,
                      const int32_t* __restrict__ xwp_pat, int64_t t, LincombCols c,
                      int32_t* __restrict__ out, int64_t n, Field f) {
  __shared__ uint32_t ks[11][NW];
  __shared__ PatternTile tile;
  int64_t i = global_index();
  stage_cols(k, 11, 0, 11, ks);
  int row = stage_pattern(xw_pat, xwp_pat, t, i, tile);
  __syncthreads();
  if (i >= n) return;
  const uint32_t *w = tile.w[row], *wp = tile.wp[row];
  uint32_t acc[NW], v[NW], x[NW];
  stark::load_elem(c.col[3], n, i, v);
  stark::mont_mul(f, ks[0], v, acc);
  stark::load_elem(c.col[4], n, i, v);
  parent_term(f, ks[1], v, acc);
  stark::load_elem(c.col[5], n, i, v);
  parent_term(f, ks[2], v, acc);
#pragma unroll
  for (int m = 0; m < 3; ++m) {  // P, B2, B3 and their x^steps terms
    stark::load_elem(c.col[m == 0 ? 0 : 5 + m], n, i, v);
    parent_term(f, ks[3 + 2 * m], v, acc);
    stark::shoup_mul(f, w, wp, v, x);
    parent_term(f, ks[4 + 2 * m], x, acc);
  }
  stark::load_elem(c.col[1], n, i, v);
  parent_term(f, ks[9], v, acc);
  stark::load_elem(c.col[2], n, i, v);
  parent_term(f, ks[10], v, acc);
  stark::store_elem(out, n, i, acc);
}

// --- coef: the x terms folded into coefficients, 8 CIOS products --------------

__global__ void __launch_bounds__(THREADS, 2)
coef_lincomb_kernel(const int32_t* __restrict__ k, const int32_t* __restrict__ xw_pat,
                    const int32_t* __restrict__ xwp_pat, int64_t t, LincombCols c,
                    int32_t* __restrict__ out, int64_t n, Field f) {
  __shared__ LincombTile tile;
  const int64_t i = global_index();
  const int row = stage_lincomb_shoup(f, k, xw_pat, xwp_pat, t, i, tile);
  if (i >= n) return;
  uint32_t acc[NW], v[NW], u[NW], s[NW];
#pragma unroll
  for (int j = 0; j < LC_PLANES; ++j) {
    stark::load_elem(c.col[j], n, i, v);
    const uint32_t* src = lc_x(j) >= 0 ? tile.cx[row] + lc_x(j) * NW : tile.ks[lc_k(j)];
    if (j == 0) {
      stark::mont_mul(f, src, v, acc);
    } else {
      stark::mont_mul(f, src, v, u);
      stark::mod_add(f, acc, u, s);
      stark::set_elem(acc, s);
    }
  }
  stark::store_elem(out, n, i, acc);
}

// --- lazy: the kernel's sum, each plane loaded just before its product --------

template <int MINB, bool PREFETCH>
__global__ void __launch_bounds__(THREADS, MINB)
lazy_lincomb_kernel(const int32_t* __restrict__ k, const int32_t* __restrict__ xw_pat,
                    const int32_t* __restrict__ xwp_pat, int64_t t, LincombCols c,
                    int32_t* __restrict__ out, int64_t n, Field f) {
  __shared__ LincombTile tile;
  const int64_t i = global_index();
  uint32_t raw[stark::LIMBS];
  if (PREFETCH && i < n) load_limbs(c.col[0], n, i, raw);
  const int row = stage_lincomb_shoup(f, k, xw_pat, xwp_pat, t, i, tile);
  if (i >= n) return;
  if (PREFETCH) {
    lincomb_lazy(f, tile, tile.cx[row], c, n, i, raw, out);
    return;
  }
  uint32_t acc[WIDE], v[NW], kw[NW];
#pragma unroll
  for (int w = 0; w < WIDE; ++w) acc[w] = 0;
#pragma unroll
  for (int j = 0; j < LC_PLANES; ++j) {
    stark::load_elem(c.col[j], n, i, v);
    const uint32_t* src = lc_x(j) >= 0 ? tile.cx[row] + lc_x(j) * NW : tile.ks[lc_k(j)];
#pragma unroll
    for (int w = 0; w < NW; ++w) kw[w] = src[w];
    mac_wide(acc, kw, v);
  }
  redc_wide(f, acc);
  uint32_t r[NW + 1];
#pragma unroll
  for (int w = 0; w <= NW; ++w) r[w] = acc[NW + w];
  reduce_below_8p(f, r);
  stark::store_elem(out, n, i, r);
}

// --- q2: the parent, one output a thread ---------------------------------------

__global__ void __launch_bounds__(THREADS)
parent_q2_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ f2,
                 int32_t* __restrict__ out, int64_t n, int64_t k1, int64_t k2, Field f) {
  int64_t i = global_index();
  if (i >= n) return;
  int64_t i1 = i + k1 < n ? i + k1 : i + k1 - n;
  int64_t i2 = i + k2 < n ? i + k2 : i + k2 - n;
  uint32_t a[NW], b[NW], t[NW], u[NW];
  stark::load_elem(p, n, i, a);
  stark::load_elem(p, n, i1, b);
  stark::mont_mul(f, a, b, t);
  stark::load_elem(p, n, i2, a);
  stark::mod_sub(f, a, t, u);
  stark::load_elem(f2, n, i, a);
  stark::mont_mul(f, a, u, t);
  stark::store_elem(out, n, i, t);
}

// --- one Montgomery product by the lazy sum's rows -------------------------------

// a*b*2^-256 mod p (a, b < p): the 512-bit product, one reduction
// (T < p^2/2^256 + p < 2p), one conditional subtraction
__device__ __forceinline__ void mont_mul_wide(const Field& f, const uint32_t (&a)[NW],
                                              const uint32_t (&b)[NW],
                                              uint32_t (&r)[NW]) {
  uint32_t acc[WIDE];
#pragma unroll
  for (int w = 0; w < WIDE; ++w) acc[w] = 0;
  mac_wide(acc, a, b);
  redc_wide(f, acc);
#pragma unroll
  for (int w = 0; w < NW; ++w) r[w] = acc[NW + w];
  stark::cond_sub_p(f, acc[2 * NW], r);
}

// --- the CIOS product in PTX carry chains (ntt.cu's mont_mul_lazy) ---------------

__device__ __forceinline__ void cios_lo_row(uint32_t (&t)[NW + 1], const uint32_t (&a)[NW],
                                            uint32_t b) {
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
}

__device__ __forceinline__ void cios_hi_row(uint32_t (&t)[NW + 1], const uint32_t (&a)[NW],
                                            uint32_t b) {
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

// a*b*2^-256 mod p, canonical, for a, b < p: ntt.cu's CIOS rows (t below
// 2^288 throughout), then one conditional subtraction
__device__ __forceinline__ void mont_mul_cios(const Field& f, const uint32_t (&a)[NW],
                                              const uint32_t (&b)[NW], uint32_t (&r)[NW]) {
  uint32_t t[NW + 1];
#pragma unroll
  for (int i = 0; i <= NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    cios_lo_row(t, a, b[i]);
    cios_hi_row(t, a, b[i]);
    const uint32_t m = t[0] * f.np;
    cios_lo_row(t, f.p, m);
    cios_hi_row(t, f.p, m);
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
    t[NW] = 0;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = t[i];
  stark::cond_sub_p(f, 0, r);
}

// --- q2, three outputs a thread, under each product -------------------------------------

// PRODUCT 0: field.cuh's mont_mul, 1: mont_mul_wide, 2: mont_mul_cios
template <int PRODUCT>
__device__ __forceinline__ void q2_mul(const Field& f, const uint32_t (&a)[NW],
                                       const uint32_t (&b)[NW], uint32_t (&r)[NW]) {
  if (PRODUCT == 1) {
    mont_mul_wide(f, a, b, r);
  } else if (PRODUCT == 2) {
    mont_mul_cios(f, a, b, r);
  } else {
    stark::mont_mul(f, a, b, r);
  }
}

template <int PRODUCT>
__device__ __forceinline__ void q2_probe_one(const Field& f, const uint32_t (&p0)[NW],
                                             const uint32_t (&p1)[NW],
                                             const uint32_t (&p2)[NW],
                                             const int32_t* __restrict__ f2,
                                             int32_t* __restrict__ out, int64_t n, int64_t i) {
  uint32_t t[NW], u[NW], w[NW];
  q2_mul<PRODUCT>(f, p0, p1, t);
  stark::mod_sub(f, p2, t, u);
  stark::load_elem(f2, n, i, w);
  q2_mul<PRODUCT>(f, w, u, t);
  stark::store_elem(out, n, i, t);
}

template <int PRODUCT, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
q2_probe_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ f2,
                int32_t* __restrict__ out, int64_t n, int64_t k1, int64_t k2, int64_t span,
                Field f) {
  const int64_t g = global_index();
  uint32_t a[NW], b[NW], c[NW], d[NW];
  if (g < span) {
    const int64_t i1 = g + k1, i2 = i1 + k1;
    const int64_t i3 = i2 + k1 < n ? i2 + k1 : i2 + k1 - n;
    const int64_t i4 = i3 + k1 < n ? i3 + k1 : i3 + k1 - n;
    stark::load_elem(p, n, g, a);
    stark::load_elem(p, n, i1, b);
    stark::load_elem(p, n, i2, c);
    stark::load_elem(p, n, i3, d);
    q2_probe_one<PRODUCT>(f, a, b, c, f2, out, n, g);
    stark::load_elem(p, n, i4, a);
    q2_probe_one<PRODUCT>(f, b, c, d, f2, out, n, i1);
    q2_probe_one<PRODUCT>(f, c, d, a, f2, out, n, i2);
    return;
  }
  const int64_t i = g + 2 * span;
  if (i >= n) return;
  const int64_t i1 = i + k1 < n ? i + k1 : i + k1 - n;
  const int64_t i2 = i + k2 < n ? i + k2 : i + k2 - n;
  stark::load_elem(p, n, i, a);
  stark::load_elem(p, n, i1, b);
  stark::load_elem(p, n, i2, c);
  q2_probe_one<PRODUCT>(f, a, b, c, f2, out, n, i);
}

// --- a product's cost at full occupancy ------------------------------------------

// operands below 2^252 from the thread index (below p on both fields)
__device__ __forceinline__ void seed_elem(uint32_t x[NW], uint32_t s) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    s = s * 1664525u + 1013904223u;
    x[w] = s;
  }
  x[NW - 1] &= 0x0FFFFFFFu;
}

// KIND 0: mont_mul, 1: mac_wide, 2: shoup_mul, 3: mont_mul_wide, 4:
// mont_mul_cios; DO = false leaves out the
// products (the same kernel's other instructions, to subtract)
template <int KIND, bool DO>
__global__ void __launch_bounds__(THREADS)
tput_kernel(uint32_t* __restrict__ out, int chain, Field f) {
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
        stark::shoup_mul(f, b, a, a, r);
      } else if (KIND == 3) {
        mont_mul_wide(f, a, b, r);
      } else {
        mont_mul_cios(f, a, b, r);
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

}  // namespace

// variant: 0 parent, 1 coef, 2 lazy, 3 prefetch, 4 prefetch_b1, 5 prefetch_b3,
// 6 prefetch_b4;
// cols: 8 device pointers p, a, s, d1, d2, d3, b2, b3
extern "C" int probe_lincomb(int variant, const void* k, const void* xw, const void* xwp,
                             long long t, const void* const* cols, void* out, long long n,
                             const uint32_t* field_words, uint32_t np, void* stream) {
  LincombCols c;
  for (int j = 0; j < LC_PLANES; ++j) c.col[j] = in(cols[j]);
  const Field f = stark::make_field(field_words, np);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n);
  const auto K = in(k), W = in(xw), WP = in(xwp);
  auto* o = outp(out);
  switch (variant) {
    case 0: parent_lincomb_kernel<<<blocks, THREADS, 0, st>>>(K, W, WP, t, c, o, n, f); break;
    case 1: coef_lincomb_kernel<<<blocks, THREADS, 0, st>>>(K, W, WP, t, c, o, n, f); break;
    case 2: lazy_lincomb_kernel<2, false><<<blocks, THREADS, 0, st>>>(K, W, WP, t, c, o, n, f); break;
    case 3: lazy_lincomb_kernel<2, true><<<blocks, THREADS, 0, st>>>(K, W, WP, t, c, o, n, f); break;
    case 4: lazy_lincomb_kernel<1, true><<<blocks, THREADS, 0, st>>>(K, W, WP, t, c, o, n, f); break;
    case 5: lazy_lincomb_kernel<3, true><<<blocks, THREADS, 0, st>>>(K, W, WP, t, c, o, n, f); break;
    case 6: lazy_lincomb_kernel<4, true><<<blocks, THREADS, 0, st>>>(K, W, WP, t, c, o, n, f); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q2 variant: 0 the parent (straight order, k1, k2 only); three outputs a
// thread (g, g + k1, g + 2k1 for g < span) with 1 field.cuh's product, 2
// mont_mul_wide, 3 variant 1 under four blocks an SM, 4 variant 2 under four,
// 5 mont_mul_cios, 6 variant 5 under three, 7 variant 1 in blocks of 128
extern "C" int probe_q2(int variant, const void* p, const void* f2, void* out, long long n,
                        long long k1, long long k2, long long span,
                        const uint32_t* field_words, uint32_t np, void* stream) {
  const Field f = stark::make_field(field_words, np);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(variant == 0 ? n : n - 2 * span);
  const auto P = in(p), F = in(f2);
  auto* o = outp(out);
  switch (variant) {
    case 0: parent_q2_kernel<<<blocks, THREADS, 0, st>>>(P, F, o, n, k1, k2, f); break;
    case 1: q2_probe_kernel<0, 1><<<blocks, THREADS, 0, st>>>(P, F, o, n, k1, k2, span, f); break;
    case 2: q2_probe_kernel<1, 1><<<blocks, THREADS, 0, st>>>(P, F, o, n, k1, k2, span, f); break;
    case 3: q2_probe_kernel<0, 4><<<blocks, THREADS, 0, st>>>(P, F, o, n, k1, k2, span, f); break;
    case 4: q2_probe_kernel<1, 4><<<blocks, THREADS, 0, st>>>(P, F, o, n, k1, k2, span, f); break;
    case 5: q2_probe_kernel<2, 1><<<blocks, THREADS, 0, st>>>(P, F, o, n, k1, k2, span, f); break;
    case 6: q2_probe_kernel<2, 3><<<blocks, THREADS, 0, st>>>(P, F, o, n, k1, k2, span, f); break;
    case 7: q2_probe_kernel<0, 1><<<blocks_for(2 * (n - 2 * span)), 128, 0, st>>>(
                P, F, o, n, k1, k2, span, f);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 mont_mul, 1 wide, 2 shoup, 3 mont_mul_wide, 4 mont_mul_cios;
// with_products = 0 runs the same chain
// without them
extern "C" int probe_tput(int kind, int with_products, void* out, long long threads,
                          int chain, const uint32_t* field_words, uint32_t np,
                          void* stream) {
  const Field f = stark::make_field(field_words, np);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  const unsigned blocks = blocks_for(threads);
  switch (kind * 2 + (with_products ? 1 : 0)) {
    case 0: tput_kernel<0, false><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    case 1: tput_kernel<0, true><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    case 2: tput_kernel<1, false><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    case 3: tput_kernel<1, true><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    case 4: tput_kernel<2, false><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    case 5: tput_kernel<2, true><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    case 6: tput_kernel<3, false><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    case 7: tput_kernel<3, true><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    case 8: tput_kernel<4, false><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    case 9: tput_kernel<4, true><<<blocks, THREADS, 0, st>>>(o, chain, f); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found")
    return path


def build_probe(tmp: str):
    """Compile the probe beside `csrc/` into a shared library; returns it,
    {kernel: [registers, spill store bytes]} from `ptxas -v` and {kernel:
    static SASS instructions} from `cuobjdump -sass`."""
    from stark_tpu_torch.ops import build

    src, so = os.path.join(tmp, "protocol_probe.cu"), os.path.join(tmp, "protocol_probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared", "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    _vp, _ll, _u32p = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32)
    _i, _u = ctypes.c_int, ctypes.c_uint32
    lib.probe_lincomb.argtypes = [_i, _vp, _vp, _vp, _ll, ctypes.POINTER(_vp), _vp, _ll,
                                  _u32p, _u, _vp]
    lib.probe_q2.argtypes = [_i, _vp, _vp, _vp, _ll, _ll, _ll, _ll, _u32p, _u, _vp]
    lib.probe_tput.argtypes = [_i, _i, _vp, _ll, _i, _u32p, _u, _vp]
    for fn in (lib.probe_lincomb, lib.probe_q2, lib.probe_tput):
        fn.restype = ctypes.c_int
    return lib, ptxas_usage(proc.stdout + proc.stderr), sass_counts(so), so


def ptxas_usage(log: str) -> dict:
    """{kernel: [registers, spill store bytes]} of a `ptxas -v` log."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            usage[name] = [None, None]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and usage[name][1] is None:
            usage[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and usage[name][0] is None:
            usage[name][0] = int(m.group(1))
    return usage


def sass_counts(library: str) -> dict:
    """{kernel (mangled): static SASS instructions} of a built library."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", ln):
            out[name] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records to DIR/protocol_kernels.json")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--chain", type=int, default=64,
                    help="dependent products a thread in the throughput probes")
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
        lib, usage, sass, so = build_probe(tmp)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            text = subprocess.run([_tool("cuobjdump"), "-sass", so], capture_output=True,
                                  text=True, check=True).stdout
            text = re.sub(r"\s*/\* 0x[0-9a-f]+ \*/", "", text)  # the encodings
            with open(os.path.join(args.out, "protocol_probe.sass"), "w") as f:
                f.writelines(part for part in re.split(r"(?=\n\s*Function : )", text)
                             if re.search(r"lincomb|linear_comb|q2_|tput", part[:200]))
    print(json.dumps({"ptxas": usage, "sass": sass}), flush=True)

    rng = np.random.default_rng(SEED)
    rand = lambda n: chip_smoke.random_planes(rng, spec, n, device)  # noqa: E731
    consts = [0, 1, spec.p - 1] + [int.from_bytes(rng.bytes(32), "little") % spec.p
                                   for _ in range(SKIPS - 3)]
    pats = mm.shoup_consts(spec, consts, device)
    k11 = chip_smoke.with_edges(spec, rand(11))
    cols = [chip_smoke.with_edges(spec, rand(N)) for _ in range(8)]
    ptrs = (ctypes.c_void_p * 8)(*[c.data_ptr() for c in cols])
    words, np32, stream = fc.cuda_args(spec, cols[0])
    want_l = fk.linear_combination_shoup_plain(spec, k11, *pats, *cols)
    p_ev, f2 = cols[0], cols[1]
    want_q = {ks: fk.q2_eval_plain(spec, p_ev, f2, ks) for ks in (KSHIFT, 0)}

    def lincomb_call(variant):
        if variant == "kernel":
            return lambda: fk.linear_combination_shoup(spec, k11, *pats, *cols)
        out = torch.empty_like(cols[0])

        def run():
            rc = lib.probe_lincomb(LINCOMB.index(variant), k11.data_ptr(), pats[0].data_ptr(),
                                   pats[1].data_ptr(), SKIPS, ptrs, out.data_ptr(), N,
                                   words, np32, stream)
            if rc:
                raise RuntimeError(f"lincomb {variant}: CUDA error {rc}")
            return out
        return run

    def q2_call(variant, ks):
        if variant == "kernel":
            return lambda: fk.q2_eval(spec, p_ev, f2, ks)
        out = torch.empty_like(p_ev)

        k1, k2, span = fk.q2_plan(N, ks)

        def run():
            rc = lib.probe_q2(Q2.index(variant), p_ev.data_ptr(), f2.data_ptr(), out.data_ptr(),
                              N, k1, k2, span, words, np32, stream)
            if rc:
                raise RuntimeError(f"q2 {variant}: CUDA error {rc}")
            return out
        return run

    calls = {f"lincomb {v}": (lincomb_call(v), want_l) for v in LINCOMB}
    calls.update({f"q2 {v} kshift={ks}": (q2_call(v, ks), want_q[ks])
                  for v in Q2 for ks in (KSHIFT, 0)})
    times = {label: [] for label in calls}
    for order in (list(calls), list(calls)[::-1]):
        for label in order:
            fn, want = calls[label]
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{label} differs from the plain version")
            times[label].append(chip_smoke.median_ms(fn, args.reps))

    tput_out = torch.empty(THREADS_TPUT, dtype=torch.int32, device=device)
    tput = {}
    for kind, name in enumerate(THROUGHPUT):
        ms = {}
        for with_products in (0, 1):
            def run(kind=kind, with_products=with_products):
                rc = lib.probe_tput(kind, with_products, tput_out.data_ptr(), THREADS_TPUT,
                                    args.chain, words, np32, stream)
                if rc:
                    raise RuntimeError(f"throughput {name}: CUDA error {rc}")
            ms[with_products] = [chip_smoke.median_ms(run, args.reps) for _ in range(2)]
        products = THREADS_TPUT * args.chain
        net_ms = min(ms[1]) - min(ms[0])
        static = [next((v for k, v in sass.items()
                        if "tput_kernel" in k and f"ILi{kind}ELb{b}E" in k), None)
                  for b in (1, 0)]
        tput[name] = {"ms": ms[1], "ms_without": ms[0],
                      "thread_products_per_s": products / (net_ms * 1e-3),
                      "sm_clocks_per_thread_product": net_ms * 1e-3 * sm_hz * sms / products,
                      "sass_per_product": (static[0] - static[1]
                                           if None not in static else None)}
    del lib

    print(json.dumps({"times_ms": times, "throughput": tput}), flush=True)
    print(f"median device ms of {args.reps}, forward / backward pass; {card}")
    for label, (a, b) in times.items():
        print(f"| {label} | {a:.4f} / {b:.4f} |")
    for name, t in tput.items():
        print(f"| {name} | {t['thread_products_per_s']:.4g} thread products/s | "
              f"{t['sm_clocks_per_thread_product']:.3f} SM clocks a thread product | "
              f"{t['sass_per_product']} SASS instructions |")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "protocol_kernels.json"), "w") as f:
            json.dump({"card": card, "sm_hz": sm_hz, "sms": sms, "reps": args.reps,
                       "chain": args.chain, "ptxas": usage, "sass": sass, "times_ms": times,
                       "throughput": tput}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
