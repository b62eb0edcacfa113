#!/usr/bin/env python3
"""Measure the PyTorch/CUDA port's two FRI fold kernels
(`stark_tpu_torch/csrc/fri.cu`: `fri_fold_pre`, `fri_fold_post`) and each
step of their design on one NVIDIA GPU, without the rest of `chip_smoke.py`.

    python3 scripts/fri_fold_variants_cuda.py [--out DIR] [--reps 20]

The probe source below includes `fri.cu` and adds the variants, each a pair
(pre, post) of the new interface (pre: x -> the denominators; post: sx, x,
y, inverted denominators -> the folded column) but the first:
  `parent`: the kernels before the redesign, one thread a row, the TPU
      pair's split (pre writes the four cubics of each row beside the
      denominators, post reads them back), under `__launch_bounds__(128, 4)`;
  `row`: step 1 alone, products of differences (pre 8 products a row, post
      14) and no cubics, one thread a row;
  `quad`: step 2, a row over a quad of lanes, one member a lane, the x (in
      post the differences sx - x) traded by `__shfl_xor_sync`: pre 2
      products a lane (`fri.cu`'s pre), post 4 (16 a row);
  `warps`: step 2 the other way, four warps a block, one member a warp, 32
      rows a block, trading through shared memory;
  `tile`: step 3, `warps` with the block's x (and y, inverses) staged in
      shared memory by 16-byte loads and its outputs stored by 16-byte
      stores (q a multiple of 4);
  `persist`: step 3, `quad` on a persistent grid, as many blocks as the card
      holds at once, each walking the tiles of 32 rows;
  `pair`: `quad`'s pre, and post over a pair of lanes, two members a lane:
      7 products a lane, the 14 a row that the function needs (`fri.cu`);
  `quad29`, `pair29`: post as `quad`, `pair` with radix-2^29 products
      (R' = 2^261), one more product a lane by 2^281 mod p to take out
      their factors of 2^-5;
  `kernel`: the wrappers `fused_kernels.fri_fold_pre` / `fri_fold_post`.
Printed first: the card's name and power limit; then what `ptxas -v` said
of every probe kernel (registers, spill bytes); then, for each variant and
each round's q (2^18 .. 2^6) and q = 192, the median device time of each
kernel over `--reps` runs, in two passes over the variants (forward, then
backward) so the spread between passes shows. Every variant's outputs are
held against the plain versions (`fri_fold_pre_plain`, `fri_fold_post_plain`)
with `torch.equal`, on inputs with 0, 1 and p - 1 among the x and y, a row
with two equal x, and sx equal to one of a row's x. Exits non-zero without
a card. Needs `nvcc`; imports nothing of JAX.
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

SEED = 20261017
QS = (1 << 18, 1 << 16, 1 << 14, 1 << 12, 1 << 10, 1 << 8, 1 << 6, 192)
VARIANTS = ("parent", "row", "quad", "warps", "tile", "persist", "pair", "quad29", "pair29",
            "kernel")

PROBE = r"""
#include "fri.cu"

namespace {

// --- parent: the kernels before the redesign (the TPU pair's split) ---------

__device__ __forceinline__ void mod_neg(const Field& f, const uint32_t a[NW],
                                        uint32_t r[NW]) {
  uint32_t zero[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) zero[w] = 0;
  stark::mod_sub(f, zero, a, r);
}

__device__ __forceinline__ void cubic_and_denominator(
    const Field& f, int j, const uint32_t xj[NW], const uint32_t xa[NW],
    const uint32_t xb[NW], const uint32_t xc[NW], const uint32_t xab[NW],
    const uint32_t xac[NW], const uint32_t xbc[NW], int32_t* __restrict__ eqs,
    int32_t* __restrict__ dens, int64_t q, int64_t i) {
  uint32_t c0[NW], c1[NW], c2[NW], t[NW], u[NW];
  stark::mont_mul(f, xab, xc, t);
  mod_neg(f, t, c0);
  stark::mod_add(f, xab, xac, t);
  stark::mod_add(f, t, xbc, c1);
  stark::mod_add(f, xa, xb, t);
  stark::mod_add(f, t, xc, u);
  mod_neg(f, u, c2);
  stark::store_elem(eqs + (4 * j + 0) * q, 16 * q, i, c0);
  stark::store_elem(eqs + (4 * j + 1) * q, 16 * q, i, c1);
  stark::store_elem(eqs + (4 * j + 2) * q, 16 * q, i, c2);
  stark::store_elem(eqs + (4 * j + 3) * q, 16 * q, i, f.one);
  stark::mod_add(f, xj, c2, t);
  stark::mont_mul(f, t, xj, u);
  stark::mod_add(f, u, c1, t);
  stark::mont_mul(f, t, xj, u);
  stark::mod_add(f, u, c0, t);
  stark::store_elem(dens + j * q, 4 * q, i, t);
}

__global__ void __launch_bounds__(128, 4)
parent_pre_kernel(const int32_t* __restrict__ xs4, int32_t* __restrict__ eqs,
                  int32_t* __restrict__ dens, int64_t q, Field f) {
  int64_t i = thread_index();
  if (i >= q) return;
  uint32_t x0[NW], x1[NW], x2[NW], x3[NW];
  stark::load_elem(xs4, 4 * q, i, x0);
  stark::load_elem(xs4 + q, 4 * q, i, x1);
  stark::load_elem(xs4 + 2 * q, 4 * q, i, x2);
  stark::load_elem(xs4 + 3 * q, 4 * q, i, x3);
  uint32_t x01[NW], x02[NW], x03[NW], x12[NW], x13[NW], x23[NW];
  stark::mont_mul(f, x0, x1, x01);
  stark::mont_mul(f, x0, x2, x02);
  stark::mont_mul(f, x0, x3, x03);
  stark::mont_mul(f, x1, x2, x12);
  stark::mont_mul(f, x1, x3, x13);
  stark::mont_mul(f, x2, x3, x23);
  cubic_and_denominator(f, 0, x0, x1, x2, x3, x12, x13, x23, eqs, dens, q, i);
  cubic_and_denominator(f, 1, x1, x0, x2, x3, x02, x03, x23, eqs, dens, q, i);
  cubic_and_denominator(f, 2, x2, x0, x1, x3, x01, x03, x13, eqs, dens, q, i);
  cubic_and_denominator(f, 3, x3, x0, x1, x2, x01, x02, x12, eqs, dens, q, i);
}

__global__ void __launch_bounds__(128, 4)
parent_post_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ eqs,
                   const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
                   int32_t* __restrict__ out, int64_t q, Field f) {
  int64_t i = thread_index();
  if (i >= q) return;
  uint32_t poly[4][NW], w[NW], a[NW], t[NW], u[NW];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    stark::load_elem(ys4 + j * q, 4 * q, i, a);
    stark::load_elem(invs + j * q, 4 * q, i, t);
    stark::mont_mul(f, a, t, w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      stark::load_elem(eqs + (4 * j + k) * q, 16 * q, i, a);
      if (j == 0) {
        stark::mont_mul(f, a, w, poly[k]);
      } else {
        stark::mont_mul(f, a, w, t);
        stark::mod_add(f, poly[k], t, u);
        stark::set_elem(poly[k], u);
      }
    }
  }
  stark::load_elem(sx, 1, 0, a);
  stark::set_elem(w, poly[3]);
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    stark::mont_mul(f, w, a, t);
    stark::mod_add(f, t, poly[k], w);
  }
  stark::store_elem(out, q, i, w);
}

// --- row: products of differences, one thread a row ---------------------------

__global__ void __launch_bounds__(128)
row_pre_kernel(const int32_t* __restrict__ xs4, int32_t* __restrict__ dens, int64_t q,
               Field f) {
  int64_t i = thread_index();
  if (i >= q) return;
  uint32_t x[4][NW];
#pragma unroll
  for (int j = 0; j < 4; ++j) stark::load_elem(xs4 + j * q, 4 * q, i, x[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t acc[NW], d[NW], u[NW];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      stark::mod_sub(f, x[j], x[j ^ k], d);
      if (k == 1) {
        stark::set_elem(acc, d);
      } else {
        stark::mont_mul(f, acc, d, u);
        stark::set_elem(acc, u);
      }
    }
    stark::store_elem(dens + j * q, 4 * q, i, acc);
  }
}

__global__ void __launch_bounds__(128)
row_post_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
                const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
                int32_t* __restrict__ out, int64_t q, Field f) {
  int64_t i = thread_index();
  if (i >= q) return;
  uint32_t s[NW], d[4][NW], p01[NW], p23[NW], a[NW], b[NW], w[NW], l[NW], acc[NW];
  stark::load_elem(sx, 1, 0, s);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    stark::load_elem(xs4 + m * q, 4 * q, i, a);
    stark::mod_sub(f, s, a, d[m]);
  }
  stark::mont_mul(f, d[0], d[1], p01);
  stark::mont_mul(f, d[2], d[3], p23);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    stark::mont_mul(f, d[j ^ 1], j < 2 ? p23 : p01, l);
    stark::load_elem(ys4 + j * q, 4 * q, i, a);
    stark::load_elem(invs + j * q, 4 * q, i, b);
    stark::mont_mul(f, a, b, w);
    if (j == 0) {
      stark::mont_mul(f, w, l, acc);
    } else {
      stark::mont_mul(f, w, l, a);
      stark::mod_add(f, acc, a, b);
      stark::set_elem(acc, b);
    }
  }
  stark::store_elem(out, q, i, acc);
}

// --- quad: a row over four lanes, one member a lane (post; pre is fri.cu's) -----

// lane j forms d_j = sx - x_j, takes the other three d from its quad (two
// products), its weight w_j = y_j inv_j and term; two shuffle-and-add rounds
// sum the quad, and lane j stores limbs 4j .. 4j + 3 of the row
__device__ __forceinline__ void quad_post_lane(
    const Field& f, const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
    const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
    int32_t* __restrict__ out, int64_t q, int64_t t) {
  const Quad r = quad_of(t, q);
  uint32_t a[NW], b[NW], d[NW], w[NW], l[NW], u[NW];
  stark::load_elem(sx, 1, 0, a);
  stark::load_elem(xs4 + r.j * q, 4 * q, r.c, b);
  stark::mod_sub(f, a, b, d);
  stark::load_elem(ys4 + r.j * q, 4 * q, r.c, a);
  stark::load_elem(invs + r.j * q, 4 * q, r.c, b);
  stark::mont_mul(f, a, b, w);
  shfl_elem(d, 1, a);
  shfl_elem(d, 2, b);
  stark::mont_mul(f, a, b, l);
  shfl_elem(d, 3, a);
  stark::mont_mul(f, l, a, u);
  stark::mont_mul(f, w, u, l);
  shfl_elem(l, 1, a);
  stark::mod_add(f, l, a, u);
  shfl_elem(u, 2, a);
  stark::mod_add(f, u, a, l);
  uint32_t lo = l[0], hi = l[1];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (r.j == k) {
      lo = l[2 * k];
      hi = l[2 * k + 1];
    }
  }
  if (r.live) {
    int32_t* o = out + (4 * r.j) * q + r.i;
    o[0] = static_cast<int32_t>(lo & 0xFFFFu);
    o[q] = static_cast<int32_t>(lo >> 16);
    o[2 * q] = static_cast<int32_t>(hi & 0xFFFFu);
    o[3 * q] = static_cast<int32_t>(hi >> 16);
  }
}

__global__ void __launch_bounds__(128)
quad_post_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
                 const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
                 int32_t* __restrict__ out, int64_t q, Field f) {
  quad_post_lane(f, sx, xs4, ys4, invs, out, q, thread_index());
}

// --- warps: four warps a block, one member a warp, shared memory ----------------

// Warp j of the block holds member j of rows base .. base + 31, a row a lane.
struct WarpRow {
  int64_t i, c;
  int j, lane;
  bool live;
};

__device__ __forceinline__ WarpRow warp_row(int64_t q) {
  WarpRow r;
  r.j = threadIdx.x >> 5;
  r.lane = threadIdx.x & 31;
  r.i = static_cast<int64_t>(blockIdx.x) * 32 + r.lane;
  r.live = r.i < q;
  r.c = r.live ? r.i : q - 1;
  return r;
}

__device__ __forceinline__ void put(uint32_t (*sh)[NW][32], int j, int lane,
                                   const uint32_t v[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) sh[j][w][lane] = v[w];
}

__device__ __forceinline__ void get(uint32_t (*sh)[NW][32], int j, int lane, uint32_t v[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) v[w] = sh[j][w][lane];
}

// the sum of the four members' terms in sh, limbs 4j .. 4j + 3 of row i to out
__device__ __forceinline__ void sum_and_store(const Field& f, uint32_t (*sh)[NW][32],
                                              const WarpRow& r, int32_t* __restrict__ out,
                                              int64_t q) {
  uint32_t a[NW], b[NW], s[NW];
  get(sh, 0, r.lane, a);
  get(sh, 1, r.lane, b);
  stark::mod_add(f, a, b, s);
  get(sh, 2, r.lane, a);
  stark::mod_add(f, s, a, b);
  get(sh, 3, r.lane, a);
  stark::mod_add(f, b, a, s);
  uint32_t lo = s[0], hi = s[1];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (r.j == k) {
      lo = s[2 * k];
      hi = s[2 * k + 1];
    }
  }
  if (r.live) {
    int32_t* o = out + (4 * r.j) * q + r.i;
    o[0] = static_cast<int32_t>(lo & 0xFFFFu);
    o[q] = static_cast<int32_t>(lo >> 16);
    o[2 * q] = static_cast<int32_t>(hi & 0xFFFFu);
    o[3 * q] = static_cast<int32_t>(hi >> 16);
  }
}

__global__ void __launch_bounds__(128)
warps_pre_kernel(const int32_t* __restrict__ xs4, int32_t* __restrict__ dens, int64_t q,
                 Field f) {
  __shared__ uint32_t sh[4][NW][32];
  const WarpRow r = warp_row(q);
  uint32_t x[NW], o[NW], d[NW], acc[NW], u[NW];
  stark::load_elem(xs4 + r.j * q, 4 * q, r.c, x);
  put(sh, r.j, r.lane, x);
  __syncthreads();
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    get(sh, r.j ^ k, r.lane, o);
    stark::mod_sub(f, x, o, d);
    if (k == 1) {
      stark::set_elem(acc, d);
    } else {
      stark::mont_mul(f, acc, d, u);
      stark::set_elem(acc, u);
    }
  }
  if (r.live) stark::store_elem(dens + r.j * q, 4 * q, r.i, acc);
}

__global__ void __launch_bounds__(128)
warps_post_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
                  const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
                  int32_t* __restrict__ out, int64_t q, Field f) {
  __shared__ uint32_t sh[4][NW][32];
  const WarpRow r = warp_row(q);
  uint32_t a[NW], b[NW], d[NW], w[NW], l[NW], u[NW];
  stark::load_elem(sx, 1, 0, a);
  stark::load_elem(xs4 + r.j * q, 4 * q, r.c, b);
  stark::mod_sub(f, a, b, d);
  put(sh, r.j, r.lane, d);
  stark::load_elem(ys4 + r.j * q, 4 * q, r.c, a);
  stark::load_elem(invs + r.j * q, 4 * q, r.c, b);
  stark::mont_mul(f, a, b, w);
  __syncthreads();
  get(sh, r.j ^ 1, r.lane, a);
  get(sh, r.j ^ 2, r.lane, b);
  stark::mont_mul(f, a, b, l);
  get(sh, r.j ^ 3, r.lane, a);
  stark::mont_mul(f, l, a, u);
  stark::mont_mul(f, w, u, l);
  __syncthreads();
  put(sh, r.j, r.lane, l);
  __syncthreads();
  sum_and_store(f, sh, r, out, q);
}

// --- tile: warps, with 16-byte loads and stores through shared memory -----------

// Rows base .. base + 31 of a (16, R, q) array (limb stride `stride`) into
// tile[limb][r][32] by 16-byte loads (q % 4 == 0); rows past q read 0.
template <int R>
__device__ __forceinline__ void stage(uint32_t (*tile)[R][32], const int32_t* __restrict__ src,
                                      int64_t stride, int64_t q, int64_t base) {
  // 16 limbs x R rows x 8 chunks of 4 int32
  for (int e = threadIdx.x; e < 16 * R * 8; e += blockDim.x) {
    const int chunk = e & 7, lr = e >> 3, row = lr % R, limb = lr / R;
    const int64_t i = base + 4 * chunk;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (i < q) v = *reinterpret_cast<const uint4*>(src + limb * stride + row * q + i);
    *reinterpret_cast<uint4*>(&tile[limb][row][4 * chunk]) = v;
  }
}

template <int R>
__device__ __forceinline__ void elem_of(uint32_t (*tile)[R][32], int row, int lane,
                                        uint32_t v[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
    v[w] = (tile[2 * w][row][lane] & 0xFFFFu) | (tile[2 * w + 1][row][lane] << 16);
}

template <int R>
__device__ __forceinline__ void elem_to(uint32_t (*tile)[R][32], int row, int lane,
                                        const uint32_t v[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    tile[2 * w][row][lane] = v[w] & 0xFFFFu;
    tile[2 * w + 1][row][lane] = v[w] >> 16;
  }
}

// tile[limb][row][32] -> rows of dst (16, R, q) with int4 stores
template <int R>
__device__ __forceinline__ void unstage(uint32_t (*tile)[R][32], int32_t* __restrict__ dst,
                                        int64_t stride, int64_t q, int64_t base) {
  for (int e = threadIdx.x; e < 16 * R * 8; e += blockDim.x) {
    const int chunk = e & 7, lr = e >> 3, row = lr % R, limb = lr / R;
    const int64_t i = base + 4 * chunk;
    if (i < q)
      *reinterpret_cast<uint4*>(dst + limb * stride + row * q + i) =
          *reinterpret_cast<const uint4*>(&tile[limb][row][4 * chunk]);
  }
}

__global__ void __launch_bounds__(128)
tile_pre_kernel(const int32_t* __restrict__ xs4, int32_t* __restrict__ dens, int64_t q,
                Field f) {
  __shared__ uint32_t tile[16][4][32];
  const WarpRow r = warp_row(q);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * 32;
  stage<4>(tile, xs4, 4 * q, q, base);
  __syncthreads();
  uint32_t x[NW], o[NW], d[NW], acc[NW], u[NW];
  elem_of<4>(tile, r.j, r.lane, x);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    elem_of<4>(tile, r.j ^ k, r.lane, o);
    stark::mod_sub(f, x, o, d);
    if (k == 1) {
      stark::set_elem(acc, d);
    } else {
      stark::mont_mul(f, acc, d, u);
      stark::set_elem(acc, u);
    }
  }
  __syncthreads();
  elem_to<4>(tile, r.j, r.lane, acc);
  __syncthreads();
  unstage<4>(tile, dens, 4 * q, q, base);
}

__global__ void __launch_bounds__(128)
tile_post_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
                 const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
                 int32_t* __restrict__ out, int64_t q, Field f) {
  __shared__ uint32_t tx[16][4][32], ty[16][4][32], ti[16][4][32];
  const WarpRow r = warp_row(q);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * 32;
  stage<4>(tx, xs4, 4 * q, q, base);
  stage<4>(ty, ys4, 4 * q, q, base);
  stage<4>(ti, invs, 4 * q, q, base);
  __syncthreads();
  uint32_t s[NW], a[NW], b[NW], d[NW], w[NW], l[NW], u[NW];
  stark::load_elem(sx, 1, 0, s);
  elem_of<4>(ty, r.j, r.lane, a);
  elem_of<4>(ti, r.j, r.lane, b);
  stark::mont_mul(f, a, b, w);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    elem_of<4>(tx, r.j ^ k, r.lane, a);
    stark::mod_sub(f, s, a, d);
    if (k == 1) {
      stark::set_elem(l, d);
    } else {
      stark::mont_mul(f, l, d, u);
      stark::set_elem(l, u);
    }
  }
  stark::mont_mul(f, w, l, u);
  // the four terms of each row, then their sum as one (16, 1, 32) tile
  uint32_t (*sh)[NW][32] = reinterpret_cast<uint32_t (*)[NW][32]>(ty);
  __syncthreads();
  put(sh, r.j, r.lane, u);
  __syncthreads();
  get(sh, 0, r.lane, a);
  get(sh, 1, r.lane, b);
  stark::mod_add(f, a, b, s);
  get(sh, 2, r.lane, a);
  stark::mod_add(f, s, a, b);
  get(sh, 3, r.lane, a);
  stark::mod_add(f, b, a, s);
  uint32_t (*ot)[1][32] = reinterpret_cast<uint32_t (*)[1][32]>(tx);
  __syncthreads();
  if (r.j == 0) elem_to<1>(ot, 0, r.lane, s);
  __syncthreads();
  unstage<1>(ot, out, q, q, base);
}

// lane h of a pair stores limbs 8h .. 8h + 7 of row i

__device__ __forceinline__ void store_half(int32_t* __restrict__ out, int64_t q, int64_t i,
                                           int h, const uint32_t s[NW]) {
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = h ? s[4 + k] : s[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[(8 * h + 2 * k) * q + i] = static_cast<int32_t>(v[k] & 0xFFFFu);
    out[(8 * h + 2 * k + 1) * q + i] = static_cast<int32_t>(v[k] >> 16);
  }
}

// --- quad29, pair29: quad and pair with radix-2^29 products (post only) --------
//
// mont_mul29(a, b) = a b 2^-261 mod p up to one p (a < 4p, b < 2p, 4p < 2^261).
// On the R = 2^256 Montgomery planes each product leaves a factor 2^-5: the
// four in a term's chain (two for prod d, one for w, one for the term) are
// taken out by one more product by k29 = 2^281 mod p.

struct K29 {
  uint32_t w[stark::NL29];
};

using stark::NL29;
using stark::MASK29;

__device__ __forceinline__ void mont_mul29(const uint32_t p29[NL29], uint32_t np29,
                                           const uint32_t a[NL29], const uint32_t b[NL29],
                                           uint32_t r[NL29]) {
  uint64_t t[2 * NL29];
#pragma unroll
  for (int i = 0; i < 2 * NL29; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
#pragma unroll
    for (int j = 0; j < NL29; ++j) t[i + j] += static_cast<uint64_t>(a[i]) * b[j];
  }
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    const uint32_t m = (static_cast<uint32_t>(t[i]) * np29) & MASK29;
#pragma unroll
    for (int j = 0; j < NL29; ++j) t[i + j] += static_cast<uint64_t>(m) * p29[j];
    t[i + 1] += t[i] >> 29;
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    c += t[NL29 + i];
    r[i] = static_cast<uint32_t>(c) & MASK29;
    c >>= 29;
  }
}

__device__ __forceinline__ void shfl29(const uint32_t v[NL29], int k, uint32_t r[NL29]) {
#pragma unroll
  for (int w = 0; w < NL29; ++w) r[w] = __shfl_xor_sync(FULL, v[w], k);
}

__device__ __forceinline__ void load29(const int32_t* planes, int64_t n, int64_t col,
                                       uint32_t r[NL29]) {
  uint32_t w[NW];
  stark::load_elem(planes, n, col, w);
  stark::to_limbs29(w, r);
}

// a lazy value below 2p in limbs -> canonical words
__device__ __forceinline__ void canonical(const Field& f, const uint32_t l[NL29],
                                          uint32_t w[NW]) {
  stark::from_limbs29(l, w);
  stark::cond_sub_p(f, 0, w);
}

__global__ void __launch_bounds__(128)
quad29_post_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
                   const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
                   int32_t* __restrict__ out, int64_t q, Field f, K29 k29) {
  const Quad r = quad_of(thread_index(), q);
  uint32_t p29[NL29], a[NL29], b[NL29], d[NL29], w[NL29], l[NL29];
  stark::to_limbs29(f.p, p29);
  const uint32_t np29 = f.np & MASK29;
  uint32_t s[NW], x[NW], e[NW];
  stark::load_elem(sx, 1, 0, s);
  stark::load_elem(xs4 + r.j * q, 4 * q, r.c, x);
  stark::mod_sub(f, s, x, e);
  stark::to_limbs29(e, d);
  load29(ys4 + r.j * q, 4 * q, r.c, a);
  load29(invs + r.j * q, 4 * q, r.c, b);
  mont_mul29(p29, np29, a, b, w);
  shfl29(d, 1, a);
  shfl29(d, 2, b);
  mont_mul29(p29, np29, a, b, l);
  shfl29(d, 3, a);
  mont_mul29(p29, np29, l, a, b);
  mont_mul29(p29, np29, w, b, l);
  mont_mul29(p29, np29, l, k29.w, a);
  canonical(f, a, e);
  shfl_elem(e, 1, s);
  stark::mod_add(f, e, s, x);
  shfl_elem(x, 2, s);
  stark::mod_add(f, x, s, e);
  uint32_t lo = e[0], hi = e[1];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (r.j == k) {
      lo = e[2 * k];
      hi = e[2 * k + 1];
    }
  }
  if (r.live) {
    int32_t* o = out + (4 * r.j) * q + r.i;
    o[0] = static_cast<int32_t>(lo & 0xFFFFu);
    o[q] = static_cast<int32_t>(lo >> 16);
    o[2 * q] = static_cast<int32_t>(hi & 0xFFFFu);
    o[3 * q] = static_cast<int32_t>(hi >> 16);
  }
}

__global__ void __launch_bounds__(128)
pair29_post_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
                   const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
                   int32_t* __restrict__ out, int64_t q, Field f, K29 k29) {
  const int64_t t = thread_index(), i = t >> 1;
  const int h = static_cast<int>(t & 1);
  const bool live = i < q;
  const int64_t c = live ? i : q - 1;
  const int32_t* xa = xs4 + (2 * h) * q;
  const int32_t* ya = ys4 + (2 * h) * q;
  const int32_t* ia = invs + (2 * h) * q;
  uint32_t p29[NL29], da[NL29], db[NL29], pr[NL29], la[NL29], lb[NL29], a[NL29], b[NL29],
      w[NL29];
  stark::to_limbs29(f.p, p29);
  const uint32_t np29 = f.np & MASK29;
  uint32_t s[NW], x[NW], e[NW];
  stark::load_elem(sx, 1, 0, s);
  stark::load_elem(xa, 4 * q, c, x);
  stark::mod_sub(f, s, x, e);
  stark::to_limbs29(e, da);
  stark::load_elem(xa + q, 4 * q, c, x);
  stark::mod_sub(f, s, x, e);
  stark::to_limbs29(e, db);
  mont_mul29(p29, np29, da, db, pr);
  shfl29(pr, 1, a);
  mont_mul29(p29, np29, db, a, la);
  mont_mul29(p29, np29, da, a, lb);
  load29(ya, 4 * q, c, a);
  load29(ia, 4 * q, c, b);
  mont_mul29(p29, np29, a, b, w);
  mont_mul29(p29, np29, w, la, pr);
  load29(ya + q, 4 * q, c, a);
  load29(ia + q, 4 * q, c, b);
  mont_mul29(p29, np29, a, b, w);
  mont_mul29(p29, np29, w, lb, la);
  // the two terms' sum, below 4p, by limbs (each below 2^30), then 2^281
#pragma unroll
  for (int k = 0; k < NL29; ++k) a[k] = pr[k] + la[k];
  mont_mul29(p29, np29, a, k29.w, b);
  canonical(f, b, e);
  shfl_elem(e, 1, s);
  stark::mod_add(f, e, s, x);
  if (live) store_half(out, q, i, h, x);
}

// --- persist: quad on a persistent grid ------------------------------------------

__global__ void __launch_bounds__(THREADS)
persist_pre_kernel(const int32_t* __restrict__ xs4, int32_t* __restrict__ dens, int64_t q,
                   Field f) {
  const int64_t tiles = (4 * q + THREADS - 1) / THREADS;
  for (int64_t b = blockIdx.x; b < tiles; b += gridDim.x)
    fold_pre_lane(f, xs4, dens, q, b * THREADS + threadIdx.x);
}

__global__ void __launch_bounds__(THREADS)
persist_post_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
                    const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
                    int32_t* __restrict__ out, int64_t q, Field f) {
  const int64_t tiles = (4 * q + THREADS - 1) / THREADS;
  for (int64_t b = blockIdx.x; b < tiles; b += gridDim.x)
    quad_post_lane(f, sx, xs4, ys4, invs, out, q, b * THREADS + threadIdx.x);
}

template <typename K>
unsigned persistent_blocks(K kernel, long long q) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const long long tiles = (4 * q + THREADS - 1) / THREADS;
  const long long most = static_cast<long long>(sms) * per_sm;
  return static_cast<unsigned>(tiles < most ? tiles : most);
}

}  // namespace

// variant: 0 parent (writes eqs beside dens), 1 row, 2 quad, 3 warps, 4 tile,
// 5 persist
extern "C" int probe_pre(int variant, const void* xs4_, void* eqs_, void* dens_, long long q,
                         const uint32_t* field_words, uint32_t np, void* stream) {
  const auto* xs4 = static_cast<const int32_t*>(xs4_);
  auto* eqs = static_cast<int32_t*>(eqs_);
  auto* dens = static_cast<int32_t*>(dens_);
  const Field f = stark::make_field(field_words, np);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned rows = static_cast<unsigned>((q + 127) / 128);
  const unsigned tiles = static_cast<unsigned>((q + 31) / 32);
  if (variant == 4 && q % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: parent_pre_kernel<<<rows, 128, 0, st>>>(xs4, eqs, dens, q, f); break;
    case 1: row_pre_kernel<<<rows, 128, 0, st>>>(xs4, dens, q, f); break;
    case 2:
    case 6:
    case 7:
    case 8: fri_fold_pre_kernel<<<blocks_for(4 * q), THREADS, 0, st>>>(xs4, dens, q, f); break;
    case 3: warps_pre_kernel<<<tiles, 128, 0, st>>>(xs4, dens, q, f); break;
    case 4: tile_pre_kernel<<<tiles, 128, 0, st>>>(xs4, dens, q, f); break;
    case 5:
      persist_pre_kernel<<<persistent_blocks(persist_pre_kernel, q), THREADS, 0, st>>>(
          xs4, dens, q, f);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// xin: the parent's eqs (16, 16, q) for variant 0, else xs4 (16, 4, q)
// k29_words: 2^281 mod p in 29-bit limbs (variants 7, 8)
extern "C" int probe_post(int variant, const void* sx_, const void* xin_, const void* ys4_,
                          const void* invs_, void* out_, long long q,
                          const uint32_t* field_words, uint32_t np, const uint32_t* k29_words,
                          void* stream) {
  K29 k29;
  for (int k = 0; k < stark::NL29; ++k) k29.w[k] = k29_words[k];
  const auto* sx = static_cast<const int32_t*>(sx_);
  const auto* xin = static_cast<const int32_t*>(xin_);
  const auto* ys4 = static_cast<const int32_t*>(ys4_);
  const auto* invs = static_cast<const int32_t*>(invs_);
  auto* out = static_cast<int32_t*>(out_);
  const Field f = stark::make_field(field_words, np);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned rows = static_cast<unsigned>((q + 127) / 128);
  const unsigned tiles = static_cast<unsigned>((q + 31) / 32);
  if (variant == 4 && q % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: parent_post_kernel<<<rows, 128, 0, st>>>(sx, xin, ys4, invs, out, q, f); break;
    case 1: row_post_kernel<<<rows, 128, 0, st>>>(sx, xin, ys4, invs, out, q, f); break;
    case 2:
      quad_post_kernel<<<blocks_for(4 * q), THREADS, 0, st>>>(sx, xin, ys4, invs, out, q, f);
      break;
    case 3: warps_post_kernel<<<tiles, 128, 0, st>>>(sx, xin, ys4, invs, out, q, f); break;
    case 4: tile_post_kernel<<<tiles, 128, 0, st>>>(sx, xin, ys4, invs, out, q, f); break;
    case 5:
      persist_post_kernel<<<persistent_blocks(persist_post_kernel, q), THREADS, 0, st>>>(
          sx, xin, ys4, invs, out, q, f);
      break;
    case 6:
      fri_fold_post_kernel<<<blocks_for(2 * q), THREADS, 0, st>>>(sx, xin, ys4, invs, out, q,
                                                                   f);
      break;
    case 7:
      quad29_post_kernel<<<blocks_for(4 * q), THREADS, 0, st>>>(sx, xin, ys4, invs, out, q, f,
                                                                 k29);
      break;
    case 8:
      pair29_post_kernel<<<blocks_for(2 * q), THREADS, 0, st>>>(sx, xin, ys4, invs, out, q, f,
                                                                 k29);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def build_probe(tmp: str):
    """Compile the probe beside `csrc/` into a shared library; returns it and
    {kernel: (registers, spill store bytes)} from `ptxas -v`."""
    from stark_tpu_torch.ops import build

    src, so = os.path.join(tmp, "fri_probe.cu"), os.path.join(tmp, "fri_probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-shared", "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    _vp, _ll, _u32p = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32)
    lib.probe_pre.argtypes = [ctypes.c_int, _vp, _vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp]
    lib.probe_post.argtypes = [ctypes.c_int, _vp, _vp, _vp, _vp, _vp, _ll, _u32p,
                               ctypes.c_uint32, _u32p, _vp]
    lib.probe_pre.restype = lib.probe_post.restype = ctypes.c_int
    return lib, ptxas_usage(proc.stdout + proc.stderr)


def ptxas_usage(log: str) -> dict:
    """{kernel name: [registers, spill store bytes]} of a `ptxas -v` log."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(\w+_kernel)", m.group(1))
            name = k.group(1) if k else m.group(1)
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
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke
    from stark_tpu_torch.fields.field import BN254_FR as spec
    from stark_tpu_torch.ops import field_cuda as fc
    from stark_tpu_torch.ops import modmath as mm
    from stark_tpu_torch.protocol import fused_kernels as fk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        lib, usage = build_probe(tmp)
    print(json.dumps({"ptxas": usage}), flush=True)

    rng = np.random.default_rng(SEED)
    cases = {}
    for q in QS:
        sx, xs4, ys4 = chip_smoke.fold_inputs(spec, rng, q, device)
        dens = fk.fri_fold_pre_plain(spec, xs4)
        invs = mm.multi_inv(spec, dens.reshape(16, 4 * q)).reshape(16, 4, q)
        cases[q] = {"sx": sx, "xs4": xs4, "ys4": ys4, "invs": invs, "dens": dens,
                    "out": fk.fri_fold_post_plain(spec, sx, xs4, ys4, invs),
                    "eqs": torch.empty((16, 16, q), dtype=torch.int32, device=device)}
    words, np32, stream = fc.cuda_args(spec, cases[QS[0]]["xs4"])
    k = pow(2, 281, spec.p)
    k29 = (ctypes.c_uint32 * 9)(*[(k >> 29 * i) & ((1 << 29) - 1) for i in range(9)])

    def calls(variant: str, c: dict):
        """(pre, post) of a variant on case c, and a check that runs both
        once and compares their outputs with the plain versions'."""
        q = c["xs4"].shape[2]
        if variant == "kernel":
            pre = lambda: fk.fri_fold_pre(spec, c["xs4"])  # noqa: E731
            post = lambda: fk.fri_fold_post(spec, c["sx"], c["xs4"], c["ys4"], c["invs"])  # noqa: E731
            return pre, post, lambda: (pre(), post())
        v = VARIANTS.index(variant)
        xin = c["eqs"] if variant == "parent" else c["xs4"]
        d2, o2 = torch.empty_like(c["dens"]), torch.empty_like(c["out"])

        def pre():
            rc = lib.probe_pre(v, c["xs4"].data_ptr(), c["eqs"].data_ptr(), d2.data_ptr(), q,
                               words, np32, stream)
            if rc:
                raise RuntimeError(f"{variant} pre: CUDA error {rc}")

        def post():
            rc = lib.probe_post(v, c["sx"].data_ptr(), xin.data_ptr(), c["ys4"].data_ptr(),
                                c["invs"].data_ptr(), o2.data_ptr(), q, words, np32, k29,
                                stream)
            if rc:
                raise RuntimeError(f"{variant} post: CUDA error {rc}")

        def check():
            d2.zero_(), o2.zero_()
            pre(), post()
            return d2, o2
        return pre, post, check

    times = {v: {q: {"pre_ms": [], "post_ms": []} for q in QS} for v in VARIANTS}
    for order in (VARIANTS, VARIANTS[::-1]):
        for variant in order:
            for q, c in cases.items():
                pre, post, check = calls(variant, c)
                d2, o2 = check()
                torch.cuda.synchronize()
                if not (torch.equal(d2, c["dens"]) and torch.equal(o2, c["out"])):
                    raise AssertionError(f"{variant} at q={q} differs from the plain versions")
                times[variant][q]["pre_ms"].append(chip_smoke.median_ms(pre, args.reps))
                times[variant][q]["post_ms"].append(chip_smoke.median_ms(post, args.reps))
    del lib

    for variant in VARIANTS:
        print(json.dumps({"variant": variant, "ms": times[variant]}), flush=True)
    print(f"median device ms of {args.reps}, forward pass / backward pass; {card}")
    for name in ("pre", "post"):
        print(f"| {name} | " + " | ".join(f"q={q}" for q in QS) + " |")
        print("|---" * (len(QS) + 1) + "|")
        for variant in VARIANTS:
            cells = [times[variant][q][f"{name}_ms"] for q in QS]
            print(f"| {variant} | " + " | ".join(f"{a:.4f} / {b:.4f}" for a, b in cells) + " |")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fri_fold_variants.json"), "w") as f:
            json.dump({"card": card, "reps": args.reps, "ptxas": usage,
                       "ms": {v: {str(q): t for q, t in ts.items()} for v, ts in times.items()}},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
