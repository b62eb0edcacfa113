// The two halves of FRI's Lagrange fold, around the shared batched inversion.
//
// They replace the TPU kernels of stark_tpu/protocol/pallas_kernels.py:
//   fri_fold_pre   :433 (_fri_pre_kernel :399)   the four monic cubics eq_j
//       vanishing at a row's other three x, and e_j = eq_j(x_j)
//   fri_fold_post  :478 (_fri_post_kernel :455)  w_j = y_j/e_j,
//       poly_k = sum_j eq_j[k]*w_j, then Horner at special_x
// which tile the q rows of a round over (16, 4, 1024) VMEM blocks.
//
// Layout: a round's n = 4q domain points as (16, 4, q) planes, member j of
// row i at [limb][j][i] (a view of the flat (16, n) plane: x_j[i] =
// xs[j*q + i]); eqs is (16, 16, q) with coefficient k of eq_j at index 4j+k.
//
// What bounds them on an H100: device memory. A row of `fri_fold_pre` reads
// 256 bytes and writes 1,280 for 18 Montgomery products; a row of
// `fri_fold_post` reads 1,536 bytes and writes 64 for 23. By the card's
// rates the bytes take 2.5 to 3 times as long as the products. Most of
// those bytes are the eqs round trip between the two kernels (1,024 bytes a
// row each way), which the interface keeps so that each half can be held
// against its TPU counterpart.
// What the design does about it:
// - One thread per row i < q, every element as 8 packed words in registers,
//   each plane row read or written once with `load_elem`/`store_elem` on a
//   row's base pointer and the limb stride of the whole (16, R, q) array, so
//   a warp's access to one limb of one member is one 128-byte segment and
//   the (16, 4, q) views need no copy.
// - `fri_fold_pre` keeps the four x and the six pair products in registers
//   (80 words) and stores each coefficient as soon as it exists; c3 = R mod p
//   comes from the Field argument.
// - `fri_fold_post` streams: for each j it loads y_j and 1/e_j, forms w_j,
//   and adds eq_j[k]*w_j into four running sums, so only the sums, w_j and
//   one operand are live (about 56 words); special_x is one (16, 1) column
//   that every thread reads (the same address across a warp: one broadcast).
// - Both kernels bound their registers for four blocks an SM (FRI_MIN_BLOCKS):
//   with the addresses of 20 output rows and an inlined product's
//   temporaries beside the values above, occupancy and not the spill decides
//   their time.
// - Every intermediate is canonical (< p) and the negations are 0 - a mod p,
//   which keeps 0 at 0, so the bits equal the composed route's.
#include "field.cuh"

namespace {

using stark::Field;
using stark::NW;

// Threads a block, and the blocks an SM must be able to hold, which caps a
// thread's registers (4 blocks of 128 threads: 128 registers). Left to itself
// the compiler takes 179 (pre) and 156 (post) and two or three blocks fit an
// SM, too few warps in flight for a pass that waits on memory; at 128 a few
// words spill to local memory (24 bytes a thread in pre, 140 in post) and at
// q = 2^18 pre takes 0.51 ms where it took 0.81 and post 0.51 where it took
// 0.66 (chip_smoke.py on an H100 80GB HBM3 at 700 W). Both can be set from
// the compiler's command line, FRI_MIN_BLOCKS=0 for no bound at all:
// scripts/fri_fold_variants_cuda.py builds and times the alternatives. On
// that card 64- and 256-thread blocks at the same 128 registers read the
// same within 3%; at 64 registers (8 blocks) pre is 13% faster and post,
// with 2.5 KB spilled, 29% slower, so one bound serves both.
#ifndef FRI_THREADS
#define FRI_THREADS 128
#endif
#ifndef FRI_MIN_BLOCKS
#define FRI_MIN_BLOCKS 4
#endif
constexpr int THREADS = FRI_THREADS;
#if FRI_MIN_BLOCKS > 0
#define FRI_BOUNDS __launch_bounds__(FRI_THREADS, FRI_MIN_BLOCKS)
#else
#define FRI_BOUNDS
#endif

// 0 - a mod p: p - a, and 0 for a = 0.
__device__ __forceinline__ void mod_neg(const Field& f, const uint32_t a[NW],
                                        uint32_t r[NW]) {
  uint32_t zero[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) zero[w] = 0;
  stark::mod_sub(f, zero, a, r);
}

// Row r of a (16, R, q) array: base pointer for load_elem/store_elem with
// limb stride R*q.
__device__ __forceinline__ const int32_t* row_in(const int32_t* base,
                                                 int r, int64_t q) {
  return base + r * q;
}

__device__ __forceinline__ int32_t* row_out(int32_t* base, int r, int64_t q) {
  return base + r * q;
}

// The cubic with roots {x_a, x_b, x_c} for member j (the other three), its
// value at x_j, both stored; xab, xac, xbc are the pair products.
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
  stark::store_elem(row_out(eqs, 4 * j + 0, q), 16 * q, i, c0);
  stark::store_elem(row_out(eqs, 4 * j + 1, q), 16 * q, i, c1);
  stark::store_elem(row_out(eqs, 4 * j + 2, q), 16 * q, i, c2);
  stark::store_elem(row_out(eqs, 4 * j + 3, q), 16 * q, i, f.one);
  // e_j = ((x_j + c2)*x_j + c1)*x_j + c0, the leading coefficient being 1
  stark::mod_add(f, xj, c2, t);
  stark::mont_mul(f, t, xj, u);
  stark::mod_add(f, u, c1, t);
  stark::mont_mul(f, t, xj, u);
  stark::mod_add(f, u, c0, t);
  stark::store_elem(row_out(dens, j, q), 4 * q, i, t);
}

__global__ void FRI_BOUNDS
fri_fold_pre_kernel(const int32_t* __restrict__ xs4, int32_t* __restrict__ eqs,
                    int32_t* __restrict__ dens, int64_t q, Field f) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q) return;
  uint32_t x0[NW], x1[NW], x2[NW], x3[NW];
  stark::load_elem(row_in(xs4, 0, q), 4 * q, i, x0);
  stark::load_elem(row_in(xs4, 1, q), 4 * q, i, x1);
  stark::load_elem(row_in(xs4, 2, q), 4 * q, i, x2);
  stark::load_elem(row_in(xs4, 3, q), 4 * q, i, x3);
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

__global__ void FRI_BOUNDS
fri_fold_post_kernel(const int32_t* __restrict__ sx,
                     const int32_t* __restrict__ eqs,
                     const int32_t* __restrict__ ys4,
                     const int32_t* __restrict__ invs,
                     int32_t* __restrict__ out, int64_t q, Field f) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q) return;
  uint32_t poly[4][NW], w[NW], a[NW], t[NW], u[NW];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    stark::load_elem(row_in(ys4, j, q), 4 * q, i, a);
    stark::load_elem(row_in(invs, j, q), 4 * q, i, t);
    stark::mont_mul(f, a, t, w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      stark::load_elem(row_in(eqs, 4 * j + k, q), 16 * q, i, a);
      if (j == 0) {
        stark::mont_mul(f, a, w, poly[k]);
      } else {
        stark::mont_mul(f, a, w, t);
        stark::mod_add(f, poly[k], t, u);
        stark::set_elem(poly[k], u);
      }
    }
  }
  // Horner at special_x: ((poly3*sx + poly2)*sx + poly1)*sx + poly0
  stark::load_elem(sx, 1, 0, a);
  stark::set_elem(w, poly[3]);
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    stark::mont_mul(f, w, a, t);
    stark::mod_add(f, t, poly[k], w);
  }
  stark::store_elem(out, q, i, w);
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

// xs4: (16, 4, q) -> eqs (16, 16, q), dens (16, 4, q); nothing to do for q = 0.
extern "C" int stark_fri_fold_pre(const void* xs4, void* eqs, void* dens,
                                  long long q, const uint32_t* field_words,
                                  uint32_t np, void* stream) {
  if (q > 0)
    fri_fold_pre_kernel<<<blocks_for(q), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(xs4), static_cast<int32_t*>(eqs),
        static_cast<int32_t*>(dens), q, stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

// sx (16, 1), eqs (16, 16, q), ys4 and invs (16, 4, q) -> out (16, q).
extern "C" int stark_fri_fold_post(const void* sx, const void* eqs,
                                   const void* ys4, const void* invs,
                                   void* out, long long q,
                                   const uint32_t* field_words, uint32_t np,
                                   void* stream) {
  if (q > 0)
    fri_fold_post_kernel<<<blocks_for(q), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(sx), static_cast<const int32_t*>(eqs),
        static_cast<const int32_t*>(ys4), static_cast<const int32_t*>(invs),
        static_cast<int32_t*>(out), q, stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}
