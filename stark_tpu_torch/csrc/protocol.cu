// The prover's elementwise protocol stages and the leaf packing, one launch
// each over the whole evaluation domain.
//
// They replace the TPU kernels of stark_tpu/protocol/pallas_kernels.py, which
// share one launcher (`_call`, :44) over (16, 1024) VMEM tiles:
//   rand_combination      :98   nmr = r0 + r1*idx + r2*S, dnm = r0 + r1*perm + r2*S
//   q1_eval               :118  F0*(P - F1*P_prev - K*S)
//   q2_eval               :137  F2*(P(+2k) - P*P(+k))
//   q3_eval               :154  A*dnm - A_prev*nmr
//   linear_combination    :190  sum k_j*term_j, three terms times x^steps
//   horner_eval           :214  a polynomial of d coefficients at every x
//   vanishing_eval        :236  prod_i (x - x_i)
//   shoup_mul_periodic    :268  x times periodic plain constants, Shoup form
//   linear_combination_shoup :319  the same sum, x^steps as a Shoup pattern pair
//   sub_mul               :353  (a - b)*c
//   from_mont_pack_words  :373  REDC by 1, limb pairs to little-endian words
//
// Common to all: one thread per domain element (or per output), the
// element as 8 packed words in registers, every plane read with `load_elem`
// (thread i reads column i of each limb row, so a warp's loads of a row are
// one 128-byte segment) and written once. No intermediate reaches device
// memory, every output is canonical (< p), so the bits equal the composed
// route's. Small operands (r, k, coefficients, points) are staged once per
// block in shared memory as packed words; coefficients and points in tiles of
// SMALL_TILE columns. The TPU wrappers materialised rolled copies of whole
// planes (a tile cannot wrap); here a rolled operand is read at its shifted
// index. `vanishing_eval` of no points is R mod p from the Field argument; `sub_mul`
// takes b as a plane or as one (16, 1) column; `from_mont_pack_words` stores
// the 8 packed words as they sit in registers, the little-endian words of the
// canonical value. The Shoup kernels multiply by constants that repeat along
// the domain with a short period t (Z^-1 and x^steps: t = the extension
// factor, 8), given as a pattern pair (w and floor(w*2^256/p)); what the
// form saves here is bytes, since the (16, n) table is never read.
//
// What bounds them on an H100: device memory, 64 bytes a plane an element,
// for all but `horner_eval` and `vanishing_eval`, whose run-time loops of
// products turn integer bound at long polynomials. Four were redesigned:
//
// `linear_combination_shoup` (8 planes in, 1 out: 0.180 ms at 2^20 over
// 3.35 TB/s) issued 14 full products and 10 modular additions an element
// (8,000 static SASS instructions with its staging), each plane loaded just
// before its product: bound by its products and by exposed load latency, at
// 2.5 times its bytes. Now:
// - Three terms carry x^steps: k3*P + k4*P*x = (k3 + k4*x)*P, and so for B2
//   and B3. x repeats with period t, so each block computes the three
//   coefficients k3 + k4*x, k5 + k6*x, k7 + k8*x of every column of the
//   pattern once (one Shoup product each) into shared memory; the sum is then
//   8 products, one a plane, the function's minimum.
// - The 8 products are summed wide and reduced once: acc = sum c_j*v_j
//   (512-bit products, canonical c_j, v_j < p) in 17 words, PTX carry chains
//   of 32-bit multiply-adds (`mac_row`, the carries past a row's ninth word
//   deferred to the next row), then one Montgomery reduction (`redc_wide`)
//   and subtractions of 4p, 2p, p. A wide product without its reduction
//   takes ~2.8 SM clocks a thread at full occupancy, a CIOS product ~7.4.
//   Bounds: acc < 8p^2; T = (acc + m*p)/2^256 < 8p^2/2^256 + p.
//     BN254 (p/2^256 ~ 0.189): acc < 2^511 (16 words), T < 2.52p.
//     BLS12-381 Fr (~0.453): acc < 2^512.71 (the 17th word), T < 4.63p.
//     Any field the kernels take (2p < 2^256): acc < 2^513, T < 5p < 2^258,
//     so T fits 9 words and the three subtractions (4p, 2p, p, each where T
//     is not below it) leave T canonical.
// - The next plane's 16 limb rows are loaded before the current product, so
//   a warp has a plane in flight while it multiplies; the first plane's
//   loads are issued before the block stages its coefficients. Under
//   `__launch_bounds__(256, 3)` (80 registers) three blocks share an SM,
//   which hides more of the loads' latency than two (123 registers).
// `linear_combination` (the (16, n) x^steps table, off the prover's path)
// shares the sum: each thread forms its own three coefficients from its x
// with CIOS products.
//
// `q2_eval` (P, F2 in, Q2 out: 3 planes, 0.060 ms) read P three times, at
// i, (i + k) mod n and (i + 2k) mod n with the prover's k ~ n/3. P is 64 MB
// at 2^20 against a 50 MB L2, and the three reads of an element came about
// 22 MB of sweep apart, so each came from device memory again. Now one
// output a thread in the host's order (`fused_kernels.q2_plan`): where
// 0 < k and 3k <= n, a slice of three warps takes g, g + k and g + 2k for
// the same 32 g, reading P at g .. g + 4k, so L1 serves each line to two or
// three warps at once; the prover's 3k = n - 8*(steps mod 3) makes g + 3k
// and g + 4k lines the slice before has just read. Device memory sees P
// about once, as when k = 0. The other outputs, and every output of a shift
// with 3k > n, take one thread each in order. Its two products an output
// (a Montgomery product costs ~7 SM clocks a thread at full occupancy)
// take about as long as its bytes, which keeps it above its bound; three
// outputs a thread, P read five times by one thread, was slower.
//
// `horner_eval` (d coefficients) and `vanishing_eval` (npts points) run, at
// every x, a chain as long as the circuit's count of public wires (2 on the
// real-size circuit, 1,062 on the `bits` golden): bound by their products,
// not their bytes, past two terms. Each did one CIOS product and one
// addition a term (the first a product by zero or one), 9.4 SM clocks a
// term at 2^20. Now a thread works in groups of G terms, each a wide sum
// reduced once (G a build, 1, 2, 4 or 8; the wrapper takes the cheapest by
// a cost model in measured clocks: `fused_kernels.horner_group`,
// `vanishing_group`):
// - Horner in x^G: x^2 .. x^G once (G - 1 CIOS products), then from the
//   highest group down acc <- REDC(acc*x^G + sum_{0<j<G} c_j*x^j +
//   c_0*2^256), c_0*2^256 a word offset, not a product: G wide products
//   and one reduction per G coefficients (2.8 and 4.8 SM clocks a thread
//   against 7.4 for a CIOS product). The highest group, which alone may be
//   short, has no acc term; a lone highest coefficient is the start.
// - The vanishing product by spans of 32 points: each span's monic product
//   x^s + sum_{j<s} e_j*x^j (`vanishing_coeffs_kernel`, once a call, a warp
//   a span) valued by the same Horner in x^G with the leading 1 in the
//   highest group (a shifted power, not a product), and multiplied into
//   acc by one CIOS product from the second span on: per G points G wide
//   products and a reduction, and one CIOS product per 32 points. An
//   earlier step, groups of G points each valued by one wide sum and
//   multiplied in, paid a CIOS product per G points: 16% slower at 17
//   points, 9% at 1,061. The pre-pass is latency-bound (about 1 us a
//   step), so the wrapper counts it in, spread over the elements: below
//   2^20 few points keep G = 1, the product of the differences x - q
//   without the product by one.
// - Bounds: with every operand below p, a group's sum W < G*p^2 + p*2^256
//   (with the leading 1: (G - 1)*p^2 + 2p*2^256), so T = REDC(W) < W/2^256
//   + p stays below 8p, where the subtractions of 4p, 2p and p make it
//   canonical, for G <= 31 on BN254 and G <= 13 on BLS12-381 (with the 1:
//   27 and 12): `fused_kernels.group_fits` derives them exactly.
// - Registers bound G: the powers take 8G of them (G = 8: 121-123, two
//   blocks an SM). G = 12 (one block), the powers in shared memory and
//   more blocks for G = 1 were all slower (scripts/horner_kernels_cuda.py).

#include "field.cuh"

namespace {

using stark::Field;
using stark::NW;
using stark::WIDE;
using stark::add_shifted;
using stark::mac_wide;
using stark::redc_canonical;
using stark::redc_wide;
using stark::reduce_below_8p;

constexpr int THREADS = 256;
constexpr int Q2_THREADS = 192;  // q2_eval's blocks: two slices of three warps
constexpr int SMALL_TILE = 128;  // columns of a small operand staged at once

__device__ __forceinline__ int64_t global_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// Stage columns [base, base + count) of a small (16, k) operand in shared
// memory as packed words; the block must reach this together.
__device__ __forceinline__ void stage_cols(const int32_t* __restrict__ small,
                                           int64_t k, int64_t base, int count,
                                           uint32_t (*sm)[NW]) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    uint32_t w[NW];
    stark::load_elem(small, k, base + j, w);
    stark::set_elem(sm[j], w);
  }
}

__global__ void __launch_bounds__(THREADS)
rand_combination_kernel(const int32_t* __restrict__ r,
                        const int32_t* __restrict__ idx,
                        const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ s,
                        int32_t* __restrict__ nmr, int32_t* __restrict__ dnm,
                        int64_t n, Field f) {
  __shared__ uint32_t rs[3][NW];
  stage_cols(r, 3, 0, 3, rs);
  __syncthreads();
  int64_t i = global_index();
  if (i >= n) return;
  uint32_t v[NW], r2s[NW], t[NW], u[NW];
  stark::load_elem(s, n, i, v);
  stark::mont_mul(f, rs[2], v, r2s);
  stark::load_elem(idx, n, i, v);
  stark::mont_mul(f, rs[1], v, t);
  stark::mod_add(f, t, r2s, u);
  stark::mod_add(f, rs[0], u, t);
  stark::store_elem(nmr, n, i, t);
  stark::load_elem(perm, n, i, v);
  stark::mont_mul(f, rs[1], v, t);
  stark::mod_add(f, t, r2s, u);
  stark::mod_add(f, rs[0], u, t);
  stark::store_elem(dnm, n, i, t);
}

// shift = skips mod n: P_prev[i] = P[(i - shift) mod n].
__global__ void __launch_bounds__(THREADS)
q1_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ k,
          const int32_t* __restrict__ p, const int32_t* __restrict__ f0,
          const int32_t* __restrict__ f1, int32_t* __restrict__ out,
          int64_t n, int64_t shift, Field f) {
  int64_t i = global_index();
  if (i >= n) return;
  int64_t ip = i >= shift ? i - shift : i - shift + n;
  uint32_t a[NW], b[NW], t[NW], u[NW];
  stark::load_elem(f1, n, i, a);
  stark::load_elem(p, n, ip, b);
  stark::mont_mul(f, a, b, t);
  stark::load_elem(k, n, i, a);
  stark::load_elem(s, n, i, b);
  stark::mont_mul(f, a, b, u);
  stark::mod_add(f, t, u, a);
  stark::load_elem(p, n, i, b);
  stark::mod_sub(f, b, a, t);
  stark::load_elem(f0, n, i, a);
  stark::mont_mul(f, a, t, u);
  stark::store_elem(out, n, i, u);
}

// Q2 at element i from P at i, i + k1 and i + k2 (mod n), each canonical.
__device__ __forceinline__ void q2_one(const Field& f, const uint32_t p0[NW],
                                       const uint32_t p1[NW], const uint32_t p2[NW],
                                       const int32_t* __restrict__ f2,
                                       int32_t* __restrict__ out, int64_t n,
                                       int64_t i) {
  uint32_t t[NW], u[NW], w[NW];
  stark::mont_mul(f, p0, p1, t);
  stark::mod_sub(f, p2, t, u);
  stark::load_elem(f2, n, i, w);
  stark::mont_mul(f, w, u, t);
  stark::store_elem(out, n, i, t);
}

// k1 = kshift mod n, k2 = 2*kshift mod n: P(+k)[i] = P[(i + k1) mod n].
// One output a thread, in the order of `fused_kernels.q2_plan`: where span
// > 0 (span = k1, 3*k1 <= n), the first ceil(span/32)*96 threads form slices
// of three warps, warp j of slice s taking the output g + j*k1 for its lane's
// g = 32s + lane < span, so that the slice reads P at g .. g + 4*k1 and each
// line of it from two or three warps at once; the rest take one output each
// in order from 3*span (all of them when span = 0).
__global__ void __launch_bounds__(Q2_THREADS)
q2_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ f2,
          int32_t* __restrict__ out, int64_t n, int64_t k1, int64_t k2,
          int64_t span, Field f) {
  const int64_t t = global_index();
  const int64_t grouped = (span + 31) / 32 * 96;
  int64_t i;
  if (t < grouped) {
    const int64_t g = t / 96 * 32 + t % 32;
    if (g >= span) return;
    i = g + (t % 96) / 32 * k1;
  } else {
    i = t - grouped + 3 * span;
    if (i >= n) return;
  }
  const int64_t i1 = i + k1 < n ? i + k1 : i + k1 - n;
  const int64_t i2 = i + k2 < n ? i + k2 : i + k2 - n;
  uint32_t a[NW], b[NW], c[NW];
  stark::load_elem(p, n, i, a);
  stark::load_elem(p, n, i1, b);
  stark::load_elem(p, n, i2, c);
  q2_one(f, a, b, c, f2, out, n, i);
}

__global__ void __launch_bounds__(THREADS)
q3_kernel(const int32_t* __restrict__ a_ev, const int32_t* __restrict__ nmr,
          const int32_t* __restrict__ dnm, int32_t* __restrict__ out,
          int64_t n, int64_t shift, Field f) {
  int64_t i = global_index();
  if (i >= n) return;
  int64_t ip = i >= shift ? i - shift : i - shift + n;
  uint32_t a[NW], b[NW], t[NW], u[NW];
  stark::load_elem(a_ev, n, i, a);
  stark::load_elem(dnm, n, i, b);
  stark::mont_mul(f, a, b, t);
  stark::load_elem(a_ev, n, ip, a);
  stark::load_elem(nmr, n, i, b);
  stark::mont_mul(f, a, b, u);
  stark::mod_sub(f, t, u, a);
  stark::store_elem(out, n, i, a);
}

// --- the linear combination: one lazy sum of eight products ---------------

constexpr int LC_PLANES = 8;
constexpr int XROW = 3 * NW + 3;  // words of a row of x coefficients (odd: a
                                  // warp's rows fall in different banks)

// The 8 planes in the order the C entry points pass them: p, a, s, d1, d2,
// d3, b2, b3. Plane j takes k[lc_k(j)] or, with lc_x(j) >= 0, the x
// coefficient k[3 + 2w] + k[4 + 2w]*x^steps of w = lc_x(j) (P, B2, B3).
struct LincombCols {
  const int32_t* col[LC_PLANES];
};

__host__ __device__ constexpr int lc_k(int j) {
  return j == 1 ? 9 : j == 2 ? 10 : j == 3 ? 0 : j == 4 ? 1 : j == 5 ? 2 : -1;
}

__host__ __device__ constexpr int lc_x(int j) {
  return j == 0 ? 0 : j == 6 ? 1 : j == 7 ? 2 : -1;
}

struct LincombTile {
  uint32_t ks[11][NW];
  uint32_t cx[THREADS][XROW];  // 3 x coefficients a row, NW words each
};

// The 16 limb rows of element i of a plane, as loaded; `pack_limbs` makes
// them the 8 words of `load_elem`.
__device__ __forceinline__ void load_limbs(const int32_t* __restrict__ plane,
                                           int64_t n, int64_t i,
                                           uint32_t (&raw)[stark::LIMBS]) {
#pragma unroll
  for (int l = 0; l < stark::LIMBS; ++l) raw[l] = static_cast<uint32_t>(plane[l * n + i]);
}

__device__ __forceinline__ void pack_limbs(const uint32_t (&raw)[stark::LIMBS],
                                           uint32_t (&w)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = (raw[2 * k] & 0xFFFFu) | (raw[2 * k + 1] << 16);
}

// The two ways to multiply a coefficient by x^steps at an element; both
// canonical.
struct TimesMont {  // x^steps in Montgomery form, from the (16, n) table
  uint32_t x[NW];
  __device__ __forceinline__ void operator()(const Field& f,
                                             const uint32_t v[NW],
                                             uint32_t t[NW]) const {
    stark::mont_mul(f, v, x, t);
  }
};

struct TimesShoup {  // plain x^steps and its companion, one pattern column
  uint32_t w[NW], wp[NW];
  __device__ __forceinline__ void operator()(const Field& f,
                                             const uint32_t v[NW],
                                             uint32_t t[NW]) const {
    stark::shoup_mul(f, w, wp, v, t);
    stark::cond_sub_p(f, 0, t);
  }
};

// x coefficient `which` (0: P, 1: B2, 2: B3), k[3 + 2w] + k[4 + 2w]*x, into
// its NW words of a tile row.
template <class TimesX>
__device__ __forceinline__ void x_coef(const Field& f, const uint32_t (*ks)[NW],
                                       const TimesX& times_x, int which,
                                       uint32_t* row) {
  uint32_t t[NW], u[NW];
  times_x(f, ks[4 + 2 * which], t);
  stark::mod_add(f, ks[3 + 2 * which], t, u);
#pragma unroll
  for (int w = 0; w < NW; ++w) row[which * NW + w] = u[w];
}

// L at element i: the 8 planes times their coefficients (k from the tile,
// x coefficients from `xrow`), summed wide and reduced once. `raw` holds
// plane 0's limbs, loaded by the caller.
__device__ __forceinline__ void lincomb_lazy(const Field& f, const LincombTile& tile,
                                             const uint32_t* xrow,
                                             const LincombCols& c, int64_t n,
                                             int64_t i, uint32_t (&raw)[stark::LIMBS],
                                             int32_t* __restrict__ out) {
  uint32_t acc[WIDE], v[NW], k[NW];
#pragma unroll
  for (int w = 0; w < WIDE; ++w) acc[w] = 0;
#pragma unroll
  for (int j = 0; j < LC_PLANES; ++j) {
    pack_limbs(raw, v);
    if (j + 1 < LC_PLANES) load_limbs(c.col[j + 1], n, i, raw);
    const uint32_t* src = lc_x(j) >= 0 ? xrow + lc_x(j) * NW : tile.ks[lc_k(j)];
#pragma unroll
    for (int w = 0; w < NW; ++w) k[w] = src[w];
    mac_wide(acc, k, v);
  }
  redc_wide(f, acc);
  uint32_t t[NW + 1];
#pragma unroll
  for (int w = 0; w <= NW; ++w) t[w] = acc[NW + w];
  reduce_below_8p(f, t);
  stark::store_elem(out, n, i, t);
}

__global__ void __launch_bounds__(THREADS, 3)
linear_combination_kernel(const int32_t* __restrict__ k,
                          const int32_t* __restrict__ x2s, LincombCols c,
                          int32_t* __restrict__ out, int64_t n, Field f) {
  __shared__ LincombTile tile;
  const int64_t i = global_index();
  uint32_t raw[stark::LIMBS];
  if (i < n) load_limbs(c.col[0], n, i, raw);
  stage_cols(k, 11, 0, 11, tile.ks);
  __syncthreads();
  if (i >= n) return;
  // this thread's own row of coefficients: no barrier between write and read
  TimesMont times_x;
  stark::load_elem(x2s, n, i, times_x.x);
  uint32_t* row = tile.cx[threadIdx.x];
#pragma unroll 1
  for (int which = 0; which < 3; ++which) x_coef(f, tile.ks, times_x, which, row);
  lincomb_lazy(f, tile, row, c, n, i, raw, out);
}

// A (16, t) Shoup pattern pair for the elements of one block, as packed words
// in shared memory. Element i takes column i mod t. A pattern of at most
// THREADS columns is staged whole, row = column (stride NW + 1 words: the
// few columns a warp reads then lie in different banks); of a wider one
// each thread stages its own column in its own row.
struct PatternTile {
  uint32_t w[THREADS][NW + 1];
  uint32_t wp[THREADS][NW + 1];
};

// Returns the tile row of element i's constants. The block must reach this
// together, and a barrier must follow before the rows are read.
__device__ __forceinline__ int stage_pattern(const int32_t* __restrict__ w_pat,
                                             const int32_t* __restrict__ wp_pat,
                                             int64_t t, int64_t i,
                                             PatternTile& tile) {
  uint32_t v[NW];
  if (t <= THREADS) {
    for (int j = threadIdx.x; j < t; j += blockDim.x) {
      stark::load_elem(w_pat, t, j, v);
      stark::set_elem(tile.w[j], v);
      stark::load_elem(wp_pat, t, j, v);
      stark::set_elem(tile.wp[j], v);
    }
    return static_cast<int>(i % t);
  }
  stark::load_elem(w_pat, t, i % t, v);
  stark::set_elem(tile.w[threadIdx.x], v);
  stark::load_elem(wp_pat, t, i % t, v);
  stark::set_elem(tile.wp[threadIdx.x], v);
  return threadIdx.x;
}

// Stage k and the x coefficients of a (16, t) Shoup pattern pair in the
// tile; returns the row of element i's. A pattern of t <= THREADS columns:
// 3t coefficients, one a thread, in rows 0..t-1, element i reading row
// i mod t. A wider one: each thread forms the three of its own column
// (i mod t) in its own row. The block must reach this together; it ends
// with the barrier after which the rows may be read.
__device__ __forceinline__ int stage_lincomb_shoup(const Field& f,
                                                   const int32_t* __restrict__ k,
                                                   const int32_t* __restrict__ xw_pat,
                                                   const int32_t* __restrict__ xwp_pat,
                                                   int64_t t, int64_t i,
                                                   LincombTile& tile) {
  stage_cols(k, 11, 0, 11, tile.ks);
  __syncthreads();
  int row;
  TimesShoup times_x;
  if (t <= THREADS) {
    for (int j = threadIdx.x; j < 3 * t; j += blockDim.x) {
      const int col = static_cast<int>(j % t);
      stark::load_elem(xw_pat, t, col, times_x.w);
      stark::load_elem(xwp_pat, t, col, times_x.wp);
      x_coef(f, tile.ks, times_x, static_cast<int>(j / t), tile.cx[col]);
    }
    row = static_cast<int>(i % t);
  } else {
    stark::load_elem(xw_pat, t, i % t, times_x.w);
    stark::load_elem(xwp_pat, t, i % t, times_x.wp);
    row = threadIdx.x;
#pragma unroll 1
    for (int which = 0; which < 3; ++which) x_coef(f, tile.ks, times_x, which, tile.cx[row]);
  }
  __syncthreads();
  return row;
}

__global__ void __launch_bounds__(THREADS, 3)
linear_combination_shoup_kernel(const int32_t* __restrict__ k,
                                const int32_t* __restrict__ xw_pat,
                                const int32_t* __restrict__ xwp_pat, int64_t t,
                                LincombCols c, int32_t* __restrict__ out,
                                int64_t n, Field f) {
  __shared__ LincombTile tile;
  const int64_t i = global_index();
  uint32_t raw[stark::LIMBS];
  if (i < n) load_limbs(c.col[0], n, i, raw);
  const int row = stage_lincomb_shoup(f, k, xw_pat, xwp_pat, t, i, tile);
  if (i >= n) return;
  lincomb_lazy(f, tile, tile.cx[row], c, n, i, raw, out);
}

// out[i] = x[i] * w[i mod t] mod p, canonical: one Shoup product and one
// conditional subtraction of p.
__global__ void __launch_bounds__(THREADS)
shoup_mul_periodic_kernel(const int32_t* __restrict__ w_pat,
                          const int32_t* __restrict__ wp_pat, int64_t t,
                          const int32_t* __restrict__ x,
                          int32_t* __restrict__ out, int64_t n, Field f) {
  __shared__ PatternTile tile;
  int64_t i = global_index();
  int row = stage_pattern(w_pat, wp_pat, t, i, tile);
  __syncthreads();
  if (i >= n) return;
  uint32_t v[NW], r[NW];
  stark::load_elem(x, n, i, v);
  stark::shoup_mul(f, tile.w[row], tile.wp[row], v, r);
  stark::cond_sub_p(f, 0, r);
  stark::store_elem(out, n, i, r);
}

// --- horner_eval and vanishing_eval: groups of G terms, summed wide --------

__device__ __forceinline__ void row_words(const uint32_t* row, uint32_t (&v)[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) v[w] = row[w];
}

// xp[k] = x^(k+1) (Montgomery) for k < m <= G from xp[0] = x: m - 1 products.
template <int G>
__device__ __forceinline__ void powers(const Field& f, int64_t m, uint32_t (&xp)[G][NW]) {
#pragma unroll
  for (int k = 1; k < G; ++k)
    if (k < m) stark::mont_mul(f, xp[k - 1], xp[0], xp[k]);
}

// Columns of a small operand staged at once: whole groups of G.
template <int G>
__host__ __device__ constexpr int group_tile() { return SMALL_TILE / G * G; }

// One group of Horner's rule in x^G, coefficients c[0..r) (shared memory):
// acc <- REDC(acc*x^G + sum_{0<j<r} c_j*x^j + c_0*2^256), or without the
// acc term for the first (highest) group, which alone may be short; a first
// group of one coefficient is that coefficient.
template <int G>
__device__ __forceinline__ void horner_group(const Field& f, uint32_t (&xp)[G][NW],
                                             uint32_t (*c)[NW], int r, bool first,
                                             uint32_t (&acc)[NW]) {
  uint32_t k[NW];
  if (first && r == 1) {
    row_words(c[0], acc);
    return;
  }
  uint32_t w[WIDE];
#pragma unroll
  for (int j = 0; j < WIDE; ++j) w[j] = 0;
  if (!first) mac_wide(w, acc, xp[G - 1]);
#pragma unroll
  for (int j = 1; j < G; ++j) {
    if (j < r) {
      row_words(c[j], k);
      mac_wide(w, k, xp[j - 1]);
    }
  }
  row_words(c[0], k);
  add_shifted(w, k);
  redc_canonical(f, w, acc);
}

// out = c[d-1]*x^(d-1) + .. + c[0] (0 for d = 0): Horner's rule in x^G over
// groups of G coefficients from the highest down, the highest group short.
template <int G, int MINB = 1>
__global__ void __launch_bounds__(THREADS, MINB)
horner_kernel(const int32_t* __restrict__ coeffs, int64_t d,
              const int32_t* __restrict__ xs, int32_t* __restrict__ out,
              int64_t n, Field f) {
  constexpr int TILE = group_tile<G>();
  __shared__ __align__(16) uint32_t cs[TILE][NW];
  const int64_t i = global_index();
  const bool live = i < n;
  uint32_t xp[G][NW], acc[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) acc[w] = 0;
  if (live && d > 1) stark::load_elem(xs, n, i, xp[0]);
  bool first = true;
  // tiles of whole groups from the highest coefficients down; the first may
  // be short, and its first group
  for (int64_t hi = d; hi > 0;) {
    const int64_t base = (hi - 1) / TILE * TILE;
    const int count = static_cast<int>(hi - base);
    __syncthreads();
    stage_cols(coeffs, d, base, count, cs);
    __syncthreads();
    if (live) {
      if (first) powers<G>(f, d - 1 < G ? d - 1 : G, xp);
#pragma unroll 1
      for (int top = count; top > 0;) {
        const int lo = (top - 1) / G * G;
        horner_group<G>(f, xp, cs + lo, top - lo, first, acc);
        first = false;
        top = lo;
      }
    }
    hi = base;
  }
  if (live) stark::store_elem(out, n, i, acc);
}

// Points a span covers: the vanishing product's points in spans of SPAN, one
// warp forming each span's monic product.
constexpr int SPAN = 32;

// The coefficients of each span's monic product: prod_{k<s} (x - q_k) =
// x^s + sum_{j<s} e_j*x^j, e_j at column lo + j of es for the span of points
// lo .. lo + s - 1 (lo = SPAN*span; the last span short). One warp a span:
// lane j holds c_j of the product so far, from x - q_0 (c_1 = 1).
// Multiplying in x - q_k: c_j <- c_{j-1} - q_k*c_j, c_{j-1} from lane j - 1
// by a shuffle, so the s - 1 steps cost one product's latency each.
__global__ void __launch_bounds__(THREADS)
vanishing_coeffs_kernel(const int32_t* __restrict__ pts, int64_t npts,
                        int32_t* __restrict__ es, Field f) {
  const int j = static_cast<int>(threadIdx.x % SPAN);
  const int64_t lo = global_index() / SPAN * SPAN;
  // s is the same for the whole warp, so its steps and shuffles are too
  const int s = lo < npts ? static_cast<int>(npts - lo < SPAN ? npts - lo : SPAN) : 0;
  uint32_t c[NW], q[NW], t[NW], below[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) c[w] = t[w] = 0;
  if (s == 0) return;
  stark::load_elem(pts, npts, lo, q);
  if (j == 0) stark::mod_sub(f, t, q, c);
  if (j == 1) stark::set_elem(c, f.one);
  if (s > 1) stark::load_elem(pts, npts, lo + 1, q);
#pragma unroll 1
  for (int k = 1; k < s; ++k) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      below[w] = __shfl_up_sync(0xFFFFFFFFu, c[w], 1);
      if (j == 0) below[w] = 0;
    }
    stark::mont_mul(f, q, c, t);
    if (k + 1 < s) stark::load_elem(pts, npts, lo + k + 1, q);  // the next step's point
    stark::mod_sub(f, below, t, c);
  }
  if (j < s) stark::store_elem(es, npts, lo + j, c);
}

// The value at x of a span's monic product x^s + sum_{j<s} e_j*x^j, from its
// coefficients e[0..s) in shared memory: Horner's rule in x^G over the s + 1
// coefficients, the leading 1 in the highest group. That group, e[lo..s)
// with lo = G*floor(s/G), is REDC(sum_{0<j<t} e_{lo+j}*x^j + (x^t +
// e_lo)*2^256) for t = s - lo > 1 coefficients, x + e_lo for one, the 1
// alone for none; each group below takes acc*x^G (after the lone 1,
// x^G*2^256) and G - 1 coefficients' products and e_{lo'}*2^256.
template <int G>
__device__ __forceinline__ void span_value(const Field& f, uint32_t (&xp)[G][NW],
                                           uint32_t (*e)[NW], int s, uint32_t (&v)[NW]) {
  uint32_t k[NW], w[WIDE];
  const int lo = s / G * G, t = s - lo;
  if (t == 1) {
    row_words(e[lo], k);
    stark::mod_add(f, xp[0], k, v);
  } else if (t > 1) {
#pragma unroll
    for (int i = 0; i < WIDE; ++i) w[i] = 0;
    row_words(e[lo], k);
    add_shifted(w, k);
#pragma unroll
    for (int j = 1; j < G; ++j) {
      if (j < t) {
        row_words(e[lo + j], k);
        mac_wide(w, k, xp[j - 1]);
      } else if (j == t) {
        add_shifted(w, xp[j - 1]);
      }
    }
    redc_canonical(f, w, v);
  }
#pragma unroll 1
  for (int top = lo; top > 0; top -= G) {
#pragma unroll
    for (int i = 0; i < WIDE; ++i) w[i] = 0;
    if (top == s) {
      add_shifted(w, xp[G - 1]);
    } else {
      mac_wide(w, v, xp[G - 1]);
    }
#pragma unroll
    for (int j = 1; j < G; ++j) {
      row_words(e[top - G + j], k);
      mac_wide(w, k, xp[j - 1]);
    }
    row_words(e[top - G], k);
    add_shifted(w, k);
    redc_canonical(f, w, v);
  }
}

// out = prod_j (x - pts[j]) (R mod p for no points). G = 1: the differences
// x - q_j, the first as it is, each further one multiplied in (es: the
// points). G > 1: the spans' values (`span_value`; es: their coefficients),
// the first as it is, each further one multiplied in.
template <int G>
__global__ void __launch_bounds__(THREADS)
vanishing_kernel(const int32_t* __restrict__ es, int64_t npts,
                 const int32_t* __restrict__ xs, int32_t* __restrict__ out,
                 int64_t n, Field f) {
  static_assert(SMALL_TILE % SPAN == 0, "a tile holds whole spans");
  constexpr int STEP = G == 1 ? 1 : SPAN;
  __shared__ __align__(16) uint32_t cs[SMALL_TILE][NW];
  const int64_t i = global_index();
  const bool live = i < n;
  uint32_t xp[G][NW], acc[NW], v[NW], t[NW];
  stark::set_elem(acc, f.one);
  if (live && npts > 0) stark::load_elem(xs, n, i, xp[0]);
  bool first = true;
  for (int64_t base = 0; base < npts; base += SMALL_TILE) {
    const int count = static_cast<int>(npts - base < SMALL_TILE ? npts - base : SMALL_TILE);
    __syncthreads();
    stage_cols(es, npts, base, count, cs);
    __syncthreads();
    if (live) {
      if (first) powers<G>(f, npts < G ? npts : G, xp);
#pragma unroll 1
      for (int lo = 0; lo < count; lo += STEP) {
        if (G == 1) {
          row_words(cs[lo], t);
          stark::mod_sub(f, xp[0], t, v);
        } else {
          span_value<G>(f, xp, cs + lo, count - lo < SPAN ? count - lo : SPAN, v);
        }
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

// b is a (16, n) plane, or with b_is_col one (16, 1) column for every i.
__global__ void __launch_bounds__(THREADS)
sub_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int b_is_col, const int32_t* __restrict__ c,
               int32_t* __restrict__ out, int64_t n, Field f) {
  int64_t i = global_index();
  if (i >= n) return;
  uint32_t x[NW], y[NW], t[NW];
  stark::load_elem(a, n, i, x);
  if (b_is_col) {
    stark::load_elem(b, 1, 0, y);
  } else {
    stark::load_elem(b, n, i, y);
  }
  stark::mod_sub(f, x, y, t);
  stark::load_elem(c, n, i, x);
  stark::mont_mul(f, t, x, y);
  stark::store_elem(out, n, i, y);
}

// (16, n) Montgomery planes -> (8, n) little-endian words of the canonical
// values: a Montgomery product with the integer 1.
__global__ void __launch_bounds__(THREADS)
from_mont_pack_words_kernel(const int32_t* __restrict__ col,
                            int32_t* __restrict__ out, int64_t n, Field f) {
  int64_t i = global_index();
  if (i >= n) return;
  uint32_t x[NW], one[NW], r[NW];
  stark::load_elem(col, n, i, x);
#pragma unroll
  for (int w = 0; w < NW; ++w) one[w] = w == 0 ? 1u : 0u;
  stark::mont_mul(f, x, one, r);
#pragma unroll
  for (int w = 0; w < NW; ++w) out[w * n + i] = static_cast<int32_t>(r[w]);
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

inline const int32_t* in(const void* p) {
  return static_cast<const int32_t*>(p);
}

inline int32_t* outp(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

// Launch `kernel` over n elements (nothing to do for n = 0) on `stream`.
#define STARK_LAUNCH(kernel, n, stream, ...)                        \
  if ((n) > 0)                                                      \
  kernel<<<blocks_for(n), THREADS, 0,                               \
           static_cast<cudaStream_t>(stream)>>>(__VA_ARGS__)

extern "C" int stark_rand_combination(const void* r, const void* idx,
                                      const void* perm, const void* s,
                                      void* nmr, void* dnm, long long n,
                                      const uint32_t* field_words,
                                      uint32_t np, void* stream) {
  STARK_LAUNCH(rand_combination_kernel, n, stream, in(r), in(idx), in(perm),
               in(s), outp(nmr), outp(dnm), n,
               stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stark_q1_eval(const void* s, const void* k, const void* p,
                             const void* f0, const void* f1, void* out,
                             long long n, long long shift,
                             const uint32_t* field_words, uint32_t np,
                             void* stream) {
  STARK_LAUNCH(q1_kernel, n, stream, in(s), in(k), in(p), in(f0), in(f1),
               outp(out), n, shift, stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

// k1, k2, span: `fused_kernels.q2_plan`.
extern "C" int stark_q2_eval(const void* p, const void* f2, void* out,
                             long long n, long long k1, long long k2,
                             long long span, const uint32_t* field_words,
                             uint32_t np, void* stream) {
  const long long threads = (span + 31) / 32 * 96 + n - 3 * span;
  if (n > 0)
    q2_kernel<<<static_cast<unsigned>((threads + Q2_THREADS - 1) / Q2_THREADS),
                Q2_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        in(p), in(f2), outp(out), n, k1, k2, span,
        stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stark_q3_eval(const void* a, const void* nmr, const void* dnm,
                             void* out, long long n, long long shift,
                             const uint32_t* field_words, uint32_t np,
                             void* stream) {
  STARK_LAUNCH(q3_kernel, n, stream, in(a), in(nmr), in(dnm), outp(out), n,
               shift, stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

// cols: 9 device pointers in the order x2s, p, a, s, d1, d2, d3, b2, b3.
extern "C" int stark_linear_combination(const void* k, const void* const* cols,
                                        void* out, long long n,
                                        const uint32_t* field_words,
                                        uint32_t np, void* stream) {
  LincombCols c;
  for (int j = 0; j < LC_PLANES; ++j) c.col[j] = in(cols[j + 1]);
  STARK_LAUNCH(linear_combination_kernel, n, stream, in(k), in(cols[0]), c,
               outp(out), n, stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

// cols: 8 device pointers in the order p, a, s, d1, d2, d3, b2, b3; the
// (16, t) pattern pair holds plain x^steps and its companions, t divides n.
extern "C" int stark_linear_combination_shoup(
    const void* k, const void* xw_pat, const void* xwp_pat, long long t,
    const void* const* cols, void* out, long long n,
    const uint32_t* field_words, uint32_t np, void* stream) {
  LincombCols c;
  for (int j = 0; j < LC_PLANES; ++j) c.col[j] = in(cols[j]);
  STARK_LAUNCH(linear_combination_shoup_kernel, n, stream, in(k), in(xw_pat),
               in(xwp_pat), t, c, outp(out), n,
               stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stark_shoup_mul_periodic(const void* w_pat, const void* wp_pat,
                                        long long t, const void* x, void* out,
                                        long long n,
                                        const uint32_t* field_words,
                                        uint32_t np, void* stream) {
  STARK_LAUNCH(shoup_mul_periodic_kernel, n, stream, in(w_pat), in(wp_pat), t,
               in(x), outp(out), n, stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

// group: the G of a build (`fused_kernels.GROUPS`), checked against the
// field's bound by the wrapper.
extern "C" int stark_horner_eval(const void* coeffs, long long d, int group,
                                 const void* xs, void* out, long long n,
                                 const uint32_t* field_words, uint32_t np,
                                 void* stream) {
  const Field f = stark::make_field(field_words, np);
  switch (group) {
    case 1: STARK_LAUNCH(horner_kernel<1>, n, stream, in(coeffs), d, in(xs), outp(out), n, f); break;
    case 2: STARK_LAUNCH(horner_kernel<2>, n, stream, in(coeffs), d, in(xs), outp(out), n, f); break;
    case 4: STARK_LAUNCH(horner_kernel<4>, n, stream, in(coeffs), d, in(xs), outp(out), n, f); break;
    case 8: STARK_LAUNCH(horner_kernel<8>, n, stream, in(coeffs), d, in(xs), outp(out), n, f); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// es: (16, npts), the points for group 1, else each span's coefficients
// (`vanishing_coeffs`).
extern "C" int stark_vanishing_eval(const void* es, long long npts, int group,
                                    const void* xs, void* out, long long n,
                                    const uint32_t* field_words, uint32_t np,
                                    void* stream) {
  const Field f = stark::make_field(field_words, np);
  switch (group) {
    case 1: STARK_LAUNCH(vanishing_kernel<1>, n, stream, in(es), npts, in(xs), outp(out), n, f); break;
    case 2: STARK_LAUNCH(vanishing_kernel<2>, n, stream, in(es), npts, in(xs), outp(out), n, f); break;
    case 4: STARK_LAUNCH(vanishing_kernel<4>, n, stream, in(es), npts, in(xs), outp(out), n, f); break;
    case 8: STARK_LAUNCH(vanishing_kernel<8>, n, stream, in(es), npts, in(xs), outp(out), n, f); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// pts, es: (16, npts); a warp a span of SPAN points.
extern "C" int stark_vanishing_coeffs(const void* pts, long long npts, void* es,
                                      const uint32_t* field_words, uint32_t np,
                                      void* stream) {
  const long long threads = (npts + SPAN - 1) / SPAN * SPAN;
  STARK_LAUNCH(vanishing_coeffs_kernel, threads, stream, in(pts), npts, outp(es),
               stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stark_sub_mul(const void* a, const void* b, int b_is_col,
                             const void* c, void* out, long long n,
                             const uint32_t* field_words, uint32_t np,
                             void* stream) {
  STARK_LAUNCH(sub_mul_kernel, n, stream, in(a), in(b), b_is_col, in(c),
               outp(out), n, stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stark_from_mont_pack_words(const void* col, void* out,
                                          long long n,
                                          const uint32_t* field_words,
                                          uint32_t np, void* stream) {
  STARK_LAUNCH(from_mont_pack_words_kernel, n, stream, in(col), outp(out), n,
               stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}
