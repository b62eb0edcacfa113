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
// What bounds them on an H100: device memory for all but the two with a
// run-time loop. Per element each reads its input planes once (64 bytes a
// plane) and writes its outputs once, against 2 to 14 Montgomery products of
// ~130 integer multiply-adds; `horner_eval` and `vanishing_eval` move two
// planes and do one product per coefficient or point, so a long polynomial
// turns them to integer-multiply bound.
// What the design does about it:
// - One thread per domain element, the element as 8 packed words in
//   registers, every plane read with `load_elem` (thread i reads column i of
//   each limb row, so a warp's loads of a row are one 128-byte segment) and
//   written once. No intermediate ever reaches device memory; every
//   intermediate is canonical (< p), so the bits equal the composed route's.
// - The rolled operands (P_prev, P(+k), P(+2k), A_prev) are read at the
//   shifted index (i - skips) mod n or (i + k) mod n. The TPU wrappers had to
//   materialise rolled copies of whole planes because a tile cannot wrap.
// - The small operands (r, k, coefficients, points) are staged once per block
//   in shared memory as packed words; coefficients and points in tiles of
//   SMALL_TILE columns, so their count is a run-time bound without a limit.
// - `vanishing_eval` starts from R mod p in the Field argument; the TPU
//   wrapper appended it as an extra column.
// - `sub_mul` takes b as a plane or as one (16, 1) column read by every
//   thread, so the constant one is never expanded to a plane.
// - `linear_combination` accumulates term by term (acc, term, k_j, and the
//   x^steps value kept for three terms): about 40 words live at the widest.
// - `from_mont_pack_words` stores the 8 packed words as they sit in
//   registers: they are the little-endian words of the canonical value.
// - The Shoup kernels multiply by constants that repeat along the domain with
//   a short period (Z^-1 and x^steps: the extension factor, 8). On the TPU the
//   form saves limb products (1.7 against 3). Here an exact Shoup product
//   costs the 136 multiply-adds of a CIOS product, and what it saves is
//   bytes: the (16, n) table is never read, so `shoup_mul_periodic` moves 2
//   planes where `mmul` by the table moves 3, and the linear combination 9
//   where the table form moves 10. The pattern pair (w and floor(w*2^256/p),
//   any width t that divides n) is staged per block in shared memory as
//   packed words, whole when t <= THREADS (with a padded stride so that the
//   columns a warp reads fall in different banks), else each thread's own
//   column; the products read it from there at each use, which keeps 16
//   words out of the registers. `linear_combination_shoup` feeds the lazy [0, 2p)
//   products straight to the k_j multiply, whose reduction takes them.
#include "field.cuh"

namespace {

using stark::Field;
using stark::NW;

constexpr int THREADS = 256;
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

// k1 = kshift mod n, k2 = 2*kshift mod n: P(+k)[i] = P[(i + k1) mod n].
__global__ void __launch_bounds__(THREADS)
q2_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ f2,
          int32_t* __restrict__ out, int64_t n, int64_t k1, int64_t k2,
          Field f) {
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

struct LincombCols {
  const int32_t *p, *a, *s, *d1, *d2, *d3, *b2, *b3;
};

// acc += k_j * term; term may be lazy (< 2p), acc stays canonical.
__device__ __forceinline__ void lincomb_term(const Field& f,
                                             const uint32_t kj[NW],
                                             const uint32_t term[NW],
                                             uint32_t acc[NW]) {
  uint32_t t[NW], u[NW];
  stark::mont_mul(f, kj, term, t);
  stark::mod_add(f, acc, t, u);
  stark::set_elem(acc, u);
}

// The two ways to multiply a column value by x^steps at this element.
struct TimesMont {  // x^steps in Montgomery form, from the (16, n) table
  uint32_t x[NW];
  __device__ __forceinline__ void operator()(const Field& f,
                                             const uint32_t v[NW],
                                             uint32_t t[NW]) const {
    stark::mont_mul(f, v, x, t);
  }
};

struct TimesShoup {  // plain x^steps and its companion; the product is < 2p
  const uint32_t *w, *wp;  // in shared memory, read again at each use
  __device__ __forceinline__ void operator()(const Field& f,
                                             const uint32_t v[NW],
                                             uint32_t t[NW]) const {
    stark::shoup_mul(f, w, wp, v, t);
  }
};

// sum_j k_j * term_j at element i, term by term.
template <class TimesX>
__device__ __forceinline__ void lincomb_sum(const Field& f,
                                            const uint32_t (*ks)[NW],
                                            const LincombCols& c, int64_t n,
                                            int64_t i, const TimesX& times_x,
                                            int32_t* __restrict__ out) {
  uint32_t acc[NW], v[NW], t[NW];
  stark::load_elem(c.d1, n, i, v);
  stark::mont_mul(f, ks[0], v, acc);
  stark::load_elem(c.d2, n, i, v);
  lincomb_term(f, ks[1], v, acc);
  stark::load_elem(c.d3, n, i, v);
  lincomb_term(f, ks[2], v, acc);
  stark::load_elem(c.p, n, i, v);
  lincomb_term(f, ks[3], v, acc);
  times_x(f, v, t);
  lincomb_term(f, ks[4], t, acc);
  stark::load_elem(c.b2, n, i, v);
  lincomb_term(f, ks[5], v, acc);
  times_x(f, v, t);
  lincomb_term(f, ks[6], t, acc);
  stark::load_elem(c.b3, n, i, v);
  lincomb_term(f, ks[7], v, acc);
  times_x(f, v, t);
  lincomb_term(f, ks[8], t, acc);
  stark::load_elem(c.a, n, i, v);
  lincomb_term(f, ks[9], v, acc);
  stark::load_elem(c.s, n, i, v);
  lincomb_term(f, ks[10], v, acc);
  stark::store_elem(out, n, i, acc);
}

__global__ void __launch_bounds__(THREADS)
linear_combination_kernel(const int32_t* __restrict__ k,
                          const int32_t* __restrict__ x2s, LincombCols c,
                          int32_t* __restrict__ out, int64_t n, Field f) {
  __shared__ uint32_t ks[11][NW];
  stage_cols(k, 11, 0, 11, ks);
  __syncthreads();
  int64_t i = global_index();
  if (i >= n) return;
  TimesMont times_x;
  stark::load_elem(x2s, n, i, times_x.x);
  lincomb_sum(f, ks, c, n, i, times_x, out);
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

__global__ void __launch_bounds__(THREADS)
linear_combination_shoup_kernel(const int32_t* __restrict__ k,
                                const int32_t* __restrict__ xw_pat,
                                const int32_t* __restrict__ xwp_pat, int64_t t,
                                LincombCols c, int32_t* __restrict__ out,
                                int64_t n, Field f) {
  __shared__ uint32_t ks[11][NW];
  __shared__ PatternTile tile;
  int64_t i = global_index();
  stage_cols(k, 11, 0, 11, ks);
  int row = stage_pattern(xw_pat, xwp_pat, t, i, tile);
  __syncthreads();
  if (i >= n) return;
  TimesShoup times_x{tile.w[row], tile.wp[row]};
  lincomb_sum(f, ks, c, n, i, times_x, out);
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

// out = (..(c[d-1]*x + c[d-2])*x + ..)*x + c[0], from acc = 0; d >= 0.
__global__ void __launch_bounds__(THREADS)
horner_kernel(const int32_t* __restrict__ coeffs, int64_t d,
              const int32_t* __restrict__ xs, int32_t* __restrict__ out,
              int64_t n, Field f) {
  __shared__ uint32_t cs[SMALL_TILE][NW];
  int64_t i = global_index();
  bool live = i < n;
  uint32_t x[NW], acc[NW], t[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) acc[w] = 0;
  if (live) stark::load_elem(xs, n, i, x);
  // tiles from the highest coefficients down; the first may be short
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

// out = prod_j (x - pts[j]), from acc = R mod p; npts >= 0.
__global__ void __launch_bounds__(THREADS)
vanishing_kernel(const int32_t* __restrict__ pts, int64_t npts,
                 const int32_t* __restrict__ xs, int32_t* __restrict__ out,
                 int64_t n, Field f) {
  __shared__ uint32_t ps[SMALL_TILE][NW];
  int64_t i = global_index();
  bool live = i < n;
  uint32_t x[NW], acc[NW], t[NW], u[NW];
  stark::set_elem(acc, f.one);
  if (live) stark::load_elem(xs, n, i, x);
  for (int64_t base = 0; base < npts; base += SMALL_TILE) {
    int count = static_cast<int>(npts - base < SMALL_TILE ? npts - base
                                                          : SMALL_TILE);
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

extern "C" int stark_q2_eval(const void* p, const void* f2, void* out,
                             long long n, long long k1, long long k2,
                             const uint32_t* field_words, uint32_t np,
                             void* stream) {
  STARK_LAUNCH(q2_kernel, n, stream, in(p), in(f2), outp(out), n, k1, k2,
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
  LincombCols c{in(cols[1]), in(cols[2]), in(cols[3]), in(cols[4]),
                in(cols[5]), in(cols[6]), in(cols[7]), in(cols[8])};
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
  LincombCols c{in(cols[0]), in(cols[1]), in(cols[2]), in(cols[3]),
                in(cols[4]), in(cols[5]), in(cols[6]), in(cols[7])};
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

extern "C" int stark_horner_eval(const void* coeffs, long long d,
                                 const void* xs, void* out, long long n,
                                 const uint32_t* field_words, uint32_t np,
                                 void* stream) {
  STARK_LAUNCH(horner_kernel, n, stream, in(coeffs), d, in(xs), outp(out), n,
               stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stark_vanishing_eval(const void* pts, long long npts,
                                    const void* xs, void* out, long long n,
                                    const uint32_t* field_words, uint32_t np,
                                    void* stream) {
  STARK_LAUNCH(vanishing_kernel, n, stream, in(pts), npts, in(xs), outp(out),
               n, stark::make_field(field_words, np));
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
