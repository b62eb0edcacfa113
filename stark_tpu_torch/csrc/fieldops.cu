// Scalar-lane exponentiation and the prefix-product scan.
//
// mpow_scalar replaces the TPU kernel stark_tpu/ops/pallas_field.py:573
// `mpow_scalar` (body `_mpow_kernel`: a fori_loop that squares, multiplies
// always and selects, with the exponent bits in SMEM).
//   What bounds it on an H100: a chain of bit_length + popcount dependent
//   Montgomery products on at most 32 lanes; it moves 128 bytes per lane.
//   What the design does about it: nothing can shorten the chain, so the
//   kernel only removes everything around it: one block, one thread per
//   lane, operand and accumulator in registers, the exponent (up to 256 bits)
//   as 8 words passed by value. Every lane shares the exponent, so the
//   multiply is a uniform branch instead of a multiply-and-select.
//
// scan_prod replaces stark_tpu/ops/pallas_field.py:626 `scan_prod` (body
// `_scan_kernel`: a sequential grid that carries the running product in a
// VMEM scratch from one grid step to the next): the inclusive prefix product
// along B of a (16, B, C) array, each column c on its own.
//   What bounds it on an H100: products. Blocks of a CUDA grid run in no
//   order and carry nothing, so the sequential axis is a loop in a thread.
//   One canonical product (field.cuh's C `mont_mul`) is 443 SASS
//   instructions, most on the integer units, and holds a warp's SM
//   partition about as long as a chain of them takes (0.83 us a dependent
//   product on one thread; scripts/scan_kernels_cuda.py, H100 80GB HBM3 at
//   700 W). So a launch runs at the card's product rate where it holds a few
//   warps on every one of the 528 partitions, and at one product a step of
//   its longest thread where it holds fewer: with one thread a column, the
//   prover's first (16, 64, 2048) walked 64 steps on 64 warps, 13 times its
//   bytes bound of 128 bytes an element.
//   What the design does about it: a team of T threads (a power of two, at
//   most B) shares each column. Thread t scans rows [t*B/T, (t+1)*B/T) with
//   the running product in registers and each row's limbs loaded one step
//   ahead (packed only when its product is next), and stores its segment's
//   prefixes; the team scans its T segment totals in shared memory
//   (Kogge-Stone, log2 T steps); then each thread but the first multiplies
//   its rows by the product of the segments before it.
//   A block is (CB columns) x (T segments), threadIdx.x over neighbouring
//   columns, so a warp's row accesses coalesce. The last pass's products
//   are independent but a warp issues in order, so they queue like the
//   chain: a team trades about twice the products for a B/T-long walk. The
//   wrapper (`ops/field_cuda.py scan_team`) therefore takes T = 1 from 2^14
//   columns up and a team below, and `ops/modmath.py prefix_prod` plans
//   wide first levels of 16 rows, where one thread a column fills the card.
//   A segment's first row is reduced mod p by subtraction (the value of its
//   product by Montgomery one) instead of multiplied.
#include "field.cuh"

namespace {

struct Exponent {
  uint32_t w[stark::NW];
};

__global__ void mpow_scalar_kernel(const int32_t* __restrict__ a,
                                   int32_t* __restrict__ out, int k,
                                   Exponent e, int nbits, stark::Field f) {
  int lane = threadIdx.x;
  if (lane >= k) return;
  uint32_t x[stark::NW], acc[stark::NW], t[stark::NW];
  stark::load_elem(a, k, lane, x);
  stark::set_elem(acc, f.one);
#pragma unroll 1
  for (int i = nbits - 1; i >= 0; --i) {
    stark::mont_mul(f, acc, acc, t);
    if ((e.w[i >> 5] >> (i & 31)) & 1u) {
      stark::mont_mul(f, t, x, acc);
    } else {
      stark::set_elem(acc, t);
    }
  }
  stark::store_elem(out, k, lane, acc);
}

constexpr int SCAN_BLOCK = 256;  // most threads of a scan block (CB x T)

// An element's 16 limbs as loaded from (16, n) planes, and their packing
// into 8 words. The packing waits on the loads and a warp issues in order,
// so a row loaded ahead is packed only when its product is next: its loads
// then fly while the product before it runs. `cg` reads through L2 only
// (ld.global.cg), for planes this kernel has written.
template <bool cg>
__device__ __forceinline__ void load_limbs(const int32_t* __restrict__ planes, int64_t n,
                                           int64_t col, uint32_t (&l)[2 * stark::NW]) {
#pragma unroll
  for (int i = 0; i < 2 * stark::NW; ++i) {
    l[i] = static_cast<uint32_t>(cg ? __ldcg(planes + i * n + col) : planes[i * n + col]);
  }
}

__device__ __forceinline__ void pack_limbs(const uint32_t (&l)[2 * stark::NW],
                                           uint32_t w[stark::NW]) {
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) w[i] = (l[2 * i] & 0xFFFFu) | (l[2 * i + 1] << 16);
}

// x mod p for any x < 2^256: p subtracted while x >= p, at most
// floor(2^256 / p) times (5 for BN254's scalar field); one comparison for a
// canonical x. It stands in for the product by Montgomery one that starts a
// segment, with the same value.
__device__ __forceinline__ void reduce_mod_p(const stark::Field& f, uint32_t x[stark::NW]) {
  for (;;) {
    uint32_t d[stark::NW];
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < stark::NW; ++i) {
      uint64_t t = static_cast<uint64_t>(x[i]) - f.p[i] - borrow;
      d[i] = static_cast<uint32_t>(t);
      borrow = (t >> 32) & 1u;
    }
    if (borrow) return;
    stark::set_elem(x, d);
  }
}

__global__ void __launch_bounds__(SCAN_BLOCK)
    scan_prod_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                     int64_t B, int64_t C, stark::Field f) {
  // the team's segment totals, word-major: totals[w][t][cx]
  extern __shared__ uint32_t totals[];
  const int CB = blockDim.x, T = blockDim.y, t = threadIdx.y;
  const int slot = t * CB + threadIdx.x, words_apart = T * CB;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * CB + threadIdx.x;
  const bool live = c < C;
  const int64_t n = B * C;
  const int64_t r0 = t * B / T, r1 = (t + 1) * B / T;
  uint32_t run[stark::NW], v[stark::NW], prod[stark::NW], next[2 * stark::NW];
  stark::set_elem(run, f.one);
  if (live && r0 < r1) {
    load_limbs<false>(x, n, r0 * C + c, next);
    pack_limbs(next, run);
    if (r0 + 1 < r1) load_limbs<false>(x, n, (r0 + 1) * C + c, next);
    reduce_mod_p(f, run);
    stark::store_elem(out, n, r0 * C + c, run);
#pragma unroll 1
    for (int64_t r = r0 + 1; r < r1; ++r) {
      pack_limbs(next, v);
      if (r + 1 < r1) load_limbs<false>(x, n, (r + 1) * C + c, next);
      stark::mont_mul(f, run, v, prod);
      stark::set_elem(run, prod);
      stark::store_elem(out, n, r * C + c, run);
    }
  }
  // inclusive scan of the T segment totals of each column
#pragma unroll
  for (int w = 0; w < stark::NW; ++w) totals[w * words_apart + slot] = run[w];
  __syncthreads();
#pragma unroll 1
  for (int d = 1; d < T; d <<= 1) {
    if (t >= d) {
#pragma unroll
      for (int w = 0; w < stark::NW; ++w) v[w] = totals[w * words_apart + slot - d * CB];
    }
    __syncthreads();
    if (t >= d) {
      stark::mont_mul(f, v, run, prod);
      stark::set_elem(run, prod);
#pragma unroll
      for (int w = 0; w < stark::NW; ++w) totals[w * words_apart + slot] = run[w];
    }
    __syncthreads();
  }
  if (!live || t == 0 || r0 == r1) return;
  // rows of a later segment times the product of the segments before it
  uint32_t before[stark::NW];
#pragma unroll
  for (int w = 0; w < stark::NW; ++w) before[w] = totals[w * words_apart + slot - CB];
  load_limbs<true>(out, n, r0 * C + c, next);
#pragma unroll 1
  for (int64_t r = r0; r < r1; ++r) {
    pack_limbs(next, v);
    if (r + 1 < r1) load_limbs<true>(out, n, (r + 1) * C + c, next);
    stark::mont_mul(f, before, v, prod);
    stark::store_elem(out, n, r * C + c, prod);
  }
}

}  // namespace

// a, out: (16, k) planes, k <= 32; e_words: 8 little-endian words of the
// exponent on the host; nbits: its bit length (at least 1).
extern "C" int stark_mpow_scalar(const void* a, void* out, int k,
                                 const uint32_t* e_words, int nbits,
                                 const uint32_t* field_words, uint32_t np,
                                 void* stream) {
  if (k > 0) {
    Exponent e;
    for (int i = 0; i < stark::NW; ++i) e.w[i] = e_words[i];
    mpow_scalar_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<int32_t*>(out), k, e,
        nbits, stark::make_field(field_words, np));
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out: (16, B, C) planes; inclusive prefix product along B per column c,
// in blocks of `cols` columns x `team` segments (powers of two, team <= B,
// cols * team <= SCAN_BLOCK).
extern "C" int stark_scan_prod(const void* x, void* out, long long B,
                               long long C, int team, int cols,
                               const uint32_t* field_words, uint32_t np,
                               void* stream) {
  if (B > 0 && C > 0) {
    if (team < 1 || cols < 1 || team * cols > SCAN_BLOCK || team > B) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long blocks = (C + cols - 1) / cols;
    const size_t smem = sizeof(uint32_t) * stark::NW * team * cols;
    scan_prod_kernel<<<static_cast<unsigned>(blocks), dim3(cols, team), smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<int32_t*>(out), B, C,
        stark::make_field(field_words, np));
  }
  return static_cast<int>(cudaGetLastError());
}
