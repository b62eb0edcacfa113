// Scalar-lane exponentiation and the prefix-product scan.
//
// mpow_scalar replaces the TPU kernel stark_tpu/ops/pallas_field.py:573
// `mpow_scalar` (body `_mpow_kernel`: a fori_loop that squares, multiplies
// always and selects, with the exponent bits in SMEM): a^e of a (16, k <= 32)
// plane, e < 2^256 known on the host.
//   What bounds it on an H100: the chain of e.bit_length() - 1 dependent
//   squares (253 for BN254's p - 2, the prover's Fermat inversion), each of
//   which holds one warp on one SM partition: a product's 64-bit
//   multiply-adds issue at a fraction of a warp a clock, so a square costs
//   what its warp instructions cost, dependent or not (PR 7). It moves 128
//   bytes a lane.
//   What the design does about it (scripts/mpow_kernels_cuda.py times each
//   step on the card):
//   - the multiplies leave the chain: warp 0 only squares, and two
//     multiply warps (other partitions) each take a stream of e's bits (the
//     host deals e's 4-bit digits round robin, `ops/field_cuda.py
//     mpow_streams`), warp 1 keeping the top digits and folding the others'
//     products in; after the last square one product is left;
//   - a dedicated square in a radix-2^29 form (field.cuh's `mont_sqr29`: 9
//     limbs, R' = 2^261, 45 + 81 products, each one IMAD.WIDE into a 64-bit
//     column sum with no carry between them; 211 SASS instructions against
//     `mont_mul`'s 443), lazy: values stay below 2p, as 4p < 2^261 holds for
//     every field the kernels take (BLS12-381's too), so no field needs a
//     canonical chain. The powers it hands over carry 2^(-5 (2^i - 1)),
//     which warp 1's starting value cancels (`mpow_start`);
//   - the hand-over costs the chain 9 tagged stores a square and no fence:
//     each square goes, tagged, into a ring slot that the multiply warps
//     poll; the squaring warp checks their progress every 16 squares.
//   Tried and dropped (times in PERF.md): the steps one at a time (windows
//   of 3-5 bits left to right; two warps with `mont_mul`; a 32-bit SOS
//   square, made canonical or lazy; squares handed over behind a fenced
//   counter, ~0.14 us each); a square spread over 9 lanes of a warp (a limb a
//   lane, carry rounds by shuffle: more instructions than one lane's, and
//   ten dependent shuffle rounds); a product-scanning form of the square.
//   The multiplies needed no window: the binary streams keep up.
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

constexpr int MPOW_STREAMS = 2;  // multiply warps beside the squaring warp, at most
constexpr int MPOW_RING = 32;    // squares held for the multiply warps
constexpr int MPOW_HALF = MPOW_RING / 2;

// The exponent recoded on the host (`ops/field_cuda.py mpow_streams`): one
// stream of e's bits for each multiply warp, disjoint, summing to e; and
// multiply warp 1's starting value (`mpow_start`).
struct MpowStreams {
  uint32_t e[MPOW_STREAMS][stark::NW];
  uint32_t start[stark::NW];
};

// Word j of an 8-word exponent, j known at run time, without indexing an
// array in local memory.
__device__ __forceinline__ uint32_t word_at(const uint32_t (&e)[stark::NW], int j) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) w = i == j ? e[i] : w;
  return w;
}

__device__ __forceinline__ int bit_length(const uint32_t (&e)[stark::NW]) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) n = e[i] ? 32 * i + 32 - __clz(e[i]) : n;
  return n;
}

// A counter in shared memory that one warp bumps (release) and another
// reads (acquire).
__device__ __forceinline__ int load_acquire(const int* counter) {
  int v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(counter)))
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* counter, int v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;"
               :
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(counter))), "r"(v)
               : "memory");
}

// Spin until a counter exceeds v.
__device__ __forceinline__ void wait_above(const int* counter, int v) {
  while (load_acquire(counter) <= v) {
  }
}

// acc times the products that the other multiply warps leave in `accs`, each once
// its `done` flag is up.
__device__ __forceinline__ void fold_streams(const stark::Field& f,
                                             const uint32_t (*accs)[stark::NW][32],
                                             const int* done, int streams, int col,
                                             uint32_t acc[stark::NW]) {
  for (int o = 1; o < streams; ++o) {
    uint32_t x[stark::NW], t[stark::NW];
    wait_above(&done[o], 0);
#pragma unroll
    for (int w = 0; w < stark::NW; ++w) x[w] = accs[o][w][col];
    stark::mont_mul(f, acc, x, t);
    stark::set_elem(acc, t);
  }
}

// The tag that marks slot i % MPOW_RING as holding square i: bits 29-31
// of each of its limbs (below 2^29), one more than i / MPOW_RING mod 8. A
// slot holds 0 (its start) or an earlier square of the same slot, whose
// tags all differ from square i's for i < 8 MPOW_RING = 256, but for the
// 8th pass's tag, 0, which a reader takes only once every slot has been
// written (`lapped`).
__device__ __forceinline__ uint32_t ring_tag(int i) {
  return static_cast<uint32_t>((i / MPOW_RING + 1) & 7) << 29;
}

// Warp 0 squares in the radix-2^29 form (field.cuh's `mont_sqr29`), one
// lane a column: x_0 = a mod p, x_{i+1} = x_i^2 2^-261 mod p (below 2p), and
// writes every x_i, tagged, to slot i % MPOW_RING of a ring in shared
// memory: no branch and no fence on the chain. Every MPOW_HALF squares it
// waits until each multiply warp's next bit (`next`, released by that warp)
// lies past the slots it is about to overwrite. Multiply warp m walks the
// bits of its stream: it spins until the slot of its next bit holds all 9
// limbs under that square's tag (each 32-bit store lands whole), makes the
// limbs words and multiplies its accumulator by them with field.cuh's
// canonical `mont_mul` (acc < p, x < 2p: acc x < p 2^256). Warp 2 hands its
// product to warp 1, which starts from `start` (the squares carry
// 2^(-5 (2^i - 1)) against the R = 2^256 powers; see `mpow_start`), folds
// it in before its first bit above warp 2's last, and stores the result.
__global__ void __launch_bounds__(32 * (1 + MPOW_STREAMS))
    mpow_scalar_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int k,
                       MpowStreams s, int streams, int nbits, stark::Field f) {
  __shared__ uint32_t ring[MPOW_RING][stark::NL29][32];
  __shared__ uint32_t accs[MPOW_STREAMS][stark::NW][32];
  __shared__ int next[MPOW_STREAMS], done[MPOW_STREAMS], lapped;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < MPOW_RING * stark::NL29 * 32; i += blockDim.x) {
    (&ring[0][0][0])[i] = 0;
  }
  if (threadIdx.x < MPOW_STREAMS) next[threadIdx.x] = done[threadIdx.x] = 0;
  if (threadIdx.x == 0) lapped = 0;
  __syncthreads();
  if (warp == 0) {
    uint32_t x[stark::NW], y[stark::NL29], z[stark::NL29], p29[stark::NL29];
    if (lane < k) {
      stark::load_elem(a, k, lane, x);
      reduce_mod_p(f, x);
    } else {
#pragma unroll
      for (int w = 0; w < stark::NW; ++w) x[w] = 0;
    }
    stark::to_limbs29(x, y);
    stark::to_limbs29(f.p, p29);
    const uint32_t np29 = f.np & stark::MASK29;
    for (int i = 0;; ++i) {
      if (i % MPOW_HALF == 0 && i + MPOW_HALF > MPOW_RING) {
        if (i == MPOW_RING) {
          __syncwarp();
          if (lane == 0) store_release(&lapped, 1);
        }
        for (int m = 0; m < streams; ++m) wait_above(&next[m], i + MPOW_HALF - MPOW_RING - 1);
      }
      const uint32_t tag = ring_tag(i);
      uint32_t(&slot)[stark::NL29][32] = ring[i % MPOW_RING];
      if (i + 1 == nbits) {
#pragma unroll
        for (int q = 0; q < stark::NL29; ++q) slot[q][lane] = y[q] | tag;
        break;
      }
      stark::mont_sqr29(p29, np29, y, z);
#pragma unroll
      for (int q = 0; q < stark::NL29; ++q) {
        slot[q][lane] = y[q] | tag;
        y[q] = z[q];
      }
    }
    return;
  }
  const int m = warp - 1;
  if (m >= streams) return;
  uint32_t e[stark::NW], acc[stark::NW], x[stark::NW], t[stark::NW];
#pragma unroll
  for (int w = 0; w < stark::NW; ++w) {
    e[w] = 0;
#pragma unroll
    for (int o = 0; o < MPOW_STREAMS; ++o) e[w] = o == m ? s.e[o][w] : e[w];
    acc[w] = m == 0 ? s.start[w] : f.one[w];
  }
  // warp 1 folds the other warps' products in before its first bit at or
  // above `fold_at`, where they have been handed their last value
  int fold_at = 0;
#pragma unroll
  for (int o = 1; o < MPOW_STREAMS; ++o) fold_at = max(fold_at, bit_length(s.e[o]));
  bool folded = m > 0 || streams == 1;
  // the stream's bits, lowest first: `next` is the one waited for
  int i = 0;
  uint32_t cur = word_at(e, 0);
  auto advance = [&](int from) {
    for (i = from; i < nbits; ++i) {
      if ((i & 31) == 0) cur = word_at(e, i >> 5);
      if (cur & 1u) break;
      cur >>= 1;
    }
    if (i < nbits) cur >>= 1;
    __syncwarp();
    if (lane == 0) store_release(&next[m], i);
  };
  advance(0);
#pragma unroll 1
  while (i < nbits) {
    if (!folded && i >= fold_at) {
      fold_streams(f, accs, done, streams, lane, acc);
      folded = true;
    }
    if (i >= 7 * MPOW_RING) wait_above(&lapped, 0);
    const volatile uint32_t* slot = &ring[i % MPOW_RING][0][lane];
    const uint32_t tag = ring_tag(i);
    uint32_t l29[stark::NL29];
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int q = 0; q < stark::NL29; ++q) {
        l29[q] = slot[32 * q];
        ready &= (l29[q] & ~stark::MASK29) == tag;
      }
    } while (!ready);
#pragma unroll
    for (int q = 0; q < stark::NL29; ++q) l29[q] &= stark::MASK29;
    advance(i + 1);
    stark::from_limbs29(l29, x);
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
  if (!folded) fold_streams(f, accs, done, streams, lane, acc);  // no bit of its own above
  if (lane < k) stark::store_elem(out, k, lane, acc);
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

// a, out: (16, k) planes, k <= 32; stream_words: `streams` (<= MPOW_STREAMS)
// exponents of 8 little-endian words each, disjoint, summing to e, then the
// 8 words of multiply warp 1's start; nbits: e's bit length (at least 1).
extern "C" int stark_mpow_scalar(const void* a, void* out, int k,
                                 const uint32_t* stream_words, int streams, int nbits,
                                 const uint32_t* field_words, uint32_t np, void* stream) {
  if (k > 32 || streams < 1 || streams > MPOW_STREAMS || nbits < 1 || nbits > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) {
    MpowStreams s = {};
    for (int m = 0; m < streams; ++m)
      for (int i = 0; i < stark::NW; ++i) s.e[m][i] = stream_words[m * stark::NW + i];
    for (int i = 0; i < stark::NW; ++i) s.start[i] = stream_words[streams * stark::NW + i];
    mpow_scalar_kernel<<<1, 32 * (1 + streams), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<int32_t*>(out), k, s, streams, nbits,
        stark::make_field(field_words, np));
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
