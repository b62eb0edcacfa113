// Radix-2 NTT butterfly stages over (16, n) limb planes.
//
// The flat array is viewed as (16, m, 2, l) with n = 2ml. Within each group
// of 2l, position k pairs u = x[k] and v = x[k + l] with the twiddle
// tw_k = root^(k*m), read from the stage's (16, l) table:
//   Gentleman-Sande DIF (natural in, bit-reversed out):
//     y[k] = u + v,     y[k + l] = (u - v) * tw_k
//   Cooley-Tukey DIT (bit-reversed in, natural out):
//     t = v * tw_k,     y[k] = u + t,     y[k + l] = u - t
//
// butterfly_stage and butterfly_pass replace stark_tpu/ops/pallas_field.py:446
// `butterfly_stage` (one stage with l >= TILE, strided (16, 1, 2, 1024)
// blocks): the stage as it is, and the run of such stages that the NTT plan
// launches, up to three a launch. butterfly_fused replaces
// stark_tpu/ops/pallas_field.py:518 `butterfly_fused` (every stage with
// 2l <= block, run back to back in VMEM with XOR-roll partner exchange and
// period-2l twiddle rows).
//
// butterfly_stage: what bounds it on an H100 is device memory, a stage
// reads and writes the whole array (2 x 64 MiB at n = 2^20) for n/2
// Montgomery products. One thread per (group, k) pair; consecutive threads
// take consecutive k, so the u, v, twiddle and output rows are read and
// written as contiguous 128-byte warp segments. The plan no longer runs it
// (`ops/ntt.py run` takes the passes); it stays, held against its plain
// version.
//
// butterfly_pass: r <= 3 consecutive outer stages (l = l0 .. 4 l0, l0 >=
// 2048 on the plan's path) in one launch, so the column moves once where
// the stages moved it r times. Stage s pairs elements j and j + 2^s of the
// group of 2^r elements base + j l0, and every twiddle of the pass comes from
// its largest stage's table (tw_l[k] = tw_2l[2k]), which the plan holds as 8
// packed words an element (32 bytes, half the limb planes' 64): two 16-byte
// loads a twiddle. What bounds it: the column's bytes first. A device copy
// of a (16, 2^20) column takes 0.049 ms and a pass 0.058 / 0.066 / 0.069-0.072
// ms at r = 1 / 2 / 3 (one H100 80GB HBM3 at 700 W, `scripts/
// ntt_kernels_cuda.py`): each stage adds its products (~600 SASS
// instructions a butterfly) mostly under the bytes, and passes of 4 and 5
// stages, which the probe also builds, save only 8% of the 2^20 run (the
// products bind there). The design:
// - A CTA holds a tile of the 2^r rows of one group at K = min(l0, 512 /
//   2^r) consecutive k in shared memory, word major (conflict-free: a
//   warp's lanes on consecutive k). 256 threads load two neighbouring
//   elements each as 8-byte accesses to each limb plane, run one butterfly
//   each a stage between __syncthreads, and store two each. About 48-64
//   registers, 16 KB of shared memory, so 4-5 CTAs an SM overlap one
//   another's loads, products and stores.
// - Tried on the card and dropped (the probe script keeps them): one
//   thread a group in registers (127-138 registers, 0.12-0.20 ms at 2^20:
//   too few warps for the loads in flight), its twiddles from each stage's
//   own table, the tile with scalar accesses and twiddles read from limb
//   planes (0.082-0.090 ms), and a persistent tile that copies the next
//   tile in with cp.async while the current one computes (0.080-0.092 ms).
// - The butterflies are butterfly_fused's (fused_butterfly): lazy on BN254
//   (DIT below 4p, DIF below 2p, reduced on the way out), canonical on
//   BLS12-381, the same choice by the field (`ops/ntt.py fused_lazy`). The
//   output is canonical, so a pass equals its stages run one by one, bit
//   for bit. The kernel's index map and its lazy bounds are modelled in
//   `tests/test_torch_ntt_pass.py`.
//
// butterfly_fused (replaces stark_tpu/ops/pallas_field.py:518). What bounds
// it on an H100: the integer instruction stream. Its log2(block) stages move
// the array once in and once out (0.04 ms at 2^20) but issue 11 x n/2
// butterflies, most of them with a 256-bit Montgomery product of some 530
// SASS instructions (`scripts/ntt_kernels_cuda.py` counts one butterfly's
// SASS and prices it at the SM's issue rate). The design:
// - A thread keeps 4 elements in registers and runs two radix-2 stages on
//   them between exchanges (rounds of stages 2^s0, 2^(s0+1); at block 2048
//   five pairs from l = 1 up and l = 1024 alone): the same stages in the
//   same order on the same values, so exact for any tw_cat. Between rounds
//   the elements pass through one of two word-major exchange buffers (one
//   __syncthreads a round) whose XOR-swizzled columns make every access free
//   of bank conflicts. The round of stride 1024 reads (DIF) or writes (DIT)
//   the limb planes directly; the other side of the block goes through a
//   coalesced copy. (Reading and writing the round of l = 1, 2 straight from
//   and to the planes as 16-byte vectors, with the next block prefetched
//   into L2, was slower in a trial build on the card.)
// - A cluster of two CTAs shares each block, 256 threads each, two CTAs an
//   SM: each holds half of the block (two 32 KB exchange buffers) and the
//   stages below 1024 (32 KB of twiddles, staged once packed as 8-word
//   elements, two 16-byte loads each), runs those stages on its half alone,
//   and the stage of stride 1024 pairs the halves through distributed
//   shared memory (DIF's first round writes into both CTAs' buffers, DIT's
//   last reads both, behind cluster barriers; its twiddles come from L2).
//   The clusters persist and walk the blocks. So the pass fills the card at
//   2^17 (64 blocks on 128 SMs, not 64) and at 2^20 two CTAs an SM overlap
//   one another's exchanges and barriers with their products, where one
//   CTA of 512 threads a whole block left them bare (4-6% faster at 2^20
//   than that design in a trial build on one H100 80GB HBM3 at 700 W). 4 elements a thread (~110
//   registers) beat 2 (1024 threads held to 64 registers) and 8 (256
//   threads, ~200 registers) in trial builds on the card. The next block
//   is not loaded while one is computed: its limb planes take twice the
//   room of its words (16-bit limbs in int32), more than shared memory has
//   beside the buffers and twiddles; the other CTA's warps fill that wait.
// - Lazy reduction (Harvey): DIT keeps values below 4p, DIF below 2p; the
//   products skip their final subtraction and the block is reduced on its
//   way out. That build needs 5p < 2^256 (BN254's scalar field). A field
//   without that headroom (BLS12-381's, 4p > 2^256 > 2p) gets the canonical
//   build of the same pass: canonical sums and differences, each product
//   followed by one conditional subtraction, every value below p. The field
//   picks the build, never the shape or a caller: `ops/ntt.py fused_lazy`,
//   true iff 5p < 2^256, passed to the entry point as `lazy`.
// - Products and sums as PTX carry chains (mont_mul_lazy). ptxas turns a
//   multiply-add with carry into an IMAD or IMAD.HI and an IADD3.X, the
//   carry in a predicate, and the SM issues those on its two integer pipes
//   side by side: more SASS instructions than the earlier C product with
//   64-bit sums (IMAD.WIDE, FIOS order), yet faster in a trial build.
// - A twiddle equal to f.one (tested by value) skips its product: the
//   product by R mod p is the operand itself. The round of stages l = 1, 2
//   gives every thread the same pattern (a thread's two butterflies of l = 2
//   take k = 0 and k = 1), so all of l = 1 and half of l = 2 skip whole
//   warps.
//
// butterfly_pass_shoup and butterfly_fused_shoup: the Shoup-twiddle forms of
// the two (stark_tpu/ops/pallas_field.py:427 _single_stage_kernel and :483
// _fused_kernel with shoup=True, the arithmetic of :407
// _butterfly_pair_shoup). Twiddles are plain values w with their companions
// floor(w 2^256 / p), 16 words an entry (64 bytes, twice the Montgomery
// form's 32); every product has field.cuh's shoup_mul's value (exact
// quotient, result below 2p for any operand below 2^256); every value lies
// in [0, 2p), sums and differences keep their carry out of bit 256 and
// subtract 2p where they reach it, so any field with 2p < 2^256 takes them
// (BN254's and BLS12-381's scalar fields); with `canon` the last stage's
// outputs are reduced below p.
// - butterfly_pass_shoup is butterfly_pass's tile (same index map, 16 KB of
//   shared memory, 256 threads), its twiddle four 16-byte loads, its product
//   field.cuh's shoup_mul. Bound: the column's bytes, as the Montgomery
//   pass, plus the companions' (2 x 16 MiB of tables at 2^20 against 2 x
//   128 MiB of column).
// - butterfly_fused_shoup runs butterfly_fused's design with Shoup
//   butterflies. What bounds it: the integer instruction stream and its
//   dependences, as row 3 (11 x n/2 butterflies, the array moved once in and
//   once out). The design:
//   - Row 3's schedule: a cluster of two CTAs of 256 threads a block, each
//     holding half of it in two XOR-swizzled exchange buffers (64 KB), 4
//     elements a thread, two stages a round (6 barriers a block of 2048,
//     where the first build synced a CTA a stage, 11), the stage of stride
//     1024 through distributed shared memory with its twiddles from L2,
//     persistent clusters (cudaOccupancyMaxActiveClusters); a block of 2 on
//     one CTA of 512 threads.
//   - 40 KB of staged twiddles: only the table of stage ls = block / 4, the
//     largest below the stride-h stage (rows ls - 1 .. 2 ls - 2 of the
//     table), since every smaller stage's is a stride of it (tw_l[k] =
//     tw_ls[k ls / l], as a plan builds them); 512 entries at block 2048,
//     staged once a CTA in five planes of 16-byte vectors at tw_pos, which
//     keeps every stage's loads free of bank conflicts. 104 KB a CTA, two
//     CTAs an SM (228 KB); the full 1,023-entry table would not fit twice.
//   - The product in the radix-2^29 form (shoup_mul29, the staged entries
//     already in 29-bit limbs): column sums of limb products, one IMAD.WIDE
//     each with a 64-bit addend, no carry chains; q from the full product's
//     normalised limbs, r from the 9 low columns of w x + q (2^261 - p):
//     381 SASS instructions a butterfly, where the word form's PTX carry
//     chains take 570 and row 3's Montgomery butterfly 607.
//   - The twiddle 1 (w = 1 with its companion, tested by value) takes no
//     product: x - p where x >= c1 = ceil(2^256 / wp1), else x, the exact
//     value for x < 2p (`shoup_one`, on the host). Only in the round of
//     l = 1, 2, where a warp's lanes share each twiddle (all of l = 1, half
//     of l = 2: 14% of the products); elsewhere the branch would keep the
//     compiler from overlapping a thread's two butterflies.
//   - 116-122 registers, no spills (ptxas), under the 128 of two CTAs of
//     256 threads an SM.
//   On one H100 80GB HBM3 at 700 W (scripts/ntt_kernels_cuda.py, in one
//   call): 2^20 dit 0.2021-0.2027 ms, row 3 0.2176-0.2177, the first build
//   0.2716-0.2718; dif 0.2101-0.2110, row 3 0.2086-0.2098; 2^17 0.0339-0.0341
//   against row 3's 0.0366-0.0373. Tried and dropped (the probe keeps them):
//   the word form's carry chains 0.2112-0.2118 at dit (the first build of
//   this design took 0.2269-0.2277 with them, row 3 0.2173-0.2174 in that
//   call), field.cuh's C product 0.2098-0.2099, the twiddle 1 tested in
//   every round 0.2079-0.2083 (dif 0.2181-0.2189); in an earlier call, where
//   that build took 0.2192-0.2202, one accumulator for the chains' low
//   halves 0.2328-0.2333 and no product by 1 skipped 0.2296-0.2299.
#include <cooperative_groups.h>

#include "field.cuh"

namespace cg = cooperative_groups;

namespace {

template <bool DIT>
__device__ __forceinline__ void butterfly(const stark::Field& f,
                                          const uint32_t u[stark::NW],
                                          const uint32_t v[stark::NW],
                                          const uint32_t w[stark::NW],
                                          uint32_t y0[stark::NW],
                                          uint32_t y1[stark::NW]) {
  if (DIT) {
    uint32_t t[stark::NW];
    stark::mont_mul(f, v, w, t);
    stark::mod_add(f, u, t, y0);
    stark::mod_sub(f, u, t, y1);
  } else {
    uint32_t d[stark::NW];
    stark::mod_add(f, u, v, y0);
    stark::mod_sub(f, u, v, d);
    stark::mont_mul(f, d, w, y1);
  }
}

template <bool DIT>
__global__ void butterfly_stage_kernel(const int32_t* __restrict__ a,
                                       const int32_t* __restrict__ tw,
                                       int32_t* __restrict__ out, int64_t n,
                                       int64_t l, stark::Field f) {
  int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n / 2) return;
  int64_t g = j / l;
  int64_t k = j - g * l;
  int64_t i0 = g * 2 * l + k;
  int64_t i1 = i0 + l;
  uint32_t u[stark::NW], v[stark::NW], w[stark::NW];
  uint32_t y0[stark::NW], y1[stark::NW];
  stark::load_elem(a, n, i0, u);
  stark::load_elem(a, n, i1, v);
  stark::load_elem(tw, l, k, w);
  butterfly<DIT>(f, u, v, w, y0, y1);
  stark::store_elem(out, n, i0, y0);
  stark::store_elem(out, n, i1, y1);
}

constexpr int PASS_MAX_STAGES = 3;  // outer stages a butterfly_pass runs
constexpr int PASS_TILE = 512;      // elements a CTA of the pass holds

constexpr int FB_MAX_LOG = 11;  // blocks up to 2048 elements
constexpr int FB_EPT = 4;       // elements a thread: two stages a round
constexpr int FB_THREADS = (1 << FB_MAX_LOG) / FB_EPT;

// Column of element i of the exchange buffer: bits 5 and 6 of i XORed into
// its bank bits, so that every round's reads and writes of a word plane, and
// the coalesced copies, are free of bank conflicts (a warp's 32 lanes vary
// i's bits 2-6 in the round of stride 1, bits 0-1 and 4-6 at stride 4,
// bits 0-3 and 6 at stride 16, bits 0-4 beyond).
__device__ __forceinline__ int fb_col(int i) {
  return i ^ (((i >> 5) & 1) * 5) ^ (((i >> 6) & 1) * 26);
}

__device__ __forceinline__ bool is_one(const stark::Field& f, const uint32_t w[stark::NW]) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) eq &= w[i] == f.one[i];
  return eq;
}

// Carry chains in PTX, one asm statement a chain so that the carry flag
// never crosses statements. ptxas lowers a multiply-add with carry to an
// IMAD (or IMAD.HI) and an IADD3.X whose carry rides in a predicate.

// d = a - b over 8 words; returns 0xffffffff if it borrowed (a < b), else 0
__device__ __forceinline__ uint32_t sub_words(const uint32_t (&a)[stark::NW],
                                              const uint32_t (&b)[stark::NW],
                                              uint32_t (&d)[stark::NW]) {
  uint32_t s[stark::NW], borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]),
        "=r"(s[6]), "=r"(s[7]), "=r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) d[i] = s[i];
  return borrow;
}

// r = a + b over 8 words, for sums that stay below 2^256
__device__ __forceinline__ void add_words(const uint32_t (&a)[stark::NW],
                                          const uint32_t (&b)[stark::NW],
                                          uint32_t (&r)[stark::NW]) {
  uint32_t s[stark::NW];
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]),
        "=r"(s[6]), "=r"(s[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) r[i] = s[i];
}

// a - m where a >= m, else a (a < 2m, m < 2^256)
__device__ __forceinline__ void sub_if_ge(uint32_t (&a)[stark::NW],
                                          const uint32_t (&m)[stark::NW]) {
  uint32_t d[stark::NW];
  const uint32_t borrow = sub_words(a, m, d);
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) a[i] = borrow ? a[i] : d[i];
}

// r = a + (m - b) for b <= m
__device__ __forceinline__ void add_diff(const uint32_t (&a)[stark::NW],
                                         const uint32_t (&m)[stark::NW],
                                         const uint32_t (&b)[stark::NW],
                                         uint32_t (&r)[stark::NW]) {
  uint32_t d[stark::NW];
  sub_words(m, b, d);
  add_words(a, d, r);
}

// t[0..7] += lo(a[j] * b) at word j, the carry into t[8]
__device__ __forceinline__ void mad_lo_row(uint32_t (&t)[stark::NW + 1],
                                           const uint32_t (&a)[stark::NW], uint32_t b) {
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

// t[1..8] += hi(a[j] * b) at word j + 1; the caller's bound keeps the sum
// below 2^288, so no carry leaves t[8]
__device__ __forceinline__ void mad_hi_row(uint32_t (&t)[stark::NW + 1],
                                           const uint32_t (&a)[stark::NW], uint32_t b) {
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

// The Montgomery product a*b*2^-256 mod p (field.cuh's R) without its final
// subtraction, for a < 4p, b < p and 5p < 2^256. CIOS, a row a word of b:
// t += a*b_i, m = t_0*n', t += m*p, t >>= 32, each product as two carry
// chains (low halves, then high halves one word up). The running t stays
// below a + p, so a row's sums stay below (a + p)*2^32 < 2^288 (nine words),
// and the result is below a*b/2^256 + p < 2p. The canonical build's operands
// (a, b < p, 2p < 2^256) keep the same bounds.
__device__ __forceinline__ void mont_mul_lazy(const stark::Field& f,
                                              const uint32_t (&a)[stark::NW],
                                              const uint32_t (&b)[stark::NW],
                                              uint32_t (&r)[stark::NW]) {
  uint32_t t[stark::NW + 1];
#pragma unroll
  for (int i = 0; i <= stark::NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) {
    mad_lo_row(t, a, b[i]);
    mad_hi_row(t, a, b[i]);
    const uint32_t m = t[0] * f.np;
    mad_lo_row(t, f.p, m);  // t[0] becomes 0
    mad_hi_row(t, f.p, m);
#pragma unroll
    for (int j = 0; j < stark::NW; ++j) t[j] = t[j + 1];
    t[stark::NW] = 0;
  }
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) r[i] = t[i];
}

// One butterfly of the fused pass, in place; a product by Montgomery one
// (a twiddle equal to f.one, tested by value) is its operand itself. The
// lazy build (5p < 2^256) keeps Harvey's bounds, the canonical build every
// value below p.
template <bool DIT, bool LAZY>
__device__ __forceinline__ void fused_butterfly(const stark::Field& f,
                                                const uint32_t (&p2)[stark::NW],
                                                uint32_t (&u)[stark::NW],
                                                uint32_t (&v)[stark::NW],
                                                const uint32_t (&w)[stark::NW]) {
  uint32_t t[stark::NW];
  if (!LAZY) {
    // a < p, b < p: the product's running sums stay below 2p * 2^32 and it
    // ends below 2p (2p < 2^256); sums and differences below 2p
    if (DIT) {
      if (is_one(f, w)) {
        stark::set_elem(t, v);
      } else {
        mont_mul_lazy(f, v, w, t);
        sub_if_ge(t, f.p);
      }
      add_diff(u, f.p, t, v);  // u + p - t < 2p
      sub_if_ge(v, f.p);
      add_words(u, t, u);
      sub_if_ge(u, f.p);
    } else {
      add_diff(u, f.p, v, t);  // u + p - v < 2p
      sub_if_ge(t, f.p);
      add_words(u, v, u);
      sub_if_ge(u, f.p);
      if (is_one(f, w)) {
        stark::set_elem(v, t);
      } else {
        mont_mul_lazy(f, t, w, v);
        sub_if_ge(v, f.p);
      }
    }
    return;
  }
  // Harvey's lazy butterflies: DIT keeps values in [0, 4p), DIF in [0, 2p)
  // (4p < 2^256); the last stage's outputs are reduced when they are stored
  if (DIT) {
    sub_if_ge(u, p2);  // u < 2p
    if (is_one(f, w)) {
      stark::set_elem(t, v);
      sub_if_ge(t, p2);
    } else {
      mont_mul_lazy(f, v, w, t);  // v < 4p, w < p: t < 2p
    }
    add_diff(u, p2, t, v);  // u + 2p - t < 4p
    add_words(u, t, u);     // u + t < 4p
  } else {
    add_diff(u, p2, v, t);  // u + 2p - v < 4p
    add_words(u, v, u);
    sub_if_ge(u, p2);  // u + v < 2p
    if (is_one(f, w)) {
      stark::set_elem(v, t);
      sub_if_ge(v, p2);
    } else {
      mont_mul_lazy(f, t, w, v);  // t < 4p: < 2p
    }
  }
}

// The canonical value of an element the fused pass leaves (< 4p after a
// lazy DIT, < 2p after a lazy DIF; already canonical in the canonical build).
template <bool DIT, bool LAZY>
__device__ __forceinline__ void fused_canonical(const stark::Field& f,
                                                const uint32_t (&p2)[stark::NW],
                                                uint32_t (&x)[stark::NW]) {
  if (!LAZY) return;
  if (DIT) sub_if_ge(x, p2);
  sub_if_ge(x, f.p);
}

// One round: stages s0 .. s0 + R - 1 (l = 2^s) on elements held in
// registers. A thread owns Q = FB_EPT / 2^R sets of 2^R elements, set p at
// i = hi * 2^(s0+R) + j * 2^s0 + lo (lo = p mod 2^s0, hi = p / 2^s0,
// j < 2^R): every butterfly of those stages pairs two elements of one set.
// i counts the h elements the CTA holds, which start at `lbase` in the
// planes. The round reads its elements from the exchange buffer `src` (or,
// when `from_global`, straight from the limb planes) and writes them to
// `dst` (or to the limb planes: only the round of the largest stride does,
// so a warp's accesses there are whole 128-byte rows).
template <bool DIT, bool LAZY, int R>
__device__ __forceinline__ void fused_round(
    const stark::Field& f, const uint32_t (&p2)[stark::NW], uint32_t (&x)[FB_EPT][stark::NW],
    const uint4* __restrict__ tws,
    const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
    const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t n, int64_t lbase,
    int h, int s0, bool from_global, bool to_global) {
  constexpr int E = 1 << R, Q = FB_EPT / E;
  const int L = 1 << s0, pairs = h >> R, nt = blockDim.x;
  int idx[Q][E];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + nt * q;
    const int lo = p & (L - 1), hi = p >> s0;
#pragma unroll
    for (int j = 0; j < E; ++j) idx[q][j] = (hi << (s0 + R)) + j * L + lo;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (threadIdx.x + nt * q >= pairs) continue;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (from_global) {
        stark::load_elem(a, n, lbase + idx[q][j], x[q * E + j]);
      } else {
        const int c = fb_col(idx[q][j]);
#pragma unroll
        for (int w = 0; w < stark::NW; ++w) x[q * E + j][w] = src[w * h + c];
      }
    }
  }
#pragma unroll
  for (int st = 0; st < R; ++st) {
    const int r = DIT ? st : R - 1 - st;  // DIT: l ascending; DIF: descending
    const int l = L << r;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int p = threadIdx.x + nt * q;
      if (p >= pairs) continue;
      const int lo = p & (L - 1);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j & (1 << r)) continue;
        uint32_t(&u)[stark::NW] = x[q * E + j];
        uint32_t(&v)[stark::NW] = x[q * E + j + (1 << r)];
        const int k = (j & ((1 << r) - 1)) * L + lo;
        const uint4 t0 = tws[2 * (l - 1 + k)], t1 = tws[2 * (l - 1 + k) + 1];
        const uint32_t w[stark::NW] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
        fused_butterfly<DIT, LAZY>(f, p2, u, v, w);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (threadIdx.x + nt * q >= pairs) continue;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (to_global) {
        fused_canonical<DIT, LAZY>(f, p2, x[q * E + j]);
        stark::store_elem(out, n, lbase + idx[q][j], x[q * E + j]);
      } else {
        const int c = fb_col(idx[q][j]);
#pragma unroll
        for (int w = 0; w < stark::NW; ++w) dst[w * h + c] = x[q * E + j][w];
      }
    }
  }
}

// The stage of stride h when a pair of CTAs shares a block of 2h: element
// i < h lives in rank 0's exchange buffer, i + h in rank 1's, both at
// column fb_col(i), and CTA `rank` takes the butterflies k = rank * h/2 + p.
// DIF runs it first, from the planes into both ranks' buffers `bufs`
// (distributed shared memory); DIT runs it last, from `bufs` into the
// planes. Its twiddles are read from tw_cat (in L2), not staged.
template <bool DIT, bool LAZY>
__device__ __forceinline__ void cross_round(
    const stark::Field& f, const uint32_t (&p2)[stark::NW], uint32_t (&x)[FB_EPT][stark::NW],
    const int32_t* __restrict__ tw_cat, uint32_t* const (&bufs)[2],
    const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t n, int64_t base, int h,
    int rank) {
  constexpr int Q = FB_EPT / 2;
  const int nt = blockDim.x, pairs = h >> 1;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + nt * q;
    if (p >= pairs) continue;
    const int k = rank * pairs + p, c = fb_col(k);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (DIT) {
#pragma unroll
        for (int w = 0; w < stark::NW; ++w) x[2 * q + j][w] = bufs[j][w * h + c];
      } else {
        stark::load_elem(a, n, base + j * h + k, x[2 * q + j]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + nt * q;
    if (p >= pairs) continue;
    uint32_t w[stark::NW];
    stark::load_elem(tw_cat, 2 * h - 1, h - 1 + rank * pairs + p, w);
    fused_butterfly<DIT, LAZY>(f, p2, x[2 * q], x[2 * q + 1], w);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + nt * q;
    if (p >= pairs) continue;
    const int k = rank * pairs + p, c = fb_col(k);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (DIT) {
        fused_canonical<DIT, LAZY>(f, p2, x[2 * q + j]);
        stark::store_elem(out, n, base + j * h + k, x[2 * q + j]);
      } else {
#pragma unroll
        for (int w = 0; w < stark::NW; ++w) bufs[j][w * h + c] = x[2 * q + j][w];
      }
    }
  }
}

// A barrier of the block's CTAs: the cluster's when a pair shares a block,
// which also orders their distributed shared memory accesses.
__device__ __forceinline__ void block_sync(int cs) {
  if (cs > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Persistent: each CTA stages the twiddles of its stages once, then walks
// blocks. A block belongs to a cluster of two CTAs (cs = 2), each holding
// half of it, h = block / cs elements, or, for a block of 2, to one CTA
// (cs = 1); clusters walk blocks c, c + clusters, ... Two exchange buffers,
// so one __syncthreads a round suffices. DIT's first round pairs neighbours
// and DIF's last writes them, so that side of the block passes through
// shared memory in a separate coalesced copy (element i to thread i mod
// threads). (For a block of 2 the one round is both first and last, and DIF
// reads the planes there with stride 1: correct, merely uncoalesced.)
template <bool DIT, bool LAZY>
__global__ void __launch_bounds__(FB_THREADS, 1)
butterfly_fused_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ tw_cat,
                       int32_t* __restrict__ out, int64_t n, int log_block, int cs,
                       stark::Field f) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int block = 1 << log_block, h = block / cs, ntw = h - 1, nt = blockDim.x;
  const int rank = cs > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  uint32_t p2[stark::NW];  // 2p, the lazy butterflies' bound
#pragma unroll
  for (int i = 0; i < stark::NW; ++i)
    p2[i] = (f.p[i] << 1) | (i > 0 ? f.p[i - 1] >> 31 : 0u);
  uint32_t* const xs = sm;  // two exchange buffers of [NW][h] words
  uint4* tws = reinterpret_cast<uint4*>(sm + 2 * stark::NW * h);  // 2 x 16 bytes each
  for (int k = threadIdx.x; k < ntw; k += nt) {  // the stages below stride h
    uint32_t w[stark::NW];
    stark::load_elem(tw_cat, block - 1, k, w);
    tws[2 * k] = make_uint4(w[0], w[1], w[2], w[3]);
    tws[2 * k + 1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
  // rounds in l-ascending order: of two stages each on the CTA's own h
  // elements, the last a single stage when log2(h) is odd, then, for a
  // pair, the stage of stride h (DIT runs them in this order, DIF in
  // reverse)
  const int log_h = log_block - (cs > 1), nl = (log_h + 1) / 2, nr = nl + (cs > 1);
  const int64_t nblocks = n >> log_block;
  for (int64_t blk = blockIdx.x / cs; blk < nblocks; blk += gridDim.x / cs) {
    const int64_t base = blk << log_block, lbase = base + static_cast<int64_t>(rank) * h;
    uint32_t x[FB_EPT][stark::NW];
    // the twiddles are staged; the last block's buffers are free, the
    // partner's reads and writes of them included
    block_sync(cs);
    int cur = 0;
    if (DIT) {
      for (int i = threadIdx.x; i < h; i += nt) {
        uint32_t w[stark::NW];
        stark::load_elem(a, n, lbase + i, w);
        const int c = fb_col(i);
#pragma unroll
        for (int q = 0; q < stark::NW; ++q) xs[q * h + c] = w[q];
      }
      __syncthreads();
    }
    for (int rr = 0; rr < nr; ++rr) {
      const int ri = DIT ? rr : nr - 1 - rr;  // index in l-ascending order
      if (ri == nl) {  // the pair's stage of stride h
        cg::cluster_group cluster = cg::this_cluster();
        const int buf = DIT ? cur : cur ^ 1;
        uint32_t* const bufs[2] = {
            cluster.map_shared_rank(xs + buf * stark::NW * h, 0),
            cluster.map_shared_rank(xs + buf * stark::NW * h, 1)};
        if (DIT) block_sync(cs);  // the partner's half is in its buffer
        cross_round<DIT, LAZY>(f, p2, x, tw_cat, bufs, a, out, n, base, h, rank);
        if (!DIT) {
          block_sync(cs);
          cur ^= 1;
        }
        continue;
      }
      const int R = ri == nl - 1 && (log_h & 1) ? 1 : 2, s0 = 2 * ri;
      const bool from_global = !DIT && rr == 0, to_global = DIT && rr == nr - 1;
      const uint32_t* src = xs + cur * stark::NW * h;
      uint32_t* dst = xs + (cur ^ 1) * stark::NW * h;
      if (R == 2)
        fused_round<DIT, LAZY, 2>(f, p2, x, tws, src, dst, a, out, n, lbase, h, s0, from_global,
                            to_global);
      else
        fused_round<DIT, LAZY, 1>(f, p2, x, tws, src, dst, a, out, n, lbase, h, s0, from_global,
                            to_global);
      if (!to_global) {
        __syncthreads();
        cur ^= 1;
      }
    }
    if (!DIT) {
      for (int i = threadIdx.x; i < h; i += nt) {
        uint32_t w[stark::NW];
        const int c = fb_col(i);
#pragma unroll
        for (int q = 0; q < stark::NW; ++q) w[q] = xs[cur * stark::NW * h + q * h + c];
        fused_canonical<DIT, LAZY>(f, p2, w);
        stark::store_elem(out, n, lbase + i, w);
      }
    }
  }
  block_sync(cs);  // no CTA leaves while its partner may read its buffers
}

// A pass of R consecutive outer stages, l = l0 .. l0 2^(R-1) (see the header).
// The groups are the 2^R elements base + j l0 (j < 2^R, base = g 2^R l0 + k,
// k < l0). A CTA holds a tile of the 2^R rows j of one g at K = min(l0,
// PASS_TILE / 2^R) consecutive k, k0 .. k0 + K - 1, in shared memory, word
// major (an element's word q at xs[q][j K + c]); E K / 2 threads load two
// neighbouring elements each (8-byte loads from each limb plane), run one
// butterfly each a stage between __syncthreads, and store two each. Stage s
// (l = l0 2^s) pairs row j with j + 2^s, twiddle tw_l[k + (j mod 2^s) l0]:
// entry (k + (j mod 2^s) l0) 2^(R-1-s) of the largest stage's table `tw`,
// packed as 8 words (two 16-byte loads). DIT runs s ascending, DIF
// descending.
template <bool DIT, bool LAZY, int R>
__global__ void __launch_bounds__(PASS_TILE / 2)
butterfly_pass_kernel(const int32_t* __restrict__ a, const uint4* __restrict__ tw,
                      int32_t* __restrict__ out, int64_t n, int log_l0, int log_k,
                      stark::Field f) {
  __shared__ __align__(16) uint32_t xs[stark::NW][PASS_TILE];
  const int K = 1 << log_k;
  const int64_t l0 = int64_t(1) << log_l0;
  const int64_t k0 = (static_cast<int64_t>(blockIdx.x) << log_k) & (l0 - 1);
  const int64_t g = static_cast<int64_t>(blockIdx.x) >> (log_l0 - log_k);
  const int64_t base = (g << (log_l0 + R)) + k0;
  uint32_t p2[stark::NW];  // 2p, the lazy butterflies' bound
#pragma unroll
  for (int i = 0; i < stark::NW; ++i)
    p2[i] = (f.p[i] << 1) | (i > 0 ? f.p[i - 1] >> 31 : 0u);
  // tile elements e and e + 1 lie side by side in the planes: K is even, or
  // K = l0 and the tile is one contiguous run
  const int e = 2 * threadIdx.x;
  const int64_t col = base + (e >> log_k) * l0 + (e & (K - 1));
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) {
    const int2 lo = *reinterpret_cast<const int2*>(a + 2 * i * n + col);
    const int2 hi = *reinterpret_cast<const int2*>(a + (2 * i + 1) * n + col);
    *reinterpret_cast<uint2*>(&xs[i][e]) =
        make_uint2((static_cast<uint32_t>(lo.x) & 0xFFFFu) | (static_cast<uint32_t>(hi.x) << 16),
                   (static_cast<uint32_t>(lo.y) & 0xFFFFu) | (static_cast<uint32_t>(hi.y) << 16));
  }
  __syncthreads();
  const int c = threadIdx.x & (K - 1), jj = threadIdx.x >> log_k;
#pragma unroll
  for (int st = 0; st < R; ++st) {
    const int s = DIT ? st : R - 1 - st;
    const int j = ((jj >> s) << (s + 1)) | (jj & ((1 << s) - 1));  // bit s clear
    const int iu = j * K + c, iv = iu + (K << s);
    uint32_t u[stark::NW], v[stark::NW];
#pragma unroll
    for (int q = 0; q < stark::NW; ++q) {
      u[q] = xs[q][iu];
      v[q] = xs[q][iv];
    }
    const int64_t ti = (k0 + c + (j & ((1 << s) - 1)) * l0) << (R - 1 - s);
    const uint4 t0 = tw[2 * ti], t1 = tw[2 * ti + 1];
    const uint32_t w[stark::NW] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
    fused_butterfly<DIT, LAZY>(f, p2, u, v, w);
#pragma unroll
    for (int q = 0; q < stark::NW; ++q) {
      xs[q][iu] = u[q];
      xs[q][iv] = v[q];
    }
    __syncthreads();
  }
  uint32_t y0[stark::NW], y1[stark::NW];
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) {
    const uint2 x = *reinterpret_cast<const uint2*>(&xs[i][e]);
    y0[i] = x.x;
    y1[i] = x.y;
  }
  fused_canonical<DIT, LAZY>(f, p2, y0);
  fused_canonical<DIT, LAZY>(f, p2, y1);
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) {
    *reinterpret_cast<int2*>(out + 2 * i * n + col) =
        make_int2(static_cast<int32_t>(y0[i] & 0xFFFFu), static_cast<int32_t>(y1[i] & 0xFFFFu));
    *reinterpret_cast<int2*>(out + (2 * i + 1) * n + col) =
        make_int2(static_cast<int32_t>(y0[i] >> 16), static_cast<int32_t>(y1[i] >> 16));
  }
}

// --- the Shoup-twiddle form -------------------------------------------------

// r = a + b over 8 words; returns the carry out of bit 256
__device__ __forceinline__ uint32_t add_words_carry(const uint32_t (&a)[stark::NW],
                                                    const uint32_t (&b)[stark::NW],
                                                    uint32_t (&r)[stark::NW]) {
  uint32_t s[stark::NW], carry;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]),
        "=r"(s[6]), "=r"(s[7]), "=r"(carry)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) r[i] = s[i];
  return carry;
}

// s (with `carry` as bit 256) less 2p where it reaches 2p; s < 4p
__device__ __forceinline__ void reduce_2p(const uint32_t (&p2)[stark::NW], uint32_t carry,
                                          uint32_t (&s)[stark::NW]) {
  uint32_t d[stark::NW];
  const uint32_t borrow = sub_words(s, p2, d);
  const bool ge = carry != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) s[i] = ge ? d[i] : s[i];
}

// A Shoup twiddle as 8 words of w and 8 of its companion wp
struct TwWords {
  uint32_t w[stark::NW], wp[stark::NW];
};

// field.cuh's shoup_mul as a butterfly's product
struct ShoupMul {
  const stark::Field& f;
  __device__ __forceinline__ void operator()(const TwWords& t, const uint32_t (&x)[stark::NW],
                                             uint32_t (&r)[stark::NW]) const {
    stark::shoup_mul(f, t.w, t.wp, x, r);
  }
};

// One Shoup butterfly in place, u, v in [0, 2p), tw a plain twiddle w < p
// with its companion wp (_butterfly_pair_shoup): dif: u + v, (u - v) w;
// dit: t = v w, u + t, u - t; each sum a + b and difference a + 2p - b less
// 2p where it reaches 2p, each product mul(tw, x) below 2p; with CANON both
// outputs below p.
template <bool DIT, class Mul, class Tw>
__device__ __forceinline__ void shoup_butterfly(const stark::Field& f, const Mul& mul,
                                                const uint32_t (&p2)[stark::NW],
                                                uint32_t (&u)[stark::NW],
                                                uint32_t (&v)[stark::NW], const Tw& tw,
                                                bool canon) {
  uint32_t t[stark::NW], d[stark::NW];
  if (DIT) {
    mul(tw, v, t);
    sub_words(p2, t, d);  // 2p - t > 0
    reduce_2p(p2, add_words_carry(u, d, v), v);
    reduce_2p(p2, add_words_carry(u, t, u), u);
  } else {
    sub_words(p2, v, d);  // 2p - v > 0
    reduce_2p(p2, add_words_carry(u, d, t), t);
    reduce_2p(p2, add_words_carry(u, v, u), u);
    mul(tw, t, v);
  }
  if (canon) {
    sub_if_ge(u, f.p);
    sub_if_ge(v, f.p);
  }
}

__device__ __forceinline__ void load_shoup_tw(const uint4* __restrict__ tw, int64_t e,
                                              uint32_t (&w)[stark::NW],
                                              uint32_t (&wp)[stark::NW]) {
  const uint4 t0 = tw[4 * e], t1 = tw[4 * e + 1], t2 = tw[4 * e + 2], t3 = tw[4 * e + 3];
  w[0] = t0.x; w[1] = t0.y; w[2] = t0.z; w[3] = t0.w;
  w[4] = t1.x; w[5] = t1.y; w[6] = t1.z; w[7] = t1.w;
  wp[0] = t2.x; wp[1] = t2.y; wp[2] = t2.z; wp[3] = t2.w;
  wp[4] = t3.x; wp[5] = t3.y; wp[6] = t3.z; wp[7] = t3.w;
}

// butterfly_pass_kernel's tile and index map with Shoup butterflies; tw is
// the largest stage's table, l0 2^(R-1) entries of 16 words (w, then its
// companion). With canon, the last stage's outputs are reduced below p.
template <bool DIT, int R>
__global__ void __launch_bounds__(PASS_TILE / 2)
butterfly_pass_shoup_kernel(const int32_t* __restrict__ a, const uint4* __restrict__ tw,
                            int32_t* __restrict__ out, int64_t n, int log_l0, int log_k,
                            int canon, stark::Field f) {
  __shared__ __align__(16) uint32_t xs[stark::NW][PASS_TILE];
  const int K = 1 << log_k;
  const int64_t l0 = int64_t(1) << log_l0;
  const int64_t k0 = (static_cast<int64_t>(blockIdx.x) << log_k) & (l0 - 1);
  const int64_t g = static_cast<int64_t>(blockIdx.x) >> (log_l0 - log_k);
  const int64_t base = (g << (log_l0 + R)) + k0;
  uint32_t p2[stark::NW];  // 2p
#pragma unroll
  for (int i = 0; i < stark::NW; ++i)
    p2[i] = (f.p[i] << 1) | (i > 0 ? f.p[i - 1] >> 31 : 0u);
  const int e = 2 * threadIdx.x;
  const int64_t col = base + (e >> log_k) * l0 + (e & (K - 1));
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) {
    const int2 lo = *reinterpret_cast<const int2*>(a + 2 * i * n + col);
    const int2 hi = *reinterpret_cast<const int2*>(a + (2 * i + 1) * n + col);
    *reinterpret_cast<uint2*>(&xs[i][e]) =
        make_uint2((static_cast<uint32_t>(lo.x) & 0xFFFFu) | (static_cast<uint32_t>(hi.x) << 16),
                   (static_cast<uint32_t>(lo.y) & 0xFFFFu) | (static_cast<uint32_t>(hi.y) << 16));
  }
  __syncthreads();
  const int c = threadIdx.x & (K - 1), jj = threadIdx.x >> log_k;
#pragma unroll
  for (int st = 0; st < R; ++st) {
    const int s = DIT ? st : R - 1 - st;
    const int j = ((jj >> s) << (s + 1)) | (jj & ((1 << s) - 1));  // bit s clear
    const int iu = j * K + c, iv = iu + (K << s);
    uint32_t u[stark::NW], v[stark::NW];
    TwWords t;
#pragma unroll
    for (int q = 0; q < stark::NW; ++q) {
      u[q] = xs[q][iu];
      v[q] = xs[q][iv];
    }
    load_shoup_tw(tw, (k0 + c + (j & ((1 << s) - 1)) * l0) << (R - 1 - s), t.w, t.wp);
    shoup_butterfly<DIT>(f, ShoupMul{f}, p2, u, v, t, canon && st == R - 1);
#pragma unroll
    for (int q = 0; q < stark::NW; ++q) {
      xs[q][iu] = u[q];
      xs[q][iv] = v[q];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) {
    const uint2 x = *reinterpret_cast<const uint2*>(&xs[i][e]);
    *reinterpret_cast<int2*>(out + 2 * i * n + col) =
        make_int2(static_cast<int32_t>(x.x & 0xFFFFu), static_cast<int32_t>(x.y & 0xFFFFu));
    *reinterpret_cast<int2*>(out + (2 * i + 1) * n + col) =
        make_int2(static_cast<int32_t>(x.x >> 16), static_cast<int32_t>(x.y >> 16));
  }
}

// --- the fused Shoup run in row 3's design --------------------------------

// The radix-2^29 form of a Shoup twiddle: w and wp as 9 limbs of 29 bits
struct Tw29 {
  uint32_t w[stark::NL29], wp[stark::NL29];
};

// The twiddle 1's constants and p's, computed on the host (`shoup_one`):
// the companion of 1, wp1 = floor(2^256 / p), in words and in 29-bit limbs;
// c1 = ceil(2^256 / wp1): for x < 2p the quotient floor(wp1 x / 2^256) is 1
// where x >= c1 and 0 below, so the product by 1 is x - p or x; and
// 2^261 - p in 29-bit limbs.
struct ShoupOne {
  uint32_t wp[stark::NW];
  uint32_t c1[stark::NW];
  uint32_t wp29[stark::NL29];
  uint32_t pn29[stark::NL29];
};

// Whether a twiddle is 1 with its companion (by value)
__device__ __forceinline__ bool is_shoup_one(const ShoupOne& one, const Tw29& t) {
  bool eq = t.w[0] == 1u && t.wp[0] == one.wp29[0];
#pragma unroll
  for (int i = 1; i < stark::NL29; ++i) eq &= t.w[i] == 0u && t.wp[i] == one.wp29[i];
  return eq;
}

// The Shoup product by 1 for x < 2p, the exact value without a product
__device__ __forceinline__ void shoup_mul_one(const stark::Field& f, const ShoupOne& one,
                                              const uint32_t (&x)[stark::NW],
                                              uint32_t (&r)[stark::NW]) {
  uint32_t c[stark::NW], d[stark::NW];
  const uint32_t below = sub_words(x, one.c1, c);
  sub_words(x, f.p, d);
#pragma unroll
  for (int i = 0; i < stark::NW; ++i) r[i] = below ? x[i] : d[i];
}

// field.cuh's shoup_mul in the radix-2^29 form, the same value: the 17
// columns of wp x (one IMAD.WIDE a limb product, each column below 9 2^58)
// normalised into limbs L, q = floor(wp x / 2^256) their bits from 256
// (q_m = L[8+m] >> 24 | L[9+m] << 5, 29 bits), then the 9 low columns of
// w x + q (2^261 - p) (each below 18 2^58) normalised: that is
// w x - q p mod 2^261, and w x - q p < 2p < 2^256.
__device__ __forceinline__ void shoup_mul29(const ShoupOne& one, const Tw29& t,
                                            const uint32_t (&x)[stark::NW],
                                            uint32_t (&r)[stark::NW]) {
  uint32_t xl[stark::NL29], q[stark::NL29], rl[stark::NL29], L[stark::COLS29 + 1];
  stark::to_limbs29(x, xl);
  uint64_t c[stark::COLS29];
  stark::clear29(c);
  stark::mac29(c, t.wp, xl);
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < stark::COLS29 - 1; ++k) {
    const uint64_t v = c[k] + carry;
    L[k] = static_cast<uint32_t>(v) & stark::MASK29;
    carry = v >> 29;
  }
  L[stark::COLS29 - 1] = static_cast<uint32_t>(carry);  // below 2^19
  L[stark::COLS29] = 0;
#pragma unroll
  for (int m = 0; m < stark::NL29; ++m)
    q[m] = ((L[8 + m] >> 24) | (L[9 + m] << 5)) & stark::MASK29;
  uint64_t d[stark::NL29];
#pragma unroll
  for (int k = 0; k < stark::NL29; ++k) d[k] = 0;
#pragma unroll
  for (int i = 0; i < stark::NL29; ++i)
#pragma unroll
    for (int j = 0; i + j < stark::NL29; ++j)
      d[i + j] += static_cast<uint64_t>(t.w[i]) * xl[j] +
                  static_cast<uint64_t>(q[i]) * one.pn29[j];
  carry = 0;
#pragma unroll
  for (int k = 0; k < stark::NL29; ++k) {
    const uint64_t v = d[k] + carry;
    rl[k] = static_cast<uint32_t>(v) & stark::MASK29;
    carry = v >> 29;
  }
  stark::from_limbs29(rl, r);
}

// How a product takes its twiddles (the kernel's Mul::Layout): a table row
// is w's 8 words then wp's (4 vectors of 16 bytes); `stage` turns it into
// the VECS vectors a staged entry holds, `unpack` those into the product's
// twiddle. The radix-2^29 layout: w's and wp's 9 limbs, 2 words of padding.
struct Limbs29Layout {
  using Tw = Tw29;
  static constexpr int VECS = 5;
  __device__ static void stage(const uint4* __restrict__ row, uint4 (&v)[VECS]) {
    uint32_t t[2 * stark::NW], s[4 * VECS];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 r = row[c];
      t[4 * c] = r.x; t[4 * c + 1] = r.y; t[4 * c + 2] = r.z; t[4 * c + 3] = r.w;
    }
    stark::to_limbs29(t, s);
    stark::to_limbs29(t + stark::NW, s + stark::NL29);
    s[2 * stark::NL29] = s[2 * stark::NL29 + 1] = 0;
#pragma unroll
    for (int c = 0; c < VECS; ++c)
      v[c] = make_uint4(s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3]);
  }
  __device__ static Tw unpack(const uint4 (&v)[VECS]) {
    Tw t;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(v);
#pragma unroll
    for (int i = 0; i < stark::NL29; ++i) {
      t.w[i] = s[i];
      t.wp[i] = s[stark::NL29 + i];
    }
    return t;
  }
};

// The fused run's product (the kernel's Mul): the radix-2^29 form
// (scripts/ntt_kernels_cuda.py builds the kernel with the word form's
// products in its place)
struct ShoupMul29 {
  using Layout = Limbs29Layout;
  const stark::Field& f;
  const ShoupOne& one;
  __device__ __forceinline__ void operator()(const Tw29& t, const uint32_t (&x)[stark::NW],
                                             uint32_t (&r)[stark::NW]) const {
    shoup_mul29(one, t, x, r);
  }
};

// A product that takes the twiddle 1 (tested by value) without a product,
// `shoup_mul_one`. The kernel uses it in the round of l = 1, 2 alone, where
// every lane of a warp reads the same twiddles, so a warp skips whole
// products (all of l = 1, half of l = 2): elsewhere a lane or none would
// skip, and the branch would keep the compiler from overlapping a thread's
// two butterflies.
template <class Mul>
struct SkipOne {
  using Layout = typename Mul::Layout;
  const Mul& mul;
  __device__ __forceinline__ void operator()(const typename Layout::Tw& t,
                                             const uint32_t (&x)[stark::NW],
                                             uint32_t (&r)[stark::NW]) const {
    if (is_shoup_one(mul.one, t))
      shoup_mul_one(mul.f, mul.one, x, r);
    else
      mul(t, x, r);
  }
};

// Entry e of the staged table: VECS planes of 16-byte vectors, vector c of
// entry e at c ls + tw_pos(e). tw_pos XORs bits 3-5 and 6-8 of e into its
// low three, so that 8 entries e = k s (8 consecutive k from a multiple of
// 8, s = 2^a) lie in 8 distinct 16-byte bank groups: each quarter-warp's
// loads of a stage are free of conflicts.
__device__ __forceinline__ int tw_pos(int e) { return e ^ (((e >> 3) ^ (e >> 6)) & 7); }

template <class Layout>
__device__ __forceinline__ typename Layout::Tw load_staged(const uint4* __restrict__ tws, int ls,
                                                           int e) {
  const int pos = tw_pos(e);
  uint4 v[Layout::VECS];
#pragma unroll
  for (int c = 0; c < Layout::VECS; ++c) v[c] = tws[c * ls + pos];
  return Layout::unpack(v);
}

// fused_round with Shoup butterflies: the same sets of elements, exchange
// buffers and columns. Stage l = 2^s reads tw_l[k] = tw_ls[k ls / l], entry
// k 2^(log_ls - s) of the staged table of stage ls = 2^log_ls. With canon
// the round's last stage reduces its outputs below p; the round that writes
// the planes stores its values as they are.
template <bool DIT, int R, class Mul>
__device__ __forceinline__ void shoup_round(
    const stark::Field& f, const Mul& mul, const uint32_t (&p2)[stark::NW],
    uint32_t (&x)[FB_EPT][stark::NW], const uint4* __restrict__ tws, int log_ls,
    const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
    const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t n, int64_t lbase,
    int h, int s0, bool from_global, bool to_global, bool canon) {
  constexpr int E = 1 << R, Q = FB_EPT / E;
  const int L = 1 << s0, pairs = h >> R, nt = blockDim.x;
  int idx[Q][E];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + nt * q;
    const int lo = p & (L - 1), hi = p >> s0;
#pragma unroll
    for (int j = 0; j < E; ++j) idx[q][j] = (hi << (s0 + R)) + j * L + lo;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (threadIdx.x + nt * q >= pairs) continue;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (from_global) {
        stark::load_elem(a, n, lbase + idx[q][j], x[q * E + j]);
      } else {
        const int c = fb_col(idx[q][j]);
#pragma unroll
        for (int w = 0; w < stark::NW; ++w) x[q * E + j][w] = src[w * h + c];
      }
    }
  }
#pragma unroll
  for (int st = 0; st < R; ++st) {
    const int r = DIT ? st : R - 1 - st;  // DIT: l ascending; DIF: descending
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int p = threadIdx.x + nt * q;
      if (p >= pairs) continue;
      const int lo = p & (L - 1);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j & (1 << r)) continue;
        const int k = (j & ((1 << r) - 1)) * L + lo;
        const auto t = load_staged<typename Mul::Layout>(tws, 1 << log_ls,
                                                         k << (log_ls - s0 - r));
        shoup_butterfly<DIT>(f, mul, p2, x[q * E + j], x[q * E + j + (1 << r)], t,
                             canon && st == R - 1);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (threadIdx.x + nt * q >= pairs) continue;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (to_global) {
        stark::store_elem(out, n, lbase + idx[q][j], x[q * E + j]);
      } else {
        const int c = fb_col(idx[q][j]);
#pragma unroll
        for (int w = 0; w < stark::NW; ++w) dst[w * h + c] = x[q * E + j][w];
      }
    }
  }
}

// cross_round with Shoup butterflies: the stage of stride h across the pair
// of CTAs, its twiddles tw_h[k] read from rows h - 1 + k of the table (in
// L2); with canon its outputs below p.
template <bool DIT, class Mul>
__device__ __forceinline__ void shoup_cross_round(
    const stark::Field& f, const Mul& mul, const uint32_t (&p2)[stark::NW],
    uint32_t (&x)[FB_EPT][stark::NW], const uint4* __restrict__ tw,
    uint32_t* const (&bufs)[2], const int32_t* __restrict__ a, int32_t* __restrict__ out,
    int64_t n, int64_t base, int h, int rank, bool canon) {
  constexpr int Q = FB_EPT / 2;
  const int nt = blockDim.x, pairs = h >> 1;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + nt * q;
    if (p >= pairs) continue;
    const int k = rank * pairs + p, c = fb_col(k);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (DIT) {
#pragma unroll
        for (int w = 0; w < stark::NW; ++w) x[2 * q + j][w] = bufs[j][w * h + c];
      } else {
        stark::load_elem(a, n, base + j * h + k, x[2 * q + j]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + nt * q;
    if (p >= pairs) continue;
    using Layout = typename Mul::Layout;
    uint4 v[Layout::VECS];
    Layout::stage(tw + 4 * (h - 1 + rank * pairs + p), v);
    shoup_butterfly<DIT>(f, mul, p2, x[2 * q], x[2 * q + 1], Layout::unpack(v), canon);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + nt * q;
    if (p >= pairs) continue;
    const int k = rank * pairs + p, c = fb_col(k);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (DIT) {
        stark::store_elem(out, n, base + j * h + k, x[2 * q + j]);
      } else {
#pragma unroll
        for (int w = 0; w < stark::NW; ++w) bufs[j][w * h + c] = x[2 * q + j][w];
      }
    }
  }
}

// butterfly_fused_kernel's schedule with Shoup butterflies (see the
// header): persistent clusters of two CTAs a block (one CTA for a block of
// 2), each CTA's h = block / cs elements in two exchange buffers, and the
// table of stage ls = h / 2, the largest below stride h (rows ls - 1 ..
// 2 ls - 2 of the (block - 1, 16) table), staged once, every smaller stage
// a stride of it. With canon the last stage in execution order reduces
// below p (DIT's stride-h round, or DIF's round of l = 1, 2).
template <bool DIT, class Mul>
__global__ void __launch_bounds__(FB_THREADS, 1)
butterfly_fused_shoup_kernel(const int32_t* __restrict__ a, const uint4* __restrict__ tw,
                             int32_t* __restrict__ out, int64_t n, int log_block, int cs,
                             int canon, stark::Field f, ShoupOne one) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int block = 1 << log_block, h = block / cs, ls = h / 2, nt = blockDim.x;
  const int log_h = log_block - (cs > 1), log_ls = log_h - 1;
  const int rank = cs > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const Mul mul{f, one};
  uint32_t p2[stark::NW];  // 2p
#pragma unroll
  for (int i = 0; i < stark::NW; ++i)
    p2[i] = (f.p[i] << 1) | (i > 0 ? f.p[i - 1] >> 31 : 0u);
  uint32_t* const xs = sm;  // two exchange buffers of [NW][h] words
  using Layout = typename Mul::Layout;
  uint4* const tws = reinterpret_cast<uint4*>(sm + 2 * stark::NW * h);  // [VECS][ls]
  for (int e = threadIdx.x; e < ls; e += nt) {
    uint4 v[Layout::VECS];
    Layout::stage(tw + 4 * (ls - 1 + e), v);
    const int pos = tw_pos(e);
#pragma unroll
    for (int c = 0; c < Layout::VECS; ++c) tws[c * ls + pos] = v[c];
  }
  // rounds in l-ascending order, as butterfly_fused_kernel's
  const int nl = (log_h + 1) / 2, nr = nl + (cs > 1);
  const int64_t nblocks = n >> log_block;
  for (int64_t blk = blockIdx.x / cs; blk < nblocks; blk += gridDim.x / cs) {
    const int64_t base = blk << log_block, lbase = base + static_cast<int64_t>(rank) * h;
    uint32_t x[FB_EPT][stark::NW];
    block_sync(cs);  // the table is staged; the last block's buffers are free
    int cur = 0;
    if (DIT) {
      for (int i = threadIdx.x; i < h; i += nt) {
        uint32_t w[stark::NW];
        stark::load_elem(a, n, lbase + i, w);
        const int c = fb_col(i);
#pragma unroll
        for (int q = 0; q < stark::NW; ++q) xs[q * h + c] = w[q];
      }
      __syncthreads();
    }
    for (int rr = 0; rr < nr; ++rr) {
      const int ri = DIT ? rr : nr - 1 - rr;  // index in l-ascending order
      const bool last = canon && rr == nr - 1;
      if (ri == nl) {  // the pair's stage of stride h
        cg::cluster_group cluster = cg::this_cluster();
        const int buf = DIT ? cur : cur ^ 1;
        uint32_t* const bufs[2] = {
            cluster.map_shared_rank(xs + buf * stark::NW * h, 0),
            cluster.map_shared_rank(xs + buf * stark::NW * h, 1)};
        if (DIT) block_sync(cs);  // the partner's half is in its buffer
        shoup_cross_round<DIT>(f, mul, p2, x, tw, bufs, a, out, n, base, h, rank, last);
        if (!DIT) {
          block_sync(cs);
          cur ^= 1;
        }
        continue;
      }
      const int R = ri == nl - 1 && (log_h & 1) ? 1 : 2, s0 = 2 * ri;
      const bool from_global = !DIT && rr == 0, to_global = DIT && rr == nr - 1;
      const uint32_t* src = xs + cur * stark::NW * h;
      uint32_t* dst = xs + (cur ^ 1) * stark::NW * h;
      if (R == 2 && s0 == 0)
        shoup_round<DIT, 2>(f, SkipOne<Mul>{mul}, p2, x, tws, log_ls, src, dst, a, out, n,
                            lbase, h, s0, from_global, to_global, last);
      else if (R == 2)
        shoup_round<DIT, 2>(f, mul, p2, x, tws, log_ls, src, dst, a, out, n, lbase, h, s0,
                            from_global, to_global, last);
      else
        shoup_round<DIT, 1>(f, mul, p2, x, tws, log_ls, src, dst, a, out, n, lbase, h, s0,
                            from_global, to_global, last);
      if (!to_global) {
        __syncthreads();
        cur ^= 1;
      }
    }
    if (!DIT) {
      for (int i = threadIdx.x; i < h; i += nt) {
        uint32_t w[stark::NW];
        const int c = fb_col(i);
#pragma unroll
        for (int q = 0; q < stark::NW; ++q) w[q] = xs[cur * stark::NW * h + q * h + c];
        stark::store_elem(out, n, lbase + i, w);
      }
    }
  }
  block_sync(cs);  // no CTA leaves while its partner may read its buffers
}

// floor(2^256 / d) for 2 <= d < 2^256, bit by bit (host); returns whether
// the division left a remainder
inline bool div_pow2_256(const uint32_t (&d)[stark::NW], uint32_t (&q)[stark::NW]) {
  uint64_t r[stark::NW + 1] = {};  // the remainder, below 2d < 2^257, 32 bits a word
  for (int i = 0; i < stark::NW; ++i) q[i] = 0;
  for (int b = 256; b >= 0; --b) {
    uint64_t c = b == 256;  // r = 2r + bit b of 2^256
    for (int i = 0; i <= stark::NW; ++i) {
      const uint64_t v = ((r[i] << 1) | c) & 0xFFFFFFFFu;
      c = r[i] >> 31;
      r[i] = v;
    }
    bool ge = r[stark::NW] != 0;  // r >= d
    if (!ge) {
      ge = true;
      for (int i = stark::NW - 1; i >= 0; --i) {
        if (r[i] != d[i]) {
          ge = r[i] > d[i];
          break;
        }
      }
    }
    if (!ge) continue;
    uint64_t borrow = 0;
    for (int i = 0; i <= stark::NW; ++i) {
      const uint64_t s = r[i] - (i < stark::NW ? d[i] : 0) - borrow;
      r[i] = s & 0xFFFFFFFFu;
      borrow = (s >> 32) & 1u;
    }
    q[b / 32] |= 1u << (b % 32);  // b < 256: d >= 2
  }
  for (int i = 0; i <= stark::NW; ++i)
    if (r[i]) return true;
  return false;
}

// ShoupOne of p: wp1 = floor(2^256 / p), c1 = ceil(2^256 / wp1)
inline ShoupOne shoup_one(const uint32_t* p_words) {
  uint32_t p[stark::NW];
  for (int i = 0; i < stark::NW; ++i) p[i] = p_words[i];
  ShoupOne one;
  div_pow2_256(p, one.wp);
  if (div_pow2_256(one.wp, one.c1)) {
    for (int i = 0; i < stark::NW && ++one.c1[i] == 0; ++i) {
    }
  }
  uint32_t pn[stark::NW + 1];  // 2^261 - p, 9 words
  uint64_t borrow = 0;
  for (int i = 0; i <= stark::NW; ++i) {
    const uint64_t s = (i == stark::NW ? 1ull << 5 : 0ull) - (i < stark::NW ? p[i] : 0u) - borrow;
    pn[i] = static_cast<uint32_t>(s);
    borrow = (s >> 32) & 1u;
  }
  for (int i = 0; i < stark::NL29; ++i) {  // both in 29-bit limbs
    const int bit = 29 * i, word = bit / 32, sh = bit % 32;
    const uint64_t v = pn[word] | (static_cast<uint64_t>(pn[word + 1]) << 32);
    const uint64_t u = one.wp[word] |
                       (word + 1 < stark::NW ? static_cast<uint64_t>(one.wp[word + 1]) << 32 : 0);
    one.pn29[i] = static_cast<uint32_t>(v >> sh) & stark::MASK29;
    one.wp29[i] = static_cast<uint32_t>(u >> sh) & stark::MASK29;
  }
  return one;
}

// A fused Shoup run of blocks of 2^log_block (4 .. 2048: a cluster of two
// CTAs a block, 256 threads each, two CTAs an SM; 2: one CTA of 512), 104 KB
// of shared memory a CTA at block 2048 with Mul = ShoupMul29; a persistent
// grid of as many clusters as the card holds at once.
template <class Mul>
cudaError_t launch_fused_shoup(const int32_t* a, const uint4* tw, int32_t* out, int64_t n,
                               int log_block, int dit, int canon, const uint32_t* p_words,
                               uint32_t np, cudaStream_t stream) {
  const long long blocks = n >> log_block;
  const int cs = log_block >= 2 ? 2 : 1, h = (1 << log_block) / cs;
  const size_t smem = (2 * static_cast<size_t>(h) * stark::NW * sizeof(uint32_t) +
                       static_cast<size_t>(h / 2) * Mul::Layout::VECS * sizeof(uint4));
  auto kernel = dit ? butterfly_fused_shoup_kernel<true, Mul>
                    : butterfly_fused_shoup_kernel<false, Mul>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cs;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(cs * blocks));
  cfg.blockDim = dim3(FB_THREADS / cs);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;  // clusters the card holds at once: the persistent grid
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters > 0 && clusters < blocks) cfg.gridDim = dim3(static_cast<unsigned>(cs * clusters));
  const stark::Field f = stark::make_field(p_words, np);
  err = cudaLaunchKernelEx(&cfg, kernel, a, tw, out, n, log_block, cs, canon, f,
                           shoup_one(p_words));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool DIT>
cudaError_t launch_pass_shoup(int stages, const int32_t* a, const uint4* tw, int32_t* out,
                              int64_t n, int log_l0, int canon, const stark::Field& f,
                              cudaStream_t st) {
  int log_k = 0;  // K = min(l0, PASS_TILE / 2^stages), as launch_pass
  while ((2 << log_k) << stages <= PASS_TILE && log_k < log_l0) ++log_k;
  const unsigned blocks = static_cast<unsigned>(n >> (stages + log_k));
  const unsigned threads = (1u << (stages + log_k)) / 2;
  if (stages == 1)
    butterfly_pass_shoup_kernel<DIT, 1><<<blocks, threads, 0, st>>>(a, tw, out, n, log_l0,
                                                                    log_k, canon, f);
  else if (stages == 2)
    butterfly_pass_shoup_kernel<DIT, 2><<<blocks, threads, 0, st>>>(a, tw, out, n, log_l0,
                                                                    log_k, canon, f);
  else
    butterfly_pass_shoup_kernel<DIT, 3><<<blocks, threads, 0, st>>>(a, tw, out, n, log_l0,
                                                                    log_k, canon, f);
  return cudaGetLastError();
}

template <bool DIT, bool LAZY>
cudaError_t launch_pass(int stages, const int32_t* a, const uint4* tw, int32_t* out,
                        int64_t n, int log_l0, const stark::Field& f, cudaStream_t st) {
  int log_k = 0;  // K = min(l0, PASS_TILE / 2^stages)
  while ((2 << log_k) << stages <= PASS_TILE && log_k < log_l0) ++log_k;
  const unsigned blocks = static_cast<unsigned>(n >> (stages + log_k));
  const unsigned threads = (1u << (stages + log_k)) / 2;
  if (stages == 1)
    butterfly_pass_kernel<DIT, LAZY, 1><<<blocks, threads, 0, st>>>(a, tw, out, n, log_l0, log_k, f);
  else if (stages == 2)
    butterfly_pass_kernel<DIT, LAZY, 2><<<blocks, threads, 0, st>>>(a, tw, out, n, log_l0, log_k, f);
  else
    butterfly_pass_kernel<DIT, LAZY, 3><<<blocks, threads, 0, st>>>(a, tw, out, n, log_l0, log_k, f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int stark_butterfly_stage(const void* a, const void* tw, void* out,
                                     long long n, long long l, int dit,
                                     const uint32_t* p_words, uint32_t np,
                                     void* stream) {
  const int threads = 256;
  const long long pairs = n / 2;
  if (pairs > 0) {
    const unsigned blocks = static_cast<unsigned>((pairs + threads - 1) / threads);
    const stark::Field f = stark::make_field(p_words, np);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* ap = static_cast<const int32_t*>(a);
    const int32_t* tp = static_cast<const int32_t*>(tw);
    int32_t* op = static_cast<int32_t*>(out);
    if (dit)
      butterfly_stage_kernel<true><<<blocks, threads, 0, st>>>(ap, tp, op, n, l, f);
    else
      butterfly_stage_kernel<false><<<blocks, threads, 0, st>>>(ap, tp, op, n, l, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// lazy: the build of Harvey's lazy butterflies (the wrapper's
// `ops/ntt.py fused_lazy`: 5p < 2^256), else the canonical build (2p < 2^256,
// which field.cuh asks of every field).
extern "C" int stark_butterfly_fused(const void* a, const void* tw_cat,
                                     void* out, long long n, int block, int dit,
                                     int lazy, const uint32_t* p_words, uint32_t np,
                                     void* stream) {
  int log_block = 0;
  while ((1 << log_block) < block) ++log_block;
  const uint32_t top = p_words[stark::NW - 1];
  if (block < 2 || (1 << log_block) != block || log_block > FB_MAX_LOG ||
      top >= (lazy ? 0x33333333u : 0x80000000u))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = n / block;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  // A cluster of two CTAs shares each block, each holding half of it, two
  // CTAs an SM (one for a block of 2 elements)
  const int cs = block >= 4 ? 2 : 1, h = block / cs;
  const size_t smem = (2 * static_cast<size_t>(h) * stark::NW + (h - 1) * 8) * sizeof(uint32_t);
  auto kernel = lazy ? (dit ? butterfly_fused_kernel<true, true> : butterfly_fused_kernel<false, true>)
                     : (dit ? butterfly_fused_kernel<true, false> : butterfly_fused_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cs;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(cs * blocks));
  cfg.blockDim = dim3(FB_THREADS / cs);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;  // clusters the card holds at once: the persistent grid
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters > 0 && clusters < blocks) cfg.gridDim = dim3(static_cast<unsigned>(cs * clusters));
  const stark::Field f = stark::make_field(p_words, np);
  const int32_t* ap = static_cast<const int32_t*>(a);
  const int32_t* tp = static_cast<const int32_t*>(tw_cat);
  int32_t* op = static_cast<int32_t*>(out);
  err = cudaLaunchKernelEx(&cfg, kernel, ap, tp, op, static_cast<int64_t>(n), log_block, cs, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A pass of `stages` (1 .. 3) outer stages from width l0 (a power of two;
// n a multiple of l0 2^stages); tw: the largest stage's table, l0
// 2^(stages-1) elements of 8 packed words. lazy: as for butterfly_fused.
extern "C" int stark_butterfly_pass(const void* a, const void* tw, void* out, long long n,
                                    long long l0, int stages, int dit, int lazy,
                                    const uint32_t* p_words, uint32_t np, void* stream) {
  int log_l0 = 0;
  while ((1LL << log_l0) < l0) ++log_l0;
  const uint32_t top = p_words[stark::NW - 1];
  if (stages < 1 || stages > PASS_MAX_STAGES || (1LL << log_l0) != l0 ||
      n % (l0 << stages) != 0 || top >= (lazy ? 0x33333333u : 0x80000000u))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const stark::Field f = stark::make_field(p_words, np);
  const int32_t* ap = static_cast<const int32_t*>(a);
  const uint4* tp = static_cast<const uint4*>(tw);
  int32_t* op = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      lazy ? (dit ? launch_pass<true, true>(stages, ap, tp, op, n, log_l0, f, st)
                  : launch_pass<false, true>(stages, ap, tp, op, n, log_l0, f, st))
           : (dit ? launch_pass<true, false>(stages, ap, tp, op, n, log_l0, f, st)
                  : launch_pass<false, false>(stages, ap, tp, op, n, log_l0, f, st));
  return static_cast<int>(err);
}

// The Shoup forms (see the header). Both need 2p < 2^256; tw holds 16 words
// an entry: l0 2^(stages-1) entries for the pass (its largest stage's table),
// block - 1 for the fused run (stage l's at l - 1 .. 2l - 2). canon: the last
// stage's outputs below p.
extern "C" int stark_butterfly_pass_shoup(const void* a, const void* tw, void* out,
                                          long long n, long long l0, int stages, int dit,
                                          int canon, const uint32_t* p_words, uint32_t np,
                                          void* stream) {
  int log_l0 = 0;
  while ((1LL << log_l0) < l0) ++log_l0;
  if (stages < 1 || stages > PASS_MAX_STAGES || (1LL << log_l0) != l0 ||
      n % (l0 << stages) != 0 || p_words[stark::NW - 1] >= 0x80000000u)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const stark::Field f = stark::make_field(p_words, np);
  const int32_t* ap = static_cast<const int32_t*>(a);
  const uint4* tp = static_cast<const uint4*>(tw);
  int32_t* op = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dit ? launch_pass_shoup<true>(stages, ap, tp, op, n, log_l0, canon, f, st)
                              : launch_pass_shoup<false>(stages, ap, tp, op, n, log_l0, canon, f, st));
}

extern "C" int stark_butterfly_fused_shoup(const void* a, const void* tw, void* out,
                                           long long n, int block, int dit, int canon,
                                           const uint32_t* p_words, uint32_t np, void* stream) {
  int log_block = 0;
  while ((1 << log_block) < block) ++log_block;
  if (block < 2 || (1 << log_block) != block || log_block > FB_MAX_LOG || n % block != 0 ||
      p_words[stark::NW - 1] >= 0x80000000u)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n < block) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_fused_shoup<ShoupMul29>(
      static_cast<const int32_t*>(a), static_cast<const uint4*>(tw), static_cast<int32_t*>(out),
      n, log_block, dit, canon, p_words, np, static_cast<cudaStream_t>(stream)));
}
