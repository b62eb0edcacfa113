// The three fused passes of the CRT product (W @ x) mod p.
//
// They replace the TPU kernels of stark_tpu/ops/pallas_crt.py:
//   residues_in   :106 (_residues_kernel :79)     limbs -> residues mod every
//       prime q_i, times an optional pre-table residue, as two 7-bit digits
//   matmul_fold   :176 (_matmul_fold_kernel :142) per prime, the four digit
//       products, recombined and folded to (W @ x) mod q_i
//   reconstruct   :254 (_kernel :241, body stark_tpu/ops/crt.py:294)
//       residues -> X * R^-1 mod p as canonical 16-bit limbs
// Each has one integer meaning, and that is what is computed here: the TPU
// bodies split every constant table into bf16 digits because their matrix
// unit multiplies bf16; none of those splits is carried over.
//
// residues_in (replaces stark_tpu/ops/pallas_crt.py:106 residues_in). The
// residue of a 256-bit value v = sum_l byte_l * 256^l is
// raw = sum_l Cb[i][l] * byte_l reduced mod q_i, Cb the balanced residue of
// 256^l, |raw| < 2^26. What bounds it: bytes (64 in, 2 per prime of
// pre-table, 2 per prime out, a lane). The table-by-bytes product is a
// (P+1, 32) x (32, lanes) int8 matrix product, and the design runs it on the
// tensor cores (mma.sync m16n8k32, s8 table digits x u8 data bytes): on the
// CUDA cores it took 16 dp4a a prime and lane and held the kernel at twice
// its bound. Left on the CUDA cores is the epilogue, ~9 integer operations a
// prime and lane, ~15 with a pre-table: raw = a0 + 128 * a1 (Cb = c0 + 128 c1,
// c0 and c1 in [-64, 63], the two A planes), one Barrett step by
// floor(2^32 / q) (exact for any 32-bit value up to one conditional
// subtraction; the accumulator starts at q * 2^14 > |raw| to make it
// nonnegative), the product with the pre-table residue (< 2^28), a second
// step, the two 7-bit digits.
// - A warp tile is 4 contraction rows k (one output word) x 16 lanes b: 8
//   n-tiles of 8 lanes, n-tile (j, h) holding row 4k4 + j and, in column n,
//   lane b0 + 4(n/2) + 2h + n%2. So in the accumulator thread t holds lanes
//   b0 + 4t .. b0 + 4t + 3 (columns 2t, 2t + 1 of both h) of all four rows:
//   whole output words, stored as 16-byte vectors, and its pre-table reads
//   are 8 bytes (4 lanes) a prime and row; a warp's store or pre-table load
//   covers 64 or 32 contiguous bytes of 8 primes, whole sectors.
// - B fragments: the register of thread (g, t) holds bytes 4t..4t+3 of its
//   column's lane, word t of the element (stark::load_elem's words), and
//   bytes 16 + 4t.. (word t + 4). Thread pairs g, g + 1 load the lo and the
//   hi limb plane of that word for the 4 lanes b0 + 4(g/2) .. + 3 as one
//   16-byte vector each and swap half of it (one shuffle) to hold the whole
//   word of their two lanes in both n-tiles h.
// - A fragments (4 registers a prime tile and plane) come from the
//   kernel_table rows in shared memory, read without bank conflicts.
// - A warp walks tiles with a stride over a grid of as many blocks as fit
//   the card; a prime tile's 8 pre-table loads are issued together, ahead
//   of its products.
// - Rows k >= K load zeros and so give zero digits; lanes b >= B are not
//   stored; B % 4 != 0 takes scalar loads and stores.
// What holds it above the bound on an H100 (scripts/crt_kernels_cuda.py
// --probe): the loads and stores alone, in this order, take 1.3 times a
// device copy of as many bytes, since a warp instruction reads 32 bytes of
// a prime's pre-table row; the arithmetic alone takes under that. Staging
// tiles through shared memory (cp.async) or an L2 prefetch of the next
// tile was slower: fewer blocks an SM, more traffic.
// The digits leave as (P+1, ceil(K/4), B) int32 words, four contraction
// rows a word, the layout matmul_fold's producer copies into its K-major
// tiles four steps at a time.
//
// matmul_fold (replaces stark_tpu/ops/pallas_crt.py:176 matmul_fold). All
// digits fit int8 (W in [-64, 63], x in [0, 127]), so the four digit
// products run on the tensor cores' integer path, s8 x s8 -> s32, exact at
// any contraction length the wrapper admits (K <= 1024). What bounds it on
// this card: operations, 8*K*kout*B a prime against the int8 tensor-core
// rate, which only wgmma reaches. The design:
// - Persistent and warp-specialised: one CTA an SM walks 128 x 128 output
//   tiles prime-major (the CTAs in flight read one or two primes' W rows,
//   so the 119 MB of W planes at 57 x 1024^2 are read from L2, not DRAM),
//   with three shared-memory stages of 128 contraction bytes (64 KB each:
//   W0, W1, x0, x1) behind full/empty mbarriers.
// - Consumers: warpgroups 0 and 1, 64 W rows each, run wgmma.mma_async
//   m64n128k32 .s32.s8.s8 with both operands in shared memory, 16 a stage
//   (4 k-steps x the products W0x0, W0x1, W1x0, W1x1), into three s32
//   accumulator sets (s00, s01 + s10, s11: 192 registers; setmaxnreg gives
//   the consumers 232 and the producer 40). One wgmma group stays in flight
//   while the next stage is waited for; a stage is handed back when the
//   group that read it has completed.
// - Producer: warpgroup 2. W arrives by TMA (one 4-D tensor map over the
//   (2, P+1, kout, kp) planes, 128B swizzle). The plan pads each W row with
//   zeros to kp, a multiple of 16 bytes, because TMA needs 16-byte row
//   strides (K = 100 or 6 do not give them); zeros change no sum, and TMA's
//   out-of-bounds fill covers the rest of the last tile.
// - B's layout: wgmma takes 8-bit operands K-major only, and x arrives as
//   (P+1, K/4, B) words, four k of one column a word (crt.pack_k4), the
//   layout residues_in writes. The producer transposes
//   on the way in: a 4-byte cp.async for each word, from global (k4, b) to
//   the word's place in row b of the 128B-swizzled K-major tile. A warp
//   covers 4 words x 8 rows, so its global reads are 32-byte sectors and its
//   shared writes hit 32 distinct banks; a word past ceil(K/4) or B is
//   zero-filled by the copy itself (source size 0), so any (K, B) runs
//   without a size gate. Each producer thread's arrival on the stage's
//   full barrier is tied to the completion of its copies
//   (cp.async.mbarrier.arrive.noinc), so the producer never waits on its
//   own loads; the copies are generic-proxy writes, so a consumer fences
//   (fence.proxy.async) after the barrier and before its wgmma read them.
//   (TMA cannot do this transpose, and x's row stride 4*B bytes is not a
//   multiple of 16 at B = 5 or 70.)
// - Epilogue, the TPU kernel's: s00 + 128*fold(s01+s10) + delta*fold(s11)
//   with fold(s) = (s >> 14)*delta + (s & 16383), |.| < 2^30 for K <= 1024,
//   then Barrett to the canonical residue; rows past kout and columns past
//   B are not stored.
// Four products, not Karatsuba's three: the bound counts four, and a third
// W plane and an s8 x u8 product are left for when the tensor cores, and not
// the loads, are shown to bind.
//
// reconstruct (replaces stark_tpu/ops/pallas_crt.py:254 reconstruct, body
// stark_tpu/ops/crt.py:294). With s_i the t-scaled residues, the value is
// REDC(Y), Y = sum_i gp_i * s_i + k * (-M mod p), gp_i = (M/q_i) mod p, and
// the wrap count k = ((sum_i grr_i * s_i - s_r) * M^-1) mod q_r from the
// redundant prime. The JAX body's integer meaning is kept: Y's base-256
// digit columns are D0 + 128 * D1 + k * negM_d, D0 = G (s & 127) and
// D1 = G (s >> 7) over the P primes, G the (ND + 2 = 37, P) balanced digits
// of gp_i (rows 0..34) and of grr_i (rows 35, 36, 7-bit), |D| < 2^20 for
// P <= 64. What bounds it: bytes (4 per prime in, 64 out, a lane). With one
// thread a lane forming Y word by word (an 8-word multiply-add a prime) and
// three 64-bit remainders by q_r, it issued ~2,100 integer instructions a
// lane and ran at twice its bound. The design:
// - D0 and D1 run on the tensor cores: mma.sync m16n8k32, A = G (rows padded
//   to 48: three m-tiles; primes padded to 64: two k-steps; s8, held in
//   registers, the fragments built on the host, CrtBasis.rec_frags),
//   B = the digits of s (u8): a register holds four consecutive primes of
//   one lane, loaded as four rows and packed in pairs of 16-bit halves.
// - A warp takes rounds of 32 lanes as 4 n-tiles of 8 and issues all of a
//   round's 65 loads before it packs any (written the other way, with the
//   packing between the loads, it took 18% longer on an H100).
// - A lane's 37 sums come out spread over the 8 groups of the warp;
//   E = D0 + 128 * D1 goes to shared memory (44 words a lane: stores and
//   16-byte reads free of bank conflicts) and each thread reads back its
//   own lane's.
// - Per lane, on the CUDA cores: k from rows 35 and 36 (E35 + 128 E36 is
//   sum_i grr_i s_i), each row and the sum reduced by a Barrett step by
//   floor(2^32 / q_r), no 64-bit remainder; the 35 columns plus k * negM_d
//   (the digits a kernel argument); their carry into 9 words of Y in
//   64-bit sums; the word-wise Montgomery reduction of field.cuh's style
//   (8 rounds) and one conditional subtraction: u = (Y + m*p)/R < Y/R + p
//   < 2^19 + p < 2p.
#include <cuda.h>

#include "field.cuh"

namespace {

using stark::Field;
using stark::NW;

constexpr int QBITS = 14;
constexpr int QMASK = (1 << QBITS) - 1;
// words of one prime's table row: 8 of c0, 8 of c1, q, floor(2^32/q),
// 0 (unused), delta = 2^14 - q
constexpr int TABLE_ROW = 20;

// v mod q for any 32-bit v, with m = floor(2^32 / q): the quotient estimate
// is the true one or one less.
__device__ __forceinline__ uint32_t barrett(uint32_t v, uint32_t q, uint32_t m) {
  uint32_t r = v - __umulhi(v, m) * q;
  return r >= q ? r - q : r;
}

// d += a (16 x 32, s8, row-major) * b (32 x 8, u8, column-major) in the
// m16n8k32 fragments of the PTX ISA. With g = lane / 4, t = lane % 4: a[0]
// holds row g, columns 4t..4t+3 (a byte each, the lowest first), a[1] row
// g + 8, a[2] and a[3] the same rows at columns 16 + 4t..; b0 holds rows
// 4t..4t+3 of column g, b1 rows 16 + 4t..; d[0], d[1] are row g, columns
// 2t and 2t + 1, d[2], d[3] the same of row g + 8.
__device__ __forceinline__ void mma_s8u8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The grid of a kernel whose warps walk `work` units with a stride: as many
// blocks as fit on the card at once, fewer where there is less work.
template <typename Kernel>
unsigned resident_grid(Kernel kernel, int threads, size_t shared, long long work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, shared);
  const long long warps = threads / 32;
  const long long want = (work + warps - 1) / warps;
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(want < most ? want : most);
}

// ---------------------------------------------------------------------------
// residues_in
// ---------------------------------------------------------------------------

constexpr int RIN_WARPS = 4;
constexpr int RIN_THREADS = 32 * RIN_WARPS;
constexpr int RIN_TB = 16;  // lanes b of a warp tile (times 4 rows k)

// 4 int32 of a row from column b, zeros past B or where !live.
__device__ __forceinline__ void load4(const int32_t* __restrict__ row, int64_t b, int64_t B,
                                      bool live, uint32_t (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = live && b + e < B ? row[b + e] : 0;
}

// 4 int16 of a row from column b as two words (lanes b, b+1 and b+2, b+3).
__device__ __forceinline__ void load4_i16(const int16_t* __restrict__ row, int64_t b,
                                          int64_t B, bool live, uint32_t (&v)[2]) {
  uint32_t h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = live && b + e < B ? static_cast<uint16_t>(row[b + e]) : 0;
  v[0] = h[0] | (h[1] << 16), v[1] = h[2] | (h[3] << 16);
}

// 4 words to a row from column b; VEC: B % 4 == 0 and b a multiple of 4, so
// the four are all in or all out.
template <bool VEC>
__device__ __forceinline__ void store4(int32_t* __restrict__ row, int64_t b, int64_t B,
                                       const uint32_t (&v)[4]) {
  if (VEC) {
    if (b < B) *reinterpret_cast<int4*>(row + b) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (b + e < B) row[b + e] = static_cast<int32_t>(v[e]);
  }
}

template <bool HAS_PRE, bool VEC>
__global__ void __launch_bounds__(RIN_THREADS)
residues_in_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ table,
                   const int16_t* __restrict__ pre, int32_t* __restrict__ o0,
                   int32_t* __restrict__ o1, int p1, int64_t K, int64_t K4, int64_t B,
                   int64_t tiles_b, int64_t tiles) {
  extern __shared__ __align__(16) int32_t tab[];  // (16 * mtiles, TABLE_ROW)
  const int mtiles = (p1 + 15) / 16;
  for (int i = threadIdx.x; i < 16 * mtiles * TABLE_ROW; i += blockDim.x)
    tab[i] = i < p1 * TABLE_ROW ? table[i] : 0;  // rows past p1: zero digits
  __syncthreads();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int c = g / 2, par = g % 2;
  const int64_t n = K * B;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * RIN_WARPS + threadIdx.x / 32;
       tile < tiles; tile += static_cast<int64_t>(gridDim.x) * RIN_WARPS) {
    const int64_t k4 = tile / tiles_b, b0 = (tile % tiles_b) * RIN_TB;
    // B fragments of the 8 n-tiles: bf[j][h] = words t, t + 4 of the lane
    // b0 + 4c + 2h + par of row 4k4 + j
    uint32_t bf[4][2][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t k = 4 * k4 + j;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // this thread: the lo (par 0) or hi (par 1) limb of word t + 4r of
        // lanes b0 + 4c .. + 3; its partner g ^ 1 the other limb
        const int32_t* row = x + (2 * (t + 4 * r) + par) * n + k * B;
        uint32_t v[4];
        if (VEC) {
          int4 u = make_int4(0, 0, 0, 0);
          if (k < K && b0 + 4 * c < B) u = *reinterpret_cast<const int4*>(row + b0 + 4 * c);
          v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
        } else {
          load4(row, b0 + 4 * c, B, k < K, v);
        }
        const uint32_t send = ((par ? v[0] : v[1]) & 0xFFFFu) | ((par ? v[2] : v[3]) << 16);
        const uint32_t recv = __shfl_xor_sync(0xFFFFFFFFu, send, 4);
        bf[j][0][r] = par ? (recv & 0xFFFFu) | (v[1] << 16) : (v[0] & 0xFFFFu) | (recv << 16);
        bf[j][1][r] = par ? (recv >> 16) | (v[3] << 16) : (v[2] & 0xFFFFu) | (recv & 0xFFFF0000u);
      }
    }
    for (int mt = 0; mt < mtiles; ++mt) {
      const int i0 = 16 * mt + g, i1 = i0 + 8;  // the primes of this thread's rows
      const int32_t* r0 = tab + i0 * TABLE_ROW;
      const int32_t* r1 = tab + i1 * TABLE_ROW;
      const uint32_t a0[4] = {static_cast<uint32_t>(r0[t]), static_cast<uint32_t>(r1[t]),
                              static_cast<uint32_t>(r0[t + 4]),
                              static_cast<uint32_t>(r1[t + 4])};
      const uint32_t a1[4] = {static_cast<uint32_t>(r0[NW + t]),
                              static_cast<uint32_t>(r1[NW + t]),
                              static_cast<uint32_t>(r0[NW + t + 4]),
                              static_cast<uint32_t>(r1[NW + t + 4])};
      const uint32_t q[2] = {static_cast<uint32_t>(r0[16]), static_cast<uint32_t>(r1[16])};
      const uint32_t m[2] = {static_cast<uint32_t>(r0[17]), static_cast<uint32_t>(r1[17])};
      // pre-table residues of lanes b0 + 4t .. + 3, all loaded before the
      // prime tile's products: pw[j][prime][word], lanes 2word, 2word + 1
      uint32_t pw[4][2][2];
      if (HAS_PRE) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            const int i = pr ? i1 : i0;
            const int64_t k = 4 * k4 + j;
            const int16_t* row = pre + (static_cast<int64_t>(i) * K + k) * B;
            if (VEC) {
              int2 u = make_int2(0, 0);
              if (i < p1 && k < K && b0 + 4 * t < B)
                u = *reinterpret_cast<const int2*>(row + b0 + 4 * t);
              pw[j][pr][0] = u.x, pw[j][pr][1] = u.y;
            } else {
              load4_i16(row, b0 + 4 * t, B, i < p1 && k < K, pw[j][pr]);
            }
          }
      }
      uint32_t w0[2][4] = {}, w1[2][4] = {};  // [prime][lane b0 + 4t + e]: words
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int d0[4] = {static_cast<int>(q[0] << QBITS), static_cast<int>(q[0] << QBITS),
                       static_cast<int>(q[1] << QBITS), static_cast<int>(q[1] << QBITS)};
          int d1[4] = {0, 0, 0, 0};
          mma_s8u8(d0, a0, bf[j][h][0], bf[j][h][1]);
          mma_s8u8(d1, a1, bf[j][h][0], bf[j][h][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pr = e / 2, col = e % 2;
            // q * 2^14 + raw, in (0, 2^29)
            const uint32_t v = static_cast<uint32_t>(d0[e]) + 128u * static_cast<uint32_t>(d1[e]);
            uint32_t r = barrett(v, q[pr], m[pr]);
            if (HAS_PRE) {
              const uint32_t tw = pw[j][pr][h];
              r = barrett(r * (col ? tw >> 16 : tw & 0xFFFFu), q[pr], m[pr]);  // < 2^28
            }
            w0[pr][2 * h + col] |= (r & 127u) << (8 * j);
            w1[pr][2 * h + col] |= (r >> 7) << (8 * j);
          }
        }
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int i = pr ? i1 : i0;
        if (i < p1) {
          const int64_t o = (static_cast<int64_t>(i) * K4 + k4) * B;
          store4<VEC>(o0 + o, b0 + 4 * t, B, w0[pr]);
          store4<VEC>(o1 + o, b0 + 4 * t, B, w1[pr]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// matmul_fold
// ---------------------------------------------------------------------------

constexpr int MM_BM = 128;      // output rows (W rows) of a tile: two consumer warpgroups
constexpr int MM_BN = 128;      // output columns (batch lanes) of a tile
constexpr int MM_BK = 128;      // contraction bytes of one stage: one 128-byte swizzle row
constexpr int MM_STAGES = 3;
constexpr int MM_PLANE = MM_BM * MM_BK;  // bytes of one operand plane of a stage (16 KB)
constexpr int MM_STAGE = 4 * MM_PLANE;   // W0, W1, x0, x1
constexpr int MM_THREADS = 384;          // consumers: warpgroups 0, 1; producer: 2
constexpr int MM_SMEM = MM_STAGES * MM_STAGE + 1024;  // + slack to align to 1024

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One box of the (2, P+1, kout, Kp) digit planes into shared memory, 128B-swizzled.
__device__ __forceinline__ void tma_load_w(const CUtensorMap* map, uint32_t dst,
                                           uint32_t bar, int k, int row, int prime,
                                           int plane) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row), "r"(prime),
      "r"(plane)
      : "memory");
}

// 4 bytes from global to shared, zeros where `ok` is false.
__device__ __forceinline__ void cp_async4(uint32_t dst, const int32_t* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in 128B-swizzled rows
// of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

#define D8(i)                                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D (64 x 128 s32, this warpgroup's fragment) += A (64 x 32 s8) * B^T
// (128 x 32 s8), both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__global__ void __launch_bounds__(MM_THREADS, 1)
matmul_fold_kernel(const __grid_constant__ CUtensorMap wmap,
                   const int32_t* __restrict__ x0, const int32_t* __restrict__ x1,
                   const int32_t* __restrict__ table, int32_t* __restrict__ out,
                   int p1, int kout, int K4, int B) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MM_STAGES], empty[MM_STAGES];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x;
  const int tiles_m = (kout + MM_BM - 1) / MM_BM, tiles_n = (B + MM_BN - 1) / MM_BN;
  const int per_prime = tiles_m * tiles_n, tiles = p1 * per_prime;
  const int nk = (4 * K4 + MM_BK - 1) / MM_BK;
  if (tid == 0) {
    for (int s = 0; s < MM_STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 128 + 1);  // producer threads + the TMA issue
      mbar_init(smem_addr(&empty[s]), 8);       // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer: W through TMA, x through 4-byte copies that transpose it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int ptid = tid - 256;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int prime = tile / per_prime, rem = tile % per_prime;
      const int m0 = (rem / tiles_n) * MM_BM, n0 = (rem % tiles_n) * MM_BN;
      const int32_t* X[2] = {x0 + static_cast<int64_t>(prime) * K4 * B,
                             x1 + static_cast<int64_t>(prime) * K4 * B};
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(smem_addr(&empty[stage]), phase ^ 1);
        const uint32_t st = base + stage * MM_STAGE;
        const uint32_t fb = smem_addr(&full[stage]);
        if (ptid == 0) {
          mbar_expect_tx(fb, 2 * MM_PLANE);
          tma_load_w(&wmap, st, fb, kb * MM_BK, m0, prime, 0);
          tma_load_w(&wmap, st + MM_PLANE, fb, kb * MM_BK, m0, prime, 1);
        }
        // element e of a plane's (32 words of k) x (128 lanes) tile: word w of
        // 16-byte chunk c of lane row b; a warp covers 8 rows x one chunk, so
        // its shared-memory writes hit 32 distinct banks
#pragma unroll 2
        for (int it = 0; it < 32; ++it) {
          const int e = it * 128 + ptid;
          const int w = e & 3, bl = (e >> 2) & 7, c = (e >> 5) & 7, bh = e >> 8;
          const int b = bh * 8 + bl, k4 = kb * (MM_BK / 4) + c * 4 + w;
          const bool ok = k4 < K4 && n0 + b < B;
          const int64_t off = ok ? static_cast<int64_t>(k4) * B + n0 + b : 0;
          const uint32_t dst = b * MM_BK + ((c ^ bl) << 4) + (w << 2);
          cp_async4(st + 2 * MM_PLANE + dst, X[0] + off, ok);
          cp_async4(st + 3 * MM_PLANE + dst, X[1] + off, ok);
        }
        // this thread's copies count in on the stage's barrier as they land
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(fb)
                     : "memory");
        if (++stage == MM_STAGES) { stage = 0; phase ^= 1; }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // consumers: warpgroup wg owns W rows 64*wg .. 64*wg + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    int stage = 0, phase = 0;
    int acc00[64], accm[64], acc11[64];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int prime = tile / per_prime, rem = tile % per_prime;
      const int m0 = (rem / tiles_n) * MM_BM, n0 = (rem % tiles_n) * MM_BN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc00[i] = accm[i] = acc11[i] = 0;
      int last = -1;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(smem_addr(&full[stage]), phase);
        // the x tiles were written by the generic proxy (cp.async): order them
        // before the tensor cores' async-proxy reads
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const uint32_t st = base + stage * MM_STAGE;
        const uint32_t a0 = st + wg * 64 * MM_BK, a1 = a0 + MM_PLANE;
        const uint32_t b0 = st + 2 * MM_PLANE, b1 = b0 + MM_PLANE;
        fence_acc(acc00);
        fence_acc(accm);
        fence_acc(acc11);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < MM_BK / 32; ++ks) {
          const uint32_t o = ks * 32;
          wgmma_s8(acc00, desc_sw128(a0 + o), desc_sw128(b0 + o));
          wgmma_s8(accm, desc_sw128(a0 + o), desc_sw128(b1 + o));
          wgmma_s8(accm, desc_sw128(a1 + o), desc_sw128(b0 + o));
          wgmma_s8(acc11, desc_sw128(a1 + o), desc_sw128(b1 + o));
        }
        wgmma_commit();
        fence_acc(acc00);
        fence_acc(accm);
        fence_acc(acc11);
        // the stage before this one has been read: hand it back
        wgmma_wait<1>();
        if (last >= 0 && lane == 0) mbar_arrive(smem_addr(&empty[last]));
        last = stage;
        if (++stage == MM_STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc00);
      fence_acc(accm);
      fence_acc(acc11);
      if (lane == 0) mbar_arrive(smem_addr(&empty[last]));

      // epilogue: s00 + 128*fold(s01+s10) + delta*fold(s11), Barrett to [0, q)
      const int32_t* row = table + prime * TABLE_ROW;
      const uint32_t q = row[16], m = row[17];
      const int d = row[19];
      int32_t* o = out + static_cast<int64_t>(prime) * kout * B;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wg * 64 + warp * 16 + g + 8 * h;
        if (r >= kout) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          int v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            int s11 = acc11[i];  // |.| <= K*64*127 < 2^23
            s11 = (s11 >> QBITS) * d + (s11 & QMASK);
            int sm = accm[i];  // |.| <= 2^24
            sm = (sm >> QBITS) * d + (sm & QMASK);
            const int raw = acc00[i] + sm * 128 + d * s11;  // |.| < 2^30
            v[e] = static_cast<int>(
                barrett(static_cast<uint32_t>(raw) + (q << (30 - QBITS + 1)), q, m));
          }
          const int c = n0 + 8 * j + 2 * t;
          int32_t* dst = o + static_cast<int64_t>(r) * B + c;
          if (c + 1 < B && (B & 1) == 0) {
            *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
          } else {
            if (c < B) dst[0] = v[0];
            if (c + 1 < B) dst[1] = v[1];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// reconstruct
// ---------------------------------------------------------------------------

constexpr int REC_WARPS = 4;
constexpr int REC_THREADS = 32 * REC_WARPS;
constexpr int ND = 35;           // base-256 digit columns of Y (crt.ND)
constexpr int REC_MT = 3;        // m-tiles: the ND + 2 rows of G padded to 48
constexpr int REC_KS = 2;        // k-steps: up to 64 primes (crt.REC_PRIMES)
constexpr int REC_STRIDE = 44;   // words of one lane's sums in shared memory

struct NegMDigits {
  int32_t d[ND];  // balanced base-256 digits of -M mod p
};

// One lane's epilogue: its 37 column sums E and redundant residue s_r ->
// its 16 limbs of X * R^-1 mod p.
__device__ __forceinline__ void reconstruct_lane(const int32_t (&es)[ND + 2], int32_t s_r,
                                                 uint32_t qr, uint32_t mr, uint32_t minv,
                                                 const NegMDigits& negm, const Field& f,
                                                 int32_t* __restrict__ out, int64_t n,
                                                 int64_t l) {
  const uint32_t sr = static_cast<uint32_t>(s_r);
  // wrap count: E35 + 128 E36 = sum_i grr_i s_i; each row, then the sum
  // with q_r - s_r, reduced by a Barrett step (all inputs < 2^32)
  const uint32_t off = qr << QBITS;  // > 2^27 > |E|
  const uint32_t e0 = barrett(static_cast<uint32_t>(es[ND]) + off, qr, mr);
  const uint32_t e1 = barrett(static_cast<uint32_t>(es[ND + 1]) + off, qr, mr);
  const uint32_t kd = barrett(e0 + 128 * e1 + qr - sr, qr, mr);  // < 2^22
  const int32_t k = static_cast<int32_t>(barrett(kd * minv, qr, mr));  // kd * minv < 2^28

  // Y = sum_d (E_d + k * negM_d) 256^d >= 0, in 9 words (Y < 2^275)
  uint32_t y[NW + 2];
  int64_t acc = 0;
#pragma unroll
  for (int w = 0; w < NW + 1; ++w) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * w + i < ND)
        acc += static_cast<int64_t>(es[4 * w + i] + k * negm.d[4 * w + i]) *
               (static_cast<int64_t>(1) << (8 * i));
    y[w] = static_cast<uint32_t>(acc);
    acc >>= 32;  // arithmetic: the columns are signed
  }
  y[NW + 1] = 0;

  // word-wise Montgomery reduction of Y (9 words live, y[9] takes carries)
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t m = y[0] * f.np;
    uint64_t c = (static_cast<uint64_t>(m) * f.p[0] + y[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      uint64_t v = static_cast<uint64_t>(m) * f.p[j] + y[j] + c;
      y[j - 1] = static_cast<uint32_t>(v);
      c = v >> 32;
    }
    uint64_t v = static_cast<uint64_t>(y[NW]) + c;
    y[NW - 1] = static_cast<uint32_t>(v);
    v = static_cast<uint64_t>(y[NW + 1]) + (v >> 32);
    y[NW] = static_cast<uint32_t>(v);
    y[NW + 1] = 0;
  }
  stark::cond_sub_p(f, y[NW], y);
  stark::store_elem(out, n, l, y);
}

__global__ void __launch_bounds__(REC_THREADS)
reconstruct_kernel(const int32_t* __restrict__ s, const int4* __restrict__ frags,
                   int32_t* __restrict__ out, int P, int64_t n, int64_t rounds,
                   uint32_t qr, uint32_t mr, uint32_t minv, NegMDigits negm, Field f) {
  __shared__ __align__(16) int32_t sums[REC_WARPS][32 * REC_STRIDE];
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  int32_t* sh = sums[threadIdx.x / 32];
  uint32_t a[REC_MT][REC_KS][4];  // G's fragments, (3, 2, 32) int4 on the device
#pragma unroll
  for (int mt = 0; mt < REC_MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < REC_KS; ++ks) {
      const int4 v = frags[(mt * REC_KS + ks) * 32 + lane];
      a[mt][ks][0] = v.x, a[mt][ks][1] = v.y, a[mt][ks][2] = v.z, a[mt][ks][3] = v.w;
    }
  for (int64_t round = static_cast<int64_t>(blockIdx.x) * REC_WARPS + threadIdx.x / 32;
       round < rounds; round += static_cast<int64_t>(gridDim.x) * REC_WARPS) {
    const int64_t l0 = round * 32;
    // the round's residues, all loaded before any is used: thread (g, t)
    // takes primes 32ks + 16r + 4t .. + 3 of lane l0 + 8nt + g
    uint32_t v[4][REC_KS][2][4];  // [nt][ks][r][i], each < 2^14
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int ks = 0; ks < REC_KS; ++ks)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int prime = 32 * ks + 16 * r + 4 * t + i;
            const int64_t col = l0 + 8 * nt + g;
            v[nt][ks][r][i] = prime < P && col < n ? s[prime * n + col] : 0;
          }
    const int32_t s_r = l0 + lane < n ? s[P * n + l0 + lane] : 0;
    // B fragments, the digit planes: b[nt][plane][ks][r], four primes a
    // register, packed in pairs of 16-bit halves
    uint32_t b[4][2][REC_KS][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int ks = 0; ks < REC_KS; ++ks)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t* w = v[nt][ks][r];
          const uint32_t u02 = w[0] | (w[2] << 16), u13 = w[1] | (w[3] << 16);
          b[nt][0][ks][r] = (u02 & 0x007F007Fu) | ((u13 & 0x007F007Fu) << 8);
          b[nt][1][ks][r] = ((u02 >> 7) & 0x007F007Fu) | (((u13 >> 7) & 0x007F007Fu) << 8);
        }
    __syncwarp();  // the last round's sums are read; the mma takes the whole warp
    // E = D0 + 128 D1 of rows 16mt + g (+8) and lanes 2t, 2t + 1 of each n-tile
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < REC_MT; ++mt) {
        int d0[4] = {0, 0, 0, 0}, d1[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ks = 0; ks < REC_KS; ++ks) {
          mma_s8u8(d0, a[mt][ks], b[nt][0][ks][0], b[nt][0][ks][1]);
          mma_s8u8(d1, a[mt][ks], b[nt][1][ks][0], b[nt][1][ks][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + 8 * (e / 2);
          if (row < ND + 2) sh[(8 * nt + 2 * t + e % 2) * REC_STRIDE + row] = d0[e] + 128 * d1[e];
        }
      }
    __syncwarp();
    int32_t es[ND + 2];  // this thread's lane: |E| < 2^27
#pragma unroll
    for (int v = 0; v < 9; ++v) {
      const int4 w = *reinterpret_cast<const int4*>(sh + lane * REC_STRIDE + 4 * v);
      es[4 * v] = w.x, es[4 * v + 1] = w.y, es[4 * v + 2] = w.z, es[4 * v + 3] = w.w;
    }
    es[ND + 1] = sh[lane * REC_STRIDE + ND + 1];
    const int64_t l = l0 + lane;
    if (l < n) reconstruct_lane(es, s_r, qr, mr, minv, negm, f, out, n, l);
  }
}

}  // namespace

// x (16, K, B) limb planes, table (p1, 20), pre (p1, K, B) int16 or null ->
// o0, o1 (p1, ceil(K/4), B) packed digit planes.
extern "C" int stark_crt_residues_in(const void* x, const void* table,
                                     const void* pre, void* o0, void* o1, int p1,
                                     long long K, long long B, void* stream) {
  const long long K4 = (K + 3) / 4, tiles_b = (B + RIN_TB - 1) / RIN_TB;
  const long long tiles = K4 * tiles_b;
  if (tiles > 0 && p1 > 0) {
    const size_t shared = static_cast<size_t>((p1 + 15) / 16) * 16 * TABLE_ROW * sizeof(int32_t);
    auto launch = [&](auto kernel) {
      kernel<<<resident_grid(kernel, RIN_THREADS, shared, tiles), RIN_THREADS, shared,
               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(x), static_cast<const int32_t*>(table),
          static_cast<const int16_t*>(pre), static_cast<int32_t*>(o0),
          static_cast<int32_t*>(o1), p1, K, K4, B, tiles_b, tiles);
    };
    const bool vec = B % 4 == 0;
    if (pre != nullptr)
      vec ? launch(residues_in_kernel<true, true>) : launch(residues_in_kernel<true, false>);
    else
      vec ? launch(residues_in_kernel<false, true>) : launch(residues_in_kernel<false, false>);
  }
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// w (2, p1, kout, kp) int8, the two digit planes with rows padded to kp
// (a multiple of 16) bytes; x0, x1 (p1, ceil(K/4), B) packed digit planes;
// table (p1, 20) -> out (p1, kout, B) canonical residues.
extern "C" int stark_crt_matmul_fold(const void* w, const void* x0, const void* x1,
                                     const void* table, void* out, int p1,
                                     int kout, int K, int kp, int B, void* stream) {
  if (p1 <= 0 || kout <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  if (kp % 16 != 0 || kp < K) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap wmap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(kout),
                              static_cast<cuuint64_t>(p1), 2};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(kp),
                                 static_cast<cuuint64_t>(kp) * kout,
                                 static_cast<cuuint64_t>(kp) * kout * p1};
  const cuuint32_t box[4] = {MM_BK, MM_BM, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(w), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = static_cast<long long>(p1) * ((kout + MM_BM - 1) / MM_BM) *
                          ((B + MM_BN - 1) / MM_BN);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  matmul_fold_kernel<<<grid, MM_THREADS, MM_SMEM, static_cast<cudaStream_t>(stream)>>>(
      wmap, static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), p1, kout,
      (K + 3) / 4, B);
  return static_cast<int>(cudaGetLastError());
}

// s (P+1, n) residues, frags (3, 2, 32) int4 fragments of G, negm (35) digits
// of -M mod p (host memory) -> out (16, n) limbs.
extern "C" int stark_crt_reconstruct(const void* s, const void* frags, void* out, int P,
                                     long long n, uint32_t qr, uint32_t minv,
                                     const int32_t* negm_digits,
                                     const uint32_t* field_words, uint32_t np,
                                     void* stream) {
  if (P > 32 * REC_KS) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    NegMDigits negm;
    for (int d = 0; d < ND; ++d) negm.d[d] = negm_digits[d];
    const long long rounds = (n + 31) / 32;
    const uint32_t mr = static_cast<uint32_t>((1ull << 32) / qr);
    reconstruct_kernel<<<resident_grid(reconstruct_kernel, REC_THREADS, 0, rounds),
                         REC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(s), static_cast<const int4*>(frags),
        static_cast<int32_t*>(out), P, n, rounds, qr, mr, minv, negm,
        stark::make_field(field_words, np));
  }
  return static_cast<int>(cudaGetLastError());
}
