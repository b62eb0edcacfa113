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
// residues_in. The residue of a 256-bit value v = sum_l byte_l * 256^l is
// raw = sum_l Cb[i][l] * byte_l reduced mod q_i, Cb the balanced residue of
// 256^l, |raw| < 2^27. A thread owns four lanes (k .. k+3, b) of the (K, B)
// operand, keeps their 32 bytes as 8 packed words each, and for each prime
// forms raw with 16 dp4a instructions a lane: Cb = c0 + 128*c1 with c0, c1
// in [-64, 63] packed four to a word, the data bytes offset by -128 to make
// them signed (the row's constant 128 * sum_l Cb[l] puts that back). The
// reduction is one Barrett step with floor(2^32 / q), exact for any 32-bit
// value up to one conditional subtraction, then the product with the
// pre-table residue (< 2^28) and a second step. The four lanes' digits leave
// as one word per plane, (P+1, K/4, B) int32: a warp writes 128 contiguous
// bytes, and matmul_fold's producer moves each word, four contraction steps,
// into its K-major tile with one 4-byte copy. Bytes bound the function (64
// in, 2 per prime of pre-table, 2 per prime out, a lane): the table-by-bytes
// product is a (P+1, 32) x (32, N) int8 matrix product, small at the tensor
// cores' rate, and the reductions and digits are ~7 integer operations a
// prime and lane, ~13 with a pre-table.
// This version forms the product on the CUDA cores instead, and those 16
// dp4a a prime and lane are what hold it above that bound; the table sits
// in shared memory and is read as 16-byte vectors to keep them fed.
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
// reconstruct. With s_i the t-scaled residues, the value is REDC(Y),
// Y = sum_i gp_i*s_i + k*(-M mod p), gp_i = (M/q_i) mod p, and the wrap
// count k = ((sum_i grr_i*s_i - s_r) * M^-1) mod q_r from the redundant
// prime. A thread owns one lane: it accumulates Y in 9 words (s_i < 2^14,
// k < 2^14 and the at most 57 primes of a basis give Y < 2^275; the 9 words
// hold any basis below 2^19 primes) from the (P+1, 8)-word table in
// shared memory, runs the word-wise Montgomery reduction of field.cuh's
// style (8 rounds), and subtracts p once: u = (Y + m*p)/R < Y/R + p
// < 2^19 + p < 2p, so one conditional subtraction is canonical. Bytes bound
// it (4 per prime in, 64 out, a lane).
#include <cuda.h>

#include "field.cuh"

namespace {

using stark::Field;
using stark::NW;

constexpr int QBITS = 14;
constexpr int QMASK = (1 << QBITS) - 1;
// words of one prime's table row: 8 of c0, 8 of c1, q, floor(2^32/q),
// 128 * sum_l Cb[l], delta = 2^14 - q
constexpr int TABLE_ROW = 20;

// v mod q for any 32-bit v, with m = floor(2^32 / q): the quotient estimate
// is the true one or one less.
__device__ __forceinline__ uint32_t barrett(uint32_t v, uint32_t q, uint32_t m) {
  uint32_t r = v - __umulhi(v, m) * q;
  return r >= q ? r - q : r;
}

// ---------------------------------------------------------------------------
// residues_in
// ---------------------------------------------------------------------------

constexpr int RIN_THREADS = 128;

template <bool HAS_PRE>
__global__ void __launch_bounds__(RIN_THREADS)
residues_in_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ table,
                   const int16_t* __restrict__ pre, int32_t* __restrict__ o0,
                   int32_t* __restrict__ o1, int p1, int64_t K, int64_t K4,
                   int64_t B) {
  extern __shared__ __align__(16) int32_t tab[];
  for (int i = threadIdx.x; i < p1 * TABLE_ROW; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= K4 * B) return;
  const int64_t k4 = idx / B, b = idx % B, n = K * B;
  uint32_t w[4][NW];
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    live[j] = 4 * k4 + j < K;
    if (live[j]) {
      stark::load_elem(x, n, (4 * k4 + j) * B + b, w[j]);
#pragma unroll
      for (int t = 0; t < NW; ++t) w[j][t] ^= 0x80808080u;  // byte - 128, signed
    } else {
#pragma unroll
      for (int t = 0; t < NW; ++t) w[j][t] = 0;
    }
  }
  for (int i = 0; i < p1; ++i) {
    const int4* row = reinterpret_cast<const int4*>(tab + i * TABLE_ROW);
    int cw[TABLE_ROW];
#pragma unroll
    for (int v = 0; v < TABLE_ROW / 4; ++v) {
      int4 c = row[v];
      cw[4 * v] = c.x;
      cw[4 * v + 1] = c.y;
      cw[4 * v + 2] = c.z;
      cw[4 * v + 3] = c.w;
    }
    const uint32_t q = cw[16], m = cw[17];
    uint32_t d0 = 0, d1 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int a0 = 0, a1 = 0;
#pragma unroll
      for (int t = 0; t < NW; ++t) {
        a0 = __dp4a(static_cast<int>(w[j][t]), cw[t], a0);
        a1 = __dp4a(static_cast<int>(w[j][t]), cw[NW + t], a1);
      }
      int raw = a0 + a1 * 128 + cw[18];  // |raw| < 2^27
      uint32_t r = barrett(static_cast<uint32_t>(raw) + (q << QBITS), q, m);
      if (HAS_PRE && live[j]) {
        uint32_t t = static_cast<uint16_t>(
            pre[static_cast<int64_t>(i) * n + (4 * k4 + j) * B + b]);
        r = barrett(r * t, q, m);  // < 2^28
      }
      if (!live[j]) r = 0;
      d0 |= (r & 127u) << (8 * j);
      d1 |= (r >> 7) << (8 * j);
    }
    int64_t o = (static_cast<int64_t>(i) * K4 + k4) * B + b;
    o0[o] = static_cast<int32_t>(d0);
    o1[o] = static_cast<int32_t>(d1);
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

constexpr int REC_THREADS = 128;

// y (NW + 2 words) += a (NW words) * s
__device__ __forceinline__ void mul_add_word(uint32_t y[NW + 2],
                                             const uint32_t* __restrict__ a,
                                             uint32_t s) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t v = static_cast<uint64_t>(a[j]) * s + y[j] + c;
    y[j] = static_cast<uint32_t>(v);
    c = v >> 32;
  }
  uint64_t v = static_cast<uint64_t>(y[NW]) + c;
  y[NW] = static_cast<uint32_t>(v);
  y[NW + 1] += static_cast<uint32_t>(v >> 32);
}

__global__ void __launch_bounds__(REC_THREADS)
reconstruct_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ gp,
                   const int32_t* __restrict__ grr, int32_t* __restrict__ out,
                   int P, int64_t n, uint32_t qr, uint32_t minv, Field f) {
  extern __shared__ __align__(16) uint32_t sh[];  // (P+1)*8 words of gp, P of grr
  uint32_t* sgp = sh;
  uint32_t* sgrr = sh + (P + 1) * NW;
  for (int i = threadIdx.x; i < (P + 1) * NW; i += blockDim.x)
    sgp[i] = static_cast<uint32_t>(gp[i]);
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    sgrr[i] = static_cast<uint32_t>(grr[i]);
  __syncthreads();
  int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  uint32_t y[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) y[j] = 0;
  uint64_t ksum = 0;
  for (int i = 0; i < P; ++i) {
    uint32_t si = static_cast<uint32_t>(s[static_cast<int64_t>(i) * n + lane]);
    ksum += static_cast<uint64_t>(sgrr[i]) * si;
    mul_add_word(y, sgp + i * NW, si);
  }
  // wrap count: k = ((sum_i grr_i*s_i - s_r) * M^-1) mod q_r, canonical
  int64_t kd = static_cast<int64_t>(ksum % qr) -
               static_cast<int64_t>(static_cast<uint32_t>(s[static_cast<int64_t>(P) * n + lane]));
  kd %= static_cast<int64_t>(qr);
  if (kd < 0) kd += qr;
  uint32_t k = static_cast<uint32_t>(static_cast<uint64_t>(kd) * minv % qr);
  mul_add_word(y, sgp + P * NW, k);

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
  stark::store_elem(out, n, lane, y);
}

inline unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// x (16, K, B) limb planes, table (p1, 20), pre (p1, K, B) int16 or null ->
// o0, o1 (p1, ceil(K/4), B) packed digit planes.
extern "C" int stark_crt_residues_in(const void* x, const void* table,
                                     const void* pre, void* o0, void* o1, int p1,
                                     long long K, long long B, void* stream) {
  long long K4 = (K + 3) / 4;
  if (K4 * B > 0) {
    size_t shared = static_cast<size_t>(p1) * TABLE_ROW * sizeof(int32_t);
    auto st = static_cast<cudaStream_t>(stream);
    unsigned blocks = blocks_for(K4 * B, RIN_THREADS);
    if (pre != nullptr)
      residues_in_kernel<true><<<blocks, RIN_THREADS, shared, st>>>(
          static_cast<const int32_t*>(x), static_cast<const int32_t*>(table),
          static_cast<const int16_t*>(pre), static_cast<int32_t*>(o0),
          static_cast<int32_t*>(o1), p1, K, K4, B);
    else
      residues_in_kernel<false><<<blocks, RIN_THREADS, shared, st>>>(
          static_cast<const int32_t*>(x), static_cast<const int32_t*>(table),
          nullptr, static_cast<int32_t*>(o0), static_cast<int32_t*>(o1), p1, K,
          K4, B);
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

// s (P+1, n) residues, gp (P+1, 8) words, grr (P) -> out (16, n) limbs.
extern "C" int stark_crt_reconstruct(const void* s, const void* gp,
                                     const void* grr, void* out, int P,
                                     long long n, uint32_t qr, uint32_t minv,
                                     const uint32_t* field_words, uint32_t np,
                                     void* stream) {
  if (n > 0) {
    size_t shared = (static_cast<size_t>(P + 1) * NW + P) * sizeof(uint32_t);
    reconstruct_kernel<<<blocks_for(n, REC_THREADS), REC_THREADS, shared,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(s), static_cast<const int32_t*>(gp),
        static_cast<const int32_t*>(grr), static_cast<int32_t*>(out), P, n, qr,
        minv, stark::make_field(field_words, np));
  }
  return static_cast<int>(cudaGetLastError());
}
