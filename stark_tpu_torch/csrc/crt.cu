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
// bytes, and matmul_fold reads four contraction steps per register with no
// transpose. Bytes bound the function (64 in, 2 per prime of pre-table, 2 per
// prime out, a lane): the table-by-bytes product is a (P+1, 32) x (32, N) int8
// matrix product, small at the tensor cores' rate, and the reductions and
// digits are ~7 integer operations a prime and lane, ~13 with a pre-table.
// This version forms the product on the CUDA cores instead, and those 16
// dp4a a prime and lane are what hold it above that bound; the table sits
// in shared memory and is read as 16-byte vectors to keep them fed.
//
// matmul_fold. All digits fit int8 (W in [-64, 63], x in [0, 127]), so the
// products run on the tensor cores' integer path, mma.sync m16n8k32
// s8 x s8 -> s32: sums are exact in int32 at any contraction length the
// wrapper admits, and the planes take half the bytes of bf16. A block of
// four warps owns a 64 x 64 tile of one prime's output and walks K in steps
// of 64 through shared memory (W rows with their K bytes contiguous, the
// stride 80 bytes; x as words of four k, the stride 72 words: both make the
// fragment loads conflict-free); a warp holds a 32 x 32 sub-tile as three
// accumulator sets, s00, s01 + s10 and s11, four mma a step each pair of
// fragments. The epilogue is the TPU kernel's: s00 + 128*fold(s01+s10) +
// delta*fold(s11) with fold(s) = (s >> 14)*delta + (s & 16383), |.| < 2^30 for
// K <= 1024, then Barrett to the canonical residue. Edges are zero-filled on
// load and masked on store, so any (kout, K, B) runs: no size gate. It is
// bound by operations (8*K*kout*B per prime against the int8 tensor-core
// rate); this first version neither overlaps loads with mma nor uses wgmma.
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

constexpr int MM_TM = 64;       // output rows of a block
constexpr int MM_TN = 64;       // output columns of a block
constexpr int MM_TK = 64;       // contraction rows of one shared-memory step
constexpr int MM_THREADS = 128;  // four warps, 2 x 2, 32 x 32 each
constexpr int MM_AS = MM_TK + 16;  // bytes of one W row in shared memory
constexpr int MM_BS = MM_TN + 8;   // words of one x row (four k) in shared memory

// D += A (16 x 32, row) * B (32 x 8, col), s8 x s8 -> s32. Lane (g = lane/4,
// t = lane%4) holds: a0 row g, k 4t..4t+3; a1 row g+8; a2, a3 the same rows
// at k+16; b0 column g, k 4t..4t+3; b1 at k+16; c0, c1 row g, columns 2t,
// 2t+1; c2, c3 row g+8.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(MM_THREADS)
matmul_fold_kernel(const int8_t* __restrict__ w0, const int8_t* __restrict__ w1,
                   const int32_t* __restrict__ x0, const int32_t* __restrict__ x1,
                   const int32_t* __restrict__ table, int32_t* __restrict__ out,
                   int kout, int K, int K4, int B) {
  __shared__ __align__(16) int8_t As[2][MM_TM * MM_AS];
  __shared__ __align__(16) int32_t Bs[2][(MM_TK / 4) * MM_BS];
  const int prime = blockIdx.z;
  const int m0 = blockIdx.y * MM_TM, n0 = blockIdx.x * MM_TN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int8_t* W[2] = {w0 + static_cast<int64_t>(prime) * kout * K,
                        w1 + static_cast<int64_t>(prime) * kout * K};
  const int32_t* X[2] = {x0 + static_cast<int64_t>(prime) * K4 * B,
                         x1 + static_cast<int64_t>(prime) * K4 * B};
  // 16-byte loads where every row starts on a 16-byte boundary
  const bool a_vec = K % 16 == 0, b_vec = B % 4 == 0;

  int acc00[2][4][4], accm[2][4][4], acc11[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc00[mi][ni][e] = accm[mi][ni][e] = acc11[mi][ni][e] = 0;

  for (int k0 = 0; k0 < 4 * K4; k0 += MM_TK) {
    // W tiles: 64 rows of four 16-byte chunks
    for (int c = tid; c < MM_TM * (MM_TK / 16); c += MM_THREADS) {
      const int row = c / (MM_TK / 16), kc = (c % (MM_TK / 16)) * 16;
      const int gm = m0 + row, gk = k0 + kc;
#pragma unroll
      for (int mat = 0; mat < 2; ++mat) {
        int4 v = make_int4(0, 0, 0, 0);
        if (gm < kout && gk < K) {
          const int8_t* src = W[mat] + static_cast<int64_t>(gm) * K + gk;
          if (a_vec) {
            v = *reinterpret_cast<const int4*>(src);
          } else {
            int8_t* dst = reinterpret_cast<int8_t*>(&v);
            for (int e = 0; e < 16 && gk + e < K; ++e) dst[e] = src[e];
          }
        }
        *reinterpret_cast<int4*>(&As[mat][row * MM_AS + kc]) = v;
      }
    }
    // x tiles: 16 rows (of four k each) of sixteen 4-word chunks
    for (int c = tid; c < (MM_TK / 4) * (MM_TN / 4); c += MM_THREADS) {
      const int row = c / (MM_TN / 4), nc = (c % (MM_TN / 4)) * 4;
      const int gk4 = k0 / 4 + row, gn = n0 + nc;
#pragma unroll
      for (int mat = 0; mat < 2; ++mat) {
        int4 v = make_int4(0, 0, 0, 0);
        if (gk4 < K4 && gn < B) {
          const int32_t* src = X[mat] + static_cast<int64_t>(gk4) * B + gn;
          if (b_vec) {
            v = *reinterpret_cast<const int4*>(src);
          } else {
            int32_t* dst = reinterpret_cast<int32_t*>(&v);
            for (int e = 0; e < 4 && gn + e < B; ++e) dst[e] = src[e];
          }
        }
        *reinterpret_cast<int4*>(&Bs[mat][row * MM_BS + nc]) = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MM_TK / 32; ++ks) {
      uint32_t a[2][2][4], bf[2][4][2];
#pragma unroll
      for (int mat = 0; mat < 2; ++mat) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int8_t* p = &As[mat][(wm + mi * 16 + g) * MM_AS + ks * 32 + t * 4];
          a[mat][mi][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mat][mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * MM_AS);
          a[mat][mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          a[mat][mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * MM_AS + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int32_t* p = &Bs[mat][(ks * 8 + t) * MM_BS + wn + ni * 8 + g];
          bf[mat][ni][0] = static_cast<uint32_t>(p[0]);
          bf[mat][ni][1] = static_cast<uint32_t>(p[4 * MM_BS]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_s8(acc00[mi][ni], a[0][mi], bf[0][ni]);
          mma_s8(accm[mi][ni], a[0][mi], bf[1][ni]);
          mma_s8(accm[mi][ni], a[1][mi], bf[0][ni]);
          mma_s8(acc11[mi][ni], a[1][mi], bf[1][ni]);
        }
    }
    __syncthreads();
  }

  const int32_t* row = table + prime * TABLE_ROW;
  const uint32_t q = row[16], m = row[17];
  const int d = row[19];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int c = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (r >= kout || c >= B) continue;
        int s11 = acc11[mi][ni][e];  // |.| <= K*64*127 < 2^23
        s11 = (s11 >> QBITS) * d + (s11 & QMASK);
        int sm = accm[mi][ni][e];  // |.| <= 2^24
        sm = (sm >> QBITS) * d + (sm & QMASK);
        int raw = acc00[mi][ni][e] + sm * 128 + d * s11;  // |.| < 2^30
        uint32_t v = static_cast<uint32_t>(raw) + (q << (30 - QBITS + 1));
        out[(static_cast<int64_t>(prime) * kout + r) * B + c] =
            static_cast<int32_t>(barrett(v, q, m));
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

// w0, w1 (p1, kout, K) int8; x0, x1 (p1, ceil(K/4), B) packed digit planes;
// table (p1, 20) -> out (p1, kout, B) canonical residues.
extern "C" int stark_crt_matmul_fold(const void* w0, const void* w1,
                                     const void* x0, const void* x1,
                                     const void* table, void* out, int p1,
                                     int kout, int K, int B, void* stream) {
  if (p1 > 0 && kout > 0 && B > 0) {
    dim3 grid((B + MM_TN - 1) / MM_TN, (kout + MM_TM - 1) / MM_TM, p1);
    matmul_fold_kernel<<<grid, MM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(w0), static_cast<const int8_t*>(w1),
        static_cast<const int32_t*>(x0), static_cast<const int32_t*>(x1),
        static_cast<const int32_t*>(table), static_cast<int32_t*>(out), kout, K,
        (K + 3) / 4, B);
  }
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
