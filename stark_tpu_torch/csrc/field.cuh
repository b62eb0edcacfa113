// Montgomery field arithmetic shared by the field and NTT kernels.
//
// Interchange layout (the JAX package's): limbs-first (16, n) int32 planes,
// 16-bit limbs, little-endian limb order, Montgomery form with R = 2^256.
// Inside a thread an element is 8 packed 32-bit words, so one product is an
// 8-word CIOS Montgomery multiply on 32x32->64-bit products instead of the
// TPU's 16x16-bit schoolbook plus REDC. Same R, so the same canonical output.
//
// The modulus p (8 words), Montgomery one R mod p (8 words) and
// n' = -p^-1 mod 2^32 arrive as a kernel argument built from the caller's
// FieldSpec; nothing here is BN254-specific beyond the width (p < 2^255, so
// 2p fits in 8 words).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stark {

constexpr int NW = 8;      // 32-bit words per element
constexpr int LIMBS = 16;  // 16-bit limbs per element in the planes

struct Field {
  uint32_t p[NW];
  uint32_t one[NW];  // R mod p: the Montgomery form of 1
  uint32_t np;       // -p^-1 mod 2^32
};

// Host helper: copy the C-ABI field words (p, then R mod p: 16 words) into a
// by-value kernel argument.
inline Field make_field(const uint32_t* field_words, uint32_t np) {
  Field f;
  for (int i = 0; i < NW; ++i) {
    f.p[i] = field_words[i];
    f.one[i] = field_words[NW + i];
  }
  f.np = np;
  return f;
}

// Element `col` of a (16, n) plane -> 8 packed words; also column `col` of a
// small (16, k) operand (coefficients, points, challenges) with n = k.
__device__ __forceinline__ void load_elem(const int32_t* __restrict__ planes,
                                          int64_t n, int64_t col,
                                          uint32_t w[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t lo = static_cast<uint32_t>(planes[(2 * i) * n + col]);
    uint32_t hi = static_cast<uint32_t>(planes[(2 * i + 1) * n + col]);
    w[i] = (lo & 0xFFFFu) | (hi << 16);
  }
}

__device__ __forceinline__ void set_elem(uint32_t w[NW], const uint32_t v[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = v[i];
}

__device__ __forceinline__ void store_elem(int32_t* __restrict__ planes,
                                           int64_t n, int64_t col,
                                           const uint32_t w[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    planes[(2 * i) * n + col] = static_cast<int32_t>(w[i] & 0xFFFFu);
    planes[(2 * i + 1) * n + col] = static_cast<int32_t>(w[i] >> 16);
  }
}

// r = a - p if a (with `top` as bit 256) is >= p, else a.
__device__ __forceinline__ void cond_sub_p(const Field& f, uint32_t top,
                                           uint32_t a[NW]) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(a[i]) - f.p[i] - borrow;
    d[i] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1u;
  }
  // a >= p exactly when the subtraction did not borrow past bit 256, or
  // the value had a 257th bit to borrow from.
  bool ge = (borrow == 0) || (top != 0);
#pragma unroll
  for (int i = 0; i < NW; ++i) a[i] = ge ? d[i] : a[i];
}

// Montgomery product r = a*b*2^-256 mod p (CIOS). Valid for a*b < 2^256*p,
// which covers a, b < p and the transcript's a < 2^256, b < p embedding;
// the result is canonical.
__device__ __forceinline__ void mont_mul(const Field& f, const uint32_t a[NW],
                                         const uint32_t b[NW], uint32_t r[NW]) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = static_cast<uint64_t>(a[j]) * b[i] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[NW]) + c;
    t[NW] = static_cast<uint32_t>(s);
    t[NW + 1] = static_cast<uint32_t>(s >> 32);

    uint32_t m = t[0] * f.np;
    s = static_cast<uint64_t>(m) * f.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = static_cast<uint64_t>(m) * f.p[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[NW]) + c;
    t[NW - 1] = static_cast<uint32_t>(s);
    t[NW] = t[NW + 1] + static_cast<uint32_t>(s >> 32);
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = t[i];
  cond_sub_p(f, t[NW], r);
}

// The radix-2^29 form: 9 limbs of 29 bits (261 bits), so that a column of
// word products and its reduction terms sum in one 64-bit accumulator
// without carries between them (IMAD.WIDE with a 64-bit addend).
constexpr int NL29 = 9;
constexpr uint32_t MASK29 = (1u << 29) - 1;

// 8 words -> 9 limbs of 29 bits
__device__ __forceinline__ void to_limbs29(const uint32_t w[NW], uint32_t l[NL29]) {
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    const int bit = 29 * i, word = bit / 32, sh = bit % 32;
    uint32_t v = w[word] >> sh;
    if (sh > 3 && word + 1 < NW) v |= w[word + 1] << (32 - sh);
    l[i] = v & MASK29;
  }
}

// 9 limbs of 29 bits (a value below 2^256) -> 8 words
__device__ __forceinline__ void from_limbs29(const uint32_t l[NL29], uint32_t w[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int bit = 32 * j, i = bit / 29, sh = bit % 29;
    uint32_t v = l[i] >> sh;
    if (i + 1 < NL29) v |= l[i + 1] << (29 - sh);
    if (sh > 26 && i + 2 < NL29) v |= l[i + 2] << (58 - sh);
    w[j] = v;
  }
}

// The radix-2^29 form's sums (R' = 2^261): a sum of products c*y of 9-limb
// values accumulates in COLS29 64-bit columns (`mac29`: column k holds the
// limb products of weight 2^(29k), one IMAD.WIDE each), values times 2^261
// at columns 9..17 (`add_shifted29`), and `redc29` reduces it: 9 rows that
// each add m_i p 2^(29i) with m_i = t_i n' mod 2^29 and carry t_i >> 29
// into the next column leave r = t*2^-261 mod p up to a multiple of p,
// r < t/2^261 + p, its limbs normalised. With limbs below 2^29, a column of
// k products and the reduction's 9 stays below (k + 9) 2^58 plus a carry
// below 2^35: below 2^64 for k <= 54. r must be below 2^261 (the caller's
// bound). p29: p in 29-bit limbs; np29: -p^-1 mod 2^29.
constexpr int COLS29 = 2 * NL29;

__device__ __forceinline__ void clear29(uint64_t (&t)[COLS29]) {
#pragma unroll
  for (int k = 0; k < COLS29; ++k) t[k] = 0;
}

__device__ __forceinline__ void mac29(uint64_t (&t)[COLS29], const uint32_t (&c)[NL29],
                                      const uint32_t (&y)[NL29]) {
#pragma unroll
  for (int i = 0; i < NL29; ++i)
#pragma unroll
    for (int j = 0; j < NL29; ++j) t[i + j] += static_cast<uint64_t>(c[i]) * y[j];
}

__device__ __forceinline__ void add_shifted29(uint64_t (&t)[COLS29], const uint32_t (&c)[NL29]) {
#pragma unroll
  for (int i = 0; i < NL29; ++i) t[NL29 + i] += c[i];
}

__device__ __forceinline__ void redc29(const uint32_t p29[NL29], uint32_t np29,
                                       uint64_t (&t)[COLS29], uint32_t r[NL29]) {
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

// Montgomery square in the radix-2^29 form: r = y*y*2^-261 mod p up to a
// multiple of p, r < y^2/2^261 + p, for any y whose 9 limbs are below 2^29
// (so r < 2p where y < 2p and 4p < 2^261, every field here); the caller
// keeps r below 2^261. The 45 distinct limb products (cross terms against
// doubled limbs) go into the 17 columns, which `redc29` reduces: a column
// holds at most 9 products of 58 bits and 9 of the reduction, below 2^63.
__device__ __forceinline__ void mont_sqr29(const uint32_t p29[NL29], uint32_t np29,
                                           const uint32_t y[NL29], uint32_t r[NL29]) {
  uint64_t t[COLS29];
  uint32_t d[NL29];
#pragma unroll
  for (int i = 0; i < NL29; ++i) d[i] = y[i] << 1;
  clear29(t);
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    t[2 * i] += static_cast<uint64_t>(y[i]) * y[i];
#pragma unroll
    for (int j = i + 1; j < NL29; ++j) t[i + j] += static_cast<uint64_t>(y[i]) * d[j];
  }
  redc29(p29, np29, t, r);
}

// Shoup product by a constant: w < p is a plain (non-Montgomery) value and
// wp = floor(w * 2^256 / p) its companion. r = w*x - q*p with
// q = floor(wp*x / 2^256) equals w*x mod p up to one subtraction of p:
// 0 <= r < p + x*p/2^256, so r < 2p for any x < 2^256. A Montgomery x stays
// Montgomery: w*(xR) = (wx)R. q is exact (the whole high half of the 16-word
// product), the two other products need their low 8 words only, and 2p < 2^256
// makes the difference mod 2^256 the true difference.
__device__ __forceinline__ void shoup_mul(const Field& f, const uint32_t w[NW],
                                          const uint32_t wp[NW],
                                          const uint32_t x[NW], uint32_t r[NW]) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = static_cast<uint64_t>(wp[j]) * x[i] + t[i + j] + c;
      t[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    t[i + NW] = static_cast<uint32_t>(c);
  }
  // lo = (w*x mod 2^256) - (q*p mod 2^256), word by word with a borrow
  uint32_t wx[NW], qp[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) wx[i] = qp[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0, d = 0;
#pragma unroll
    for (int j = 0; i + j < NW; ++j) {
      uint64_t s = static_cast<uint64_t>(w[j]) * x[i] + wx[i + j] + c;
      wx[i + j] = static_cast<uint32_t>(s);
      c = s >> 32;
      uint64_t u = static_cast<uint64_t>(f.p[j]) * t[NW + i] + qp[i + j] + d;
      qp[i + j] = static_cast<uint32_t>(u);
      d = u >> 32;
    }
  }
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t s = static_cast<uint64_t>(wx[i]) - qp[i] - borrow;
    r[i] = static_cast<uint32_t>(s);
    borrow = (s >> 32) & 1u;
  }
}

// (a + b) mod p for a, b < p.
__device__ __forceinline__ void mod_add(const Field& f, const uint32_t a[NW],
                                        const uint32_t b[NW], uint32_t r[NW]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t s = static_cast<uint64_t>(a[i]) + b[i] + c;
    r[i] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
  cond_sub_p(f, static_cast<uint32_t>(c), r);
}

// (a - b) mod p for a, b < p: subtract, and add p back on a borrow.
__device__ __forceinline__ void mod_sub(const Field& f, const uint32_t a[NW],
                                        const uint32_t b[NW], uint32_t r[NW]) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = static_cast<uint64_t>(a[i]) - b[i] - borrow;
    r[i] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1u;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint64_t s = static_cast<uint64_t>(r[i]) + f.p[i] + c;
      r[i] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
  }
}

// --- wide sums: products summed in 17 words, reduced once ----------------
//
// A sum of products c*v (512 bits each) and of values shifted up 256 bits
// accumulates in WIDE words (`mac_wide`, `add_shifted`); one Montgomery
// reduction (`redc_wide`) and subtractions of multiples of p
// (`redc_canonical`) then make it canonical. A wide product without its
// reduction costs ~2.8 SM clocks a thread at full occupancy on an H100, a
// CIOS product ~7.4 (scripts/protocol_kernels_cuda.py). Each caller states
// the bound that keeps its sum below 2^544 and its REDC below 8p.

constexpr int WIDE = 2 * NW + 1;  // words of the lazy sum

// acc += c*v*2^(32B) over the 17 words, as two PTX carry chains (low halves
// at words B..B+7, high halves at B+1..B+8). The carry out of word B + 8 is
// deferred: `pend` (at most 2) is owed at word B + 8 on entry, where this
// row adds it, and at word B + 9 on exit, where the next row (B + 1) adds it;
// after row 7 it is owed at word 16. acc + pend*2^(32(B+9)) is the true sum
// throughout.
template <int B>
__device__ __forceinline__ void mac_row(uint32_t (&acc)[WIDE], uint32_t& pend,
                                        const uint32_t (&c)[NW], uint32_t v) {
  asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32 %8, %8, %9;\n\t"
      "addc.u32 %9, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(acc[B]), "+r"(acc[B + 1]), "+r"(acc[B + 2]), "+r"(acc[B + 3]),
        "+r"(acc[B + 4]), "+r"(acc[B + 5]), "+r"(acc[B + 6]), "+r"(acc[B + 7]),
        "+r"(acc[B + 8]), "+r"(pend)
      : "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4]), "r"(c[5]),
        "r"(c[6]), "r"(c[7]), "r"(v));
}

// acc += c*v, the whole 512-bit product; the sum must stay below 2^544.
__device__ __forceinline__ void mac_wide(uint32_t (&acc)[WIDE],
                                         const uint32_t (&c)[NW],
                                         const uint32_t (&v)[NW]) {
  uint32_t pend = 0;
  mac_row<0>(acc, pend, c, v[0]);
  mac_row<1>(acc, pend, c, v[1]);
  mac_row<2>(acc, pend, c, v[2]);
  mac_row<3>(acc, pend, c, v[3]);
  mac_row<4>(acc, pend, c, v[4]);
  mac_row<5>(acc, pend, c, v[5]);
  mac_row<6>(acc, pend, c, v[6]);
  mac_row<7>(acc, pend, c, v[7]);
  acc[2 * NW] += pend;
}

// Montgomery reduction of the lazy sum: acc + m*p with m < 2^256 chosen
// word by word so that words 0..7 vanish; words 8..16 are then
// T = acc*2^-256 mod p up to multiples of p, T < acc/2^256 + p.
__device__ __forceinline__ void redc_wide(const Field& f, uint32_t (&acc)[WIDE]) {
  uint32_t pend = 0;
  mac_row<0>(acc, pend, f.p, acc[0] * f.np);
  mac_row<1>(acc, pend, f.p, acc[1] * f.np);
  mac_row<2>(acc, pend, f.p, acc[2] * f.np);
  mac_row<3>(acc, pend, f.p, acc[3] * f.np);
  mac_row<4>(acc, pend, f.p, acc[4] * f.np);
  mac_row<5>(acc, pend, f.p, acc[5] * f.np);
  mac_row<6>(acc, pend, f.p, acc[6] * f.np);
  mac_row<7>(acc, pend, f.p, acc[7] * f.np);
  acc[2 * NW] += pend;
}

// t -= m where t >= m, over 9 words
__device__ __forceinline__ void sub_if_ge9(uint32_t (&t)[NW + 1],
                                           const uint32_t (&m)[NW + 1]) {
  uint32_t d[NW + 1], borrow;
  asm("sub.cc.u32 %0, %10, %19;\n\t"
      "subc.cc.u32 %1, %11, %20;\n\t"
      "subc.cc.u32 %2, %12, %21;\n\t"
      "subc.cc.u32 %3, %13, %22;\n\t"
      "subc.cc.u32 %4, %14, %23;\n\t"
      "subc.cc.u32 %5, %15, %24;\n\t"
      "subc.cc.u32 %6, %16, %25;\n\t"
      "subc.cc.u32 %7, %17, %26;\n\t"
      "subc.cc.u32 %8, %18, %27;\n\t"
      "subc.u32 %9, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
        "=r"(d[6]), "=r"(d[7]), "=r"(d[8]), "=r"(borrow)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(m[0]), "r"(m[1]), "r"(m[2]),
        "r"(m[3]), "r"(m[4]), "r"(m[5]), "r"(m[6]), "r"(m[7]), "r"(m[8]));
#pragma unroll
  for (int w = 0; w <= NW; ++w) t[w] = borrow ? t[w] : d[w];
}

// t < 8p (9 words) -> t mod p: take away 4p, 2p and p where t is not below.
__device__ __forceinline__ void reduce_below_8p(const Field& f,
                                                uint32_t (&t)[NW + 1]) {
#pragma unroll
  for (int s = 2; s >= 0; --s) {
    uint32_t m[NW + 1];
    m[0] = f.p[0] << s;
#pragma unroll
    for (int w = 1; w < NW; ++w) m[w] = s ? __funnelshift_l(f.p[w - 1], f.p[w], s) : f.p[w];
    m[NW] = s ? f.p[NW - 1] >> (32 - s) : 0;
    sub_if_ge9(t, m);
  }
}

// acc += c*2^256: c's words at words 8..15, the carry into word 16.
__device__ __forceinline__ void add_shifted(uint32_t (&acc)[WIDE], const uint32_t (&c)[NW]) {
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]), "+r"(acc[12]),
        "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15]), "+r"(acc[16])
      : "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4]), "r"(c[5]),
        "r"(c[6]), "r"(c[7]));
}

// r = acc*2^-256 mod p, canonical, for a wide sum whose REDC stays below 8p
// (protocol.cu's bound on G).
__device__ __forceinline__ void redc_canonical(const Field& f, uint32_t (&acc)[WIDE],
                                               uint32_t (&r)[NW]) {
  redc_wide(f, acc);
  uint32_t t[NW + 1];
#pragma unroll
  for (int w = 0; w <= NW; ++w) t[w] = acc[NW + w];
  reduce_below_8p(f, t);
#pragma unroll
  for (int w = 0; w < NW; ++w) r[w] = t[w];
}

}  // namespace stark
