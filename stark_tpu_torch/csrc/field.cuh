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

// Montgomery square in the radix-2^29 form with R' = 2^261: y*y*2^-261 mod
// p up to one p, for y < 2p and 4p < 2^261 (every field here): the 45
// distinct limb products (cross terms against doubled limbs) into 17 column
// accumulators, then 9 reduction rows that each add m_i p 2^(29i) with
// m_i = t_i n' mod 2^29 and carry t_i >> 29 into the next column. A column
// holds at most 9 products of 58 bits and 9 of the reduction: below 2^63.
// p29: p in 29-bit limbs; np29: -p^-1 mod 2^29.
__device__ __forceinline__ void mont_sqr29(const uint32_t p29[NL29], uint32_t np29,
                                           const uint32_t y[NL29], uint32_t r[NL29]) {
  uint64_t t[2 * NL29];
  uint32_t d[NL29];
#pragma unroll
  for (int i = 0; i < NL29; ++i) d[i] = y[i] << 1;
#pragma unroll
  for (int i = 0; i < 2 * NL29; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    t[2 * i] += static_cast<uint64_t>(y[i]) * y[i];
#pragma unroll
    for (int j = i + 1; j < NL29; ++j) t[i + j] += static_cast<uint64_t>(y[i]) * d[j];
  }
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

}  // namespace stark
