// Batched Blake2s-256 over N equal-length messages.
//
// Replaces the TPU kernel stark_tpu/ops/pallas_blake2s.py:84 `blake2s_words`
// (all 10 rounds unrolled over (W, 1024) VMEM tiles of message words).
// Standard unkeyed Blake2s-256 (h0 ^= 0x01010020), identical to hashlib.
//
// Layout: msgs (W, N) int32 words (W = 16 * nblocks, zero-padded blocks,
// little-endian bytes within a word), digests (8, N) int32 words.
//
// What bounds it on an H100: integer throughput at 64-byte messages (one
// compression of ~900 32-bit add/xor/rotate operations per 64 bytes read)
// and device memory for the 256-byte m-tree leaves read once per digest.
// What the design does about it: one thread per message; thread i reads
// column i of each word row, so a warp's loads of one row are one
// contiguous 128-byte segment. The state and the 16 message words live in
// registers: the rounds are unrolled with SIGMA as literal indices (the
// ROUND macro), so no message word is ever indexed at run time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

#define G(a, b, c, d, x, y) \
  a = a + b + (x);          \
  d = rotr(d ^ a, 16);      \
  c = c + d;                \
  b = rotr(b ^ c, 12);      \
  a = a + b + (y);          \
  d = rotr(d ^ a, 8);       \
  c = c + d;                \
  b = rotr(b ^ c, 7);

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  G(v0, v4, v8, v12, m[s0], m[s1])                                                  \
  G(v1, v5, v9, v13, m[s2], m[s3])                                                  \
  G(v2, v6, v10, v14, m[s4], m[s5])                                                 \
  G(v3, v7, v11, v15, m[s6], m[s7])                                                 \
  G(v0, v5, v10, v15, m[s8], m[s9])                                                 \
  G(v1, v6, v11, v12, m[s10], m[s11])                                               \
  G(v2, v7, v8, v13, m[s12], m[s13])                                                \
  G(v3, v4, v9, v14, m[s14], m[s15])

constexpr uint32_t IV0 = 0x6A09E667u, IV1 = 0xBB67AE85u, IV2 = 0x3C6EF372u,
                   IV3 = 0xA54FF53Au, IV4 = 0x510E527Fu, IV5 = 0x9B05688Cu,
                   IV6 = 0x1F83D9ABu, IV7 = 0x5BE0CD19u;

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16],
                                         uint64_t t, bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  uint32_t v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = IV0, v9 = IV1, v10 = IV2, v11 = IV3;
  uint32_t v12 = IV4 ^ static_cast<uint32_t>(t);
  uint32_t v13 = IV5 ^ static_cast<uint32_t>(t >> 32);
  uint32_t v14 = last ? ~IV6 : IV6;
  uint32_t v15 = IV7;
  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

__global__ void blake2s_kernel(const int32_t* __restrict__ msgs,
                               int32_t* __restrict__ out, int64_t n,
                               int nblocks, int64_t msg_len) {
  int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t h[8] = {IV0 ^ 0x01010020u, IV1, IV2, IV3, IV4, IV5, IV6, IV7};
  for (int blk = 0; blk < nblocks; ++blk) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      m[i] = static_cast<uint32_t>(msgs[(blk * 16 + i) * n + col]);
    const bool last = blk == nblocks - 1;
    const uint64_t t = last ? static_cast<uint64_t>(msg_len)
                            : static_cast<uint64_t>(blk + 1) * 64;
    compress(h, m, t, last);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i * n + col] = static_cast<int32_t>(h[i]);
}

}  // namespace

extern "C" int stark_blake2s_words(const void* msgs, void* out, long long n,
                                   int nblocks, long long msg_len,
                                   void* stream) {
  if (n > 0) {
    const int threads = 128;
    const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
    blake2s_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(msgs), static_cast<int32_t*>(out), n,
        nblocks, msg_len);
  }
  return static_cast<int>(cudaGetLastError());
}
