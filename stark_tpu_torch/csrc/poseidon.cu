// Poseidon over BLS12-381's Fr, one permutation a thread: the tree levels of
// the l-tree and FRI's trees under digest="poseidon".
//
// The port's own kernel: the JAX package has no Pallas kernel here. Its
// device path (stark_tpu/ops/poseidon.py:147-213, `poseidon_permute_batch`
// under `poseidon_hash_pairs`) is an XLA lax.scan of the 63 rounds over
// (16, 3, N) limb planes, every product an `mmul` of the whole batch.
//
// Function: arity 2 (t = 3), 8 full and 55 partial rounds, domain tag 3,
// the digest state[1]. `poseidon_leaves`: out[:, i] = Poseidon(tag, v_i, 0),
// v_i the value in rows 0-7 of a (W, N) leaf buffer (the rest is blake block
// padding); `poseidon_pairs`: out[:, i] = Poseidon(tag, layer[:, 2i],
// layer[:, 2i + 1]) over an (8, 2m) layer. A value is 8 little-endian
// uint32 words, word k in row k: the layout of the blake2s trees, so a
// Poseidon layer is gathered and branched as theirs are.
//
// What bounds it on an H100: integer operations. A hash reads 64 bytes (32
// for a leaf), writes 32, and the least work it needs, the permutation's
// optimized form (sparse partial rounds, Grassi et al. 2021, Appendix B), is
// 416 8-word Montgomery products and 156 squarings: 4.38 ns a hash at the
// card's integer rate, against 0.03 ns for its bytes. This kernel runs the
// textbook rounds, 807 products (8 full rounds of 18, 55 partial of 12, 3
// conversions). A level narrower than the card's resident threads is bound
// by latency instead: a round's critical path is about 4 dependent products
// (the S-box's three, one of the MDS), 252 over the permutation, whatever
// the level's width.
// What the design does about it: one thread a hash, its state (3 x 8 words)
// in registers; the inputs are read straight from the packed words and taken
// into Montgomery form in the kernel (x R^2 mod p) and the digest out of it
// (x 1), so a tree level is one launch with no conversion or stride pass
// around it. The 189 round constants, the 9 MDS entries (Montgomery form),
// R^2 mod p and the tag (6,400 bytes, built on the host from the port's
// `ops/poseidon.py`: `kernel_table`, kept on the device by the wrapper) sit
// in __constant__ memory: every thread of a round reads the same address,
// which the constant cache broadcasts. Each launch copies the table in on
// its own stream first (device to device), so the copy is ordered before the
// kernel on any stream; concurrent launches write the same bytes. Partial
// rounds apply the S-box to state[0] alone. Products are `stark::mont_mul`
// (CIOS, field.cuh), valid for any input below 2^256 since 2p < 2^256, and
// canonical.
// Simple and right first: lanes a hash, the MDS as a wide sum reduced once
// and fused levels are later work.
#include "field.cuh"

namespace {

using stark::Field;
using stark::NW;

constexpr int T = 3, FULL = 8, PARTIAL = 55, ROUNDS = FULL + PARTIAL;
// table entries (8 words each): the round constants in consumption order,
// the MDS matrix row by row (M[i][j] at MDS0 + 3i + j), R^2 mod p, the tag
constexpr int MDS0 = T * ROUNDS;
constexpr int R2 = MDS0 + T * T;
constexpr int TAG = R2 + 1;
constexpr int ENTRIES = TAG + 1;
constexpr int THREADS = 128;

__constant__ uint32_t c_tab[ENTRIES * NW];

__device__ __forceinline__ void entry(int e, uint32_t w[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = c_tab[e * NW + k];
}

__device__ __forceinline__ void sbox(const Field& f, uint32_t x[NW]) {
  uint32_t x2[NW], x4[NW];
  stark::mont_mul(f, x, x, x2);
  stark::mont_mul(f, x2, x2, x4);
  stark::mont_mul(f, x4, x, x);
}

// s[j] <- sum_i M[i][j] s[i]
__device__ __forceinline__ void mds(const Field& f, uint32_t s[T][NW]) {
  uint32_t out[T][NW], m[NW], t[NW];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    entry(MDS0 + j, m);
    stark::mont_mul(f, s[0], m, out[j]);
#pragma unroll
    for (int i = 1; i < T; ++i) {
      entry(MDS0 + T * i + j, m);
      stark::mont_mul(f, s[i], m, t);
      stark::mod_add(f, out[j], t, out[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < T; ++j) stark::set_elem(s[j], out[j]);
}

template <bool PARTIAL_ROUND>
__device__ __forceinline__ void perm_round(const Field& f, int r, uint32_t s[T][NW]) {
  uint32_t c[NW];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    entry(T * r + i, c);
    stark::mod_add(f, s[i], c, s[i]);
  }
  if (PARTIAL_ROUND) {
    sbox(f, s[0]);
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) sbox(f, s[i]);
  }
  mds(f, s);
}

// n hashes; the inputs' rows are `ld` words apart, the output's n.
template <bool PAIRS>
__global__ void __launch_bounds__(THREADS)
poseidon_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int64_t n,
                int64_t ld, Field f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t col = PAIRS ? 2 * i : i;
  uint32_t s[T][NW], r2[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    s[1][k] = static_cast<uint32_t>(in[k * ld + col]);
    s[2][k] = PAIRS ? static_cast<uint32_t>(in[k * ld + col + 1]) : 0u;
  }
  entry(R2, r2);
  stark::mont_mul(f, s[1], r2, s[1]);
  if (PAIRS) stark::mont_mul(f, s[2], r2, s[2]);  // a leaf's 0 is 0 in either form
  entry(TAG, s[0]);
  int r = 0;
#pragma unroll 1
  for (; r < FULL / 2; ++r) perm_round<false>(f, r, s);
#pragma unroll 1
  for (; r < FULL / 2 + PARTIAL; ++r) perm_round<true>(f, r, s);
#pragma unroll 1
  for (; r < ROUNDS; ++r) perm_round<false>(f, r, s);
  uint32_t one[NW] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  stark::mont_mul(f, s[1], one, s[1]);
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k * n + i] = static_cast<int32_t>(s[1][k]);
}

template <bool PAIRS>
int launch(const void* in, void* out, long long n, long long ld, const uint32_t* table,
           const uint32_t* field_words, uint32_t np, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemcpyToSymbolAsync(c_tab, table, sizeof(c_tab), 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + THREADS - 1) / THREADS;
  poseidon_kernel<PAIRS><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), n, ld,
      stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: `kernel_table` on the device (ENTRIES x 8 words).
// leaf_words (W >= 8, ld) -> out (8, n): the leaf layer (n = ld).
extern "C" int stark_poseidon_leaves(const void* leaf_words, void* out, long long n,
                                     long long ld, const uint32_t* table,
                                     const uint32_t* field_words, uint32_t np,
                                     void* stream) {
  return launch<false>(leaf_words, out, n, ld, table, field_words, np, stream);
}

// layer (8, ld = 2n) -> out (8, n): one fold level.
extern "C" int stark_poseidon_pairs(const void* layer, void* out, long long n,
                                    long long ld, const uint32_t* table,
                                    const uint32_t* field_words, uint32_t np,
                                    void* stream) {
  return launch<true>(layer, out, n, ld, table, field_words, np, stream);
}
