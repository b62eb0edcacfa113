// Poseidon over BLS12-381's Fr: the tree levels of the l-tree and FRI's trees
// under digest="poseidon", in two forms, builds of one source over one table:
// a thread a hash (wide levels) and a group of 4 lanes a hash (narrow ones).
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
// uint32 words, word k in row k: the layout of the blake2s trees. An input
// at or above p counts as its residue (the plain version's product by R^2).
//
// What bounds it on an H100: integer operations on wide levels, one hash's
// chain of dependent operations on narrow ones. A hash reads 64 bytes (32
// for a leaf) and writes 32; the least work it needs is the permutation's
// optimized form, 416 products and 156 squarings (412 and 154 a leaf).
// What the design does about it:
// - The optimized form (Grassi et al., "Poseidon", USENIX Security 2021,
//   Appendix B; `ops/poseidon.py sparse_form`): the partial rounds'
//   constants moved onto state[0], their matrices sparse (a00, row0, col0:
//   5 products, not 9), round 3's matrix the pre-matrix; round 0 S-boxes the
//   input lanes alone (the tag lane, and a leaf's lane 2, give constants);
//   the last round forms the output row alone.
// - Every value is 9 limbs of 29 bits in Montgomery form for R' = 2^261
//   (field.cuh's radix-2^29 form): a product's limb products go into 64-bit
//   column sums, one IMAD.WIDE each, with no carry chain between them, and
//   one reduction (`redc29`) carries them once. An S-box is two squarings
//   (`mont_sqr29`) and a product; each row of a matrix is one sum of its
//   products and of the next round's constant shifted up 261 bits,
//   reduced once.
// - Values stay lazy: a reduction leaves t/2^261 + p, and 2^261 is 70.66p,
//   so no subtraction runs but one for the digest. The largest any value
//   gets is 58.9p (state[1] and state[2] across the partial rounds, each of
//   which adds col0 x0 R'^-1 + p to them); worst-case bounds, round by
//   round, in tests/test_torch_poseidon_plan.py.
// - No conversion: round 0 takes the inputs plain (an S-box of v gives
//   v^5 R'^-4, so its matrix entries are A R'^6), and the output row's
//   entries A[1] leave the digest plain; one conditional subtraction of p
//   makes it canonical.
// - The table (`kernel_table`, 388 entries of 9 limbs and 3 words of
//   padding, 18,624 bytes) is staged in shared memory once a block from the
//   wrapper's device buffer: no copy into a constant symbol ahead of each
//   launch, and no constant-cache misses where warps walk it many rounds
//   apart. In the thread form a warp reads one entry (a broadcast).
// - The thread form's rounds 1-61 are one loop over one code path each for
//   full and partial rounds (a full round's S-boxes and rows in loops that
//   rotate the three values): the same code fully unrolled made nvcc fail.
// The lane form (LANE): lane i < 3 of a group holds state[i] (lane 3 repeats
// lane 0), 8 hashes a warp. Every round each lane S-boxes its own element
// (in a partial round rows 1 and 2 keep theirs), gathers the group's three
// values by width-4 `__shfl_sync` (9 limbs each) and forms its own row: a
// partial round's rows 1 and 2 as col0 x0 + R' s (the table's Montgomery
// one) + 0 s', the same three products as every other row, so the lanes
// never diverge. A round's chain is one S-box and one row, where the thread
// form's full round is three of each. A warp wholly past the level returns;
// a ragged group computes on zeros and neither loads nor stores.
#include "field.cuh"

namespace {

using stark::COLS29;
using stark::NL29;
using stark::NW;

constexpr int T = 3, HALF = 4, PARTIAL = 55;
constexpr int LAST_PARTIAL = HALF + PARTIAL - 1;    // 58
constexpr int LAST_ROUND = 2 * HALF + PARTIAL - 1;  // 62
// `kernel_table`'s layout (ops/poseidon.py E_*), entries of ENTRY_WORDS words
constexpr int E_IN = 0, E_K0 = 2, E_C0P = 8, E_C0L = 11, E_MDS = 14, E_PRE = 23,
              E_NXT1 = 32, E_NXT2 = 41, E_PART = 53, PART_SLOTS = 6;
constexpr int E_OUT = E_PART + PART_SLOTS * PARTIAL;
constexpr int E_ONE = E_OUT + T, E_ZERO = E_ONE + 1, ENTRIES = E_ZERO + 1;
constexpr int ENTRY_WORDS = 12;  // 9 limbs and 3 words of padding: 16-byte rows
constexpr int THREADS = 128;
// at least 5 blocks an SM: the thread form in 94 registers, no spill, 2%
// faster than in the 116 it takes unbounded; 6 and 8 blocks spill to the
// stack (scripts/poseidon_kernels_cuda.py `OCCUPANCY`)
constexpr int MIN_BLOCKS = 5;
constexpr int LANES = 4;  // the lane form's lanes a hash
constexpr unsigned ALL_LANES = 0xffffffffu;

struct Sq29 {  // p in 29-bit limbs and -p^-1 mod 2^29
  uint32_t p[NL29];
  uint32_t np;
};

using Elem = uint32_t[NL29];

__device__ __forceinline__ void entry(const uint32_t* tab, int e, Elem& l) {
  const uint4* row = reinterpret_cast<const uint4*>(tab) + 3 * e;
  const uint4 a = row[0], b = row[1], c = row[2];
  l[0] = a.x;
  l[1] = a.y;
  l[2] = a.z;
  l[3] = a.w;
  l[4] = b.x;
  l[5] = b.y;
  l[6] = b.z;
  l[7] = b.w;
  l[8] = c.x;
}

__device__ __forceinline__ void copy(Elem& d, const Elem& v) {
#pragma unroll
  for (int k = 0; k < NL29; ++k) d[k] = v[k];
}

// t += table entry e * y
__device__ __forceinline__ void term(const uint32_t* tab, int e, const Elem& y,
                                     uint64_t (&t)[COLS29]) {
  Elem c;
  entry(tab, e, c);
  stark::mac29(t, c, y);
}

// t += table entry e * 2^261
__device__ __forceinline__ void shifted(const uint32_t* tab, int e, uint64_t (&t)[COLS29]) {
  Elem c;
  entry(tab, e, c);
  stark::add_shifted29(t, c);
}

__device__ __forceinline__ void reduce(const Sq29& q, uint64_t (&t)[COLS29], Elem& r) {
  stark::redc29(q.p, q.np, t, r);
}

// x = v^5 in the table's scale: v^4 by two squarings, then v^4 v
__device__ __forceinline__ void sbox(const Sq29& q, const Elem& v, Elem& x) {
  Elem y, z;
  uint64_t t[COLS29];
  stark::mont_sqr29(q.p, q.np, v, y);
  stark::mont_sqr29(q.p, q.np, y, z);
  stark::clear29(t);
  stark::mac29(t, z, v);
  reduce(q, t, x);
}

// round 0's S-box input on input lane k (1 or 2): the column's value plus
// c[0][k], lazy (below 2^256 + p)
__device__ __forceinline__ void round0_input(const int32_t* __restrict__ in, int64_t ld,
                                             int64_t col, const uint32_t* tab, int k,
                                             Elem& v) {
  uint32_t w[NW];
  Elem c;
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = static_cast<uint32_t>(in[i * ld + col]);
  stark::to_limbs29(w, v);
  entry(tab, E_IN + k - 1, c);
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    const uint32_t sum = v[i] + c[i] + carry;
    v[i] = sum & stark::MASK29;
    carry = sum >> 29;
  }
}

// the digest r (below 2p) -> r mod p, as 8 words
__device__ __forceinline__ void digest_words(const Sq29& q, const Elem& r, uint32_t (&w)[NW]) {
  Elem d;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL29; ++i) {
    const uint32_t diff = r[i] - q.p[i] - borrow;
    d[i] = diff & stark::MASK29;
    borrow = diff >> 31;
  }
#pragma unroll
  for (int i = 0; i < NL29; ++i) d[i] = borrow ? r[i] : d[i];
  stark::from_limbs29(d, w);
}

// the last round's output row over the S-boxed y0, y1, y2, as 8 words
__device__ __forceinline__ void output_row(const Sq29& q, const uint32_t* tab, const Elem& y0,
                                           const Elem& y1, const Elem& y2,
                                           uint32_t (&w)[NW]) {
  uint64_t t[COLS29];
  Elem r;
  stark::clear29(t);
  term(tab, E_OUT, y0, t);
  term(tab, E_OUT + 1, y1, t);
  term(tab, E_OUT + 2, y2, t);
  reduce(q, t, r);
  digest_words(q, r, w);
}

// --- a thread a hash ---------------------------------------------------------

// (s0, s1, s2) <- (s1, s2, v)
__device__ __forceinline__ void rotate_in(Elem& s0, Elem& s1, Elem& s2, const Elem& v) {
  copy(s0, s1);
  copy(s1, s2);
  copy(s2, v);
}

// (s0, s1, s2) <- (S(s0), S(s1), S(s2))
__device__ __forceinline__ void sbox_all(const Sq29& q, Elem& s0, Elem& s1, Elem& s2) {
  Elem x;
#pragma unroll 1
  for (int i = 0; i < T; ++i) {
    sbox(q, s0, x);
    rotate_in(s0, s1, s2, x);
  }
}

// Round r of 1-61. A full round: the matrix at entry m times the S-boxed
// state, plus the next round's constants at entry nx. A partial round (the
// sparse one at entry b): x0 = S(s0); s0 <- a00 x0 + row0 . (s1, s2) + the
// next c0; s_i <- col0_i x0 + s_i (+ round 59's constants after round 58).
__device__ __forceinline__ void hash_round(const Sq29& q, const uint32_t* tab, int r, Elem& s0,
                                           Elem& s1, Elem& s2) {
  uint64_t t[COLS29];
  if (r >= HALF && r <= LAST_PARTIAL) {
    const int b = E_PART + PART_SLOTS * (r - HALF);
    Elem x0, n0;
    sbox(q, s0, x0);
    stark::clear29(t);
    term(tab, b, x0, t);
    term(tab, b + 1, s1, t);
    term(tab, b + 2, s2, t);
    shifted(tab, b + 5, t);
    reduce(q, t, n0);
    stark::clear29(t);
    term(tab, b + 3, x0, t);
    stark::add_shifted29(t, s1);
    if (r == LAST_PARTIAL) shifted(tab, E_NXT2 + 1, t);
    reduce(q, t, s1);
    stark::clear29(t);
    term(tab, b + 4, x0, t);
    stark::add_shifted29(t, s2);
    if (r == LAST_PARTIAL) shifted(tab, E_NXT2 + 2, t);
    reduce(q, t, s2);
    copy(s0, n0);
    return;
  }
  const int m = r == HALF - 1 ? E_PRE : E_MDS;
  const int nx = r < HALF ? E_NXT1 + T * (r - 1) : E_NXT2 + T * (r - LAST_PARTIAL);
  sbox_all(q, s0, s1, s2);
  Elem o0, o1, o2;
#pragma unroll 1
  for (int j = 0; j < T; ++j) {  // (o0, o1, o2) <- (o1, o2, row j)
    Elem row;
    stark::clear29(t);
    term(tab, m + T * j, s0, t);
    term(tab, m + T * j + 1, s1, t);
    term(tab, m + T * j + 2, s2, t);
    shifted(tab, nx + j, t);
    reduce(q, t, row);
    rotate_in(o0, o1, o2, row);
  }
  copy(s0, o0);
  copy(s1, o1);
  copy(s2, o2);
}

template <bool PAIRS>
__device__ __forceinline__ void thread_form(const int32_t* __restrict__ in,
                                            int32_t* __restrict__ out, int64_t n, int64_t ld,
                                            const Sq29& q, const uint32_t* tab) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  Elem s0, s1 = {}, s2 = {}, x1, x2;
  uint64_t t[COLS29];
  round0_input(in, ld, PAIRS ? 2 * i : i, tab, 1, s0);
  sbox(q, s0, x1);
  if (PAIRS) {
    round0_input(in, ld, 2 * i + 1, tab, 2, s0);
    sbox(q, s0, x2);
  }
#pragma unroll 1
  for (int j = 0; j < T; ++j) {  // round 0's rows: (s0, s1, s2) <- (s1, s2, row j)
    Elem row;
    stark::clear29(t);
    term(tab, E_K0 + 2 * j, x1, t);
    if (PAIRS) term(tab, E_K0 + 2 * j + 1, x2, t);
    shifted(tab, (PAIRS ? E_C0P : E_C0L) + j, t);
    reduce(q, t, row);
    rotate_in(s0, s1, s2, row);
  }
#pragma unroll 1
  for (int r = 1; r < LAST_ROUND; ++r) hash_round(q, tab, r, s0, s1, s2);
  sbox_all(q, s0, s1, s2);
  uint32_t w[NW];
  output_row(q, tab, s0, s1, s2, w);
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k * n + i] = static_cast<int32_t>(w[k]);
}

// --- a group of LANES lanes a hash -------------------------------------------

// y_i = member i's x, for i < T, in each lane's group
__device__ __forceinline__ void gather(const Elem& x, Elem& y0, Elem& y1, Elem& y2) {
#pragma unroll
  for (int k = 0; k < NL29; ++k) {
    y0[k] = __shfl_sync(ALL_LANES, x[k], 0, LANES);
    y1[k] = __shfl_sync(ALL_LANES, x[k], 1, LANES);
    y2[k] = __shfl_sync(ALL_LANES, x[k], 2, LANES);
  }
}

template <bool PAIRS>
__device__ __forceinline__ void lane_form(const int32_t* __restrict__ in,
                                          int32_t* __restrict__ out, int64_t n, int64_t ld,
                                          const Sq29& q, const uint32_t* tab) {
  const int64_t thread = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if ((thread & ~int64_t{31}) / LANES >= n) return;  // the whole warp is past the level
  const int64_t h = thread / LANES;
  const bool live = h < n;
  const int member = threadIdx.x & (LANES - 1);
  const int row = member == T ? 0 : member;
  Elem s = {}, x, y0, y1, y2;
  uint64_t t[COLS29];
  // round 0: members 1 (and 2 for pairs) S-box their input, the others 0
  if (live && (member == 1 || (PAIRS && member == 2)))
    round0_input(in, ld, PAIRS ? 2 * h + member - 1 : h, tab, member, s);
  sbox(q, s, x);
  gather(x, y0, y1, y2);
  stark::clear29(t);
  term(tab, E_K0 + 2 * row, y1, t);
  if (PAIRS) term(tab, E_K0 + 2 * row + 1, y2, t);
  shifted(tab, (PAIRS ? E_C0P : E_C0L) + row, t);
  reduce(q, t, s);
#pragma unroll 1
  for (int r = 1; r < LAST_ROUND; ++r) {
    const bool partial = r >= HALF && r <= LAST_PARTIAL;
    int e0, e1, e2, nx;
    if (partial) {
      const int b = E_PART + PART_SLOTS * (r - HALF);
      e0 = row == 0 ? b : b + 2 + row;
      e1 = row == 0 ? b + 1 : row == 1 ? E_ONE : E_ZERO;
      e2 = row == 0 ? b + 2 : row == 2 ? E_ONE : E_ZERO;
      nx = row == 0 ? b + 5 : r == LAST_PARTIAL ? E_NXT2 + row : E_ZERO;
    } else {
      e0 = (r == HALF - 1 ? E_PRE : E_MDS) + T * row;
      e1 = e0 + 1;
      e2 = e0 + 2;
      nx = (r < HALF ? E_NXT1 + T * (r - 1) : E_NXT2 + T * (r - LAST_PARTIAL)) + row;
    }
    sbox(q, s, x);
    if (partial && row != 0) copy(x, s);
    gather(x, y0, y1, y2);
    stark::clear29(t);
    term(tab, e0, y0, t);
    term(tab, e1, y1, t);
    term(tab, e2, y2, t);
    shifted(tab, nx, t);
    reduce(q, t, s);
  }
  // the last round: every lane forms the output row; member m stores words
  // 2m and 2m + 1 of the digest
  sbox(q, s, x);
  gather(x, y0, y1, y2);
  uint32_t w[NW];
  output_row(q, tab, y0, y1, y2, w);
  if (live) {
#pragma unroll
    for (int k = 0; k < NW; ++k)
      if (k / 2 == member) out[k * n + h] = static_cast<int32_t>(w[k]);
  }
}

// n hashes; the inputs' rows are `ld` words apart, the output's n.
template <bool PAIRS, bool LANE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
poseidon_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int64_t n,
                int64_t ld, const uint32_t* __restrict__ table, stark::Field f) {
  __shared__ __align__(16) uint32_t tab[ENTRIES * ENTRY_WORDS];
  for (int w = threadIdx.x; w < ENTRIES * ENTRY_WORDS / 4; w += THREADS)
    reinterpret_cast<uint4*>(tab)[w] = reinterpret_cast<const uint4*>(table)[w];
  __syncthreads();
  Sq29 q;
  stark::to_limbs29(f.p, q.p);
  q.np = f.np & stark::MASK29;
  if (LANE) {
    lane_form<PAIRS>(in, out, n, ld, q, tab);
  } else {
    thread_form<PAIRS>(in, out, n, ld, q, tab);
  }
}

template <bool PAIRS>
int launch(const void* in, void* out, long long n, long long ld, const void* table, int lanes,
           const uint32_t* field_words, uint32_t np, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const stark::Field f = stark::make_field(field_words, np);
  const long long per_block = lanes ? THREADS / LANES : THREADS;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  const auto* src = static_cast<const int32_t*>(in);
  auto* dst = static_cast<int32_t*>(out);
  const auto* tab = static_cast<const uint32_t*>(table);
  if (lanes) {
    poseidon_kernel<PAIRS, true><<<blocks, THREADS, 0, s>>>(src, dst, n, ld, tab, f);
  } else {
    poseidon_kernel<PAIRS, false><<<blocks, THREADS, 0, s>>>(src, dst, n, ld, tab, f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: `kernel_table` on the device (ENTRIES x 12 words, 16-byte aligned);
// lanes: 1 for the lane form (`ops/poseidon.py lane_form`), 0 for a thread a
// hash. leaf_words (W >= 8, ld) -> out (8, n): the leaf layer (n = ld).
extern "C" int stark_poseidon_leaves(const void* leaf_words, void* out, long long n,
                                     long long ld, const void* table, int lanes,
                                     const uint32_t* field_words, uint32_t np,
                                     void* stream) {
  return launch<false>(leaf_words, out, n, ld, table, lanes, field_words, np, stream);
}

// layer (8, ld = 2n) -> out (8, n): one fold level.
extern "C" int stark_poseidon_pairs(const void* layer, void* out, long long n,
                                    long long ld, const void* table, int lanes,
                                    const uint32_t* field_words, uint32_t np,
                                    void* stream) {
  return launch<true>(layer, out, n, ld, table, lanes, field_words, np, stream);
}
