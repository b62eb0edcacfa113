// FRI's fold: the two halves of its Lagrange route, around the shared batched
// inversion, and its radix-4 inverse-DFT route (fri_fold_dft, below) whole.
//
// They replace the TPU kernels of stark_tpu/protocol/pallas_kernels.py:
//   fri_fold_pre   :433 (_fri_pre_kernel :399)   its second output, the
//       denominators dens_j = prod_(m != j) (x_j - x_m) = eq_j(x_j)
//   fri_fold_post  :478 (_fri_post_kernel :455)  its output for the cubics
//       eq_j that :433 makes from the same x: sum_j y_j inv_j eq_j(sx)
// The TPU pair carries the four monic cubics eq_j of each row (16 words of
// 8, one of them the constant R mod p) from pre to post across the batched
// inversion. Here post rebuilds eq_j(sx) = prod_(m != j) (sx - x_m) from the
// row's four x, so pre writes the denominators only and post reads the x
// in place of the cubics: the same bits (exact arithmetic, canonical
// outputs), in 1,344 bytes a row where the TPU's split moves 3,136.
//
// Layout: a round's n = 4q domain points as (16, 4, q) planes, member j of
// row i at [limb][j][i] (a view of the flat (16, n) plane: x_j[i] =
// xs[j*q + i]).
//
// What bounds them on an H100: by bytes, 512 a row for pre (x in, dens out)
// and 832 for post (x, y, inverses in, one element out), 0.040 and 0.065 ms
// at q = 2^18. By what the function needs, 8 Montgomery products a row in
// pre and 14 in post. The products bind: at q = 2^18 pre takes 0.074 ms
// and post 0.128; moving the same bytes another way (through shared memory,
// by 16-byte loads: below) made neither faster, and post's time follows its
// products a lane (a quad, 16 a row: 0.139).
// What the design does about it:
// - No product beyond what the function needs. dens_j is two products of
//   the differences x_j - x_m (the TPU kernel forms six pair products and
//   Horner-evaluates each cubic: 18 a row). Post forms d_m = sx - x_m, the
//   pair products d_0 d_1 and d_2 d_3, each member's vanishing product from
//   them, its weight w_j = y_j inv_j and its term: 14 a row (the TPU's 23).
//   Every difference is a canonical mod_sub, 0 exactly for equal x, so a
//   row with two equal x gets dens 0 for both (and, from multi_inv,
//   inverses 0).
// - Short chains on many lanes. Pre spreads a row over a quad of lanes, one
//   member a lane (2 products), the x traded by __shfl_xor_sync. Post
//   spreads it over a pair, two members a lane (7 products, the pair
//   products traded), and the two lanes add their sums by a shuffle and
//   store half the limbs each. 46 and 64 registers, no spill, no
//   __launch_bounds__ cap (the TPU's split, a row a thread, took 128
//   registers under __launch_bounds__(128, 4) and spilled 20 and 140 bytes).
// - Each limb plane row is read with load_elem, so a warp reads 32-byte
//   sectors of 4 members (pre) or 2 (post) of 8 or 16 neighbouring rows.
// Tried and dropped (scripts/fri_fold_variants_cuda.py, which keeps each as
// probe source; ms at q = 2^18 and q = 64, pre / post, one H100 80GB HBM3 at
// 700.00 W): the TPU's split, a row a thread, 0.4447 / 0.4681 and 0.0366 /
// 0.0414; products of differences a row a thread 0.0975 / 0.1389 and
// 0.0119 / 0.0163; post over a quad, 4 products a lane (16 a row), 0.1387
// at 2^18 but 0.0085 at q = 64 (the pair's 0.0105: two more dependent
// products a lane); four warps a block trading through shared memory
// 0.0757 / 0.1453; the block's rows staged by 16-byte loads and stores
// 0.0937 / 0.1794; a persistent grid 0.0868 / 0.1651; radix-2^29 products
// (field.cuh's form, R' = 2^261, and one more product by 2^281 mod p to
// take out their factors): post 0.1439 over a quad, 0.1280 over a pair.
// The schedule moves post by a few percent: the same arithmetic with each
// output word's select beside its two stores (and d_a d_b shuffled into its
// own operand's register) took 0.1333 ms at q = 2^18, this form 0.1269 to
// 0.1281, in calls where the quad's post read 0.1374 to 0.1389 both times.
//
// fri_fold_dft: one round of the default route in one launch, special_x
// included. It replaces no TPU kernel: the JAX package's fold on this route
// is XLA glue (stark_tpu/fri/fri.py:121 _fold_j, its default branch
// :163-190), which the port ran as PyTorch field ops, about 860 launches and
// 13 host syncs a round (madd's and msub's carry chains in int64, six mmul,
// a cat with a flip, the uploads of p, 1/4 and R^2), after special_x from
// the previous tree's root (protocol/device_transcript.py
// digest_le_int_mont). The row points are a coset of the 4th roots of unity,
// x_j = x I^j with I = g^(n/4), so for row i of q = n/4, with v_j =
// values[j q + i], x^-1 = xs[(n - i) mod n] and t = special_x x^-1:
//   a = v0 + v2, b = v1 + v3, c = v0 - v2, e = I (v3 - v1),
//   u0 = a + b, u2 = a - b, u1 = c + e, u3 = c - e,
//   out = (((u3 t + u2) t + u1) t + u0) / 4.
// special_x is the root's 8 words read as a little-endian integer below
// 2^256, taken into Montgomery form by one product with R^2 mod p (CIOS
// takes a < 2^256 against b < p): one thread a block computes it into
// shared memory, with I, while the block's loads are in flight. The product
// by 1/4 is two halvings mod p, the same canonical value as the composed
// fold's product by the constant. Every step is canonical, so the output
// equals the composition's bit for bit.
// What bounds it on an H100: bytes, 384 a row (4 values and x^-1 in, one
// element out, as 16 limb planes of int32): at q = 2^21, round 0 of a 2^23
// prove, 805 MB, 0.240 ms at 3.35 TB/s. By operations, 5 Montgomery
// products a row, 0.085 ms at 136 operations a product. The products of
// fri_fold_post (14 a row at 0.128 ms for q = 2^18) put the 5 at about 0.37
// ms: the products, not the bytes, may bind.
// What the design does about it:
// - A row a thread, nothing between the steps in device memory: the
//   composed fold wrote and read 14 int64 temporaries a row (256 MB each at
//   round 0 of 2^23). The chain is e and t side by side, then three
//   dependent Horner products: with q >= 2^15 rows in the rounds that cost
//   time, the card holds many rows a lane slot and the products' rate, not
//   the chain's latency, binds, so the pair of lanes that paid in
//   fri_fold_post (14 products, two members a lane) does not here; a row
//   split over lanes would trade its u_k by shuffles to save one product of
//   latency in the rounds of a few hundred rows, which take microseconds.
// - The values are read as the (16, 4, q) view of the limb planes, a warp
//   reading whole 32-byte sectors of one member, and x^-1 in descending
//   order over the same sectors.
// - xs is the whole domain's power table and the round reads every
//   stride-th point, stride = 4^round: no copy of the round's points is
//   made, and I = xs[stride q] is the same point in every round.
// - The grid follows q (a thread a row, 128 a block), from 2^21 rows down
//   to the last round's few; a block past the last row computes on row
//   q - 1 and stores nothing.
// Measured (scripts/fri_fold_dft_cuda.py, chip_smoke.py; one H100 80GB HBM3
// at 700.00 W): 80 registers, no spill; 0.4204 and 0.4227 ms at q = 2^21,
// 57% of the byte bound, 0.1311 at 2^19 (stride 4), 0.0752 at 2^17 (stride
// 16), 0.011 ms at 2^9 and below; the 9 rounds of a 2^23 fold 0.691 ms of
// device time, where the composition took 153-157 ms. The strided read
// costs at round 2 (0.0750 ms against 0.0424 on a ready copy of the
// round's points) less than the copy it saves (copy and kernel 0.2352).
#include "field.cuh"

namespace {

using stark::Field;
using stark::NW;

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;

// r = the element that lane (this lane ^ k) of the warp holds
__device__ __forceinline__ void shfl_elem(const uint32_t v[NW], int k, uint32_t r[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) r[w] = __shfl_xor_sync(FULL, v[w], k);
}

// Lane 4r + j of a warp holds member j of one row: row i = thread / 4. A
// quad past the last row computes on row q - 1 and stores nothing, so that
// every lane takes part in the shuffles.
struct Quad {
  int64_t i;  // the row
  int64_t c;  // the row it reads: i, or q - 1 past the end
  int j;      // the member
  bool live;
};

__device__ __forceinline__ Quad quad_of(int64_t t, int64_t q) {
  Quad r;
  r.i = t >> 2;
  r.j = static_cast<int>(t & 3);
  r.live = r.i < q;
  r.c = r.live ? r.i : q - 1;
  return r;
}

// dens_j = (x_j - x_(j^1)) (x_j - x_(j^2)) (x_j - x_(j^3)): two products, for
// the lane of thread index t
__device__ __forceinline__ void fold_pre_lane(const Field& f, const int32_t* __restrict__ xs4,
                                              int32_t* __restrict__ dens, int64_t q,
                                              int64_t t) {
  const Quad r = quad_of(t, q);
  uint32_t x[NW], o[NW], d[NW], acc[NW], u[NW];
  stark::load_elem(xs4 + r.j * q, 4 * q, r.c, x);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    shfl_elem(x, k, o);
    stark::mod_sub(f, x, o, d);
    if (k == 1) {
      stark::set_elem(acc, d);
    } else {
      stark::mont_mul(f, acc, d, u);
      stark::set_elem(acc, u);
    }
  }
  if (r.live) stark::store_elem(dens + r.j * q, 4 * q, r.i, acc);
}

// out = sum_j y_j inv_j prod_(m != j) (sx - x_m) for the lane of thread index
// t: lane h of a pair holds members a = 2h and b = 2h + 1 of row i = t / 2.
// It forms d_a d_b (d = sx - x), takes the other lane's, and from them the
// vanishing products of its members, their weights w = y inv and terms;
// the two lanes add their sums, and lane h stores limbs 8h .. 8h + 7. A row
// past the end computes on row q - 1 and stores nothing.
__device__ __forceinline__ void fold_post_lane(
    const Field& f, const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
    const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
    int32_t* __restrict__ out, int64_t q, int64_t t) {
  const int64_t i = t >> 1;
  const int h = static_cast<int>(t & 1);
  const bool live = i < q;
  const int64_t c = live ? i : q - 1;
  const int32_t* xa = xs4 + (2 * h) * q;
  const int32_t* ya = ys4 + (2 * h) * q;
  const int32_t* ia = invs + (2 * h) * q;
  uint32_t s[NW], u[NW], da[NW], db[NW], pr[NW], po[NW], la[NW], lb[NW], w[NW], v[NW];
  stark::load_elem(sx, 1, 0, s);
  stark::load_elem(xa, 4 * q, c, u);
  stark::mod_sub(f, s, u, da);
  stark::load_elem(xa + q, 4 * q, c, u);
  stark::mod_sub(f, s, u, db);
  stark::mont_mul(f, da, db, pr);
  shfl_elem(pr, 1, po);
  stark::mont_mul(f, db, po, la);
  stark::mont_mul(f, da, po, lb);
  stark::load_elem(ya, 4 * q, c, s);
  stark::load_elem(ia, 4 * q, c, u);
  stark::mont_mul(f, s, u, w);
  stark::mont_mul(f, w, la, v);
  stark::load_elem(ya + q, 4 * q, c, s);
  stark::load_elem(ia + q, 4 * q, c, u);
  stark::mont_mul(f, s, u, w);
  stark::mont_mul(f, w, lb, la);
  stark::mod_add(f, v, la, u);
  shfl_elem(u, 1, v);
  stark::mod_add(f, u, v, s);
  if (live) {
    uint32_t half[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) half[k] = h ? s[4 + k] : s[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[(8 * h + 2 * k) * q + i] = static_cast<int32_t>(half[k] & 0xFFFFu);
      out[(8 * h + 2 * k + 1) * q + i] = static_cast<int32_t>(half[k] >> 16);
    }
  }
}

__device__ __forceinline__ int64_t thread_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__global__ void __launch_bounds__(THREADS)
fri_fold_pre_kernel(const int32_t* __restrict__ xs4, int32_t* __restrict__ dens,
                    int64_t q, Field f) {
  fold_pre_lane(f, xs4, dens, q, thread_index());
}

__global__ void __launch_bounds__(THREADS)
fri_fold_post_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ xs4,
                     const int32_t* __restrict__ ys4, const int32_t* __restrict__ invs,
                     int32_t* __restrict__ out, int64_t q, Field f) {
  fold_post_lane(f, sx, xs4, ys4, invs, out, q, thread_index());
}

// x / 2 mod p for x < p: x, or x + p where x is odd, shifted down one bit
__device__ __forceinline__ void halve(const Field& f, uint32_t a[NW]) {
  const uint32_t odd = 0u - (a[0] & 1u);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t s = static_cast<uint64_t>(a[i]) + (f.p[i] & odd) + c;
    a[i] = static_cast<uint32_t>(s);
    c = s >> 32;
  }
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) a[i] = (a[i] >> 1) | (a[i + 1] << 31);
  a[NW - 1] = (a[NW - 1] >> 1) | (static_cast<uint32_t>(c) << 31);
}

// R^2 mod p, 8 words: special_x's product into Montgomery form
struct Words {
  uint32_t w[NW];
};

// values (16, 4q), xs (16, 4q stride): row i of the fold (the note above)
__global__ void __launch_bounds__(THREADS)
fri_fold_dft_kernel(const int32_t* __restrict__ root, const int32_t* __restrict__ values,
                    const int32_t* __restrict__ xs, int32_t* __restrict__ out, int64_t q,
                    int64_t stride, Field f, Words r2) {
  __shared__ uint32_t sx_s[NW], i_s[NW];
  const int64_t i = thread_index();
  const bool live = i < q;
  const int64_t c = live ? i : q - 1;
  const int64_t n = 4 * q, m = stride * n;
  uint32_t v0[NW], v1[NW], v2[NW], v3[NW], t[NW], s[NW], u[NW], acc[NW];
  stark::load_elem(values, n, c, v0);
  stark::load_elem(values + q, n, c, v1);
  stark::load_elem(values + 2 * q, n, c, v2);
  stark::load_elem(values + 3 * q, n, c, v3);
  stark::load_elem(xs, m, c == 0 ? 0 : stride * (n - c), t);  // x^-1
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NW; ++k) u[k] = static_cast<uint32_t>(root[k]);
    stark::mont_mul(f, u, r2.w, s);
    stark::load_elem(xs, m, stride * q, u);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      sx_s[k] = s[k];
      i_s[k] = u[k];
    }
  }
  // the butterflies' sums and differences: v0 = a, v1 = b, v2 = c, v3 = v3 - v1
  stark::mod_sub(f, v0, v2, u);
  stark::mod_add(f, v0, v2, v0);
  stark::set_elem(v2, u);
  stark::mod_sub(f, v3, v1, u);
  stark::mod_add(f, v1, v3, v1);
  stark::set_elem(v3, u);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NW; ++k) s[k] = i_s[k];
  stark::mont_mul(f, s, v3, v3);  // e
#pragma unroll
  for (int k = 0; k < NW; ++k) s[k] = sx_s[k];
  stark::mont_mul(f, s, t, t);  // t = special_x x^-1
  stark::mod_sub(f, v2, v3, u);  // u3
  stark::mont_mul(f, u, t, acc);
  stark::mod_sub(f, v0, v1, u);  // u2
  stark::mod_add(f, acc, u, acc);
  stark::mont_mul(f, acc, t, acc);
  stark::mod_add(f, v2, v3, u);  // u1
  stark::mod_add(f, acc, u, acc);
  stark::mont_mul(f, acc, t, acc);
  stark::mod_add(f, v0, v1, u);  // u0
  stark::mod_add(f, acc, u, acc);
  halve(f, acc);
  halve(f, acc);
  if (live) stark::store_elem(out, q, i, acc);
}

inline unsigned blocks_for(long long lanes) {
  return static_cast<unsigned>((lanes + THREADS - 1) / THREADS);
}

}  // namespace

// xs4 (16, 4, q) -> dens (16, 4, q); nothing to do for q = 0.
extern "C" int stark_fri_fold_pre(const void* xs4, void* dens, long long q,
                                  const uint32_t* field_words, uint32_t np,
                                  void* stream) {
  if (q > 0)
    fri_fold_pre_kernel<<<blocks_for(4 * q), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(xs4), static_cast<int32_t*>(dens), q,
        stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

// sx (16, 1), xs4, ys4 and invs (16, 4, q) -> out (16, q).
extern "C" int stark_fri_fold_post(const void* sx, const void* xs4, const void* ys4,
                                   const void* invs, void* out, long long q,
                                   const uint32_t* field_words, uint32_t np,
                                   void* stream) {
  if (q > 0)
    fri_fold_post_kernel<<<blocks_for(2 * q), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(sx), static_cast<const int32_t*>(xs4),
        static_cast<const int32_t*>(ys4), static_cast<const int32_t*>(invs),
        static_cast<int32_t*>(out), q, stark::make_field(field_words, np));
  return static_cast<int>(cudaGetLastError());
}

// root (8,) words, values (16, 4q) and xs (16, 4q stride) -> out (16, q);
// nothing to do for q = 0.
extern "C" int stark_fri_fold_dft(const void* root, const void* values, const void* xs,
                                  void* out, long long q, long long stride,
                                  const uint32_t* field_words, const uint32_t* r2_words,
                                  uint32_t np, void* stream) {
  if (q > 0) {
    Words r2;
    for (int k = 0; k < stark::NW; ++k) r2.w[k] = r2_words[k];
    fri_fold_dft_kernel<<<blocks_for(q), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(root), static_cast<const int32_t*>(values),
        static_cast<const int32_t*>(xs), static_cast<int32_t*>(out), q, stride,
        stark::make_field(field_words, np), r2);
  }
  return static_cast<int>(cudaGetLastError());
}
