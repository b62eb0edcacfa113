// Scalar-lane exponentiation and the prefix-product scan.
//
// mpow_scalar replaces the TPU kernel stark_tpu/ops/pallas_field.py:573
// `mpow_scalar` (body `_mpow_kernel`: a fori_loop that squares, multiplies
// always and selects, with the exponent bits in SMEM).
//   What bounds it on an H100: a chain of bit_length + popcount dependent
//   Montgomery products on at most 32 lanes; it moves 128 bytes per lane.
//   What the design does about it: nothing can shorten the chain, so the
//   kernel only removes everything around it: one block, one thread per
//   lane, operand and accumulator in registers, the exponent (up to 256 bits)
//   as 8 words passed by value. Every lane shares the exponent, so the
//   multiply is a uniform branch instead of a multiply-and-select.
//
// scan_prod replaces stark_tpu/ops/pallas_field.py:626 `scan_prod` (body
// `_scan_kernel`: a sequential grid that carries the running product in a
// VMEM scratch from one grid step to the next).
//   What bounds it: B dependent products per lane-column; blocks of a CUDA
//   grid run in no order and carry nothing, so the sequential axis cannot be
//   a grid axis. With C columns only C threads are in flight, so for small C
//   the chain binds and for large C the 2 x 64 bytes per element do.
//   What the design does about it: one thread owns one lane-column c and
//   loops over the B rows with the running product in registers;
//   neighbouring threads take neighbouring c, so each row access coalesces,
//   and each row is loaded one step ahead of its product.
//   Blocks are one warp wide to spread few columns over many SMs. The caller
//   (`ops/modmath.py prefix_prod`) picks short chains and many columns.
#include "field.cuh"

namespace {

struct Exponent {
  uint32_t w[stark::NW];
};

__global__ void mpow_scalar_kernel(const int32_t* __restrict__ a,
                                   int32_t* __restrict__ out, int k,
                                   Exponent e, int nbits, stark::Field f) {
  int lane = threadIdx.x;
  if (lane >= k) return;
  uint32_t x[stark::NW], acc[stark::NW], t[stark::NW];
  stark::load_elem(a, k, lane, x);
  stark::set_elem(acc, f.one);
#pragma unroll 1
  for (int i = nbits - 1; i >= 0; --i) {
    stark::mont_mul(f, acc, acc, t);
    if ((e.w[i >> 5] >> (i & 31)) & 1u) {
      stark::mont_mul(f, t, x, acc);
    } else {
      stark::set_elem(acc, t);
    }
  }
  stark::store_elem(out, k, lane, acc);
}

__global__ void scan_prod_kernel(const int32_t* __restrict__ x,
                                 int32_t* __restrict__ out, int64_t B,
                                 int64_t C, stark::Field f) {
  int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int64_t n = B * C;
  uint32_t run[stark::NW], v[stark::NW], next[stark::NW], t[stark::NW];
  stark::set_elem(run, f.one);
  stark::load_elem(x, n, c, v);
  stark::set_elem(next, v);
#pragma unroll 1
  for (int64_t b = 0; b < B; ++b) {
    // the next row's load starts before this row's product, so its
    // latency hides behind the product instead of lengthening the chain
    if (b + 1 < B) stark::load_elem(x, n, (b + 1) * C + c, next);
    stark::mont_mul(f, run, v, t);
    stark::set_elem(run, t);
    stark::store_elem(out, n, b * C + c, run);
    stark::set_elem(v, next);
  }
}

}  // namespace

// a, out: (16, k) planes, k <= 32; e_words: 8 little-endian words of the
// exponent on the host; nbits: its bit length (at least 1).
extern "C" int stark_mpow_scalar(const void* a, void* out, int k,
                                 const uint32_t* e_words, int nbits,
                                 const uint32_t* field_words, uint32_t np,
                                 void* stream) {
  if (k > 0) {
    Exponent e;
    for (int i = 0; i < stark::NW; ++i) e.w[i] = e_words[i];
    mpow_scalar_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<int32_t*>(out), k, e,
        nbits, stark::make_field(field_words, np));
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out: (16, B, C) planes; inclusive prefix product along B per column c.
extern "C" int stark_scan_prod(const void* x, void* out, long long B,
                               long long C, const uint32_t* field_words,
                               uint32_t np, void* stream) {
  if (B > 0 && C > 0) {
    const int threads = 32;
    const long long blocks = (C + threads - 1) / threads;
    scan_prod_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<int32_t*>(out), B, C,
        stark::make_field(field_words, np));
  }
  return static_cast<int>(cudaGetLastError());
}
