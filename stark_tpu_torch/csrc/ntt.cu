// Radix-2 NTT butterfly stages over (16, n) limb planes.
//
// The flat array is viewed as (16, m, 2, l) with n = 2ml. Within each group
// of 2l, position k pairs u = x[k] and v = x[k + l] with the twiddle
// tw_k = root^(k*m), read from the stage's (16, l) table:
//   Gentleman-Sande DIF (natural in, bit-reversed out):
//     y[k] = u + v,     y[k + l] = (u - v) * tw_k
//   Cooley-Tukey DIT (bit-reversed in, natural out):
//     t = v * tw_k,     y[k] = u + t,     y[k + l] = u - t
//
// butterfly_stage replaces stark_tpu/ops/pallas_field.py:446
// `butterfly_stage` (one stage with l >= TILE, strided (16, 1, 2, 1024)
// blocks). butterfly_fused replaces stark_tpu/ops/pallas_field.py:518
// `butterfly_fused` (every stage with 2l <= block, run back to back in VMEM
// with XOR-roll partner exchange and period-2l twiddle rows).
//
// What bounds them on an H100: device memory. A stage reads and writes the
// whole array (2 x 64 MiB at n = 2^20) for n/2 Montgomery products.
// What the design does about it:
// - butterfly_stage: one thread per (group, k) pair; consecutive threads
//   take consecutive k, so the u, v, twiddle and output rows are read and
//   written as contiguous 128-byte warp segments.
// - butterfly_fused: one CTA holds `block` consecutive elements in shared
//   memory as 8 packed words each (64 KB at block = 2048, opted in as
//   dynamic shared memory) and runs all of its small stages there, so the
//   log2(block) stages cost one read and one write of the array. Words are
//   stored word-major (s[w * block + i]) so a warp's accesses fall on
//   distinct banks. Partners are addressed directly: the XOR-roll trick was
//   the TPU's way around lane shuffles and is not needed here. Twiddles
//   come from the per-stage tables, concatenated (stage l at columns
//   l-1 .. 2l-2) and small enough to stay in L2.
#include "field.cuh"

namespace {

template <bool DIT>
__device__ __forceinline__ void butterfly(const stark::Field& f,
                                          const uint32_t u[stark::NW],
                                          const uint32_t v[stark::NW],
                                          const uint32_t w[stark::NW],
                                          uint32_t y0[stark::NW],
                                          uint32_t y1[stark::NW]) {
  if (DIT) {
    uint32_t t[stark::NW];
    stark::mont_mul(f, v, w, t);
    stark::mod_add(f, u, t, y0);
    stark::mod_sub(f, u, t, y1);
  } else {
    uint32_t d[stark::NW];
    stark::mod_add(f, u, v, y0);
    stark::mod_sub(f, u, v, d);
    stark::mont_mul(f, d, w, y1);
  }
}

template <bool DIT>
__global__ void butterfly_stage_kernel(const int32_t* __restrict__ a,
                                       const int32_t* __restrict__ tw,
                                       int32_t* __restrict__ out, int64_t n,
                                       int64_t l, stark::Field f) {
  int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n / 2) return;
  int64_t g = j / l;
  int64_t k = j - g * l;
  int64_t i0 = g * 2 * l + k;
  int64_t i1 = i0 + l;
  uint32_t u[stark::NW], v[stark::NW], w[stark::NW];
  uint32_t y0[stark::NW], y1[stark::NW];
  stark::load_elem(a, n, i0, u);
  stark::load_elem(a, n, i1, v);
  stark::load_elem(tw, l, k, w);
  butterfly<DIT>(f, u, v, w, y0, y1);
  stark::store_elem(out, n, i0, y0);
  stark::store_elem(out, n, i1, y1);
}

template <bool DIT>
__global__ void butterfly_fused_kernel(const int32_t* __restrict__ a,
                                       const int32_t* __restrict__ tw_cat,
                                       int32_t* __restrict__ out, int64_t n,
                                       int block, stark::Field f) {
  extern __shared__ uint32_t s[];  // [NW][block], word-major
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const int64_t ntw = block - 1;

  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    uint32_t x[stark::NW];
    stark::load_elem(a, n, base + i, x);
#pragma unroll
    for (int w = 0; w < stark::NW; ++w) s[w * block + i] = x[w];
  }
  __syncthreads();

  const int half = block / 2;
  for (int st = 0; (1 << st) < block; ++st) {
    // DIT runs l = 1, 2, ..., block/2; DIF runs the same stages reversed
    const int l = DIT ? (1 << st) : (half >> st);
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int k = j & (l - 1);
      const int i0 = (j - k) * 2 + k;
      const int i1 = i0 + l;
      uint32_t u[stark::NW], v[stark::NW], w[stark::NW];
      uint32_t y0[stark::NW], y1[stark::NW];
#pragma unroll
      for (int q = 0; q < stark::NW; ++q) {
        u[q] = s[q * block + i0];
        v[q] = s[q * block + i1];
      }
      stark::load_elem(tw_cat, ntw, l - 1 + k, w);
      butterfly<DIT>(f, u, v, w, y0, y1);
#pragma unroll
      for (int q = 0; q < stark::NW; ++q) {
        s[q * block + i0] = y0[q];
        s[q * block + i1] = y1[q];
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    uint32_t x[stark::NW];
#pragma unroll
    for (int w = 0; w < stark::NW; ++w) x[w] = s[w * block + i];
    stark::store_elem(out, n, base + i, x);
  }
}

}  // namespace

extern "C" int stark_butterfly_stage(const void* a, const void* tw, void* out,
                                     long long n, long long l, int dit,
                                     const uint32_t* p_words, uint32_t np,
                                     void* stream) {
  const int threads = 256;
  const long long pairs = n / 2;
  if (pairs > 0) {
    const unsigned blocks = static_cast<unsigned>((pairs + threads - 1) / threads);
    const stark::Field f = stark::make_field(p_words, np);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* ap = static_cast<const int32_t*>(a);
    const int32_t* tp = static_cast<const int32_t*>(tw);
    int32_t* op = static_cast<int32_t*>(out);
    if (dit)
      butterfly_stage_kernel<true><<<blocks, threads, 0, st>>>(ap, tp, op, n, l, f);
    else
      butterfly_stage_kernel<false><<<blocks, threads, 0, st>>>(ap, tp, op, n, l, f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stark_butterfly_fused(const void* a, const void* tw_cat,
                                     void* out, long long n, int block, int dit,
                                     const uint32_t* p_words, uint32_t np,
                                     void* stream) {
  const int threads = 256;
  const size_t smem = static_cast<size_t>(block) * stark::NW * sizeof(uint32_t);
  const stark::Field f = stark::make_field(p_words, np);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ap = static_cast<const int32_t*>(a);
  const int32_t* tp = static_cast<const int32_t*>(tw_cat);
  int32_t* op = static_cast<int32_t*>(out);
  const unsigned blocks = static_cast<unsigned>(n / block);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  if (dit) {
    err = cudaFuncSetAttribute(butterfly_fused_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    butterfly_fused_kernel<true><<<blocks, threads, smem, st>>>(ap, tp, op, n, block, f);
  } else {
    err = cudaFuncSetAttribute(butterfly_fused_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    butterfly_fused_kernel<false><<<blocks, threads, smem, st>>>(ap, tp, op, n, block, f);
  }
  return static_cast<int>(cudaGetLastError());
}
