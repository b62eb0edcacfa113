// Elementwise Montgomery multiply of (16, n) limb planes.
//
// Replaces the TPU kernel stark_tpu/ops/pallas_field.py:174 `mmul` (its body
// `_mmul_kernel`, a 16x16-bit schoolbook plus REDC over (16, 1024) VMEM
// tiles).
//
// What bounds it on an H100: device memory. Each element moves 3 x 64 bytes
// (two 16-limb inputs, one output) for one 8-word CIOS product of ~130
// integer multiply-adds, so at n = 2^20 one call moves 3 x 64 MiB and the
// arithmetic is far below the card's integer rate.
// What the design does about it: one thread per element; thread i reads
// column i of each limb row, so a warp's 32 loads of one row are one
// contiguous 128-byte segment. The limbs are packed to 8 words in registers
// and never touch shared memory. No tiling beyond that: simple and right
// first; packing the planes as words is later work.
#include "field.cuh"

namespace {

__global__ void mmul_kernel(const int32_t* __restrict__ a,
                            const int32_t* __restrict__ b,
                            int32_t* __restrict__ out, int64_t n,
                            stark::Field f) {
  int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t x[stark::NW], y[stark::NW], r[stark::NW];
  stark::load_elem(a, n, col, x);
  stark::load_elem(b, n, col, y);
  stark::mont_mul(f, x, y, r);
  stark::store_elem(out, n, col, r);
}

}  // namespace

extern "C" int stark_mmul(const void* a, const void* b, void* out, long long n,
                          const uint32_t* p_words, uint32_t np, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    mmul_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        static_cast<int32_t*>(out), n, stark::make_field(p_words, np));
  }
  return static_cast<int>(cudaGetLastError());
}
