// Warp-level helpers shared by the first flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): warp reductions, tile
// loads of bf16 head slices into padded shared memory, and the mma.sync
// m16n8k16 bf16 product with its fragment loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy `rows` x HDP of a (rows_valid x hd) head slice whose rows sit
// `stride` elements apart into shared memory [rows][ld]; zero past the edge.
template <int HDP, int THREADS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, int ld, int rows,
                                               const bf16* src,
                                               long long stride,
                                               int rows_valid, int hd,
                                               bool vec) {
  if (vec) {  // hd % 8 == 0 and 16-byte aligned rows: one uint4 = 8 values
    constexpr int VPR = HDP / 8;
    for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid && c < hd)
        val = *reinterpret_cast<const uint4*>(src + r * stride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * HDP; i += THREADS) {
      const int r = i / HDP, c = i % HDP;
      bf16 val = __float2bfloat16(0.f);
      if (r < rows_valid && c < hd) val = src[r * stride + c];
      dst[r * ld + c] = val;
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of a 16 x 8 tile of V (rows: keys, columns: head dims) from
// row-major shared memory, transposed on the way by ldmatrix
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const bf16* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace
