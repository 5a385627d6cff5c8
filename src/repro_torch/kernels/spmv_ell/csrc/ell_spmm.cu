// ELL SpMM for Hopper (sm_90a): y[v,:] = sum over the rows r of vertex v,
// sum over k of mask[r,k] * vals[r,k] * x[cols[r,k], :].
//
// Replaces the Pallas TPU kernel `ell_row_partials` (body `_kernel`) in
// src/repro/kernels/spmv_ell/spmv_ell.py together with the `segment_sum`
// finish of its wrapper `ell_spmm_kernel` (src/repro/kernels/spmv_ell/ops.py).
// The TPU version writes per-row partials and sums them by `row_ids` in a
// second pass, and chunks d to fit x in VMEM; neither is needed here.
//
// What bounds it on the card: memory. Each live entry costs one 4-byte
// column id, one 4-byte weight and a gather of d floats of x, against
// 2*d flops; the mask is read once per live row. At the RWR shapes
// (d = 4 for the label table, d = n_sweep*k for the expansion tables) the
// kernel is far below the card's flop/byte balance point, so the only
// levers are fewer bytes and coalesced gathers.
//
// Design:
//  * one warp per destination vertex. The warp walks the vertex's rows in
//    ascending row order through a row index (`perm`, `row_ptr`) sorted
//    stably by owning vertex, built once per mirror version by the wrapper.
//    Spill rows handed out from a shared cursor need not sit next to their
//    vertex's first row, and the index finds them wherever they are. Rows
//    with no live entry are not in the index, so the unallocated capacity
//    rows (all owned by vertex 0) never reach vertex 0's warp.
//  * d >= 32: lanes run across 32 columns of x at a time, so each gathered
//    row segment of x is one coalesced 128-byte read. The live entries of a
//    32-wide slice of the row are found with one ballot over the mask and
//    broadcast lane to lane with shuffles, in ascending k.
//  * d < 32: lanes run across K instead; each lane keeps d partial sums in
//    registers (the column count is a template bound) and the 32 partials
//    meet in a fixed shuffle tree at the end.
//  * no atomics and a fixed summation order: every vertex's sum is formed
//    by one warp in the same order on every run, so the result is bitwise
//    the same from run to run (the seed top-k and the expander argmax of
//    G-Ray read these values).
//  * launches on the caller's stream, allocates nothing, and returns
//    cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps = 8 vertices per block

__global__ void ell_spmm_cols(const int32_t* __restrict__ cols,
                              const float* __restrict__ vals,
                              const uint8_t* __restrict__ mask,
                              const int32_t* __restrict__ perm,
                              const int32_t* __restrict__ row_ptr,
                              const float* __restrict__ x,
                              float* __restrict__ y, int n, int d, int K) {
  const int lane = threadIdx.x & 31;
  const long long v =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (v >= n) return;  // warp-uniform
  const int p0 = row_ptr[v];
  const int p1 = row_ptr[v + 1];
  for (int c0 = 0; c0 < d; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < d;
    float acc = 0.f;
    for (int p = p0; p < p1; ++p) {
      const long long base = (long long)perm[p] * K;
      float part = 0.f;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int kk = k0 + lane;
        const bool m = kk < K && mask[base + kk] != 0;
        const int col = m ? cols[base + kk] : 0;
        const float w = m ? vals[base + kk] : 0.f;
        unsigned bits = __ballot_sync(kFull, m);
        while (bits) {  // warp-uniform: every lane holds the same ballot
          const int j = __ffs(bits) - 1;
          bits &= bits - 1;
          const int src = __shfl_sync(kFull, col, j);
          const float wj = __shfl_sync(kFull, w, j);
          if (on) part += wj * x[(long long)src * d + c];
        }
      }
      acc += part;
    }
    if (on) y[v * d + c] = acc;
  }
}

template <int DM>
__global__ void ell_spmm_small(const int32_t* __restrict__ cols,
                               const float* __restrict__ vals,
                               const uint8_t* __restrict__ mask,
                               const int32_t* __restrict__ perm,
                               const int32_t* __restrict__ row_ptr,
                               const float* __restrict__ x,
                               float* __restrict__ y, int n, int d, int K) {
  const int lane = threadIdx.x & 31;
  const long long v =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (v >= n) return;  // warp-uniform
  const int p0 = row_ptr[v];
  const int p1 = row_ptr[v + 1];
  float acc[DM];
#pragma unroll
  for (int j = 0; j < DM; ++j) acc[j] = 0.f;
  for (int p = p0; p < p1; ++p) {
    const long long base = (long long)perm[p] * K;
    for (int kk = lane; kk < K; kk += 32) {
      if (mask[base + kk] != 0) {
        const float w = vals[base + kk];
        const float* xr = x + (long long)cols[base + kk] * d;
#pragma unroll
        for (int j = 0; j < DM; ++j) {
          if (j < d) acc[j] += w * xr[j];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DM; ++j) {
    float s = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    acc[j] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < DM; ++j) {
      if (j < d) y[v * d + j] = acc[j];
    }
  }
}

}  // namespace

extern "C" int ell_spmm_f32(const void* cols, const void* vals,
                            const void* mask, const void* perm,
                            const void* row_ptr, const void* x, void* y,
                            int n, int d, int K, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const long long threads_total = (long long)n * 32;
  const unsigned blocks =
      (unsigned)((threads_total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const float* w = static_cast<const float*>(vals);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int32_t* pm = static_cast<const int32_t*>(perm);
  const int32_t* rp = static_cast<const int32_t*>(row_ptr);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  if (d <= 4) {
    ell_spmm_small<4><<<blocks, kThreads, 0, s>>>(c, w, m, pm, rp, xx, yy, n, d, K);
  } else if (d <= 8) {
    ell_spmm_small<8><<<blocks, kThreads, 0, s>>>(c, w, m, pm, rp, xx, yy, n, d, K);
  } else if (d <= 16) {
    ell_spmm_small<16><<<blocks, kThreads, 0, s>>>(c, w, m, pm, rp, xx, yy, n, d, K);
  } else if (d < 32) {
    ell_spmm_small<32><<<blocks, kThreads, 0, s>>>(c, w, m, pm, rp, xx, yy, n, d, K);
  } else {
    ell_spmm_cols<<<blocks, kThreads, 0, s>>>(c, w, m, pm, rp, xx, yy, n, d, K);
  }
  return static_cast<int>(cudaGetLastError());
}
