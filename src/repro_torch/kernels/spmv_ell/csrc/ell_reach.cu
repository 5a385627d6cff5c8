// ELL reach sweep for Hopper (sm_90a): for indicator x in {0, 1},
// y[v,:] = max(0, max over the rows r of vertex v, max over k with
// mask[r,k], of x[cols[r,k], :]) — one frontier step of G-Ray's bounded BFS.
//
// Replaces the Pallas TPU kernel `ell_row_maxima` (body `_max_kernel`) in
// src/repro/kernels/spmv_ell/spmv_ell.py together with the `segment_max`
// finish and the -inf -> 0 clamp of its wrapper `ell_reach_kernel`
// (src/repro/kernels/spmv_ell/ops.py). Starting each max at 0 reproduces
// the clamp: a vertex with no live entry comes out 0.
//
// What bounds it on the card: memory, as for the SpMM — a column id and a
// d-wide gather of x per live entry, one compare per gathered float.
//
// Design: the SpMM's (ell_spmm.cu) — one warp per destination vertex
// walking its live rows through the wrapper's row index (so spill rows are
// found wherever the shared cursor put them, and the unallocated capacity
// rows of vertex 0 are never walked); lanes across 32 columns of x for
// d >= 32, across K with a fixed shuffle tree for d < 32. A max over exact
// 0/1 values does not depend on order, so any order would be exact; the
// kernel still uses no atomics. It launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps = 8 vertices per block

__global__ void ell_reach_cols(const int32_t* __restrict__ cols,
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
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int kk = k0 + lane;
        const bool m = kk < K && mask[base + kk] != 0;
        const int col = m ? cols[base + kk] : 0;
        unsigned bits = __ballot_sync(kFull, m);
        while (bits) {  // warp-uniform: every lane holds the same ballot
          const int j = __ffs(bits) - 1;
          bits &= bits - 1;
          const int src = __shfl_sync(kFull, col, j);
          if (on) acc = fmaxf(acc, x[(long long)src * d + c]);
        }
      }
    }
    if (on) y[v * d + c] = acc;
  }
}

template <int DM>
__global__ void ell_reach_small(const int32_t* __restrict__ cols,
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
        const float* xr = x + (long long)cols[base + kk] * d;
#pragma unroll
        for (int j = 0; j < DM; ++j) {
          if (j < d) acc[j] = fmaxf(acc[j], xr[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DM; ++j) {
    float s = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = fmaxf(s, __shfl_down_sync(kFull, s, off));
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

extern "C" int ell_reach_f32(const void* cols, const void* mask,
                             const void* perm, const void* row_ptr,
                             const void* x, void* y, int n, int d, int K,
                             void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const long long threads_total = (long long)n * 32;
  const unsigned blocks =
      (unsigned)((threads_total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int32_t* pm = static_cast<const int32_t*>(perm);
  const int32_t* rp = static_cast<const int32_t*>(row_ptr);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  if (d <= 4) {
    ell_reach_small<4><<<blocks, kThreads, 0, s>>>(c, m, pm, rp, xx, yy, n, d, K);
  } else if (d <= 8) {
    ell_reach_small<8><<<blocks, kThreads, 0, s>>>(c, m, pm, rp, xx, yy, n, d, K);
  } else if (d <= 16) {
    ell_reach_small<16><<<blocks, kThreads, 0, s>>>(c, m, pm, rp, xx, yy, n, d, K);
  } else if (d < 32) {
    ell_reach_small<32><<<blocks, kThreads, 0, s>>>(c, m, pm, rp, xx, yy, n, d, K);
  } else {
    ell_reach_cols<<<blocks, kThreads, 0, s>>>(c, m, pm, rp, xx, yy, n, d, K);
  }
  return static_cast<int>(cudaGetLastError());
}
