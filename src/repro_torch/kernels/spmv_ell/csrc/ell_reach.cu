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
// What bounds it on the card: memory, as for the SpMM — a column id per
// live entry and a d-wide gather of x, one compare per gathered float.
// With x larger than L2 (335 MB at the full mirror's d = 320) the gathers,
// nnz * d * 4 bytes, set a realistic floor above the "x read once" bound.
//
// Design (the SpMM's walk, ell_spmm.cu, without the weights):
//  * one warp per destination vertex, walking the vertex's live rows
//    through the wrapper's row index (`perm`, `row_ptr`), so spill rows
//    are found wherever the shared cursor put them and the unallocated
//    capacity rows of vertex 0 are never walked.
//  * d >= 32 (`ell_reach_rows`): each row is walked once. Its 32-slot
//    slices of mask and cols are read once, coalesced; one ballot finds
//    the live entries, which are broadcast lane to lane U at a time.
//    Lanes own float4 column groups l, l + 32, ... (NG of them) and every
//    gather of a batch is issued before the first fmaxf. Where d % 4 != 0
//    or x is not 16-byte aligned the same walk gathers single floats.
//    Wider than 32 * VW * NG columns (512) the walk repeats per chunk.
//  * the max starts at 0, which is the clamp: a vertex with no live entry
//    comes out 0.
//  * d < 32 (`ell_reach_small`): lanes run across K; each lane keeps d
//    maxima in registers and the 32 meet in a shuffle tree at the end.
//  * what limits the walk is the chain of dependent loads per vertex
//    (row_ptr, perm, the row's slots, then x), so warps in flight matter
//    more than gathers in flight per warp. A sweep on an H100 80GB HBM3 at
//    700 W (tools/kernel_sweep.py reach: U 1/2/4/8 x min blocks 2/3/4/6,
//    float4 path) put these first, in ms (the SpMM's settings in brackets):
//
//      input                       NG  best    U  MINB  [U, MINB]
//      served BFS (batch), d 80     1  0.0878  1  6     [4, 4] 0.1251
//      synthetic tile, d 40         1  0.2344  4  6     [4, 4] 0.2846
//      served BFS (batch), d 160    2  0.1337  1  6     [2, 4] 0.1610
//      synthetic tile, d 160        2  0.5666  2  2-4   [2, 4] 0.5668
//      synthetic tile, d 320        3  0.9715  1  2     [2, 3] 0.9881
//
//    (synthetic tile: chip_smoke.py's, n 262,144, R 393,216, K 64, 1.78 M
//    live entries; served: 0.53 M live entries, most vertices empty.) The
//    table in ell_reach_f32 takes U = 1 with 6 blocks per SM up to
//    256 columns, where the served inputs decide (U = 1, MINB = 6 costs
//    3 % on the synthetic d = 160 tile and 25 % at d = 40, which no path
//    serves), and U = 1 with 2 blocks at 257-384 columns. Wider (two walks)
//    and the scalar path were not swept: they keep the SpMM's settings.
//  * a max over exact 0/1 values does not depend on order, so the result
//    is bitwise that of the plain version; no atomics.
//  * the variant (small, wide float4, wide scalar) is chosen by shape in
//    the wrapper (ops.py: ell_variant).
//  * launches on the caller's stream, allocates nothing, and returns
//    cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 8 warps = 8 vertices per block

template <int VW>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ void max_into(float (&acc)[4], const float4& xv) {
  acc[0] = fmaxf(acc[0], xv.x);
  acc[1] = fmaxf(acc[1], xv.y);
  acc[2] = fmaxf(acc[2], xv.z);
  acc[3] = fmaxf(acc[3], xv.w);
}

__device__ __forceinline__ void max_into(float (&acc)[1], float xv) {
  acc[0] = fmaxf(acc[0], xv);
}

__device__ __forceinline__ void store(float* y, const float (&a)[4]) {
  *reinterpret_cast<float4*>(y) = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void store(float* y, const float (&a)[1]) {
  *y = a[0];
}

// VW floats per gather, NG gathers per lane per live entry, U live entries
// per batch, at least MINB blocks per SM (caps the registers)
template <int VW, int NG, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    ell_reach_rows(const int32_t* __restrict__ cols,
                   const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ row_ptr,
                   const float* __restrict__ x, float* __restrict__ y, int n,
                   int d, int K) {
  using V = typename Vec<VW>::T;
  constexpr int CHUNK = 32 * VW * NG;  // columns per walk
  const int lane = threadIdx.x & 31;
  const long long v =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (v >= n) return;  // warp-uniform
  const int p0 = row_ptr[v];
  const int p1 = row_ptr[v + 1];
  for (int c0 = 0; c0 < d; c0 += CHUNK) {  // one walk unless d > CHUNK
    int col_of[NG];
    bool on[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      col_of[i] = c0 + VW * (lane + 32 * i);
      on[i] = col_of[i] < d;
    }
    // the max starts at 0: a vertex with no live entry comes out 0
    float acc[NG][VW];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int c = 0; c < VW; ++c) acc[i][c] = 0.f;
    for (int p = p0; p < p1; ++p) {
      const long long base = (long long)perm[p] * K;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int kk = k0 + lane;
        const bool m = kk < K && mask[base + kk] != 0;
        const int col = m ? cols[base + kk] : 0;
        unsigned bits = __ballot_sync(kFull, m);
        while (bits) {  // warp-uniform: every lane holds the same ballot
          int src[U];
          bool live[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            live[u] = bits != 0;
            const int j = live[u] ? __ffs(bits) - 1 : 0;
            bits &= bits - 1;
            src[u] = __shfl_sync(kFull, col, j);
          }
          // every gather of the batch is issued before the first max
          V xv[U][NG];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int i = 0; i < NG; ++i)
              if (live[u] && on[i])
                xv[u][i] = __ldg(reinterpret_cast<const V*>(
                    x + (long long)src[u] * d + col_of[i]));
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int i = 0; i < NG; ++i)
              if (live[u] && on[i]) max_into(acc[i], xv[u][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NG; ++i)
      if (on[i]) store(y + v * d + col_of[i], acc[i]);
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

template <int VW, int NG, int U, int MINB>
void launch_rows(unsigned blocks, cudaStream_t s, const int32_t* c,
                 const uint8_t* m, const int32_t* pm, const int32_t* rp,
                 const float* xx, float* yy, int n, int d, int K) {
  ell_reach_rows<VW, NG, U, MINB><<<blocks, kThreads, 0, s>>>(
      c, m, pm, rp, xx, yy, n, d, K);
}

}  // namespace

// variant (ops.py: VARIANTS): 0 small (d < 32), 1 wide float4
// (d >= 32, d % 4 == 0, x 16-byte aligned), 2 wide scalar (d >= 32).
extern "C" int ell_reach_f32(const void* cols, const void* mask,
                             const void* perm, const void* row_ptr,
                             const void* x, void* y, int n, int d, int K,
                             int variant, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (variant < 0 || variant > 2 || (variant == 0) != (d < 32) ||
      (variant == 1 && d % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (variant == 0) {
    if (d <= 4) {
      ell_reach_small<4><<<blocks, kThreads, 0, s>>>(c, m, pm, rp, xx, yy, n, d, K);
    } else if (d <= 8) {
      ell_reach_small<8><<<blocks, kThreads, 0, s>>>(c, m, pm, rp, xx, yy, n, d, K);
    } else if (d <= 16) {
      ell_reach_small<16><<<blocks, kThreads, 0, s>>>(c, m, pm, rp, xx, yy, n, d, K);
    } else {
      ell_reach_small<32><<<blocks, kThreads, 0, s>>>(c, m, pm, rp, xx, yy, n, d, K);
    }
  } else if (variant == 1) {
    // (NG, U, MINB) from the sweep described at the top of this file
    const int per_lane = (d / 4 + 31) / 32;  // float4 groups per lane
    if (per_lane <= 1) {
      launch_rows<4, 1, 1, 6>(blocks, s, c, m, pm, rp, xx, yy, n, d, K);
    } else if (per_lane <= 2) {
      launch_rows<4, 2, 1, 6>(blocks, s, c, m, pm, rp, xx, yy, n, d, K);
    } else if (per_lane <= 3) {
      launch_rows<4, 3, 1, 2>(blocks, s, c, m, pm, rp, xx, yy, n, d, K);
    } else {  // d > 384: 512 columns per walk
      launch_rows<4, 4, 1, 3>(blocks, s, c, m, pm, rp, xx, yy, n, d, K);
    }
  } else {
    const int per_lane = (d + 31) / 32;  // floats per lane
    if (per_lane <= 2) {
      launch_rows<1, 2, 4, 4>(blocks, s, c, m, pm, rp, xx, yy, n, d, K);
    } else if (per_lane <= 4) {
      launch_rows<1, 4, 2, 4>(blocks, s, c, m, pm, rp, xx, yy, n, d, K);
    } else if (per_lane <= 8) {
      launch_rows<1, 8, 1, 4>(blocks, s, c, m, pm, rp, xx, yy, n, d, K);
    } else {  // d > 256: 512 columns per walk
      launch_rows<1, 16, 1, 3>(blocks, s, c, m, pm, rp, xx, yy, n, d, K);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef ELL_REACH_SWEEP
// Tuning entry point, compiled only with -DELL_REACH_SWEEP (by
// tools/kernel_sweep.py): the float4 walk at any (U, MINB) of the sweep,
// NG from d as in ell_reach_f32. Returns cudaErrorInvalidValue for a
// setting outside the swept set.
namespace {

#define REACH_ARGS blocks, s, c, m, pm, rp, xx, yy, n, d, K

template <int NG, int U>
int sweep_minb(int minb, unsigned blocks, cudaStream_t s, const int32_t* c,
               const uint8_t* m, const int32_t* pm, const int32_t* rp,
               const float* xx, float* yy, int n, int d, int K) {
  switch (minb) {
    case 2: launch_rows<4, NG, U, 2>(REACH_ARGS); break;
    case 3: launch_rows<4, NG, U, 3>(REACH_ARGS); break;
    case 4: launch_rows<4, NG, U, 4>(REACH_ARGS); break;
    case 6: launch_rows<4, NG, U, 6>(REACH_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NG>
int sweep_u(int u, int minb, unsigned blocks, cudaStream_t s,
            const int32_t* c, const uint8_t* m, const int32_t* pm,
            const int32_t* rp, const float* xx, float* yy, int n, int d,
            int K) {
  switch (u) {
    case 1: return sweep_minb<NG, 1>(minb, REACH_ARGS);
    case 2: return sweep_minb<NG, 2>(minb, REACH_ARGS);
    case 4: return sweep_minb<NG, 4>(minb, REACH_ARGS);
    case 8: return sweep_minb<NG, 8>(minb, REACH_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int ell_reach_sweep(const void* cols, const void* mask,
                               const void* perm, const void* row_ptr,
                               const void* x, void* y, int n, int d, int K,
                               int u, int minb, void* stream) {
  if (n <= 0 || d < 32 || d % 4 != 0 || d > 384)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      (unsigned)(((long long)n * 32 + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int32_t* pm = static_cast<const int32_t*>(perm);
  const int32_t* rp = static_cast<const int32_t*>(row_ptr);
  const float* xx = static_cast<const float*>(x);
  float* yy = static_cast<float*>(y);
  const int per_lane = (d / 4 + 31) / 32;
  if (per_lane <= 1) return sweep_u<1>(u, minb, REACH_ARGS);
  if (per_lane <= 2) return sweep_u<2>(u, minb, REACH_ARGS);
  return sweep_u<3>(u, minb, REACH_ARGS);
}

#undef REACH_ARGS
#endif  // ELL_REACH_SWEEP
