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
// levers are fewer bytes and enough gathers in flight. With x larger than
// L2 (335 MB at the full mirror's d = 320) the gathers alone, nnz * d * 4
// bytes, set a realistic floor well above the "x read once" bound.
//
// Design:
//  * one warp per destination vertex. The warp walks the vertex's rows in
//    ascending row order through a row index (`perm`, `row_ptr`) sorted
//    stably by owning vertex, built once per mirror version by the wrapper.
//    Spill rows handed out from a shared cursor need not sit next to their
//    vertex's first row, and the index finds them wherever they are. Rows
//    with no live entry are not in the index, so the unallocated capacity
//    rows (all owned by vertex 0) never reach vertex 0's warp.
//  * d >= 32 (`ell_spmm_rows`): each row is walked once. Its 32-slot
//    slices of mask, cols and vals are read once, coalesced; one ballot
//    finds the live entries, which are broadcast lane to lane in ascending
//    k, U at a time. Lanes run across the columns: lane l owns the float4
//    groups l, l + 32, ... (NG of them; at d = 320, 80 groups: three on
//    lanes 0-15, two on the rest) and gathers them with 16-byte loads, so
//    one live entry's row of x is read in whole 128-byte lines, and U * NG
//    independent loads are in flight per lane before the first FMA. Where
//    d % 4 != 0 or x is not 16-byte aligned the same walk gathers single
//    floats (VW = 1). Wider than 32 * VW * NG columns (512 here), the walk
//    repeats per 512-column chunk. The first design re-walked every row
//    once per 32 columns with one 4-byte gather in flight per lane.
//  * what limits the walk is the chain of dependent loads per vertex
//    (row_ptr, perm, the row's slots, then x), so warps in flight matter
//    more than loads in flight per warp: a sweep of U and of the
//    registers per thread on an H100 (U 1-8, 1-4 blocks of 8 warps per
//    SM, d 96-320, on chip_smoke's tile and on one with 57 % empty
//    vertices) found small batches (U 2-4) with the registers capped by
//    __launch_bounds__ fastest, 2-5x faster than U = 8 at 120-170
//    registers. The table in launch() keeps those settings.
//  * d < 32 (`ell_spmm_small`): lanes run across K for the loads instead:
//    each lane reads its slot of the row and gathers that slot's row of x
//    (d floats, the column count a template bound) into shared memory,
//    then lane j < d chains the fused multiply-adds of column j over the
//    live slots in ascending k. So the small variant sums in the wide
//    walk's order (below), and a column's bits do not depend on how many
//    columns ride in its block: a sweep block split over the query axis
//    of the engine's mesh (narrower, perhaps below 32 columns) gives the
//    bits of the whole block. (The first small variant kept a partial
//    per lane and met them in a shuffle tree, another order; broadcasting
//    each live slot's row lane to lane by shuffles kept the order but was
//    57 % slower at d = 4 on chip_smoke's tile.)
//  * no atomics and a fixed summation order, the same in all three
//    variants: a row's partial is summed in ascending k by fused
//    multiply-adds, then added to the vertex's total, rows in the index's
//    order. Every vertex's sum is formed by one warp
//    in the same order on every run, so the result is bitwise the same
//    from run to run (the seed top-k and the expander argmax of G-Ray read
//    these values). It is the first design's order and its arithmetic
//    (`part += w * x`, contracted to an FMA by nvcc), so the two give the
//    same bits.
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

__device__ __forceinline__ void fma_into(float (&part)[4], float w,
                                         const float4& xv) {
  part[0] = __fmaf_rn(w, xv.x, part[0]);
  part[1] = __fmaf_rn(w, xv.y, part[1]);
  part[2] = __fmaf_rn(w, xv.z, part[2]);
  part[3] = __fmaf_rn(w, xv.w, part[3]);
}

__device__ __forceinline__ void fma_into(float (&part)[1], float w,
                                         float xv) {
  part[0] = __fmaf_rn(w, xv, part[0]);
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
    ell_spmm_rows(const int32_t* __restrict__ cols,
                  const float* __restrict__ vals,
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
    float acc[NG][VW];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int c = 0; c < VW; ++c) acc[i][c] = 0.f;
    for (int p = p0; p < p1; ++p) {
      const long long base = (long long)perm[p] * K;
      float part[NG][VW];
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int c = 0; c < VW; ++c) part[i][c] = 0.f;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int kk = k0 + lane;
        const bool m = kk < K && mask[base + kk] != 0;
        const int col = m ? cols[base + kk] : 0;
        const float w = m ? vals[base + kk] : 0.f;
        unsigned bits = __ballot_sync(kFull, m);
        while (bits) {  // warp-uniform: every lane holds the same ballot
          int src[U];
          float wj[U];
          bool live[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            live[u] = bits != 0;
            const int j = live[u] ? __ffs(bits) - 1 : 0;
            bits &= bits - 1;
            src[u] = __shfl_sync(kFull, col, j);
            wj[u] = __shfl_sync(kFull, w, j);
          }
          // every gather of the batch is issued before the first FMA
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
              if (live[u] && on[i]) fma_into(part[i], wj[u], xv[u][i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int c = 0; c < VW; ++c) acc[i][c] += part[i][c];
    }
#pragma unroll
    for (int i = 0; i < NG; ++i)
      if (on[i]) store(y + v * d + col_of[i], acc[i]);
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
  // per warp: each slot's weight and gathered row of x (DM + 1 floats a
  // row, so the stores at a stride of DM + 1 and the reads along a row
  // hit distinct banks)
  __shared__ float xs[kThreads / 32][32][DM + 1];
  __shared__ float ws[kThreads / 32][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long v =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (v >= n) return;  // warp-uniform
  const int p0 = row_ptr[v];
  const int p1 = row_ptr[v + 1];
  float acc = 0.f;  // lane j < d owns column j
  for (int p = p0; p < p1; ++p) {
    const long long base = (long long)perm[p] * K;
    float part = 0.f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int kk = k0 + lane;
      const bool m = kk < K && mask[base + kk] != 0;
      unsigned bits = __ballot_sync(kFull, m);
      if (!bits) continue;  // warp-uniform: no live slot in this slice
      if (m) {  // each live slot gathers its row of x before the sum
        const float* xr = x + (long long)cols[base + kk] * d;
        ws[warp][lane] = vals[base + kk];
#pragma unroll
        for (int j = 0; j < DM; ++j)
          if (j < d) xs[warp][lane][j] = __ldg(xr + j);
      }
      __syncwarp();
      if (lane < d) {
        while (bits) {  // live slots in ascending k, 4 loads in flight
          float wv[4], xv[4];
          bool live[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            live[u] = bits != 0;
            const int src = live[u] ? __ffs(bits) - 1 : 0;
            bits &= bits - 1;
            wv[u] = ws[warp][src];
            xv[u] = xs[warp][src][lane];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (live[u]) part = __fmaf_rn(wv[u], xv[u], part);
        }
      }
      __syncwarp();
    }
    acc += part;
  }
  if (lane < d) y[v * d + lane] = acc;
}

template <int VW, int NG, int U, int MINB>
void launch_rows(unsigned blocks, cudaStream_t s, const int32_t* c,
                 const float* w, const uint8_t* m, const int32_t* pm,
                 const int32_t* rp, const float* xx, float* yy, int n, int d,
                 int K) {
  ell_spmm_rows<VW, NG, U, MINB><<<blocks, kThreads, 0, s>>>(
      c, w, m, pm, rp, xx, yy, n, d, K);
}

}  // namespace

// variant (ops.py: VARIANTS): 0 small (d < 32), 1 wide float4
// (d >= 32, d % 4 == 0, x 16-byte aligned), 2 wide scalar (d >= 32).
extern "C" int ell_spmm_f32(const void* cols, const void* vals,
                            const void* mask, const void* perm,
                            const void* row_ptr, const void* x, void* y,
                            int n, int d, int K, int variant, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (variant < 0 || variant > 2 || (variant == 0) != (d < 32) ||
      (variant == 1 && d % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (variant == 0) {
    if (d <= 4) {
      ell_spmm_small<4><<<blocks, kThreads, 0, s>>>(c, w, m, pm, rp, xx, yy, n, d, K);
    } else if (d <= 8) {
      ell_spmm_small<8><<<blocks, kThreads, 0, s>>>(c, w, m, pm, rp, xx, yy, n, d, K);
    } else if (d <= 16) {
      ell_spmm_small<16><<<blocks, kThreads, 0, s>>>(c, w, m, pm, rp, xx, yy, n, d, K);
    } else {
      ell_spmm_small<32><<<blocks, kThreads, 0, s>>>(c, w, m, pm, rp, xx, yy, n, d, K);
    }
  } else if (variant == 1) {
    // (NG, U, MINB) from the sweep described at the top of this file
    const int per_lane = (d / 4 + 31) / 32;  // float4 groups per lane
    if (per_lane <= 1) {
      launch_rows<4, 1, 4, 4>(blocks, s, c, w, m, pm, rp, xx, yy, n, d, K);
    } else if (per_lane <= 2) {
      launch_rows<4, 2, 2, 4>(blocks, s, c, w, m, pm, rp, xx, yy, n, d, K);
    } else if (per_lane <= 3) {
      launch_rows<4, 3, 2, 3>(blocks, s, c, w, m, pm, rp, xx, yy, n, d, K);
    } else {  // d > 384: 512 columns per walk
      launch_rows<4, 4, 1, 3>(blocks, s, c, w, m, pm, rp, xx, yy, n, d, K);
    }
  } else {
    const int per_lane = (d + 31) / 32;  // floats per lane
    if (per_lane <= 2) {
      launch_rows<1, 2, 4, 4>(blocks, s, c, w, m, pm, rp, xx, yy, n, d, K);
    } else if (per_lane <= 4) {
      launch_rows<1, 4, 2, 4>(blocks, s, c, w, m, pm, rp, xx, yy, n, d, K);
    } else if (per_lane <= 8) {
      launch_rows<1, 8, 1, 4>(blocks, s, c, w, m, pm, rp, xx, yy, n, d, K);
    } else {  // d > 256: 512 columns per walk
      launch_rows<1, 16, 1, 3>(blocks, s, c, w, m, pm, rp, xx, yy, n, d, K);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
