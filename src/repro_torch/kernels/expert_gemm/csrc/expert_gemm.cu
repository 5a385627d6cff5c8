// Grouped per-expert GEMM (the MoE dispatch matmul) for Hopper (sm_90a).
//
//   y[n] = x[n] @ w[n mod E]      x (N, C, d), w (E, d, f) -> y (N, C, f)
//
// with an f32 accumulator over d. The MoE block hands its whole (G, E, C, d)
// dispatch buffer over as N = G * E matrices, so one launch covers every
// group and expert, and `moe_block` launches it three times per layer
// (gate, up, down).
//
// Replaces the Pallas TPU kernel `expert_gemm_raw` (body `_kernel`) in
// src/repro/kernels/expert_gemm/expert_gemm.py, which the JAX MoE block
// computes as the einsums of src/repro/models/moe.py. The TPU wrapper pads
// C, d and f to multiples of 128 for the MXU; here the ragged edges are
// masked in the kernel instead (zero-filled tiles, guarded stores).
//
// What bounds it on the card: at prefill (C 328, d 2048, f 768, N 256) the
// work is 264 GFLOP per product against about 0.9 GB of x, w and y, so
// operations and bytes are about even at the card's peaks; at decode
// (C 8) only the 403 MB of expert weights count, and bytes bound it.
// So: tensor cores for the products, each weight tile read by one block
// per (C-tile, f-tile), and 16-byte loads.
//
// Design (simple first; no TMA, wgmma or warp specialisation yet):
//  * bf16: one block of 8 warps per (f-tile of 128, C-tile of 128, n). The
//    d loop steps 32 at a time through two shared-memory stages: the next
//    x and w tiles are fetched into registers while the warps run WMMA
//    16x16x16 products (f32 accumulators, 64 x 32 per warp) on the current
//    stage. The epilogue goes through a small per-warp f32 tile in shared
//    memory and writes bf16 under the C and f masks.
//  * f32: a classic 64 x 64 tile with 16-deep steps and 4 x 4 outputs per
//    thread in FMAs (TF32 would lose the digits the f32 configs are held
//    to).
//  * the sum over d runs in a fixed order: two launches give the same bits.
//  * launches on the caller's stream, allocates nothing, returns
//    cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

struct Params {
  const void* x;
  const void* w;
  void* y;
  int N, E, C, d, f;
  int vec_x, vec_w;
};

// ---------------------------------------------------------------------------
// bf16: WMMA tensor-core path
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;  // 8 warps: 2 along C x 4 along f
constexpr int WM = 64, WN = 32;  // per warp: 4 x 2 fragments of 16 x 16
constexpr int LDX = BK + 8;
constexpr int LDW = BN + 8;
constexpr int X_VECS = BM * BK / 8 / THREADS;  // uint4 loads per thread
constexpr int W_VECS = BK * BN / 8 / THREADS;

union Pack8 {  // eight bf16 bit patterns as one 16-byte word
  uint4 u;
  unsigned short h[8];
};

struct Stage {
  bf16 x[BM * LDX];
  bf16 w[BK * LDW];
};

__device__ __forceinline__ void fetch(uint4 (&xr)[X_VECS],
                                      uint4 (&wr)[W_VECS], const bf16* xg,
                                      const bf16* wg, const Params& p,
                                      int c0, int f0, int k0) {
#pragma unroll
  for (int i = 0; i < X_VECS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    const int row = c0 + r, col = k0 + c;
    if (p.vec_x) {
      xr[i] = (row < p.C && col < p.d)
                  ? *reinterpret_cast<const uint4*>(xg + (long long)row * p.d + col)
                  : make_uint4(0u, 0u, 0u, 0u);
    } else {
      Pack8 t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t.h[j] = (row < p.C && col + j < p.d)
                     ? __bfloat16_as_ushort(xg[(long long)row * p.d + col + j])
                     : (unsigned short)0;
      xr[i] = t.u;
    }
  }
#pragma unroll
  for (int i = 0; i < W_VECS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    const int row = k0 + r, col = f0 + c;
    if (p.vec_w) {
      wr[i] = (row < p.d && col < p.f)
                  ? *reinterpret_cast<const uint4*>(wg + (long long)row * p.f + col)
                  : make_uint4(0u, 0u, 0u, 0u);
    } else {
      Pack8 t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t.h[j] = (row < p.d && col + j < p.f)
                     ? __bfloat16_as_ushort(wg[(long long)row * p.f + col + j])
                     : (unsigned short)0;
      wr[i] = t.u;
    }
  }
}

__device__ __forceinline__ void stash(Stage& st, const uint4 (&xr)[X_VECS],
                                      const uint4 (&wr)[W_VECS]) {
#pragma unroll
  for (int i = 0; i < X_VECS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(&st.x[r * LDX + c]) = xr[i];
  }
#pragma unroll
  for (int i = 0; i < W_VECS; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(&st.w[r * LDW + c]) = wr[i];
  }
}

__global__ void __launch_bounds__(THREADS) expert_gemm_bf16(Params p) {
  __shared__ __align__(128) Stage stages[2];
  __shared__ __align__(128) float out_tile[THREADS / 32][16 * 16];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int f0 = blockIdx.x * BN, c0 = blockIdx.y * BM, n = blockIdx.z;
  const bf16* xg = static_cast<const bf16*>(p.x) + (long long)n * p.C * p.d;
  const bf16* wg = static_cast<const bf16*>(p.w) +
                   (long long)(n % p.E) * p.d * p.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 xr[X_VECS], wr[W_VECS];
  const int n_k = (p.d + BK - 1) / BK;
  fetch(xr, wr, xg, wg, p, c0, f0, 0);
  stash(stages[0], xr, wr);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const Stage& st = stages[kt & 1];
    if (kt + 1 < n_k) fetch(xr, wr, xg, wg, p, c0, f0, (kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(a[i], &st.x[(wm * WM + i * 16) * LDX + kk], LDX);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        wmma::load_matrix_sync(b, &st.w[kk * LDW + wn * WN + j * 16], LDW);
#pragma unroll
        for (int i = 0; i < WM / 16; ++i)
          wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    if (kt + 1 < n_k) stash(stages[(kt + 1) & 1], xr, wr);
    __syncthreads();
  }

  bf16* yg = static_cast<bf16*>(p.y) + (long long)n * p.C * p.f;
  float* tile = out_tile[warp];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      wmma::store_matrix_sync(tile, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row0 = c0 + wm * WM + i * 16, col0 = f0 + wn * WN + j * 16;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane * 8 + e;
        const int row = row0 + idx / 16, col = col0 + idx % 16;
        if (row < p.C && col < p.f)
          yg[(long long)row * p.f + col] = __float2bfloat16(tile[idx]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA path
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;
constexpr int F_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(F_THREADS) expert_gemm_f32(Params p) {
  __shared__ float xs[FK][FM + 4];  // x tile, transposed
  __shared__ float ws[FK][FN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int f0 = blockIdx.x * FN, c0 = blockIdx.y * FM, n = blockIdx.z;
  const float* xg = static_cast<const float*>(p.x) + (long long)n * p.C * p.d;
  const float* wg = static_cast<const float*>(p.w) +
                    (long long)(n % p.E) * p.d * p.f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.d; k0 += FK) {
#pragma unroll
    for (int e = 0; e < FM * FK / F_THREADS; ++e) {
      const int v = threadIdx.x + e * F_THREADS;
      const int r = v / FK, c = v % FK;  // x: row r of the tile, depth c
      const int row = c0 + r, col = k0 + c;
      xs[c][r] = (row < p.C && col < p.d) ? xg[(long long)row * p.d + col] : 0.f;
      const int wr = v / FN, wc = v % FN;  // w: depth wr, column wc
      const int wrow = k0 + wr, wcol = f0 + wc;
      ws[wr][wc] = (wrow < p.d && wcol < p.f) ? wg[(long long)wrow * p.f + wcol]
                                              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
  float* yg = static_cast<float*>(p.y) + (long long)n * p.C * p.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + tx * 4 + j;
      if (row < p.C && col < p.f) yg[(long long)row * p.f + col] = acc[i][j];
    }
  }
}

}  // namespace

// x (N, C, d), w (E, d, f), y (N, C, f); contiguous, all bf16 (bf16_io != 0)
// or all f32; N % E == 0. Returns a cudaError_t.
extern "C" int expert_gemm(const void* x, const void* w, void* y, int N,
                           int E, int C, int d, int f, int bf16_io,
                           void* stream) {
  if (N <= 0 || C <= 0 || f <= 0) return 0;
  if (E <= 0 || N % E != 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w = w;
  p.y = y;
  p.N = N;
  p.E = E;
  p.C = C;
  p.d = d;
  p.f = f;
  p.vec_x = (d % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  p.vec_w = (f % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_io) {
    const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, N);
    expert_gemm_bf16<<<grid, THREADS, 0, s>>>(p);
  } else {
    const dim3 grid((f + FN - 1) / FN, (C + FM - 1) / FM, N);
    expert_gemm_f32<<<grid, F_THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
