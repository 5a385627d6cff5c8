// Causal GQA flash attention, backward, for Hopper (sm_90a).
//
// Given the forward's inputs q (B, Sq, H, hd), k, v (B, Sk, KV, hd), the
// output's gradient dO (B, Sq, H, hd), each query row's log-sum-exp
// lse (B, H, Sq) of its scaled scores (written by the forward kernels) and
// D = rowsum(dO * O) (B, H, Sq), f32, it writes
//
//   P  = exp(scale * q k^T - lse)       (masked entries 0)
//   dV = sum over the G query heads of P^T dO
//   dS = P * (dO v^T - D)
//   dK = scale * sum over the G query heads of dS^T q
//   dQ = scale * dS k
//
// with scale = 1/sqrt(hd) of the true head dim, keys j < Sk and, when
// causal, j <= q_offset + i. Tensors keep the model layout, contiguous.
//
// Replaces the gradient of the Pallas TPU kernel `flash_attention_fwd` in
// src/repro/kernels/flash_attention/flash_attention.py, which has no
// backward of its own: the JAX package trains through XLA's autodiff of
// `blockwise_attention` (src/repro/models/layers.py:43). FlashAttention-2's
// backward is the design, in two passes so that no sum crosses blocks:
//
//  * pass 1, one CTA per (block of keys, KV head, batch): the key block's
//    K and V stay in shared memory while the CTA walks the G query heads
//    of its KV head and, for each, the query blocks from the causal
//    diagonal on, in that fixed order; it recomputes P^T and dP^T and
//    accumulates dV and dK in registers, so they come out per KV head,
//    summed over the group, with no atomics. Causal key blocks run first
//    (blockIdx.z 0 is key block 0, the one with the most queries).
//  * pass 2, one CTA per (block of queries, query head, batch): Q and dO
//    stay in shared memory while the CTA walks the key blocks up to the
//    diagonal (blocks above it are never loaded), recomputes P and dP and
//    accumulates dQ. The longest causal rows run first.
//
// What bounds it on the card: operations. The work is five products of
// the forward's size (S, dP, dV, dK, dQ: 10 * hd flops per visible (query,
// key) pair and head; this design recomputes S and dP in pass 2, seven in
// all); at the train shape (B 1, S 4096, H 32, hd 128, causal) 344 GFLOP
// against 152 MB of q, k, v, o, dO, lse and the gradients. So the
// products belong on the tensor cores and P, dS never reach device memory.
//
// Variants (simple first; no TMA or wgmma yet):
//  * bf16, any hd <= 128 padded to 64 or 128: mma.sync m16n8k16 with f32
//    accumulation, as flash_attention_fwd.cu. Each warp owns 16 keys
//    (pass 1) or 16 queries (pass 2); P and dS are rounded to bf16 in
//    registers and reused as A fragments of the next product; the tiles
//    that the product reads transposed (dO, Q in pass 1; K in pass 2) go
//    through ldmatrix.trans.
//  * f32, hd <= 128 padded to 32, 64 or 128: plain FMAs in f32 with 32-key,
//    32-query tiles; P and dS go through shared memory.
//  * every sum runs in a fixed order and there are no atomics, so two
//    launches give the same bits.
//  * launches on the caller's stream, allocates nothing, returns a
//    cudaError_t so the wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KV, hd, q_offset, causal, vec;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: tensor-core path (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 rows
constexpr int K1_BK = 64;        // pass 1: keys per CTA
constexpr int K1_BQ = 32;        // pass 1: queries per step
constexpr int Q2_BQ = 64;        // pass 2: queries per CTA
constexpr int Q2_BK = 64;        // pass 2: keys per step

template <int HDP>
struct Pass1Layout {
  static constexpr int LD = HDP + 8;  // 16-byte rows, conflict-free reads
  static constexpr size_t bytes =
      (size_t)(2 * K1_BK + 2 * K1_BQ) * LD * 2 + 2 * K1_BQ * 4;
};

template <int HDP>
struct Pass2Layout {
  static constexpr int LD = HDP + 8;
  static constexpr size_t bytes = (size_t)(2 * Q2_BQ + 2 * Q2_BK) * LD * 2;
};

// A fragment (16 x 16, rows r0 and r0 + 8 of this thread) of a row-major
// bf16 tile in shared memory, at k-step kk
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int kk, int t) {
  const bf16* lo = tile + r0 * ld + kk * 16 + 2 * t;
  const bf16* hi = lo + 8 * ld;
  a[0] = ld32(lo);
  a[1] = ld32(hi);
  a[2] = ld32(lo + 8);
  a[3] = ld32(hi + 8);
}

// the A fragment of k-step kk from two 8-column accumulator tiles, rounded
// to bf16 (the accumulator layout of m16n8 is the A layout of m16k16)
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS)
    flash_bwd_dkdv_bf16(Params p) {
  constexpr int LD = Pass1Layout<HDP>::LD;
  constexpr int NKD = HDP / 16;    // k-steps over the head dim
  constexpr int NQ = K1_BQ / 8;    // 8-query column tiles of S^T
  constexpr int NO = HDP / 8;      // 8-dim column tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + K1_BK * LD;
  bf16* Qs = Vs + K1_BK * LD;
  bf16* dOs = Qs + K1_BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + K1_BQ * LD);
  float* d_s = lse_s + K1_BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * K1_BK;
  const int G = p.H / p.KV;
  const long long q_stride = (long long)p.H * p.hd;
  const long long kv_stride = (long long)p.KV * p.hd;
  const int kv_valid = min(K1_BK, p.Sk - kv0);
  const long long kv_off =
      ((long long)b * p.Sk + kv0) * kv_stride + (long long)kvh * p.hd;
  load_tile_bf16<HDP, TC_THREADS>(Ks, LD, K1_BK,
                                  static_cast<const bf16*>(p.k) + kv_off,
                                  kv_stride, kv_valid, p.hd, p.vec != 0);
  load_tile_bf16<HDP, TC_THREADS>(Vs, LD, K1_BK,
                                  static_cast<const bf16*>(p.v) + kv_off,
                                  kv_stride, kv_valid, p.hd, p.vec != 0);

  const int r0 = warp * 16 + g;  // this thread's keys r0 and r0 + 8
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // the first query block with a row that sees key kv0
  int q_first = 0;
  if (p.causal) q_first = max(0, kv0 - p.q_offset) / K1_BQ * K1_BQ;
  for (int hq = 0; hq < G; ++hq) {
    const int h = kvh * G + hq;
    const long long q_off =
        (long long)b * p.Sq * q_stride + (long long)h * p.hd;
    const float* lse_g = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* d_g = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int q0 = q_first; q0 < p.Sq; q0 += K1_BQ) {
      const int q_valid = min(K1_BQ, p.Sq - q0);
      __syncthreads();  // every warp is done with the previous Q and dO
      load_tile_bf16<HDP, TC_THREADS>(
          Qs, LD, K1_BQ, static_cast<const bf16*>(p.q) + q_off + q0 * q_stride,
          q_stride, q_valid, p.hd, p.vec != 0);
      load_tile_bf16<HDP, TC_THREADS>(
          dOs, LD, K1_BQ,
          static_cast<const bf16*>(p.dout) + q_off + q0 * q_stride, q_stride,
          q_valid, p.hd, p.vec != 0);
      if (threadIdx.x < K1_BQ) {
        const int i = threadIdx.x;
        lse_s[i] = i < q_valid ? lse_g[q0 + i] : 0.f;
        d_s[i] = i < q_valid ? d_g[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries per warp
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk) {
        uint32_t ka[4], va[4];
        a_frag(ka, Ks, LD, r0, kk, t);
        a_frag(va, Vs, LD, r0, kk, t);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const bf16* q_row = Qs + (j * 8 + g) * LD + kk * 16 + 2 * t;
          const bf16* do_row = dOs + (j * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16(s[j], ka, ld32(q_row), ld32(q_row + 8));
          mma_bf16(dp[j], va, ld32(do_row), ld32(do_row + 8));
        }
      }

      // P^T and dS^T = P^T * (dP^T - D) in place
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);  // query within the block
          const int key = r0 + 8 * (e >> 1);       // key within the block
          const bool valid =
              key < kv_valid && qi < q_valid &&
              (!p.causal || kv0 + key <= p.q_offset + q0 + qi);
          const float pe = valid ? expf(s[j][e] * p.scale - lse_s[qi]) : 0.f;
          s[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - d_s[qi]);
        }
      }

      // dV += P^T dO, dK += dS^T Q: k-steps over the block's queries
#pragma unroll
      for (int kk = 0; kk < K1_BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
        const bf16* do_rows = dOs + (kk * 16 + (lane & 15)) * LD;
        const bf16* q_rows = Qs + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, do_rows + j * 8);
          mma_bf16(dv[j], pa, b0, b1);
          ldmatrix_x2_trans(b0, b1, q_rows + j * 8);
          mma_bf16(dk[j], da, b0, b1);
        }
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + kv_off;
  bf16* dvg = static_cast<bf16*>(p.dv) + kv_off;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = r0 + 8 * hi;
    if (row >= kv_valid) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + 2 * t;
      const long long at = row * kv_stride + c;
      if (c < p.hd) {
        dkg[at] = __float2bfloat16(dk[j][2 * hi] * p.scale);
        dvg[at] = __float2bfloat16(dv[j][2 * hi]);
      }
      if (c + 1 < p.hd) {
        dkg[at + 1] = __float2bfloat16(dk[j][2 * hi + 1] * p.scale);
        dvg[at + 1] = __float2bfloat16(dv[j][2 * hi + 1]);
      }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dq_bf16(Params p) {
  constexpr int LD = Pass2Layout<HDP>::LD;
  constexpr int NKD = HDP / 16;
  constexpr int NS = Q2_BK / 8;    // 8-key column tiles of S
  constexpr int NO = HDP / 8;      // 8-dim column tiles of dQ
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + Q2_BQ * LD;
  bf16* Ks = dOs + Q2_BQ * LD;
  bf16* Vs = Ks + Q2_BK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * Q2_BQ;  // longest rows first
  const int kvh = h / (p.H / p.KV);
  const long long q_stride = (long long)p.H * p.hd;
  const long long kv_stride = (long long)p.KV * p.hd;
  const int q_valid = min(Q2_BQ, p.Sq - q0);
  const long long q_off =
      ((long long)b * p.Sq + q0) * q_stride + (long long)h * p.hd;
  load_tile_bf16<HDP, TC_THREADS>(Qs, LD, Q2_BQ,
                                  static_cast<const bf16*>(p.q) + q_off,
                                  q_stride, q_valid, p.hd, p.vec != 0);
  load_tile_bf16<HDP, TC_THREADS>(dOs, LD, Q2_BQ,
                                  static_cast<const bf16*>(p.dout) + q_off,
                                  q_stride, q_valid, p.hd, p.vec != 0);

  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8
  float lse_r[2], d_r[2];
  int q_pos[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + r0 + 8 * hi;
    const long long at = ((long long)b * p.H + h) * p.Sq + row;
    lse_r[hi] = row < p.Sq ? p.lse[at] : 0.f;
    d_r[hi] = row < p.Sq ? p.delta[at] : 0.f;
    q_pos[hi] = p.q_offset + row;
  }
  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  const bf16* kg =
      static_cast<const bf16*>(p.k) + (long long)b * p.Sk * kv_stride +
      (long long)kvh * p.hd;
  const bf16* vg =
      static_cast<const bf16*>(p.v) + (long long)b * p.Sk * kv_stride +
      (long long)kvh * p.hd;
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, p.q_offset + q0 + Q2_BQ);
  for (int kv0 = 0; kv0 < kv_end; kv0 += Q2_BK) {
    const int kv_valid = min(Q2_BK, p.Sk - kv0);
    __syncthreads();  // every warp is done with the previous K and V
    load_tile_bf16<HDP, TC_THREADS>(Ks, LD, Q2_BK, kg + kv0 * kv_stride,
                                    kv_stride, kv_valid, p.hd, p.vec != 0);
    load_tile_bf16<HDP, TC_THREADS>(Vs, LD, Q2_BK, vg + kv0 * kv_stride,
                                    kv_stride, kv_valid, p.hd, p.vec != 0);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKD; ++kk) {
      uint32_t qa[4], oa[4];
      a_frag(qa, Qs, LD, r0, kk, t);
      a_frag(oa, dOs, LD, r0, kk, t);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bf16* k_row = Ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* v_row = Vs + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[j], qa, ld32(k_row), ld32(k_row + 8));
        mma_bf16(dp[j], oa, ld32(v_row), ld32(v_row + 8));
      }
    }

    // dS = P * (dP - D), P = exp(scale * S - lse), in place in s
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        const int hi = e >> 1;
        const bool valid = key - kv0 < kv_valid &&
                           r0 + 8 * hi < q_valid &&
                           (!p.causal || key <= q_pos[hi]);
        const float pe = valid ? expf(s[j][e] * p.scale - lse_r[hi]) : 0.f;
        s[j][e] = pe * (dp[j][e] - d_r[hi]);
      }
    }

    // dQ += dS K: k-steps over the block's keys, K read transposed
#pragma unroll
    for (int kk = 0; kk < Q2_BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
      const bf16* k_rows = Ks + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, k_rows + j * 8);
        mma_bf16(dq[j], da, b0, b1);
      }
    }
  }

  bf16* dqg = static_cast<bf16*>(p.dq) + q_off;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = r0 + 8 * hi;
    if (row >= q_valid) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + 2 * t;
      const long long at = row * q_stride + c;
      if (c < p.hd) dqg[at] = __float2bfloat16(dq[j][2 * hi] * p.scale);
      if (c + 1 < p.hd)
        dqg[at + 1] = __float2bfloat16(dq[j][2 * hi + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA path
// ---------------------------------------------------------------------------

constexpr int F_BK = 32;         // keys per tile
constexpr int F_BQ = 32;         // queries per tile
constexpr int F_THREADS = 128;   // 4 warps x 8 rows
constexpr int F_ROWS = 8;        // rows a warp owns: keys (1), queries (2)

template <int HDP>
struct F32Layout {
  static constexpr int LDP = HDP + 1;    // column-wise reads across lanes
  static constexpr int LDT = F_BQ + 1;   // P, dS tiles
  static constexpr size_t bytes =
      (size_t)(2 * F_BK * LDP + 2 * F_BQ * LDP + 2 * F_BK * LDT + 2 * F_BQ) *
      4;
};

__device__ __forceinline__ void load_tile_f32(float* dst, int ldp, int hdp,
                                              int rows, const float* src,
                                              long long stride,
                                              int rows_valid, int hd) {
  for (int i = threadIdx.x; i < rows * hdp; i += F_THREADS) {
    const int r = i / hdp, c = i % hdp;
    dst[r * ldp + c] = (r < rows_valid && c < hd) ? src[r * stride + c] : 0.f;
  }
}

template <int HDP>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dkdv_f32(Params p) {
  using L = F32Layout<HDP>;
  constexpr int LDP = L::LDP, LDT = L::LDT;
  constexpr int NC = HDP / 32;  // columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + F_BK * LDP;
  float* Qs = Vs + F_BK * LDP;
  float* dOs = Qs + F_BQ * LDP;
  float* Ps = dOs + F_BQ * LDP;   // [key][query]
  float* dSs = Ps + F_BK * LDT;   // [key][query]
  float* lse_s = dSs + F_BK * LDT;
  float* d_s = lse_s + F_BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * F_BK;
  const int G = p.H / p.KV;
  const long long q_stride = (long long)p.H * p.hd;
  const long long kv_stride = (long long)p.KV * p.hd;
  const int kv_valid = min(F_BK, p.Sk - kv0);
  const long long kv_off =
      ((long long)b * p.Sk + kv0) * kv_stride + (long long)kvh * p.hd;
  load_tile_f32(Ks, LDP, HDP, F_BK, static_cast<const float*>(p.k) + kv_off,
                kv_stride, kv_valid, p.hd);
  load_tile_f32(Vs, LDP, HDP, F_BK, static_cast<const float*>(p.v) + kv_off,
                kv_stride, kv_valid, p.hd);

  float dk[F_ROWS][NC], dv[F_ROWS][NC];  // keys warp*8 + r, columns lane + 32j
#pragma unroll
  for (int r = 0; r < F_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk[r][j] = dv[r][j] = 0.f;

  int q_first = 0;
  if (p.causal) q_first = max(0, kv0 - p.q_offset) / F_BQ * F_BQ;
  for (int hq = 0; hq < G; ++hq) {
    const int h = kvh * G + hq;
    const long long q_off =
        (long long)b * p.Sq * q_stride + (long long)h * p.hd;
    const float* lse_g = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* d_g = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int q0 = q_first; q0 < p.Sq; q0 += F_BQ) {
      const int q_valid = min(F_BQ, p.Sq - q0);
      __syncthreads();  // the previous Q, dO, P and dS are no longer read
      load_tile_f32(Qs, LDP, HDP, F_BQ,
                    static_cast<const float*>(p.q) + q_off + q0 * q_stride,
                    q_stride, q_valid, p.hd);
      load_tile_f32(dOs, LDP, HDP, F_BQ,
                    static_cast<const float*>(p.dout) + q_off + q0 * q_stride,
                    q_stride, q_valid, p.hd);
      if (threadIdx.x < F_BQ) {
        const int i = threadIdx.x;
        lse_s[i] = i < q_valid ? lse_g[q0 + i] : 0.f;
        d_s[i] = i < q_valid ? d_g[q0 + i] : 0.f;
      }
      __syncthreads();

      // P^T and dS^T for this warp's 8 keys; lane = query
#pragma unroll
      for (int r = 0; r < F_ROWS; ++r) {
        const int key = warp * F_ROWS + r;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int c = 0; c < HDP; ++c) {
          s += Ks[key * LDP + c] * Qs[lane * LDP + c];
          dp += Vs[key * LDP + c] * dOs[lane * LDP + c];
        }
        const bool valid = key < kv_valid && lane < q_valid &&
                           (!p.causal || kv0 + key <= p.q_offset + q0 + lane);
        const float pe = valid ? expf(s * p.scale - lse_s[lane]) : 0.f;
        Ps[key * LDT + lane] = pe;
        dSs[key * LDT + lane] = pe * (dp - d_s[lane]);
      }
      __syncwarp();  // a warp reads back only its own keys' rows

      // dV += P^T dO, dK += dS^T Q over the block's queries, in order
      for (int qq = 0; qq < F_BQ; ++qq) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float dov = dOs[qq * LDP + lane + 32 * j];
          const float qv = Qs[qq * LDP + lane + 32 * j];
#pragma unroll
          for (int r = 0; r < F_ROWS; ++r) {
            const int key = warp * F_ROWS + r;
            dv[r][j] += Ps[key * LDT + qq] * dov;
            dk[r][j] += dSs[key * LDT + qq] * qv;
          }
        }
      }
    }
  }

  float* dkg = static_cast<float*>(p.dk) + kv_off;
  float* dvg = static_cast<float*>(p.dv) + kv_off;
#pragma unroll
  for (int r = 0; r < F_ROWS; ++r) {
    const int key = warp * F_ROWS + r;
    if (key >= kv_valid) break;  // warp-uniform
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < p.hd) {
        dkg[key * kv_stride + c] = dk[r][j] * p.scale;
        dvg[key * kv_stride + c] = dv[r][j];
      }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dq_f32(Params p) {
  using L = F32Layout<HDP>;
  constexpr int LDP = L::LDP, LDT = L::LDT;
  constexpr int NC = HDP / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + F_BK * LDP;
  float* Qs = Vs + F_BK * LDP;
  float* dOs = Qs + F_BQ * LDP;
  float* dSs = dOs + F_BQ * LDP;  // [query][key]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * F_BQ;
  const int kvh = h / (p.H / p.KV);
  const long long q_stride = (long long)p.H * p.hd;
  const long long kv_stride = (long long)p.KV * p.hd;
  const int q_valid = min(F_BQ, p.Sq - q0);
  const long long q_off =
      ((long long)b * p.Sq + q0) * q_stride + (long long)h * p.hd;
  load_tile_f32(Qs, LDP, HDP, F_BQ, static_cast<const float*>(p.q) + q_off,
                q_stride, q_valid, p.hd);
  load_tile_f32(dOs, LDP, HDP, F_BQ,
                static_cast<const float*>(p.dout) + q_off, q_stride, q_valid,
                p.hd);
  float lse_r[F_ROWS], d_r[F_ROWS], dq[F_ROWS][NC];
#pragma unroll
  for (int r = 0; r < F_ROWS; ++r) {
    const int row = q0 + warp * F_ROWS + r;
    const long long at = ((long long)b * p.H + h) * p.Sq + row;
    lse_r[r] = row < p.Sq ? p.lse[at] : 0.f;
    d_r[r] = row < p.Sq ? p.delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) dq[r][j] = 0.f;
  }

  const float* kg = static_cast<const float*>(p.k) +
                    (long long)b * p.Sk * kv_stride + (long long)kvh * p.hd;
  const float* vg = static_cast<const float*>(p.v) +
                    (long long)b * p.Sk * kv_stride + (long long)kvh * p.hd;
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, p.q_offset + q0 + F_BQ);
  for (int kv0 = 0; kv0 < kv_end; kv0 += F_BK) {
    const int kv_valid = min(F_BK, p.Sk - kv0);
    __syncthreads();  // the previous K, V and dS are no longer read
    load_tile_f32(Ks, LDP, HDP, F_BK, kg + kv0 * kv_stride, kv_stride,
                  kv_valid, p.hd);
    load_tile_f32(Vs, LDP, HDP, F_BK, vg + kv0 * kv_stride, kv_stride,
                  kv_valid, p.hd);
    __syncthreads();

    // dS for this warp's 8 rows; lane = key
#pragma unroll
    for (int r = 0; r < F_ROWS; ++r) {
      const int row = warp * F_ROWS + r;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int c = 0; c < HDP; ++c) {
        s += Qs[row * LDP + c] * Ks[lane * LDP + c];
        dp += dOs[row * LDP + c] * Vs[lane * LDP + c];
      }
      const bool valid = lane < kv_valid && row < q_valid &&
                         (!p.causal || kv0 + lane <= p.q_offset + q0 + row);
      const float pe = valid ? expf(s * p.scale - lse_r[r]) : 0.f;
      dSs[row * LDT + lane] = pe * (dp - d_r[r]);
    }
    __syncwarp();  // a warp reads back only its own rows

    // dQ += dS K over the block's keys, in order
    for (int kk = 0; kk < F_BK; ++kk) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kv = Ks[kk * LDP + lane + 32 * j];
#pragma unroll
        for (int r = 0; r < F_ROWS; ++r)
          dq[r][j] += dSs[(warp * F_ROWS + r) * LDT + kk] * kv;
      }
    }
  }

  float* dqg = static_cast<float*>(p.dq) + q_off;
#pragma unroll
  for (int r = 0; r < F_ROWS; ++r) {
    const int row = warp * F_ROWS + r;
    if (row >= q_valid) break;  // warp-uniform
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < p.hd) dqg[row * q_stride + c] = dq[r][j] * p.scale;
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_bf16(const Params& p, cudaStream_t s) {
  const dim3 grid1(p.KV, p.B, (p.Sk + K1_BK - 1) / K1_BK);
  int rc = launch(flash_bwd_dkdv_bf16<HDP>, grid1, TC_THREADS,
                  Pass1Layout<HDP>::bytes, p, s);
  if (rc != 0) return rc;
  const dim3 grid2(p.H, p.B, (p.Sq + Q2_BQ - 1) / Q2_BQ);
  return launch(flash_bwd_dq_bf16<HDP>, grid2, TC_THREADS,
                Pass2Layout<HDP>::bytes, p, s);
}

template <int HDP>
int launch_f32(const Params& p, cudaStream_t s) {
  const dim3 grid1(p.KV, p.B, (p.Sk + F_BK - 1) / F_BK);
  int rc = launch(flash_bwd_dkdv_f32<HDP>, grid1, F_THREADS,
                  F32Layout<HDP>::bytes, p, s);
  if (rc != 0) return rc;
  const dim3 grid2(p.H, p.B, (p.Sq + F_BQ - 1) / F_BQ);
  return launch(flash_bwd_dq_f32<HDP>, grid2, F_THREADS,
                F32Layout<HDP>::bytes, p, s);
}

}  // namespace

// q, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Sk, KV, hd); lse, delta:
// f32 (B, H, Sq); all contiguous, the tensors all bf16 (bf16_io != 0) or
// all f32. hd <= 128, H % KV == 0, Sq, Sk >= 1. Returns a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   int q_offset, int causal, int bf16_io,
                                   void* stream) {
  if (B <= 0 || H <= 0 || hd <= 0) return 0;
  if (Sq <= 0 || Sk <= 0 || hd > 128 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.hd = hd;
  p.q_offset = q_offset;
  p.causal = causal;
  p.scale = 1.f / sqrtf(static_cast<float>(hd));
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  p.vec = (hd % 8 == 0) && (any % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_io) {
    if (hd <= 64) return launch_bf16<64>(p, s);
    return launch_bf16<128>(p, s);
  }
  if (hd <= 32) return launch_f32<32>(p, s);
  if (hd <= 64) return launch_f32<64>(p, s);
  return launch_f32<128>(p, s);
}
