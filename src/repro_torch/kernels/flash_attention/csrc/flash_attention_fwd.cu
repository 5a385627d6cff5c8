// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
//   o[b, i, h, :] = softmax_j(scale * q[b, i, h, :] . k[b, j, h/G, :]) v[b, j, h/G, :]
//
// over keys j < Sk (and j <= q_offset + i when causal), scale = 1/sqrt(hd),
// G = H / KV query heads per KV head. Tensors keep the model layout:
// q, o (B, Sq, H, hd) and k, v (B, Sk, KV, hd), contiguous.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (body `_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py together with its
// wrapper `flash_attention` (src/repro/kernels/flash_attention/ops.py). The
// TPU wrapper copies K and V G times (`jnp.repeat`) and pads hd to 128
// lanes and S to the block size; none of that is done here: the KV head is
// read as h / G straight from k and v, and the ragged edges of S and hd are
// masked in the kernel.
//
// What bounds it on the card: operations. The work is 4 * B * H * hd flops
// per visible (query, key) pair, about S^2 / 2 pairs per head when causal;
// at the prefill shape (B 2, S 4096, H 32, hd 128) that is 275 GFLOP
// against 151 MB of q, k, v and o, far above the card's flop/byte balance.
// So the products belong on the tensor cores, and the score matrix must
// never reach device memory.
//
// Design (simple first; no TMA, wgmma or warp specialisation yet):
//  * one block of 4 warps per (tile of 64 query rows, q-head, batch), the
//    tiles with the longest causal rows launched first. A loop over 64-key
//    tiles takes the place of the TPU's sequential KV grid axis and stops
//    at the diagonal (tiles above it are never loaded).
//  * bf16: both products run on the tensor cores as mma.sync m16n8k16
//    with f32 accumulation, FlashAttention-2 style. Each warp owns 16
//    query rows: their Q fragments stay in registers for the whole loop,
//    and so do the 16 x 64 scores S = Q K^T and the 16 x hd accumulator O.
//    The four threads of a quad hold a row between them, so the running
//    max m and denominator l are updated in registers with two shuffles;
//    the scale is applied to the f32 scores (q is not rounded twice), and
//    the score registers are rounded to bf16 and reused in place as the A
//    fragments of P V. K and V tiles go through shared memory (rows padded
//    by 16 bytes: conflict-free fragment reads); V's B fragments are read
//    transposed by ldmatrix.
//  * f32: the same loop with 32-row, 32-key tiles and plain FMAs in f32
//    (tensor-core TF32 would lose the digits the f32 configs are held to);
//    q is scaled in f32 before the product, as the TPU kernel does.
//  * masked scores are -inf and take p = 0; a row whose running max is
//    still -inf takes m = 0 and corr = 0 (the guard of the model's
//    blockwise attention). The output is acc / max(l, 1e-30).
//  * on request (a non-null `lse`, f32 (B, H, Sq)) each row's log-sum-exp
//    of its scaled scores, m + log(max(l, 1e-30)), is written beside O for
//    the backward pass (flash_attention_bwd.cu); O is the same either way.
//  * no atomics, fixed summation order: two launches give the same bits.
//  * launches on the caller's stream, allocates nothing, returns
//    cudaGetLastError() so the wrapper can raise on a refused launch.

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
  void* o;
  float* lse;  // (B, H, Sq) or null
  int B, Sq, Sk, H, KV, hd, q_offset, causal, vec;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: tensor-core path (mma.sync m16n8k16, scores and output in registers)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;
constexpr int TC_BK = 64;
constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows

template <int HDP>
struct TcLayout {
  static constexpr int LD = HDP + 8;  // bf16 row of Q, K, V: 16-byte rows,
                                      // conflict-free fragment reads
  static constexpr size_t bytes = (size_t)(TC_BQ + 2 * TC_BK) * LD * 2;
};

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS)
    flash_fwd_bf16(Params p) {
  using L = TcLayout<HDP>;
  constexpr int LD = L::LD;
  constexpr int NKD = HDP / 16;   // k-steps of Q K^T over the head dim
  constexpr int NS = TC_BK / 8;   // 8-key column tiles of S
  constexpr int NO = HDP / 8;     // 8-dim column tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TC_BQ * LD;
  bf16* Vs = Ks + TC_BK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  // the longest causal rows first, so the last blocks to run are short
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const long long q_stride = (long long)p.H * p.hd;
  const long long kv_stride = (long long)p.KV * p.hd;
  const bf16* qg = static_cast<const bf16*>(p.q) +
                   ((long long)b * p.Sq + q0) * q_stride + (long long)h * p.hd;
  const bf16* kg = static_cast<const bf16*>(p.k) +
                   (long long)b * p.Sk * kv_stride + (long long)kvh * p.hd;
  const bf16* vg = static_cast<const bf16*>(p.v) +
                   (long long)b * p.Sk * kv_stride + (long long)kvh * p.hd;

  load_tile_bf16<HDP, TC_THREADS>(Qs, LD, TC_BQ, qg, q_stride,
                                  min(TC_BQ, p.Sq - q0), p.hd, p.vec != 0);
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole KV loop
  const int r0 = warp * 16 + g;  // rows r0 and r0 + 8 of the tile
  uint32_t qf[NKD][4];
#pragma unroll
  for (int kk = 0; kk < NKD; ++kk) {
    const bf16* q_lo = Qs + r0 * LD + kk * 16 + 2 * t;
    const bf16* q_hi = q_lo + 8 * LD;
    qf[kk][0] = ld32(q_lo);
    qf[kk][1] = ld32(q_hi);
    qf[kk][2] = ld32(q_lo + 8);
    qf[kk][3] = ld32(q_hi + 8);
  }

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows r0, r0 + 8
  float l[2] = {0.f, 0.f};              // this thread's part of the sum
  const int q_pos[2] = {p.q_offset + q0 + r0, p.q_offset + q0 + r0 + 8};

  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, p.q_offset + q0 + TC_BQ);
  for (int kv0 = 0; kv0 < kv_end; kv0 += TC_BK) {
    const int kv_valid = min(TC_BK, p.Sk - kv0);
    __syncthreads();  // every warp is done with the previous K and V
    load_tile_bf16<HDP, TC_THREADS>(Ks, LD, TC_BK, kg + kv0 * kv_stride,
                                    kv_stride, kv_valid, p.hd, p.vec != 0);
    load_tile_bf16<HDP, TC_THREADS>(Vs, LD, TC_BK, vg + kv0 * kv_stride,
                                    kv_stride, kv_valid, p.hd, p.vec != 0);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys in registers
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* k_row = Ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk)
        mma_bf16(s[j], qf[kk], ld32(k_row + kk * 16), ld32(k_row + kk * 16 + 8));
    }

    // scale, mask and the online softmax update; the four threads of a
    // quad hold one row's 64 scores between them
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = kv0 + j * 8 + 2 * t + (e & 1);
        const int hi = e >> 1;
        const bool valid = k_pos - kv0 < kv_valid &&
                           (!p.causal || k_pos <= q_pos[hi]);
        s[j][e] = valid ? s[j][e] * p.scale : -INFINITY;
        mx[hi] = fmaxf(mx[hi], s[j][e]);
      }
    }
    float corr[2], m_safe[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      const float m_new = fmaxf(m[hi], mx[hi]);
      m_safe[hi] = isfinite(m_new) ? m_new : 0.f;
      corr[hi] = isfinite(m[hi]) ? expf(m[hi] - m_safe[hi]) : 0.f;
      m[hi] = m_new;
      l[hi] *= corr[hi];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m_safe[hi]);
        l[hi] += s[j][e];
      }
    }

    // O += P V, P rounded to bf16: two 8-key tiles of S make one 16-key
    // A fragment
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* v_rows = Vs + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, v_rows + j * 8);
        mma_bf16(o[j], pf, b0, b1);
      }
    }
  }

  // the row sums are spread over the quad
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    l[hi] = fmaxf(l[hi], 1e-30f);
  }
  if (p.lse != nullptr && t == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.Sq + q0;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      if (q0 + r0 + 8 * hi < p.Sq) lse[r0 + 8 * hi] = m[hi] + logf(l[hi]);
  }
  bf16* og = static_cast<bf16*>(p.o) + ((long long)b * p.Sq + q0) * q_stride +
             (long long)h * p.hd;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = r0 + 8 * hi;
    if (q0 + row >= p.Sq) continue;
    bf16* orow = og + row * q_stride;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + 2 * t;
      const float v0 = o[j][2 * hi] / l[hi], v1 = o[j][2 * hi + 1] / l[hi];
      if (c < p.hd) orow[c] = __float2bfloat16(v0);
      if (c + 1 < p.hd) orow[c + 1] = __float2bfloat16(v1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA path
// ---------------------------------------------------------------------------

constexpr int F_BQ = 32;
constexpr int F_BK = 32;
constexpr int F_THREADS = 128;  // 4 warps x 8 query rows
constexpr int F_ROWS = F_BQ / (F_THREADS / 32);

template <int HDP>
struct F32Layout {
  static constexpr int LDK = HDP + 1;  // column-wise reads across lanes
  static constexpr size_t bytes =
      (F_BQ * HDP + F_BK * LDK + F_BK * HDP + F_BQ * F_BK) * 4;
};

template <int HDP>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32(Params p) {
  using L = F32Layout<HDP>;
  constexpr int NC = HDP / 32;  // output columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + F_BQ * HDP;
  float* Vs = Ks + F_BK * L::LDK;
  float* Ps = Vs + F_BK * HDP;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * F_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const long long q_stride = (long long)p.H * p.hd;
  const long long kv_stride = (long long)p.KV * p.hd;
  const float* qg = static_cast<const float*>(p.q) +
                    ((long long)b * p.Sq + q0) * q_stride +
                    (long long)h * p.hd;
  const float* kg = static_cast<const float*>(p.k) +
                    (long long)b * p.Sk * kv_stride + (long long)kvh * p.hd;
  const float* vg = static_cast<const float*>(p.v) +
                    (long long)b * p.Sk * kv_stride + (long long)kvh * p.hd;

  const int q_valid = min(F_BQ, p.Sq - q0);
  for (int i = threadIdx.x; i < F_BQ * HDP; i += F_THREADS) {
    const int r = i / HDP, c = i % HDP;
    Qs[i] = (r < q_valid && c < p.hd) ? qg[r * q_stride + c] * p.scale : 0.f;
  }

  float m[F_ROWS], l[F_ROWS], o[F_ROWS][NC];
#pragma unroll
  for (int r = 0; r < F_ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[r][j] = 0.f;
  }

  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, p.q_offset + q0 + F_BQ);
  for (int kv0 = 0; kv0 < kv_end; kv0 += F_BK) {
    const int kv_valid = min(F_BK, p.Sk - kv0);
    for (int i = threadIdx.x; i < F_BK * HDP; i += F_THREADS) {
      const int r = i / HDP, c = i % HDP;
      const bool in = r < kv_valid && c < p.hd;
      const long long off = (long long)(kv0 + r) * kv_stride + c;
      Ks[r * L::LDK + c] = in ? kg[off] : 0.f;
      Vs[r * HDP + c] = in ? vg[off] : 0.f;
    }
    __syncthreads();

    // s[r] = q[row r] . k[key lane], summed over the head dim in order
    float s[F_ROWS];
#pragma unroll
    for (int r = 0; r < F_ROWS; ++r) s[r] = 0.f;
    for (int c = 0; c < HDP; ++c) {
      const float kc = Ks[lane * L::LDK + c];
#pragma unroll
      for (int r = 0; r < F_ROWS; ++r)
        s[r] += Qs[(warp * F_ROWS + r) * HDP + c] * kc;
    }
    const int k_pos = kv0 + lane;
#pragma unroll
    for (int r = 0; r < F_ROWS; ++r) {
      const int row = warp * F_ROWS + r;
      const int q_pos = p.q_offset + q0 + row;
      const bool valid = lane < kv_valid && (!p.causal || k_pos <= q_pos);
      const float sv = valid ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float pv = valid ? expf(sv - m_safe) : 0.f;
      const float corr = isfinite(m[r]) ? expf(m[r] - m_safe) : 0.f;
      l[r] = l[r] * corr + warp_sum(pv);
      m[r] = m_new;
      Ps[row * F_BK + lane] = pv;
#pragma unroll
      for (int j = 0; j < NC; ++j) o[r][j] *= corr;
    }
    __syncwarp();
    for (int kk = 0; kk < F_BK; ++kk) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = Vs[kk * HDP + lane + 32 * j];
#pragma unroll
        for (int r = 0; r < F_ROWS; ++r)
          o[r][j] += Ps[(warp * F_ROWS + r) * F_BK + kk] * vv;
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

  float* og = static_cast<float*>(p.o) + ((long long)b * p.Sq + q0) * q_stride +
              (long long)h * p.hd;
#pragma unroll
  for (int r = 0; r < F_ROWS; ++r) {
    const int row = warp * F_ROWS + r;
    if (row >= q_valid) break;  // warp-uniform
    const float lr = fmaxf(l[r], 1e-30f);
    if (p.lse != nullptr && lane == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + q0 + row] = m[r] + logf(lr);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < p.hd) og[row * q_stride + c] = o[r][j] / lr;
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

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); all contiguous, all bf16
// (bf16 != 0) or all f32. hd <= 128, H % KV == 0. lse: null, or f32
// (B, H, Sq) for each row's log-sum-exp. Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int q_offset, int causal,
                                   int bf16_io, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || hd <= 0) return 0;
  if (hd > 128 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.hd = hd;
  p.q_offset = q_offset;
  p.causal = causal;
  p.scale = 1.f / sqrtf(static_cast<float>(hd));
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  p.vec = (hd % 8 == 0) && (any % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_io) {
    const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
    if (hd <= 64)
      return launch(flash_fwd_bf16<64>, grid, TC_THREADS,
                    TcLayout<64>::bytes, p, s);
    return launch(flash_fwd_bf16<128>, grid, TC_THREADS,
                  TcLayout<128>::bytes, p, s);
  }
  const dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
  if (hd <= 32)
    return launch(flash_fwd_f32<32>, grid, F_THREADS, F32Layout<32>::bytes, p,
                  s);
  if (hd <= 64)
    return launch(flash_fwd_f32<64>, grid, F_THREADS, F32Layout<64>::bytes, p,
                  s);
  return launch(flash_fwd_f32<128>, grid, F_THREADS, F32Layout<128>::bytes, p,
                s);
}
