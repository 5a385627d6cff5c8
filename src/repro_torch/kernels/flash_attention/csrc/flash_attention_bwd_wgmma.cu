// Causal GQA flash attention, backward, bf16, built for Hopper (sm_90a):
// TMA loads into a ring of shared-memory stages and wgmma for all five
// products, the G query heads of a KV head spread over CTAs and their dK,
// dV partials summed afterwards in a fixed order.
//
// Given the forward's inputs q, o, dO (B, Sq, H, hd), k, v (B, Sk, KV, hd),
// contiguous bf16, hd 64 or 128, every pointer 16-byte aligned, and each
// query row's natural log-sum-exp lse (B, H, Sq) of its scaled scores
// (written by the forward kernels), it writes, with scale = 1/sqrt(hd),
// keys j < Sk and, when causal, j <= q_offset + i:
//
//   D  = rowsum(dO * O)                 (f32, in this file's first kernel)
//   P  = exp(scale * q k^T - lse)       (masked entries 0)
//   dV = sum over the G query heads of P^T dO
//   dS = P * (dO v^T - D)
//   dK = scale * sum over the G query heads of dS^T q
//   dQ = scale * dS k
//
// The wrapper (ops.py: flash_bwd_variant) sends every other call to
// flash_attention_bwd.cu.
//
// Replaces the gradient of the Pallas TPU kernel `flash_attention_fwd` in
// src/repro/kernels/flash_attention/flash_attention.py, which has no
// backward of its own: the JAX package trains through XLA's autodiff of
// `blockwise_attention` (src/repro/models/layers.py:43).
//
// What bounds it on the card: operations. Five products of the forward's
// size, 10 * hd flops per visible (query, key) pair and head: 343.7 GFLOP
// at the train shape (B 1, S 4096, H 32, KV 4, hd 128, causal), 0.35 ms at
// the bf16 peak, against 152 MB of tensors. This two-pass design
// recomputes S and dP in the dQ pass: 7 products, 481 GFLOP, 0.49 ms.
// The first design (flash_attention_bwd.cu) puts all G query heads of a KV
// head in one CTA (key block 0 of a causal head then walks 8x every query
// block while the others idle), copies tiles through registers between
// two __syncthreads and runs mma.sync: 13x its bound. Here:
//  * four kernels on the caller's stream, one entry point:
//    1. pre: one warp per query row sums dO * O in f32 (lanes in column
//       order, then a shuffle tree) into D, and writes lse * log2(e) beside
//       it, both padded to Sq_pad = a multiple of 64 rows (zeros past Sq)
//       so that a row block is one 16-byte aligned bulk copy;
//    2. dK/dV: one CTA per (128-key block, query head, batch); the grid
//       runs key block 0 first (causal: it sees the most queries), and no
//       CTA walks more than Sq / 64 query blocks. Two warpgroups own 64
//       keys each: S^T = K Q^T and dP^T = V dO^T (SS wgmma m64n64k16, both
//       operands K-major), P^T and dS^T = P^T * (dP^T - D) in registers,
//       rounded to bf16 as A fragments (the accumulator layout is wgmma's
//       A layout), then dV += P^T dO and dK += dS^T Q (RS wgmma, dO and Q
//       read MN-major). K and V of the block are TMA-loaded once and stay
//       in shared memory; Q, dO tiles of 64 queries (TMA) and their lse, D
//       rows (bulk copy) stream through a ring of 3 stages, loaded two
//       steps ahead. Each CTA writes its f32 partial dK, dV for its own
//       query head to a workspace (B, Sk, H, hd);
//    3. dQ: one CTA per (128-query block, query head, batch), longest
//       causal rows first; two warpgroups own 64 rows each. Q and dO stay
//       in shared memory; K and V tiles of 128 keys stream by TMA through
//       a ring of 2 stages, one step ahead, blocks above the diagonal never
//       loaded. S = Q K^T and dP = dO V^T as SS wgmma in two groups, P's
//       exp under dP's product, then dQ += dS K as RS wgmma (K MN-major);
//       dQ * scale goes out as bf16 through the warpgroup's own Q rows,
//       16-byte stores;
//    4. reduce: the G partials of each KV head summed in ascending head
//       order, dK scaled, both written as bf16.
//  * no producer warpgroup: dK and dV alone hold 128 registers a thread at
//    hd 128, and with 8 warps an SM sub-partition holds two of them, so a
//    thread may use 255 registers. With a third (producer) warpgroup it
//    holds three, a thread gets 168 whatever setmaxnreg asks, and the
//    dK/dV pass spilled. Thread 0 starts every load instead and refills a
//    stage once all 8 warps have released it (full/empty mbarriers); a
//    warpgroup then runs at most one step ahead of the other.
//  * the tensor maps (4-D: hd, heads, seq, batch; 128-byte swizzle, boxes
//    of 64 columns x 64 rows) are encoded on the host per launch; rows
//    past S come in as zeros (TMA's fill) and are masked.
//  * P = exp2(s * scale * log2(e) - lse * log2(e)): log2(e) is folded into
//    both terms, the natural-log convention of both forward kernels.
//  * no atomics anywhere and every sum in a fixed order: two launches give
//    the same bits.
//  * allocates nothing (the wrapper passes the lse/D rows and the dK/dV
//    partials as scratch tensors) and returns a cudaError_t (or an encode
//    failure) so the wrapper can raise.
// Left for later: a one-pass dQ (FlashAttention-3's semaphore-ordered
// accumulation, deterministic), which drops the recomputed S and dP, and
// ping-pong between the two warpgroups.

#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;      // rows of every TMA box; the lse/D padding
constexpr int THREADS = 256;  // two warpgroups of 64 rows each, both passes
// dK/dV pass: keys per CTA, queries per streamed step, ring depth, and how
// many steps ahead thread 0 loads
constexpr int BK = 128, BQ = 64, DKDV_STAGES = 3, DKDV_AHEAD = 2;
// dQ pass: queries per CTA, keys per streamed step, ring depth, steps ahead
constexpr int BM = 128, BN = 128, DQ_STAGES = 2, DQ_AHEAD = 1;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* lse2;   // (B, H, Sq_pad): lse * log2(e), 0 past Sq
  const float* delta;  // (B, H, Sq_pad): rowsum(dO * O), 0 past Sq
  float* part_dk;      // (B, Sk, H, hd): dS^T q of each query head
  float* part_dv;      // (B, Sk, H, hd): P^T dO of each query head
  void* dq;            // (B, Sq, H, hd) bf16
  int Sq, Sk, H, KV, Sq_pad, q_offset, causal;
  float scale;       // 1/sqrt(hd)
  float scale_log2;  // log2(e)/sqrt(hd)
};

// D (64 x HD, f32) += A (64 x 16, bf16 registers) * B (16 x HD, smem,
// MN-major)
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db, 1);
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db, 1);
}

// `rows` (a multiple of ROWS) rows of one head from sequence row r0 into
// a tile [HD / 64][rows][64], one box per 64 columns and 64 rows
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int r0,
                                          int rows, int b) {
  for (int hf = 0; hf < HD / 64; ++hf)
    for (int rb = 0; rb < rows / ROWS; ++rb)
      tma_load_4d(dst + (hf * rows + rb * ROWS) * 128, map, bar, hf * 64,
                  head, r0 + rb * ROWS, b);
}

// P (or P^T) rounded to bf16 as A fragments: 8-column chunks 2kk and
// 2kk + 1 of the accumulator make k-step kk
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO * O) and lse * log2(e), rows padded to Sq_pad
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_pre(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ lse2,
                  float* __restrict__ delta, int B, int Sq, int H,
                  int Sq_pad) {
  constexpr int PER = HD / 32;  // bf16 values per lane
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        (threadIdx.x >> 5);  // (b, h, i), i fastest
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(B) * H * Sq_pad) return;  // warp-uniform
  const int i = static_cast<int>(row % Sq_pad);
  const long long bh = row / Sq_pad;
  float acc = 0.f, l2 = 0.f;
  if (i < Sq) {
    const long long b = bh / H;
    const int h = static_cast<int>(bh % H);
    const long long at = ((b * Sq + i) * H + h) * HD + lane * PER;
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(o + at);
    const __nv_bfloat162* d2 =
        reinterpret_cast<const __nv_bfloat162*>(dout + at);
#pragma unroll
    for (int c = 0; c < PER / 2; ++c) {
      const float2 a = __bfloat1622float2(o2[c]);
      const float2 d = __bfloat1622float2(d2[c]);
      acc = fmaf(d.x, a.x, acc);
      acc = fmaf(d.y, a.y, acc);
    }
    l2 = lse[bh * Sq + i] * LOG2E;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = l2;
  }
}

// ---------------------------------------------------------------------------
// 2. dK, dV partials: one CTA per (key block, query head, batch)
// ---------------------------------------------------------------------------

// Shared memory, every tile 1024-byte aligned (the 128-byte swizzle atom):
// K [hd/64][BK][64], V likewise, then DKDV_STAGES x (Q [hd/64][BQ][64], dO
// likewise, lse2 and D rows), barriers.
template <int HD>
struct DkdvSmem {
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int T_BYTES = BQ * HD * 2;
  static constexpr int STAGE = 2 * T_BYTES + 1024;  // + 2 x BQ floats
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int ST_OFF = 2 * KV_BYTES;
  static constexpr int BAR_OFF = ST_OFF + DKDV_STAGES * STAGE;
  static constexpr int N_BARS = 1 + 2 * DKDV_STAGES;
  static constexpr int BYTES = BAR_OFF + 8 * N_BARS + 1024;  // + align slack
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, Params p) {
  using L = DkdvSmem<HD>;
  constexpr int ST = DKDV_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t s_k = base, s_v = base + L::V_OFF;
  const uint32_t s_bar = base + L::BAR_OFF;
  // barriers: full_kv, full[ST], empty[ST]
  const uint32_t full_kv = s_bar;
  auto full = [&](int s) { return s_bar + 8u * (1 + s); };
  auto empty = [&](int s) { return s_bar + 8u * (1 + ST + s); };
  auto stage = [&](int s) { return L::ST_OFF + s * L::STAGE; };  // offset

  const int h = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * BK;  // key block 0, the longest, first
  const int kvh = h / (p.H / p.KV);
  // the first query block with a row that sees key kv0
  int q_first = 0;
  if (p.causal) q_first = max(0, kv0 - p.q_offset) / BQ * BQ;
  const int n_steps = q_first < p.Sq ? (p.Sq - q_first + BQ - 1) / BQ : 0;
  const long long bh = static_cast<long long>(b) * p.H + h;

  // thread 0 loads step `it` (Q, dO tiles by TMA, lse2 and D rows by bulk
  // copy) into stage it % ST
  auto load_step = [&](int it) {
    const int s = it % ST;
    const int q0 = q_first + it * BQ;
    const uint32_t st = base + stage(s);
    mbar_expect_tx(full(s), 2 * L::T_BYTES + 2 * BQ * 4);
    load_rows<HD>(st, &tq, full(s), h, q0, BQ, b);
    load_rows<HD>(st + L::T_BYTES, &tdo, full(s), h, q0, BQ, b);
    const long long row = bh * p.Sq_pad + q0;
    bulk_load(st + 2 * L::T_BYTES, p.lse2 + row, BQ * 4, full(s));
    bulk_load(st + 2 * L::T_BYTES + BQ * 4, p.delta + row, BQ * 4, full(s));
  };

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per warp
    }
    mbar_fence_init();
    mbar_expect_tx(full_kv, 2 * L::KV_BYTES);
    load_rows<HD>(s_k, &tk, full_kv, kvh, kv0, BK, b);
    load_rows<HD>(s_v, &tv, full_kv, kvh, kv0, BK, b);
    for (int it = 0; it < min(DKDV_AHEAD, n_steps); ++it) load_step(it);
  }
  __syncthreads();

  // warpgroup cw owns keys kv0 + cw*64 .. + 63 (read through a shuffle so
  // that the compiler sees it is warp-uniform)
  const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x - 128 * cw;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg_key = kv0 + cw * 64;
  const int key0 = wg_key + warp * 16 + g;  // this thread's keys, and + 8
  const float sl = p.scale_log2;
  const uint32_t k_rows = s_k + cw * 64 * 128;
  const uint32_t v_rows = s_v + cw * 64 * 128;

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(full_kv, 0);
  for (int it = 0; it < n_steps; ++it) {
    // load step it + DKDV_AHEAD into the stage of step it + DKDV_AHEAD -
    // ST, once both warpgroups have released that one
    const int nx = it + DKDV_AHEAD;
    if (threadIdx.x == 0 && nx < n_steps) {
      if (nx >= ST) mbar_wait(empty(nx % ST), ((nx / ST) - 1) & 1);
      load_step(nx);
    }
    __syncwarp();
    const int s = it % ST;
    const uint32_t ph = (it / ST) & 1;
    const int q0 = q_first + it * BQ;
    const uint32_t q_t = base + stage(s);
    const uint32_t do_t = q_t + L::T_BYTES;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + stage(s) + 2 * L::T_BYTES);
    const float* d_s = lse_s + BQ;
    mbar_wait(full(s), ph);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries per warpgroup
    float sacc[BQ / 2], dpacc[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sacc[i] = dpacc[i] = 0.f;
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16 columns = 32 bytes
      Wgmma<BQ>::ss<0, 0>(
          sacc, sw128_desc(k_rows + (kk >> 2) * BK * 128 + off, 16, 1024),
          sw128_desc(q_t + (kk >> 2) * BQ * 128 + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      Wgmma<BQ>::ss<0, 0>(
          dpacc, sw128_desc(v_rows + (kk >> 2) * BK * 128 + off, 16, 1024),
          sw128_desc(do_t + (kk >> 2) * BQ * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);

    // P^T = exp(scale s - lse), dS^T = P^T (dP^T - D); masked only where
    // the tile reaches past Sk or Sq or over the diagonal
    const bool edge = wg_key + 64 > p.Sk || q0 + BQ > p.Sq ||
                      (p.causal && wg_key + 63 > p.q_offset + q0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int qc = 8 * j + 2 * t;  // this thread's query columns
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qc);
      const float2 dd = *reinterpret_cast<const float2*>(d_s + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x;
        const float dr = (e & 1) ? dd.y : dd.x;
        float pe = exp2f(fmaf(sacc[4 * j + e], sl, -lq));
        if (edge) {
          const int key = key0 + 8 * (e >> 1);
          const int q = q0 + qc + (e & 1);
          if (key >= p.Sk || q >= p.Sq || (p.causal && key > p.q_offset + q))
            pe = 0.f;
        }
        sacc[4 * j + e] = pe;
        dpacc[4 * j + e] = pe * (dpacc[4 * j + e] - dr);
      }
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_a<BQ>(pa, sacc);
    to_a<BQ>(da, dpacc);

    // dV += P^T dO, dK += dS^T Q: k-steps over the tile's queries
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<HD>(dv, pa[kk],
                   sw128_desc(do_t + kk * 16 * 128, BQ * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<HD>(dk, da[kk],
                   sw128_desc(q_t + kk * 16 * 128, BQ * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // this query head's partials, f32, rows past Sk skipped
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.Sk) continue;
    const long long at =
        ((static_cast<long long>(b) * p.Sk + key) * p.H + h) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<float2*>(p.part_dk + at + 8 * j) =
          make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(p.part_dv + at + 8 * j) =
          make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one CTA per (query block, query head, batch)
// ---------------------------------------------------------------------------

// Q [hd/64][BM][64], dO likewise, then DQ_STAGES x (K [hd/64][BN][64],
// V likewise), barriers.
template <int HD>
struct DqSmem {
  static constexpr int T_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;
  static constexpr int DO_OFF = T_BYTES;
  static constexpr int ST_OFF = 2 * T_BYTES;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int BAR_OFF = ST_OFF + DQ_STAGES * STAGE;
  static constexpr int N_BARS = 1 + 2 * DQ_STAGES;
  static constexpr int BYTES = BAR_OFF + 8 * N_BARS + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, Params p) {
  using L = DqSmem<HD>;
  constexpr int ST = DQ_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t s_q = raw + pad;
  const uint32_t s_do = s_q + L::DO_OFF;
  const uint32_t s_bar = s_q + L::BAR_OFF;
  const uint32_t full_q = s_bar;
  auto full = [&](int s) { return s_bar + 8u * (1 + s); };
  auto empty = [&](int s) { return s_bar + 8u * (1 + ST + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest rows first
  const int kvh = h / (p.H / p.KV);
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, max(p.q_offset + q0 + BM, 0));
  const int n_tiles = (kv_end + BN - 1) / BN;

  // thread 0 loads K and V tile `it` into stage it % ST
  auto load_step = [&](int it) {
    const int s = it % ST;
    const uint32_t st = s_q + L::ST_OFF + s * L::STAGE;
    mbar_expect_tx(full(s), L::STAGE);
    load_rows<HD>(st, &tk, full(s), kvh, it * BN, BN, b);
    load_rows<HD>(st + L::KV_BYTES, &tv, full(s), kvh, it * BN, BN, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_fence_init();
    mbar_expect_tx(full_q, 2 * L::T_BYTES);
    load_rows<HD>(s_q, &tq, full_q, h, q0, BM, b);
    load_rows<HD>(s_do, &tdo, full_q, h, q0, BM, b);
    for (int it = 0; it < min(DQ_AHEAD, n_tiles); ++it) load_step(it);
  }
  __syncthreads();

  // warpgroup cw owns query rows q0 + cw*64 .. + 63
  const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x - 128 * cw;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's rows of the 64, and + 8
  const int first_pos = p.q_offset + q0 + cw * 64;
  const float sl = p.scale_log2;
  const long long bh = static_cast<long long>(b) * p.H + h;
  float lse_r[2], d_r[2];
  int pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + cw * 64 + row0 + 8 * r;
    lse_r[r] = q < p.Sq ? p.lse2[bh * p.Sq_pad + q] : 0.f;
    d_r[r] = q < p.Sq ? p.delta[bh * p.Sq_pad + q] : 0.f;
    pos[r] = p.q_offset + q;
  }
  const uint32_t q_rows = s_q + cw * 64 * 128;
  const uint32_t do_rows = s_do + cw * 64 * 128;

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  mbar_wait(full_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int nx = it + DQ_AHEAD;  // as in the dK/dV pass
    if (threadIdx.x == 0 && nx < n_tiles) {
      if (nx >= ST) mbar_wait(empty(nx % ST), ((nx / ST) - 1) & 1);
      load_step(nx);
    }
    __syncwarp();
    const int s = it % ST;
    const uint32_t ph = (it / ST) & 1;
    const int kv0 = it * BN;
    const uint32_t k_t = s_q + L::ST_OFF + s * L::STAGE;
    const uint32_t v_t = k_t + L::KV_BYTES;
    mbar_wait(full(s), ph);

    // S = Q K^T and dP = dO V^T: 64 rows x 128 keys per warpgroup
    float sacc[BN / 2], dpacc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sacc[i] = dpacc[i] = 0.f;
    fence_regs(sacc);
    fence_regs(dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      Wgmma<BN>::ss<0, 0>(
          sacc, sw128_desc(q_rows + (kk >> 2) * BM * 128 + off, 16, 1024),
          sw128_desc(k_t + (kk >> 2) * BN * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      Wgmma<BN>::ss<0, 0>(
          dpacc, sw128_desc(do_rows + (kk >> 2) * BM * 128 + off, 16, 1024),
          sw128_desc(v_t + (kk >> 2) * BN * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S is done; dP runs on under P's exp
    fence_regs(sacc);

    // P = exp(scale s - lse); masked only where the tile reaches past Sk
    // or over the diagonal (rows past Sq are not written, and their zero
    // Q, dO, lse and D give dS = 0)
    const bool edge =
        kv0 + BN > p.Sk || (p.causal && kv0 + BN - 1 > first_pos);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pe = exp2f(fmaf(sacc[4 * j + e], sl, -lse_r[r]));
        if (edge) {
          const int key = kv0 + 8 * j + 2 * t + (e & 1);
          if (key >= p.Sk || (p.causal && key > pos[r])) pe = 0.f;
        }
        sacc[4 * j + e] = pe;
      }
    }
    wgmma_wait<0>();
    fence_regs(dpacc);

    // dS = P (dP - D), then dQ += dS K: k-steps over the tile's keys, K
    // read MN-major
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      dpacc[i] = sacc[i] * (dpacc[i] - d_r[(i >> 1) & 1]);
    uint32_t da[BN / 16][4];
    to_a<BN>(da, dpacc);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<HD>(dq, da[kk],
                   sw128_desc(k_t + kk * 16 * 128, BN * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // epilogue: dQ * scale in bf16, staged in this warpgroup's Q rows (no
  // longer read) with the 16-byte chunks of each 128-byte row XOR-swizzled
  // by row, then 16-byte coalesced stores, rows past Sq skipped
  unsigned char* stage = smem + cw * 64 * 128;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int hf = j >> 3, c = j & 7;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const uint32_t val = pack_bf16(dq[4 * j + 2 * r] * p.scale,
                                     dq[4 * j + 2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(stage + hf * BM * 128 + row * 128 +
                                   ((c ^ (row & 7)) << 4) + 4 * t) = val;
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  bf16* dqg = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 64 * CHUNKS / 128; ++i) {
    const int idx = i * 128 + tid;
    const int row = idx / CHUNKS, cc = idx % CHUNKS;
    const int hf = cc >> 3, c = cc & 7;
    const int q = q0 + cw * 64 + row;
    if (q < p.Sq) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          stage + hf * BM * 128 + row * 128 + ((c ^ (row & 7)) << 4));
      *reinterpret_cast<uint4*>(
          dqg + ((static_cast<long long>(b) * p.Sq + q) * p.H + h) * HD +
          cc * 8) = val;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dK, dV: the G partials of a KV head summed in ascending head order
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_reduce(const float* __restrict__ part_dk,
                     const float* __restrict__ part_dv, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int B, int Sk, int H, int KV,
                     float scale) {
  constexpr int C4 = HD / 4;  // 4-column groups per row
  const long long idx =
      static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= static_cast<long long>(B) * Sk * KV * C4) return;
  const int c4 = static_cast<int>(idx % C4);
  const long long rest = idx / C4;
  const int kvh = static_cast<int>(rest % KV);
  const long long bj = rest / KV;  // b * Sk + key
  const int G = H / KV;
  const long long first = (bj * H + static_cast<long long>(kvh) * G) * HD;
  const float4* pk = reinterpret_cast<const float4*>(part_dk + first) + c4;
  const float4* pv = reinterpret_cast<const float4*>(part_dv + first) + c4;
  float4 sk = pk[0], sv = pv[0];
  for (int hq = 1; hq < G; ++hq) {
    const float4 a = pk[hq * C4], c = pv[hq * C4];
    sk.x += a.x;
    sk.y += a.y;
    sk.z += a.z;
    sk.w += a.w;
    sv.x += c.x;
    sv.y += c.y;
    sv.z += c.z;
    sv.w += c.w;
  }
  const long long out = (bj * KV + kvh) * HD + 4 * c4;
  uint2 wk, wv;
  wk.x = pack_bf16(sk.x * scale, sk.y * scale);
  wk.y = pack_bf16(sk.z * scale, sk.w * scale);
  wv.x = pack_bf16(sv.x, sv.y);
  wv.y = pack_bf16(sv.z, sv.w);
  *reinterpret_cast<uint2*>(dk + out) = wk;
  *reinterpret_cast<uint2*>(dv + out) = wv;
}

// (B, S, NH, HD) bf16, boxes of 64 columns x 1 head x ROWS rows x 1 batch
bool encode(CUtensorMap* map, const void* base, int B, int S, int NH,
            int HD) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)NH, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)NH * HD * 2,
                                 (cuuint64_t)S * NH * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)ROWS, 1};
  return encode_bf16_sw128(map, base, 4, dims, strides, box);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* stats, float* part, int B, int Sq, int Sk, int H, int KV,
           int q_offset, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, q, B, Sq, H, HD) || !encode(&tk, k, B, Sk, KV, HD) ||
      !encode(&tv, v, B, Sk, KV, HD) || !encode(&tdo, dout, B, Sq, H, HD))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.Sq_pad = (Sq + ROWS - 1) / ROWS * ROWS;
  const long long n_rows = static_cast<long long>(B) * H * p.Sq_pad;
  float* lse2 = stats;
  float* delta = stats + n_rows;
  p.lse2 = lse2;
  p.delta = delta;
  p.part_dk = part;
  p.part_dv = part + static_cast<long long>(B) * Sk * H * HD;
  p.dq = dq;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.q_offset = q_offset;
  p.causal = causal;
  p.scale = 1.f / sqrtf(static_cast<float>(HD));
  p.scale_log2 = LOG2E / sqrtf(static_cast<float>(HD));

  flash_bwd_pre<HD><<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0,
                      stream>>>(static_cast<const bf16*>(o),
                                static_cast<const bf16*>(dout), lse, lse2,
                                delta, B, Sq, H, p.Sq_pad);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  rc = set_smem(flash_bwd_dkdv_wgmma<HD>, DkdvSmem<HD>::BYTES);
  if (rc != 0) return rc;
  const dim3 grid1(H, B, (Sk + BK - 1) / BK);
  flash_bwd_dkdv_wgmma<HD><<<grid1, THREADS, DkdvSmem<HD>::BYTES,
                             stream>>>(
      tq, tk, tv, tdo, p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  rc = set_smem(flash_bwd_dq_wgmma<HD>, DqSmem<HD>::BYTES);
  if (rc != 0) return rc;
  const dim3 grid2(H, B, (Sq + BM - 1) / BM);
  flash_bwd_dq_wgmma<HD><<<grid2, THREADS, DqSmem<HD>::BYTES, stream>>>(
      tq, tk, tv, tdo, p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  const long long n_out = static_cast<long long>(B) * Sk * KV * (HD / 4);
  flash_bwd_reduce<HD><<<static_cast<unsigned>((n_out + 255) / 256), 256, 0,
                         stream>>>(p.part_dk, p.part_dv,
                                   static_cast<bf16*>(dk),
                                   static_cast<bf16*>(dv), B, Sk, H, KV,
                                   p.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Sk, KV, hd); all
// contiguous bf16, hd 64 or 128, every pointer 16-byte aligned, Sq, Sk >= 1,
// H % KV == 0 (the wrapper's flash_bwd_variant checks all of it). lse: f32
// (B, H, Sq). Scratch, f32: stats 2 x (B, H, Sq_pad) with Sq_pad = Sq
// rounded up to 64; partials 2 x (B, Sk, H, hd). Returns a cudaError_t.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv,
                                         void* stats, void* partials, int B,
                                         int Sq, int Sk, int H, int KV,
                                         int hd, int q_offset, int causal,
                                         void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
      reinterpret_cast<uintptr_t>(stats) |
      reinterpret_cast<uintptr_t>(partials);
  if (any % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
  float* pt = static_cast<float*>(partials);
  if (hd == 64)
    return launch<64>(q, k, v, o, dout, l, dq, dk, dv, st, pt, B, Sq, Sk, H,
                      KV, q_offset, causal, s);
  return launch<128>(q, k, v, o, dout, l, dq, dk, dv, st, pt, B, Sq, Sk, H,
                     KV, q_offset, causal, s);
}
