// Causal GQA flash attention, forward, bf16, built for Hopper (sm_90a):
// TMA loads into a ring of shared-memory stages, wgmma for both products,
// one producer warpgroup and two consumer warpgroups.
//
//   o[b, i, h, :] = softmax_j(scale * q[b, i, h, :] . k[b, j, h/G, :]) v[b, j, h/G, :]
//
// over keys j < Sk (and j <= q_offset + i when causal), scale = 1/sqrt(hd),
// G = H / KV. Tensors keep the model layout: q, o (B, Sq, H, hd) and k, v
// (B, Sk, KV, hd), contiguous bf16, hd 64 or 128, 16-byte aligned. The
// wrapper (ops.py: flash_variant) sends every other call to
// flash_attention_fwd.cu.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (body `_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py with its wrapper
// `flash_attention` (src/repro/kernels/flash_attention/ops.py), as
// flash_attention_fwd.cu does; the KV head is read as h / G and ragged S
// is handled here, not padded.
//
// What bounds it on the card: operations. 4 * hd flops per visible
// (query, key) pair and head; at the prefill shape (B 2, S 4096, H 32,
// hd 128, causal) 275 GFLOP against 151 MB of q, k, v and o. The first
// design (flash_attention_fwd.cu: mma.sync, K and V copied through
// registers between two __syncthreads, no load in flight during the math)
// reached 135 TFLOP/s. This one is shaped the way Hopper wants it:
//  * one CTA per (128-query-row tile, q-head, batch); the grid runs the
//    q-tile slowest and reversed, so the tiles with the longest causal
//    rows start first and the short ones fill the tail. CTAs that run
//    together share KV heads, whose tiles then come from L2.
//  * warpgroup 0 is the producer: one thread issues TMA loads (Q once,
//    then K and V tiles of 128 keys into a ring of 2 stages, each with a
//    "full" mbarrier the TMA completes and an "empty" one the consumers
//    release), and the warpgroup gives its registers up (setmaxnreg) to
//    warpgroups 1 and 2, the consumers, 64 query rows each.
//  * the tensor maps (4-D: hd, heads, seq, batch; 128-byte swizzle, one
//    64-column half of hd per box) are encoded on the host per launch
//    through cudaGetDriverEntryPoint (no link against libcuda) and passed
//    as __grid_constant__ parameters. Rows past S come in as zeros (TMA's
//    out-of-bounds fill) and are masked.
//  * S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory,
//    f32 accumulators in registers.
//  * online softmax in registers: a row lives in the four threads of a
//    quad (two shuffles for max and sum), exp2f with log2(e) * scale folded
//    into one FMA; a row whose max is still -inf takes m = 0, corr = 0.
//    Only tiles that reach past the diagonal or past Sk are masked.
//  * O += P V: P rounded to bf16 in registers, whose accumulator layout is
//    already wgmma's A-fragment layout, times V read MN-major (transposed)
//    from shared memory: wgmma m64n{hd}k16 with A from registers.
//  * a stage is released to the producer only after wait_group 0 of the
//    wgmma that reads it. The output acc / max(l, 1e-30) is rounded to bf16,
//    staged (swizzled) in the warpgroup's own Q rows and written with
//    16-byte stores, rows past Sq skipped.
//  * on request (a non-null `lse`, f32 (B, H, Sq)) each row's natural
//    log-sum-exp of its scaled scores, m * scale + log(max(l, 1e-30)), is
//    written for the backward pass (flash_attention_bwd.cu); O is the same
//    either way.
//  * no atomics, fixed summation order: two launches give the same bits.
//  * launches on the caller's stream, allocates nothing, returns a
//    cudaError_t (or an encode failure) so the wrapper can raise.
// Left for later: ping-pong scheduling of the two consumer warpgroups,
// softmax overlapped with the next Q K^T inside a warpgroup, and a
// persistent tile scheduler (FlashAttention-3's refinements).

#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // query rows per CTA: two consumer warpgroups
constexpr int BN = 128;       // keys per K / V tile
constexpr int STAGES = 2;     // K / V ring depth
constexpr int THREADS = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory, every tile 1024-byte aligned (the 128-byte swizzle atom):
// Q [hd/64][BM][64], then STAGES x K [hd/64][BN][64], STAGES x V, barriers.
template <int HD>
struct Smem {
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 4 * STAGES;
  static constexpr int BYTES = BAR_OFF + 8 * N_BARS + 1024;  // + align slack
};

struct Params {
  void* o;
  float* lse;  // (B, H, Sq) or null
  int Sq, Sk, H, KV, q_offset, causal;
  float scale_log2;  // log2(e) / sqrt(hd)
};

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db, 1);
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db, 1);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Params p) {
  using L = Smem<HD>;
  constexpr int HALVES = HD / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t s_q = raw + pad;
  const uint32_t s_k = s_q + L::K_OFF;
  const uint32_t s_v = s_q + L::V_OFF;
  const uint32_t s_bar = s_q + L::BAR_OFF;
  // barriers: full_q, full_k[S], full_v[S], empty_k[S], empty_v[S]
  const uint32_t full_q = s_bar;
  auto full_k = [&](int s) { return s_bar + 8u * (1 + s); };
  auto full_v = [&](int s) { return s_bar + 8u * (1 + STAGES + s); };
  auto empty_k = [&](int s) { return s_bar + 8u * (1 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return s_bar + 8u * (1 + 3 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest rows first
  const int kvh = h / (p.H / p.KV);
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, max(p.q_offset + q0 + BM, 0));
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // one arrival per consumer warp
      mbar_init(empty_v(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, L::Q_BYTES);
      for (int hf = 0; hf < HALVES; ++hf)
        tma_load_4d(s_q + hf * BM * 128, &tq, full_q, hf * 64, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        mbar_wait(empty_k(s), ph ^ 1);  // round 0 passes at once
        mbar_expect_tx(full_k(s), L::KV_BYTES);
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load_4d(s_k + s * L::KV_BYTES + hf * BN * 128, &tk, full_k(s),
                      hf * 64, kvh, it * BN, b);
        mbar_wait(empty_v(s), ph ^ 1);
        mbar_expect_tx(full_v(s), L::KV_BYTES);
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load_4d(s_v + s * L::KV_BYTES + hf * BN * 128, &tv, full_v(s),
                      hf * 64, kvh, it * BN, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows cw*64 .. cw*64 + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // this thread's rows (r, r + 8) of the warpgroup's 64, as positions
    const int row0 = warp * 16 + g;
    const int pos0 = p.q_offset + q0 + cw * 64 + row0;
    const int first_pos = p.q_offset + q0 + cw * 64;
    const float sl = p.scale_log2;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float sacc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    const uint32_t q_rows = s_q + cw * 64 * 128;

    mbar_wait(full_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const int kv0 = it * BN;

      // S = Q K^T (64 x 128 per warpgroup)
      mbar_wait(full_k(s), ph);
      const uint32_t k_tile = s_k + s * L::KV_BYTES;
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // 16 columns = 32 bytes
        const uint64_t da =
            sw128_desc(q_rows + (kk >> 2) * BM * 128 + off, 16, 1024);
        const uint64_t db =
            sw128_desc(k_tile + (kk >> 2) * BN * 128 + off, 16, 1024);
        Wgmma<128>::ss<0, 0>(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k(s));

      // mask only where the tile reaches past the diagonal or past Sk
      const bool edge = kv0 + BN > p.Sk ||
                        (p.causal && kv0 + BN - 1 > first_pos);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kv0 + j * 8 + 2 * t + (e & 1);
            const int pos = pos0 + 8 * (e >> 1);
            if (key >= p.Sk || (p.causal && key > pos))
              sacc[4 * j + e] = -INFINITY;
          }
        }
      }

      // online softmax; the quad (t = 0..3) holds a row between it
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      float corr[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        ms[r] = m_new == -INFINITY ? 0.f : m_new * sl;
        corr[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] * sl - ms[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // exp2f(-inf) = 0 for masked scores
          const float pe = exp2f(fmaf(sacc[4 * j + e], sl, -ms[e >> 1]));
          sacc[4 * j + e] = pe;
          l[e >> 1] += pe;
        }
      }
      // P as bf16 A fragments: 8-key chunks 2kk and 2kk + 1 make k-step kk
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }

      // O += P V
      mbar_wait(full_v(s), ph);
      const uint32_t v_tile = s_v + s * L::KV_BYTES;
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = sw128_desc(v_tile + kk * 16 * 128, BN * 128, 1024);
        wgmma_pv<HD>(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v(s));
    }

    // epilogue: rows summed over the quad, O / l in bf16, staged in this
    // warpgroup's Q rows (no longer read) with the 16-byte chunks of each
    // 128-byte row XOR-swizzled by row, then 16-byte coalesced stores
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    if (p.lse != nullptr && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + cw * 64 + row0 + 8 * r;
        // m is the raw score max: m * sl is its scaled value in log2 units
        if (q < p.Sq)
          p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + q] =
              m[r] * sl * LN2 + logf(l[r]);
      }
    }
    unsigned char* stage = smem + cw * 64 * 128;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int hf = j >> 3, c = j & 7;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const uint32_t v = pack_bf16(o[4 * j + 2 * r] / l[r],
                                     o[4 * j + 2 * r + 1] / l[r]);
        *reinterpret_cast<uint32_t*>(stage + hf * BM * 128 + row * 128 +
                                     ((c ^ (row & 7)) << 4) + 4 * t) = v;
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
    bf16* og = static_cast<bf16*>(p.o);
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
            og + ((static_cast<long long>(b) * p.Sq + q) * p.H + h) * HD +
            cc * 8) = val;
      }
    }
  }
}

// (B, S, NH, HD) bf16, boxes of 64 columns x 1 head x `rows` x 1 batch
bool encode(CUtensorMap* map, const void* base, int B, int S, int NH, int HD,
            int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)NH, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)NH * HD * 2,
                                 (cuuint64_t)S * NH * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_bf16_sw128(map, base, 4, dims, strides, box);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KV, int q_offset, int causal,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, Sq, H, HD, BM) || !encode(&tk, k, B, Sk, KV, HD, BN) ||
      !encode(&tv, v, B, Sk, KV, HD, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.o = o;
  p.lse = lse;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.q_offset = q_offset;
  p.causal = causal;
  p.scale_log2 = LOG2E / sqrtf(static_cast<float>(HD));
  const int bytes = Smem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + BM - 1) / BM);
  flash_fwd_wgmma<HD><<<grid, THREADS, bytes, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); contiguous bf16, hd 64 or
// 128, every pointer 16-byte aligned, Sq, Sk >= 1, H % KV == 0 (the
// wrapper's flash_variant checks all of it). lse: null, or f32 (B, H, Sq)
// for each row's log-sum-exp. Returns a cudaError_t.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int Sq, int Sk, int H, int KV,
                                         int hd, int q_offset, int causal,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(o);
  if (any % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 64)
    return launch<64>(q, k, v, o, l, B, Sq, Sk, H, KV, q_offset, causal, s);
  return launch<128>(q, k, v, o, l, B, Sq, Sk, H, KV, q_offset, causal, s);
}
