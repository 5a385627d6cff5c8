// Grouped per-expert GEMM for bf16 on Hopper (sm_90a): TMA loads into a
// ring of shared-memory stages, wgmma for the products.
//
//   y[n] = x[n] @ w[n mod E]      x (N, C, d), w (E, d, f) -> y (N, C, f)
//
// with an f32 accumulator over d and y rounded to bf16 once. The MoE block
// hands its whole (G, E, C, d) dispatch buffer over as N = G * E matrices
// and launches this three times per layer (gate, up, down).
//
// Replaces the Pallas TPU kernel `expert_gemm_raw` (body `_kernel`) in
// src/repro/kernels/expert_gemm/expert_gemm.py for bf16 tensors that TMA
// can address: d % 8 == 0, f % 8 == 0 (16-byte row strides) and x, w, y
// 16-byte aligned. The wrapper (ops.py: gemm_variant) sends every other
// call, and all of f32, to the first kernel, expert_gemm.cu. The TPU
// wrapper pads C, d and f to multiples of 128; here TMA fills the ragged
// edges of a tile with zeros and the stores are guarded.
//
// Two forward variants, picked by C in the wrapper, and the two products
// of the backward pass (ExpertGemm in ops.py):
//
// * tiles (C above the skinny threshold; the prefill, C 328, d 2048 / 768,
//   f 768 / 2048, N 256). Bound by operations: 264 GFLOP per product,
//   0.27 ms at the bf16 peak, against 0.88 GB of x, w and y (0.26 ms at the
//   memory rate), so both units have to be kept busy. The first kernel
//   (WMMA 16x16x16 through registers, one __syncthreads per 32-deep stage)
//   reached 118 TFLOP/s. This one:
//    - a persistent grid of one CTA per SM walks 128 x BN output tiles
//      (BN = 192: f = 768 is four of them). Tiles are numbered C-tile
//      fastest, then group, then f-tile, then expert, so the CTAs that run
//      together read the same expert's w tile (for every C-tile of both
//      groups n and n + E) and it comes from L2 after the first read.
//    - warpgroup 0 is the producer: one thread issues TMA loads of 64-deep
//      k-tiles (x: 128 rows x 64; w: 64 x BN, as BN / 64 boxes of 64
//      columns) into a ring of STAGES stages with a "full" mbarrier the
//      TMA completes and an "empty" one the consumers release. The ring
//      runs on across tiles, so the next tile's loads overlap this tile's
//      epilogue. The warpgroup gives its registers up (setmaxnreg 24) to
//      the two consumer warpgroups (240), 64 rows of the tile each.
//    - tensor maps are 3-D, x (d, C, N) and w (f, d, E) with coordinate
//      n mod E, so a ragged C (328 = 2 * 128 + 72) or d loads zeros from
//      the same matrix and never reads the next one; 128-byte swizzle.
//    - wgmma m64nBNk16: x is K-major; w is MN-major (f contiguous), read
//      transposed, with LBO the 8 KB between 64-column chunks and SBO the
//      1 KB between groups of 8 k-rows (hopper.cuh: sw128_desc). Each
//      k-tile's four products are committed as one group; a stage goes
//      back to the producer once the group after it is issued and
//      wait_group 1 says it is done, so one group is always in flight.
//    - epilogue: the accumulators in bf16 are staged in shared memory (an
//      output tile of its own, 48 KB beside the 4 x 40 KB ring) and
//      written with 16-byte coalesced stores, guarded at C and f.
//    - (BN, STAGES) from a sweep on an H100 80GB HBM3 at 700 W
//      (tools/kernel_sweep.py gemm), ms for the serve-lm prefill products
//      gate (d 2048, f 768) / down (d 768, f 2048), C 328, N 256:
//
//        BN, STAGES     128,4   128,6   192,3   192,4   256,2   256,3
//        gate           0.5111  0.5218  0.5284  0.4450  0.6885  0.4601
//        down           0.5511  0.5490  0.5775  0.4885  0.7135  0.4834
//
//      A first version stored the 4-byte pairs straight from the
//      accumulator layout (half-filled 32-byte sectors), with no output
//      tile and so one stage more: BN 256 took 0.5606 / 0.7547 ms, the
//      down product with its 12-deep k-loop 35 % above gate's 32-deep one.
// * skinny (C <= SKINNY_MAX_C; the decode step, C 8). Bound by bytes: the
//   403 MB of expert weights, 0.12 ms at the memory rate, against a few
//   GFLOP. The tiles variant pads C up to 128 rows and keeps one CTA per
//   SM. This one swaps the operands, y^T (f x C) = w^T (f x d)
//   x^T (d x C): A is w, read MN-major from shared memory (transposed A
//   is allowed for bf16), B is x, K-major, with N = C rounded up to 8, 16,
//   32 or 64. One CTA per (n, 128-wide f-tile); a producer warp streams
//   64 x 128 tiles of w (and 64 x N of x) through a 4-stage TMA ring, and
//   three CTAs fit on an SM, so about 200 KB of w are in flight per SM.
//   Tensor cores keep the consumer's work per byte negligible; a version
//   without them would need the same ring to reach the memory rate. The
//   same sweep timed both variants, alternately, three rounds each, on
//   the decode products (gate / down, G 1, N 128), medians in ms on an
//   H100 80GB HBM3 at 700 W against the shipped tiles (BN 192, 4 stages):
//
//        C              8       16      32      64
//        gate skinny    0.1397  0.1426  0.1471  0.1577
//        gate tiles     0.1489  0.1506  0.1539  0.1604
//        down skinny    0.1393  0.1424  0.1475  0.1557
//        down tiles     0.1494  0.1548  0.1557  0.1644
//
//   Skinny is 6-7 % faster at C 8 and 1.7-8 % at C 16 to 64, and every
//   one of its rounds beat every round of tiles, so it takes every C up
//   to 64.
//
// * dX (the backward's dX[n] = dY[n] W[n mod E]^T, dY (N, C, f), W
//   (E, d, f) -> dX (N, C, d)): the tiles variant with B = W read where it
//   lies. Seen as B (k = f, n = d), W is K-major, wgmma's native B layout
//   (ss<0, 0>): one TMA box of 64 k-columns x BN rows per stage instead of
//   BN / 64 boxes of 64 x 64, and the k16 steps advance 32 bytes along the
//   swizzled row. Everything else is the tiles design above (the template
//   argument TB picks B's major-ness). The first backward launched
//   the tiles variant on a transposed copy of W, 1.47-1.52 ms per product
//   for the copy alone against 0.30-0.33 ms for the product (H100 80GB
//   HBM3, 700 W). At the train shape (G 4, C 88) C pads to 128 rows:
//   206 GFLOP where 142 are needed, 0.208 ms at the bf16 peak, above the
//   0.196 ms the 656 MB of dY, W and dX take at the memory rate.
// * dW (dW[e] = sum_g X[g E + e]^T dY[g E + e], X (N, C, d_in), dY (N, C,
//   d_out) -> dW (E, d_in, d_out)): its own persistent kernel, gemm_dw,
//   with the tiles variant's producer, ring and two consumers. It reads X
//   and dY where they lie: A = X^T and B = dY are both MN-major (ss<1, 1>;
//   the transpose is allowed for bf16), loaded as 64-column boxes of KS
//   rows of C through 3-D maps (d, C, N) at n = g E + e, so a ragged C
//   loads zeros from the same matrix. Output tiles are 128 (d_in) x BN
//   (d_out) of one expert, d_out-tile fastest, then d_in-tile, then
//   expert, so the CTAs that run together read one expert's X and dY rows
//   and find them in L2. The k-loop walks g ascending, then c ascending,
//   in KS-row steps; a group's last step loads its rows rounded up to 16
//   (a second pair of maps with that box) and runs only those k16
//   products, as one straight run of wgmma (a guard on each product makes
//   ptxas fence each one, its note C7519). At the train shape (C 88) a group
//   is one 96-row step: 155 GFLOP at the gate shape (0.156 ms at the bf16
//   peak) where 64-row steps over whole boxes would cost 206 (0.208 ms);
//   the 0.196 ms byte bound stays the larger, and dW's 403 MB output is
//   most of it. Each warpgroup stages its 64 x BN tile in shared memory in
//   the layout TMA's 128-byte swizzle reads, and one thread hands it to a
//   TMA store, so the write overlaps the next tile's k-loop; the staging
//   area is overwritten only after the store has read it
//   (cp.async.bulk.wait_group.read). (BN, STAGES, KS) from a sweep on an
//   H100 80GB HBM3 at 700 W (tools/kernel_sweep.py gemm-bwd), ms at the
//   train shapes gate (d_in 2048, d_out 768) / down (768, 2048), G 4, E
//   128, C 88, TMA store unless marked:
//
//        BN, STAGES, KS   192,4,64  192,2,96  256,3,64  128,3,128  128,4,96
//        gate             0.3292    0.3764    0.3279    0.3348     0.2805
//        down             0.3325    0.3956    0.3233    0.3365     0.2806
//
//   128,4,96 with the tiles variant's 16-byte stores: 0.2925 / 0.2964;
//   64,5,96: 0.4556 / 0.4544. cuBLAS (torch.bmm) on X and dY copied to
//   (E, d, G C), (E, G C, f) takes 0.2747 / 0.2711 ms, not counting the
//   copies (0.49-0.79 ms); the first backward ran the tiles variant on
//   them, 0.3044 / 0.3118 ms.
//
// All: a fixed k order and no split-K or atomics, so two launches give the
// same bits. Launches go on the caller's stream, allocate nothing, and
// return a cudaError_t (or cudaErrorInvalidValue if a tensor map cannot be
// encoded) so the wrapper can raise.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;           // k-tile depth: one 128-byte swizzle row
constexpr int CHUNK_BYTES = BK * 128;  // 64 k-rows x 64 columns
constexpr int SKINNY_MAX_C = 64;

struct Params {
  bf16* y;
  int N, E, C, d, f;
  int c_tiles, f_tiles, groups, n_tiles, k_tiles;
};

// ---------------------------------------------------------------------------
// tiles: 128 x BN output tiles, persistent
// ---------------------------------------------------------------------------

constexpr int TM = 128;          // rows of C per tile: two consumer warpgroups
constexpr int T_THREADS = 384;   // warpgroup 0 produces, 1 and 2 consume

// Shared memory, every tile 1024-byte aligned (the 128-byte swizzle atom):
// STAGES x (x [TM][64], w [BN/64][64][64] read MN-major or [BN][64] read
// K-major), the output tile [BN/64][TM][64] that the epilogue stages, then
// the barriers.
template <int BN, int STAGES>
struct TileSmem {
  static constexpr int A_BYTES = TM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int OUT_BYTES = TM * BN * 2;
  static constexpr int BAR_OFF = OUT_OFF + OUT_BYTES;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;  // + align slack
};

struct Tile {
  int n, e, c0, f0;
};

// C-tile fastest, then group, then f-tile, then expert
__device__ __forceinline__ Tile tile_of(int t, const Params& p, int bn) {
  const int inner = p.c_tiles * p.groups;
  const int ct = t % p.c_tiles;
  const int g = (t % inner) / p.c_tiles;
  const int rest = t / inner;
  Tile tl;
  tl.e = rest / p.f_tiles;
  tl.f0 = (rest % p.f_tiles) * bn;
  tl.n = g * p.E + tl.e;
  tl.c0 = ct * TM;
  return tl;
}

// Epilogue of a consumer warpgroup (tiles and dW): its 64 x BN accumulators
// in bf16, staged in its 64 rows of the output tile `out` ([BN/64][TM][64])
// with the 16-byte chunks of each 128-byte row XOR-swizzled by row -- the
// 128-byte swizzle TMA reads -- so neither side has bank conflicts.
template <int BN>
__device__ __forceinline__ void stage_acc(unsigned char* out,
                                          const float (&acc)[BN / 2],
                                          int warp, int g, int t4) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int ch = j >> 3, c = j & 7;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(out + ch * TM * 128 + row * 128 +
                                   ((c ^ (row & 7)) << 4) + 4 * t4) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// ... then written to the row-major y (leading dimension ld) with 16-byte
// coalesced stores: staged row r to row row0 + r, column chunk c to
// columns col0 + 8c, rows at or past `rows` and columns at or past `cols`
// skipped (cols % 8 == 0: a chunk is all in or all out)
template <int BN>
__device__ __forceinline__ void store_staged(const unsigned char* out,
                                             bf16* y, int ld, int row0,
                                             int rows, int col0, int cols,
                                             int tid) {
  constexpr int CHUNKS = BN / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = 0; i < 64 * CHUNKS / 128; ++i) {
    const int idx = i * 128 + tid;
    const int row = idx / CHUNKS, cc = idx % CHUNKS;
    const int ch = cc >> 3, c = cc & 7;
    const int y_row = row0 + row, y_col = col0 + cc * 8;
    if (y_row < rows && y_col < cols) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          out + ch * TM * 128 + row * 128 + ((c ^ (row & 7)) << 4));
      *reinterpret_cast<uint4*>(y + static_cast<long long>(y_row) * ld +
                                y_col) = v;
    }
  }
}

// TB = 1: w (E, d, f), B read MN-major (the forward, y = x w); TB = 0:
// w (E, f, d), B read K-major (dX, y = x w^T with w as it lies)
template <int BN, int S, int TB>
__global__ void __launch_bounds__(T_THREADS, 1)
    gemm_tiles(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw, Params p) {
  using L = TileSmem<BN, S>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t base = raw + pad;
  const uint32_t s_bar = base + L::BAR_OFF;
  auto full = [&](int s) { return s_bar + 8u * s; };
  auto empty = [&](int s) { return s_bar + 8u * (S + s); };
  auto a_tile = [&](int s) { return base + s * L::STAGE_BYTES; };
  auto b_tile = [&](int s) { return base + s * L::STAGE_BYTES + L::A_BYTES; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
        const Tile tl = tile_of(t, p, BN);
        for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(empty(s), ((it / S) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(full(s), L::STAGE_BYTES);
          tma_load_3d(a_tile(s), &tx, full(s), kt * BK, tl.c0, tl.n);
          if (TB) {
#pragma unroll
            for (int ch = 0; ch < BN / 64; ++ch)
              tma_load_3d(b_tile(s) + ch * CHUNK_BYTES, &tw, full(s),
                          tl.f0 + ch * 64, kt * BK, tl.e);
          } else {
            tma_load_3d(b_tile(s), &tw, full(s), kt * BK, tl.f0, tl.e);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows cw*64 .. cw*64 + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const Tile tl = tile_of(t, p, BN);
      for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
        const int s = it % S;
        mbar_wait(full(s), (it / S) & 1);
        const uint32_t a = a_tile(s) + cw * 64 * 128;
        const uint32_t b = b_tile(s);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
          const uint64_t db =
              TB ? sw128_desc(b + kk * 16 * 128, CHUNK_BYTES, 1024)
                 : sw128_desc(b + kk * 32, 16, 1024);
          Wgmma<BN>::template ss<0, TB>(acc, da, db, kt > 0 || kk > 0);
        }
        wgmma_commit();
        fence_regs(acc);
        if (kt > 0) {  // the previous k-tile's group is done: free its stage
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty((it - 1) % S));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((it - 1) % S));

      // epilogue: staged, then 16-byte stores guarded at C and f
      unsigned char* out = smem_raw + pad + L::OUT_OFF + cw * 64 * 128;
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      stage_acc<BN>(out, acc, warp, g, t4);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      store_staged<BN>(out, p.y + static_cast<long long>(tl.n) * p.C * p.f,
                       p.f, tl.c0 + cw * 64, p.C, tl.f0, p.f, tid);
    }
  }
}

// ---------------------------------------------------------------------------
// dW: 128 x BN tiles of dW[e] = sum_g x[g E + e]^T dy[g E + e], persistent
// ---------------------------------------------------------------------------

struct DwParams {
  int N, E, C, din, dout;
  int groups, c_steps, m_tiles, j_tiles, n_tiles;
  int tail_rows;  // rows of a group's last k-step, rounded up to 16
};

struct DwTile {
  int e, m0, j0;
};

// d_out-tile fastest, then d_in-tile, then expert
__device__ __forceinline__ DwTile dw_tile_of(int t, const DwParams& p,
                                             int bn) {
  const int rest = t / p.j_tiles;
  DwTile tl;
  tl.j0 = (t % p.j_tiles) * bn;
  tl.m0 = (rest % p.m_tiles) * TM;
  tl.e = rest / p.m_tiles;
  return tl;
}

// Shared memory of dW: STAGES x (x^T [2][KS c][64 d_in], dy [BN/64][KS c]
// [64 d_out]), the output tile [BN/64][TM][64], the barriers.
template <int BN, int STAGES, int KS>
struct DwSmem {
  static constexpr int CHUNK = KS * 128;  // KS rows of 64 columns
  static constexpr int A_BYTES = 2 * CHUNK;
  static constexpr int STAGE_BYTES = (2 + BN / 64) * CHUNK;
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = OUT_OFF + TM * BN * 2;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
};

// nk (1 .. NK) k16 products of one k-step (A = x^T and B = dy, both
// MN-major, chunks `chunk` bytes apart), after their own fence, committed
// as one group: one straight run of wgmma per count, so that none sits
// behind a branch (a guard on each product made ptxas fence each one)
template <int BN, int NK>
__device__ __forceinline__ void dw_products(float (&acc)[BN / 2], uint32_t a,
                                            uint32_t b, uint32_t chunk,
                                            int nk, bool first) {
  if constexpr (NK > 1) {
    if (nk < NK) {
      dw_products<BN, NK - 1>(acc, a, b, chunk, nk, first);
      return;
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    Wgmma<BN>::template ss<1, 1>(acc, sw128_desc(a + kk * 16 * 128, chunk,
                                                 1024),
                                 sw128_desc(b + kk * 16 * 128, chunk, 1024),
                                 !first || kk > 0);
  wgmma_commit();
}

// TMA_STORE: the staged tile leaves by TMA store; otherwise by the tiles
// variant's 16-byte stores (kept for the sweep).
template <int BN, int S, int KS, bool TMA_STORE>
__global__ void __launch_bounds__(T_THREADS, 1)
    gemm_dw(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tdy,
            const __grid_constant__ CUtensorMap tx_tail,
            const __grid_constant__ CUtensorMap tdy_tail,
            const __grid_constant__ CUtensorMap tdw, bf16* dw, DwParams p) {
  using L = DwSmem<BN, S, KS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t base = raw + pad;
  const uint32_t s_bar = base + L::BAR_OFF;
  auto full = [&](int s) { return s_bar + 8u * s; };
  auto empty = [&](int s) { return s_bar + 8u * (S + s); };
  auto a_tile = [&](int s) { return base + s * L::STAGE_BYTES; };
  auto b_tile = [&](int s) { return base + s * L::STAGE_BYTES + L::A_BYTES; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: k-steps of KS rows of C, groups in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
        const DwTile tl = dw_tile_of(t, p, BN);
        for (int grp = 0; grp < p.groups; ++grp) {
          const int n = grp * p.E + tl.e;
          for (int cs = 0; cs < p.c_steps; ++cs, ++it) {
            const int s = it % S;
            // a group's last step loads its rows rounded up to 16 only
            const bool last = cs + 1 == p.c_steps;
            const CUtensorMap* mx = last ? &tx_tail : &tx;
            const CUtensorMap* mdy = last ? &tdy_tail : &tdy;
            mbar_wait(empty(s), ((it / S) & 1) ^ 1);
            mbar_expect_tx(full(s),
                           (2 + BN / 64) * (last ? p.tail_rows : KS) * 128);
            tma_load_3d(a_tile(s), mx, full(s), tl.m0, cs * KS, n);
            tma_load_3d(a_tile(s) + L::CHUNK, mx, full(s), tl.m0 + 64,
                        cs * KS, n);
#pragma unroll
            for (int ch = 0; ch < BN / 64; ++ch)
              tma_load_3d(b_tile(s) + ch * L::CHUNK, mdy, full(s),
                          tl.j0 + ch * 64, cs * KS, n);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns d_in rows cw*64 .. cw*64 + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    unsigned char* out = smem_raw + pad + L::OUT_OFF + cw * 64 * 128;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const DwTile tl = dw_tile_of(t, p, BN);
      int step = 0;  // k-steps of this tile so far
      for (int grp = 0; grp < p.groups; ++grp) {
        for (int cs = 0; cs < p.c_steps; ++cs, ++it, ++step) {
          const int s = it % S;
          const int nk = (cs + 1 < p.c_steps ? KS : p.tail_rows) / 16;
          mbar_wait(full(s), (it / S) & 1);
          fence_regs(acc);
          dw_products<BN, KS / 16>(acc, a_tile(s) + cw * L::CHUNK, b_tile(s),
                                   L::CHUNK, nk, step == 0);
          fence_regs(acc);
          if (step > 0) {  // the previous step's group is done: free its stage
            wgmma_wait<1>();
            __syncwarp();
            if (lane == 0) mbar_arrive(empty((it - 1) % S));
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((it - 1) % S));

      if (TMA_STORE) {
        // the previous tile's store has read the staging area
        if (tid == 0) bulk_wait_read<0>();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        stage_acc<BN>(out, acc, warp, g, t4);
        fence_async_smem();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        if (tid == 0) {  // boxes wholly past d_in or d_out are not issued
#pragma unroll
          for (int ch = 0; ch < BN / 64; ++ch)
            if (tl.m0 + cw * 64 < p.din && tl.j0 + ch * 64 < p.dout)
              tma_store_3d(&tdw, smem_u32(out + ch * TM * 128),
                           tl.j0 + ch * 64, tl.m0 + cw * 64, tl.e);
          bulk_commit();
        }
      } else {
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        stage_acc<BN>(out, acc, warp, g, t4);
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        store_staged<BN>(out, dw + static_cast<long long>(tl.e) * p.din *
                                       p.dout,
                         p.dout, tl.m0 + cw * 64, p.din, tl.j0, p.dout, tid);
      }
    }
    if (TMA_STORE && tid == 0) bulk_wait<0>();  // the last stores are done
  }
}

// ---------------------------------------------------------------------------
// skinny: y^T = w^T x^T, one CTA per (n, 128-wide f-tile)
// ---------------------------------------------------------------------------

constexpr int SF = 128;          // f per CTA: two m64 products
constexpr int S_THREADS = 160;   // warpgroup 0 consumes, warp 4 produces
constexpr int S_STAGES = 4;

template <int NB>
struct SkinnySmem {
  static constexpr int W_BYTES = BK * SF * 2;  // two 64-column chunks
  static constexpr int X_BYTES = NB * BK * 2;  // NB rows of 128 bytes
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
  static constexpr int BAR_OFF = S_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 16 * S_STAGES + 1024;
};

template <int NB>
__global__ void __launch_bounds__(S_THREADS)
    gemm_skinny(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw, Params p) {
  using L = SkinnySmem<NB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t s_bar = base + L::BAR_OFF;
  auto full = [&](int s) { return s_bar + 8u * s; };
  auto empty = [&](int s) { return s_bar + 8u * (S_STAGES + s); };
  auto w_tile = [&](int s) { return base + s * L::STAGE_BYTES; };
  auto x_tile = [&](int s) { return base + s * L::STAGE_BYTES + L::W_BYTES; };
  const int f0 = blockIdx.x * SF, n = blockIdx.y, e = n % p.E;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread of warp 4 ----
    if (threadIdx.x == 128) {
      for (int kt = 0; kt < p.k_tiles; ++kt) {
        const int s = kt % S_STAGES;
        mbar_wait(empty(s), ((kt / S_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), L::STAGE_BYTES);
        tma_load_3d(w_tile(s), &tw, full(s), f0, kt * BK, e);
        tma_load_3d(w_tile(s) + CHUNK_BYTES, &tw, full(s), f0 + 64, kt * BK,
                    e);
        tma_load_3d(x_tile(s), &tx, full(s), kt * BK, 0, n);
      }
    }
    return;
  }

  // ---- consumer warpgroup: f rows h*64 .. h*64 + 63 of the tile, h = 0, 1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float acc0[NB / 2], acc1[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc0[i] = acc1[i] = 0.f;
  for (int kt = 0; kt < p.k_tiles; ++kt) {
    const int s = kt % S_STAGES;
    mbar_wait(full(s), (kt / S_STAGES) & 1);
    const uint32_t wt = w_tile(s), xt = x_tile(s);
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = sw128_desc(xt + kk * 32, 16, 1024);
      const int sc = kt > 0 || kk > 0;
      Wgmma<NB>::template ss<1, 0>(
          acc0, sw128_desc(wt + kk * 16 * 128, CHUNK_BYTES, 1024), db, sc);
      Wgmma<NB>::template ss<1, 0>(
          acc1, sw128_desc(wt + CHUNK_BYTES + kk * 16 * 128, CHUNK_BYTES, 1024),
          db, sc);
    }
    wgmma_commit();
    fence_regs(acc0);
    fence_regs(acc1);
    if (kt > 0) {
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((kt - 1) % S_STAGES));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);

  // epilogue: accumulator row = f, column = c; scalar bf16 stores
  bf16* yg = p.y + static_cast<long long>(n) * p.C * p.f;
  auto store = [&](const float(&acc)[NB / 2], int h) {
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int fr = f0 + h * 64 + warp * 16 + g + 8 * (q >> 1);
        const int c = j * 8 + 2 * t4 + (q & 1);
        if (fr < p.f && c < p.C)
          yg[static_cast<long long>(c) * p.f + fr] =
              __float2bfloat16(acc[4 * j + q]);
      }
    }
  };
  store(acc0, 0);
  store(acc1, 1);
}


// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// mats row-major (rows, cols) bf16 matrices back to back: boxes of 64
// columns x box_rows rows x 1 matrix, 128-byte swizzle
bool encode_3d(CUtensorMap* map, const void* base, int mats, int rows,
               int cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16_sw128(map, base, 3, dims, strides, box);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// TB = 1: w (E, d, f) in 64 x 64 boxes; TB = 0: w (E, f, d) in boxes of 64
// k-columns x BN rows
template <int BN, int STAGES, int TB>
int launch_tiles(const void* x, const void* w, Params p, cudaStream_t s) {
  CUtensorMap tx, tw;
  const bool ok_w = TB ? encode_3d(&tw, w, p.E, p.d, p.f, BK)
                       : encode_3d(&tw, w, p.E, p.f, p.d, BN);
  if (!encode_3d(&tx, x, p.N, p.C, p.d, TM) || !ok_w)
    return static_cast<int>(cudaErrorInvalidValue);
  p.c_tiles = (p.C + TM - 1) / TM;
  p.f_tiles = (p.f + BN - 1) / BN;
  p.n_tiles = p.c_tiles * p.groups * p.f_tiles * p.E;
  const int bytes = TileSmem<BN, STAGES>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_tiles<BN, STAGES, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.n_tiles < sm_count() ? p.n_tiles : sm_count();
  gemm_tiles<BN, STAGES, TB><<<grid, T_THREADS, bytes, s>>>(tx, tw, p);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_skinny(const void* x, const void* w, Params p, cudaStream_t s) {
  CUtensorMap tx, tw;
  if (!encode_3d(&tx, x, p.N, p.C, p.d, NB) ||
      !encode_3d(&tw, w, p.E, p.d, p.f, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = SkinnySmem<NB>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_skinny<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.f + SF - 1) / SF, p.N);
  gemm_skinny<NB><<<grid, S_THREADS, bytes, s>>>(tx, tw, p);
  return static_cast<int>(cudaGetLastError());
}

// x (N, C, din), dy (N, C, dout) -> dw (E, din, dout)
template <int BN, int STAGES, int KS, bool TMA_STORE>
int launch_dw(const void* x, const void* dy, void* dw, int N, int E, int C,
              int din, int dout, cudaStream_t s) {
  DwParams p;
  p.c_steps = (C + KS - 1) / KS;
  p.tail_rows = (C - (p.c_steps - 1) * KS + 15) / 16 * 16;
  CUtensorMap tx, tdy, tx_tail, tdy_tail, tdw;
  if (!encode_3d(&tx, x, N, C, din, KS) ||
      !encode_3d(&tdy, dy, N, C, dout, KS) ||
      !encode_3d(&tx_tail, x, N, C, din, p.tail_rows) ||
      !encode_3d(&tdy_tail, dy, N, C, dout, p.tail_rows) ||
      !encode_3d(&tdw, dw, E, din, dout, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  p.N = N;
  p.E = E;
  p.C = C;
  p.din = din;
  p.dout = dout;
  p.groups = N / E;
  p.m_tiles = (din + TM - 1) / TM;
  p.j_tiles = (dout + BN - 1) / BN;
  p.n_tiles = p.m_tiles * p.j_tiles * E;
  const int bytes = DwSmem<BN, STAGES, KS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_dw<BN, STAGES, KS, TMA_STORE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.n_tiles < sm_count() ? p.n_tiles : sm_count();
  gemm_dw<BN, STAGES, KS, TMA_STORE><<<grid, T_THREADS, bytes, s>>>(
      tx, tdy, tx_tail, tdy_tail, tdw, static_cast<bf16*>(dw), p);
  return static_cast<int>(cudaGetLastError());
}

Params params_of(void* y, int N, int E, int C, int d, int f) {
  Params p;
  p.y = static_cast<bf16*>(y);
  p.N = N;
  p.E = E;
  p.C = C;
  p.d = d;
  p.f = f;
  p.groups = N / E;
  p.k_tiles = (d + BK - 1) / BK;
  p.c_tiles = p.f_tiles = p.n_tiles = 0;
  return p;
}

}  // namespace

// Contiguous bf16, N % E == 0, d and f positive multiples of 8, every
// pointer 16-byte aligned (the wrapper's gemm_variant / gemm_bwd_variant
// check all of it). variant (ops.py: GEMM_VARIANTS) and what x, w, y, d, f
// are:
//   0 tiles, 1 skinny (C <= 64): x (N, C, d), w (E, d, f) -> y (N, C, f)
//   2 dX: x = dY (N, C, d), w = W (E, f, d) -> y = dX (N, C, f)
//   3 dW: x = X (N, C, d), w = dY (N, C, f) -> y = dW (E, d, f)
// N or C of 0 writes nothing. Returns a cudaError_t.
extern "C" int expert_gemm_wgmma(const void* x, const void* w, void* y,
                                 int N, int E, int C, int d, int f,
                                 int variant, void* stream) {
  if (N <= 0 || C <= 0) return 0;
  if (E <= 0 || N % E != 0 || d <= 0 || d % 8 != 0 || f <= 0 || f % 8 != 0 ||
      variant < 0 || variant > 3 || (variant == 1 && C > SKINNY_MAX_C))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(y);
  if (any % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 3)
    return launch_dw<128, 4, 96, true>(x, w, y, N, E, C, d, f, s);
  const Params p = params_of(y, N, E, C, d, f);
  if (variant == 0) return launch_tiles<192, 4, 1>(x, w, p, s);
  if (variant == 2) return launch_tiles<192, 4, 0>(x, w, p, s);
  if (C <= 8) return launch_skinny<8>(x, w, p, s);
  if (C <= 16) return launch_skinny<16>(x, w, p, s);
  if (C <= 32) return launch_skinny<32>(x, w, p, s);
  return launch_skinny<64>(x, w, p, s);
}

#ifdef EXPERT_GEMM_SWEEP
// Tuning entry points, compiled only with -DEXPERT_GEMM_SWEEP (by
// tools/kernel_sweep.py), with the checks of expert_gemm_wgmma left to the
// caller: the tiles variant at the (BN, STAGES) settings below, and dW at
// (BN, STAGES) with its TMA-store or its 16-byte-store epilogue.
extern "C" int expert_gemm_sweep(const void* x, const void* w, void* y,
                                 int N, int E, int C, int d, int f, int bn,
                                 int stages, void* stream) {
  const Params p = params_of(y, N, E, C, d, f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128 && stages == 4) return launch_tiles<128, 4, 1>(x, w, p, s);
  if (bn == 128 && stages == 6) return launch_tiles<128, 6, 1>(x, w, p, s);
  if (bn == 192 && stages == 3) return launch_tiles<192, 3, 1>(x, w, p, s);
  if (bn == 192 && stages == 4) return launch_tiles<192, 4, 1>(x, w, p, s);
  if (bn == 256 && stages == 2) return launch_tiles<256, 2, 1>(x, w, p, s);
  if (bn == 256 && stages == 3) return launch_tiles<256, 3, 1>(x, w, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int expert_gemm_dw_sweep(const void* x, const void* dy, void* dw,
                                    int N, int E, int C, int din, int dout,
                                    int bn, int stages, int ks, int tma_store,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DW_CASE(BN_, S_, KS_, ST_)                                         \
  if (bn == BN_ && stages == S_ && ks == KS_ && tma_store == ST_)          \
    return launch_dw<BN_, S_, KS_, ST_ == 1>(x, dy, dw, N, E, C, din, dout, \
                                             s);
  DW_CASE(192, 4, 64, 1)
  DW_CASE(192, 2, 96, 1)
  DW_CASE(256, 3, 64, 1)
  DW_CASE(128, 3, 128, 1)
  DW_CASE(128, 4, 96, 1)
  DW_CASE(128, 4, 96, 0)
  DW_CASE(64, 5, 96, 1)
#undef DW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // EXPERT_GEMM_SWEEP
