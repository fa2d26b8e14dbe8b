// Forward kernels of the non-causal blockwise MHLA island for Hopper (sm_90a):
//
//   K6 mix_states_dense  mixed[b, i] = sum_j M[i, j] S[b, j]      dense [N, N] mixing
//   K7 block_readout     o[b, i, :, h] = q[b, i, :, h] @ mixed[b, i, h]
//
// Both come in float32 (the default attention island of the video model,
// float32-accurate products) and in bf16 (attn_compute_dtype=bfloat16);
// both accumulate in float32 and round once to the element type.
//
// Layout: tokens are head-flat and blocked, [B, N, C, H*D]; the states and
// the mixed states are [B, N, H*Dk, Dv], R = H*Dk*Dv columns a block row.
//
// K6 replaces mix_states_dense (mhla_tpu/kernels/mhla_block_pallas.py:51),
//   which runs _mix_kernel (mhla_tpu/kernels/mhla_chunk_pallas.py:293) with
//   one full band; the video model mixes N = 150 blocks densely, on M in the
//   forward and its remat recompute and on M^T in the backward.
//   Bound: bytes. S is read once and the result written once, 2 * B*N*R
//   elements (472 MB at [2, 150, 1536, 128] float32: 0.141 ms at 3.35
//   TB/s). Float32 accuracy on the TF32 tensor cores takes three products
//   (below), 3 * 2 * N^2 * R * B operations: 53 GFLOP there, 0.107 ms at 495
//   TFLOP/s; the bf16 form one, 0.036 ms, below its 0.070 ms of bytes.
//   (Outside the tensor cores the same float32 product is 17.7 GFLOP at 67
//   TFLOP/s, 0.264 ms: the earlier SIMT kernel's bound.)
//   Split: each float32 operand x = hi + lo, hi its TF32 rounding and lo =
//   x - hi, which the tensor cores read truncated to TF32 (split_tf32 in
//   hopper.cuh); hi S^T hi M + hi S^T lo M + lo S^T hi M carries the product
//   to float32 accuracy, where one TF32 product alone is about 3e-4 off in
//   relative RMS. A bf16 S is exact in TF32 and the bf16 form returns bf16,
//   whose rounding (2^-9 relative) lies above that 3e-4, so that form runs
//   the one product S hi M.
//   Design: TF32 wgmma takes both operands K-major, and S[j][c] read as B is
//   not, so the kernel computes out^T = S^T M^T: A is a 64-column tile of
//   S^T, taken into registers from a TMA-staged tile of S and split there;
//   B is M's rows (K-major as stored), split into hi and lo once per block
//   into 128-byte swizzled panels (hi only in the bf16 form). N (the i axis)
//   is split over a cluster of two blocks up to N = 160 (four up to 224),
//   each holding kNH rows of M's copies (80 rows x 160 columns x 8 bytes =
//   100 KB at N = 150 in float32; all of M would be 185 KB). The blocks are
//   persistent over items of 256 state columns of one batch row; each of
//   two consumer warpgroups takes two tiles of 64 columns. S streams
//   through a ring of up to 16 stages of one k-step (8 rows of j across the
//   item's columns, 8 KB in float32); each
//   block loads its share of every stage's panels and multicasts it to the
//   cluster, so S is read once from device memory and every block gets all
//   of it. The products read a stage from registers only, so it is freed as
//   soon as its fragments are loaded, in every block of the cluster once all
//   have them (one remote mbarrier arrival per warpgroup and block, at CTA
//   scope: a cluster-scope release made each arrival wait, and the kernel
//   ran 3x slower). Each consumer keeps two register sets of A fragments, so
//   a k-step's products run while the next k-step is loaded and split; the
//   producer gives its registers to the consumers (setmaxnreg 40 / 232).
//   Each warpgroup's [kNH x 64] tiles are transposed into a swizzled
//   shared-memory buffer (two a warpgroup where shared memory allows, one
//   written while the other is stored) and stored by TMA (rows past N and
//   columns past R are not written). No atomics: the result is the same
//   from run to run. What bounds it (on an H100, PERF.md section 6): in a
//   form with clusters of four and items of 512 columns, the data path alone
//   (no products) took about 0.20 ms at N = 150 in float32 (2.3 TB/s), and a
//   wgmma of N = 40 about as long as one of N = 80, so two blocks of 80
//   rows, not four of 40, hold M.
//   Not Triton: the point of the kernel is where its operands live, M's
//   split copies resident in shared memory for a persistent block's whole
//   walk and one S tile multicast to a cluster, and Triton places neither.
//
// K7 replaces _readout_fwd_kernel (mhla_block_pallas.py:100). The TPU kernel
//   groups G blocks of rows into one supertile and masks rows to feed its
//   128 x 128 matrix unit; none of that tiling is carried over.
//   Bound: bytes. q read once, o written once and the mixed states read
//   once: 1,010 MB at (d)'s [2, 150, 210, 12 * 128] float32, 0.302 ms at
//   3.35 TB/s; three TF32 products of 2 * C * Dk * Dv a block and head, 74
//   GFLOP there, 0.150 ms at 495 TFLOP/s (the bf16 form: half the bytes and
//   one product). (Outside the tensor cores the float32 product is 24.8
//   GFLOP at 67 TFLOP/s, 0.370 ms: the earlier FMA kernel's bound.)
//   Design: o = q mixed on TF32 wgmma, K = Dk, with K6's hi / lo split (the
//   bf16 form one product, q and the states exact in TF32). A persistent
//   grid of blocks of a producer warpgroup and two consumer warpgroups walks
//   items of (block, head, 2 * kVW columns of Dv); consumer w owns kVW of
//   them. TF32 wgmma reads both operands K-major: q's rows are, so q is the
//   A operand, taken into registers from a TMA-staged tile and split there;
//   mixed [Dk][Dv] is not, so each consumer writes its [kVW][Dk] slice of
//   mixed^T into shared memory once per item, split into hi and lo while
//   transposing, from registers it loaded during the previous item. The
//   other orientation (o^T = mixed^T q^T, q the B operand) would split and
//   write q's lo tile every token tile, C / Dv times the work. Each k-step
//   of 8 is one commit group (three products, one in bf16) whose A
//   fragments are split while the previous k-step's products run. Shared
//   memory at
//   Dk = 128, float32 (kVW = 64): mixed^T hi + lo 2 x 64 KB, the output
//   tiles 2 x 16 KB, 8 q stages of one 128-byte panel of 64 token rows (8
//   KB): 230,528 of 232,448 bytes. Dk = 256 takes kVW = 32 in float32 (the
//   same 64 KB a consumer; 10 stages), 64 in bf16 (hi only). q is loaded
//   through a tensor map with C as a dimension of its own, so rows past C
//   read as zeros (C = 210 is not a multiple of the 64-row tile), and o is
//   stored through one (rows past C are not written), each tile from a
//   swizzled staging buffer by TMA. Sums in a fixed order, no atomics: the
//   same bits every run.
//   What holds it (PERF.md sections 6 and 7): the next item's slice held in
//   64 registers through an item (the kernel is at ptxas's cap of 168 a
//   thread) slows every tile's products, and loaded later (from L2, or in
//   the last tile) its latency shows instead; two blocks of one consumer an
//   SM spilled at 200 registers.

#include "hopper.cuh"
#include "mhla_block_common.cuh"

using namespace hopper;
using namespace mhla_block;

namespace {

// K6's geometry: blocks of a producer warpgroup and two consumer
// warpgroups; items of 2 * kWT column tiles of 64 (kWT per consumer);
// stages of one k-step, 8 rows of S (the sum's j) across the item's columns.
constexpr int kMixConsumers = 2;
constexpr int kMixThreads = 128 * (1 + kMixConsumers);
constexpr int kMixK = 8;
constexpr int kMixMaxStages = 16;
constexpr int kMaxMixBlocks = 224;  // N: clusters of four blocks of 56 rows of M
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

template <typename T, int kWT>
struct MixGeom {
  static constexpr int kEs = (int)sizeof(T);
  static constexpr int kCols = kMixConsumers * 64 * kWT;     // columns of an item
  static constexpr int kPanelCols = 128 / kEs;               // columns of a 128-byte panel row
  static constexpr int kPanels = kCols / kPanelCols;         // 1 KB panels of a stage
  static constexpr int kStageBytes = kMixK * kCols * kEs;
  static constexpr bool kSplit = sizeof(T) == 4;  // three products (hi and lo M), else one
};

// Output tiles of [kNH][64] a consumer stages its results in: two where
// shared memory allows (one is written while the other is stored), else one.
__host__ __device__ constexpr int mix_out_bufs(int nh) { return nh <= 40 ? 2 : 1; }

// K6's dynamic shared memory besides the stages: M's rows (kNH x KP float32,
// hi and lo in float32, hi alone in bf16), the consumers' output tiles,
// slack for alignment. The stages take what is left, at most kMixMaxStages.
int mix_fixed_smem(int es, int nh, int kp) {
  return (es == 4 ? 2 : 1) * nh * kp * 4 + mix_out_bufs(nh) * kMixConsumers * 64 * nh * es +
         1024;
}

// Element (j, c) of a stage: [kMixK][kCols] in 1 KB panels of 128-byte rows.
__device__ __forceinline__ float stage_at(const float* st, int j, int c) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const unsigned char*>(st) +
                                         (c >> 5) * 1024 + swizzle128_f32(j, c & 31));
}
__device__ __forceinline__ float stage_at(const bf16* st, int j, int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      reinterpret_cast<const unsigned char*>(st) + (c >> 6) * 1024 + swizzle128(j, c & 63)));
}

// Element (i, c) of an output tile: [kNH][64] in panels of 128-byte rows.
template <int kNH>
__device__ __forceinline__ void put_out(float* tile, int i, int c, float v) {
  *reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(tile) + (c >> 5) * kNH * 128 +
                            swizzle128_f32(i, c & 31)) = v;
}
template <int kNH>
__device__ __forceinline__ void put_out(bf16* tile, int i, int c, float v) {
  *reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(tile) + swizzle128(i, c)) =
      __float2bfloat16_rn(v);
}

// K6. A persistent grid of clusters of kCL blocks, kMixThreads threads,
// dynamic shared memory mix_fixed_smem + stages * kStageBytes. Block
// ``rank`` of a cluster computes rows [rank * kNH, rank * kNH + kNH) of
// every item its cluster takes, and loads panels [rank * kPanels / kCL,
// ...) of every stage for the whole cluster. map_s and map_out are make_rows_map
// maps of s and out ([B, N, R]) with boxes of kMixK and kNH rows. m: [N, N]
// float32, read row-major as B.
template <typename T, int kNH, int kWT, int kCL>
__global__ void __launch_bounds__(kMixThreads, 1)
mix_dense_kernel(const __grid_constant__ CUtensorMap map_s,
                 const __grid_constant__ CUtensorMap map_out, const float* __restrict__ m, int N,
                 int KP, long long R, int col_items, int items, int stages) {
  typedef MixGeom<T, kWT> G;
  constexpr int kTiles = kNH / 8;
  constexpr int kOutBytes = 64 * kNH * G::kEs;  // one output tile
  constexpr int kOutBufs = mix_out_bufs(kNH);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int mbytes = kNH * KP * 4;
  unsigned char* m_hi = smem;
  unsigned char* m_lo = smem + mbytes;  // float32 form only
  unsigned char* outs = smem + (G::kSplit ? 2 : 1) * mbytes;
  unsigned char* ring = outs + kOutBufs * kMixConsumers * kOutBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * G::kStageBytes);
  uint64_t* empty = full + stages;

  const uint32_t rank = cluster_ctarank();
  const int cluster = blockIdx.x / kCL, clusters = gridDim.x / kCL;
  const int nk = KP / kMixK;
  const int i0 = rank * kNH;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kMixConsumers * kCL);  // every consumer warpgroup of the cluster
    }
    fence_barrier_init();
  }
  cluster_sync();  // the cluster's barriers exist before any multicast or remote arrival

  const int tid = threadIdx.x;
  if (tid < 128) {  // the producer: one thread loads this block's panels of every stage
    regs_dec<40>();
    if (tid == 0) {
      constexpr int kMine = G::kPanels / kCL;
      int stage = 0;
      uint32_t phase = 0;
      for (int item = cluster; item < items; item += clusters) {
        const int b = item / col_items, c0 = (item % col_items) * G::kCols;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], G::kStageBytes);
          unsigned char* dst = ring + stage * G::kStageBytes;
#pragma unroll
          for (int p = rank * kMine; p < (rank + 1) * kMine; ++p)
            tma_load_4d_multicast(dst + p * 1024, &map_s, &full[stage],
                                  (uint16_t)((1 << kCL) - 1), c0 + p * G::kPanelCols,
                                  kc * kMixK, b, 0);
          if (++stage == stages) stage = 0, phase ^= 1;
        }
      }
    }
    cluster_sync();  // no block leaves while another may still arrive on its barriers
    return;          // (the roles do not meet again after setmaxnreg)
  } else {  // the consumers, kWT tiles of 64 columns of every item each
    regs_inc<232>();
    const int wg = tid / 128 - 1, t = tid % 128;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
    // this block's rows of M, split into TF32 hi and lo (hi alone in the
    // bf16 form), K-major panels of 32 columns
    for (int e = tid - 128; e < kNH * KP; e += 128 * kMixConsumers) {
      const int i = e / KP, j = e - i * KP;
      const float x = (i0 + i < N && j < N) ? m[(int64_t)(i0 + i) * N + j] : 0.f;
      uint32_t hi, lo;
      split_tf32(x, hi, lo);
      const int off = (j >> 5) * kNH * 128 + swizzle128_f32(i, j & 31);
      *reinterpret_cast<uint32_t*>(m_hi + off) = hi;
      if constexpr (G::kSplit) *reinterpret_cast<uint32_t*>(m_lo + off) = lo;
    }
    fence_async_shared();  // the wgmmas read M through the async proxy
    named_sync(1, 128 * kMixConsumers);
    const uint64_t dhi = desc_kmajor(m_hi, 0), dlo = desc_kmajor(m_lo, 0);
    const int cw = wg * 64 * kWT;  // this warpgroup's first column of an item
    int stage = 0, out = 0;
    uint32_t phase = 0;
    float acc[kWT][kTiles][4];
    // Stage kc in: A = S^T for each of this warpgroup's tiles x the stage's
    // 8 rows, split; the products read it from registers only, so the stage
    // is freed at once, in every block of the cluster once all have read it.
    auto stage_in = [&](uint32_t (&ahi)[kWT][4], uint32_t (&alo)[kWT][4]) {
      mbar_wait(&full[stage], phase);
      const T* st = reinterpret_cast<const T*>(ring + stage * G::kStageBytes);
#pragma unroll
      for (int w = 0; w < kWT; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = stage_at(st, tg + 4 * (e >> 1), cw + w * 64 + warp * 16 + g + 8 * (e & 1));
          if constexpr (G::kSplit) split_tf32(x, ahi[w][e], alo[w][e]);
          else ahi[w][e] = __float_as_uint(x);
        }
      named_sync(2 + wg, 128);
      if (t == 0)
        for (int q = 0; q < kCL; ++q) mbar_arrive_cluster(&empty[stage], q);
      if (++stage == stages) stage = 0, phase ^= 1;
    };
    // The products of k-step kc, one commit group.
    auto products = [&](const uint32_t (&ahi)[kWT][4], const uint32_t (&alo)[kWT][4], int kc) {
      const uint64_t off = kstep_kmajor<kNH>(kc);
      wgmma_fence();
#pragma unroll
      for (int w = 0; w < kWT; ++w) {
        wgmma_tf32(acc[w], ahi[w], dhi + off, kc > 0);
        if constexpr (G::kSplit) {
          wgmma_tf32(acc[w], ahi[w], dlo + off, 1);
          wgmma_tf32(acc[w], alo[w], dhi + off, 1);
        }
      }
      wgmma_commit();
    };
    for (int item = cluster; item < items; item += clusters) {
      const int b = item / col_items;
      const long long c0 = (long long)(item % col_items) * G::kCols + cw;
      // two register sets of A in turn: a k-step's products run while the
      // next k-step's fragments are loaded (nk is a multiple of 4)
      uint32_t a0hi[kWT][4], a0lo[kWT][4], a1hi[kWT][4], a1lo[kWT][4];
      for (int kc = 0; kc < nk; kc += 2) {
        stage_in(a0hi, a0lo);
        products(a0hi, a0lo, kc);
        wgmma_wait<1>();  // k-step kc - 1 is done: a1 may be written
        fence_frag(a1hi);
        if constexpr (G::kSplit) fence_frag(a1lo);
        stage_in(a1hi, a1lo);
        products(a1hi, a1lo, kc + 1);
        wgmma_wait<1>();  // k-step kc is done: a0 may be written
        fence_frag(a0hi);
        if constexpr (G::kSplit) fence_frag(a0lo);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int w = 0; w < kWT; ++w) fence_acc(acc[w]);
      fence_frag(a1hi);
      if constexpr (G::kSplit) fence_frag(a1lo);
      // out[b, i0 + i, c0 + 64 w + c] = acc[w]^T, each tile through a
      // swizzled buffer and one TMA store
#pragma unroll
      for (int w = 0; w < kWT; ++w, out = (out + 1) % kOutBufs) {
        T* tile = reinterpret_cast<T*>(outs + (kOutBufs * wg + out) * kOutBytes);
        // the store that last used this buffer has read it
        if (t == 0) tma_store_wait_read<kOutBufs - 1>();
        named_sync(2 + wg, 128);
#pragma unroll
        for (int n = 0; n < kTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            put_out<kNH>(tile, n * 8 + tg * 2 + (e & 1), warp * 16 + g + 8 * (e >> 1),
                         acc[w][n][e]);
        fence_async_shared();
        named_sync(2 + wg, 128);
        if (t == 0 && c0 + w * 64 < R && i0 < N) {
#pragma unroll
          for (int p = 0; p < 64 / G::kPanelCols; ++p)
            tma_store_4d_part(&map_out, reinterpret_cast<unsigned char*>(tile) + p * kNH * 128,
                              (int)c0 + w * 64 + p * G::kPanelCols, i0, b, 0);
        }
        if (t == 0) tma_store_commit();  // an empty group where nothing was stored
      }
    }
    if (t == 0) tma_store_wait_all();
    cluster_sync();
  }
}

// K7's geometry: blocks of a producer warpgroup and two consumer
// warpgroups; items of (block, head, kCols = 2 * kVW columns of Dv), each
// consumer kVW of them; q in stages of one 128-byte panel (32 float32 or 64
// bf16 columns of Dk) of kReadTok token rows.
constexpr int kReadConsumers = 2;
constexpr int kReadThreads = 128 * (1 + kReadConsumers);
constexpr int kReadTok = 64;
constexpr int kReadMaxStages = 16;

template <typename T, int kDk, int kVW>
struct ReadGeom {
  static constexpr int kEs = (int)sizeof(T);
  static constexpr bool kSplit = sizeof(T) == 4;          // three products, else one
  static constexpr int kCols = kReadConsumers * kVW;
  static constexpr int kPanelK = 128 / kEs;               // Dk columns of a stage
  static constexpr int kPanels = kDk / kPanelK;           // stages of a token tile
  static constexpr int kKS = kPanelK / 8;                 // k-steps of a stage
  static constexpr int kStageBytes = kReadTok * 128;
  static constexpr int kMBytes = kVW * kDk * 4;           // a consumer's mixed^T, hi or lo
  static constexpr int kOutPanel = 128 / kEs;             // columns of an output box
  static constexpr int kOutBytes = kReadTok * kVW * kEs;  // a consumer's output tile
  static constexpr int kFixed =
      kReadConsumers * ((kSplit ? 2 : 1) * kMBytes + kOutBytes) + 1024;
  static constexpr int kFree = (kSmemLimit - kFixed) / (kStageBytes + 16);
  static constexpr int kStages = kFree < kReadMaxStages ? kFree : kReadMaxStages;
  static constexpr int kSmem = kFixed + kStages * (kStageBytes + 16);
  static constexpr int kPre = kDk * kVW / (4 * 128);      // 4-element loads of mixed a thread
  static_assert(kStages >= 2 && kVW % kOutPanel == 0, "K7's geometry");
};

// Element (r, c) of one 128-byte panel of rows (a TMA box, 128-byte swizzle).
__device__ __forceinline__ float panel_at(const float* p, int r, int c) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const unsigned char*>(p) +
                                         swizzle128_f32(r, c));
}
__device__ __forceinline__ float panel_at(const bf16* p, int r, int c) {
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(reinterpret_cast<const unsigned char*>(p) + swizzle128(r, c)));
}

// Elements (r, c) and (r, c + 1) of an output tile of [kReadTok] rows in
// 128-byte panels (c even).
__device__ __forceinline__ void put_pair(float* tile, int r, int c, float x0, float x1) {
  *reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(tile) + (c >> 5) * kReadTok * 128 +
                             swizzle128_f32(r, c & 31)) = make_float2(x0, x1);
}
__device__ __forceinline__ void put_pair(bf16* tile, int r, int c, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<unsigned char*>(tile) +
                                     (c >> 6) * kReadTok * 128 + swizzle128(r, c & 63)) =
      __floats2bfloat162_rn(x0, x1);
}

// K7. A persistent grid of blocks of kReadThreads threads, dynamic shared
// memory ReadGeom::kSmem. map_q, map_o: make_rows_map maps of q [B*N, C,
// H*kDk] and o [B*N, C, H*Dv] with boxes of kReadTok rows; mixed: [B*N,
// H*kDk, Dv]. Items: (block * H + head) * (Dv / kCols) + column group.
template <typename T, int kDk, int kVW>
__global__ void __launch_bounds__(kReadThreads, 1)
readout_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_o,
               const T* __restrict__ mixed, int C, int H, int Dv, int items) {
  typedef ReadGeom<T, kDk, kVW> G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* outs = smem + kReadConsumers * (G::kSplit ? 2 : 1) * G::kMBytes;
  unsigned char* ring = outs + kReadConsumers * G::kOutBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::kStages * G::kStageBytes);
  uint64_t* empty = full + G::kStages;
  const int tiles = (C + kReadTok - 1) / kReadTok;
  const int groups = Dv / G::kCols;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kReadConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer: one thread keeps the q stages in flight
    regs_dec<40>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int bh = item / groups, bn = bh / H, h = bh % H;
        for (int tt = 0; tt < tiles; ++tt)
          for (int p = 0; p < G::kPanels; ++p) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], G::kStageBytes);
            tma_load_4d(ring + stage * G::kStageBytes, &map_q, &full[stage],
                        h * kDk + p * G::kPanelK, tt * kReadTok, bn, 0);
            if (++stage == G::kStages) stage = 0, phase ^= 1;
          }
      }
    }
    return;
  }

  regs_inc<232>();
  const int wg = tid / 128 - 1, t = tid % 128;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
  unsigned char* m_hi = smem + wg * (G::kSplit ? 2 : 1) * G::kMBytes;
  unsigned char* m_lo = m_hi + G::kMBytes;  // float32 form only
  T* otile = reinterpret_cast<T*>(outs + wg * G::kOutBytes);
  const uint64_t dhi = desc_kmajor(m_hi, 0), dlo = desc_kmajor(m_lo, 0);
  const int bar = 2 + wg;  // this consumer's named barrier

  // This consumer's [kDk][kVW] slice of an item's mixed, loaded into
  // registers an item ahead: load j of lane l is row 8 (u % kRB) + l % 8,
  // columns 4 (4 (u / kRB) + l / 8) .. + 3 with u = warp + 4 j, so a warp
  // reads 64 contiguous bytes (32 in bf16) of each of 8 rows and writes
  // mixed^T with two lanes a bank.
  constexpr int kRB = kDk / 8;
  typedef typename Raw4<T>::type R4;
  R4 pre[G::kPre];
  auto at = [&](int j, int& k, int& v0) {
    const int u = warp + 4 * j;
    k = (u % kRB) * 8 + (lane & 7);
    v0 = 4 * ((u / kRB) * 4 + (lane >> 3));
  };
  auto prefetch = [&](int item) {
    const int bh = item / groups;
    const T* src = mixed + (int64_t)bh * kDk * Dv + (item % groups) * G::kCols + wg * kVW;
#pragma unroll
    for (int j = 0; j < G::kPre; ++j) {
      int k, v0;
      at(j, k, v0);
      pre[j] = *reinterpret_cast<const R4*>(src + (int64_t)k * Dv + v0);
    }
  };
  // mixed^T [kVW][kDk] as the K-major B operand, split into hi and lo (hi
  // alone in the bf16 form), 128-byte swizzled panels of 32 columns of Dk.
  auto build = [&]() {
#pragma unroll
    for (int j = 0; j < G::kPre; ++j) {
      int k, v0;
      at(j, k, v0);
      const float4 x = raw_to_float4(pre[j]);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = (k >> 5) * kVW * 128 + swizzle128_f32(v0 + e, k & 31);
        if constexpr (G::kSplit) {
          uint32_t hi, lo;
          split_tf32(xs[e], hi, lo);
          *reinterpret_cast<uint32_t*>(m_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(m_lo + off) = lo;
        } else {
          *reinterpret_cast<float*>(m_hi + off) = xs[e];  // a bf16 value is exact in TF32
        }
      }
    }
  };

  int stage = 0, freed = 0;  // the next stage to take, the next to free
  uint32_t phase = 0;
  float acc[kVW / 8][4];
  uint32_t ahi[2][4], alo[2][4];  // the A fragments of two k-steps in turn
  // Free the oldest stage taken, after a wgmma_wait that completed the last
  // products it fed in every warp. (Freed as soon as its fragments were
  // loaded, a stage was at times overwritten by the next load while they
  // were still being read: whole 8-row atoms of q wrong, which the card
  // test's two-run comparison caught at Dk or Dv = 256.)
  auto free_stage = [&]() {
    named_sync(bar, 128);
    if (t == 0) mbar_arrive(&empty[freed]);
    if (++freed == G::kStages) freed = 0;
  };

  if (blockIdx.x < items) prefetch(blockIdx.x);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bh = item / groups, bn = bh / H, h = bh % H;
    const int col = h * Dv + (item % groups) * G::kCols + wg * kVW;  // this consumer's first column
    build();  // the previous item's products are done (its last tile's epilogue synced)
    fence_async_shared();
    named_sync(bar, 128);
    if (item + (int)gridDim.x < items) prefetch(item + gridDim.x);
    for (int tt = 0; tt < tiles; ++tt) {
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) {
        mbar_wait(&full[stage], phase);
        const T* st = reinterpret_cast<const T*>(ring + stage * G::kStageBytes);
        // k-step s: its A fragments (q rows) split in registers, three
        // products (one in bf16) as one commit group; a k-step's products
        // run while the next k-step's fragments are loaded and split
#pragma unroll
        for (int s = 0; s < G::kKS; ++s) {
          const int r = s & 1;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = panel_at(st, warp * 16 + g + 8 * (e & 1), 8 * s + tg + 4 * (e >> 1));
            if constexpr (G::kSplit) split_tf32(x, ahi[r][e], alo[r][e]);
            else ahi[r][e] = __float_as_uint(x);
          }
          const uint64_t off = kstep_kmajor<kVW>(p * G::kKS + s);
          wgmma_fence();
          wgmma_tf32(acc, ahi[r], dhi + off, p + s > 0);
          if constexpr (G::kSplit) {
            wgmma_tf32(acc, ahi[r], dlo + off, 1);
            wgmma_tf32(acc, alo[r], dhi + off, 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // k-step s - 1 is done: its register set may be written
          fence_frag(ahi[r ^ 1]);
          if constexpr (G::kSplit) fence_frag(alo[r ^ 1]);
          if (s == 0 && p > 0) free_stage();  // the last stage's products are done
        }
        if (++stage == G::kStages) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      free_stage();
      fence_acc(acc);
      // o rows [tt * 64, + 64) x this consumer's kVW columns: through the
      // swizzled output tile and TMA stores (rows past C are not written)
      if (t == 0) tma_store_wait_read<0>();  // the last tile's store has read the buffer
      named_sync(bar, 128);
#pragma unroll
      for (int i = 0; i < kVW / 8; ++i) {
        put_pair(otile, warp * 16 + g, 8 * i + 2 * tg, acc[i][0], acc[i][1]);
        put_pair(otile, warp * 16 + g + 8, 8 * i + 2 * tg, acc[i][2], acc[i][3]);
      }
      fence_async_shared();
      named_sync(bar, 128);
      if (t == 0) {
#pragma unroll
        for (int pp = 0; pp < kVW / G::kOutPanel; ++pp)
          tma_store_4d_part(&map_o, reinterpret_cast<unsigned char*>(otile) + pp * kReadTok * 128,
                            col + pp * G::kOutPanel, tt * kReadTok, bn, 0);
        tma_store_commit();
      }
    }
  }
  if (t == 0) tma_store_wait_all();
}

template <typename T, int kNH, int kWT, int kCL>
int launch_mix(const void* m, const void* s, void* out, int B, int N, long long R,
               cudaStream_t stream) {
  typedef MixGeom<T, kWT> G;
  constexpr int is_bf16 = sizeof(T) == 2;
  const int kp = (N + 31) / 32 * 32;  // M's columns in whole panels
  const int fixed = mix_fixed_smem((int)sizeof(T), kNH, kp);
  int stages = (kSmemLimit - fixed) / (G::kStageBytes + 16);
  if (stages > kMixMaxStages) stages = kMixMaxStages;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = fixed + stages * (G::kStageBytes + 16);
  auto kern = mix_dense_kernel<T, kNH, kWT, kCL>;
  int clusters = 0;
  int err = hopper_host::resident_clusters((const void*)kern, kMixThreads, smem, kCL,
                                           &clusters);
  if (err) return err;
  CUtensorMap map_s, map_out;
  err = hopper_host::make_rows_map(&map_s, s, is_bf16, B, N, R, kMixK);
  if (!err) err = hopper_host::make_rows_map(&map_out, out, is_bf16, B, N, R, kNH);
  if (err) return err;
  const int col_items = (int)((R + G::kCols - 1) / G::kCols), items = B * col_items;
  if (clusters > items) clusters = items;
  cudaLaunchAttribute dims;
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = kCL;
  dims.val.clusterDim.y = dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCL * clusters);
  cfg.blockDim = dim3(kMixThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, map_s, map_out, (const float*)m, N, kp,
                                           R, col_items, items, stages);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Up to N = 160 clusters of two blocks, each ceil(N / 2) rows of M rounded
// up to a multiple of 16 (products of N = 80 at N = 150: per product a
// wgmma of N = 40 took about as long as one of 80); up to N = 224 clusters
// of four, ceil(N / 4) rows rounded up to 8. Items of 256 columns.
template <typename T>
int dispatch_mix(const void* m, const void* s, void* out, int B, int N, long long R,
                 cudaStream_t stream) {
  switch ((N + 31) / 32) {
    case 1: return launch_mix<T, 16, 2, 2>(m, s, out, B, N, R, stream);
    case 2: return launch_mix<T, 32, 2, 2>(m, s, out, B, N, R, stream);
    case 3: return launch_mix<T, 48, 2, 2>(m, s, out, B, N, R, stream);
    case 4: return launch_mix<T, 64, 2, 2>(m, s, out, B, N, R, stream);
    case 5: return launch_mix<T, 80, 2, 2>(m, s, out, B, N, R, stream);
    case 6: return launch_mix<T, 48, 2, 4>(m, s, out, B, N, R, stream);
    default: return launch_mix<T, 56, 2, 4>(m, s, out, B, N, R, stream);
  }
}

template <typename T, int kDk, int kVW>
int launch_readout(const void* q, const void* mixed, void* o, int bn, int C, int H, int Dv,
                   cudaStream_t stream) {
  typedef ReadGeom<T, kDk, kVW> G;
  constexpr int is_bf16 = sizeof(T) == 2;
  auto kern = readout_kernel<T, kDk, kVW>;
  int blocks = 0;
  int err = hopper_host::resident_blocks((const void*)kern, kReadThreads, G::kSmem, &blocks);
  if (err) return err;
  CUtensorMap map_q, map_o;
  err = hopper_host::make_rows_map(&map_q, q, is_bf16, bn, C, (long long)H * kDk, kReadTok);
  if (!err)
    err = hopper_host::make_rows_map(&map_o, o, is_bf16, bn, C, (long long)H * Dv, kReadTok);
  if (err) return err;
  const int items = bn * H * (Dv / G::kCols);
  const int grid = blocks < items ? blocks : items;
  kern<<<grid, kReadThreads, G::kSmem, stream>>>(map_q, map_o, (const T*)mixed, C, H, Dv, items);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns the launch's cudaError_t.
// ``is_bf16`` selects the element type of the tensors (else float32).
extern "C" {

int mhla_mix_states_dense(const void* m, const void* s, void* out, int B, int N,
                          long long R, int is_bf16, void* stream) {
  if (N < 1 || N > kMaxMixBlocks || R < 1 || R % 32) return (int)cudaErrorInvalidValue;
  return is_bf16 ? dispatch_mix<bf16>(m, s, out, B, N, R, (cudaStream_t)stream)
                 : dispatch_mix<float>(m, s, out, B, N, R, (cudaStream_t)stream);
}

int mhla_block_readout(const void* q, const void* mixed, void* o, int bn, int C,
                       int H, int Dk, int Dv, int is_bf16, void* stream) {
  if ((Dk != 128 && Dk != 256) || Dv < 128 || Dv % 128 || bn < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return Dk == 128 ? launch_readout<bf16, 128, 64>(q, mixed, o, bn, C, H, Dv, st)
                     : launch_readout<bf16, 256, 64>(q, mixed, o, bn, C, H, Dv, st);
  return Dk == 128 ? launch_readout<float, 128, 64>(q, mixed, o, bn, C, H, Dv, st)
                   : launch_readout<float, 256, 32>(q, mixed, o, bn, C, H, Dv, st);
}

}  // extern "C"
