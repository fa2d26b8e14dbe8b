// K7b: backward of the block readout of the non-causal blockwise MHLA island
// for Hopper (sm_90a). From q [B*N, C, H*Dk], mixed [B*N, H*Dk, Dv] and
// dO [B*N, C, H*Dv], per block i and head h:
//
//   dq[i, :, h]   = dO[i, :, h] @ mixed[i, h]^T      [C, Dk]
//   dmixed[i, h]  = q[i, :, h]^T @ dO[i, :, h]       [Dk, Dv]
//
// float32 (the default attention island) or bf16 elements; both accumulate
// in float32 and round once to the element type.
//
// Replaces _readout_bwd_kernel (mhla_tpu/kernels/mhla_block_pallas.py:116).
// The TPU kernel groups G blocks of rows into one supertile and masks rows
// and columns to feed its 128 x 128 matrix unit; none of that is carried
// over.
// Bound: bytes. q, dO and mixed read once, dq and dmixed written once: 816
// MB at batch 1 x 150 blocks x 210 tokens x 12 heads of Dk = Dv = 128 in
// float32, 0.244 ms at 3.35 TB/s; two products of 2 * C * Dk * Dv a block
// and head, three TF32 products each for float32 accuracy, 74 GFLOP there,
// 0.150 ms at 495 TFLOP/s (the bf16 form: half the bytes, one product
// each). (Outside the tensor cores the float32 products are 24.8 GFLOP at
// 67 TFLOP/s, 0.370 ms: the earlier FMA kernel's bound.)
// Design: both products on TF32 wgmma with K6's hi / lo split (hi * hi' +
// hi * lo' + lo * hi'; the bf16 form one product, its values exact in
// TF32). A persistent grid of blocks of a producer warpgroup and two
// consumer warpgroups walks items of (block, head, 64-row tile of Dk); the
// producer streams stages of 64 token rows (dO [64][128] and q's [64][64]
// slice, zero past C through tensor maps with C as a dimension of their
// own), and each stage feeds both products, so q and dO are read once an
// item (dO once per 64 rows of Dk, the second time mostly from L2).
// TF32 wgmma reads both operands K-major:
// - dq [c][k] = sum_v dO[c][v] mixed[k][v] (K = Dv) on the first consumer:
//   dO rows are the A operand, loaded from the stage and split in
//   registers; mixed's rows are K-major as stored, so the item's [64][128]
//   tile is the B operand, split into hi and lo in shared memory once an
//   item from registers loaded during the previous item. dq leaves each
//   token tile as float2 (bf16 pairs) straight from the accumulator, 32
//   whole bytes of a row a quarter warp, rows past C not written.
// - dmixed^T [v][k] = sum_c dO[c][v] q[c][k] (K = tokens) on the second:
//   dO^T is gathered from the stage into A fragments (split in registers),
//   and q^T [64 k][64 c], the B operand, is written transposed and split
//   each stage. The two 64-row halves of dmixed^T stay in accumulators
//   over the item's token tiles and leave, transposed, at its end; rows past
//   C are zeros in both q and dO and add nothing.
// A stage is freed once the products that its fragments fed are done in
// both consumers. Shared memory (float32): mixed hi +
// lo 64 KB, q^T hi + lo 32 KB, two stages of 48 KB: 197,664 bytes (a third
// stage would need 246,832). Sums in a fixed order, no atomics: the same bits every run.

#include "hopper.cuh"
#include "mhla_block_common.cuh"

using namespace hopper;
using namespace mhla_block;

namespace {

constexpr int kThreads = 128 * 3;  // a producer and two consumer warpgroups
constexpr int kTok = 64;           // token rows of a stage
constexpr int kDv = 128;
constexpr int kKT = 64;            // rows of Dk an item
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

template <typename T>
struct Geom {
  static constexpr int kEs = (int)sizeof(T);
  static constexpr bool kSplit = sizeof(T) == 4;   // three products, else one
  static constexpr int kPanelW = 128 / kEs;        // columns of a 128-byte panel
  static constexpr int kDoBytes = kTok * kDv * kEs;
  static constexpr int kStageBytes = kDoBytes + kTok * kKT * kEs;
  static constexpr int kMBytes = kKT * kDv * 4;    // mixed [64 k][128 v], hi or lo
  static constexpr int kQtBytes = kKT * kTok * 4;  // q^T [64 k][64 c], hi or lo
  static constexpr int kFixed = (kSplit ? 2 : 1) * (kMBytes + kQtBytes) + 1024;
  static constexpr int kFree = (kSmemLimit - kFixed) / (kStageBytes + 16);
  static constexpr int kStages = kFree < kMaxStages ? kFree : kMaxStages;
  static constexpr int kSmem = kFixed + kStages * (kStageBytes + 16);
  static_assert(kStages >= 2, "K7b's stages");
};

// Element (r, c) of a [kTok][W] tile of T in 128-byte panels of kTok rows
// (as TMA loads it, 128-byte swizzle).
__device__ __forceinline__ float tile_at(const float* p, int r, int c) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const unsigned char*>(p) +
                                         (c >> 5) * kTok * 128 + swizzle128_f32(r, c & 31));
}
__device__ __forceinline__ float tile_at(const bf16* p, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      reinterpret_cast<const unsigned char*>(p) + (c >> 6) * kTok * 128 + swizzle128(r, c & 63)));
}
// Elements (r, c .. c + 3) of such a tile (c a multiple of 4).
__device__ __forceinline__ float4 tile_at4(const float* p, int r, int c) {
  return *reinterpret_cast<const float4*>(reinterpret_cast<const unsigned char*>(p) +
                                          (c >> 5) * kTok * 128 + swizzle128_f32(r, c & 31));
}
__device__ __forceinline__ float4 tile_at4(const bf16* p, int r, int c) {
  return raw_to_float4(*reinterpret_cast<const uint2*>(
      reinterpret_cast<const unsigned char*>(p) + (c >> 6) * kTok * 128 + swizzle128(r, c & 63)));
}

__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// Write x = hi + lo (hi alone where !kSplit) at byte ``off`` of a hi and a lo tile.
template <bool kSplit>
__device__ __forceinline__ void put_split(unsigned char* hi_tile, unsigned char* lo_tile, int off,
                                          float x) {
  if constexpr (kSplit) {
    uint32_t hi, lo;
    split_tf32(x, hi, lo);
    *reinterpret_cast<uint32_t*>(hi_tile + off) = hi;
    *reinterpret_cast<uint32_t*>(lo_tile + off) = lo;
  } else {
    *reinterpret_cast<float*>(hi_tile + off) = x;
  }
}

// K7b. A persistent grid of blocks of kThreads threads, dynamic shared memory
// Geom::kSmem. map_q, map_do: make_rows_map maps of q [B*N, C, H*Dk] and dO
// [B*N, C, H*kDv] with boxes of kTok rows. Items: (block * H + head) *
// (Dk / kKT) + Dk tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
readout_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_do, const T* __restrict__ mixed,
                   T* __restrict__ dq, T* __restrict__ dmixed, int C, int H, int Dk, int items) {
  typedef Geom<T> G;
  constexpr bool kSplit = G::kSplit;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* m_hi = smem;
  unsigned char* m_lo = m_hi + G::kMBytes;                   // float32 form only
  unsigned char* qt_hi = smem + (kSplit ? 2 : 1) * G::kMBytes;
  unsigned char* qt_lo = qt_hi + G::kQtBytes;  // float32 form only
  unsigned char* ring = qt_hi + (kSplit ? 2 : 1) * G::kQtBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::kStages * G::kStageBytes);
  uint64_t* empty = full + G::kStages;
  const int tiles = (C + kTok - 1) / kTok, kts = Dk / kKT;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // both consumers
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer: one thread keeps the stages in flight
    regs_dec<40>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int bh = item / kts, bn = bh / H, h = bh % H, k0 = h * Dk + (item % kts) * kKT;
        for (int tt = 0; tt < tiles; ++tt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], G::kStageBytes);
          unsigned char* dst = ring + stage * G::kStageBytes;
#pragma unroll
          for (int p = 0; p < kDv / G::kPanelW; ++p)
            tma_load_4d(dst + p * kTok * 128, &map_do, &full[stage], h * kDv + p * G::kPanelW,
                        tt * kTok, bn, 0);
#pragma unroll
          for (int p = 0; p < kKT / G::kPanelW; ++p)
            tma_load_4d(dst + G::kDoBytes + p * kTok * 128, &map_q, &full[stage],
                        k0 + p * G::kPanelW, tt * kTok, bn, 0);
          if (++stage == G::kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  regs_inc<232>();
  const int wg = tid / 128 - 1, t = tid % 128;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
  const int64_t ldq = (int64_t)H * Dk;
  int stage = 0;
  uint32_t phase = 0;
  // This consumer is done with the stage: called after the wgmma_wait that
  // completed the products its fragments fed (as K7 frees its stages).
  auto release = [&](int bar) {
    named_sync(bar, 128);
    if (t == 0) mbar_arrive(&empty[stage]);
    if (++stage == G::kStages) stage = 0, phase ^= 1;
  };

  if (wg == 0) {  // dq, and the item's mixed tile
    constexpr int kLoads = kKT * kDv / (4 * 128);
    // an item's mixed tile [64 k][128 v], loaded into registers an item
    // ahead: load j of thread t is row (t + 128 j) / 32, columns 4 ((t + 128
    // j) % 32) .. + 3, so a warp reads one whole row
    typename Raw4<T>::type pre[kLoads];
    auto prefetch = [&](int item) {
      const T* src = mixed + ((int64_t)(item / kts) * Dk + (item % kts) * kKT) * kDv;
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int e = t + 128 * j;
        pre[j] = *reinterpret_cast<const typename Raw4<T>::type*>(src + (e >> 5) * kDv +
                                                                  4 * (e & 31));
      }
    };
    const uint64_t dhi = desc_kmajor(m_hi, 0), dlo = desc_kmajor(m_lo, 0);
    float acc[8][4];  // dq [64 c][64 k]
    if (blockIdx.x < items) prefetch(blockIdx.x);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int bh = item / kts, bn = bh / H, h = bh % H;
      // mixed, K-major as stored, split into 128-byte panels of 32 v
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int e = t + 128 * j, k = e >> 5, v = 4 * (e & 31);
        const float4 x = raw_to_float4(pre[j]);
        const int off = (v >> 5) * kKT * 128 + swizzle128_f32(k, v & 31);
        put_split<kSplit>(m_hi, m_lo, off, x.x);
        put_split<kSplit>(m_hi, m_lo, off + 4, x.y);
        put_split<kSplit>(m_hi, m_lo, off + 8, x.z);
        put_split<kSplit>(m_hi, m_lo, off + 12, x.w);
      }
      fence_async_shared();
      named_sync(2, 128);
      if (item + (int)gridDim.x < items) prefetch(item + gridDim.x);
      T* dq_item = dq + (int64_t)bn * C * ldq + h * Dk + (item % kts) * kKT;
      for (int tt = 0; tt < tiles; ++tt) {
        mbar_wait(&full[stage], phase);
        const T* st = reinterpret_cast<const T*>(ring + stage * G::kStageBytes);
        // 16 k-steps of 8 v, A = dO rows [64 c][128 v] split in registers, in
        // two register sets in turn
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          const int r = s & 1;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = tile_at(st, warp * 16 + g + 8 * (e & 1), 8 * s + tg + 4 * (e >> 1));
            if constexpr (kSplit) split_tf32(x, ahi[r][e], alo[r][e]);
            else ahi[r][e] = __float_as_uint(x);
          }
          const uint64_t off = kstep_kmajor<kKT>(s);
          wgmma_fence();
          wgmma_tf32(acc, ahi[r], dhi + off, s > 0);
          if constexpr (kSplit) {
            wgmma_tf32(acc, ahi[r], dlo + off, 1);
            wgmma_tf32(acc, alo[r], dhi + off, 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // k-step s - 1 is done: its register set may be written
          fence_frag(ahi[r ^ 1]);
          if constexpr (kSplit) fence_frag(alo[r ^ 1]);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        release(2);
        const int r0 = tt * kTok + warp * 16 + g;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (r0 < C)
            store_pair(dq_item + (int64_t)r0 * ldq + 8 * i + 2 * tg, acc[i][0], acc[i][1]);
          if (r0 + 8 < C)
            store_pair(dq_item + (int64_t)(r0 + 8) * ldq + 8 * i + 2 * tg, acc[i][2], acc[i][3]);
        }
      }
      named_sync(2, 128);  // every warp's products of this item are done before mixed is rewritten
    }
  } else {  // dmixed^T [128 v][64 k], two 64-row halves
    float acc[2][8][4];
    const uint64_t dhi = desc_kmajor(qt_hi, 0), dlo = desc_kmajor(qt_lo, 0);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int bh = item / kts;
      for (int tt = 0; tt < tiles; ++tt) {
        mbar_wait(&full[stage], phase);
        const T* st = reinterpret_cast<const T*>(ring + stage * G::kStageBytes);
        const T* sq = reinterpret_cast<const T*>(ring + stage * G::kStageBytes + G::kDoBytes);
        // q^T [64 k][64 c], K-major (c along a row), split (the last tile's
        // products are done):
        // lane l reads row c = 32 (i % 2) + l of q, columns 4 (i / 2) .. + 3,
        // and writes one bank of each of four rows of q^T
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = warp + 4 * j, c = 32 * (i & 1) + lane, k = 4 * (i >> 1);
          const float4 x = tile_at4(sq, c, k);
          const int off = (c >> 5) * kKT * 128;
          put_split<kSplit>(qt_hi, qt_lo, off + swizzle128_f32(k, c & 31), x.x);
          put_split<kSplit>(qt_hi, qt_lo, off + swizzle128_f32(k + 1, c & 31), x.y);
          put_split<kSplit>(qt_hi, qt_lo, off + swizzle128_f32(k + 2, c & 31), x.z);
          put_split<kSplit>(qt_hi, qt_lo, off + swizzle128_f32(k + 3, c & 31), x.w);
        }
        fence_async_shared();  // q^T is read by the products (async proxy)
        named_sync(3, 128);
        // 8 k-steps of 8 tokens, A = dO^T [128 v][64 c] gathered from the
        // stage for each half and split in registers, in two register sets
        // in turn ([register set][half])
        uint32_t ahi[2][2][4], alo[2][2][4];
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int r = s & 1;
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x =
                  tile_at(st, 8 * s + tg + 4 * (e >> 1), 64 * m + warp * 16 + g + 8 * (e & 1));
              if constexpr (kSplit) split_tf32(x, ahi[r][m][e], alo[r][m][e]);
              else ahi[r][m][e] = __float_as_uint(x);
            }
          const uint64_t off = kstep_kmajor<kKT>(s);
          wgmma_fence();
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            wgmma_tf32(acc[m], ahi[r][m], dhi + off, tt > 0 || s > 0);
            if constexpr (kSplit) {
              wgmma_tf32(acc[m], ahi[r][m], dlo + off, 1);
              wgmma_tf32(acc[m], alo[r][m], dhi + off, 1);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // k-step s - 1 is done: its register set may be written
          fence_frag(ahi[r ^ 1]);
          if constexpr (kSplit) fence_frag(alo[r ^ 1]);
        }
        // every warp's products of this tile are done before the stage is
        // freed and before any warp writes q^T again
        wgmma_wait<0>();
        release(3);
      }
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      // dmixed [k][v] = acc^T: a quarter warp writes 8 neighbouring v of one row k
      T* dm_item = dmixed + ((int64_t)bh * Dk + (item % kts) * kKT) * kDv;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            store_one(dm_item + (int64_t)(8 * i + 2 * tg + (e & 1)) * kDv + 64 * m + warp * 16 + g +
                          8 * (e >> 1),
                      acc[m][i][e]);
    }
  }
}

template <typename T>
int launch_readout_bwd(const void* q, const void* mixed, const void* dout, void* dq,
                       void* dmixed, int bn, int C, int H, int Dk, cudaStream_t stream) {
  typedef Geom<T> G;
  constexpr int is_bf16 = sizeof(T) == 2;
  auto kern = readout_bwd_kernel<T>;
  int blocks = 0;
  int err = hopper_host::resident_blocks((const void*)kern, kThreads, G::kSmem, &blocks);
  if (err) return err;
  CUtensorMap map_q, map_do;
  err = hopper_host::make_rows_map(&map_q, q, is_bf16, bn, C, (long long)H * Dk, kTok);
  if (!err)
    err = hopper_host::make_rows_map(&map_do, dout, is_bf16, bn, C, (long long)H * kDv, kTok);
  if (err) return err;
  const int items = bn * H * (Dk / kKT);
  const int grid = blocks < items ? blocks : items;
  kern<<<grid, kThreads, G::kSmem, stream>>>(map_q, map_do, (const T*)mixed, (T*)dq, (T*)dmixed,
                                             C, H, Dk, items);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches on the given stream,
// does not synchronise, returns the launch's cudaError_t. ``is_bf16`` selects
// the element type of the tensors (else float32).
extern "C" int mhla_block_readout_bwd(const void* q, const void* mixed, const void* dout,
                                      void* dq, void* dmixed, int bn, int C, int H, int Dk,
                                      int Dv, int is_bf16, void* stream) {
  if (Dk < kKT || Dk % kKT || Dv != kDv || bn < 1 || C < 1) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_readout_bwd<bf16>(q, mixed, dout, dq, dmixed, bn, C, H, Dk,
                                            (cudaStream_t)stream)
                 : launch_readout_bwd<float>(q, mixed, dout, dq, dmixed, bn, C, H, Dk,
                                             (cudaStream_t)stream);
}
