// Forward kernels of the causal chunked MHLA op for Hopper (sm_90a):
//
//   K2 chunk_states   S_j = k_j^T v_j                         per chunk, per head
//   K3 mix_states     mixed_i = sum_{j<i} Ms[i, j] S_j        strictly-lower mixing
//   K4 chunk_output   o_i = q_i @ mixed_i + md_i * (bf16(tril(q_i k_i^T)) @ v_i)
//
// K2 and K4 are here; K3 is csrc/mhla_mix_wide.cu's at every N.
//
// Ms is the scaled strict lower triangle of the mixing matrix and md its
// scaled diagonal (the q scale Dk^-0.5 is folded into both by the caller,
// exactly once). All products accumulate in float32; the states, the mixed
// states, the masked scores and the output are rounded to bf16, the rounding
// points of the JAX op (mhla_tpu/ops/mhla_chunk.py:222-247).
//
// Layout: token tensors are head-flat [B, N, C, H*D] (the padded [B, T, H*D]
// rows, chunked by a free reshape); states and mixed are [B, N, H*Dk, Dv].
// md is shared by the batch, or one per batch row for packed varlen rows:
// K4 reads it with a batch stride (0 when shared), as the JAX kernels give
// their M blocks a batch index (mhla_chunk_pallas.py:726).
//
// What each kernel replaces, what bounds it on the H100 and what the design
// does about it:
//
// K2 replaces _phase_a_kernel (mhla_tpu/kernels/mhla_chunk_pallas.py:101).
//   Bound: bytes. At the 340M serving shape (B=4, T=2048, H=4, Dk=128,
//   Dv=256) it reads 25 MB of k/v and writes 34 MB of states for 2.1 GFLOP,
//   about 36 FLOP/byte, far below the card's ~295 FLOP/byte ridge: 17.5 us
//   at 3.35 TB/s.
//   Design (hopper.cuh, the mirror of K2b): a persistent grid, one block of
//   two consumer warpgroups and a producer warp on each SM, walks the items
//   (chunk, head, 128 rows of Dk, 128 columns of Dv) in a fixed order; the
//   Dv panels spread a small grid (one 781-token row: 52 chunk-heads, 104
//   items) over the SMs. The producer loads each 64-row slab of the chunk
//   (k's [64, 128] and v's [64, 128], every box 64 x 64 in the 128-byte
//   swizzle) by TMA into a ring of five 32 KB stages, so the next items'
//   tiles land while this one is stored. Consumer warpgroup w forms rows
//   64 w .. 64 w + 63 of the item's [128, 128] state with wgmma m64n128k16,
//   A = k^T and B = v both read MN-major from the tiles (the chunk's rows
//   are the K index), summed over the slabs in registers, then rounds it to
//   bf16 into a swizzled staging panel and writes it by one TMA store (two
//   panels a warpgroup, alternating, so the store of one item overlaps the
//   next item's products). Any C % 16: the k and v maps end at the chunk, so
//   TMA fills a slab's rows past it with zeros, which add nothing. Any Dk %
//   16: the k map ends at Dk, so a group's columns past it are zeros, a
//   box wholly past it is not loaded, and the state map ends at Dk, so rows
//   past it are not stored (a warpgroup whose 64 rows lie wholly past Dk
//   idles). No atomics: the same bits from run to run.
//
// K4 replaces _st_fwd_kernel (mhla_chunk_pallas.py:589). The TPU kernel
//   groups 4 chunks into a 256-row supertile to fill its 128x128 MXU; here
//   an item is one chunk (at most 64 rows: one wgmma M) of one head.
//   Bound: bytes. At the 340M serving shape (B=4, T=2048, H=4, Dk=128,
//   Dv=256) it reads q/k/v (34 MB) and mixed (34 MB) and writes o (17 MB)
//   for 3.7 GFLOP: 25 us at 3.35 TB/s.
//   Design (hopper.cuh, in the manner of K2 and flash_fwd.cu's fwd_block):
//   a persistent grid of one block an SM; the block is two workers, each a
//   consumer warpgroup fed by its own producer thread (warps 0 and 1 of the
//   producer warpgroup, setmaxnreg 24 / 240) through its own ring of four
//   24 KB stages of [64][64] boxes in the 128-byte swizzle. A worker walks
//   its items (chunk, head) in a fixed order: the producer loads q and k by
//   64-column panels of Dk, then for each 128-column panel of Dv the v panel
//   and, by 64-row panels of Dk, q again (from L2) with the mixed panel.
//   The consumer forms S = q k^T with wgmma m64n64 (both K-major), masks
//   tril and rounds S to bf16 in registers as the A fragments of P v (the
//   way fwd_block forms P); per Dv panel acc = P v by wgmma_rs (v MN-major),
//   acc *= md, acc += q mixed by wgmma (mixed MN-major: its rows are the K
//   index Dk), then rounds acc to bf16 into a swizzled staging panel and
//   writes o by TMA. P stays in registers across the Dv panels. Any C % 16
//   up to 64: the token maps end at the chunk, so TMA fills rows past it with
//   zeros and the store does not write them. Any Dk % 16, 384 included: the
//   q, k and mixed maps end at Dk (zeros past it) and Dk is walked in
//   panels. No atomics: the same bits from run to run.

#include "hopper.cuh"

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

// K2's geometry: items of 128 rows of Dk by 128 columns of Dv, chunks in
// slabs of 64 rows, a ring of stages of one slab's k and v boxes.
constexpr int kStatesThreads = 288;  // two consumer warpgroups and a producer warp
constexpr int kBoxBytes = 64 * 64 * 2;  // one [64][64] bf16 box
constexpr int kStatesStageBytes = 4 * kBoxBytes;  // k [64][128] and v [64][128]
constexpr int kStatesStages = 5;
constexpr int kStatesOutBytes = 2 * kBoxBytes;  // a warpgroup's [64][128] staging panels
constexpr int kStatesSmem =
    kStatesStages * kStatesStageBytes + 4 * kStatesOutBytes + 1024 + 256;

// K2. Persistent grid of at most one block per SM, kStatesThreads threads,
// dynamic shared memory kStatesSmem. Item i = ((bn * H + h) * groups + g) *
// panels + p: rows [128 g, 128 g + 128) of Dk and columns [128 p, 128 p +
// 128) of Dv of chunk bn (of the B*N) and head h. Maps: k and v as [bn, C,
// H, D] (boxes of 64 columns x 64 rows), the states as [bn * H, Dk, 1, Dv]
// (boxes of 64 x 64).
__global__ void __launch_bounds__(kStatesThreads, 1)
chunk_states_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_s, int C, int H, int Dk, int groups,
                    int panels, int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;                                  // [stages][k 2 boxes, v 2 boxes]
  unsigned char* out = ring + kStatesStages * kStatesStageBytes;  // [2 warpgroups][2][2 boxes]
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 4 * kStatesOutBytes);
  uint64_t* empty = full + kStatesStages;
  const int slabs = (C + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStatesStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases a stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int p = item % panels, g = item / panels % groups, bnh = item / panels / groups;
        const int h = bnh % H, bn = bnh / H, k0 = g * 128;
        const int kboxes = Dk - k0 > 64 ? 2 : 1;  // a box wholly past Dk is not loaded
        for (int sl = 0; sl < slabs; ++sl) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], (kboxes + 2) * kBoxBytes);
          unsigned char* st = ring + stage * kStatesStageBytes;
          for (int q = 0; q < kboxes; ++q)
            tma_load_4d(st + q * kBoxBytes, &map_k, &full[stage], k0 + q * 64, h, sl * 64, bn);
          for (int q = 0; q < 2; ++q)
            tma_load_4d(st + (2 + q) * kBoxBytes, &map_v, &full[stage], p * 128 + q * 64, h,
                        sl * 64, bn);
          if (++stage == kStatesStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {  // two consumer warpgroups, 64 rows of Dk each
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    int stage = 0, stored = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int p = item % panels, g = item / panels % groups, bnh = item / panels / groups;
      const int row0 = g * 128 + wg * 64;  // this warpgroup's first row of Dk
      const bool active = row0 < Dk;
      float acc[16][4];
      for (int sl = 0; sl < slabs; ++sl) {
        mbar_wait(&full[stage], phase);
        if (active) {
          const unsigned char* st = ring + stage * kStatesStageBytes;
          // A = k^T: the K index (the chunk's rows) runs down the box, M along it
          const uint64_t da = desc_mnmajor<64>(st + wg * kBoxBytes);
          const uint64_t db = desc_mnmajor<64>(st + 2 * kBoxBytes);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_ss<1, 1>(acc, da + kstep_mnmajor(s), db + kstep_mnmajor(s), sl > 0 || s > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
        }
        mbar_arrive(&empty[stage]);
        if (++stage == kStatesStages) stage = 0, phase ^= 1;
      }
      if (!active) continue;
      // staging panels of the item two back: its store has read them
      unsigned char* buf = out + (wg * 2 + (stored++ & 1)) * kStatesOutBytes;
      if (t == 0) tma_store_wait_read<1>();
      named_sync(1 + wg, 128);
      acc_to_panels<128>(buf, acc);
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (t == 0) {
        tma_store_4d_part(&map_s, buf, p * 128, 0, row0, bnh);
        tma_store_4d_part(&map_s, buf + kBoxBytes, p * 128 + 64, 0, row0, bnh);
        tma_store_commit();
      }
    }
    if (t == 0) tma_store_wait_all();
  }
}

// K4's geometry: two workers a block, each a ring of stages of three
// [64][64] boxes (q and k panels; a v panel; a q panel and a mixed panel)
// and a [64][128] staging tile of o.
constexpr int kOutThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kOutStages = 4;
constexpr int kOutStageBytes = 3 * kBoxBytes;
constexpr int kOutWorkerBytes = kOutStages * kOutStageBytes + 2 * kBoxBytes;
constexpr int kOutSmem = 2 * kOutWorkerBytes + 1024 + 256;

// K4. Persistent grid of at most one block per SM, kOutThreads threads,
// dynamic shared memory kOutSmem. Worker w of block x takes the items
// 2 x + w, 2 x + w + 2 G, ... (G blocks): item (bn * H + h) is chunk bn (of
// the B*N) of head h. Maps: q, k as [bn, C, H, Dk], v and o as [bn, C, H,
// Dv] (boxes of 64 columns x 64 rows), mixed as [bn * H, Dk, 1, Dv] (boxes
// of 64 x 64). md: [N], or [B, N] with md_bstride = N (0 when shared).
__global__ void __launch_bounds__(kOutThreads, 1)
chunk_output_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_m,
                    const __grid_constant__ CUtensorMap map_o, const float* __restrict__ md,
                    int N, int H, int Dk, int Dv, int md_bstride, int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * kOutWorkerBytes);  // [w][full, empty]
  const int kpanels = (Dk + 63) / 64, vpanels = Dv / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * kOutStages; ++s) {
      mbar_init(&bars[(s / kOutStages) * 2 * kOutStages + s % kOutStages], 1);
      mbar_init(&bars[(s / kOutStages) * 2 * kOutStages + kOutStages + s % kOutStages], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: lane 0 of warp w feeds worker w
    regs_dec<24>();
    const int w = threadIdx.x / 32;
    if (w < 2 && threadIdx.x % 32 == 0) {
      unsigned char* ring = smem + w * kOutWorkerBytes;
      uint64_t* full = bars + w * 2 * kOutStages;
      uint64_t* empty = full + kOutStages;
      int stage = 0;
      uint32_t phase = 0;
      // the next stage, once its consumer has released it, expecting ``boxes`` boxes
      auto acquire = [&](int boxes) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], boxes * kBoxBytes);
        return ring + stage * kOutStageBytes;
      };
      auto advance = [&] {
        if (++stage == kOutStages) stage = 0, phase ^= 1;
      };
      for (int item = 2 * blockIdx.x + w; item < items; item += 2 * gridDim.x) {
        const int h = item % H, bn = item / H;
        for (int j = 0; j < kpanels; ++j) {  // q and k, panel j of Dk
          unsigned char* st = acquire(2);
          tma_load_4d(st, &map_q, &full[stage], 64 * j, h, 0, bn);
          tma_load_4d(st + kBoxBytes, &map_k, &full[stage], 64 * j, h, 0, bn);
          advance();
        }
        for (int p = 0; p < vpanels; ++p) {
          unsigned char* st = acquire(2);  // v, columns [128 p, 128 p + 128)
          tma_load_4d(st, &map_v, &full[stage], 128 * p, h, 0, bn);
          tma_load_4d(st + kBoxBytes, &map_v, &full[stage], 128 * p + 64, h, 0, bn);
          advance();
          for (int j = 0; j < kpanels; ++j) {  // q panel j, mixed rows [64 j, 64 j + 64)
            st = acquire(3);
            tma_load_4d(st, &map_q, &full[stage], 64 * j, h, 0, bn);
            tma_load_4d(st + kBoxBytes, &map_m, &full[stage], 128 * p, 0, 64 * j, item);
            tma_load_4d(st + 2 * kBoxBytes, &map_m, &full[stage], 128 * p + 64, 0, 64 * j, item);
            advance();
          }
        }
      }
    }
  } else {  // the two consumer warpgroups, one a worker
    regs_inc<240>();
    const int w = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int g = (t & 31) >> 2, tg = t & 3;
    const int r0 = (t >> 5) * 16 + g, r1 = r0 + 8;  // this thread's rows of the chunk
    const unsigned char* ring = smem + w * kOutWorkerBytes;
    unsigned char* out = smem + w * kOutWorkerBytes + kOutStages * kOutStageBytes;
    uint64_t* full = bars + w * 2 * kOutStages;
    uint64_t* empty = full + kOutStages;
    int stage = 0;
    uint32_t phase = 0;
    auto release = [&] {
      mbar_arrive(&empty[stage]);
      if (++stage == kOutStages) stage = 0, phase ^= 1;
    };
    for (int item = 2 * blockIdx.x + w; item < items; item += 2 * gridDim.x) {
      const int h = item % H, bn = item / H;
      const float mdn = md[(bn / N) * md_bstride + bn % N];
      // S = q k^T over the panels of Dk
      float sacc[8][4];
      for (int j = 0; j < kpanels; ++j) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * kOutStageBytes;
        const uint64_t dq = desc_kmajor(st, 0), dk = desc_kmajor(st + kBoxBytes, 0);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_ss(sacc, dq + kstep_kmajor<64>(s), dk + kstep_kmajor<64>(s), j > 0 || s > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sacc);
        release();
      }
      // P = bf16(tril S) as the A fragments of P v (key k-step s: columns 16 s ..)
      uint32_t pa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = nt * 8 + tg * 2;
        pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(c <= r0 ? sacc[nt][0] : 0.f,
                                                 c + 1 <= r0 ? sacc[nt][1] : 0.f);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(c <= r1 ? sacc[nt][2] : 0.f,
                                                 c + 1 <= r1 ? sacc[nt][3] : 0.f);
      }
      for (int p = 0; p < vpanels; ++p) {
        float acc[16][4];
        mbar_wait(&full[stage], phase);
        const uint64_t dv = desc_mnmajor<64>(ring + stage * kOutStageBytes);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) wgmma_rs(acc, pa[s], dv + kstep_mnmajor(s), s > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        fence_frag(pa);
        release();
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] *= mdn;
        for (int j = 0; j < kpanels; ++j) {  // acc += q mixed, panel j of Dk
          mbar_wait(&full[stage], phase);
          const unsigned char* st = ring + stage * kOutStageBytes;
          const uint64_t dq = desc_kmajor(st, 0), dm = desc_mnmajor<64>(st + kBoxBytes);
          wgmma_fence();  // the scaled accumulator was written by ordinary code
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_ss<0, 1>(acc, dq + kstep_kmajor<64>(s), dm + kstep_mnmajor(s), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
          release();
        }
        // o's panel: bf16 into the staging tile (the last store has read it), one TMA store
        if (t == 0) tma_store_wait_read<0>();
        named_sync(1 + w, 128);
        acc_to_panels<128>(out, acc);
        fence_async_shared();
        named_sync(1 + w, 128);
        if (t == 0) {
          tma_store_4d_part(&map_o, out, 128 * p, h, 0, bn);
          tma_store_4d_part(&map_o, out + kBoxBytes, 128 * p + 64, h, 0, bn);
          tma_store_commit();
        }
      }
    }
    if (t == 0) tma_store_wait_all();
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns the launch's cudaError_t.
extern "C" {

// C % 16 == 0, Dk % 16 == 0 and Dv % 128 == 0, or cudaErrorInvalidValue;
// every pointer 16-byte aligned (TMA).
int mhla_chunk_states(const void* k, const void* v, void* s, int bn, int C, int H, int Dk,
                      int Dv, void* stream) {
  if (bn < 1 || H < 1 || C < 16 || C % 16 || Dk < 16 || Dk % 16 || Dv < 128 || Dv % 128)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv, ms;
  int err = hopper_host::make_tile_map(&mk, k, bn, C, H, Dk, 64);
  if (!err) err = hopper_host::make_tile_map(&mv, v, bn, C, H, Dv, 64);
  if (!err) err = hopper_host::make_tile_map(&ms, s, bn * H, Dk, 1, Dv, 64);
  if (err) return err;
  int fill = 0;  // one block an SM
  err = hopper_host::resident_blocks((const void*)chunk_states_kernel, kStatesThreads,
                                     kStatesSmem, &fill);
  if (err) return err;
  const int groups = (Dk + 127) / 128, panels = Dv / 128;
  const long long items = (long long)bn * H * groups * panels;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  chunk_states_kernel<<<items < fill ? (int)items : fill, kStatesThreads, kStatesSmem,
                        (cudaStream_t)stream>>>(mk, mv, ms, C, H, Dk, groups, panels,
                                                (int)items);
  return (int)cudaGetLastError();
}

// C % 16 == 0 with 16 <= C <= 64, Dk % 16 == 0 and Dv % 128 == 0, or
// cudaErrorInvalidValue; every pointer 16-byte aligned (TMA).
int mhla_chunk_output(const void* q, const void* k, const void* v, const void* mixed,
                      const void* md, void* o, int bn, int N, int C, int H, int Dk, int Dv,
                      int md_bstride, void* stream) {
  if (bn < 1 || N < 1 || H < 1 || C < 16 || C > 64 || C % 16 || Dk < 16 || Dk % 16 ||
      Dv < 128 || Dv % 128)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mm, mo;
  int err = hopper_host::make_tile_map(&mq, q, bn, C, H, Dk, 64);
  if (!err) err = hopper_host::make_tile_map(&mk, k, bn, C, H, Dk, 64);
  if (!err) err = hopper_host::make_tile_map(&mv, v, bn, C, H, Dv, 64);
  if (!err) err = hopper_host::make_tile_map(&mm, mixed, bn * H, Dk, 1, Dv, 64);
  if (!err) err = hopper_host::make_tile_map(&mo, o, bn, C, H, Dv, 64);
  if (err) return err;
  int fill = 0;  // one block an SM
  err = hopper_host::resident_blocks((const void*)chunk_output_kernel, kOutThreads, kOutSmem,
                                     &fill);
  if (err) return err;
  const long long items = (long long)bn * H;
  if (items > 0x7fffffff - 1) return (int)cudaErrorInvalidValue;
  const long long pairs = (items + 1) / 2;
  chunk_output_kernel<<<pairs < fill ? (int)pairs : fill, kOutThreads, kOutSmem,
                        (cudaStream_t)stream>>>(mq, mk, mv, mm, mo, (const float*)md, N, H, Dk,
                                                Dv, md_bstride, (int)items);
  return (int)cudaGetLastError();
}

}  // extern "C"
