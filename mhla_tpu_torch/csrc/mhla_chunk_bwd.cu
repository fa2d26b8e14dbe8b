// Backward kernels of the causal chunked MHLA op for Hopper (sm_90a), the
// gradient of csrc/mhla_chunk.cu's K2 -> K3 -> K4:
//
//   K4b chunk_output_bwd   per chunk and head, recomputing A = q k^T:
//                            P  = bf16(tril A),  dP = tril(dO v^T)
//                            dA = bf16(md * dP)
//                            dv_intra = md * P^T dO
//                            dq       = dA k + dO mixed^T
//                            dk_intra = dA^T q
//                            dmixed   = q^T dO                  [Dk, Dv]
//                            d md partial = sum(dP * A)         one per item
//   K2b chunk_states_bwd   dk = v dS^T + dk_intra,  dv = k dS + dv_intra
//
// K3b between them, dS_j = sum_{i>j} Ms[i, j] dmixed_i and dMs[i, j] =
// <dmixed_i, S_j>, is csrc/mhla_mix_wide.cu's at every N.
//
// All products accumulate in float32 from bf16 operands; dA, dq, dk, dv,
// dmixed and the intra terms are rounded to bf16, the rounding points of the
// JAX backward (mhla_tpu/kernels/mhla_chunk_pallas.py:623-707, 184-207). d md
// stays float32.
//
// Layout as in csrc/mhla_chunk.cu: token tensors [B, N, C, H*D], states,
// mixed and their gradients [B, N, H*Dk, Dv]. md is shared by the batch or
// one per batch row (packed varlen rows); K4b writes one float32 partial of
// d md per (chunk, head), which the caller sums over heads (and, for a
// shared md, over the batch) in a fixed order: d md is [N] or [B, N], as the
// JAX kernels give it a batch index (mhla_chunk_pallas.py:726).
//
// What each kernel replaces, what bounds it on the H100 and what the design
// does about it:
//
// K4b replaces _st_bwd_kernel (mhla_chunk_pallas.py:623). The TPU kernel
//   works on 256-row supertiles with near-block weights; the port's forward
//   mixes every earlier chunk in K3, so here only the chunk's own diagonal
//   term is differentiated and there is no dmb fold.
//   Bound: bytes. At the 340M training shape (B=8, T=2048, H=4, Dk=128,
//   Dv=256) it reads q/k/v/dO (101 MB) and mixed (67 MB) and writes dq,
//   dk_intra, dv_intra (67 MB) and dmixed (67 MB) for 16 GFLOP, ~53
//   FLOP/byte: 90 us at 3.35 TB/s.
//   Design (hopper.cuh, in the manner of K2b and flash_bwd.cu): a persistent
//   grid of one block an SM walks the items (chunk, head) in a fixed order;
//   an item sees all of Dv, since dq, dk_intra and d md sum over it. One
//   producer thread loads the item's q and k [64, Dk] by TMA into one of two
//   buffers (one at Dk above 128), then for each 64-column panel of Dv the v
//   and dO panels and the mixed panel [Dk, 64] into a ring of stages, all in
//   the 128-byte swizzle. Two consumer warpgroups share the item
//   (setmaxnreg 24 / 240):
//   - warpgroup 1 forms A = q k^T (wgmma m64n64, K-major), keeps tril A in
//     float32 registers and writes P = bf16(tril A) into a swizzled tile;
//     per Dv panel it adds dO v^T into dP (K-major) and forms dv_intra = md
//     P^T dO (A = P^T, B = dO, both MN-major), stored by TMA; then it masks
//     dP, sums its float32 partial of sum(dP * A) in a fixed order (the
//     thread's fragment, the warp by shuffles, the four warps in order),
//     writes dA = bf16(md dP) as a swizzled tile, hands it to warpgroup 2
//     under a named barrier, and forms dk_intra = dA^T q (both MN-major);
//   - warpgroup 2 adds dO mixed^T into dq over the Dv panels (both K-major,
//     N = Dk), forms dmixed = q^T dO per 64 rows of Dk and panel of Dv
//     (both MN-major), stored by TMA, then adds dA k (k MN-major) into dq
//     once warpgroup 1 has written dA.
//   At kDk = 256 ptxas spills 1.4 KB a thread and serializes the wgmmas
//   (C7512): it holds these 384-thread kernels to 168 registers a thread (with
//   dmixed formed in warpgroup 1 it spills as much). No configuration reaches it.
//   Every output leaves through swizzled staging tiles and TMA stores. d md
//   has no atomics: the partials are one per item, and the caller sums
//   them; all five outputs are the same bits from run to run. Any C % 16 up
//   to 64: the token maps end at the chunk, so TMA fills rows past it with
//   zeros and the stores do not write them. Key head dims of any multiple
//   of 16 up to 256 run on the tile width kDk = 64, 128 or 256 just above:
//   the maps end at Dk, so q's and k's columns and mixed's rows past it are
//   zeros, and no column past it is stored.
//
// K2b replaces _phase_a_bwd_acc_kernel (mhla_chunk_pallas.py:184) and
//   _phase_a_bwd_kernel (:142), which is the same kernel without the added
//   intra terms.
//   Bound: bytes. It reads k/v (50 MB), dS (67 MB) and the intra terms
//   (50 MB) and writes dk/dv (50 MB) for ~8.6 GFLOP at the training shape:
//   0.065 ms at 3.35 TB/s.
//   Design (Hopper, hopper.cuh): a persistent grid, one block of three
//   warpgroups on each SM, walks the work items (64 rows of a chunk, head)
//   in a fixed order. Warpgroup 0 is the producer: one thread loads the
//   item's k tile [64, Dk] by TMA into one of two k buffers, then for each
//   128-column piece of Dv the v piece [64, 128] and the dS piece [Dk, 128]
//   into a ring of stages (4 at Dk = 128: 48 KB each), every tile read
//   once from device memory in the 128-byte swizzle. Splitting dS by Dv
//   keeps a stage small enough for a deep ring (two 112 KB stages of whole
//   items would leave no room to stage anything else) and bounds both
//   accumulators at 64 float32 registers at Dk = 128. Warpgroup 1 forms dk
//   = v dS^T (wgmma m64nDk, A = v and B = dS both K-major over the piece),
//   summed over the pieces in registers; warpgroup 2 forms dv = k dS one
//   piece at a time (m64n128, A = k K-major, B = dS MN-major). Each
//   consumer loads its bf16 intra terms into registers before it waits for
//   the stage, releases the stage as soon as its products are done, adds
//   the intra terms in float32 and rounds once to bf16 in the accumulator
//   layout, so the next tiles land while it stores. No atomics: the same
//   bits from run to run. Chunks of any multiple of 16: an item is 64 rows
//   of one chunk; rows past the chunk are loaded (the next chunk's, or
//   zeros past the tensor) and neither read for intra terms nor stored.
//   Key head dims of any multiple of 16 up to 256 run on the tile width kDk
//   = 64, 128 or 256 just above: the tensor maps end at the head's Dk, so
//   TMA fills k's columns and dS's rows past it with zeros, which add
//   nothing to dv, and dk's columns past it are neither read nor stored.

#include "hopper.cuh"

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBoxBytes = 64 * 64 * 2;  // one [64][64] bf16 box

// K4b geometry at key tile width kDk (64, 128 or 256): q and k tiles [64][kDk]
// (two buffers where they fit beside two stages), stages of a Dv panel of 64
// columns (v and dO [64][64], mixed [kDk][64]), the P and dA tiles, and a
// staging region a consumer warpgroup (two [64][64] tiles, or its [64][kDk]
// output).
template <int kDk>
struct OutBwdGeom {
  static constexpr int kTile = 64 * kDk * 2;
  static constexpr int kStageBytes = 2 * kBoxBytes + kTile;
  static constexpr int kStaging = kTile > 2 * kBoxBytes ? kTile : 2 * kBoxBytes;
  static constexpr int kFixed = 2 * kBoxBytes + 2 * kStaging + 1024 + 512;
  static constexpr int kQKBufs = kFixed + 4 * kTile + 2 * kStageBytes <= 232448 ? 2 : 1;
  static constexpr int kFit = (232448 - kFixed - 2 * kQKBufs * kTile) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = 2 * kQKBufs * kTile + kStages * kStageBytes + kFixed;
  static_assert(kStages >= 1, "K4b needs a stage");
};

// Round a consumer warpgroup's [64][64] accumulator to bf16 into staging tile
// piece % 2 of ``stg`` and store it by TMA as the box (c0, c1, c2, c3) of
// ``map``. The store two back has read that tile; an item's first piece waits
// for all, since the item before stored its [64][kDk] output from both tiles.
// ``bar`` is the warpgroup's named barrier.
__device__ __forceinline__ void store_piece(const CUtensorMap* map, unsigned char* stg,
                                            int& piece, int bar, const float (&acc)[8][4],
                                            int c0, int c1, int c2, int c3) {
  const bool issuer = threadIdx.x % 128 == 0;
  unsigned char* buf = stg + (piece & 1) * kBoxBytes;
  if (issuer) {
    if (piece == 0) tma_store_wait_read<0>();
    else tma_store_wait_read<1>();
  }
  ++piece;
  named_sync(bar, 128);
  acc_to_panels<64>(buf, acc);
  fence_async_shared();
  named_sync(bar, 128);
  if (issuer) tma_store_4d(map, buf, c0, c1, c2, c3);
}

// dmixed = q^T dO for Dv panel p (dO's [64][64] tile at ``dos``), by 64 rows
// of Dk (q's panels read MN-major as A) up to Dk, each stored by store_piece.
template <int kDk>
__device__ __forceinline__ void dmixed_panel(const CUtensorMap* map_dm, const unsigned char* qs,
                                             const unsigned char* dos, int Dk, int p, int item,
                                             unsigned char* stg, int& piece, int bar) {
  for (int j = 0; j < kDk / 64 && 64 * j < Dk; ++j) {
    float dmacc[8][4];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_ss<1, 1>(dmacc, desc_mnmajor<64>(qs + j * kBoxBytes) + kstep_mnmajor(s),
                     desc_mnmajor<64>(dos) + kstep_mnmajor(s), s > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dmacc);
    store_piece(map_dm, stg, piece, bar, dmacc, 64 * p, 0, 64 * j, item);
  }
}

// K4b. Persistent grid of at most one block per SM, 384 threads, dynamic
// shared memory OutBwdGeom<kDk>::kSmem. Item (bn * H + h) is chunk bn (of the
// B*N) of head h. Maps: q, k, dq, dk_i as [bn, C, H, Dk], v, dO and dv_i as
// [bn, C, H, Dv] (boxes of 64 columns x 64 rows), mixed and dmixed as
// [bn * H, Dk, 1, Dv] (boxes of 64 x 64). md: [N], or [B, N] with
// md_bstride = N (0 when shared); dmd_part: [bn * H], item by item.
template <int kDk>
__global__ void __launch_bounds__(384, 1)
chunk_output_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_m,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_dq,
                        const __grid_constant__ CUtensorMap map_dk,
                        const __grid_constant__ CUtensorMap map_dv,
                        const __grid_constant__ CUtensorMap map_dm,
                        const float* __restrict__ md, float* __restrict__ dmd_part, int N,
                        int H, int Dk, int Dv, int md_bstride, int items) {
  typedef OutBwdGeom<kDk> G;
  constexpr int kStages = G::kStages, kPanels = kDk / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qk = smem;                                      // [bufs][q, k]
  unsigned char* ring = qk + 2 * G::kQKBufs * G::kTile;          // [stages][v, dO, mixed]
  unsigned char* ptile = ring + kStages * G::kStageBytes;        // P = bf16(tril A)
  unsigned char* datile = ptile + kBoxBytes;                     // dA = bf16(md tril dP)
  unsigned char* staging = datile + kBoxBytes;                   // [warpgroup 1, 2]
  uint64_t* qk_full = reinterpret_cast<uint64_t*>(staging + 2 * G::kStaging);
  uint64_t* qk_empty = qk_full + 2;
  uint64_t* full = qk_full + 4;
  uint64_t* empty = full + kStages;
  float* red = reinterpret_cast<float*>(empty + kStages);  // warpgroup 1's four warps
  const int vpanels = Dv / 64;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qk_full[i], 1);
      mbar_init(&qk_empty[i], 256);  // both consumer warpgroups release q and k
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    regs_dec<24>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
        const int h = item % H, bn = item / H;
        const int b = it % G::kQKBufs, round = it / G::kQKBufs;
        unsigned char* qs = qk + 2 * b * G::kTile;
        mbar_wait(&qk_empty[b], (round & 1) ^ 1);
        mbar_arrive_expect_tx(&qk_full[b], 2 * G::kTile);
        tma_load_tile<kDk, 64>(qs, &map_q, &qk_full[b], 0, h, bn);
        tma_load_tile<kDk, 64>(qs + G::kTile, &map_k, &qk_full[b], 0, h, bn);
        for (int p = 0; p < vpanels; ++p) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], G::kStageBytes);
          unsigned char* st = ring + stage * G::kStageBytes;
          tma_load_4d(st, &map_v, &full[stage], 64 * p, h, 0, bn);
          tma_load_4d(st + kBoxBytes, &map_do, &full[stage], 64 * p, h, 0, bn);
#pragma unroll
          for (int j = 0; j < kPanels; ++j)  // mixed rows [64 j, 64 j + 64), one [kDk][64] tile
            tma_load_4d(st + (2 + j) * kBoxBytes, &map_m, &full[stage], 64 * p, 0, 64 * j, item);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {  // the consumer warpgroups
    regs_inc<240>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = t >> 5, g = (t & 31) >> 2, tg = t & 3;
    const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's rows of the chunk
    unsigned char* stg = staging + (wg - 1) * G::kStaging;
    int stage = 0;
    uint32_t phase = 0;
    auto release = [&] {  // this warpgroup is done with the stage
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) stage = 0, phase ^= 1;
    };
    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
      const int h = item % H, bn = item / H;
      const int b = it % G::kQKBufs, round = it / G::kQKBufs;
      const unsigned char* qs = qk + 2 * b * G::kTile;
      const unsigned char* ks = qs + G::kTile;
      int piece = 0;  // [64][64] tiles this warpgroup stored this item
      mbar_wait(&qk_full[b], round & 1);
      if (wg == 1) {
        const float mdn = md[(bn / N) * md_bstride + bn % N];
        // A = q k^T, tril in float32 registers; P = bf16(tril A) into its tile
        float sacc[8][4];
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kDk / 16; ++s)
          wgmma_ss(sacc, desc_kmajor(qs, 0) + kstep_kmajor<64>(s),
                   desc_kmajor(ks, 0) + kstep_kmajor<64>(s), s > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sacc);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (nt * 8 + tg * 2 + (e & 1) > (e < 2 ? r0 : r1)) sacc[nt][e] = 0.f;
        acc_to_panels<64>(ptile, sacc);
        fence_async_shared();
        named_sync(1, 128);
        // per Dv panel: dP += dO v^T; dv_intra = md P^T dO
        float dpacc[8][4];
        for (int p = 0; p < vpanels; ++p) {
          mbar_wait(&full[stage], phase);
          const unsigned char* st = ring + stage * G::kStageBytes;
          const unsigned char* dos = st + kBoxBytes;
          float dvacc[8][4];
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_ss(dpacc, desc_kmajor(dos, 0) + kstep_kmajor<64>(s),
                     desc_kmajor(st, 0) + kstep_kmajor<64>(s), p > 0 || s > 0);
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_ss<1, 1>(dvacc, desc_mnmajor<64>(ptile) + kstep_mnmajor(s),
                           desc_mnmajor<64>(dos) + kstep_mnmajor(s), s > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(dpacc);
          fence_acc(dvacc);
          release();
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) dvacc[i][e] *= mdn;
          store_piece(&map_dv, stg, piece, 1, dvacc, 64 * p, h, 0, bn);
        }
        // tril dP, the item's partial of sum(dP * A), dA = md dP
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (nt * 8 + tg * 2 + (e & 1) > (e < 2 ? r0 : r1)) dpacc[nt][e] = 0.f;
            part = fmaf(dpacc[nt][e], sacc[nt][e], part);
            dpacc[nt][e] *= mdn;
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if ((t & 31) == 0) red[warp] = part;
        if (it > 0) named_sync(4, 256);  // warpgroup 2 has read the last item's dA
        acc_to_panels<64>(datile, dpacc);
        fence_async_shared();
        named_sync(1, 128);
        named_arrive(3, 256);  // dA is ready for warpgroup 2
        if (t == 0) dmd_part[item] = ((red[0] + red[1]) + red[2]) + red[3];
        // dk_intra = dA^T q
        float dkacc[kDk / 8][4];
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_ss<1, 1>(dkacc, desc_mnmajor<64>(datile) + kstep_mnmajor(s),
                         desc_mnmajor<64>(qs) + kstep_mnmajor(s), s > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dkacc);
        mbar_arrive(&qk_empty[b]);
        if (t == 0) tma_store_wait_read<0>();
        named_sync(1, 128);
        acc_to_panels<kDk>(stg, dkacc);
        fence_async_shared();
        named_sync(1, 128);
        if (t == 0) {
          for (int j = 0; j < kPanels && 64 * j < Dk; ++j)
            tma_store_4d_part(&map_dk, stg + j * kBoxBytes, 64 * j, h, 0, bn);
          tma_store_commit();
        }
      } else {
        // per Dv panel: dq += dO mixed^T; dmixed = q^T dO
        float dqacc[kDk / 8][4];
        for (int p = 0; p < vpanels; ++p) {
          mbar_wait(&full[stage], phase);
          const unsigned char* st = ring + stage * G::kStageBytes;
          const unsigned char* dos = st + kBoxBytes;
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_ss(dqacc, desc_kmajor(dos, 0) + kstep_kmajor<64>(s),
                     desc_kmajor(st + 2 * kBoxBytes, 0) + kstep_kmajor<kDk>(s), p > 0 || s > 0);
          wgmma_commit();
          dmixed_panel<kDk>(&map_dm, qs, dos, Dk, p, item, stg, piece, 2);
          wgmma_wait<0>();
          fence_acc(dqacc);
          release();
        }
        // dq += dA k, once warpgroup 1 has written dA
        named_sync(3, 256);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_ss<0, 1>(dqacc, desc_kmajor(datile, 0) + kstep_kmajor<64>(s),
                         desc_mnmajor<64>(ks) + kstep_mnmajor(s), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dqacc);
        mbar_arrive(&qk_empty[b]);
        if (item + (int)gridDim.x < items) named_arrive(4, 256);  // dA may be rewritten
        if (t == 0) tma_store_wait_read<0>();
        named_sync(2, 128);
        acc_to_panels<kDk>(stg, dqacc);
        fence_async_shared();
        named_sync(2, 128);
        if (t == 0) {
          for (int j = 0; j < kPanels && 64 * j < Dk; ++j)
            tma_store_4d_part(&map_dq, stg + j * kBoxBytes, 64 * j, h, 0, bn);
          tma_store_commit();
        }
      }
    }
    if (t == 0) tma_store_wait_all();
  }
}

template <int kDk>
int launch_output_bwd(const void* q, const void* k, const void* v, const void* mixed,
                      const void* md, const void* dout, void* dq, void* dk_i, void* dv_i,
                      void* dmixed, void* dmd_part, int bn, int N, int C, int H, int Dk, int Dv,
                      int md_bstride, cudaStream_t stream) {
  typedef OutBwdGeom<kDk> G;
  CUtensorMap mq, mk, mv, mm, mdo, mdq, mdk, mdv, mdm;
  int err = hopper_host::make_tile_map(&mq, q, bn, C, H, Dk, 64);
  if (!err) err = hopper_host::make_tile_map(&mk, k, bn, C, H, Dk, 64);
  if (!err) err = hopper_host::make_tile_map(&mv, v, bn, C, H, Dv, 64);
  if (!err) err = hopper_host::make_tile_map(&mm, mixed, bn * H, Dk, 1, Dv, 64);
  if (!err) err = hopper_host::make_tile_map(&mdo, dout, bn, C, H, Dv, 64);
  if (!err) err = hopper_host::make_tile_map(&mdq, dq, bn, C, H, Dk, 64);
  if (!err) err = hopper_host::make_tile_map(&mdk, dk_i, bn, C, H, Dk, 64);
  if (!err) err = hopper_host::make_tile_map(&mdv, dv_i, bn, C, H, Dv, 64);
  if (!err) err = hopper_host::make_tile_map(&mdm, dmixed, bn * H, Dk, 1, Dv, 64);
  if (err) return err;
  auto kern = chunk_output_bwd_kernel<kDk>;
  int sms = 0;  // one block an SM
  err = hopper_host::resident_blocks((const void*)kern, 384, G::kSmem, &sms);
  if (err) return err;
  const long long items = (long long)bn * H;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kern<<<items < sms ? (int)items : sms, 384, G::kSmem, stream>>>(
      mq, mk, mv, mm, mdo, mdq, mdk, mdv, mdm, (const float*)md, (float*)dmd_part, N, H, Dk,
      Dv, md_bstride, (int)items);
  return (int)cudaGetLastError();
}

// K2b geometry at key tile width kDk (64, 128 or 256): 64-row items, Dv in
// pieces of 128 columns, as many ring stages as fit beside two k buffers.
template <int kDk>
struct StatesBwdGeom {
  static constexpr int kRows = 64;     // chunk rows per item (wgmma's M)
  static constexpr int kPiece = 128;   // Dv columns per stage
  static constexpr int kKBytes = kRows * kDk * 2;
  static constexpr int kVBytes = kRows * kPiece * 2;
  static constexpr int kSBytes = kDk * kPiece * 2;
  static constexpr int kStageBytes = kVBytes + kSBytes;
  static constexpr int kFit = (232448 - 1024 - 256 - 2 * kKBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = 2 * kKBytes + kStages * kStageBytes + 1024 + 256;
  static_assert(kStages >= 2, "K2b needs two stages");
};

// Round acc + add (the bf16 pairs of the same fragment positions) to bf16 and
// store rows r0 and r0 + 8 (those below ``rows``) and the columns below
// ``cols`` (even) of a [64 x kN] tile whose row r starts at out + r * ld.
template <int kN>
__device__ __forceinline__ void store_tile(bf16* out, int64_t ld, int r0, int rows, int cols,
                                           const float (&acc)[kN / 8][4],
                                           const uint32_t (&add)[kN / 8][2]) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < kN / 8; ++i) {
    const int c = i * 8 + tg * 2;
    if (c >= cols) continue;
    const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&add[i][0]));
    const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&add[i][1]));
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(out + r0 * ld + c) =
          pack_bf16(acc[i][0] + a0.x, acc[i][1] + a0.y);
    if (r0 + 8 < rows)
      *reinterpret_cast<uint32_t*>(out + (r0 + 8) * ld + c) =
          pack_bf16(acc[i][2] + a1.x, acc[i][3] + a1.y);
  }
}

// The bf16 pairs at the accumulator positions of rows r0, r0 + 8 (zeros at
// and past ``rows``, and at and past column ``cols``) of a [64 x kN] tile at
// src (row stride ld).
template <int kN>
__device__ __forceinline__ void load_tile(uint32_t (&add)[kN / 8][2], const bf16* src,
                                          int64_t ld, int r0, int rows, int cols) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < kN / 8; ++i) {
    const int c = i * 8 + tg * 2;
    if (c >= cols) {
      add[i][0] = add[i][1] = 0u;
      continue;
    }
    add[i][0] = r0 < rows ? *reinterpret_cast<const uint32_t*>(src + r0 * ld + c) : 0u;
    add[i][1] = r0 + 8 < rows ? *reinterpret_cast<const uint32_t*>(src + (r0 + 8) * ld + c) : 0u;
  }
}

// K2b. Persistent grid of at most one block per SM, 384 threads, dynamic
// shared memory StatesBwdGeom<kDk>::kSmem. Item i = ((bn * row_tiles + rt)
// * H + h): rows [64 rt, 64 rt + 64) of chunk bn (of the B*N) and head h.
// Maps: k and v as [1, bn * C, H, D] (boxes of 64 rows), dS as [bn * H,
// Dk, 1, Dv] (boxes of kDk rows), both ending at the head dim Dk <= kDk.
// dk_i, dk: [bn, C, H*Dk]; dv_i, dv: [bn, C, H*Dv].
template <int kDk>
__global__ void __launch_bounds__(384, 1)
chunk_states_bwd_kernel(const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_ds,
                        const bf16* __restrict__ dk_i, const bf16* __restrict__ dv_i,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int C, int H, int Dk,
                        int Dv, int row_tiles, int items) {
  typedef StatesBwdGeom<kDk> G;
  constexpr int kStages = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kbuf = smem;                        // [2][64][kDk]
  unsigned char* ring = smem + 2 * G::kKBytes;       // [kStages][v piece, dS piece]
  uint64_t* kfull = reinterpret_cast<uint64_t*>(ring + kStages * G::kStageBytes);
  uint64_t* kempty = kfull + 2;
  uint64_t* full = kfull + 4;
  uint64_t* empty = full + kStages;
  const int pieces = Dv / G::kPiece;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&kfull[i], 1);
      mbar_init(&kempty[i], 128);  // the dv warpgroup releases a k buffer
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // both consumer warpgroups release a stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    regs_dec<24>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
        const int h = item % H, rest = item / H;
        const int bn = rest / row_tiles, t0 = bn * C + (rest % row_tiles) * G::kRows;
        const int kb = it & 1;
        mbar_wait(&kempty[kb], ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&kfull[kb], G::kKBytes);
        tma_load_tile<kDk, G::kRows>(kbuf + kb * G::kKBytes, &map_k, &kfull[kb], t0, h, 0);
        for (int p = 0; p < pieces; ++p) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], G::kStageBytes);
          unsigned char* st = ring + stage * G::kStageBytes;
          tma_load_cols<G::kPiece, G::kRows>(st, &map_v, &full[stage], p * G::kPiece, t0, h, 0);
          tma_load_cols<G::kPiece, kDk>(st + G::kVBytes, &map_ds, &full[stage], p * G::kPiece,
                                        0, 0, bn * H + h);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {  // the consumer warpgroups: 1 forms dk, 2 forms dv
    regs_inc<240>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int r0 = (t >> 5) * 16 + ((t & 31) >> 2);  // this thread's rows r0, r0 + 8
    const int64_t ldk = (int64_t)H * Dk, ldv = (int64_t)H * Dv;
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
      const int h = item % H, rest = item / H;
      const int rt = rest % row_tiles, bn = rest / row_tiles;
      const int rows = min(G::kRows, C - rt * G::kRows);
      const int64_t row0 = (int64_t)bn * C + rt * G::kRows;  // the item's first token
      if (wg == 1) {
        const int64_t off = row0 * ldk + h * Dk;
        uint32_t add[kDk / 8][2];
        load_tile<kDk>(add, dk_i + off, ldk, r0, rows, Dk);
        float acc[kDk / 8][4];
        for (int p = 0; p < pieces; ++p) {
          mbar_wait(&full[stage], phase);
          const unsigned char* st = ring + stage * G::kStageBytes;
          const uint64_t da = desc_kmajor(st, 0), db = desc_kmajor(st + G::kVBytes, 0);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < G::kPiece / 16; ++s)
            wgmma_ss(acc, da + kstep_kmajor<G::kRows>(s), db + kstep_kmajor<kDk>(s),
                     p > 0 || s > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
          mbar_arrive(&empty[stage]);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
        store_tile<kDk>(dk + off, ldk, r0, rows, Dk, acc, add);
      } else {
        const int kb = it & 1;
        mbar_wait(&kfull[kb], (it >> 1) & 1);
        const uint64_t da = desc_kmajor(kbuf + kb * G::kKBytes, 0);
        for (int p = 0; p < pieces; ++p) {
          const int64_t off = row0 * ldv + (int64_t)h * Dv + p * G::kPiece;
          uint32_t add[G::kPiece / 8][2];
          load_tile<G::kPiece>(add, dv_i + off, ldv, r0, rows, G::kPiece);
          mbar_wait(&full[stage], phase);
          const uint64_t db = desc_mnmajor<kDk>(ring + stage * G::kStageBytes + G::kVBytes);
          float acc[G::kPiece / 8][4];
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < kDk / 16; ++s)
            wgmma_ss<0, 1>(acc, da + kstep_kmajor<G::kRows>(s), db + kstep_mnmajor(s), s > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(acc);
          mbar_arrive(&empty[stage]);
          if (p == pieces - 1) mbar_arrive(&kempty[kb]);
          if (++stage == kStages) stage = 0, phase ^= 1;
          store_tile<G::kPiece>(dv + off, ldv, r0, rows, G::kPiece, acc, add);
        }
      }
    }
  }
}

template <int kDk>
int launch_states_bwd(const void* k, const void* v, const void* ds, const void* dk_i,
                      const void* dv_i, void* dk, void* dv, int bn, int C, int H, int Dk, int Dv,
                      cudaStream_t stream) {
  typedef StatesBwdGeom<kDk> G;
  CUtensorMap mk, mv, mds;
  int err = hopper_host::make_tile_map(&mk, k, 1, bn * C, H, Dk, G::kRows);
  if (!err) err = hopper_host::make_tile_map(&mv, v, 1, bn * C, H, Dv, G::kRows);
  if (!err) err = hopper_host::make_tile_map(&mds, ds, bn * H, Dk, 1, Dv, kDk);
  if (err) return err;
  auto kern = chunk_states_bwd_kernel<kDk>;
  int sms = 0;  // one block an SM
  err = hopper_host::resident_blocks((const void*)kern, 384, G::kSmem, &sms);
  if (err) return err;
  const int row_tiles = (C + G::kRows - 1) / G::kRows;
  const int items = bn * row_tiles * H;
  kern<<<items < sms ? items : sms, 384, G::kSmem, stream>>>(
      mk, mv, mds, (const bf16*)dk_i, (const bf16*)dv_i, (bf16*)dk, (bf16*)dv, C, H, Dk, Dv,
      row_tiles, items);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns the launch's cudaError_t.
extern "C" {

// C % 16 == 0 with 16 <= C <= 64, Dk % 16 == 0 with 16 <= Dk <= 256 and
// Dv % 128 == 0, or cudaErrorInvalidValue; every pointer 16-byte aligned
// (TMA). dmd_part: [bn * H] float32, one partial of d md per (chunk, head).
int mhla_chunk_output_bwd(const void* q, const void* k, const void* v, const void* mixed,
                          const void* md, const void* dout, void* dq, void* dk_i, void* dv_i,
                          void* dmixed, void* dmd_part, int bn, int N, int C, int H, int Dk,
                          int Dv, int md_bstride, void* stream) {
  if (bn < 1 || N < 1 || H < 1 || C < 16 || C > 64 || C % 16 || Dk < 16 || Dk > 256 ||
      Dk % 16 || Dv < 128 || Dv % 128)
    return (int)cudaErrorInvalidValue;
  auto launch = Dk <= 64 ? launch_output_bwd<64> : Dk <= 128 ? launch_output_bwd<128>
                                                             : launch_output_bwd<256>;
  return launch(q, k, v, mixed, md, dout, dq, dk_i, dv_i, dmixed, dmd_part, bn, N, C, H, Dk, Dv,
                md_bstride, (cudaStream_t)stream);
}

// Dk % 16 == 0 with 16 <= Dk <= 256 and Dv % 128 == 0, or
// cudaErrorInvalidValue; every pointer 16-byte aligned (TMA).
int mhla_chunk_states_bwd(const void* k, const void* v, const void* ds, const void* dk_i,
                          const void* dv_i, void* dk, void* dv, int bn, int C, int H, int Dk,
                          int Dv, void* stream) {
  if (bn < 1 || C < 1 || Dv < 128 || Dv % 128 || Dk < 16 || Dk > 256 || Dk % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  auto launch = Dk <= 64 ? launch_states_bwd<64> : Dk <= 128 ? launch_states_bwd<128>
                                                             : launch_states_bwd<256>;
  return launch(k, v, ds, dk_i, dv_i, dk, dv, bn, C, H, Dk, Dv, s);
}

}  // extern "C"
