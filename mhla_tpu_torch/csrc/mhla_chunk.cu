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
//   one block handles one (chunk, head, 128-column tile of Dv).
//   Bound: bytes. It reads q/k/v (25 MB) and mixed (34 MB) and writes o
//   (16 MB) for 4.3 GFLOP at the 340M serving shape.
//   Design: the [C, C] scores never leave the SM: WMMA computes q k^T into
//   fp32 shared memory (blocks above the diagonal are skipped), the block
//   masks and rounds it to bf16, then each warp accumulates
//   md * (P @ v) + q @ mixed for its 16x16 output tiles in one fp32 fragment,
//   skipping the zero blocks of P right of the diagonal.

#include <mma.h>

#include "hopper.cuh"

using namespace hopper;
using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFrag = 16;       // WMMA tile: m = n = k = 16 for bf16
constexpr int kTileN = 128;     // output columns of Dv per block (K4)

// K2's geometry: items of 128 rows of Dk by 128 columns of Dv, chunks in
// slabs of 64 rows, a ring of stages of one slab's k and v boxes.
constexpr int kStatesThreads = 288;  // two consumer warpgroups and a producer warp
constexpr int kBoxBytes = 64 * 64 * 2;  // one [64][64] bf16 box
constexpr int kStatesStageBytes = 4 * kBoxBytes;  // k [64][128] and v [64][128]
constexpr int kStatesStages = 5;
constexpr int kStatesOutBytes = 2 * kBoxBytes;  // a warpgroup's [64][128] staging panels
constexpr int kStatesSmem =
    kStatesStages * kStatesStageBytes + 4 * kStatesOutBytes + 1024 + 256;

typedef wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float> Acc;
typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::col_major> BCol;

// Round a 16x16 fp32 accumulator to bf16 and write it to dst (row stride
// ld elements) through the warp's staging tile, 16 bytes per lane.
__device__ __forceinline__ void store_tile_bf16(const Acc& acc, float* stage,
                                                bf16* dst, int64_t ld) {
  wmma::store_matrix_sync(stage, acc, kFrag, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  __align__(16) bf16 vals[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) vals[i] = __float2bfloat16(stage[r * kFrag + c0 + i]);
  *reinterpret_cast<uint4*>(dst + r * ld + c0) = *reinterpret_cast<const uint4*>(vals);
  __syncwarp();
}

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

// K4. grid (B*N, H, Dv/kTileN); dynamic shared memory C*C*(4 + 2) bytes.
// q, k: [B,N,C,H*Dk]; v, o: [B,N,C,H*Dv]; mixed: [B,N,H*Dk,Dv]; md: [N], or
// [B, N] with md_bstride = N (0 when shared).
__global__ void __launch_bounds__(kThreads)
chunk_output_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ mixed,
                    const float* __restrict__ md, bf16* __restrict__ o, int N,
                    int C, int H, int Dk, int Dv, int md_bstride) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem);    // [C, C] fp32
  bf16* pm = reinterpret_cast<bf16*>(scores + C * C);  // [C, C] masked, bf16
  __shared__ __align__(32) float stage[kWarps][kFrag * kFrag];
  const int warp = threadIdx.x >> 5;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y, tn = blockIdx.z;
  const int n = (int)(bn % N);
  const int64_t ldk = (int64_t)H * Dk, ldv = (int64_t)H * Dv;
  const bf16* qc = q + bn * C * ldk + h * Dk;
  const bf16* kc = k + bn * C * ldk + h * Dk;
  const bf16* vc = v + bn * C * ldv + h * Dv + tn * kTileN;
  const bf16* mc = mixed + (bn * H + h) * Dk * Dv + tn * kTileN;
  bf16* oc = o + bn * C * ldv + h * Dv + tn * kTileN;
  const int ct = C / kFrag;

  // 1. scores = q k^T in fp32, lower block triangle only
  for (int f = warp; f < ct * ct; f += kWarps) {
    const int fm = f / ct, fn = f % ct;
    if (fn > fm) continue;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < Dk; kk += kFrag) {
      ARow a;
      BCol b;  // B = k^T: element (kk, c) = k[c][kk], column-major with ld H*Dk
      wmma::load_matrix_sync(a, qc + fm * kFrag * ldk + kk, (unsigned)ldk);
      wmma::load_matrix_sync(b, kc + fn * kFrag * ldk + kk, (unsigned)ldk);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(scores + fm * kFrag * C + fn * kFrag, acc, C,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // 2. causal mask, rounded to bf16 (only entries c <= r were computed)
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int r = e / C, c = e % C;
    pm[e] = __float2bfloat16(c <= r ? scores[e] : 0.f);
  }
  __syncthreads();

  // 3. o = md[n] * (P @ v) + q @ mixed, one fp32 fragment per output tile
  const float mdn = md[(bn / N) * md_bstride + n];
  const int nt = kTileN / kFrag;
  for (int f = warp; f < ct * nt; f += kWarps) {
    const int fm = f / nt, fn = f % nt;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk <= fm * kFrag; kk += kFrag) {  // P is zero right of the diagonal
      ARow a;
      BRow b;
      wmma::load_matrix_sync(a, pm + fm * kFrag * C + kk, (unsigned)C);
      wmma::load_matrix_sync(b, vc + kk * ldv + fn * kFrag, (unsigned)ldv);
      wmma::mma_sync(acc, a, b, acc);
    }
#pragma unroll
    for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= mdn;
    for (int kk = 0; kk < Dk; kk += kFrag) {
      ARow a;
      BRow b;
      wmma::load_matrix_sync(a, qc + fm * kFrag * ldk + kk, (unsigned)ldk);
      wmma::load_matrix_sync(b, mc + (int64_t)kk * Dv + fn * kFrag, (unsigned)Dv);
      wmma::mma_sync(acc, a, b, acc);
    }
    store_tile_bf16(acc, stage[warp], oc + (int64_t)fm * kFrag * ldv + fn * kFrag, ldv);
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

int mhla_chunk_output(const void* q, const void* k, const void* v,
                      const void* mixed, const void* md, void* o, int bn, int N,
                      int C, int H, int Dk, int Dv, int md_bstride, void* stream) {
  dim3 grid(bn, H, Dv / kTileN);
  const size_t smem = (size_t)C * C * (sizeof(float) + sizeof(bf16));
  chunk_output_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)mixed,
      (const float*)md, (bf16*)o, N, C, H, Dk, Dv, md_bstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
