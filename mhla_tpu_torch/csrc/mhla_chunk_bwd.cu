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
//                            d md[n] += sum(dP * A)             over B, H
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
// one per batch row (packed varlen rows); then d md is [B, N] (K4b sums over
// heads only), as the JAX kernels give it a batch index
// (mhla_chunk_pallas.py:726).
//
// What each kernel replaces, what bounds it on the H100 and what the design
// does about it:
//
// K4b replaces _st_bwd_kernel (mhla_chunk_pallas.py:623). The TPU kernel
//   works on 256-row supertiles with near-block weights; the port's forward
//   mixes every earlier chunk in K3, so here only the chunk's own diagonal
//   term is differentiated and there is no dmb fold.
//   Bound: bytes. At the 340M training shape (B=8, T=2048, H=4, Dk=128,
//   Dv=256) it reads q/k/v/dO/mixed (168 MB) and writes dq, dk_intra,
//   dv_intra and dmixed (134 MB) for ~16 GFLOP, ~53 FLOP/byte.
//   Design: one block per (chunk, head) owns all of Dv, so dq, dk_intra and
//   d md, which sum over Dv, are finished in the block without a second
//   pass. The [C, C] tiles A and dP (float32) and P, dA (bf16) live in
//   shared memory; blocks above the diagonal are skipped in every product.
//   d md also sums over batch and heads: each block reduces its partial in
//   shared memory and adds it with one float32 atomicAdd, so the sum's order
//   (not its terms) changes from run to run.
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

#include <mma.h>

#include "hopper.cuh"

using namespace hopper;
using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFrag = 16;      // WMMA tile: m = n = k = 16 for bf16

typedef wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float> Acc;
typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::col_major> BCol;

// Round a 16x16 fp32 accumulator to bf16 and write it to dst (row stride
// ld) through the warp's staging tile, 16 bytes per lane.
__device__ __forceinline__ void store_tile_bf16(const Acc& acc, float* stage, bf16* dst,
                                                int64_t ld) {
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

// K4b. grid (B*N, H); dynamic shared memory C*C*(2*4 + 2*2) bytes.
// q, k, dq, dk_i: [B,N,C,H*Dk]; v, dout, dv_i: [B,N,C,H*Dv];
// mixed, dmixed: [B,N,H*Dk,Dv]; md, dmd: [N] fp32, or [B, N] with
// md_bstride = N (0 when shared); dmd zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
chunk_output_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ mixed,
                        const float* __restrict__ md, const bf16* __restrict__ dout,
                        bf16* __restrict__ dq, bf16* __restrict__ dk_i,
                        bf16* __restrict__ dv_i, bf16* __restrict__ dmixed,
                        float* __restrict__ dmd, int N, int C, int H, int Dk, int Dv,
                        int md_bstride) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);     // [C, C] A = q k^T
  float* sdp = sa + C * C;                         // [C, C] dP = dO v^T
  bf16* sp = reinterpret_cast<bf16*>(sdp + C * C);  // [C, C] bf16(tril A)
  bf16* sda = sp + C * C;                          // [C, C] bf16(md * tril dP)
  __shared__ __align__(32) float stage[kWarps][kFrag * kFrag];
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y;
  const int n = (int)(bn % N);
  const int64_t ldk = (int64_t)H * Dk, ldv = (int64_t)H * Dv;
  const bf16* qc = q + bn * C * ldk + h * Dk;
  const bf16* kc = k + bn * C * ldk + h * Dk;
  const bf16* vc = v + bn * C * ldv + h * Dv;
  const bf16* doc = dout + bn * C * ldv + h * Dv;
  const int64_t st_off = (bn * H + h) * Dk * Dv;
  const bf16* mc = mixed + st_off;
  const int ct = C / kFrag;

  // 1. A = q k^T and dP = dO v^T in fp32, lower block triangle only
  for (int f = warp; f < 2 * ct * ct; f += kWarps) {
    const int which = f / (ct * ct), g = f % (ct * ct);
    const int fm = g / ct, fn = g % ct;
    if (fn > fm) continue;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    const bf16* ra = which == 0 ? qc : doc;
    const bf16* rb = which == 0 ? kc : vc;
    const int64_t ld = which == 0 ? ldk : ldv;
    const int depth = which == 0 ? Dk : Dv;
    for (int kk = 0; kk < depth; kk += kFrag) {
      ARow a;
      BCol b;  // B = rows^T: element (kk, c) = rb[c][kk], column-major with ld
      wmma::load_matrix_sync(a, ra + fm * kFrag * ld + kk, (unsigned)ld);
      wmma::load_matrix_sync(b, rb + fn * kFrag * ld + kk, (unsigned)ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    float* dst = (which == 0 ? sa : sdp) + fm * kFrag * C + fn * kFrag;
    wmma::store_matrix_sync(dst, acc, C, wmma::mem_row_major);
  }
  __syncthreads();

  // 2. causal mask, the two bf16 tiles, and this block's part of d md
  const int64_t md_off = (bn / N) * md_bstride + n;
  const float mdn = md[md_off];
  float part = 0.f;
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int r = e / C, c = e % C;
    const bool keep = c <= r;
    const float a = keep ? sa[e] : 0.f;
    const float dp = keep ? sdp[e] : 0.f;
    sp[e] = __float2bfloat16(a);
    sda[e] = __float2bfloat16(mdn * dp);
    part = fmaf(dp, a, part);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w];
    atomicAdd(dmd + md_off, s);
  }

  // 3. dv_intra = md * P^T dO  [C, Dv]; P^T is zero below the diagonal
  const int ntv = Dv / kFrag, ntk = Dk / kFrag;
  for (int f = warp; f < ct * ntv; f += kWarps) {
    const int fm = f / ntv, fn = f % ntv;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = fm * kFrag; kk < C; kk += kFrag) {
      ACol a;  // A = P^T: element (m, kk) = P[kk][m], column-major with ld C
      BRow b;
      wmma::load_matrix_sync(a, sp + kk * C + fm * kFrag, (unsigned)C);
      wmma::load_matrix_sync(b, doc + kk * ldv + fn * kFrag, (unsigned)ldv);
      wmma::mma_sync(acc, a, b, acc);
    }
#pragma unroll
    for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= mdn;
    store_tile_bf16(acc, stage[warp], dv_i + bn * C * ldv + h * Dv + fm * kFrag * ldv + fn * kFrag,
                    ldv);
  }

  // 4. dq = dA k + dO mixed^T and 5. dk_intra = dA^T q  [C, Dk]
  for (int f = warp; f < 2 * ct * ntk; f += kWarps) {
    const int which = f / (ct * ntk), g = f % (ct * ntk);
    const int fm = g / ntk, fn = g % ntk;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    if (which == 0) {
      for (int kk = 0; kk <= fm * kFrag; kk += kFrag) {  // dA is zero right of the diagonal
        ARow a;
        BRow b;
        wmma::load_matrix_sync(a, sda + fm * kFrag * C + kk, (unsigned)C);
        wmma::load_matrix_sync(b, kc + kk * ldk + fn * kFrag, (unsigned)ldk);
        wmma::mma_sync(acc, a, b, acc);
      }
      for (int kk = 0; kk < Dv; kk += kFrag) {
        ARow a;
        BCol b;  // B = mixed^T: element (kk, c) = mixed[c][kk], column-major with ld Dv
        wmma::load_matrix_sync(a, doc + fm * kFrag * ldv + kk, (unsigned)ldv);
        wmma::load_matrix_sync(b, mc + (int64_t)fn * kFrag * Dv + kk, (unsigned)Dv);
        wmma::mma_sync(acc, a, b, acc);
      }
      store_tile_bf16(acc, stage[warp], dq + bn * C * ldk + h * Dk + fm * kFrag * ldk + fn * kFrag,
                      ldk);
    } else {
      for (int kk = fm * kFrag; kk < C; kk += kFrag) {  // dA^T is zero below the diagonal
        ACol a;  // A = dA^T: element (m, kk) = dA[kk][m]
        BRow b;
        wmma::load_matrix_sync(a, sda + kk * C + fm * kFrag, (unsigned)C);
        wmma::load_matrix_sync(b, qc + kk * ldk + fn * kFrag, (unsigned)ldk);
        wmma::mma_sync(acc, a, b, acc);
      }
      store_tile_bf16(acc, stage[warp],
                      dk_i + bn * C * ldk + h * Dk + fm * kFrag * ldk + fn * kFrag, ldk);
    }
  }

  // 6. dmixed = q^T dO  [Dk, Dv]
  bf16* dmc = dmixed + st_off;
  for (int f = warp; f < ntk * ntv; f += kWarps) {
    const int fm = f / ntv, fn = f % ntv;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < C; kk += kFrag) {
      ACol a;  // A = q^T: element (m, kk) = q[kk][m], column-major with ld H*Dk
      BRow b;
      wmma::load_matrix_sync(a, qc + kk * ldk + fm * kFrag, (unsigned)ldk);
      wmma::load_matrix_sync(b, doc + kk * ldv + fn * kFrag, (unsigned)ldv);
      wmma::mma_sync(acc, a, b, acc);
    }
    store_tile_bf16(acc, stage[warp], dmc + (int64_t)fm * kFrag * Dv + fn * kFrag, Dv);
  }
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

int mhla_chunk_output_bwd(const void* q, const void* k, const void* v, const void* mixed,
                          const void* md, const void* dout, void* dq, void* dk_i, void* dv_i,
                          void* dmixed, void* dmd, int bn, int N, int C, int H, int Dk, int Dv,
                          int md_bstride, void* stream) {
  const int smem = C * C * (2 * (int)sizeof(float) + 2 * (int)sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      chunk_output_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bn, H);
  chunk_output_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)mixed, (const float*)md,
      (const bf16*)dout, (bf16*)dq, (bf16*)dk_i, (bf16*)dv_i, (bf16*)dmixed, (float*)dmd, N, C,
      H, Dk, Dv, md_bstride);
  return (int)cudaGetLastError();
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
