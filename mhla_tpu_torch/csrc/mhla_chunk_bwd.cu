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
//   K3b mix_states_bwd     dS_j = sum_{i>j} Ms[i, j] dmixed_i
//                          dMs[i, j] += <dmixed_i, S_j>  (i > j), over B, H*Dk*Dv
//   K2b chunk_states_bwd   dk = v dS^T + dk_intra,  dv = k dS + dv_intra
//
// All products accumulate in float32 from bf16 operands; dA, dq, dk, dv,
// dmixed, dS and the intra terms are rounded to bf16, the rounding points of
// the JAX backward (mhla_tpu/kernels/mhla_chunk_pallas.py:623-707, 459-534,
// 184-207). d md and dMs stay float32.
//
// Layout as in csrc/mhla_chunk.cu: token tensors [B, N, C, H*D], states,
// mixed and their gradients [B, N, H*Dk, Dv]. Ms and md are shared by the
// batch or one per batch row (packed varlen rows); then d md is [B, N] (K4b
// sums over heads only) and dMs [B, N, N] (K3b's blocks each work on one
// batch row and add into that row's matrix), as the JAX kernels give dM a
// batch index (_dm_pallas(batched=True), mhla_chunk_pallas.py:422).
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
// K3b replaces _mix_bwd_fused_kernel (mhla_chunk_pallas.py:459) and the math
//   of its fallbacks, _mix_kernel in its upper form (:293) and _dm_kernel
//   (:394): one pass over dmixed gives both dS and dMs.
//   Bound: bytes. It reads dmixed and the states once (134 MB at the
//   training shape) and writes dS (67 MB); dMs is an [N, N] reduction over
//   B*H*Dk*Dv = 8 * 2^17 values per entry.
//   Design: a block walks slabs of 256 state columns of one batch row,
//   staging the N x 256 slabs of dmixed and S in shared memory. Each thread
//   forms dS for one column from the slab (the zero upper triangle of Ms is
//   never read); the warps accumulate D S^T for the slab on the tensor cores
//   (WMMA, 16x16 tiles of the 32x32 slot matrix, the upper tile skipped) in
//   fragments that persist across the block's slabs. At the end each block
//   adds its [N, N] strict lower partial with float32 atomicAdd, one per
//   entry, so the sum over blocks runs in no fixed order.
//
// K2b replaces _phase_a_bwd_acc_kernel (mhla_chunk_pallas.py:184) and
//   _phase_a_bwd_kernel (:142), which is the same kernel without the added
//   intra terms.
//   Bound: bytes. It reads k/v (50 MB), dS (67 MB) and the intra terms
//   (50 MB) and writes dk/dv (50 MB) for ~8.6 GFLOP at the training shape.
//   Design: one block per (chunk, head); each warp owns 16x16 output tiles
//   of dk and dv, reduces on the tensor cores reading its fragments from
//   global memory, and adds the bf16 intra term while rounding the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFrag = 16;      // WMMA tile: m = n = k = 16 for bf16
constexpr int kMaxSlots = 32;  // K3b: chunk slots (two 16-row WMMA tiles)
constexpr int kSlab = 256;     // K3b: state columns per slab, one per thread
constexpr int kMixBlocks = 528;  // K3b: 4 blocks on each of the H100's 132 SMs

typedef wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float> Acc;
typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::col_major> BCol;

// Round a 16x16 fp32 accumulator, plus the bf16 tile `add` (row stride
// ld_add) when it is not null, to bf16 and write it to dst (row stride ld)
// through the warp's staging tile, 16 bytes per lane.
__device__ __forceinline__ void store_tile_bf16(const Acc& acc, float* stage, bf16* dst,
                                                int64_t ld, const bf16* add,
                                                int64_t ld_add) {
  wmma::store_matrix_sync(stage, acc, kFrag, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  float extra[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (add != nullptr) {
    const uint4 raw = *reinterpret_cast<const uint4*>(add + r * ld_add + c0);
    const bf16* a = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) extra[i] = __bfloat162float(a[i]);
  }
  __align__(16) bf16 vals[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) vals[i] = __float2bfloat16(stage[r * kFrag + c0 + i] + extra[i]);
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
                    ldv, nullptr, 0);
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
                      ldk, nullptr, 0);
    } else {
      for (int kk = fm * kFrag; kk < C; kk += kFrag) {  // dA^T is zero below the diagonal
        ACol a;  // A = dA^T: element (m, kk) = dA[kk][m]
        BRow b;
        wmma::load_matrix_sync(a, sda + kk * C + fm * kFrag, (unsigned)C);
        wmma::load_matrix_sync(b, qc + kk * ldk + fn * kFrag, (unsigned)ldk);
        wmma::mma_sync(acc, a, b, acc);
      }
      store_tile_bf16(acc, stage[warp],
                      dk_i + bn * C * ldk + h * Dk + fm * kFrag * ldk + fn * kFrag, ldk,
                      nullptr, 0);
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
    store_tile_bf16(acc, stage[warp], dmc + (int64_t)fm * kFrag * Dv + fn * kFrag, Dv, nullptr,
                    0);
  }
}

// K3b. Shared m: grid (min(slabs, kMixBlocks)); each block walks slabs
// s = blockIdx.x, blockIdx.x + gridDim.x, ... of kSlab columns over all batch
// rows (n_slabs = B * slabs_per_row). Per-row m (m_bstride = N*N): grid
// (blocks per row, B); block row blockIdx.y walks the slabs of batch row
// blockIdx.y only (n_slabs = slabs_per_row) and reads and writes that row's
// matrices. m: [N, N] or [B, N, N] fp32 (read below the diagonal only, its
// values taken at bf16 as the wide form takes them); dmix,
// st, ds: [B, N, R]; dm: m's shape, fp32 zeroed by the caller, accumulated
// atomically below the diagonal.
__global__ void __launch_bounds__(kThreads)
mix_states_bwd_kernel(const float* __restrict__ m, const bf16* __restrict__ dmix,
                      const bf16* __restrict__ st, bf16* __restrict__ ds,
                      float* __restrict__ dm, int N, int64_t R, int64_t slabs_per_row,
                      int64_t n_slabs, int64_t m_bstride) {
  m += blockIdx.y * m_bstride;
  dm += blockIdx.y * m_bstride;
  __shared__ float ms[kMaxSlots * kMaxSlots];
  __shared__ __align__(32) bf16 sd[kMaxSlots * kSlab];
  __shared__ __align__(32) bf16 ss[kMaxSlots * kSlab];
  __shared__ __align__(32) float part[kWarps][kFrag * kFrag];
  const int warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < kMaxSlots * kMaxSlots; e += blockDim.x) {
    const int i = e / kMaxSlots, j = e % kMaxSlots;
    ms[e] = (i < N && j < i) ? __bfloat162float(__float2bfloat16(m[i * N + j])) : 0.f;
  }
  // slot rows N..31 stay zero for every slab
  for (int e = threadIdx.x; e < (kMaxSlots - N) * kSlab; e += blockDim.x) {
    sd[N * kSlab + e] = __float2bfloat16(0.f);
    ss[N * kSlab + e] = __float2bfloat16(0.f);
  }
  // warps 0-3 and 4-7 each own the tiles (0,0), (0,1), (1,0), (1,1) of the
  // 32x32 slot matrix for one half of the slab; (0,1) is above the diagonal
  const int tile = warp & 3, ti = tile >> 1, tj = tile & 1, half = warp >> 2;
  const bool active = tile != 1 && ti * kFrag < N;
  Acc acc;
  wmma::fill_fragment(acc, 0.0f);

  for (int64_t s = blockIdx.x; s < n_slabs; s += gridDim.x) {
    const int64_t g = blockIdx.y * n_slabs + s;  // blockIdx.y is 0 when m is shared
    const int64_t b = g / slabs_per_row;
    const int64_t col0 = (g % slabs_per_row) * kSlab;
    __syncthreads();  // the previous slab's readers are done
    for (int e = threadIdx.x; e < N * (kSlab / 8); e += blockDim.x) {
      const int row = e / (kSlab / 8), c8 = (e % (kSlab / 8)) * 8;
      const int64_t off = (b * N + row) * R + col0 + c8;
      *reinterpret_cast<uint4*>(sd + row * kSlab + c8) = *reinterpret_cast<const uint4*>(dmix + off);
      *reinterpret_cast<uint4*>(ss + row * kSlab + c8) = *reinterpret_cast<const uint4*>(st + off);
    }
    __syncthreads();

    // dS_j = sum_{i>j} Ms[i, j] dmixed_i for this thread's column
    const int col = threadIdx.x;
    float d[kMaxSlots];
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i) d[i] = __bfloat162float(sd[i * kSlab + col]);
#pragma unroll
    for (int j = 0; j < kMaxSlots; ++j) {
      if (j < N) {
        float a = 0.f;
#pragma unroll
        for (int i = j + 1; i < kMaxSlots; ++i) a = fmaf(ms[i * kMaxSlots + j], d[i], a);
        ds[(b * N + j) * R + col0 + col] = __float2bfloat16(a);
      }
    }

    // dMs partial: D S^T over this warp's half of the slab
    if (active) {
      for (int kk = half * (kSlab / 2); kk < (half + 1) * (kSlab / 2); kk += kFrag) {
        ARow a;
        BCol bt;  // B = S^T: element (kk, j) = S[j][kk], column-major with ld kSlab
        wmma::load_matrix_sync(a, sd + ti * kFrag * kSlab + kk, (unsigned)kSlab);
        wmma::load_matrix_sync(bt, ss + tj * kFrag * kSlab + kk, (unsigned)kSlab);
        wmma::mma_sync(acc, a, bt, acc);
      }
    }
  }

  wmma::store_matrix_sync(part[warp], acc, kFrag, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < 4 * kFrag * kFrag; e += blockDim.x) {
    const int t = e / (kFrag * kFrag), idx = e % (kFrag * kFrag);
    const int i = (t >> 1) * kFrag + idx / kFrag, j = (t & 1) * kFrag + idx % kFrag;
    if (t != 1 && i < N && j < i) atomicAdd(dm + i * N + j, part[t][idx] + part[t + 4][idx]);
  }
}

// K2b. grid (B*N, H). k, dk_i, dk: [B,N,C,H*Dk]; v, dv_i, dv: [B,N,C,H*Dv];
// ds: [B,N,H*Dk,Dv].
__global__ void __launch_bounds__(kThreads)
chunk_states_bwd_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ ds, const bf16* __restrict__ dk_i,
                        const bf16* __restrict__ dv_i, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int C, int H, int Dk, int Dv) {
  __shared__ __align__(32) float stage[kWarps][kFrag * kFrag];
  const int warp = threadIdx.x >> 5;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t ldk = (int64_t)H * Dk, ldv = (int64_t)H * Dv;
  const int64_t kbase = bn * C * ldk + h * Dk, vbase = bn * C * ldv + h * Dv;
  const bf16* kc = k + kbase;
  const bf16* vc = v + vbase;
  const bf16* dsc = ds + (bn * H + h) * Dk * Dv;
  const int ct = C / kFrag, ntk = Dk / kFrag, ntv = Dv / kFrag;
  for (int f = warp; f < ct * (ntk + ntv); f += kWarps) {
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    if (f < ct * ntk) {  // dk = v dS^T  [C, Dk]
      const int fm = f / ntk, fn = f % ntk;
      for (int kk = 0; kk < Dv; kk += kFrag) {
        ARow a;
        BCol b;  // B = dS^T: element (kk, c) = dS[c][kk], column-major with ld Dv
        wmma::load_matrix_sync(a, vc + fm * kFrag * ldv + kk, (unsigned)ldv);
        wmma::load_matrix_sync(b, dsc + (int64_t)fn * kFrag * Dv + kk, (unsigned)Dv);
        wmma::mma_sync(acc, a, b, acc);
      }
      const int64_t off = kbase + fm * kFrag * ldk + fn * kFrag;
      store_tile_bf16(acc, stage[warp], dk + off, ldk, dk_i + off, ldk);
    } else {  // dv = k dS  [C, Dv]
      const int g = f - ct * ntk;
      const int fm = g / ntv, fn = g % ntv;
      for (int kk = 0; kk < Dk; kk += kFrag) {
        ARow a;
        BRow b;
        wmma::load_matrix_sync(a, kc + fm * kFrag * ldk + kk, (unsigned)ldk);
        wmma::load_matrix_sync(b, dsc + (int64_t)kk * Dv + fn * kFrag, (unsigned)Dv);
        wmma::mma_sync(acc, a, b, acc);
      }
      const int64_t off = vbase + fm * kFrag * ldv + fn * kFrag;
      store_tile_bf16(acc, stage[warp], dv + off, ldv, dv_i + off, ldv);
    }
  }
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

int mhla_mix_states_bwd(const void* m, const void* dmix, const void* st, void* ds, void* dm,
                        int B, int N, long long R, long long m_bstride, void* stream) {
  const long long slabs_per_row = R / kSlab;
  // shared m: one row of blocks over all slabs; per-row m: a row of blocks per batch row
  const int rows = m_bstride ? B : 1;
  const long long n_slabs = (m_bstride ? 1LL : (long long)B) * slabs_per_row;
  const long long per_row = kMixBlocks / rows > 0 ? kMixBlocks / rows : 1;
  dim3 grid((unsigned)(n_slabs < per_row ? n_slabs : per_row), rows);
  mix_states_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)m, (const bf16*)dmix, (const bf16*)st, (bf16*)ds, (float*)dm, N,
      (int64_t)R, (int64_t)slabs_per_row, (int64_t)n_slabs, (int64_t)m_bstride);
  return (int)cudaGetLastError();
}

int mhla_chunk_states_bwd(const void* k, const void* v, const void* ds, const void* dk_i,
                          const void* dv_i, void* dk, void* dv, int bn, int C, int H, int Dk,
                          int Dv, void* stream) {
  dim3 grid(bn, H);
  chunk_states_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)k, (const bf16*)v, (const bf16*)ds, (const bf16*)dk_i, (const bf16*)dv_i,
      (bf16*)dk, (bf16*)dv, C, H, Dk, Dv);
  return (int)cudaGetLastError();
}

}  // extern "C"
