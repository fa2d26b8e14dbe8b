// K9: non-causal flash-attention forward for Hopper (sm_90a), head dim 128.
//
//   o[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h]) @ v[b, :, h]
//
// q, o: [B, Tq, H, 128]; k, v: [B, Tk, H, 128]; bf16 in and out, float32
// scores, softmax statistics and accumulation. Any Tq and Tk >= 1.
//
// Replaces the JAX library's Pallas TPU flash kernel that
// mhla_tpu/kernels/flash_attention.py:59-63,115-118 calls for long queries
// (the video model's text cross-attention: Tq = 31,500, Tk = 512). That
// wrapper zero-pads both lengths to its block sizes and masks the padding
// with segment ids (flash_attention.py:69-104); here bounds checks do both
// jobs: query rows past Tq are never stored, and keys past Tk get a score
// of -inf before the softmax, so they receive no probability mass.
//
// Bound: operations. 4*Tq*Tk*128 FLOP per batch row and head against
// 2*(2*Tq + 2*Tk)*128 bytes: Tk/2 = 256 FLOP/byte at Tk = 512 and Tq >> Tk,
// at the card's bf16 ridge (989 TFLOP/s over 3.35 TB/s = 295 FLOP/byte)
// and above it for self-attention lengths.
// Design: the [Tq, Tk] scores never reach device memory. A block of 4 warps
// owns 64 query rows of one (batch row, head); each warp keeps its 16 rows
// of q as mma.sync A fragments in registers for the whole kernel, and the
// block walks over the keys 64 at a time. The K and V tiles go through
// shared memory (rows padded by 16 bytes, so the 8 row reads of an ldmatrix
// phase hit 32 distinct banks); one ldmatrix.x4 brings the B fragments of
// two mma steps, plain for K (stored [key][d], read as k^T) and transposed
// for V. S = q k^T runs on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 out); the online softmax works on the accumulator fragments in
// registers (a row lives in the 4 lanes of a quad: two shuffles reduce it);
// the probabilities are rounded to bf16 and reused in place as the A
// fragments of P @ V, whose float32 accumulator is rescaled by
// exp2(m_old - m_new) per row. One division by the row sum at the end.
// The tiles arrive by cp.async into two buffers: while the block computes on
// one tile the next one is in flight, and no register stages the copy (keys
// past Tk are zero-filled by a copy of size 0). Not done yet: wgmma, TMA.

#include <math_constants.h>

#include "flash_common.cuh"

using namespace flash;

namespace {

constexpr int kD = 128;          // head dim
constexpr int kBlockM = 64;      // query rows per block (16 per warp)
constexpr int kBlockN = 64;      // keys per tile
constexpr int kLd = kD + 8;      // shared-memory row stride in elements
constexpr int kThreads = 128;
constexpr int kSmemBytes = 4 * kBlockN * kLd * (int)sizeof(bf16);  // 2 K and 2 V tiles

// grid (ceil(Tq / kBlockM), H, B); dynamic shared memory kSmemBytes.
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Tq,
                 int Tk, int H, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typedef bf16 Tile[kBlockN][kLd];
  Tile* ks = reinterpret_cast<Tile*>(smem_raw);  // [2] tiles of K
  Tile* vs = ks + 2;                             // [2] tiles of V
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // fragment row group, column pair
  const int lrow = lane & 7, lmat = lane >> 3;  // this lane's row and matrix of an ldmatrix
  const int b = blockIdx.z, h = blockIdx.y;
  const int64_t ld = (int64_t)H * kD;
  const bf16* qb = q + (int64_t)b * Tq * ld + h * kD;
  const bf16* kb = k + (int64_t)b * Tk * ld + h * kD;
  const bf16* vb = v + (int64_t)b * Tk * ld + h * kD;
  bf16* ob = o + (int64_t)b * Tq * ld + h * kD;

  // this warp's 16 query rows as A fragments: rows r0 = g, r1 = g + 8
  const int r0 = blockIdx.x * kBlockM + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int s = 0; s < kD / 16; ++s) {
    const int d = s * 16 + tg * 2;
    qa[s][0] = r0 < Tq ? ld32(qb + r0 * ld + d) : 0u;
    qa[s][1] = r1 < Tq ? ld32(qb + r1 * ld + d) : 0u;
    qa[s][2] = r0 < Tq ? ld32(qb + r0 * ld + d + 8) : 0u;
    qa[s][3] = r1 < Tq ? ld32(qb + r1 * ld + d + 8) : 0u;
  }

  float oacc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) oacc[t][0] = oacc[t][1] = oacc[t][2] = oacc[t][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running row maxima (log2 units)
  float l0 = 0.f, l1 = 0.f;                      // this lane's share of the row sums

  // start the copy of the K and V tile at key kt0 into buffer buf
  auto load_tile = [&](int buf, int kt0) {
#pragma unroll
    for (int i = 0; i < kBlockN * (kD / 8) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kD / 8), c8 = (e % (kD / 8)) * 8;
      const bool valid = kt0 + r < Tk;
      const int64_t row = valid ? kt0 + r : 0;  // a readable address either way
      cp_async16(&ks[buf][r][c8], kb + row * ld + c8, valid);
      cp_async16(&vs[buf][r][c8], vb + row * ld + c8, valid);
    }
  };

  const int ntiles = (Tk + kBlockN - 1) / kBlockN;
  load_tile(0, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, kt = it * kBlockN;
    // the other buffer's readers finished at the end of the last iteration
    if (it + 1 < ntiles) load_tile(buf ^ 1, kt + kBlockN);
    cp_async_commit();   // an empty group after the last tile keeps the count uniform
    cp_async_wait<1>();  // all but the newest group: this tile has landed
    __syncthreads();

    // S = q k^T for 16 rows x 64 keys: 8 accumulator tiles of 16 x 8
    float sacc[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
      for (int s2 = 0; s2 < kD / 32; ++s2) {  // 32 of d: the B fragments of two steps
        uint32_t kf[4];
        ldmatrix_x4(kf, &ks[buf][nt * 8 + lrow][s2 * 32 + lmat * 8]);
        mma_bf16(sacc[nt], qa[2 * s2], kf[0], kf[1]);
        mma_bf16(sacc[nt], qa[2 * s2 + 1], kf[2], kf[3]);
      }
    }

    // scale, mask the keys past Tk, row maxima
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + nt * 8 + tg * 2 + (e & 1);
        sacc[nt][e] = key < Tk ? sacc[nt][e] * scale_log2 : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(sacc[nt][0], sacc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[nt][2], sacc[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one key below Tk, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p = exp2(s - m), rounded to bf16 as the A fragments of P @ V
    uint32_t pa[kBlockN / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const float p0 = exp2f(sacc[nt][0] - mn0), p1 = exp2f(sacc[nt][1] - mn0);
      const float p2 = exp2f(sacc[nt][2] - mn1), p3 = exp2f(sacc[nt][3] - mn1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[nt / 2][(nt & 1) * 2 + 0] = pack2f(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack2f(p2, p3);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

    // o = alpha * o + P @ V
#pragma unroll
    for (int t = 0; t < kD / 8; ++t) {
      oacc[t][0] *= alpha0;
      oacc[t][1] *= alpha0;
      oacc[t][2] *= alpha1;
      oacc[t][3] *= alpha1;
#pragma unroll
      for (int s2 = 0; s2 < kBlockN / 32; ++s2) {  // 32 keys: the B fragments of two steps
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &vs[buf][s2 * 32 + lmat * 8 + lrow][t * 8]);
        mma_bf16(oacc[t], pa[2 * s2], vf[0], vf[1]);
        mma_bf16(oacc[t], pa[2 * s2 + 1], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer's fragment reads are done before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
    const int d = t * 8 + tg * 2;
    if (r0 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * ld + d) =
          __floats2bfloat162_rn(oacc[t][0] * inv0, oacc[t][1] * inv0);
    if (r1 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * ld + d) =
          __floats2bfloat162_rn(oacc[t][2] * inv1, oacc[t][3] * inv1);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches on the given stream,
// does not synchronise, returns the launch's cudaError_t.
extern "C" int mhla_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int Tq, int Tk, int H,
                              float scale, void* stream) {
  if (Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Tq, Tk, H,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
