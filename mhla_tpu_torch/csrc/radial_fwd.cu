// K10: flash-attention forward under the radial frame-distance mask for
// Hopper (sm_90a), head dim 128.
//
//   o[b, i, h] = softmax over allowed j of (scale * q[b, i, h] . k[b, j, h]) @ v
//
// q, k, v, o: [B, T, H, 128] bf16, T = F * hw tokens in frame-major order:
// token i lies in frame i / hw at spatial index i % hw. The pair (i, j) is
// allowed iff |s_i - s_j| < hw >> floor(log2(max(|f_i - f_j|, 1))): the whole
// frame at frame distance 0 and 1, a band that halves per octave beyond.
// float32 scores, softmax statistics and accumulation.
//
// Replaces the Pallas TPU kernel _radial_fwd_kernel
// (mhla_tpu/kernels/sparse_attention.py:312). That kernel processes all
// heads of a 256 x 1024 tile in one grid step over a schedule padded to the
// densest query block, and zero-pads the tokens to tile multiples. None of
// that is carried over: here one block owns 64 query rows of one (batch row,
// head), reads its own list of 64-key tiles (a CSR pair of int32 arrays
// computed on the host from the frame geometry, shared by all heads and
// batch rows) and loops over exactly those; bounds checks replace the
// padding (rows past T are never stored, keys past T are scored -inf).
//
// Bound: operations. 4 * 128 FLOP per allowed pair per (batch row, head)
// against 4 * T * 128 * 2 bytes: thousands of FLOP per byte at video
// lengths, far above the card's bf16 ridge of 295.
// Design: the tile step is flash_fwd.cu's (q as mma.sync A fragments in
// registers, K and V tiles double-buffered through shared memory by
// cp.async, online softmax on the accumulator fragments, P reused in place
// as the A fragments of P @ V). What the mask adds: at 64 x 64 tiles the
// schedule skips the 45% of tiles that hold no allowed pair, and its `full`
// flag (3 of 4 scheduled tiles at 21 frames of 1,500) lets a block skip all
// mask work where every pair is allowed. In the other tiles the mask is
// index arithmetic, nothing is read for it: the frame and spatial index of
// a thread's 2 rows are taken once per kernel, those of its 16 columns once
// per tile (one division per tile, then a step per column), and an element
// costs a subtraction, the octave 31 - clz(d), a shift and a compare. A
// scheduled tile may still be wholly masked for some of its rows, so the
// running maximum may stay -inf: the exponentials then take 0 as the
// reference. Not done yet: wgmma, TMA, balancing blocks by tile count.

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

// Spatial window at frame distance d: hw for d <= 1, halved per octave.
__device__ __forceinline__ int radial_window(int d, int hw) {
  return hw >> (31 - __clz(max(d, 1)));
}

// grid (ceil(T / kBlockM), H, B); dynamic shared memory kSmemBytes.
// offsets [gridDim.x + 1] and entries [offsets[last]]: query tile i visits
// the key tiles entries[offsets[i] .. offsets[i + 1]) >> 1; bit 0 of an entry
// says that every pair of the tile is allowed.
__global__ void __launch_bounds__(kThreads)
radial_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  const int* __restrict__ offsets, const int* __restrict__ entries,
                  int T, int H, int hw, float scale_log2) {
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
  const int64_t base = (int64_t)b * T * ld + h * kD;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  bf16* ob = o + base;

  // this warp's 16 query rows as A fragments: rows r0 = g, r1 = g + 8
  const int r0 = blockIdx.x * kBlockM + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int s = 0; s < kD / 16; ++s) {
    const int d = s * 16 + tg * 2;
    qa[s][0] = r0 < T ? ld32(qb + r0 * ld + d) : 0u;
    qa[s][1] = r1 < T ? ld32(qb + r1 * ld + d) : 0u;
    qa[s][2] = r0 < T ? ld32(qb + r0 * ld + d + 8) : 0u;
    qa[s][3] = r1 < T ? ld32(qb + r1 * ld + d + 8) : 0u;
  }
  const int fq0 = r0 / hw, sq0 = r0 - fq0 * hw;  // frame and spatial index of the two rows
  const int fq1 = r1 / hw, sq1 = r1 - fq1 * hw;

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
      const bool valid = kt0 + r < T;
      const int64_t row = valid ? kt0 + r : 0;  // a readable address either way
      cp_async16(&ks[buf][r][c8], kb + row * ld + c8, valid);
      cp_async16(&vs[buf][r][c8], vb + row * ld + c8, valid);
    }
  };

  const int e_begin = offsets[blockIdx.x], ntiles = offsets[blockIdx.x + 1] - e_begin;
  int entry = ntiles > 0 ? entries[e_begin] : 0;
  if (ntiles > 0) load_tile(0, (entry >> 1) * kBlockN);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, kt = (entry >> 1) * kBlockN;
    const bool full = entry & 1;
    // the other buffer's readers finished at the end of the last iteration
    if (it + 1 < ntiles) {
      entry = entries[e_begin + it + 1];
      load_tile(buf ^ 1, (entry >> 1) * kBlockN);
    }
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

    // scale; outside the full tiles, score -inf what the mask or T excludes
    if (full) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] *= scale_log2;
      }
    } else {
      const int fk0 = kt / hw, sk0 = kt - fk0 * hw;  // of the tile's first key
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int off = nt * 8 + tg * 2 + c;
          int fk = fk0, sk = sk0 + off;
          while (sk >= hw) {  // once at most when hw >= 64
            sk -= hw;
            ++fk;
          }
          const bool real = kt + off < T;
          const bool keep0 = real && abs(sq0 - sk) < radial_window(abs(fq0 - fk), hw);
          const bool keep1 = real && abs(sq1 - sk) < radial_window(abs(fq1 - fk), hw);
          sacc[nt][c] = keep0 ? sacc[nt][c] * scale_log2 : -CUDART_INF_F;
          sacc[nt][2 + c] = keep1 ? sacc[nt][2 + c] * scale_log2 : -CUDART_INF_F;
        }
      }
    }

    // row maxima
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sacc[nt][0], sacc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[nt][2], sacc[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // a row whose keys so far were all masked keeps -inf as its maximum: its
    // exponentials take 0 as the reference and come out 0, not NaN
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ref0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float ref1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - ref0), alpha1 = exp2f(m1 - ref1);
    m0 = mn0;
    m1 = mn1;

    // p = exp2(s - m), rounded to bf16 as the A fragments of P @ V
    uint32_t pa[kBlockN / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const float p0 = exp2f(sacc[nt][0] - ref0), p1 = exp2f(sacc[nt][1] - ref0);
      const float p2 = exp2f(sacc[nt][2] - ref1), p3 = exp2f(sacc[nt][3] - ref1);
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
  // every row below T has its own frame allowed, so its sum is positive
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
    const int d = t * 8 + tg * 2;
    if (r0 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * ld + d) =
          __floats2bfloat162_rn(oacc[t][0] * inv0, oacc[t][1] * inv0);
    if (r1 < T)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * ld + d) =
          __floats2bfloat162_rn(oacc[t][2] * inv1, oacc[t][3] * inv1);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches on the given stream,
// does not synchronise, returns the launch's cudaError_t. offsets and
// entries are device pointers to the schedule for T tokens in frames of hw.
extern "C" int mhla_radial_fwd(const void* q, const void* k, const void* v, void* o,
                               const void* offsets, const void* entries, int B, int T,
                               int H, int hw, float scale, void* stream) {
  if (T < 1 || hw < 1 || T % hw) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      radial_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBlockM - 1) / kBlockM, H, B);
  radial_fwd_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (const int*)offsets,
      (const int*)entries, T, H, hw, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
