// K9: flash-attention forward for Hopper (sm_90a), head dim 128 or 256.
//
//   o[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h] + mask[b, i, j]) @ v[b, :, h]
//
// q, o: [B, Tq, H, D]; k, v: [B, Tk, H, D] with D = 128 or 256; bf16 in and
// out, float32 scores, softmax statistics and accumulation. Any Tq and Tk >= 1. The
// training form also writes each row's log-sum-exp of the scaled scores,
// lse [B, H, Tq] float32 (natural log), which the backward (flash_bwd.cu)
// reads; the serving form is compiled without that store.
//
// Masked forms (Tq == Tk == T, the rule in flash_mask.cuh): causal, keeping
// key j for query i iff j <= i; segment-id, keeping it iff seg[b, i] ==
// seg[b, j] (packed documents, any ids); or both. They replace the same
// library kernel called with causal=True and/or SegmentIds
// (mhla_tpu/kernels/flash_attention.py:73-104). A block walks only the key
// tiles that can hold a kept pair: none above its diagonal, none whose
// segment-id range misses its own (a small pre-pass writes each tile's
// range); the per-element mask is applied only on the tiles that need it.
// Every row keeps at least itself, so its maximum and lse are finite; a row
// that keeps nothing in a walked tile takes exp2 against 0 there instead of
// its still infinite running maximum. JAX's padding to a block multiple and
// its -1 / -2 pad ids are not carried over: bounds checks do their work.
//
// Replaces the JAX library's Pallas TPU flash kernel that
// mhla_tpu/kernels/flash_attention.py:59-63,115-118 calls for long queries
// (the video model's text cross-attention: Tq = 31,500, Tk = 512; the LM's
// softmax layers from 2,048 tokens on, at head dim 256 when a hybrid keeps
// the LM's 4 heads). That
// wrapper zero-pads both lengths to its block sizes and masks the padding
// with segment ids (flash_attention.py:69-104); here bounds checks do both
// jobs: query rows past Tq are never stored, and keys past Tk get a score
// of -inf before the softmax, so they receive no probability mass.
//
// Bound: operations. 4*Tq*Tk*D FLOP per batch row and head against
// 2*(2*Tq + 2*Tk)*D bytes: Tk/2 = 256 FLOP/byte at Tk = 512 and Tq >> Tk,
// at the card's bf16 ridge (989 TFLOP/s over 3.35 TB/s = 295 FLOP/byte)
// and above it for self-attention lengths, whatever D.
// Design: the [Tq, Tk] scores never reach device memory. A block of 4 warps
// owns 64 query rows of one (batch row, head); at D = 128 each warp keeps its
// 16 rows of q as mma.sync A fragments in registers for the whole kernel; at
// D = 256 those would take 64 registers beside the 128 of the float32 O
// accumulator, so the block's q tile stays in shared memory and each warp
// reads its A fragments with ldmatrix at every key tile. The
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
// past Tk are zero-filled by a copy of size 0). At D = 256 the q tile and
// the four K / V tiles take 165 KB of shared memory: one block per SM.
// Not done yet: wgmma, TMA.

#include <math_constants.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mask.cuh"

using namespace flash;
using flash_mask::TileWalk;
using flash_mask::kCausal;
using flash_mask::kSegment;

namespace {

constexpr int kBlockM = 64;      // query rows per block (16 per warp)
constexpr int kBlockN = 64;      // keys per tile
constexpr int kThreads = 128;
constexpr int kSegSmemBytes = 2 * kBlockN * (int)sizeof(int);  // + 2 tiles of key ids

// 2 K and 2 V tiles of head dim D (rows padded by 8 elements), and at D = 256
// the block's q tile
template <int D>
constexpr int smem_bytes() {
  return (D == 128 ? 4 : 5) * kBlockN * (D + 8) * (int)sizeof(bf16);
}

// grid (ceil(Tq / kBlockM), H, B); dynamic shared memory smem_bytes<kD>() (+
// kSegSmemBytes in the segment form). kMask: kCausal and/or kSegment bits, 0
// for the unmasked form; seg [B, T] int32 and ranges [B, ceil(T / 64)] (the
// pre-pass's) are read by the segment form only; ``visits``, when not null,
// gets the number of key tiles the block walked (masked forms).
template <int kD, bool kLse, int kMask>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int H, float scale_log2,
                 const int* __restrict__ seg, const int2* __restrict__ ranges,
                 int* __restrict__ visits) {
  constexpr int kLd = kD + 8;  // shared-memory row stride in elements
  constexpr bool kQInRegs = kD == 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typedef bf16 Tile[kBlockN][kLd];
  Tile* ks = reinterpret_cast<Tile*>(smem_raw);  // [2] tiles of K
  Tile* vs = ks + 2;                             // [2] tiles of V
  Tile* qs = vs + 2;                             // the q tile (D = 256)
  int* kseg = reinterpret_cast<int*>(kQInRegs ? (void*)(vs + 2) : (void*)(qs + 1));
  // [2][kBlockN] key ids (segment form)
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

  // this warp's 16 query rows as A fragments: rows r0 = g, r1 = g + 8; at
  // D = 256 the q tile goes to shared memory with the first K / V tile
  const int r0 = blockIdx.x * kBlockM + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[kQInRegs ? kD / 16 : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int s = 0; s < kD / 16; ++s) {
      const int d = s * 16 + tg * 2;
      qa[s][0] = r0 < Tq ? ld32(qb + r0 * ld + d) : 0u;
      qa[s][1] = r1 < Tq ? ld32(qb + r1 * ld + d) : 0u;
      qa[s][2] = r0 < Tq ? ld32(qb + r0 * ld + d + 8) : 0u;
      qa[s][3] = r1 < Tq ? ld32(qb + r1 * ld + d + 8) : 0u;
    }
  } else {
    const int q0 = blockIdx.x * kBlockM;
#pragma unroll
    for (int i = 0; i < kBlockM * (kD / 8) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kD / 8), c8 = (e % (kD / 8)) * 8;
      const bool valid = q0 + r < Tq;
      cp_async16(&qs[0][r][c8], qb + (valid ? q0 + r : 0) * ld + c8, valid);
    }
  }

  float oacc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) oacc[t][0] = oacc[t][1] = oacc[t][2] = oacc[t][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running row maxima (log2 units)
  float l0 = 0.f, l1 = 0.f;                      // this lane's share of the row sums

  // the segment ids of this thread's two rows and of the batch row
  const int* sb = (kMask & kSegment) ? seg + (int64_t)b * Tq : nullptr;
  const int sq0 = (kMask & kSegment) && r0 < Tq ? sb[r0] : 0;
  const int sq1 = (kMask & kSegment) && r1 < Tq ? sb[r1] : 0;

  // start the copy of the K and V tile at key kt0 (and its key ids) into buffer buf
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
    if ((kMask & kSegment) && tid < kBlockN) {
      const bool valid = kt0 + tid < Tk;
      cp_async4(reinterpret_cast<float*>(kseg + buf * kBlockN + tid),
                reinterpret_cast<const float*>(sb + (valid ? kt0 + tid : 0)), valid);
    }
  };

  // the key tiles this block walks: all of them unmasked; for the masked
  // forms those that can hold a kept pair (flash_mask.cuh)
  const int ntiles = (Tk + kBlockN - 1) / kBlockN;
  const TileWalk<kMask> walk((kMask & kSegment) ? ranges + (int64_t)b * ntiles : nullptr,
                             blockIdx.x, ntiles, false);
  int cur = walk.next(walk.first);
  if (cur <= walk.last) load_tile(0, cur * kBlockN);
  cp_async_commit();
  int it = 0;
  for (; cur <= walk.last; ++it) {
    const int buf = it & 1, kt = cur * kBlockN;
    const int nxt = walk.next(cur + 1);
    // the other buffer's readers finished at the end of the last iteration
    if (nxt <= walk.last) load_tile(buf ^ 1, nxt * kBlockN);
    cp_async_commit();   // an empty group after the last tile keeps the count uniform
    cp_async_wait<1>();  // all but the newest group: this tile has landed
    __syncthreads();
    const bool masked = kMask != 0 && walk.needs_mask(cur, blockIdx.x);

    // S = q k^T for 16 rows x 64 keys: 8 accumulator tiles of 16 x 8
    float sacc[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
      sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kD / 32; ++s2) {  // 32 of d: the fragments of two steps
      uint32_t a0[4], a1[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a0[e] = qa[2 * s2][e];
          a1[e] = qa[2 * s2 + 1][e];
        }
      } else {
        const bf16* ap = &qs[0][warp * 16 + (lmat & 1) * 8 + lrow][s2 * 32 + (lmat >> 1) * 8];
        ldmatrix_x4(a0, ap);
        ldmatrix_x4(a1, ap + 16);
      }
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &ks[buf][nt * 8 + lrow][s2 * 32 + lmat * 8]);
        mma_bf16(sacc[nt], a0, kf[0], kf[1]);
        mma_bf16(sacc[nt], a1, kf[2], kf[3]);
      }
    }

    // scale, mask the keys past Tk (and, on a tile that needs it, the pairs
    // the mask drops), row maxima
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + nt * 8 + tg * 2 + (e & 1);
        bool keep = key < Tk;
        if (kMask != 0 && masked) {
          const int sk = (kMask & kSegment) ? kseg[buf * kBlockN + key - kt] : 0;
          keep = keep && flash_mask::keep_pair<kMask>(e < 2 ? r0 : r1, e < 2 ? sq0 : sq1,
                                                      key, sk);
        }
        sacc[nt][e] = keep ? sacc[nt][e] * scale_log2 : -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(sacc[nt][0], sacc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[nt][2], sacc[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // unmasked, every tile holds at least one key below Tk, so the new maxima
    // are finite; masked, a row may have kept nothing yet: exp2 against 0 then
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mr0 = kMask != 0 && mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float mr1 = kMask != 0 && mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - mr0), alpha1 = exp2f(m1 - mr1);
    m0 = mn0;
    m1 = mn1;

    // p = exp2(s - m), rounded to bf16 as the A fragments of P @ V
    uint32_t pa[kBlockN / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      const float p0 = exp2f(sacc[nt][0] - mr0), p1 = exp2f(sacc[nt][1] - mr0);
      const float p2 = exp2f(sacc[nt][2] - mr1), p3 = exp2f(sacc[nt][3] - mr1);
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
    cur = nxt;
  }
  if (kMask != 0 && visits != nullptr && tid == 0) atomicAdd(visits, it);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (kLse && tg == 0) {  // log(sum_j exp(scale * s_j)) = (m + log2(l)) * ln(2)
    float* lb = lse + ((int64_t)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = (m0 + log2f(l0)) * 0.6931471805599453f;
    if (r1 < Tq) lb[r1] = (m1 + log2f(l1)) * 0.6931471805599453f;
  }
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

template <int kD, bool kLse, int kMask>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int Tq, int Tk, int H, float scale, const int* seg,
               const int2* ranges, int* visits, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<kD, kLse, kMask>;
  const int smem = smem_bytes<kD>() + ((kMask & kSegment) ? kSegSmemBytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBlockM - 1) / kBlockM, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, Tq,
      Tk, H, scale * 1.4426950408889634f, seg, ranges, visits);
  return (int)cudaGetLastError();
}

// The masked forms: ``causal`` and / or ``seg`` (not null) pick the
// instantiation; the segment form runs the range pre-pass into ``ranges``.
template <int kD, bool kLse>
int launch_fwd_masked(const void* q, const void* k, const void* v, void* o, void* lse,
                      const int* seg, int2* ranges, int* visits, int B, int T, int H,
                      bool causal, float scale, cudaStream_t stream) {
  if (seg != nullptr) {
    const cudaError_t err = flash_mask::launch_seg_tile_ranges(seg, ranges, B, T, stream);
    if (err != cudaSuccess) return (int)err;
    return causal ? launch_fwd<kD, kLse, kCausal | kSegment>(q, k, v, o, lse, B, T, T, H,
                                                             scale, seg, ranges, visits, stream)
                  : launch_fwd<kD, kLse, kSegment>(q, k, v, o, lse, B, T, T, H, scale, seg,
                                                   ranges, visits, stream);
  }
  if (!causal) return (int)cudaErrorInvalidValue;  // the unmasked form has its own entry
  return launch_fwd<kD, kLse, kCausal>(q, k, v, o, lse, B, T, T, H, scale, nullptr, nullptr,
                                       visits, stream);
}

// Call ``fn`` with the head dim as a template argument (std::integral_constant).
template <typename Fn>
int with_head_dim(int D, Fn fn) {
  if (D == 128) return fn(std::integral_constant<int, 128>());
  if (D == 256) return fn(std::integral_constant<int, 256>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes): each launches on the given
// stream, does not synchronise, returns the launch's cudaError_t. ``D`` is
// the head dim, 128 or 256 (any other: cudaErrorInvalidValue).
extern "C" {

int mhla_flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
                   int Tq, int Tk, int H, int D, float scale, void* stream) {
  if (Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    return launch_fwd<decltype(d)::value, false, 0>(q, k, v, o, nullptr, B, Tq, Tk, H, scale,
                                                    nullptr, nullptr, nullptr,
                                                    (cudaStream_t)stream);
  });
}

// The training form: also writes lse [B, H, Tq] float32.
int mhla_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int Tq, int Tk, int H, int D, float scale,
                       void* stream) {
  if (Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    return launch_fwd<decltype(d)::value, true, 0>(q, k, v, o, lse, B, Tq, Tk, H, scale,
                                                   nullptr, nullptr, nullptr,
                                                   (cudaStream_t)stream);
  });
}

// The causal and / or segment-id forms, Tq == Tk == T: ``seg`` [B, T] int32 or
// null, ``ranges`` int32 scratch [B, ceil(T / 64), 2] (segment form),
// ``visits`` null or an int32 that gets the number of walked tiles added;
// ``lse`` null for the serving form.
int mhla_flash_fwd_masked(const void* q, const void* k, const void* v, void* o, void* lse,
                          const void* seg, void* ranges, void* visits, int B, int T, int H,
                          int D, int causal, float scale, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    auto launch = lse != nullptr ? launch_fwd_masked<kD, true> : launch_fwd_masked<kD, false>;
    return launch(q, k, v, o, lse, (const int*)seg, (int2*)ranges, (int*)visits, B, T, H,
                  causal != 0, scale, (cudaStream_t)stream);
  });
}

}  // extern "C"
