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
// segment-id range misses its own (a small pre-pass writes the range of
// every 64 tokens); the per-element mask is applied only on the tiles that
// need it. Every row keeps at least itself, so its maximum and lse are
// finite; a row that keeps nothing in a walked tile takes exp2 against 0
// there instead of its still infinite running maximum. JAX's padding to a
// block multiple and its -1 / -2 pad ids are not carried over: bounds checks
// do their work.
//
// Replaces the JAX library's Pallas TPU flash kernel that
// mhla_tpu/kernels/flash_attention.py:59-63,115-118 calls for long queries
// (the video model's text cross-attention: Tq = 31,500, Tk = 512; its softmax
// self-attention at 31,500; the LM's softmax layers from 2,048 tokens on, at
// head dim 256 when a hybrid keeps the LM's 4 heads). That wrapper zero-pads
// both lengths to its block sizes and masks the padding with segment ids
// (flash_attention.py:69-104); here bounds checks do both jobs: query rows
// past Tq are never stored, and keys past Tk get a score of -inf before the
// softmax, so they receive no probability mass.
//
// Bound: operations. 4*Tq*Tk*D FLOP per batch row and head against
// 2*(2*Tq + 2*Tk)*D bytes: Tk/2 = 256 FLOP/byte at Tk = 512 and Tq >> Tk,
// at the card's bf16 ridge (989 TFLOP/s over 3.35 TB/s = 295 FLOP/byte)
// and above it for self-attention lengths, whatever D.
//
// Design (hopper.cuh has the primitives): the [Tq, Tk] scores never reach
// device memory, and only wgmma reaches the tensor cores' full rate. A block
// of three warpgroups owns 128 query rows of one (batch row, head).
// Warpgroup 0 is the producer: one thread loads the q tile once and the K
// and V tiles of the walk by TMA into a ring of two shared-memory stages,
// each guarded by a full and an empty mbarrier; the warpgroup hands its
// registers to the consumers (setmaxnreg 24 / 240). Warpgroups 1 and 2
// consume, 64 query rows each: S = q k^T is a wgmma with both operands in
// shared memory (K-major), the online softmax runs on the accumulator
// fragments in registers (a row lives in the 4 lanes of a quad: two shuffles
// reduce it), the probabilities are rounded to bf16 and reused in place as
// the register A operand of O += P V, whose B operand is the V tile read
// MN-major; the float32 O is rescaled by exp2(m_old - m_new) per row between
// the two products (hence a wgmma fence before P V), and divided by the row
// sum once at the end. Key tiles: 128 keys at D = 128 (q 32 KB + 2 stages of
// K and V 128 KB), 64 at D = 256 (q 64 KB + 128 KB): one block per SM, eight
// consumer warps. The causal forms start their grid at the last query block
// (the longest walk). In the segment forms a producer warp copies each key
// tile's ids into shared memory beside it; the walk's range tests run 32
// tiles at a time on a warp's lanes. Not done: overlapping one warpgroup's
// softmax with the other's products, or the next tile's S with this tile's
// P V.
// Registers (-Xptxas -v, nvcc 12.9): 168 a thread at launch, no spills and
// no serialized wgmma in any of the 16 instantiations.

#include <math_constants.h>

#include <type_traits>

#include "flash_mask.cuh"
#include "hopper.cuh"

using namespace hopper;
using flash_mask::TileWalk;
using flash_mask::kCausal;
using flash_mask::kSegment;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 128;  // query rows per block: 64 per consumer warpgroup
constexpr int kThreads = 384;
constexpr int kStages = 2;

template <int kD>
struct FwdGeom {
  static constexpr int kBlockN = kD == 128 ? 128 : 64;  // keys per tile
  static constexpr int kQBytes = kBlockM * kD * 2;
  static constexpr int kKVBytes = kBlockN * kD * 2;  // one K or V tile
  static constexpr int kSegBytes = kStages * kBlockN * 4;  // key ids (segment forms)
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + kSegBytes + 1024 + 64;
};

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (ceil(Tq / 128), H, B), 384 threads, dynamic shared memory
// FwdGeom<kD>::kSmem. kMask: kCausal and/or kSegment bits, 0 for the
// unmasked form; seg [B, T] int32 and ranges [B, ceil(T / 64)] (the
// pre-pass's) are read by the segment form only; ``visits``, when not null,
// gets the number of key tiles the block walked (masked forms). The maps
// are those of q (boxes of 128 rows), k and v (kBlockN rows).
template <int kD, bool kLse, int kMask>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int H, float scale_log2,
                 const int* __restrict__ seg, const int2* __restrict__ ranges,
                 int* __restrict__ visits) {
  typedef FwdGeom<kD> G;
  constexpr int kBlockN = G::kBlockN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  auto kst = [&](int s) { return smem + G::kQBytes + s * G::kKVBytes; };
  auto vst = [&](int s) { return smem + G::kQBytes + (kStages + s) * G::kKVBytes; };
  int* kseg = reinterpret_cast<int*>(smem + G::kQBytes + 2 * kStages * G::kKVBytes);  // [stage][key]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::kQBytes + 2 * kStages * G::kKVBytes +
                                               G::kSegBytes);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int b = blockIdx.z, h = blockIdx.y;
  const int* sb = (kMask & kSegment) ? seg + (int64_t)b * Tq : nullptr;
  // the causal forms' longest walks first
  const int qblk = (kMask & kCausal) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qblk * kBlockM;
  // the key tiles this block walks: all of them unmasked; for the masked
  // forms those that can hold a kept pair (flash_mask.cuh)
  const TileWalk<kMask, kBlockM, kBlockN, false> walk(
      (kMask & kSegment) ? ranges + (int64_t)b * ((Tk + 63) / 64) : nullptr, qblk,
      kMask ? Tq : Tk);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread, and in the segment forms the 32 key-id copiers
      mbar_init(&full[s], (kMask & kSegment) ? 1 + 32 : 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread releases the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    regs_dec<24>();
    // warp 0 walks the tiles, its lane 0 loading them; in the segment forms
    // warp 1 walks beside it, copying each tile's key ids
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0 || ((kMask & kSegment) && warp == 1)) {
      if (warp == 0 && lane == 0) {
        mbar_arrive_expect_tx(bar_q, G::kQBytes);
        tma_load_tile<kD, kBlockM>(qs, &map_q, bar_q, q0, h, b);
      }
      int stage = 0, n = 0;
      uint32_t phase = 0;
      for (int j = walk.next(walk.first); j <= walk.last; j = walk.next(j + 1), ++n) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (warp == 0) {
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[stage], 2 * G::kKVBytes);
            tma_load_tile<kD, kBlockN>(kst(stage), &map_k, &full[stage], j * kBlockN, h, b);
            tma_load_tile<kD, kBlockN>(vst(stage), &map_v, &full[stage], j * kBlockN, h, b);
          }
        } else {
#pragma unroll
          for (int i = lane; i < kBlockN; i += 32) {
            const int key = j * kBlockN + i;
            kseg[stage * kBlockN + i] = key < Tk ? sb[key] : 0;
          }
          mbar_arrive(&full[stage]);
        }
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
      if (kMask != 0 && visits != nullptr && threadIdx.x == 0) atomicAdd(visits, n);
    }
  } else {  // the consumer warpgroups, 64 query rows each
    regs_inc<240>();
    const int wg = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tg = lane & 3;  // fragment row group, column pair
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    const int sq0 = (kMask & kSegment) && r0 < Tq ? sb[r0] : 0;
    const int sq1 = (kMask & kSegment) && r1 < Tq ? sb[r1] : 0;

    float oacc[kD / 8][4];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running row maxima (log2 units)
    float l0 = 0.f, l1 = 0.f;                      // this lane's share of the row sums

    mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = walk.next(walk.first); j <= walk.last; j = walk.next(j + 1)) {
      const int kt = j * kBlockN;
      const bool masked = kMask != 0 && walk.needs_mask(j);
      const bool tail = kt + kBlockN > Tk;
      mbar_wait(&full[stage], phase);
      const unsigned char* ks = kst(stage);
      const unsigned char* vs = vst(stage);

      // S = q k^T for 64 rows x kBlockN keys
      float sacc[kBlockN / 8][4];
      const uint64_t dq0 = desc_kmajor(qs, wg * 64), dk0 = desc_kmajor(ks, 0);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kD / 16; ++s)
        wgmma_ss(sacc, dq0 + kstep_kmajor<kBlockM>(s), dk0 + kstep_kmajor<kBlockN>(s), s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);

      // scale, mask the keys past Tk (and, on a tile that needs it, the pairs
      // the mask drops), row maxima
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt + nt * 8 + tg * 2 + (e & 1);
          bool keep = !tail || key < Tk;
          if (kMask != 0 && masked) {
            const int sk = (kMask & kSegment) ? kseg[stage * kBlockN + key - kt] : 0;
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
      for (int i = 0; i < kD / 8; ++i) {
        oacc[i][0] *= alpha0;
        oacc[i][1] *= alpha0;
        oacc[i][2] *= alpha1;
        oacc[i][3] *= alpha1;
      }
      const uint64_t dv0 = desc_mnmajor<kBlockN>(vs);
      wgmma_fence();  // the rescaled accumulator was written by ordinary code
#pragma unroll
      for (int s = 0; s < kBlockN / 16; ++s) wgmma_rs(oacc, pa[s], dv0 + kstep_mnmajor(s), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(oacc);
      fence_frag(pa);
      mbar_arrive(&empty[stage]);  // this stage's tiles are no longer read
      if (++stage == kStages) stage = 0, phase ^= 1;
    }

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
    const int64_t ld = (int64_t)H * kD;
    bf16* ob = o + (int64_t)b * Tq * ld + h * kD;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      const int d = i * 8 + tg * 2;
      if (r0 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * ld + d) =
            __floats2bfloat162_rn(oacc[i][0] * inv0, oacc[i][1] * inv0);
      if (r1 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * ld + d) =
            __floats2bfloat162_rn(oacc[i][2] * inv1, oacc[i][3] * inv1);
    }
  }
}

template <int kD, bool kLse, int kMask>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Tq,
               int Tk, int H, float scale, const int* seg, const int2* ranges, int* visits,
               cudaStream_t stream) {
  typedef FwdGeom<kD> G;
  CUtensorMap mq, mk, mv;
  int err = hopper_host::make_tile_map(&mq, q, B, Tq, H, kD, kBlockM);
  if (!err) err = hopper_host::make_tile_map(&mk, k, B, Tk, H, kD, G::kBlockN);
  if (!err) err = hopper_host::make_tile_map(&mv, v, B, Tk, H, kD, G::kBlockN);
  if (err) return err;
  auto kern = flash_fwd_kernel<kD, kLse, kMask>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       G::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + kBlockM - 1) / kBlockM, H, B);
  kern<<<grid, kThreads, G::kSmem, stream>>>(mq, mk, mv, (bf16*)o, (float*)lse, Tq, Tk, H,
                                             scale * 1.4426950408889634f, seg, ranges, visits);
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
