// K9b: flash-attention backward for Hopper (sm_90a), head dim 128 or 256.
//
// With S = scale * q k^T, P = exp(S - lse) and delta_i = sum_d dO[i, d] O[i, d]:
//
//   dV = P^T dO          dP = dO V^T          dS = P * (dP - delta)
//   dQ = scale * dS K    dK = scale * dS^T Q
//
// q, o, dO, dq: [B, Tq, H, D]; k, v, dk, dv: [B, Tk, H, D], bf16, D = 128 or 256;
// lse [B, H, Tq] float32 from the forward (flash_fwd.cu, natural log);
// delta [B, H, Tq] float32 scratch. Any Tq and Tk >= 1. Scores, P, dP and all
// sums are float32; P is rounded to bf16 before P^T dO and before dS, and dS
// is rounded to bf16 before its two products (the operands of the tensor
// cores), once each.
//
// Replaces the JAX library's Pallas TPU flash backward (its dq and dkv
// kernels), which jax.grad reaches through
// mhla_tpu/kernels/flash_attention.py:115-118 with the block sizes of :109-114.
//
// Bound: operations. 10*Tq*Tk*D FLOP per batch row and head (five
// products) against 2*(4*Tq + 4*Tk)*D bytes: far above the card's bf16
// ridge (295 FLOP/byte) at both of the video model's shapes and at the
// LM's causal 2,048 to 16,384 tokens.
//
// Design (hopper.cuh has the primitives): three launches and no atomics, so
// the result is the same from run to run. (1) delta: one warp per (token,
// head) row. (2) dK, dV: a block of three
// warpgroups owns 64 keys of one (batch row, head) and walks over the
// queries 128 at a time at D = 128, 64 at D = 256 (where the accumulator
// leaves no registers for more). Warpgroup 0 produces: one thread loads the
// block's K and V tiles once and the Q and dO tiles of the walk by TMA into
// a ring of two stages, 96 of its threads copy the tiles' lse, delta (and
// query ids) beside them; then it hands its registers over (setmaxnreg
// 24 / 240).
// The two consumer warpgroups share the same 64 keys and split the work:
// warpgroup 1 computes S^T = K Q^T (wgmma, both operands K-major in shared
// memory), forms P^T in registers, hands it to warpgroup 2 as bf16 through
// 16 or 8 KB of shared memory under a named barrier, and accumulates dV += P^T dO
// (register A operand, dO read MN-major); warpgroup 2 computes dP^T = V dO^T
// meanwhile, forms dS^T = P^T * (dP^T - delta) and accumulates dK += dS^T Q.
// Each thread holds one [64 x D] accumulator (D / 2 float32 registers), so
// both head dims take the backward's four products here without splitting
// the walk. (3) dQ: the mirror image of the forward: a block owns 64 query
// rows per consumer warpgroup (two at D = 128, one at D = 256 for shared
// memory: q and dO 64 KB, two stages of K and V 128 KB), loads Q and dO
// once and walks the key tiles of 64: S = Q K^T and dP = dO V^T (both
// K-major), then dS, then dQ += dS K with K read MN-major. The scores and dP
// are computed in both kernels: seven products for the backward's five, the
// price of needing no reduction across blocks. Rows and columns past Tq and
// Tk are zero-filled by TMA, get P = 0, and are never stored. At Tk = 512
// the dK/dV kernel has only 8 key blocks per head to spread over the card;
// splitting its query range is not done.
// Registers (-Xptxas -v, nvcc 12.9): 168 a thread at launch for the
// three-warpgroup kernels, 224-230 for the dQ kernel at D = 256; the masked
// dK/dV kernels spill 4-36 bytes, the others none; no serialized wgmma.
//
// Masked forms (Tq == Tk == T; causal and / or segment ids, the rule in
// flash_mask.cuh; the backward of the same library kernel called with
// causal=True and/or SegmentIds, flash_attention.py:73-104): the same three
// launches after the forward's range pre-pass, each walk cut to the tiles
// that can hold a kept pair, read from the key side in the dK/dV kernel. On
// the tiles that need it a dropped pair gets P = 0 by selection (a dropped
// score may lie far above lse): its exponent is -inf, so exp2 gives 0 with
// no branch, in every form (a select around exp2 compiled to a divergent
// branch per element in the radial form and doubled the time a tile took
// there).
//
// K10b, the radial form (Tq == Tk == T in frames of hw tokens, head dim 128;
// the rule in flash_common.cuh, the lists in flash_mask.cuh): replaces the
// fused backward of the JAX library's Pallas TPU splash-attention kernel,
// which jax.grad of the radial attention reaches through
// mhla_tpu/kernels/sparse_attention.py:507-517 (built at :137-166; that
// kernel walks 512 x 512 blocks and streams a stored boolean mask for every
// block the band crosses, none of which is carried over). lse is the
// forward's training form's (radial_fwd.cu), over the allowed keys.
// Bound: operations. 10 * 128 FLOP per allowed pair per (batch row, head)
// against 2 * 8 * T * 128 bytes: far above the bf16 ridge at video lengths.
// Walk: the same three launches and kernels, each walk cut to the tiles of
// its own list (kernels/sparse_attention.py's radial_schedule, cached on the
// device per geometry): a dQ block of 128 queries walks the 64-key tiles of
// radial_schedule(T, frames, 128, 64); a dK/dV block of 64 keys walks the
// 128-query tiles of radial_schedule(T, frames, 64, 128), read from the key
// side (the mask is symmetric: the 128-query tiles a 64-key block meets are
// the 128-key tiles a 64-query block meets, and an entry's `full` reads the
// same). On a tile not marked full a pair is kept by index arithmetic: the
// frame and spatial index of a thread's two rows once per kernel; per tile,
// the windows of the (at most two) frames its columns span, and from them a
// bit per column of the thread, outside the loop that forms P. A row below
// T always keeps its own frame, so lse is finite wherever it is read.
// Its two kernels are named radial_bwd_dkv_kernel and radial_bwd_dq_kernel
// (thin wrappers of the same bodies), so a trace tells K10b from K9b.
// Order: the lists differ in length (a tile of a middle frame meets more
// tiles than one at either end, up to about 2.3x at the video geometry), so
// block x of a head takes the x-th longest list (`order`, cached with the
// lists): a head's longest walks start first, its short ones run beside the
// next head's long ones, and the last wave holds the shortest. The grid
// stays (blocks, H, B), a head's blocks together, so the 16 MB of a head's
// Q and dO (K and V for dQ) that they all walk stay in L2.


#include <math_constants.h>

#include "flash_common.cuh"
#include "flash_mask.cuh"
#include "hopper.cuh"

using namespace hopper;
using flash::bf16;
using flash::pack2f;
using flash::unpack2f;
using flash_mask::RadialList;
using flash_mask::kCausal;
using flash_mask::kRadial;
using flash_mask::kSegment;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;
constexpr int kDeltaThreads = 128;
constexpr int kTileRows = 64;  // keys of a dK/dV block and of a dQ step
constexpr int kBarPFull = 1, kBarPEmpty = 2;  // named barriers of the P^T hand-over

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]; one warp per row of
// the [B*Tq*H, D] views. grid ceil(rows / 4), kDeltaThreads threads.
template <int kD>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int Tq, int H) {
  constexpr int kPer = kD / 32;  // elements per lane: 4 or 8
  const int64_t row = (int64_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  uint32_t a[kPer / 2], c[kPer / 2];
  if constexpr (kPer == 4) {
    const uint2 ra = *reinterpret_cast<const uint2*>(o + row * kD + lane * kPer);
    const uint2 rc = *reinterpret_cast<const uint2*>(dout + row * kD + lane * kPer);
    a[0] = ra.x, a[1] = ra.y, c[0] = rc.x, c[1] = rc.y;
  } else {
    const uint4 ra = *reinterpret_cast<const uint4*>(o + row * kD + lane * kPer);
    const uint4 rc = *reinterpret_cast<const uint4*>(dout + row * kD + lane * kPer);
    a[0] = ra.x, a[1] = ra.y, a[2] = ra.z, a[3] = ra.w;
    c[0] = rc.x, c[1] = rc.y, c[2] = rc.z, c[3] = rc.w;
  }
  const float2 a0 = unpack2f(a[0]), a1 = unpack2f(a[1]);
  const float2 c0 = unpack2f(c[0]), c1 = unpack2f(c[1]);
  float s = a0.x * c0.x + a0.y * c0.y + a1.x * c1.x + a1.y * c1.y;
#pragma unroll
  for (int i = 2; i < kPer / 2; i += 2) {
    const float2 x0 = unpack2f(a[i]), x1 = unpack2f(a[i + 1]);
    const float2 y0 = unpack2f(c[i]), y1 = unpack2f(c[i + 1]);
    s += x0.x * y0.x + x0.y * y0.y + x1.x * y1.x + x1.y * y1.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const int64_t bi = row / H;
    const int64_t i = bi % Tq, b = bi / Tq;
    delta[(b * H + h) * Tq + i] = s;
  }
}

// Round a [64 x D] float32 accumulator of a warpgroup times ``scale`` to
// bf16 and store its rows r0 and r0 + 8 (below ``limit``) of [*, H*D].
template <int kD>
__device__ __forceinline__ void store_acc(bf16* dst, int64_t ld, const float (&acc)[kD / 8][4],
                                          float scale, int r0, int limit, int tg) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    const int d = i * 8 + tg * 2;
    if (r0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * ld + d) =
          __floats2bfloat162_rn(acc[i][0] * scale, acc[i][1] * scale);
    if (r1 < limit)
      *reinterpret_cast<__nv_bfloat162*>(dst + r1 * ld + d) =
          __floats2bfloat162_rn(acc[i][2] * scale, acc[i][3] * scale);
  }
}

template <int kD>
struct DkvGeom {
  // queries per step of the walk: 128 at D = 128; at D = 256 the
  // accumulator leaves registers for 64
  static constexpr int kQT = kD == 128 ? 128 : 64;
  static constexpr int kKVBytes = kTileRows * kD * 2;  // the block's K or V
  static constexpr int kQBytes = kQT * kD * 2;         // a Q or dO tile
  // K, V; stages of Q, dO; stages of lse, delta, query ids; the P^T hand-over
  static constexpr int kStatBytes = kStages * 3 * kQT * 4;
  static constexpr int kPBytes = kQT / 4 * 128 * 4;
  static constexpr int kSmem =
      2 * kKVBytes + 2 * kStages * kQBytes + kStatBytes + kPBytes + 1024 + 64;
};

// dK and dV. grid (ceil(Tk / 64), H, B), 384 threads, dynamic shared memory
// DkvGeom<kD>::kSmem.
// The maps of k and v have boxes of 64 rows, those of q and dO of
// DkvGeom<kD>::kQT. kMask as in the forward, or kRadial (``list``: each key
// block's query tiles); ``visits``, when not null, gets the number of query
// tiles the block walked (masked forms).
template <int kD, int kMask>
__device__ __forceinline__ void dkv_block(
    const CUtensorMap& map_q, const CUtensorMap& map_k, const CUtensorMap& map_v,
    const CUtensorMap& map_do, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, const int2* __restrict__ ranges, const RadialList list,
    int* __restrict__ visits, bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int H,
    float scale_log2, float scale) {
  typedef DkvGeom<kD> G;
  constexpr int kQT = G::kQT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kst = smem;
  unsigned char* vst = smem + G::kKVBytes;
  auto qst = [&](int s) { return smem + 2 * G::kKVBytes + s * G::kQBytes; };
  auto dost = [&](int s) { return smem + 2 * G::kKVBytes + (kStages + s) * G::kQBytes; };
  float* stat = reinterpret_cast<float*>(smem + 2 * G::kKVBytes + 2 * kStages * G::kQBytes);
  // stage s: lse * log2(e) at stat[s][0], delta at [s][1], query ids at [s][2]
  auto stat_of = [&](int s, int which) { return stat + (s * 3 + which) * kQT; };
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(stat) +
                                               G::kStatBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(pbuf) +
                                               G::kPBytes);
  uint64_t* bar_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  // the radial form takes a head's key blocks longest list first
  const int b = blockIdx.z, h = blockIdx.y;
  const int own = (kMask & kRadial) ? list.order[blockIdx.x] : blockIdx.x;
  const int k0 = own * kTileRows;
  const int* sb = (kMask & kSegment) ? seg + (int64_t)b * Tq : nullptr;
  const auto walk = flash_mask::make_walk<kMask, kTileRows, kQT, true>(
      (kMask & kSegment) ? ranges + (int64_t)b * ((Tq + 63) / 64) : nullptr, list, own,
      kMask ? Tk : Tq);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 96);  // the TMA thread and the 96 stat copiers
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int tid = threadIdx.x;
  if (tid < 128) {  // the producer warpgroup
    regs_dec<24>();
    // warp 0 walks the tiles, its lane 0 loading them; warps 1 to 3 walk
    // beside it, copying each tile's statistics
    {
      const float* lb = lse + ((int64_t)b * H + h) * Tq;
      const float* db = delta + ((int64_t)b * H + h) * Tq;
      if (tid == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * G::kKVBytes);
        tma_load_tile<kD, kTileRows>(kst, &map_k, bar_kv, k0, h, b);
        tma_load_tile<kD, kTileRows>(vst, &map_v, bar_kv, k0, h, b);
      }
      int stage = 0, n = 0;
      uint32_t phase = 0;
      for (int i = walk.next(walk.first); i <= walk.last; i = walk.next(i + 1), ++n) {
        const int qt = walk.tile(i) * kQT;
        mbar_wait(&empty[stage], phase ^ 1);
        if (tid < 32) {
          if (tid == 0) {
            mbar_arrive_expect_tx(&full[stage], 2 * G::kQBytes);
            tma_load_tile<kD, kQT>(qst(stage), &map_q, &full[stage], qt, h, b);
            tma_load_tile<kD, kQT>(dost(stage), &map_do, &full[stage], qt, h, b);
          }
        } else {
          for (int j = tid - 32; j < kQT; j += 96) {
            const int q = qt + j;
            const bool valid = q < Tq;
            stat_of(stage, 0)[j] = valid ? lb[q] * kLog2e : 0.f;
            stat_of(stage, 1)[j] = valid ? db[q] : 0.f;
            if (kMask & kSegment)
              reinterpret_cast<int*>(stat_of(stage, 2))[j] = valid ? sb[q] : 0;
          }
          mbar_arrive(&full[stage]);
        }
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
      if (tid == 0 && kMask != 0 && visits != nullptr) atomicAdd(visits, n);
    }
    return;
  }

  // the consumers: warpgroup 1 S^T, P^T and dV; warpgroup 2 dP^T, dS^T and dK
  regs_inc<240>();
  const bool is_p = tid < 256;
  const int t = tid % 128;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;  // this thread's keys (rows of S^T)
  const int sk0 = (kMask & kSegment) && kr0 < Tk ? sb[kr0] : 0;
  const int sk1 = (kMask & kSegment) && kr1 < Tk ? sb[kr1] : 0;
  // radial form: the frame and spatial index of this thread's keys
  const int hw = kMask == kRadial ? list.hw : 1;
  const int2 key0 = kMask == kRadial ? make_int2(kr0 / hw, kr0 % hw) : make_int2(0, 0);
  const int2 key1 = kMask == kRadial ? make_int2(kr1 / hw, kr1 % hw) : make_int2(0, 0);

  float acc[kD / 8][4];  // dV (warpgroup 1) or dK (warpgroup 2)
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  mbar_wait(bar_kv, 0);
  int stage = 0, it = 0;
  uint32_t phase = 0;
  for (int i = walk.next(walk.first); i <= walk.last; ++it) {
    const int qt = walk.tile(i) * kQT;
    const int nxt = walk.next(i + 1);
    const bool masked = kMask != 0 && walk.needs_mask(i);
    const bool tail = qt + kQT > Tq;
    mbar_wait(&full[stage], phase);
    const unsigned char* qs = qst(stage);
    const unsigned char* dos = dost(stage);
    uint32_t pa[kQT / 16][4];  // P^T, then (warpgroup 2) dS^T, as A fragments over the queries
    float sacc[kQT / 8][4];
    if (is_p) {
      // S^T = K Q^T for 64 keys x kQT queries, then P^T: 0 for queries past
      // Tq and, on a masked tile, for dropped pairs
      const uint64_t da = desc_kmajor(kst, 0), db = desc_kmajor(qs, 0);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kD / 16; ++s)
        wgmma_ss(sacc, da + kstep_kmajor<kTileRows>(s), db + kstep_kmajor<kQT>(s), s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);
      const float* ls = stat_of(stage, 0);
      const int* ids = reinterpret_cast<const int*>(stat_of(stage, 2));
      // radial form: bit 2 nt + c of keep0 / keep1 says whether this
      // thread's query column nt * 8 + 2 tg + c is kept for its keys
      uint32_t keep0 = ~0u, keep1 = ~0u;
      if (kMask == kRadial && masked)
        flash_mask::radial_keep_bits<kQT / 8>(keep0, keep1, key0, key1, qt, tg, hw);
#pragma unroll
      for (int nt = 0; nt < kQT / 8; ++nt) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int off = nt * 8 + tg * 2 + c, col = qt + off;
          const float l = ls[off];
          bool ok0 = !tail || col < Tq, ok1 = ok0;
          if (kMask == kRadial) {
            ok0 = ok0 & ((keep0 >> (2 * nt + c)) & 1);
            ok1 = ok1 & ((keep1 >> (2 * nt + c)) & 1);
          } else if (kMask != 0 && masked) {
            const int sq = (kMask & kSegment) ? ids[off] : 0;
            ok0 = ok0 && flash_mask::keep_pair<kMask>(col, sq, kr0, sk0);
            ok1 = ok1 && flash_mask::keep_pair<kMask>(col, sq, kr1, sk1);
          }
          // dropped: exp2(-inf) = 0, with no branch
          p[c] = exp2f(ok0 ? fmaf(sacc[nt][c], scale_log2, -l) : -CUDART_INF_F);
          p[2 + c] = exp2f(ok1 ? fmaf(sacc[nt][2 + c], scale_log2, -l) : -CUDART_INF_F);
        }
        pa[nt / 2][(nt & 1) * 2 + 0] = pack2f(p[0], p[1]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack2f(p[2], p[3]);
      }
      // hand P^T over: thread t's fragment to thread t of warpgroup 2
      if (it > 0) named_sync(kBarPEmpty, 256);
#pragma unroll
      for (int r = 0; r < kQT / 4; ++r) pbuf[r * 128 + t] = pa[r / 4][r % 4];
      named_arrive(kBarPFull, 256);
      // dV += P^T dO
      const uint64_t dd = desc_mnmajor<kQT>(dos);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kQT / 16; ++s) wgmma_rs(acc, pa[s], dd + kstep_mnmajor(s), 1);
      wgmma_commit();
      wgmma_wait<0>();
    } else {
      // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta)
      const uint64_t da = desc_kmajor(vst, 0), db = desc_kmajor(dos, 0);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kD / 16; ++s)
        wgmma_ss(sacc, da + kstep_kmajor<kTileRows>(s), db + kstep_kmajor<kQT>(s), s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);
      named_sync(kBarPFull, 256);
#pragma unroll
      for (int r = 0; r < kQT / 4; ++r) pa[r / 4][r % 4] = pbuf[r * 128 + t];
      if (nxt <= walk.last) named_arrive(kBarPEmpty, 256);
      const float* dl = stat_of(stage, 1);
#pragma unroll
      for (int nt = 0; nt < kQT / 8; ++nt) {
        const int c0 = nt * 8 + tg * 2;
        const float d0 = dl[c0], d1 = dl[c0 + 1];
        uint32_t& lo = pa[nt / 2][(nt & 1) * 2 + 0];
        uint32_t& hi = pa[nt / 2][(nt & 1) * 2 + 1];
        const float2 pl = unpack2f(lo), ph = unpack2f(hi);
        lo = pack2f(pl.x * (sacc[nt][0] - d0), pl.y * (sacc[nt][1] - d1));
        hi = pack2f(ph.x * (sacc[nt][2] - d0), ph.y * (sacc[nt][3] - d1));
      }
      // dK += dS^T Q
      const uint64_t dd = desc_mnmajor<kQT>(qs);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kQT / 16; ++s) wgmma_rs(acc, pa[s], dd + kstep_mnmajor(s), 1);
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_acc(acc);
    fence_frag(pa);
    mbar_arrive(&empty[stage]);
    if (++stage == kStages) stage = 0, phase ^= 1;
    i = nxt;
  }

  const int64_t ld = (int64_t)H * kD;
  bf16* dst = (is_p ? dv : dk) + (int64_t)b * Tk * ld + h * kD;
  store_acc<kD>(dst, ld, acc, is_p ? 1.f : scale, kr0, Tk, tg);
}
// K9b's dK/dV kernel by head dim and mask form, and K10b's (the radial form
// at head dim 128) under a name of its own, so that a trace tells them apart.
template <int kD, int kMask>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     const int2* __restrict__ ranges, const RadialList list,
                     int* __restrict__ visits, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int Tq, int Tk, int H, float scale_log2, float scale) {
  dkv_block<kD, kMask>(map_q, map_k, map_v, map_do, lse, delta, seg, ranges, list, visits, dk, dv,
                       Tq, Tk, H, scale_log2, scale);
}
__global__ void __launch_bounds__(384, 1)
radial_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int* __restrict__ seg,
                      const int2* __restrict__ ranges, const RadialList list,
                      int* __restrict__ visits, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int Tq, int Tk, int H, float scale_log2, float scale) {
  dkv_block<128, kRadial>(map_q, map_k, map_v, map_do, lse, delta, seg, ranges, list, visits, dk,
                          dv, Tq, Tk, H, scale_log2, scale);
}

template <int kD>
struct DqGeom {
  static constexpr int kWG = kD == 128 ? 2 : 1;  // consumer warpgroups, 64 query rows each
  static constexpr int kBlockM = 64 * kWG;
  static constexpr int kThreads = 128 * (1 + kWG);
  static constexpr int kQBytes = kBlockM * kD * 2;
  static constexpr int kKVBytes = kTileRows * kD * 2;
  static constexpr int kSegBytes = kStages * kTileRows * 4;  // key ids (segment forms)
  static constexpr int kSmem = 2 * kQBytes + 2 * kStages * kKVBytes + kSegBytes + 1024 + 64;
};

// dQ. grid (ceil(Tq / kBlockM), H, B), DqGeom<kD>::kThreads threads, dynamic
// shared memory DqGeom<kD>::kSmem. The maps of q and dO have boxes of kBlockM rows, those
// of k and v 64. ``list`` (radial form: each query block's key tiles) and
// ``visits`` as in the dK/dV kernel (key tiles).
template <int kD, int kMask>
__device__ __forceinline__ void dq_block(
    const CUtensorMap& map_q, const CUtensorMap& map_k, const CUtensorMap& map_v,
    const CUtensorMap& map_do, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, const int2* __restrict__ ranges, const RadialList list,
    int* __restrict__ visits, bf16* __restrict__ dq, int Tq, int Tk, int H, float scale_log2,
    float scale) {
  typedef DqGeom<kD> G;
  constexpr int kBlockM = G::kBlockM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qsm = smem;
  unsigned char* dosm = smem + G::kQBytes;
  auto kst = [&](int s) { return smem + 2 * G::kQBytes + s * G::kKVBytes; };
  auto vst = [&](int s) { return smem + 2 * G::kQBytes + (kStages + s) * G::kKVBytes; };
  int* kseg = reinterpret_cast<int*>(smem + 2 * G::kQBytes + 2 * kStages * G::kKVBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(kseg) +
                                               G::kSegBytes);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int b = blockIdx.z, h = blockIdx.y;
  const int qblk = (kMask & kRadial)   ? list.order[blockIdx.x]
                   : (kMask & kCausal) ? gridDim.x - 1 - blockIdx.x
                                       : blockIdx.x;
  const int q0 = qblk * kBlockM;
  const int* sb = (kMask & kSegment) ? seg + (int64_t)b * Tq : nullptr;
  const auto walk = flash_mask::make_walk<kMask, kBlockM, kTileRows, false>(
      (kMask & kSegment) ? ranges + (int64_t)b * ((Tk + 63) / 64) : nullptr, list, qblk,
      kMask ? Tq : Tk);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread, and in the segment forms the 32 key-id copiers
      mbar_init(&full[s], (kMask & kSegment) ? 1 + 32 : 1);
      mbar_init(&empty[s], G::kWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    if constexpr (G::kWG == 2) regs_dec<24>();
    // warp 0 walks the tiles, its lane 0 loading them; in the segment forms
    // warp 1 walks beside it, copying each tile's key ids
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0 || ((kMask & kSegment) && warp == 1)) {
      if (warp == 0 && lane == 0) {
        mbar_arrive_expect_tx(bar_q, 2 * G::kQBytes);
        tma_load_tile<kD, kBlockM>(qsm, &map_q, bar_q, q0, h, b);
        tma_load_tile<kD, kBlockM>(dosm, &map_do, bar_q, q0, h, b);
      }
      int stage = 0, n = 0;
      uint32_t phase = 0;
      for (int j = walk.next(walk.first); j <= walk.last; j = walk.next(j + 1), ++n) {
        const int kt = walk.tile(j) * kTileRows;
        mbar_wait(&empty[stage], phase ^ 1);
        if (warp == 0) {
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[stage], 2 * G::kKVBytes);
            tma_load_tile<kD, kTileRows>(kst(stage), &map_k, &full[stage], kt, h, b);
            tma_load_tile<kD, kTileRows>(vst(stage), &map_v, &full[stage], kt, h, b);
          }
        } else {
#pragma unroll
          for (int i = lane; i < kTileRows; i += 32) {
            const int key = kt + i;
            kseg[stage * kTileRows + i] = key < Tk ? sb[key] : 0;
          }
          mbar_arrive(&full[stage]);
        }
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
      if (kMask != 0 && visits != nullptr && threadIdx.x == 0) atomicAdd(visits, n);
    }
  } else {  // the consumer warpgroups, 64 query rows each
    if constexpr (G::kWG == 2) regs_inc<240>();
    const int wg = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    const float* lb = lse + ((int64_t)b * H + h) * Tq;
    const float* db = delta + ((int64_t)b * H + h) * Tq;
    const float l0 = r0 < Tq ? lb[r0] * kLog2e : 0.f, l1 = r1 < Tq ? lb[r1] * kLog2e : 0.f;
    const float d0 = r0 < Tq ? db[r0] : 0.f, d1 = r1 < Tq ? db[r1] : 0.f;
    const int sq0 = (kMask & kSegment) && r0 < Tq ? sb[r0] : 0;
    const int sq1 = (kMask & kSegment) && r1 < Tq ? sb[r1] : 0;
    // radial form: the frame and spatial index of this thread's queries
    const int hw = kMask == kRadial ? list.hw : 1;
    const int2 query0 = kMask == kRadial ? make_int2(r0 / hw, r0 % hw) : make_int2(0, 0);
    const int2 query1 = kMask == kRadial ? make_int2(r1 / hw, r1 % hw) : make_int2(0, 0);

    float dqacc[kD / 8][4];
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) dqacc[i][0] = dqacc[i][1] = dqacc[i][2] = dqacc[i][3] = 0.f;

    mbar_wait(bar_q, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = walk.next(walk.first); j <= walk.last; j = walk.next(j + 1)) {
      const int kt = walk.tile(j) * kTileRows;
      const bool masked = kMask != 0 && walk.needs_mask(j);
      const bool tail = kt + kTileRows > Tk;
      mbar_wait(&full[stage], phase);
      const unsigned char* ks = kst(stage);
      const unsigned char* vs = vst(stage);

      // S = Q K^T and dP = dO V^T for 64 rows x 64 keys
      float sacc[8][4], dpacc[8][4];
      const uint64_t dq0 = desc_kmajor(qsm, wg * 64), dk0 = desc_kmajor(ks, 0);
      const uint64_t ddo0 = desc_kmajor(dosm, wg * 64), dv0 = desc_kmajor(vs, 0);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kD / 16; ++s)
        wgmma_ss(sacc, dq0 + kstep_kmajor<kBlockM>(s), dk0 + kstep_kmajor<kTileRows>(s), s > 0);
#pragma unroll
      for (int s = 0; s < kD / 16; ++s)
        wgmma_ss(dpacc, ddo0 + kstep_kmajor<kBlockM>(s), dv0 + kstep_kmajor<kTileRows>(s),
                 s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);
      fence_acc(dpacc);

      // P (0 for keys past Tk and dropped pairs), rounded to bf16, then
      // dS = P * (dP - delta) as A fragments
      uint32_t ds[4][4];
      // radial form: bit 2 nt + c of keep0 / keep1 says whether this
      // thread's key column nt * 8 + 2 tg + c is kept for its queries
      uint32_t keep0 = ~0u, keep1 = ~0u;
      if (kMask == kRadial && masked)
        flash_mask::radial_keep_bits<8>(keep0, keep1, query0, query1, kt, tg, hw);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = kt + nt * 8 + tg * 2 + c;
          bool ok0 = !tail || key < Tk, ok1 = ok0;
          if (kMask == kRadial) {
            ok0 = ok0 & ((keep0 >> (2 * nt + c)) & 1);
            ok1 = ok1 & ((keep1 >> (2 * nt + c)) & 1);
          } else if (kMask != 0 && masked) {
            const int sk = (kMask & kSegment) ? kseg[stage * kTileRows + key - kt] : 0;
            ok0 = ok0 && flash_mask::keep_pair<kMask>(r0, sq0, key, sk);
            ok1 = ok1 && flash_mask::keep_pair<kMask>(r1, sq1, key, sk);
          }
          // dropped: exp2(-inf) = 0, with no branch
          p[c] = exp2f(ok0 ? fmaf(sacc[nt][c], scale_log2, -l0) : -CUDART_INF_F);
          p[2 + c] = exp2f(ok1 ? fmaf(sacc[nt][2 + c], scale_log2, -l1) : -CUDART_INF_F);
        }
        const float2 pl = unpack2f(pack2f(p[0], p[1])), ph = unpack2f(pack2f(p[2], p[3]));
        ds[nt / 2][(nt & 1) * 2 + 0] =
            pack2f(pl.x * (dpacc[nt][0] - d0), pl.y * (dpacc[nt][1] - d0));
        ds[nt / 2][(nt & 1) * 2 + 1] =
            pack2f(ph.x * (dpacc[nt][2] - d1), ph.y * (dpacc[nt][3] - d1));
      }

      // dQ += dS K
      const uint64_t dkm = desc_mnmajor<kTileRows>(ks);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_rs(dqacc, ds[s], dkm + kstep_mnmajor(s), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dqacc);
      fence_frag(ds);
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    const int64_t ld = (int64_t)H * kD;
    store_acc<kD>(dq + (int64_t)b * Tq * ld + h * kD, ld, dqacc, scale, r0, Tq, tg);
  }
}
// K9b's dQ kernel by head dim and mask form, and K10b's under a name of its own.
template <int kD, int kMask>
__global__ void __launch_bounds__(DqGeom<kD>::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    const int2* __restrict__ ranges, const RadialList list,
                    int* __restrict__ visits, bf16* __restrict__ dq, int Tq, int Tk, int H,
                    float scale_log2, float scale) {
  dq_block<kD, kMask>(map_q, map_k, map_v, map_do, lse, delta, seg, ranges, list, visits, dq, Tq,
                      Tk, H, scale_log2, scale);
}
__global__ void __launch_bounds__(DqGeom<128>::kThreads, 1)
radial_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     const int2* __restrict__ ranges, const RadialList list,
                     int* __restrict__ visits, bf16* __restrict__ dq, int Tq, int Tk, int H,
                     float scale_log2, float scale) {
  dq_block<128, kRadial>(map_q, map_k, map_v, map_do, lse, delta, seg, ranges, list, visits, dq,
                         Tq, Tk, H, scale_log2, scale);
}

// The kernels of a head dim and mask form.
template <int kD, int kMask>
auto dkv_kernel() {
  if constexpr (kMask == kRadial) {
    static_assert(kD == 128, "the radial form runs at head dim 128");
    return radial_bwd_dkv_kernel;
  } else {
    return flash_bwd_dkv_kernel<kD, kMask>;
  }
}
template <int kD, int kMask>
auto dq_kernel() {
  if constexpr (kMask == kRadial) {
    static_assert(kD == 128, "the radial form runs at head dim 128");
    return radial_bwd_dq_kernel;
  } else {
    return flash_bwd_dq_kernel<kD, kMask>;
  }
}

// The dK/dV and dQ launches of one mask form (the delta pass has run);
// ``list_dkv`` and ``list_dq`` are the radial form's lists, empty for the others.
template <int kD, int kMask>
int launch_bwd_kernels(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* seg, const int2* ranges,
                       int* visits_dkv, int* visits_dq, void* dq, void* dk, void* dv, int B,
                       int Tq, int Tk, int H, float scale, cudaStream_t stream,
                       RadialList list_dkv, RadialList list_dq) {
  typedef DkvGeom<kD> GK;
  typedef DqGeom<kD> GQ;
  const float scale_log2 = scale * kLog2e;
  // both kernels read q and dO in tiles of GK::kQT == GQ::kBlockM rows, k and v of 64
  static_assert(GK::kQT == GQ::kBlockM, "one pair of q / dO maps serves both kernels");
  CUtensorMap mq, mk, mv, mdo;
  int err = hopper_host::make_tile_map(&mq, q, B, Tq, H, kD, GK::kQT);
  if (!err) err = hopper_host::make_tile_map(&mk, k, B, Tk, H, kD, kTileRows);
  if (!err) err = hopper_host::make_tile_map(&mv, v, B, Tk, H, kD, kTileRows);
  if (!err) err = hopper_host::make_tile_map(&mdo, dout, B, Tq, H, kD, GK::kQT);
  if (err) return err;
  auto dkv = dkv_kernel<kD, kMask>();
  cudaError_t e = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       GK::kSmem);
  if (e != cudaSuccess) return (int)e;
  dkv<<<dim3((Tk + kTileRows - 1) / kTileRows, H, B), 384, GK::kSmem, stream>>>(
      mq, mk, mv, mdo, lse, delta, seg, ranges, list_dkv, visits_dkv, (bf16*)dk, (bf16*)dv, Tq,
      Tk, H, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto dqk = dq_kernel<kD, kMask>();
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, GQ::kSmem);
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3((Tq + GQ::kBlockM - 1) / GQ::kBlockM, H, B), GQ::kThreads, GQ::kSmem, stream>>>(
      mq, mk, mv, mdo, lse, delta, seg, ranges, list_dq, visits_dq, (bf16*)dq, Tq, Tk, H,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

// delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]
template <int kD>
int launch_delta(const void* o, const void* dout, void* delta, int B, int Tq, int H,
                 cudaStream_t stream) {
  const int64_t rows = (int64_t)B * Tq * H;
  flash_bwd_delta_kernel<kD><<<(unsigned)((rows + 3) / 4), kDeltaThreads, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, rows, Tq, H);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Tq,
               int Tk, int H, float scale, cudaStream_t stream) {
  const int err = launch_delta<kD>(o, dout, delta, B, Tq, H, stream);
  if (err) return err;
  return launch_bwd_kernels<kD, 0>(q, k, v, dout, (const float*)lse, (const float*)delta,
                                   nullptr, nullptr, nullptr, nullptr, dq, dk, dv, B, Tq, Tk, H,
                                   scale, stream, RadialList{}, RadialList{});
}

// The masked forms: the range pre-pass (segment forms), the delta pass and
// the kernels of the form ``causal`` and ``seg`` ask for.
template <int kD>
int launch_bwd_masked(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* delta, void* dq, void* dk,
                      void* dv, const void* seg, void* ranges, void* visits, int B, int T, int H,
                      int causal, float scale, cudaStream_t stream) {
  if (seg != nullptr) {
    const cudaError_t e =
        flash_mask::launch_seg_tile_ranges((const int*)seg, (int2*)ranges, B, T, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const int err = launch_delta<kD>(o, dout, delta, B, T, H, stream);
  if (err) return err;
  int* vis = (int*)visits;
  auto run = [&](auto launch) {
    return launch(q, k, v, dout, (const float*)lse, (const float*)delta, (const int*)seg,
                  (const int2*)ranges, vis, vis ? vis + 1 : nullptr, dq, dk, dv, B, T, T, H,
                  scale, stream, RadialList{}, RadialList{});
  };
  if (seg == nullptr) return run(launch_bwd_kernels<kD, kCausal>);
  return causal ? run(launch_bwd_kernels<kD, kCausal | kSegment>)
                : run(launch_bwd_kernels<kD, kSegment>);
}

// The radial form (head dim 128): the delta pass and the kernels on the
// two lists.
int launch_bwd_radial(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* delta, void* dq, void* dk,
                      void* dv, RadialList list_dkv, RadialList list_dq, void* visits, int B,
                      int T, int H, float scale, cudaStream_t stream) {
  const int err = launch_delta<128>(o, dout, delta, B, T, H, stream);
  if (err) return err;
  int* vis = (int*)visits;
  return launch_bwd_kernels<128, kRadial>(q, k, v, dout, (const float*)lse, (const float*)delta,
                                          nullptr, nullptr, vis, vis ? vis + 1 : nullptr, dq, dk,
                                          dv, B, T, T, H, scale, stream, list_dkv, list_dq);
}

}  // namespace

// Plain C entry points (loaded with ctypes): each launches its kernels on
// the given stream, does not synchronise, returns the first cudaError_t that
// is not 0. ``delta`` is float32 scratch [B, H, Tq]; ``D`` the head dim, 128
// or 256 (any other: cudaErrorInvalidValue).
extern "C" int mhla_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int B, int Tq, int Tk, int H, int D,
                              float scale, void* stream) {
  if (Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return launch(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Tq, Tk, H, scale,
                  (cudaStream_t)stream);
  };
  if (D == 128) return run(launch_bwd<128>);
  if (D == 256) return run(launch_bwd<256>);
  return (int)cudaErrorInvalidValue;
}

// The causal and / or segment-id forms, Tq == Tk == T: the range pre-pass
// (segment forms; ``seg`` [B, T] int32 or null, ``ranges`` int32 scratch
// [B, ceil(T / 64), 2]), the delta pass and the masked kernels.
// ``visits`` is null or two int32 that get the tiles walked by the dK/dV and
// the dQ kernel added.
extern "C" int mhla_flash_bwd_masked(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv, const void* seg,
                                     void* ranges, void* visits, int B, int T, int H, int D,
                                     int causal, float scale, void* stream) {
  if (T < 1 || (seg == nullptr && !causal)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto launch) {
    return launch(q, k, v, o, dout, lse, delta, dq, dk, dv, seg, ranges, visits, B, T, H,
                  causal, scale, (cudaStream_t)stream);
  };
  if (D == 128) return run(launch_bwd_masked<128>);
  if (D == 256) return run(launch_bwd_masked<256>);
  return (int)cudaErrorInvalidValue;
}

// The radial form, Tq == Tk == T in frames of ``hw`` tokens, head dim 128:
// the delta pass and the two kernels, the dK/dV kernel on the lists of
// radial_schedule(T, frames, 64, 128) read from the key side (``dkv_*``),
// the dQ kernel on those of radial_schedule(T, frames, 128, 64) (``dq_*``):
// offsets, entries (2 * tile + full) and the block order, int32 on the
// device. ``visits`` as in mhla_flash_bwd_masked.
extern "C" int mhla_flash_bwd_radial(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk, void* dv,
                                     const void* dkv_offsets, const void* dkv_entries,
                                     const void* dkv_order, const void* dq_offsets,
                                     const void* dq_entries, const void* dq_order, void* visits,
                                     int B, int T, int H, int hw, float scale, void* stream) {
  if (T < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  const RadialList dkv = {(const int*)dkv_offsets, (const int*)dkv_entries,
                          (const int*)dkv_order, hw};
  const RadialList dql = {(const int*)dq_offsets, (const int*)dq_entries, (const int*)dq_order,
                          hw};
  return launch_bwd_radial(q, k, v, o, dout, lse, delta, dq, dk, dv, dkv, dql, visits, B, T, H,
                           scale, (cudaStream_t)stream);
}
