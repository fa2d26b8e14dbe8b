// K10b: flash-attention backward under the radial frame-distance mask for
// Hopper (sm_90a), head dim 128.
//
// With S = scale * q k^T on the allowed pairs, P = exp(S - lse) there and 0
// elsewhere, and delta_i = sum_d dO[i, d] O[i, d]:
//
//   dV = P^T dO          dP = dO V^T          dS = P * (dP - delta)
//   dQ = scale * dS K    dK = scale * dS^T Q
//
// q, k, v, o, dO, dq, dk, dv: [B, T, H, 128] bf16, T tokens in frames of hw
// (the mask's rule is in flash_common.cuh); lse [B, H, T] float32 from the
// forward's training form (radial_fwd.cu, natural log of the sum over the
// allowed keys); delta [B, H, T] float32 scratch. Scores, P, dP and all sums
// are float32; P is rounded to bf16 before P^T dO and before dS, and dS
// before its two products, once each, as in flash_bwd.cu.
//
// Replaces the fused backward of the JAX library's Pallas TPU splash-attention
// kernel, which jax.grad of the radial attention reaches through
// mhla_tpu/kernels/sparse_attention.py:507-517 (built at :137-166). That
// kernel walks 512 x 512 blocks and streams a stored boolean mask for every
// block the band crosses; nothing of that is carried over.
//
// Bound: operations. 10 * 128 FLOP per allowed pair per (batch row, head)
// against 2 * 8 * T * 128 bytes: far above the card's bf16 ridge (295
// FLOP/byte) at video lengths.
// Design: flash_bwd.cu's three launches (delta; dK, dV with a block per 64
// keys walking query tiles; dQ with a block per 64 queries walking key
// tiles; no atomics, so the result is the same from run to run), each walk
// cut down to the forward's schedule of 64 x 64 tiles that hold an allowed
// pair. One CSR list serves both kernels: the mask is symmetric and the tiles
// are square, so the query tiles that key tile j meets are the key tiles that
// query tile j meets, and the `full` flag of an entry (every pair allowed,
// the walked tile wholly below T) reads the same either way. On full tiles
// the tile step is flash_bwd.cu's; elsewhere the mask is index arithmetic as
// in the forward: the frame and spatial index of a thread's 2 rows once per
// kernel, of its 16 columns once per tile, and a masked pair gets P = 0 by
// selection, so a masked score above lse cannot overflow into the sums. A row
// below T always keeps its own frame, so lse is finite wherever it is read.
// Rows and columns past T are zero-filled on the way in, get P = 0 and are
// never stored. The lists differ in length (a tile of a middle frame meets
// more tiles than one at either end); blocks are not ordered by length yet,
// nor are wgmma and TMA used.

#include "flash_bwd_common.cuh"

using namespace flash_bwd;

namespace {

constexpr int kDqSmem = 6 * (int)sizeof(Tile);                       // Q, dO, 2 K, 2 V
constexpr int kDkvSmem = 6 * (int)sizeof(Tile) + 4 * kTile * (int)sizeof(float);  // + lse, delta

// P (rows x 64 columns of one warp) from the scores in ``acc``, as packed
// bf16 A fragments: exp2(acc * scale_log2 - l) with ``l0``/``l1`` taken per
// row (kRowStats: this thread's two rows) or per column (from ``ls``, in
// natural log). Outside full tiles a pair survives only if the mask keeps it
// and the column's token ``c0 + column`` lies below T. (f0, s0) and (f1, s1)
// are the frame and spatial index of the thread's rows g and g + 8.
template <bool kRowStats>
__device__ __forceinline__ void masked_p(uint32_t (&pa)[kTile / 16][4],
                                         const float (&acc)[kTile / 8][4], const float* ls,
                                         float l0, float l1, float scale_log2, bool full,
                                         int c0, int T, int hw, int f0, int s0, int f1,
                                         int s1, int tg) {
  const int fc0 = c0 / hw, sc0 = c0 - fc0 * hw;  // of the tile's first column
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    float p[4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int off = nt * 8 + tg * 2 + c;
      const float la = kRowStats ? l0 : ls[off] * kLog2e;
      const float lb = kRowStats ? l1 : la;
      p[c] = exp2f(fmaf(acc[nt][c], scale_log2, -la));
      p[2 + c] = exp2f(fmaf(acc[nt][2 + c], scale_log2, -lb));
      if (!full) {
        int fc = fc0, sc = sc0 + off;
        while (sc >= hw) {  // once at most when hw >= 64
          sc -= hw;
          ++fc;
        }
        const bool real = c0 + off < T;
        if (!(real && radial_keep(f0, s0, fc, sc, hw))) p[c] = 0.f;
        if (!(real && radial_keep(f1, s1, fc, sc, hw))) p[2 + c] = 0.f;
      }
    }
    pa[nt / 2][(nt & 1) * 2 + 0] = pack2f(p[0], p[1]);
    pa[nt / 2][(nt & 1) * 2 + 1] = pack2f(p[2], p[3]);
  }
}

// dK and dV. grid (ceil(T / 64), H, B); dynamic shared memory kDkvSmem.
// Key tile j walks the query tiles entries[offsets[j] .. offsets[j + 1]) >> 1;
// bit 0 of an entry says that every pair of the tile is allowed and that the
// query tile lies wholly below T.
__global__ void __launch_bounds__(kThreads)
radial_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ offsets, const int* __restrict__ entries,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, int hw,
                      float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile* kst = reinterpret_cast<Tile*>(smem_raw);  // this block's keys
  Tile* vst = kst + 1;
  Tile* qs = kst + 2;   // [2] query tiles
  Tile* dos = kst + 4;  // [2] dO tiles
  float* stat = reinterpret_cast<float*>(smem_raw + 6 * sizeof(Tile));  // [2][lse, delta][64]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int64_t ld = (int64_t)H * kD;
  const int64_t base = (int64_t)b * T * ld + h * kD;
  const bf16* qb = q + base;
  const bf16* dob = dout + base;
  const float* lb = lse + ((int64_t)b * H + h) * T;
  const float* db = delta + ((int64_t)b * H + h) * T;

  // this thread's two keys: the rows of S^T
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  const int fk0 = r0 / hw, sk0 = r0 - fk0 * hw;
  const int fk1 = r1 / hw, sk1 = r1 - fk1 * hw;

  auto load_tile = [&](int buf, int qt0) {
    copy_tile(qs[buf], qb, ld, qt0, T, tid);
    copy_tile(dos[buf], dob, ld, qt0, T, tid);
    const int j = tid & (kTile - 1);
    const bool valid = qt0 + j < T;
    const float* src = (tid < kTile ? lb : db) + (valid ? qt0 + j : 0);
    cp_async4(stat + (buf * 2 + (tid >= kTile)) * kTile + j, src, valid);
  };

  const int e_begin = offsets[blockIdx.x], ntiles = offsets[blockIdx.x + 1] - e_begin;
  int entry = ntiles > 0 ? entries[e_begin] : 0;
  copy_tile(kst[0], k + base, ld, k0, T, tid);
  copy_tile(vst[0], v + base, ld, k0, T, tid);
  if (ntiles > 0) load_tile(0, (entry >> 1) * kTile);
  cp_async_commit();

  float dkacc[kD / 8][4], dvacc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) {
    dkacc[t][0] = dkacc[t][1] = dkacc[t][2] = dkacc[t][3] = 0.f;
    dvacc[t][0] = dvacc[t][1] = dvacc[t][2] = dvacc[t][3] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, qt = (entry >> 1) * kTile;
    const bool full = entry & 1;
    // the other buffer's readers finished at the end of the last iteration
    if (it + 1 < ntiles) {
      entry = entries[e_begin + it + 1];
      load_tile(buf ^ 1, (entry >> 1) * kTile);
    }
    cp_async_commit();   // an empty group after the last tile keeps the count uniform
    cp_async_wait<1>();  // all but the newest group: this tile (and K, V) has landed
    __syncthreads();
    const float* ls = stat + buf * 2 * kTile;
    const float* dl = ls + kTile;

    // S^T = K Q^T for this warp's 16 keys x 64 queries, then P^T as A fragments
    float acc[kTile / 8][4];
    warp_abt(acc, kst[0], warp * 16, qs[buf], lrow, lmat);
    uint32_t pa[kTile / 16][4];
    masked_p<false>(pa, acc, ls, 0.f, 0.f, scale_log2, full, qt, T, hw, fk0, sk0, fk1, sk1, tg);
    warp_ab(dvacc, pa, dos[buf], lrow, lmat);  // dV += P^T dO

    // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta) in place of P^T
    warp_abt(acc, vst[0], warp * 16, dos[buf], lrow, lmat);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const int c0 = nt * 8 + tg * 2;
      const float d0 = dl[c0], d1 = dl[c0 + 1];
      uint32_t& lo = pa[nt / 2][(nt & 1) * 2 + 0];
      uint32_t& hi = pa[nt / 2][(nt & 1) * 2 + 1];
      const float2 pl = unpack2f(lo), ph = unpack2f(hi);
      lo = pack2f(pl.x * (acc[nt][0] - d0), pl.y * (acc[nt][1] - d1));
      hi = pack2f(ph.x * (acc[nt][2] - d0), ph.y * (acc[nt][3] - d1));
    }
    warp_ab(dkacc, pa, qs[buf], lrow, lmat);  // dK += dS^T Q
    __syncthreads();  // this buffer's fragment reads are done before it is refilled
  }
  cp_async_wait<0>();  // a tile with an empty list still started the copy of its K and V

  store_rows(dk + base, ld, dkacc, scale, r0, r1, T, tg);
  store_rows(dv + base, ld, dvacc, 1.f, r0, r1, T, tg);
}

// dQ. grid (ceil(T / 64), H, B); dynamic shared memory kDqSmem. Query tile i
// walks the key tiles of the forward's list.
__global__ void __launch_bounds__(kThreads)
radial_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ offsets, const int* __restrict__ entries,
                     bf16* __restrict__ dq, int T, int H, int hw, float scale_log2,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile* qst = reinterpret_cast<Tile*>(smem_raw);  // this block's queries
  Tile* dost = qst + 1;
  Tile* ks = qst + 2;  // [2] key tiles
  Tile* vs = qst + 4;  // [2] value tiles
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = lane & 7, lmat = lane >> 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int64_t ld = (int64_t)H * kD;
  const int64_t base = (int64_t)b * T * ld + h * kD;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  // this thread's two queries: their statistics, frames and spatial indices
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* lb = lse + ((int64_t)b * H + h) * T;
  const float* db = delta + ((int64_t)b * H + h) * T;
  const float l0 = r0 < T ? lb[r0] * kLog2e : 0.f, l1 = r1 < T ? lb[r1] * kLog2e : 0.f;
  const float d0 = r0 < T ? db[r0] : 0.f, d1 = r1 < T ? db[r1] : 0.f;
  const int fq0 = r0 / hw, sq0 = r0 - fq0 * hw;
  const int fq1 = r1 / hw, sq1 = r1 - fq1 * hw;

  auto load_tile = [&](int buf, int kt0) {
    copy_tile(ks[buf], kb, ld, kt0, T, tid);
    copy_tile(vs[buf], vb, ld, kt0, T, tid);
  };

  const int e_begin = offsets[blockIdx.x], ntiles = offsets[blockIdx.x + 1] - e_begin;
  int entry = ntiles > 0 ? entries[e_begin] : 0;
  copy_tile(qst[0], q + base, ld, q0, T, tid);
  copy_tile(dost[0], dout + base, ld, q0, T, tid);
  if (ntiles > 0) load_tile(0, (entry >> 1) * kTile);
  cp_async_commit();

  float dqacc[kD / 8][4];
#pragma unroll
  for (int t = 0; t < kD / 8; ++t) dqacc[t][0] = dqacc[t][1] = dqacc[t][2] = dqacc[t][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, kt = (entry >> 1) * kTile;
    const bool full = entry & 1;
    if (it + 1 < ntiles) {
      entry = entries[e_begin + it + 1];
      load_tile(buf ^ 1, (entry >> 1) * kTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // S = Q K^T for this warp's 16 queries x 64 keys, then P as A fragments
    float acc[kTile / 8][4];
    warp_abt(acc, qst[0], warp * 16, ks[buf], lrow, lmat);
    uint32_t pa[kTile / 16][4];
    masked_p<true>(pa, acc, nullptr, l0, l1, scale_log2, full, kt, T, hw, fq0, sq0, fq1, sq1, tg);

    // dP = dO V^T, then dS = P * (dP - delta) in place of P
    warp_abt(acc, dost[0], warp * 16, vs[buf], lrow, lmat);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      uint32_t& lo = pa[nt / 2][(nt & 1) * 2 + 0];
      uint32_t& hi = pa[nt / 2][(nt & 1) * 2 + 1];
      const float2 pl = unpack2f(lo), ph = unpack2f(hi);
      lo = pack2f(pl.x * (acc[nt][0] - d0), pl.y * (acc[nt][1] - d0));
      hi = pack2f(ph.x * (acc[nt][2] - d1), ph.y * (acc[nt][3] - d1));
    }
    warp_ab(dqacc, pa, ks[buf], lrow, lmat);  // dQ += dS K
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows(dq + base, ld, dqacc, scale, r0, r1, T, tg);
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches the three kernels on
// the given stream, does not synchronise, returns the first cudaError_t that
// is not 0. ``delta`` is float32 scratch [B, H, T]; offsets and entries are
// device pointers to the forward's schedule for T tokens in frames of hw.
extern "C" int mhla_radial_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* dq,
                               void* dk, void* dv, const void* offsets, const void* entries,
                               int B, int T, int H, int hw, float scale, void* stream_) {
  if (T < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t err = cudaFuncSetAttribute(
      radial_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(radial_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = scale * kLog2e;
  const int64_t rows = (int64_t)B * T * H;
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  flash_bwd_delta_kernel<kD><<<(unsigned)((rows + 3) / 4), kThreads, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, rows, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radial_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)offsets, (const int*)entries, (bf16*)dk, (bf16*)dv, T,
      H, hw, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radial_bwd_dq_kernel<<<grid, kThreads, kDqSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (const int*)offsets, (const int*)entries, (bf16*)dq, T, H, hw,
      scale_log2, scale);
  return (int)cudaGetLastError();
}
