// K12b: backward of chunked gated linear attention (GLA) for Hopper (sm_90a).
//
// Replaces _gla_bwd_kernel (mhla_tpu/kernels/gla_chunk_pallas.py:160), called
// through _gla_bwd_impl (:376-461). Given K12's inputs (qd, kd, v in T,
// e^{G_last} float32), its chunk-entry states S_n (float32), the output
// cotangent dO (T) and the final-state cotangent, it gives, all float32:
//
//   dS_n  = the cotangent of chunk n's exit state: dS_{N-1} = dS_final,
//           dS_{n-1} = e^{G_last, n} dS_n + qd_n^T dO_n;  ds0 = the last
//   dp    = T(mask(dO v^T))
//   dqd   = dp kd + dO T(S_n)^T
//   dkd   = dp^T qd + (v T(dS_n)^T) e^{G_last}
//   dv    = T(mask(qd kd^T))^T dO + kc T(dS_n)         kc = T(kd e^{G_last})
//   degl  = sum_Dv(S_n * dS_n) + sum_C((v T(dS_n)^T) * kd)
//
// The elementwise decay chains (qd = q e^G scale, kd = k e^-G, the cumsum)
// are differentiated outside, in PyTorch, as JAX does outside its kernel.
//
// Three launches, as in K12:
//
// 1. chunk_outer_kernel (gla_common.cuh): qd^T dO for every chunk, into
//    `exits` [B, N, H, Dk, Dv] float32.
// 2. chain_kernel (gla_common.cuh), in reverse: one thread per state entry
//    replaces qd_n^T dO_n by the exit cotangent dS_n and leaves ds0. Only this
//    chain is sequential; the TPU kernel also replays the forward chain from
//    its supertile-entry states, which K12 saved whole.
// 3. grads_kernel below, grid (B*N, H): everything of one (chunk, head). It
//    walks Dv 32 columns at a time and keeps every sum over Dv (dp, v dS^T,
//    dO S^T, S * dS) in registers across the steps, in a fixed order; the sums
//    over C (dkd's decay term, degl's second term) run after the walk, one
//    thread a column. No atomics and no sum across blocks, so K12b is
//    bit-equal from run to run. 1,024 blocks at [8, 2048, 4, 128|256].
//
// Bound at [8, 2048, 4, 128|256], float32 (chip_smoke.py gla_work): 21.0
// GFLOP (q k^T again, dO v^T and the three intra products over the kept
// pairs, the four products with the states), 0.313 ms at 67 TFLOP/s; 0.47 GB,
// 0.14 ms at 3.35 TB/s: operations. Float32 FMAs on the CUDA cores in both
// dtypes, as in K12, with the same things not done yet. One block per SM (166
// KB of shared memory, 160-172 registers a thread).

#include "gla_common.cuh"

using namespace gla;

namespace {

constexpr size_t kGradsSmem =
    (size_t)(3 * kMaxC * kLdK      // qd, kd, kc
             + kMaxC * kLdC        // T(masked scores), then T(masked dp)
             + 2 * kMaxC * kLdT    // v, dO, one tile each
             + 2 * kTile * kLdK    // S^T, dS^T, one tile each; then v dS^T [C][kLdK]
             + kDk)                // e^{G_last}
    * sizeof(float);
static_assert(2 * kTile * kLdK >= kMaxC * kLdK, "v dS^T reuses the two state tiles");

// Stage 3. grid (B*N, H). qd, kd: [B, N*C, H, Dk] T; v, dout: [B, N*C, H, Dv]
// T; egl: [B, N, H, Dk]; states, exits: [B, N, H, Dk, Dv]; dqd, dkd: [B, N*C,
// H, Dk]; dv: [B, N*C, H, Dv]; degl: [B, N, H, Dk]; float32 but for T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
grads_kernel(const T* __restrict__ qd, const T* __restrict__ kd, const T* __restrict__ v,
             const float* __restrict__ egl, const float* __restrict__ states,
             const float* __restrict__ exits, const T* __restrict__ dout,
             float* __restrict__ dqd, float* __restrict__ dkd, float* __restrict__ dv,
             float* __restrict__ degl, int C, int H, int Dv) {
  extern __shared__ float smem[];
  float* qs = smem;                // [C][kLdK]
  float* ks = qs + kMaxC * kLdK;   // [C][kLdK]
  float* kcs = ks + kMaxC * kLdK;  // [C][kLdK]
  float* sc = kcs + kMaxC * kLdK;  // [C][kLdC]
  float* vt = sc + kMaxC * kLdC;   // [C][kLdT]
  float* dt = vt + kMaxC * kLdT;   // [C][kLdT]
  float* zt = dt + kMaxC * kLdT;   // [kTile][kLdK]: S^T
  float* dzt = zt + kTile * kLdK;  // [kTile][kLdK]: dS^T
  float* eg = dzt + kTile * kLdK;  // [Dk]

  const int tid = threadIdx.x;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t ldk = (int64_t)H * kDk, ldv = (int64_t)H * Dv;
  const int64_t row_k = (bn * C * H + h) * kDk, row_v = (bn * C * H + h) * Dv;
  load_tile<false>(qs, kLdK, qd + row_k, ldk, C, kDk);
  load_tile<false>(ks, kLdK, kd + row_k, ldk, C, kDk);
  if (tid < kDk) eg[tid] = egl[(bn * H + h) * kDk + tid];
  __syncthreads();

  for (int e = tid; e < C * kDk; e += blockDim.x) {
    const int r = e / kDk, d = e % kDk;
    kcs[r * kLdK + d] = rnd<T>(ks[r * kLdK + d] * eg[d]);
  }
  // T(mask(qd kd^T)); a thread owns 4 x 4 scores
  const int i0 = (tid / 16) * 4, p0 = (tid % 16) * 4;
  if (i0 < C && p0 < C) {
    float acc[4][4];
    zero(acc);
    if (p0 <= i0 + 3) mm<float, float>(acc, qs, kLdK, 1, ks, 1, kLdK, i0, p0, kDk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[(i0 + i) * kLdC + p0 + j] = p0 + j <= i0 + i ? rnd<T>(acc[i][j]) : 0.f;
  }

  // the walk over Dv. Per thread: rows i0..i0+3 x columns d0..d0+7 of v dS^T
  // and dO S^T, rows i0..i0+3 x columns p0..p0+3 of dO v^T, rows r0..r0+1 x
  // columns c0..c0+3 of a dv tile, and column tid of sum_Dv(S * dS).
  const int d0 = (tid % 16) * 8;
  const int r0 = (tid / 8) * 2, c0 = (tid % 8) * 4;
  const bool rows = i0 < C;
  float dkc[4][8], dqs[4][8], dp[4][4];
  zero(dkc);
  zero(dqs);
  zero(dp);
  float dg = 0.f;
  const int64_t st = (bn * H + h) * kDk * (int64_t)Dv;
  for (int col0 = 0; col0 < Dv; col0 += kTile) {
    load_tile<false>(vt, kLdT, v + row_v + col0, ldv, C, kTile);
    load_tile<false>(dt, kLdT, dout + row_v + col0, ldv, C, kTile);
    load_tile<true>(zt, kLdK, states + st + col0, Dv, kDk, kTile);
    load_tile<true>(dzt, kLdK, exits + st + col0, Dv, kDk, kTile);
    __syncthreads();
    if (r0 < C) {  // dv = T(scores)^T dO + kc T(dS)
      float intra[2][4], carry[2][4];
      zero(intra);
      zero(carry);
      mm<float, float>(intra, sc, 1, kLdC, dt, kLdT, 1, r0, c0, C);
      mm<float, T>(carry, kcs, kLdK, 1, dzt, 1, kLdK, r0, c0, kDk);
      float* dvc = dv + row_v + col0;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dvc[(r0 + i) * ldv + c0 + j] = intra[i][j] + carry[i][j];
    }
    if (rows) {
      if (p0 < C) mm<float, float>(dp, dt, kLdT, 1, vt, 1, kLdT, i0, p0, kTile);
      mm<float, T>(dkc, vt, kLdT, 1, dzt, kLdK, 1, i0, d0, kTile);
      mm<float, T>(dqs, dt, kLdT, 1, zt, kLdK, 1, i0, d0, kTile);
    }
    if (tid < kDk)
      for (int j = 0; j < kTile; ++j) dg = fmaf(zt[j * kLdK + tid], dzt[j * kLdK + tid], dg);
    __syncthreads();
  }

  // T(mask(dp)) over the scores; v dS^T over the state tiles
  float* dkcs = zt;  // [C][kLdK]
  if (rows) {
    if (p0 < C) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[(i0 + i) * kLdC + p0 + j] = p0 + j <= i0 + i ? rnd<T>(dp[i][j]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dkcs[(i0 + i) * kLdK + d0 + j] = dkc[i][j];
  }
  __syncthreads();

  if (rows) {  // dqd = dp kd + dO T(S)^T;  dkd = dp^T qd + (v T(dS)^T) e^{G_last}
    float acc[4][8];
    zero(acc);
    mm<float, float>(acc, sc, kLdC, 1, ks, kLdK, 1, i0, d0, C);
    float* out = dqd + row_k;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out[(i0 + i) * ldk + d0 + j] = acc[i][j] + dqs[i][j];
    zero(acc);
    mm<float, float>(acc, sc, 1, kLdC, qs, kLdK, 1, i0, d0, C);
    out = dkd + row_k;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[(i0 + i) * ldk + d0 + j] = acc[i][j] + dkc[i][j] * eg[d0 + j];
  }
  if (tid < kDk) {  // degl = sum_Dv(S * dS) + sum_C((v T(dS)^T) * kd)
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(dkcs[c * kLdK + tid], ks[c * kLdK + tid], s);
    degl[(bn * H + h) * kDk + tid] = dg + s;
  }
}

template <typename T>
int gla_bwd(const T* qd, const T* kd, const T* v, const float* egl, const float* states,
            const T* dout, const float* ds_final, float* exits, float* dqd, float* dkd,
            float* dv, float* degl, float* ds0, int B, int N, int C, int H, int Dv,
            cudaStream_t stream) {
  int err = outer_and_chain<T>(qd, nullptr, dout, exits, egl, ds_final, ds0, B, N, C, H, Dv, 1,
                               stream);
  if (err != cudaSuccess) return err;
  cudaFuncSetAttribute(grads_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kGradsSmem);
  grads_kernel<T><<<dim3(B * N, H), kThreads, kGradsSmem, stream>>>(
      qd, kd, v, egl, states, exits, dout, dqd, dkd, dv, degl, C, H, Dv);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): the three launches on the given
// stream, no synchronisation; returns the first launch's cudaError_t. qd, kd:
// [B, N*C, H, Dk]; v, dout: [B, N*C, H, Dv], float (is_bf16 = 0) or bf16;
// egl, degl: [B, N, H, Dk]; states, exits (scratch): [B, N, H, Dk, Dv];
// ds_final, ds0: [B, H, Dk, Dv]; dqd, dkd: [B, N*C, H, Dk]; dv: [B, N*C, H,
// Dv]; float32.
extern "C" int mhla_gla_bwd(const void* qd, const void* kd, const void* v, const void* egl,
                            const void* states, const void* dout, const void* ds_final,
                            void* exits, void* dqd, void* dkd, void* dv, void* degl, void* ds0,
                            int B, int N, int C, int H, int Dk, int Dv, int is_bf16,
                            void* stream) {
  if (!shape_ok(C, Dk, Dv)) return (int)cudaErrorInvalidValue;
  const float* eg = (const float*)egl;
  const float* sts = (const float*)states;
  const float* dsf = (const float*)ds_final;
  if (is_bf16)
    return gla_bwd<bf16>((const bf16*)qd, (const bf16*)kd, (const bf16*)v, eg, sts,
                         (const bf16*)dout, dsf, (float*)exits, (float*)dqd, (float*)dkd,
                         (float*)dv, (float*)degl, (float*)ds0, B, N, C, H, Dv,
                         (cudaStream_t)stream);
  return gla_bwd<float>((const float*)qd, (const float*)kd, (const float*)v, eg, sts,
                        (const float*)dout, dsf, (float*)exits, (float*)dqd, (float*)dkd,
                        (float*)dv, (float*)degl, (float*)ds0, B, N, C, H, Dv,
                        (cudaStream_t)stream);
}
