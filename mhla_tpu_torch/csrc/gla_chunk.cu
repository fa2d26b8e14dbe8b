// K12: forward of chunked gated linear attention (GLA) for Hopper (sm_90a).
//
// Replaces _gla_fwd_kernel (mhla_tpu/kernels/gla_chunk_pallas.py:85), called
// through _gla_fused_fwd_impl (:331-373). Per chunk of C tokens and per head,
// with G the within-chunk inclusive cumsum of the per-key-channel log decay,
// qd = q e^G scale, kd = k e^-G and v in the compute dtype T (float or bf16),
// e^{G_last} float32 and S the chunk-entry state [Dk, Dv] float32:
//
//   kc = T(kd e^{G_last});   u = kc^T v
//   o  = T(mask(qd kd^T)) v + qd T(S)          mask: j <= i
//   S' = e^{G_last} S + u                      (row d decays by e^{G_last, d})
//
// The TPU kernel walks (batch, supertile) in order, the state in VMEM, and
// splits each supertile into three stages so that no product sits on the
// chain (:26-31). Here the three stages are three launches over all chunks:
//
// 1. chunk_outer_kernel (gla_common.cuh), grid (B*N, H, Dv/64): u = kc^T v
//    for every chunk, into `states` [B, N, H, Dk, Dv] float32.
// 2. chain_kernel (gla_common.cuh): one thread per state entry (B*H*Dk*Dv
//    threads, 1M at [8, 2048, 4, 128|256], 131K at [1, 32768, 8, 128|128])
//    walks the N chunks, replacing u[n] by the entry state of chunk n and
//    leaving the final state. The chain is elementwise: the per-channel decay
//    scales rows, so the sequential part moves bytes and does no product.
// 3. readout_kernel below, grid (B*N, H): per (chunk, head) the masked
//    scores once, then o 32 columns of Dv at a time. 1,024 blocks at
//    [8, 2048, 4, 128|256], 4,096 at [1, 32768, 8, 128|128], 52 at 1 x 781.
//
// The entry states stay in `states` for the backward (float32, every chunk's:
// 134 MB a layer at [8, 2048, 4, 128|256]; the TPU kernel saves only the
// supertile-entry states and replays the chain, :38-41).
//
// Bound at [8, 2048, 4, 128|256], float32 (the layer's form; chip_smoke.py
// gla_work): 10.2 GFLOP (q k^T and its product with v over the C(C+1)/2 kept
// pairs, qd S and kc^T v at 2 C Dk Dv each, per chunk and head), 0.153 ms at
// 67 TFLOP/s; 0.34 GB with the entry states, 0.10 ms at 3.35 TB/s: operations.
// Every product runs in float32 FMAs from shared memory with a register tile
// of 2x4 to 4x8 a thread, in both dtypes (for bf16 too, where the tensor
// cores would be the tool: a later step). What this version does not do:
// tensor cores, vector loads, overlap of loads and products, or keeping u and
// the states out of device memory.

#include "gla_common.cuh"

using namespace gla;

namespace {

constexpr size_t kReadoutSmem =
    (size_t)(2 * kMaxC * kLdK      // qd, kd
             + kMaxC * kLdC        // T(masked scores)
             + kMaxC * kLdT        // v, one tile
             + kDk * kLdT)         // the entry state, one tile
    * sizeof(float);

// Stage 3. grid (B*N, H). qd, kd: [B, N*C, H, Dk] T; v, o: [B, N*C, H, Dv] T;
// states: [B, N, H, Dk, Dv] float32 (the chunk-entry states).
template <typename T>
__global__ void __launch_bounds__(kThreads)
readout_kernel(const T* __restrict__ qd, const T* __restrict__ kd, const T* __restrict__ v,
               const float* __restrict__ states, T* __restrict__ o, int C, int H, int Dv) {
  extern __shared__ float smem[];
  float* qs = smem;               // [C][kLdK]
  float* ks = qs + kMaxC * kLdK;  // [C][kLdK]
  float* sc = ks + kMaxC * kLdK;  // [C][kLdC]
  float* vt = sc + kMaxC * kLdC;  // [C][kLdT]
  float* zt = vt + kMaxC * kLdT;  // [Dk][kLdT]

  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t ldk = (int64_t)H * kDk, ldv = (int64_t)H * Dv;
  const int64_t row_k = (bn * C * H + h) * kDk, row_v = (bn * C * H + h) * Dv;
  load_tile<false>(qs, kLdK, qd + row_k, ldk, C, kDk);
  load_tile<false>(ks, kLdK, kd + row_k, ldk, C, kDk);
  __syncthreads();

  // T(mask(qd kd^T)); a thread owns 4 x 4 scores
  {
    const int i0 = (threadIdx.x / 16) * 4, j0 = (threadIdx.x % 16) * 4;
    if (i0 < C && j0 < C) {
      float acc[4][4];
      zero(acc);
      if (j0 <= i0 + 3) mm<float, float>(acc, qs, kLdK, 1, ks, 1, kLdK, i0, j0, kDk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[(i0 + i) * kLdC + j0 + j] = j0 + j <= i0 + i ? rnd<T>(acc[i][j]) : 0.f;
    }
  }

  // o = T(scores) v + qd T(S), kTile columns at a time; a thread owns 2 x 4
  const float* sg = states + (bn * H + h) * kDk * (int64_t)Dv;
  const int r0 = (threadIdx.x / 8) * 2, c0 = (threadIdx.x % 8) * 4;
  for (int col0 = 0; col0 < Dv; col0 += kTile) {
    load_tile<false>(vt, kLdT, v + row_v + col0, ldv, C, kTile);
    load_tile<false>(zt, kLdT, sg + col0, Dv, kDk, kTile);
    __syncthreads();
    if (r0 < C) {
      float intra[2][4], far[2][4];
      zero(intra);
      zero(far);
      mm<float, float>(intra, sc, kLdC, 1, vt, kLdT, 1, r0, c0, C);
      mm<float, T>(far, qs, kLdK, 1, zt, kLdT, 1, r0, c0, kDk);
      T* oc = o + row_v + col0;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          oc[(r0 + i) * ldv + c0 + j] = from_f<T>(intra[i][j] + far[i][j]);
    }
    __syncthreads();
  }
}

template <typename T>
int gla_fwd(const T* qd, const T* kd, const T* v, const float* egl, const float* s0, T* o,
            float* s_final, float* states, int B, int N, int C, int H, int Dv,
            cudaStream_t stream) {
  int err = outer_and_chain<T>(kd, egl, v, states, egl, s0, s_final, B, N, C, H, Dv, 0, stream);
  if (err != cudaSuccess) return err;
  cudaFuncSetAttribute(readout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kReadoutSmem);
  readout_kernel<T><<<dim3(B * N, H), kThreads, kReadoutSmem, stream>>>(qd, kd, v, states, o,
                                                                         C, H, Dv);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): the three launches on the given
// stream, no synchronisation; returns the first launch's cudaError_t. qd, kd:
// [B, N*C, H, Dk]; v, o: [B, N*C, H, Dv], all float (is_bf16 = 0) or bf16;
// egl: [B, N, H, Dk], s0, s_final: [B, H, Dk, Dv], states: [B, N, H, Dk, Dv],
// float32.
extern "C" int mhla_gla_fwd(const void* qd, const void* kd, const void* v, const void* egl,
                            const void* s0, void* o, void* s_final, void* states, int B, int N,
                            int C, int H, int Dk, int Dv, int is_bf16, void* stream) {
  if (!shape_ok(C, Dk, Dv)) return (int)cudaErrorInvalidValue;
  const float* eg = (const float*)egl;
  if (is_bf16)
    return gla_fwd<bf16>((const bf16*)qd, (const bf16*)kd, (const bf16*)v, eg,
                         (const float*)s0, (bf16*)o, (float*)s_final, (float*)states, B, N, C,
                         H, Dv, (cudaStream_t)stream);
  return gla_fwd<float>((const float*)qd, (const float*)kd, (const float*)v, eg,
                        (const float*)s0, (float*)o, (float*)s_final, (float*)states, B, N, C,
                        H, Dv, (cudaStream_t)stream);
}
