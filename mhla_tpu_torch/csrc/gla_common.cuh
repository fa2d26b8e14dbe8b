// Helpers and the two stages shared by the chunked GLA kernels (gla_chunk.cu,
// gla_chunk_bwd.cu): the per-chunk outer products x^T y (stage 1) and the
// elementwise chain over the chunks (stage 2).
//
// Every product here runs in float32 FMAs on the CUDA cores, for both compute
// dtypes T (float or bf16): the float32 form is the GLA layer's, and a float32
// product on the tensor cores would be TF32. Shared memory holds float32
// values; a bf16 operand is converted on load, and the rounding points of the
// TPU kernel are applied by rnd<T> (the identity for float). Every matrix in
// shared memory is row-major with an odd row stride (kLd* below), so a column
// read by the threads of a warp spreads over the banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gla {

typedef __nv_bfloat16 bf16;

constexpr int kDk = 128;      // head dim of q and k
constexpr int kMaxC = 64;     // largest chunk
constexpr int kThreads = 256;
constexpr int kKvTile = 64;   // Dv columns per block of the stage-1 products
constexpr int kTile = 32;     // Dv columns per step of the readout and gradient passes
constexpr int kChainUnroll = 8;

// padded row strides (floats) of the shared-memory matrices
constexpr int kLdK = kDk + 1;       // [*, Dk]
constexpr int kLdC = kMaxC + 1;     // [*, C]
constexpr int kLdKv = kKvTile + 1;  // [*, kKvTile]
constexpr int kLdT = kTile + 1;     // [*, kTile]

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// x rounded to T and back (the identity for float)
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < K} RA(A[(m0 + i) * am + k * ak]) * RB(B[k * bk + (n0 + j) * bn]):
// a TM x TN tile of op(A) op(B) for one thread, A and B float32 in shared memory
// with any strides (so either may be read transposed), each operand rounded to
// RA / RB first (float: not rounded).
template <typename RA, typename RB, int TM, int TN>
__device__ __forceinline__ void mm(float (&acc)[TM][TN], const float* A, int am, int ak,
                                   const float* B, int bk, int bn, int m0, int n0, int K) {
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = rnd<RA>(A[(m0 + i) * am + k * ak]);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = rnd<RB>(B[k * bk + (n0 + j) * bn]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// dst[r * ldd + c] (or, Transpose, dst[c * ldd + r]) = src[r * lds + c] as
// float, for r < rows and c < cols; the block's threads walk the rows.
template <bool Transpose, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ldd, const T* src, int64_t lds,
                                          int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, c = e % cols;
    dst[Transpose ? c * ldd + r : r * ldd + c] = to_f(src[r * lds + c]);
  }
}

}  // namespace gla

// The kernels shared by both sources, in the including file's own anonymous
// namespace (one per translation unit: each source gets its own copy).
namespace {

using namespace gla;

constexpr size_t kOuterSmem = (size_t)(kMaxC * kLdK + kMaxC * kLdKv) * sizeof(float);

// Stage 1: out[b, n, h, d, col0 + j] = sum_c x'[c, d] y[c, col0 + j] over the C
// rows of chunk n and head h, with x' = rnd<T>(x e^{G_last}) when egl is given
// (the forward's kc = kd e^{G_last}, times v) and x' = x without it (the
// backward's qd, times dO). x: [B, N*C, H, Dk], y: [B, N*C, H, Dv] in T; egl:
// [B, N, H, Dk] float32 or null; out: [B, N, H, Dk, Dv] float32.
// grid (B*N, H, Dv / kKvTile); each thread owns 4 rows of Dk x 8 columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_outer_kernel(const T* __restrict__ x, const float* __restrict__ egl,
                   const T* __restrict__ y, float* __restrict__ out, int C, int H, int Dv) {
  extern __shared__ float smem[];
  float* xs = smem;               // [C][kLdK]
  float* ys = xs + kMaxC * kLdK;  // [C][kLdKv]
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y, col0 = blockIdx.z * kKvTile;
  const int64_t ldx = (int64_t)H * kDk, ldy = (int64_t)H * Dv;
  const T* xc = x + (bn * C * H + h) * kDk;
  const float* eg = egl ? egl + (bn * H + h) * kDk : nullptr;
  for (int e = threadIdx.x; e < C * kDk; e += blockDim.x) {
    const int r = e / kDk, d = e % kDk;
    const float val = to_f(xc[r * ldx + d]);
    xs[r * kLdK + d] = eg ? rnd<T>(val * eg[d]) : val;
  }
  load_tile<false>(ys, kLdKv, y + (bn * C * H + h) * Dv + col0, ldy, C, kKvTile);
  __syncthreads();

  const int d0 = (threadIdx.x / 8) * 4, j0 = (threadIdx.x % 8) * 8;
  float acc[4][8];
  zero(acc);
  mm<float, float>(acc, xs, 1, kLdK, ys, kLdKv, 1, d0, j0, C);
  float* oc = out + (bn * H + h) * kDk * (int64_t)Dv + col0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) oc[(int64_t)(d0 + i) * Dv + j0 + j] = acc[i][j];
}

// Stage 2: for every entry e of the [B, H, Dk, Dv] state, one thread walks the
// chunks n (in reverse when `reverse`): x = buf[b, n, e]; buf[b, n, e] = z;
// z = z e^{G_last}[b, n, h, d] + x, from z = s_in[e]; then s_out[e] = z. buf
// [B, N, H, Dk, Dv] holds the per-chunk terms on entry and the chain's values
// on exit: the forward's entry states, or the backward's exit cotangents. The
// product and the sum are rounded separately, as the TPU kernel's are. The
// loads of kChainUnroll chunks are issued before their updates (they do not
// depend on z).
__global__ void __launch_bounds__(kThreads)
chain_kernel(float* __restrict__ buf, const float* __restrict__ egl,
             const float* __restrict__ s_in, float* __restrict__ s_out, int N, int H, int Dv,
             int64_t total, int reverse) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t per_b = (int64_t)H * kDk * Dv;
  const int64_t b = e / per_b, rem = e % per_b;
  const int64_t hd = rem / Dv;  // h * Dk + d
  float z = s_in[e];
  for (int i0 = 0; i0 < N; i0 += kChainUnroll) {
    float x[kChainUnroll], g[kChainUnroll];
#pragma unroll
    for (int u = 0; u < kChainUnroll; ++u) {
      const int i = i0 + u;
      if (i < N) {
        const int64_t bn = b * N + (reverse ? N - 1 - i : i);
        x[u] = buf[bn * per_b + rem];
        g[u] = egl[bn * H * kDk + hd];
      }
    }
#pragma unroll
    for (int u = 0; u < kChainUnroll; ++u) {
      const int i = i0 + u;
      if (i < N) {
        const int64_t bn = b * N + (reverse ? N - 1 - i : i);
        buf[bn * per_b + rem] = z;
        z = __fadd_rn(__fmul_rn(z, g[u]), x[u]);
      }
    }
  }
  s_out[e] = z;
}

// Launch stages 1 and 2 on `stream`; returns the first launch error.
template <typename T>
int outer_and_chain(const T* x, const float* egl_scale, const T* y, float* buf,
                    const float* egl, const float* s_in, float* s_out, int B, int N, int C,
                    int H, int Dv, int reverse, cudaStream_t stream) {
  cudaFuncSetAttribute(chunk_outer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kOuterSmem);
  chunk_outer_kernel<T><<<dim3(B * N, H, Dv / kKvTile), kThreads, kOuterSmem, stream>>>(
      x, egl_scale, y, buf, C, H, Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * H * kDk * Dv;
  chain_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      buf, egl, s_in, s_out, N, H, Dv, total, reverse);
  return (int)cudaGetLastError();
}

inline bool shape_ok(int C, int Dk, int Dv) {
  return Dk == kDk && C % 16 == 0 && C > 0 && C <= kMaxC && Dv % kKvTile == 0;
}

}  // namespace
