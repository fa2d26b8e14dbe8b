// Forward kernels of the non-causal blockwise MHLA island for Hopper (sm_90a):
//
//   K6 mix_states_dense  mixed[b, i] = sum_j M[i, j] S[b, j]      dense [N, N] mixing
//   K7 block_readout     o[b, i, :, h] = q[b, i, :, h] @ mixed[b, i, h]
//
// Both come in float32 (the default attention island of the video model:
// true float32 products, no TF32) and in bf16 (attn_compute_dtype=bfloat16);
// both accumulate in float32 and round once to the element type.
//
// Layout: tokens are head-flat and blocked, [B, N, C, H*D]; the states and
// the mixed states are [B, N, H*Dk, Dv].
//
// K6 replaces mix_states_dense (mhla_tpu/kernels/mhla_block_pallas.py:51),
//   which runs _mix_kernel (mhla_tpu/kernels/mhla_chunk_pallas.py:293) with
//   one full band. The causal K3 of mhla_chunk.cu keeps at most 32 strictly
//   lower slots in registers; the video model mixes N = 150 blocks densely.
//   Bound: in float32, operations: per batch row it is an [N, N] x [N, R]
//   product with R = H*Dk*Dv state columns, 2*N*N*R FLOP against 8*N*R
//   bytes, N/4 = 37 FLOP/byte at N = 150, above the card's float32 ridge
//   (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte). In bf16, bytes.
//   Design: S is read exactly once. A block owns a tile of 32 state columns
//   for all N rows: it stages the [N, 32] tile of S in shared memory as
//   float32, keeps M transposed in shared memory, and each thread
//   accumulates ROWS x 4 outputs in registers over the N-long sum (rows
//   ty, ty + 32, ...; 4 neighbouring columns). Blocks walk over many tiles
//   so M is staged once per block, not once per tile. The bf16 form shares
//   the arithmetic (SIMT float32 FMAs) and differs only in its loads and
//   stores.
//
// K7 replaces _readout_fwd_kernel (mhla_block_pallas.py:100). The TPU kernel
//   groups G blocks of rows into one supertile and masks rows to feed its
//   128 x 128 matrix unit; here one thread block computes one (block, head,
//   128-column tile of Dv) and none of that tiling is carried over.
//   Bound: in float32, operations (2*C*Dk*Dv FLOP per block and head
//   against 4*(C*Dk + Dk*Dv + C*Dv) bytes: 21 FLOP/byte at C = 210,
//   Dk = Dv = 128, just above the float32 ridge). In bf16, bytes.
//   Design: the [Dk, 128] slice of the mixed state stays in shared memory
//   for the whole block of tokens; q rows pass through shared memory 32 at
//   a time (rows past C are zero-filled and never stored: C = 210 is not a
//   multiple of the tile), and each thread accumulates a 4 x 4 output
//   micro-tile with float4 shared-memory reads.

#include "mhla_block_common.cuh"

using namespace mhla_block;

namespace {

constexpr int kThreads = 256;
constexpr int kMixCols = 32;     // state columns per tile of K6
constexpr int kMaxMixRows = 7;   // K6 rows per thread: N <= 32 * kMaxMixRows
constexpr int kReadRows = 32;    // q rows per pass of K7
constexpr int kReadCols = 128;   // Dv columns per block of K7

// K6. grid (blocks per batch row, B); dynamic shared memory
// (N*N rounded up to 4 + N*kMixCols) floats. m: [N, N] float32; s, out: [B, N, R].
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
mix_dense_kernel(const float* __restrict__ m, const T* __restrict__ s,
                 T* __restrict__ out, int N, int64_t R, int tiles) {
  extern __shared__ __align__(16) float smem[];
  float* mt = smem;           // [N][N], transposed: mt[j*N + i] = m[i*N + j]
  float* st = smem + ((N * N + 3) & ~3);  // [N][kMixCols], 16-byte aligned
  const int tid = threadIdx.x;
  for (int e = tid; e < N * N; e += kThreads) {
    const int i = e / N, j = e % N;
    mt[j * N + i] = m[e];
  }
  const int tx = tid & 7, ty = tid >> 3;  // 8 column quads x 32 row lanes
  int rows[ROWS];
#pragma unroll
  for (int a = 0; a < ROWS; ++a) rows[a] = min(ty + 32 * a, N - 1);
  const T* sb = s + (int64_t)blockIdx.y * N * R;
  T* ob = out + (int64_t)blockIdx.y * N * R;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t col0 = (int64_t)tile * kMixCols;
    __syncthreads();  // mt is written; the previous tile's reads of st are done
    for (int e = tid; e < N * (kMixCols / 4); e += kThreads) {
      const int j = e >> 3, c4 = (e & 7) * 4;
      *reinterpret_cast<float4*>(st + j * kMixCols + c4) = load4(sb + j * R + col0 + c4);
    }
    __syncthreads();
    float acc[ROWS][4];
#pragma unroll
    for (int a = 0; a < ROWS; ++a)
      acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float4 sv = *reinterpret_cast<const float4*>(st + j * kMixCols + tx * 4);
      const float* mrow = mt + j * N;
#pragma unroll
      for (int a = 0; a < ROWS; ++a) {
        const float w = mrow[rows[a]];
        acc[a][0] = fmaf(w, sv.x, acc[a][0]);
        acc[a][1] = fmaf(w, sv.y, acc[a][1]);
        acc[a][2] = fmaf(w, sv.z, acc[a][2]);
        acc[a][3] = fmaf(w, sv.w, acc[a][3]);
      }
    }
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int i = ty + 32 * a;
      if (i < N)
        store4(ob + i * R + col0 + tx * 4,
               make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    }
  }
}

// K7. grid (B*N, H, Dv/kReadCols); dynamic shared memory
// (Dk*kReadCols + kReadRows*Dk) floats. q: [B*N, C, H*Dk],
// mixed: [B*N, H*Dk, Dv], o: [B*N, C, H*Dv].
template <typename T>
__global__ void __launch_bounds__(kThreads)
readout_kernel(const T* __restrict__ q, const T* __restrict__ mixed,
               T* __restrict__ o, int C, int H, int Dk, int Dv) {
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;                   // [Dk][kReadCols]
  float* qs = smem + Dk * kReadCols;  // [kReadRows][Dk]
  const int tid = threadIdx.x;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y, tn = blockIdx.z;
  const int64_t ldq = (int64_t)H * Dk, ldo = (int64_t)H * Dv;
  const T* qc = q + bn * C * ldq + h * Dk;
  const T* mc = mixed + (bn * H + h) * Dk * Dv + tn * kReadCols;
  T* oc = o + bn * C * ldo + h * Dv + tn * kReadCols;

  for (int e = tid; e < Dk * (kReadCols / 4); e += kThreads) {
    const int k = e / (kReadCols / 4), c4 = (e % (kReadCols / 4)) * 4;
    *reinterpret_cast<float4*>(ms + k * kReadCols + c4) = load4(mc + (int64_t)k * Dv + c4);
  }
  const int tx = tid & 31, ty = tid >> 5;  // 32 column quads x 8 row quads
  const int dk4 = Dk / 4;
  for (int r0 = 0; r0 < C; r0 += kReadRows) {
    __syncthreads();  // ms is written; the previous pass's reads of qs are done
    for (int e = tid; e < kReadRows * dk4; e += kThreads) {
      const int r = e / dk4, k4 = (e % dk4) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < C) val = load4(qc + (int64_t)(r0 + r) * ldq + k4);
      *reinterpret_cast<float4*>(qs + r * Dk + k4) = val;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
    for (int k = 0; k < Dk; k += 4) {
      float4 mv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mv[kk] = *reinterpret_cast<const float4*>(ms + (k + kk) * kReadCols + tx * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (ty * 4 + a) * Dk + k);
        const float qk[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[a][0] = fmaf(qk[kk], mv[kk].x, acc[a][0]);
          acc[a][1] = fmaf(qk[kk], mv[kk].y, acc[a][1]);
          acc[a][2] = fmaf(qk[kk], mv[kk].z, acc[a][2]);
          acc[a][3] = fmaf(qk[kk], mv[kk].w, acc[a][3]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = r0 + ty * 4 + a;
      if (row < C)
        store4(oc + (int64_t)row * ldo + tx * 4,
               make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    }
  }
}

template <typename T, int ROWS>
int launch_mix(const void* m, const void* s, void* out, int B, int N,
               long long R, cudaStream_t stream) {
  auto kern = mix_dense_kernel<T, ROWS>;
  const size_t smem = (size_t)(((N * N + 3) & ~3) + N * kMixCols) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (int)(R / kMixCols);
  int per_row = 264 / B;  // two resident blocks on each of the 132 SMs
  if (per_row < 1) per_row = 1;
  if (per_row > tiles) per_row = tiles;
  dim3 grid(per_row, B);
  kern<<<grid, kThreads, smem, stream>>>((const float*)m, (const T*)s, (T*)out,
                                         N, (int64_t)R, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mix(const void* m, const void* s, void* out, int B, int N,
                 long long R, cudaStream_t stream) {
  switch ((N + 31) / 32) {
    case 1: return launch_mix<T, 1>(m, s, out, B, N, R, stream);
    case 2: return launch_mix<T, 2>(m, s, out, B, N, R, stream);
    case 3: return launch_mix<T, 3>(m, s, out, B, N, R, stream);
    case 4: return launch_mix<T, 4>(m, s, out, B, N, R, stream);
    case 5: return launch_mix<T, 5>(m, s, out, B, N, R, stream);
    case 6: return launch_mix<T, 6>(m, s, out, B, N, R, stream);
    case 7: return launch_mix<T, 7>(m, s, out, B, N, R, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_readout(const void* q, const void* mixed, void* o, int bn, int C,
                   int H, int Dk, int Dv, cudaStream_t stream) {
  auto kern = readout_kernel<T>;
  const size_t smem = (size_t)(Dk * kReadCols + kReadRows * Dk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bn, H, Dv / kReadCols);
  kern<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)mixed, (T*)o, C,
                                         H, Dk, Dv);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns the launch's cudaError_t.
// ``is_bf16`` selects the element type of the tensors (else float32).
extern "C" {

int mhla_mix_states_dense(const void* m, const void* s, void* out, int B, int N,
                          long long R, int is_bf16, void* stream) {
  if (N < 1 || N > 32 * kMaxMixRows || R % kMixCols) return (int)cudaErrorInvalidValue;
  return is_bf16 ? dispatch_mix<bf16>(m, s, out, B, N, R, (cudaStream_t)stream)
                 : dispatch_mix<float>(m, s, out, B, N, R, (cudaStream_t)stream);
}

int mhla_block_readout(const void* q, const void* mixed, void* o, int bn, int C,
                       int H, int Dk, int Dv, int is_bf16, void* stream) {
  if (Dk % 4 || Dk > 256 || Dv % kReadCols) return (int)cudaErrorInvalidValue;
  return is_bf16
             ? launch_readout<bf16>(q, mixed, o, bn, C, H, Dk, Dv, (cudaStream_t)stream)
             : launch_readout<float>(q, mixed, o, bn, C, H, Dk, Dv, (cudaStream_t)stream);
}

}  // extern "C"
