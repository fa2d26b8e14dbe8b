// K7b: backward of the block readout of the non-causal blockwise MHLA island
// for Hopper (sm_90a). From q [B*N, C, H*Dk], mixed [B*N, H*Dk, Dv] and
// dO [B*N, C, H*Dv], per block i and head h:
//
//   dq[i, :, h]   = dO[i, :, h] @ mixed[i, h]^T      [C, Dk]
//   dmixed[i, h]  = q[i, :, h]^T @ dO[i, :, h]       [Dk, Dv]
//
// float32 (the default attention island: true float32 products, no TF32) or
// bf16 elements; both accumulate in float32 and round once.
//
// Replaces _readout_bwd_kernel (mhla_tpu/kernels/mhla_block_pallas.py:116).
// The TPU kernel groups G blocks of rows into one supertile and masks rows
// and columns to feed its 128 x 128 matrix unit; none of that is carried
// over: one thread block computes both products of one (block, head,
// 128-row tile of Dk), with Dv = 128.
// Bound: in float32, operations (4*C*Dk*Dv FLOP per block and head against
// 4*(2*C*Dk + 2*Dk*Dv + C*Dv) bytes: 25 FLOP/byte at C = 210, Dk = Dv = 128,
// above the float32 ridge of 20). In bf16, bytes.
// Design: q and dO are read once and serve both products. The [128, 128]
// tile of the mixed state stays in shared memory for the whole block of
// tokens (rows padded by 4 floats, so the 8 row reads of a quarter warp hit
// 32 distinct banks); q and dO rows pass through shared memory 32 at a time
// (rows past C are zero-filled and never stored: C = 210 is not a multiple
// of the tile). Per pass each thread finishes a 4 x 4 tile of dq (rows
// 4*ty + a, columns tx + 32*kk: four dot products over Dv with float4 reads)
// and adds the pass's 32 outer products into its 8 x 8 tile of dmixed, which
// lives in registers until the block's tokens are done.

#include "mhla_block_common.cuh"

using namespace mhla_block;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;       // token rows per pass
constexpr int kDim = 128;       // Dv, and the tile of Dk a block owns
constexpr int kLdM = kDim + 4;  // row stride of the mixed tile in shared memory
constexpr int kSmemBytes = (kDim * kLdM + 2 * kRows * kDim) * (int)sizeof(float);

// grid (B*N, H, Dk / 128); dynamic shared memory kSmemBytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
readout_bwd_kernel(const T* __restrict__ q, const T* __restrict__ mixed,
                   const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dmixed,
                   int C, int H, int Dk) {
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;                  // [128 k][kLdM]: mixed[k][v]
  float* qs = smem + kDim * kLdM;    // [kRows][128 k]
  float* ds = qs + kRows * kDim;     // [kRows][128 v]
  const int tid = threadIdx.x;
  const int64_t bn = blockIdx.x;
  const int h = blockIdx.y, kt = blockIdx.z;
  const int64_t ldq = (int64_t)H * Dk, ldo = (int64_t)H * kDim;
  const int64_t qoff = bn * C * ldq + (int64_t)h * Dk + kt * kDim;
  const T* qc = q + qoff;
  T* dqc = dq + qoff;
  const T* doc = dout + bn * C * ldo + (int64_t)h * kDim;
  const int64_t moff = ((bn * H + h) * Dk + (int64_t)kt * kDim) * kDim;
  const T* mc = mixed + moff;
  T* dmc = dmixed + moff;

  for (int e = tid; e < kDim * (kDim / 4); e += kThreads) {
    const int k = e / (kDim / 4), c4 = (e % (kDim / 4)) * 4;
    *reinterpret_cast<float4*>(ms + k * kLdM + c4) = load4(mc + (int64_t)k * kDim + c4);
  }
  const int tx = tid & 31, ty = tid >> 5;  // dq: rows 4*ty + a, columns tx + 32*kk
  const int kx = tid >> 4, vx = tid & 15;  // dmixed: rows 4*kx + i (+64), columns 4*vx + j (+64)
  float dm[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dm[i][j] = 0.f;

  for (int r0 = 0; r0 < C; r0 += kRows) {
    __syncthreads();  // ms is written; the previous pass's reads of qs and ds are done
    for (int e = tid; e < kRows * (kDim / 4); e += kThreads) {
      const int r = e / (kDim / 4), c4 = (e % (kDim / 4)) * 4;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), dv = qv;
      if (r0 + r < C) {
        qv = load4(qc + (int64_t)(r0 + r) * ldq + c4);
        dv = load4(doc + (int64_t)(r0 + r) * ldo + c4);
      }
      *reinterpret_cast<float4*>(qs + r * kDim + c4) = qv;
      *reinterpret_cast<float4*>(ds + r * kDim + c4) = dv;
    }
    __syncthreads();

    // dq[r, k] = sum_v dO[r, v] * mixed[k, v]
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
    for (int v = 0; v < kDim; v += 4) {
      float4 mv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mv[kk] = *reinterpret_cast<const float4*>(ms + (tx + 32 * kk) * kLdM + v);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 d = *reinterpret_cast<const float4*>(ds + (ty * 4 + a) * kDim + v);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[a][kk] = fmaf(d.x, mv[kk].x, acc[a][kk]);
          acc[a][kk] = fmaf(d.y, mv[kk].y, acc[a][kk]);
          acc[a][kk] = fmaf(d.z, mv[kk].z, acc[a][kk]);
          acc[a][kk] = fmaf(d.w, mv[kk].w, acc[a][kk]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = r0 + ty * 4 + a;
      if (row < C) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) store1(dqc + (int64_t)row * ldq + tx + 32 * kk, acc[a][kk]);
      }
    }

    // dmixed[k, v] += sum_r q[r, k] * dO[r, v]
    for (int r = 0; r < kRows; ++r) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + r * kDim + kx * 4);
      const float4 qb = *reinterpret_cast<const float4*>(qs + r * kDim + 64 + kx * 4);
      const float4 da = *reinterpret_cast<const float4*>(ds + r * kDim + vx * 4);
      const float4 db = *reinterpret_cast<const float4*>(ds + r * kDim + 64 + vx * 4);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float dv[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dm[i][j] = fmaf(qv[i], dv[j], dm[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = (i < 4 ? 0 : 60) + kx * 4 + i;  // rows 4*kx + i, then 64 + 4*kx + (i - 4)
    store4(dmc + (int64_t)k * kDim + vx * 4, make_float4(dm[i][0], dm[i][1], dm[i][2], dm[i][3]));
    store4(dmc + (int64_t)k * kDim + 64 + vx * 4,
           make_float4(dm[i][4], dm[i][5], dm[i][6], dm[i][7]));
  }
}

template <typename T>
int launch_readout_bwd(const void* q, const void* mixed, const void* dout, void* dq,
                       void* dmixed, int bn, int C, int H, int Dk, cudaStream_t stream) {
  auto kern = readout_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bn, H, Dk / kDim);
  kern<<<grid, kThreads, kSmemBytes, stream>>>((const T*)q, (const T*)mixed, (const T*)dout,
                                               (T*)dq, (T*)dmixed, C, H, Dk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches on the given stream,
// does not synchronise, returns the launch's cudaError_t. ``is_bf16`` selects
// the element type of the tensors (else float32).
extern "C" int mhla_block_readout_bwd(const void* q, const void* mixed, const void* dout,
                                      void* dq, void* dmixed, int bn, int C, int H, int Dk,
                                      int Dv, int is_bf16, void* stream) {
  if (Dk < kDim || Dk % kDim || Dv != kDim || bn < 1 || C < 1) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_readout_bwd<bf16>(q, mixed, dout, dq, dmixed, bn, C, H, Dk,
                                            (cudaStream_t)stream)
                 : launch_readout_bwd<float>(q, mixed, dout, dq, dmixed, bn, C, H, Dk,
                                             (cudaStream_t)stream);
}
