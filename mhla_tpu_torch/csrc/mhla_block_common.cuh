// Device helpers shared by the blockwise MHLA kernels (mhla_block.cu,
// mhla_block_bwd.cu): loads and stores of four neighbouring elements, and of
// one, as float32 whatever the element type (float32 or bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mhla_block {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

}  // namespace mhla_block
