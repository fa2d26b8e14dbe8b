// Device helpers shared by the block readout kernels, K7 (mhla_block.cu)
// and K7b (mhla_block_bwd.cu): four neighbouring elements of a float32 or
// bf16 tensor as loaded and as float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mhla_block {

typedef __nv_bfloat16 bf16;

// Four neighbouring elements of T as loaded (float4 or four bf16).
template <typename T>
struct Raw4 {
  typedef float4 type;
};
template <>
struct Raw4<bf16> {
  typedef uint2 type;
};

__device__ __forceinline__ float4 raw_to_float4(float4 v) { return v; }
__device__ __forceinline__ float4 raw_to_float4(uint2 raw) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

}  // namespace mhla_block
