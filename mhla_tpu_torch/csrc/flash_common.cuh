// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): bf16 packing and the radial mask's rule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2f(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The radial mask. Tokens are frame-major in frames of hw: token i lies in
// frame i / hw at spatial index i % hw (a token count that is no multiple of
// hw leaves a last, shorter frame). The spatial window at frame distance d
// is hw for d <= 1 and halves per octave beyond.
__device__ __forceinline__ int radial_window(int d, int hw) {
  return hw >> (31 - __clz(max(d, 1)));
}

// Whether the pair of tokens at (frame fa, spatial sa) and (fb, sb) is allowed.
__device__ __forceinline__ bool radial_keep(int fa, int sa, int fb, int sb, int hw) {
  return abs(sa - sb) < radial_window(abs(fa - fb), hw);
}

}  // namespace flash
