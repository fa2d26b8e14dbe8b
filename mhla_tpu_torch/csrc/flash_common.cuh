// Device helpers shared by the flash-attention kernels (flash_bwd.cu,
// radial_fwd.cu): the bf16 tensor-core product mma.sync m16n8k16, ldmatrix
// fragment loads from shared memory, cp.async copies into it (radial_fwd.cu),
// packing, and the radial mask's rule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, aligned); r[i] gets, of matrix i,
// the pair at row lane / 4, columns 2 * (lane % 4) and + 1 (the transposed
// form: rows 2 * (lane % 4) and + 1 of column lane / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// 16 bytes from device memory to shared memory without passing registers;
// ``valid`` false copies nothing and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// The same for one float (4 bytes).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

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
