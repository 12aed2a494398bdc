// Shared by every kernel library: the C export macro, the error string
// entry that the Python binding (dbsr_tpu_torch/kernels/__init__.py) reads,
// the cp.async helpers of the kernels that stage tiles with it, and the
// bfloat16 loads and stores of the bf16 instantiations. Each .cu file is
// built into its own shared library and includes this once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define DBSR_EXPORT extern "C" __attribute__((visibility("default")))

DBSR_EXPORT const char* dbsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cp.async of kBytes (4, 8 or 16) with src_bytes of them read, the rest
// zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes));
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending committed groups are still in flight
template <int kPending = 0>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// bfloat16 I/O with float32 math: a load widens exactly (a bf16 is the top
// half of a float32), a store rounds to nearest even, once.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_lo(uint32_t pair) {
  return __uint_as_float(pair << 16);  // the element at the lower address
}
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}
__device__ __forceinline__ float load_bf16(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to bfloat16 and widened back: the value a bf16 operand holds
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// two floats rounded into one 32-bit pair, a at the lower address
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 x bf16 in one 16-byte access (the pointer 16-byte aligned)
__device__ __forceinline__ void load_bf16x8(const bf16* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(w[i]);
    v[2 * i + 1] = bf16_hi(w[i]);
  }
}
__device__ __forceinline__ void store_bf16x8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}
// 4 x bf16 in one 8-byte access (the pointer 8-byte aligned)
__device__ __forceinline__ float4 load_bf16x4(const bf16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(r.x), bf16_hi(r.x), bf16_lo(r.y), bf16_hi(r.y));
}
__device__ __forceinline__ void store_bf16x4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}
