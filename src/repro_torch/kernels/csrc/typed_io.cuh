// Loads and stores of the element types the LM kernels take (float32 and
// bfloat16), always computing in float32. The dtype codes are the ones the
// Python wrappers pass (kernels/flash_attention.py, kernels/wkv6.py).
#pragma once

#include <cuda_bf16.h>

namespace typed_io {

enum Dtype : int { F32 = 0, BF16 = 1 };

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void store(T* p, float x);
template <>
__device__ __forceinline__ void store<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// x as a value of T would hold it (float32 keeps it; bfloat16 rounds)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

}  // namespace typed_io
