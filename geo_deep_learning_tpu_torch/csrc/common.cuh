// Shared helpers of the port's hand-written kernels.
//
// Every kernel is reached through an `extern "C"` entry point that takes
// raw pointers and the caller's CUDA stream, launches, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// 16-byte vector load/store of 16 / sizeof(T) elements, widened to f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int N = 16 / sizeof(T);
  __align__(16) T tmp[N];
  *reinterpret_cast<uint4*>(tmp) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = to_f32(tmp[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float* src) {
  constexpr int N = 16 / sizeof(T);
  __align__(16) T tmp[N];
#pragma unroll
  for (int i = 0; i < N; ++i) tmp[i] = from_f32<T>(src[i]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
