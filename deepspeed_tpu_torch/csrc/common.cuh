// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is a plain C ABI loaded with ctypes
// (deepspeed_tpu_torch/ops/cuda/build.py): pointers and the stream arrive as
// void*, each entry returns cudaGetLastError() right after its launches, and
// the Python wrapper raises when that is not cudaSuccess.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ds {

// dtype codes shared with the Python wrappers (ops/cuda/build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// finfo(float32).min: the masked-logit value of the JAX kernels (NEG_INF)
constexpr float kNegInf = -3.4028234663852886e38f;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raise the dynamic shared-memory cap of one kernel instantiation once
// (above 48 KB a kernel must opt in before its first launch).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace ds
