// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is a plain C ABI loaded with ctypes
// (deepspeed_tpu_torch/ops/cuda/build.py): pointers and the stream arrive as
// void*, each entry returns cudaGetLastError() right after its launches, and
// the Python wrapper raises when that is not cudaSuccess.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ds {

// dtype codes shared with the Python wrappers (ops/cuda/build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

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
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
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

// A split reduction finished by its last block, in one launch (K2's split
// over K, K3's split over the cache). Every block of a group stores its
// fp32 partial, then counts itself in on the group's counter; the block
// that arrives last sees every partial and reads them in the split's fixed
// order, so the result does not depend on which block came last, and only
// the count is atomic. That block also returns the counter to 0, so the
// wrapper's zeroed counter buffer is zeroed again for the next launch on
// the stream. Every thread of the block must call it; the last block then
// reads the partials with __ldcg (L2, never a stale L1 line).
__device__ __forceinline__ bool arrive_last(int* counter, int expected) {
  __shared__ int last;
  __threadfence();  // this thread's partial stores are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == expected - 1;
    if (last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Raise the dynamic shared-memory cap of one kernel instantiation once
// (above 48 KB a kernel must opt in before its first launch).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace ds
