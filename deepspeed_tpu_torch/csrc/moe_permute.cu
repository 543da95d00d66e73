// K5: row permutation with drop, the one data movement of the sorted MoE
// dispatch/combine route.
//
// Replaces the Pallas TPU kernel `_permute_kernel` (deepspeed_tpu/ops/pallas/
// moe_dispatch.py:76, launched by `_pallas_permute` :83; its VJP
// `_pallas_permute_vjp` :109-128 is the same kernel on the inverse index):
// out[g, r] = x[g, idx[g, r]] for idx in [0, N), and a zero row otherwise.
// The dispatch gathers each expert-capacity slot's token ([1, 8192, 1024] ->
// [1, 10240, 1024] on the GPT-2 350m MoE step), the combine gathers each
// token copy's expert output back ([1, 10240, 1024] -> [1, 8192, 1024]).
//
// What bounds it on the H100: bytes. It does no arithmetic; the least time
// is one read of each live source row, one write of every output row and
// the index, over 3.35 TB/s (about 37.7 MB, 0.011 ms, per call in bf16).
//
// What the design does about it: the TPU kernel ran one grid step per
// output row and let the scalar-prefetched index drive that step's DMA.
// Here a block of 128 threads owns kRows consecutive output rows, reads
// their kRows indices once, and copies the rows as 16-byte vectors (8- to
// 2-byte ones when the row width or the base address does not allow 16),
// issuing all kRows loads of a column before their stores, so each thread
// keeps kRows independent loads in flight. A dead row (index out of range)
// reads nothing and writes zeros. The copy is exact in any element type;
// the dtype code only fixes the element size.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 4;       // output rows per block

template <typename V>
__device__ __forceinline__ V zero_vec();
template <>
__device__ __forceinline__ uint4 zero_vec<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }
template <>
__device__ __forceinline__ uint2 zero_vec<uint2>() { return make_uint2(0u, 0u); }
template <>
__device__ __forceinline__ unsigned int zero_vec<unsigned int>() { return 0u; }
template <>
__device__ __forceinline__ unsigned short zero_vec<unsigned short>() { return 0; }

// x: [G, N, W] vectors, idx: [G, R] int32, out: [G, R, W] vectors, all
// contiguous. Grid: (ceil(R / kRows), G).
template <typename V>
__global__ void __launch_bounds__(kThreads)
    permute_kernel(const V* __restrict__ x, const int* __restrict__ idx, V* __restrict__ out,
                   int N, int R, int W) {
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const V* xg = x + static_cast<long long>(g) * N * W;
  V* og = out + static_cast<long long>(g) * R * W;
  const int* ig = idx + static_cast<long long>(g) * R;

  int src[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = r0 + j;
    const int s = r < R ? __ldg(ig + r) : -1;
    src[j] = (s >= 0 && s < N) ? s : -1;  // -1: a dead row, or past the end
  }
  for (int w = threadIdx.x; w < W; w += kThreads) {
    V v[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      v[j] = src[j] >= 0 ? __ldg(xg + static_cast<long long>(src[j]) * W + w) : zero_vec<V>();
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (r0 + j < R) og[static_cast<long long>(r0 + j) * W + w] = v[j];
  }
}

template <typename V>
cudaError_t launch(const void* x, const void* idx, void* out, int G, int N, int R,
                   long long row_bytes, cudaStream_t stream) {
  const int W = static_cast<int>(row_bytes / sizeof(V));
  const dim3 grid((R + kRows - 1) / kRows, G);
  permute_kernel<V><<<grid, kThreads, 0, stream>>>(static_cast<const V*>(x),
                                                  static_cast<const int*>(idx),
                                                  static_cast<V*>(out), N, R, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous [G, N, M] of `dtype`; idx: contiguous [G, R] int32; out:
// contiguous [G, R, M] of `dtype`. N may be 0 (every row dead).
int ds_moe_permute(const void* x, const void* idx, void* out, int dtype, int G, int N, int R,
                   int M, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  int elem = 0;
  if (dtype == ds::kFloat32) elem = 4;
  if (dtype == ds::kBFloat16) elem = 2;
  if (elem == 0 || G <= 0 || G > 65535 || N < 0 || R <= 0 || M <= 0) return cudaErrorInvalidValue;
  const long long row_bytes = static_cast<long long>(M) * elem;
  const unsigned long long base =
      reinterpret_cast<unsigned long long>(x) | reinterpret_cast<unsigned long long>(out);
  if (row_bytes % 16 == 0 && base % 16 == 0)
    return launch<uint4>(x, idx, out, G, N, R, row_bytes, cs);
  if (row_bytes % 8 == 0 && base % 8 == 0)
    return launch<uint2>(x, idx, out, G, N, R, row_bytes, cs);
  if (row_bytes % 4 == 0 && base % 4 == 0)
    return launch<unsigned int>(x, idx, out, G, N, R, row_bytes, cs);
  return launch<unsigned short>(x, idx, out, G, N, R, row_bytes, cs);
}

const char* ds_moe_permute_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
