// K2: x @ dequant(codes, scale) with the dequantisation fused into the GEMM.
//
// Replaces the Pallas TPU kernel `_qmm_kernel` (deepspeed_tpu/ops/pallas/
// quant_matmul.py:74, launched by `_pallas_quant_matmul` :94): x [M, K] in
// bf16 or fp32 times int8 codes [K, N] (or int4 codes packed two per byte
// along K, [K/2, N], low nibble = even row, sign-extended) scaled per
// (K-group, column) by fp32 scales [G, N]. Each weight is dequantised in
// fp32, rounded to x's dtype (as the JAX kernel feeds the MXU), multiplied in
// fp32, and the fp32 sum is written in x's dtype.
//
// What bounds it on the H100: at decode (M = 8) bytes — each code byte is
// used by 8 rows, so the least time is the code bytes over 3.35 TB/s; at a
// prefill chunk (M = 128) the two bounds are close (~256 FLOP per code
// byte). This first version multiplies with fp32 FMAs from shared memory,
// not tensor cores, so the prefill shape runs well under its bound.
//
// What the design does about it: codes move from device memory as int8 (or
// packed int4) and are expanded only in shared memory, so the dequantised
// weight never exists in device memory. A block owns a 32 x 64 output tile
// and walks K in 32-row steps, reading each row's group scale on the way in
// (any group size works, no tile has to align with a group). With few
// output tiles (decode) the K axis is split over blocks so that enough of
// them stream codes at once: each split writes an fp32 partial to a
// workspace the wrapper allocates, and a second small kernel sums the
// partials in a fixed order (deterministic, no atomics). The TPU grid
// carried the sum across its K-group steps in the output block; on Hopper
// blocks run in no order, hence the second pass.
#include "common.cuh"

namespace {

using ds::from_f;
using ds::to_f;

constexpr int kBM = 32;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;  // 16 x 8 threads, 4 x 4 outputs each

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ codes,
                        const float* __restrict__ scale, T* __restrict__ out,
                        float* __restrict__ partial, int M, int K, int N, int group_size,
                        long long ldx, int k_chunk) {
  __shared__ float Xs[kBM][kBK + 1];
  __shared__ float Ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int split = blockIdx.z;
  const int k_lo = split * k_chunk;
  const int k_hi = min(K, k_lo + k_chunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int m = m0 + r, kk = k0 + c;
      Xs[r][c] = (m < M && kk < k_hi) ? to_f(x[(long long)m * ldx + kk]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int kk = k0 + r, n = n0 + c;
      float w = 0.f;
      if (kk < k_hi && n < N) {
        int code;
        if (BITS == 8) {
          code = codes[(long long)kk * N + n];
        } else {
          const int byte = codes[(long long)(kk >> 1) * N + n];
          code = (kk & 1) ? ((byte >> 4) & 0xF) : (byte & 0xF);
          code = code > 7 ? code - 16 : code;  // sign-extend the nibble
        }
        // dequantise in fp32, then round to the activation dtype
        w = to_f(from_f<T>(static_cast<float>(code) * scale[(long long)(kk / group_size) * N + n]));
      }
      Ws[r][c] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[ty + 8 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (partial != nullptr)
        partial[((long long)split * M + m) * N + n] = acc[i][j];
      else
        out[(long long)m * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void reduce_splits_kernel(const float* __restrict__ partial, T* __restrict__ out,
                                     long long mn, int splits) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < mn;
       idx += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += partial[z * mn + idx];
    out[idx] = from_f<T>(sum);
  }
}

template <typename T, int BITS>
cudaError_t launch(const void* x, const void* codes, const void* scale, void* out,
                   void* workspace, int M, int K, int N, int group_size, long long ldx,
                   int k_chunk, int splits, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  quant_matmul_kernel<T, BITS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<T*>(out), partial, M, K, N, group_size, ldx,
      k_chunk);
  if (splits > 1) {
    const long long mn = (long long)M * N;
    const long long want = (mn + 255) / 256;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    reduce_splits_kernel<T><<<blocks, 256, 0, stream>>>(partial, static_cast<T*>(out), mn, splits);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bits(int bits, const void* x, const void* codes, const void* scale,
                          void* out, void* workspace, int M, int K, int N, int group_size,
                          long long ldx, int k_chunk, int splits, cudaStream_t stream) {
  if (bits == 8)
    return launch<T, 8>(x, codes, scale, out, workspace, M, K, N, group_size, ldx, k_chunk, splits, stream);
  if (bits == 4)
    return launch<T, 4>(x, codes, scale, out, workspace, M, K, N, group_size, ldx, k_chunk, splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: [M, K] (unit stride on K, row stride ldx); codes: contiguous int8 [K, N]
// (bits 8) or [K/2, N] (bits 4); scale: contiguous fp32 [K/group_size, N];
// out: contiguous [M, N] of x's dtype. splits > 1 needs an fp32 workspace of
// splits * M * N; each split covers k_chunk rows of K (a multiple of 32, and
// even for int4 so a packed byte never straddles two splits).
int ds_quant_matmul(const void* x, const void* codes, const void* scale, void* out,
                    void* workspace, int dtype, int bits, int M, int K, int N, int group_size,
                    long long ldx, int k_chunk, int splits, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || group_size <= 0 || K % group_size != 0) return cudaErrorInvalidValue;
  if (k_chunk <= 0 || k_chunk % kBK != 0 || splits < 1 || (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == ds::kFloat32)
    return dispatch_bits<float>(bits, x, codes, scale, out, workspace, M, K, N, group_size, ldx, k_chunk, splits, cs);
  if (dtype == ds::kBFloat16)
    return dispatch_bits<__nv_bfloat16>(bits, x, codes, scale, out, workspace, M, K, N, group_size, ldx, k_chunk, splits, cs);
  return cudaErrorInvalidValue;
}

const char* ds_quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
