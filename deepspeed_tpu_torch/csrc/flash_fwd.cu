// K1: causal / length-masked / sliding-window flash attention forward.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (deepspeed_tpu/ops/pallas/
// flash_attention.py:117, launched by `_flash_fwd` :234): online-softmax
// attention over [B, L, H, D] tensors with fp32 accumulation, emitting O and
// the log-sum-exp [B, H, Lq] (NEG_INF/2 on rows with no live key).
//
// What bounds it on the H100: at the slice's shape (B=4, H=16, L=1024, D=64,
// causal, bf16) the work is ~8.6 GFLOP against ~34 MB of traffic, ~253
// FLOP/byte, just below the 295 FLOP/byte ridge: it is bound by bytes, with
// the bf16 tensor-core bound close behind (a larger D or a longer L crosses
// over, so a tensor-core version must keep its loads streaming as well). This
// first version issues the products as fp32 FMAs from shared memory (no
// mma/wgmma), so it runs far from either bound; the tensor-core version is
// later work.
//
// What the design does about it: one thread block per (q-tile of 64 rows,
// head, batch) loops over K/V tiles inside the block, keeping the running
// max, denominator and output accumulator in registers, so the [Lq, Lk] score
// matrix never reaches device memory. The TPU grid ran its K axis in order
// with state in VMEM scratch; here that axis is the in-block loop and blocks
// run in parallel in no order. The loop starts at the window's first live
// tile and stops at min(causal last, live-length last), so dead tiles are
// never loaded. Two threads share one query row: each owns the even or odd
// key columns of a tile and the even or odd output columns, and the pair
// combines its row max and row sum with one shuffle. Shared-memory rows are
// padded by one float so the pair's accesses fall in different banks.
#include "common.cuh"

namespace {

using ds::from_f;
using ds::to_f;

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;  // two threads per query row

template <int D>
constexpr int smem_bytes() {
  return (2 * kBK * (D + 1) + kBQ * (kBK + 1)) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ kv_lengths, int H, int Lq, int Lk, float scale,
                     int causal, int window, long long q_sb, long long q_sl, long long q_sh,
                     long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                     long long v_sl, long long v_sh) {
  extern __shared__ float smem[];
  float* Ks = smem;                  // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);    // [kBK][D + 1]
  float* Ps = Vs + kBK * (D + 1);    // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int r = tid >> 1;     // query row inside the tile
  const int half = tid & 1;   // which interleaved half of the columns
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int row = qt * kBQ + r;
  const bool row_ok = row < Lq;
  const int off = Lk - Lq;  // kv-cache offset: query i sits at position i + off
  const int qpos = row + off;
  const int kv_len = kv_lengths ? min(max(kv_lengths[b], 0), Lk) : Lk;

  // live key range of the whole tile (block-uniform, so every thread runs
  // the same loop and the barriers inside it are safe)
  const int q_first = qt * kBQ + off;
  const int q_last = min(qt * kBQ + kBQ, Lq) - 1 + off;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : t_begin;

  float qr[D];
  {
    const T* qp = q + b * q_sb + (long long)min(row, Lq - 1) * q_sl + h * q_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = row_ok ? to_f(qp[d]) * scale : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
  float m = ds::kNegInf, l = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // the previous tile's readers are done with Ks/Vs
    const int k0 = t * kBK;
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Lk) {
        kv = to_f(k[b * k_sb + (long long)kj * k_sl + h * k_sh + d]);
        vv = to_f(v[b * v_sb + (long long)kj * v_sl + h * v_sh + d]);
      }
      Ks[j * (D + 1) + d] = kv;
      Vs[j * (D + 1) + d] = vv;
    }
    __syncthreads();

    float s[kBK / 2];
    float tmax = ds::kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBK / 2; ++jj) {
      const int j = 2 * jj + half;
      const int kj = k0 + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Ks[j * (D + 1) + d], dot);
      bool ok = row_ok && kj < kv_len;
      if (causal) ok = ok && kj <= qpos;
      if (window > 0) ok = ok && kj > qpos - window;
      s[jj] = ok ? dot : ds::kNegInf;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 1 while the row has seen no live key
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBK / 2; ++jj) {
      // masked keys contribute an explicit 0, so a row with no live key
      // keeps l = 0 and finishes as zeros
      const float p = s[jj] == ds::kNegInf ? 0.f : expf(s[jj] - m_new);
      Ps[r * (kBK + 1) + 2 * jj + half] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's probabilities are written and read by its own pair
#pragma unroll
    for (int cc = 0; cc < D / 2; ++cc) {
      const int c = 2 * cc + half;
      float a = acc[cc] * alpha;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) a = fmaf(Ps[r * (kBK + 1) + j], Vs[j * (D + 1) + c], a);
      acc[cc] = a;
    }
  }

  if (!row_ok) return;
  const float l_safe = fmaxf(l, 1e-37f);
  T* op = o + (((long long)b * Lq + row) * H + h) * D;
#pragma unroll
  for (int cc = 0; cc < D / 2; ++cc) op[2 * cc + half] = from_f<T>(acc[cc] / l_safe);
  if (half == 0) lse[((long long)b * H + h) * Lq + row] = l > 0.f ? m + logf(l) : ds::kNegInf / 2;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const void* kv_lengths, int B, int H, int Lq, int Lk, float scale,
                   int causal, int window, const long long* st, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const int smem = smem_bytes<D>();
  static cudaError_t attr = ds::allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_lengths), H, Lq,
      Lk, scale, causal, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, void* lse,
                       const void* kv_lengths, int B, int H, int Lq, int Lk, float scale,
                       int causal, int window, const long long* st, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, kv_lengths, B, H, Lq, Lk, scale, causal, window, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v: [B, L, H, D] with unit stride on D and element strides (batch, len,
// head) for each; o: contiguous [B, Lq, H, D] of q's dtype; lse: contiguous
// [B, H, Lq] fp32; kv_lengths: [B] int32 or null; window <= 0 means none.
int ds_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                 const void* kv_lengths, int dtype, int B, int H, int Lq, int Lk, int D,
                 float scale, int causal, int window, long long q_sb, long long q_sl,
                 long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                 long long v_sl, long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  if (dtype == ds::kFloat32)
    return dispatch_d<float>(D, q, k, v, o, lse, kv_lengths, B, H, Lq, Lk, scale, causal, window, st, s);
  if (dtype == ds::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, kv_lengths, B, H, Lq, Lk, scale, causal, window, st, s);
  return cudaErrorInvalidValue;
}

const char* ds_flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
