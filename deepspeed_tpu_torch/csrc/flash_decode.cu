// K3: length-masked decode attention against a per-slot KV cache.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (deepspeed_tpu/ops/pallas/
// flash_attention.py:555, launched by `flash_decode` :602): the newest Lq
// query tokens of each slot attend its [P, H, D] cache, where row i sits at
// position lengths[s] - Lq + i and sees the keys at or before it. Rows with
// no live key, and slots with length 0, return zeros.
//
// What bounds it on the H100: bytes. Each live key and value is used by at
// most Lq (1 or 16) query rows, so the work is a few FLOPs per byte read,
// two orders of magnitude under the 295 FLOP/byte ridge; the least time is
// the live K/V bytes over 3.35 TB/s.
//
// What the design does about it: one thread block per (head, slot, group of
// up to 16 query rows) streams only the live prefix of that slot's cache,
// tile by tile, through shared memory, with the online-softmax state in
// shared memory and registers, so nothing but the output is written. The
// loop is clamped to min(length, P): a parked slot carries length P + Lq
// (past the pool), and the TPU grid never ran past the pool's block count,
// so the clamp keeps the same contract here. It is not split over the cache
// (no second reduction pass), so a single long slot runs on one SM; split-K
// over the cache is later work, as is reading the int8 KV codes directly
// (the serving path dequantises the pool in plain torch before this kernel).
#include "common.cuh"

namespace {

using ds::from_f;
using ds::to_f;

constexpr int kRows = 16;      // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;

template <int D>
constexpr int smem_floats() {
  return kRows * D + 2 * kBK * (D + 1) + kRows * (kBK + 1) + 3 * kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ o, int H, int Lq, int P,
                        float scale, long long q_sb, long long q_sl, long long q_sh,
                        long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                        long long v_sl, long long v_sh) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kRows][D], pre-scaled
  float* Ks = Qs + kRows * D;            // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);        // [kBK][D + 1]
  float* Ps = Vs + kBK * (D + 1);        // [kRows][kBK + 1]
  float* m_s = Ps + kRows * (kBK + 1);   // [kRows] running max
  float* l_s = m_s + kRows;              // [kRows] running denominator
  float* a_s = l_s + kRows;              // [kRows] this tile's rescale factor

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, s = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int length = lengths[s];
  const int n_live = min(max(length, 0), P);  // the clamp: never read past the pool

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    const int row = row0 + i;
    Qs[idx] = row < Lq ? to_f(q[s * q_sb + (long long)row * q_sl + h * q_sh + d]) * scale : 0.f;
  }
  if (tid < kRows) {
    m_s[tid] = ds::kNegInf;
    l_s[tid] = 0.f;
  }
  constexpr int kAcc = (kRows * D) / kThreads;  // accumulator entries per thread
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;

  const int n_tiles = (n_live + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // Qs/stats ready; the previous tile's readers are done
    const int k0 = t * kBK;
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < n_live) {
        kv = to_f(k[s * k_sb + (long long)kj * k_sl + h * k_sh + d]);
        vv = to_f(v[s * v_sb + (long long)kj * v_sl + h * v_sh + d]);
      }
      Ks[j * (D + 1) + d] = kv;
      Vs[j * (D + 1) + d] = vv;
    }
    __syncthreads();

    // scores: entry e = (row i, key j); a warp covers 32 keys of one row
    for (int e = tid; e < kRows * kBK; e += kThreads) {
      const int i = e / kBK, j = e % kBK;
      const int row = row0 + i, kj = k0 + j;
      const int qpos = length - Lq + row;
      const bool ok = row < Lq && kj < n_live && kj <= qpos;
      float dot = 0.f;
      if (row < Lq) {  // warp-uniform: a decode step (Lq = 1) skips the idle rows
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(Qs[i * D + d], Ks[j * (D + 1) + d], dot);
      }
      Ps[i * (kBK + 1) + j] = ok ? dot : ds::kNegInf;
    }
    __syncthreads();

    // online-softmax statistics: one warp per row
    for (int i = warp; i < kRows && row0 + i < Lq; i += kWarps) {
      float* pr = Ps + i * (kBK + 1);
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float tmax = ds::warp_max(fmaxf(s0, s1));
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, tmax);
      // masked keys give an explicit 0: a row with no live key keeps l = 0
      const float p0 = s0 == ds::kNegInf ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == ds::kNegInf ? 0.f : expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float psum = ds::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + psum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int idx = tid + e * kThreads;
      const int i = idx / D, c = idx % D;
      if (row0 + i >= Lq) continue;  // warp-uniform, as above
      const float* pr = Ps + i * (kBK + 1);
      float a = acc[e] * a_s[i];
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) a = fmaf(pr[j], Vs[j * (D + 1) + c], a);
      acc[e] = a;
    }
  }
  __syncthreads();  // l_s final (also covers n_tiles == 0)

#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    const int idx = tid + e * kThreads;
    const int i = idx / D, c = idx % D;
    const int row = row0 + i;
    if (row < Lq) {
      const float l_safe = fmaxf(l_s[i], 1e-37f);
      o[(((long long)s * Lq + row) * H + h) * D + c] = from_f<T>(acc[e] / l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
                   int S, int H, int Lq, int P, float scale, const long long* st,
                   cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T, D>;
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static cudaError_t attr = ds::allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(H, S, (Lq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(o), H, Lq, P, scale, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* lengths,
                       void* o, int S, int H, int Lq, int P, float scale, const long long* st,
                       cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, S, H, Lq, P, scale, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: [S, Lq, H, D]; k/v: [S, P, H, D] (unit stride on D, element strides for
// slot, position, head); lengths: [S] int32; o: contiguous [S, Lq, H, D].
int ds_flash_decode(const void* q, const void* k, const void* v, const void* lengths, void* o,
                    int dtype, int S, int H, int Lq, int P, int D, float scale, long long q_sb,
                    long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                    long long k_sh, long long v_sb, long long v_sl, long long v_sh,
                    void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (S <= 0 || H <= 0 || Lq <= 0 || P <= 0) return cudaErrorInvalidValue;
  if (dtype == ds::kFloat32)
    return dispatch_d<float>(D, q, k, v, lengths, o, S, H, Lq, P, scale, st, cs);
  if (dtype == ds::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, o, S, H, Lq, P, scale, st, cs);
  return cudaErrorInvalidValue;
}

const char* ds_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
