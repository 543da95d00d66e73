// K4: flash attention backward (the FlashAttention-2 backward), the
// gradient of K1.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (deepspeed_tpu/ops/pallas/flash_attention.py:281 and :335, launched by
// `_flash_bwd` :403 from the custom VJP `_flash_attention_bhld` :515-546).
// Given q, k, v, K1's output o and log-sum-exp lse, and the output
// cotangent dO, all [B, L, H, D]: delta = rowsum(dO * O) (the JAX package
// computes it outside its kernels, :414), p = exp(s - lse) on live pairs and
// 0 elsewhere, ds = p * (dp - delta) with dp = dO v^T; dq = ds k * scale, dk =
// ds^T (q * scale), dv = p^T dO. q is scaled before q k^T, as on the TPU. A
// row with no live key carries lse = NEG_INF/2 from K1; its pairs are all
// masked, so p is exactly 0 and its gradients are 0, never NaN.
//
// What bounds it on the H100: at the training slice's shape (B=8, H=16,
// L=1024, D=64, causal, bf16) the function needs 5 products of 2*D FLOPs per
// live (query, key) pair, 43 GFLOP, ~2.5x K1's, against ~135 MB of traffic
// (q, k, v, o, dO read once, dq, dk, dv written once, lse): ~320 FLOP/byte,
// just over the 295 FLOP/byte ridge, so bound by operations on the bf16
// tensor cores (0.044 ms) with bytes close behind (0.040 ms). This first
// version multiplies with fp32 FMAs (no mma/wgmma), so it runs far from
// either bound; tensor cores are later work.
//
// What the design does about it: the TPU grid carried dq's accumulator
// across its K-block steps and dk/dv's across its Q-block steps in VMEM
// scratch. Here those sequential axes become loops inside a block, split as
// FlashAttention-2 does into two kernels with no atomics, so the result is
// deterministic:
//   * dk/dv: one block per (64-key tile, head, batch) keeps K, V and the
//     dk/dv accumulators on chip and loops over the live query tiles;
//   * dq: one block per (64-query tile, head, batch) keeps Q, dO and the dq
//     accumulator on chip and loops over the live key tiles;
//   * delta: a small pre-pass, one warp per query row.
// Both loops skip dead tiles (causal, sliding window, keys past
// kv_lengths), which is what either JAX `bwd_skip` setting computes. A key
// tile wholly past kv_lengths runs no iteration and writes zeros. The [L, L]
// score matrix never reaches device memory: each tile pair recomputes s and
// dp in registers (the dq pass repeats them, 7 products executed for 5
// needed, the price of no atomics). 256 threads each own a 4x4 register tile
// of every product and read 16-byte vectors from shared memory rows padded
// to 68 floats, so the inner loops need one shared load per 4 FMAs. q, k,
// v and dO are read in place through their strides (q, k, v are slices of
// the fused QKV projection); o, lse and the outputs are contiguous.
#include "common.cuh"

namespace {

using ds::from_f;
using ds::to_f;

constexpr int kB = 64;          // rows per tile (queries or keys), = D
constexpr int kThreads = 256;   // 16 x 16 threads, a 4x4 register tile each
constexpr int kLd = 68;         // shared row stride in floats: 16-byte rows, spread banks
constexpr int kTile = kB * kLd;  // floats per shared tile

constexpr int dkdv_smem_bytes() { return (6 * kTile + 2 * kB) * static_cast<int>(sizeof(float)); }
constexpr int dq_smem_bytes() { return (5 * kTile + 2 * kB) * static_cast<int>(sizeof(float)); }

// Rows row0..row0+63 of one (batch, head) slice of a [B, L, H, 64] tensor
// into a shared tile, times `mul`; rows past L read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0, int L,
                                          long long sl, float mul) {
  for (int idx = threadIdx.x; idx < kB * kB; idx += kThreads) {
    const int r = idx >> 6, c = idx & 63;
    const int row = row0 + r;
    dst[r * kLd + c] = row < L ? to_f(src[static_cast<long long>(row) * sl + c]) * mul : 0.f;
  }
}

// lse and delta of query rows row0..row0+63 of one (batch, head).
__device__ __forceinline__ void load_stats(float* Ls, float* Ds, const float* __restrict__ lse,
                                           const float* __restrict__ delta, int row0, int Lq) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const int row = row0 + r;
    Ls[r] = row < Lq ? lse[row] : 0.f;
    Ds[r] = row < Lq ? delta[row] : 0.f;
  }
}

// Whether query `row` (position row + off) reads key `key`.
__device__ __forceinline__ bool live(int row, int key, int Lq, int kv_len, int off, int causal,
                                     int window) {
  if (row >= Lq || key >= kv_len) return false;
  const int qpos = row + off;
  if (causal && key > qpos) return false;
  if (window > 0 && key <= qpos - window) return false;
  return true;
}

// acc[i][j] = sum_d A[ra + 16 i][d] * B[rb + 16 j][d] over one 64-wide tile pair.
__device__ __forceinline__ void rows_dot(const float* A, const float* B, int ra, int rb,
                                         float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kB; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][j] += sum_r A[r][ca + i] * B[r][cb + j] over the 64 rows of a tile
// pair (A and B row-major, ca and cb multiples of 4).
__device__ __forceinline__ void cols_outer(const float* A, const float* B, int ca, int cb,
                                           float acc[4][4]) {
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(A + r * kLd + ca);
    const float4 b = *reinterpret_cast<const float4*>(B + r * kLd + cb);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 int H, int Lq, long long do_sb, long long do_sl, long long do_sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + warp;  // (row, head) pair
  const int b = blockIdx.y;
  if (r >= Lq * H) return;
  const int row = r / H, h = r % H;
  const T* op = o + ((static_cast<long long>(b) * Lq + row) * H + h) * kB;
  const T* dp = dout + b * do_sb + static_cast<long long>(row) * do_sl + h * do_sh;
  float acc = to_f(op[lane]) * to_f(dp[lane]);
  acc = fmaf(to_f(op[lane + 32]), to_f(dp[lane + 32]), acc);
  acc = ds::warp_sum(acc);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * Lq + row] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ kv_lengths,
                T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk, float scale,
                int causal, int window, long long q_sb, long long q_sl, long long q_sh,
                long long k_sb, long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                long long v_sh, long long do_sb, long long do_sl, long long do_sh) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;            // [64 keys][kLd]
  float* Vs = Ks + kTile;
  float* Qs = Vs + kTile;      // [64 queries][kLd], pre-scaled
  float* dOs = Qs + kTile;
  float* Ps = dOs + kTile;     // p [query][key]
  float* dSs = Ps + kTile;     // ds [query][key]
  float* Ls = dSs + kTile;     // lse [64]
  float* Ds = Ls + kB;         // delta [64]

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kB;
  const int off = Lk - Lq;  // query i sits at position i + off
  const int kv_len = kv_lengths ? min(max(kv_lengths[b], 0), Lk) : Lk;

  // live query tiles of this key tile (block-uniform, so the barriers in
  // the loop are reached by every thread); none past kv_lengths
  int i_begin = 0, i_end = 0;
  if (k0 < kv_len) {
    const int k_last = min(k0 + kB, kv_len) - 1;
    const int row_first = causal ? max(k0 - off, 0) : 0;
    int row_last = Lq - 1;
    if (window > 0) row_last = min(row_last, k_last + window - 1 - off);
    if (row_last >= row_first) {
      i_begin = row_first / kB;
      i_end = row_last / kB + 1;
    }
  }

  float acc_dk[4][4], acc_dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  if (i_end > i_begin) {
    load_tile(Ks, k + b * k_sb + h * k_sh, k0, Lk, k_sl, 1.f);
    load_tile(Vs, v + b * v_sb + h * v_sh, k0, Lk, v_sl, 1.f);
  }
  const float* lse_bh = lse + (static_cast<long long>(b) * H + h) * Lq;
  const float* delta_bh = delta + (static_cast<long long>(b) * H + h) * Lq;
  for (int it = i_begin; it < i_end; ++it) {
    const int q0 = it * kB;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Qs, q + b * q_sb + h * q_sh, q0, Lq, q_sl, scale);
    load_tile(dOs, dout + b * do_sb + h * do_sh, q0, Lq, do_sl, 1.f);
    load_stats(Ls, Ds, lse_bh, delta_bh, q0, Lq);
    __syncthreads();

    // p and ds of this thread's (query tr + 16 i, key tc + 16 j) pairs
    float s[4][4], dp[4][4];
    rows_dot(Qs, Ks, tr, tc, s);
    rows_dot(dOs, Vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = live(q0 + r, k0 + c, Lq, kv_len, off, causal, window)
                            ? expf(s[i][j] - Ls[r]) : 0.f;
        Ps[r * kLd + c] = p;
        dSs[r * kLd + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

    // dv[key][d] += sum_q p[q][key] dO[q][d]; dk[key][d] += sum_q ds[q][key] Q[q][d]
    cols_outer(Ps, dOs, 4 * tr, 4 * tc, acc_dv);
    cols_outer(dSs, Qs, 4 * tr, 4 * tc, acc_dk);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * tr + i;
    if (key >= Lk) continue;
    const long long base = ((static_cast<long long>(b) * Lk + key) * H + h) * kB + 4 * tc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[base + j] = from_f<T>(acc_dk[i][j]);
      dv[base + j] = from_f<T>(acc_dv[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, const int* __restrict__ kv_lengths,
              T* __restrict__ dq, int H, int Lq, int Lk, float scale, int causal, int window,
              long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
              long long k_sh, long long v_sb, long long v_sl, long long v_sh, long long do_sb,
              long long do_sl, long long do_sh) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [64 queries][kLd], pre-scaled
  float* dOs = Qs + kTile;
  float* Ks = dOs + kTile;     // [64 keys][kLd]
  float* Vs = Ks + kTile;
  float* dSt = Vs + kTile;     // ds transposed: [key][query]
  float* Ls = dSt + kTile;
  float* Ds = Ls + kB;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kB;
  const int off = Lk - Lq;
  const int kv_len = kv_lengths ? min(max(kv_lengths[b], 0), Lk) : Lk;

  // live key tiles of this query tile (the same range K1 walks)
  const int q_first = q0 + off;
  const int q_last = min(q0 + kB, Lq) - 1 + off;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int t_begin = k_begin / kB;
  const int t_end = k_end > k_begin ? (k_end + kB - 1) / kB : t_begin;

  load_tile(Qs, q + b * q_sb + h * q_sh, q0, Lq, q_sl, scale);
  load_tile(dOs, dout + b * do_sb + h * do_sh, q0, Lq, do_sl, 1.f);
  load_stats(Ls, Ds, lse + (static_cast<long long>(b) * H + h) * Lq,
             delta + (static_cast<long long>(b) * H + h) * Lq, q0, Lq);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // Q/dO are loaded; the previous tile's readers are done
    load_tile(Ks, k + b * k_sb + h * k_sh, k0, Lk, k_sl, 1.f);
    load_tile(Vs, v + b * v_sb + h * v_sh, k0, Lk, v_sl, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    rows_dot(Qs, Ks, tr, tc, s);
    rows_dot(dOs, Vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = live(q0 + r, k0 + c, Lq, kv_len, off, causal, window)
                            ? expf(s[i][j] - Ls[r]) : 0.f;
        dSt[c * kLd + r] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

    // dq[query][d] += sum_key ds[query][key] K[key][d]
    cols_outer(dSt, Ks, 4 * tr, 4 * tc, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= Lq) continue;
    const long long base = ((static_cast<long long>(b) * Lq + row) * H + h) * kB + 4 * tc;
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[base + j] = from_f<T>(acc[i][j] * scale);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dout, const void* kv_lengths, void* delta, void* dq, void* dk,
                   void* dv, int B, int H, int Lq, int Lk, float scale, int causal, int window,
                   const long long* st, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lsep = static_cast<const float*>(lse);
  float* deltap = static_cast<float*>(delta);
  const int* lens = static_cast<const int*>(kv_lengths);

  dim3 dgrid((Lq * H + kThreads / 32 - 1) / (kThreads / 32), B);
  delta_kernel<T><<<dgrid, kThreads, 0, stream>>>(static_cast<const T*>(o), dop, deltap, H, Lq,
                                                   st[9], st[10], st[11]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static cudaError_t dq_attr = ds::allow_smem(dq_kernel<T>, dq_smem_bytes());
  if (dq_attr != cudaSuccess) return dq_attr;
  dim3 qgrid((Lq + kB - 1) / kB, H, B);
  dq_kernel<T><<<qgrid, kThreads, dq_smem_bytes(), stream>>>(
      qp, kp, vp, dop, lsep, deltap, lens, static_cast<T*>(dq), H, Lq, Lk, scale, causal, window,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static cudaError_t kv_attr = ds::allow_smem(dkdv_kernel<T>, dkdv_smem_bytes());
  if (kv_attr != cudaSuccess) return kv_attr;
  dim3 kgrid((Lk + kB - 1) / kB, H, B);
  dkdv_kernel<T><<<kgrid, kThreads, dkdv_smem_bytes(), stream>>>(
      qp, kp, vp, dop, lsep, deltap, lens, static_cast<T*>(dk), static_cast<T*>(dv), H, Lq, Lk,
      scale, causal, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/dout: [B, L, H, D] with unit stride on D and element strides
// (batch, len, head) for each; o: contiguous [B, Lq, H, D] of q's dtype;
// lse: contiguous [B, H, Lq] fp32; kv_lengths: [B] int32 or null; delta:
// [B, H, Lq] fp32 scratch; dq: contiguous [B, Lq, H, D] of q's dtype; dk,
// dv: contiguous [B, Lk, H, D] of k's dtype; window <= 0 means none.
int ds_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                 const void* dout, const void* kv_lengths, void* delta, void* dq, void* dk,
                 void* dv, int dtype, int B, int H, int Lq, int Lk, int D, float scale,
                 int causal, int window, long long q_sb, long long q_sl, long long q_sh,
                 long long k_sb, long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                 long long v_sh, long long do_sb, long long do_sl, long long do_sh,
                 void* stream) {
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, do_sb, do_sl, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D != kB) return cudaErrorInvalidValue;
  if (dtype == ds::kFloat32)
    return launch<float>(q, k, v, o, lse, dout, kv_lengths, delta, dq, dk, dv, B, H, Lq, Lk,
                         scale, causal, window, st, s);
  if (dtype == ds::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, lse, dout, kv_lengths, delta, dq, dk, dv, B, H, Lq,
                                 Lk, scale, causal, window, st, s);
  return cudaErrorInvalidValue;
}

const char* ds_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
