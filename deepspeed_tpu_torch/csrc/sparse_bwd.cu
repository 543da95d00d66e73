// K6 backward: the gradient of the block-sparse flash attention forward
// (csrc/sparse_fwd.cu).
//
// Replaces the Pallas TPU kernels `_sp_bwd_dq_kernel` and
// `_sp_bwd_dkv_kernel` (deepspeed_tpu/ops/sparse_attention/
// sparse_self_attention.py:86 and :110, launched by `_sp_bwd` :171 from the
// custom VJP `_sparse_attention_bhld` :217-232). Given q, k, v, the
// forward's o and lse, the output cotangent dO and the layout's index lists,
// one C entry launches, in order:
//   1. delta[b, h, i] = sum_d dO * O in fp32 (the JAX package computes it in
//      jnp, :175), one warp per (row, head);
//   2. dq: one thread block per (query block, head, batch) walks the key
//      blocks of kidx/kcnt, as the forward does: s = (q * scale) k^T, p =
//      exp(s - lse) on live pairs, dp = dO v^T, ds = p (dp - delta), dq +=
//      ds k; dq = that * scale;
//   3. dk/dv: one thread block per (key block, head, batch) walks the query
//      blocks of the transposed lists qidx/qcnt: dv += p^T dO, dk += ds^T
//      (q * scale).
// No atomics: each output tile has one owner, which is why the JAX package
// built the transposed lists, and the result is deterministic. Under causal,
// dq skips key blocks j > qb and dk/dv skips query blocks i < kb (wholly
// above the diagonal); the diagonal block is masked inside. p is computed on
// live pairs only, so a row with no live key (lse = NEG_INF) has zero
// gradients and a key block no query reads gets dk = dv = 0, never NaN.
//
// What bounds it on the H100: q, k, v, o and dO read once, dq, dk, dv
// written once, and 10 D FLOPs per live pair (the five products s, dp, dv,
// dk, dq). Fixed layout, causal, B=8, L=1024, H=16, block 16: 12.8 GFLOP
// against 135 MB, bound by bytes (0.040 ms against 0.013); BigBird, B=2,
// L=4096, block 64: 50.8 GFLOP against 135 MB, bound by operations (0.051
// ms against 0.040). The dq pass recomputes s and dp (7 products executed
// for 5 needed, the price of no atomics), and this first version multiplies
// with fp32 FMAs, so it runs far from either bound; tensor cores are later
// work.
//
// What the design does about it: the TPU grid carried dq's accumulator
// across the key-list steps and dk/dv's across the query-list steps in VMEM;
// here those sequential axes are loops inside a thread block, over 64-row
// tiles staged from the live blocks of the compacted list (the forward's
// scheme, sparse_attention.cuh), with the owned block's rows and their
// accumulators on chip. Scores and their gradients never reach device
// memory. q, k, v and dO are read in place through their strides; o, lse,
// delta and the outputs are contiguous.
#include "sparse_attention.cuh"

namespace {

using ds::from_f;
using ds::to_f;
using namespace ds::sparse;

constexpr int kDeltaThreads = 256;

template <int BLK>
constexpr long long dq_smem_bytes(int max_a) {
  return (3LL * BLK * kLd + 2LL * kTile + 2LL * BLK) * static_cast<long long>(sizeof(float)) +
         (max_a + 1LL) * static_cast<long long>(sizeof(int));
}

template <int BLK>
constexpr long long dkdv_smem_bytes(int max_b) {
  return (4LL * BLK * kLd + 2LL * kTile + 2LL * kT) * static_cast<long long>(sizeof(float)) +
         (kT + max_b + 1LL) * static_cast<long long>(sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 int H, int L, long long do_sb, long long do_sl, long long do_sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kDeltaThreads / 32) + warp;  // (row, head) pair
  const int b = blockIdx.y;
  if (r >= L * H) return;
  const int row = r / H, h = r % H;
  const T* op = o + ((static_cast<long long>(b) * L + row) * H + h) * kD;
  const T* dp = dout + b * do_sb + static_cast<long long>(row) * do_sl + h * do_sh;
  float acc = to_f(op[lane]) * to_f(dp[lane]);
  acc = fmaf(to_f(op[lane + 32]), to_f(dp[lane + 32]), acc);
  acc = ds::warp_sum(acc);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * L + row] = acc;
}

template <typename T, int BLK>
__global__ void __launch_bounds__(Geo<BLK>::kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, const int* __restrict__ kidx,
              const int* __restrict__ kcnt, T* __restrict__ dq, int H, int L, int max_a,
              float scale, int causal, long long q_sb, long long q_sl, long long q_sh,
              long long k_sb, long long k_sl, long long k_sh, long long v_sb, long long v_sl,
              long long v_sh, long long do_sb, long long do_sl, long long do_sh) {
  constexpr int RI = Geo<BLK>::RI, TR = Geo<BLK>::TR, NT = Geo<BLK>::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BLK][kLd], pre-scaled
  float* dOs = Qs + BLK * kLd;
  float* dSs = dOs + BLK * kLd;  // ds [query][slot]
  float* Ks = dSs + BLK * kLd;   // staged keys [64][kLd]
  float* Vs = Ks + kTile;
  float* Ls = Vs + kTile;        // lse [BLK]
  float* Ds = Ls + BLK;          // delta [BLK]
  int* list = reinterpret_cast<int*>(Ds + BLK);
  int* n_live_s = list + max_a;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nb = L / BLK;
  const long long lrow = static_cast<long long>(h) * nb + qb;
  const int n_live = compact(kidx + lrow * max_a, min(kcnt[lrow], max_a), nb,
                             causal ? kKeepAtMost : kKeepAll, qb, list, n_live_s);

  const long long bh = static_cast<long long>(b) * H + h;
  load_rows<T, BLK, NT>(Qs, q + b * q_sb + h * q_sh, qb * BLK, q_sl, scale);
  load_rows<T, BLK, NT>(dOs, dout + b * do_sb + h * do_sh, qb * BLK, do_sl, 1.f);
  for (int r = tid; r < BLK; r += NT) {
    Ls[r] = lse[bh * L + qb * BLK + r];
    Ds[r] = delta[bh * L + qb * BLK + r];
  }
  const T* kbh = k + b * k_sb + h * k_sh;
  const T* vbh = v + b * v_sb + h * v_sh;

  float acc[RI][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_tiles = (n_live * BLK + kT - 1) / kT;
  for (int tt = 0; tt < n_tiles; ++tt) {
    __syncthreads();  // Q, dO, lse, delta are loaded; the previous tile's readers are done
    stage<T, BLK, NT>(Ks, kbh, k_sl, list, n_live, tt, 1.f);
    stage<T, BLK, NT>(Vs, vbh, v_sl, list, n_live, tt, 1.f);
    __syncthreads();

    float s[RI][4], dp[RI][4];
    dot_rows<RI, TR>(Qs, Ks, tr, tc, s);
    dot_rows<RI, TR>(dOs, Vs, tr, tc, dp);
    int kpos[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kpos[j] = slot_pos<BLK>(list, n_live, tt, tc + 16 * j);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = tr + TR * i;
      const int qpos = qb * BLK + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = kpos[j] >= 0 && (!causal || kpos[j] <= qpos);
        const float p = live ? expf(s[i][j] - Ls[r]) : 0.f;
        dSs[r * kLd + tc + 16 * j] = live ? p * (dp[i][j] - Ds[r]) : 0.f;
      }
    }
    __syncwarp();  // a row's ds is written and read by its own 16 lanes
    acc_rows<RI, TR>(dSs, Ks, tr, 4 * tc, acc);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = qb * BLK + tr + TR * i;
    T* out = dq + ((static_cast<long long>(b) * L + row) * H + h) * kD + 4 * tc;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = from_f<T>(acc[i][j] * scale);
  }
}

template <typename T, int BLK>
__global__ void __launch_bounds__(Geo<BLK>::kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ qidx,
                const int* __restrict__ qcnt, T* __restrict__ dk, T* __restrict__ dv, int H,
                int L, int max_b, float scale, int causal, long long q_sb, long long q_sl,
                long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                long long v_sl, long long v_sh, long long do_sb, long long do_sl,
                long long do_sh) {
  constexpr int RI = Geo<BLK>::RI, TR = Geo<BLK>::TR, NT = Geo<BLK>::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [BLK keys][kLd]
  float* Vs = Ks + BLK * kLd;
  float* Ps = Vs + BLK * kLd;    // p transposed: [key][slot]
  float* dSs = Ps + BLK * kLd;   // ds transposed: [key][slot]
  float* Qs = dSs + BLK * kLd;   // staged queries [64][kLd], pre-scaled
  float* dOs = Qs + kTile;
  float* Ls = dOs + kTile;       // lse of the staged slots [64]
  float* Ds = Ls + kT;           // delta of the staged slots [64]
  int* qpos_s = reinterpret_cast<int*>(Ds + kT);  // position of each slot, -1 for padding
  int* list = qpos_s + kT;
  int* n_live_s = list + max_b;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nb = L / BLK;
  const long long lrow = static_cast<long long>(h) * nb + kb;
  const int n_live = compact(qidx + lrow * max_b, min(qcnt[lrow], max_b), nb,
                             causal ? kKeepAtLeast : kKeepAll, kb, list, n_live_s);

  const long long bh = static_cast<long long>(b) * H + h;
  const int n_tiles = (n_live * BLK + kT - 1) / kT;
  if (n_tiles > 0) {
    load_rows<T, BLK, NT>(Ks, k + b * k_sb + h * k_sh, kb * BLK, k_sl, 1.f);
    load_rows<T, BLK, NT>(Vs, v + b * v_sb + h * v_sh, kb * BLK, v_sl, 1.f);
  }
  const T* qbh = q + b * q_sb + h * q_sh;
  const T* dobh = dout + b * do_sb + h * do_sh;

  float acc_dk[RI][4], acc_dv[RI][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int tt = 0; tt < n_tiles; ++tt) {
    __syncthreads();  // K, V are loaded; the previous tile's readers are done
    stage<T, BLK, NT>(Qs, qbh, q_sl, list, n_live, tt, scale);
    stage<T, BLK, NT>(dOs, dobh, do_sl, list, n_live, tt, 1.f);
    for (int slot = tid; slot < kT; slot += NT) {
      const int pos = slot_pos<BLK>(list, n_live, tt, slot);
      qpos_s[slot] = pos;
      Ls[slot] = pos >= 0 ? lse[bh * L + pos] : 0.f;
      Ds[slot] = pos >= 0 ? delta[bh * L + pos] : 0.f;
    }
    __syncthreads();

    // p and ds of this thread's (key tr + TR i, slot tc + 16 j) pairs
    float s[RI][4], dp[RI][4];
    dot_rows<RI, TR>(Ks, Qs, tr, tc, s);
    dot_rows<RI, TR>(Vs, dOs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = tr + TR * i;
      const int kpos = kb * BLK + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int slot = tc + 16 * j;
        const int qpos = qpos_s[slot];
        const bool live = qpos >= 0 && (!causal || kpos <= qpos);
        const float p = live ? expf(s[i][j] - Ls[slot]) : 0.f;
        Ps[r * kLd + slot] = p;
        dSs[r * kLd + slot] = live ? p * (dp[i][j] - Ds[slot]) : 0.f;
      }
    }
    __syncwarp();  // a key row's p and ds are written and read by its own 16 lanes

    // dv[key][d] += sum_slot p[key][slot] dO[slot][d]; dk[key][d] += sum_slot ds[key][slot] Q[slot][d]
    acc_rows<RI, TR>(Ps, dOs, tr, 4 * tc, acc_dv);
    acc_rows<RI, TR>(dSs, Qs, tr, 4 * tc, acc_dk);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = kb * BLK + tr + TR * i;
    const long long base = ((static_cast<long long>(b) * L + key) * H + h) * kD + 4 * tc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[base + j] = from_f<T>(acc_dk[i][j]);
      dv[base + j] = from_f<T>(acc_dv[i][j]);
    }
  }
}

template <typename T, int BLK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
                   const void* dout, const void* kidx, const void* kcnt, const void* qidx,
                   const void* qcnt, void* delta, void* dq, void* dk, void* dv, int B, int H,
                   int L, int max_a, int max_b, float scale, int causal, const long long* st,
                   cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lsep = static_cast<const float*>(lse);
  float* deltap = static_cast<float*>(delta);

  auto dq_k = dq_kernel<T, BLK>;
  auto dkdv_k = dkdv_kernel<T, BLK>;
  static const cudaError_t dq_attr = opt_in_smem(dq_k);
  static const cudaError_t kv_attr = opt_in_smem(dkdv_k);
  if (dq_attr != cudaSuccess) return dq_attr;
  if (kv_attr != cudaSuccess) return kv_attr;
  const long long dq_smem = dq_smem_bytes<BLK>(max_a);
  const long long kv_smem = dkdv_smem_bytes<BLK>(max_b);
  if (dq_smem > kMaxSmem || kv_smem > kMaxSmem) return cudaErrorInvalidValue;

  dim3 dgrid((L * H + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32), B);
  delta_kernel<T><<<dgrid, kDeltaThreads, 0, stream>>>(static_cast<const T*>(o), dop, deltap, H,
                                                        L, st[9], st[10], st[11]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid(L / BLK, H, B);
  dq_k<<<grid, Geo<BLK>::kThreads, dq_smem, stream>>>(
      qp, kp, vp, dop, lsep, deltap, static_cast<const int*>(kidx), static_cast<const int*>(kcnt),
      static_cast<T*>(dq), H, L, max_a, scale, causal, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dkdv_k<<<grid, Geo<BLK>::kThreads, kv_smem, stream>>>(
      qp, kp, vp, dop, lsep, deltap, static_cast<const int*>(qidx), static_cast<const int*>(qcnt),
      static_cast<T*>(dk), static_cast<T*>(dv), H, L, max_b, scale, causal, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_block(int block, const void* q, const void* k, const void* v, const void* o,
                           const void* lse, const void* dout, const void* kidx, const void* kcnt,
                           const void* qidx, const void* qcnt, void* delta, void* dq, void* dk,
                           void* dv, int B, int H, int L, int max_a, int max_b, float scale,
                           int causal, const long long* st, cudaStream_t s) {
#define DS_SPARSE_BWD_CASE(BLK)                                                                  \
  case BLK:                                                                                      \
    return launch<T, BLK>(q, k, v, o, lse, dout, kidx, kcnt, qidx, qcnt, delta, dq, dk, dv, B, H, \
                          L, max_a, max_b, scale, causal, st, s);
  switch (block) {
    DS_SPARSE_BWD_CASE(16)
    DS_SPARSE_BWD_CASE(32)
    DS_SPARSE_BWD_CASE(64)
    DS_SPARSE_BWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef DS_SPARSE_BWD_CASE
}

}  // namespace

extern "C" {

// q/k/v/dout: [B, L, H, D] with unit stride on D and element strides (batch,
// len, head) for each; o: contiguous [B, L, H, D] of q's dtype; lse:
// contiguous [B, H, L] fp32; kidx/kcnt: [H, L/block, max_a] and
// [H, L/block, 1] int32, qidx/qcnt: [H, L/block, max_b] and [H, L/block, 1]
// (layout_index_lists); delta: [B, H, L] fp32 scratch; dq, dk, dv:
// contiguous [B, L, H, D] of q's dtype. D must be 64, block 16, 32, 64 or
// 128, L a multiple of block.
int ds_sparse_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                  const void* dout, const void* kidx, const void* kcnt, const void* qidx,
                  const void* qcnt, void* delta, void* dq, void* dk, void* dv, int dtype, int B,
                  int H, int L, int D, int block, int max_a, int max_b, float scale, int causal,
                  long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                  long long k_sh, long long v_sb, long long v_sl, long long v_sh, long long do_sb,
                  long long do_sl, long long do_sh, void* stream) {
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, do_sb, do_sl, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || L <= 0 || D != kD || max_a <= 0 || max_b <= 0 || block <= 0 ||
      L % block != 0)
    return cudaErrorInvalidValue;
  if (dtype == ds::kFloat32)
    return dispatch_block<float>(block, q, k, v, o, lse, dout, kidx, kcnt, qidx, qcnt, delta, dq,
                                 dk, dv, B, H, L, max_a, max_b, scale, causal, st, s);
  if (dtype == ds::kBFloat16)
    return dispatch_block<__nv_bfloat16>(block, q, k, v, o, lse, dout, kidx, kcnt, qidx, qcnt,
                                         delta, dq, dk, dv, B, H, L, max_a, max_b, scale, causal,
                                         st, s);
  return cudaErrorInvalidValue;
}

const char* ds_sparse_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
