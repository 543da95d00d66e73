// K6 forward: block-sparse flash attention over the layout's active blocks.
//
// Replaces the Pallas TPU kernel `_sp_fwd_kernel` (deepspeed_tpu/ops/
// sparse_attention/sparse_self_attention.py:54, launched by `_sp_fwd` :147):
// for each query block, online-softmax attention over the key blocks of its
// index list kidx[h, qb, :kcnt[h, qb]], fp32 accumulation, emitting O and the
// log-sum-exp [B, H, L] (NEG_INF, the float32 min, with O = 0 on a row with
// no live key: JAX's sparse convention). Under causal, key blocks wholly
// above the diagonal are skipped and the diagonal block is masked inside; the
// JAX kernel visits the blocks above the diagonal too, which changes the
// result only of a query block whose every active block lies above it (there
// JAX returns the mean of V over those blocks, this kernel zeros).
//
// What bounds it on the H100: it reads q, k, v and writes o once, and does
// 4 D FLOPs per live (query, key) pair. At the smoke run's two shapes (bf16,
// D = 64): the Sparse Transformer "fixed" layout, causal, B=8, L=1024, H=16,
// block 16, ~20.0 M live pairs, 5.1 GFLOP against 67.6 MB: bound by bytes
// (0.020 ms against 0.005 ms of bf16 tensor-core time); BigBird, B=2,
// L=4096, H=16, block 64, ~79 M live pairs, 20.3 GFLOP against 67.6 MB:
// at the ridge, bound by operations by a hair (0.0205 ms against 0.0202).
// This first version multiplies with fp32 FMAs (no mma/wgmma), whose 67
// TFLOP/s put it 4x (fixed) to 15x (BigBird) above either bound before any
// other loss; tensor cores are later work.
//
// What the design does about it: one thread block per (query block, head,
// batch) keeps the block's scaled Q, its running max and denominator and its
// output accumulator on chip and walks the live key blocks, so the scores
// never reach device memory and dead blocks (padded list entries, blocks
// above the diagonal) are never loaded. The list is compacted first (warp
// ballots), then the live key blocks are staged in 64-key tiles (four
// blocks of 16 per tile), so that every block size runs the same [BLK, 64]
// register-tiled products (sparse_attention.cuh): each thread holds RI x 4
// scores and RI x 4 outputs and reads 16-byte vectors from padded shared
// rows. The TPU grid ran its key axis in order with state in VMEM scratch;
// here that axis is the in-block loop and the blocks run in parallel. A
// thread block holds one query block (16 to 128 rows); q/k/v are read
// through their [B, L, H, D] strides, o and lse are contiguous.
#include "sparse_attention.cuh"

namespace {

using ds::from_f;
using ds::to_f;
using namespace ds::sparse;

template <int BLK>
constexpr long long fwd_smem_bytes(int max_a) {
  return (2LL * BLK * kLd + 2LL * kTile) * static_cast<long long>(sizeof(float)) +
         (max_a + 1LL) * static_cast<long long>(sizeof(int));
}

template <typename T, int BLK>
__global__ void __launch_bounds__(Geo<BLK>::kThreads)
    sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ kidx,
                      const int* __restrict__ kcnt, int H, int L, int max_a, float scale,
                      int causal, long long q_sb, long long q_sl, long long q_sh, long long k_sb,
                      long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                      long long v_sh) {
  constexpr int RI = Geo<BLK>::RI, TR = Geo<BLK>::TR, NT = Geo<BLK>::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BLK][kLd], pre-scaled
  float* Ps = Qs + BLK * kLd;    // probabilities [query][slot]
  float* Ks = Ps + BLK * kLd;    // staged keys [64][kLd]
  float* Vs = Ks + kTile;
  int* list = reinterpret_cast<int*>(Vs + kTile);  // live key blocks [max_a]
  int* n_live_s = list + max_a;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nb = L / BLK;
  const long long lrow = static_cast<long long>(h) * nb + qb;
  const int n_live = compact(kidx + lrow * max_a, min(kcnt[lrow], max_a), nb,
                             causal ? kKeepAtMost : kKeepAll, qb, list, n_live_s);

  load_rows<T, BLK, NT>(Qs, q + b * q_sb + h * q_sh, qb * BLK, q_sl, scale);
  const T* kbh = k + b * k_sb + h * k_sh;
  const T* vbh = v + b * v_sb + h * v_sh;

  float acc[RI][4], m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = ds::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (n_live * BLK + kT - 1) / kT;
  for (int tt = 0; tt < n_tiles; ++tt) {
    __syncthreads();  // Q is loaded; the previous tile's readers are done
    stage<T, BLK, NT>(Ks, kbh, k_sl, list, n_live, tt, 1.f);
    stage<T, BLK, NT>(Vs, vbh, v_sl, list, n_live, tt, 1.f);
    __syncthreads();

    float s[RI][4];
    dot_rows<RI, TR>(Qs, Ks, tr, tc, s);
    int kpos[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kpos[j] = slot_pos<BLK>(list, n_live, tt, tc + 16 * j);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = tr + TR * i;
      const int qpos = qb * BLK + r;
      bool live[4];
      float tmax = ds::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        live[j] = kpos[j] >= 0 && (!causal || kpos[j] <= qpos);
        if (live[j]) tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = group_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);  // 1 while the row has seen no live key
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // dead pairs contribute an explicit 0, so a row with no live key
        // keeps l = 0 and finishes as zeros
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * kLd + tc + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row's probabilities are written and read by its own 16 lanes
    acc_rows<RI, TR>(Ps, Vs, tr, 4 * tc, acc);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = qb * BLK + tr + TR * i;
    const float l_safe = fmaxf(l[i], 1e-37f);
    T* op = o + ((static_cast<long long>(b) * L + row) * H + h) * kD + 4 * tc;
#pragma unroll
    for (int j = 0; j < 4; ++j) op[j] = from_f<T>(acc[i][j] / l_safe);
    if (tc == 0)
      lse[(static_cast<long long>(b) * H + h) * L + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : ds::kNegInf;
  }
}

template <typename T, int BLK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const void* kidx, const void* kcnt, int B, int H, int L, int max_a,
                   float scale, int causal, const long long* st, cudaStream_t stream) {
  auto kernel = sparse_fwd_kernel<T, BLK>;
  static const cudaError_t attr = opt_in_smem(kernel);
  if (attr != cudaSuccess) return attr;
  const long long smem = fwd_smem_bytes<BLK>(max_a);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  dim3 grid(L / BLK, H, B);
  kernel<<<grid, Geo<BLK>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(kidx),
      static_cast<const int*>(kcnt), H, L, max_a, scale, causal, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_block(int block, const void* q, const void* k, const void* v, void* o,
                           void* lse, const void* kidx, const void* kcnt, int B, int H, int L,
                           int max_a, float scale, int causal, const long long* st,
                           cudaStream_t s) {
  switch (block) {
    case 16: return launch<T, 16>(q, k, v, o, lse, kidx, kcnt, B, H, L, max_a, scale, causal, st, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, kidx, kcnt, B, H, L, max_a, scale, causal, st, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, kidx, kcnt, B, H, L, max_a, scale, causal, st, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, kidx, kcnt, B, H, L, max_a, scale, causal, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v: [B, L, H, D] with unit stride on D and element strides (batch, len,
// head) for each; o: contiguous [B, L, H, D] of q's dtype; lse: contiguous
// [B, H, L] fp32; kidx: contiguous [H, L/block, max_a] int32, kcnt:
// [H, L/block, 1] int32 (layout_index_lists). D must be 64, block 16, 32,
// 64 or 128, L a multiple of block.
int ds_sparse_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                  const void* kidx, const void* kcnt, int dtype, int B, int H, int L, int D,
                  int block, int max_a, float scale, int causal, long long q_sb, long long q_sl,
                  long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                  long long v_sl, long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || L <= 0 || D != kD || max_a <= 0 || block <= 0 || L % block != 0)
    return cudaErrorInvalidValue;
  if (dtype == ds::kFloat32)
    return dispatch_block<float>(block, q, k, v, o, lse, kidx, kcnt, B, H, L, max_a, scale, causal, st, s);
  if (dtype == ds::kBFloat16)
    return dispatch_block<__nv_bfloat16>(block, q, k, v, o, lse, kidx, kcnt, B, H, L, max_a, scale,
                                         causal, st, s);
  return cudaErrorInvalidValue;
}

const char* ds_sparse_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
