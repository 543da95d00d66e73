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
// Only tensor cores come near either: fp32 FMAs (67 TFLOP/s) sit 4x
// (fixed) to 15x (BigBird) above them before any other loss.
//
// What the bf16 design does about it (MmaGeo, sparse_attention.cuh): a
// thread block of four warps owns 64 query rows, one m16 tile per warp:
// four query blocks of 16 (each warp walks its own compacted list), two of
// 32 (two warps per list), or one of 64 or half of a 128 (all four share
// it, as K1's warps share their key tiles). The scores never reach device
// memory and dead blocks (padded list entries, blocks above the diagonal)
// are never loaded. Each list group stages its live key blocks KS keys at a
// time as bf16 into swizzled shared tiles with 16-byte cp.async from the
// compacted list (mma.cuh load_tile_gathered), double-buffered, so the next
// step's loads fly while this one multiplies; its barriers are its own
// (a warp's, two warps' named barrier, or the block's when all four share
// the list), so no warp waits on a list it does not walk. S = Q K^T and
// O += P V run on mma.sync m16n8k16 with fp32 accumulators, Q's fragments
// in registers for the whole loop and P repacked from S's accumulators
// (acc_to_a), rounded to bf16: the sparse checks read at most 7.8e-3 of
// max|ref| with it, under half their 2e-2 limit, so K1's hi + lo split is
// not needed here (no routing decision reads this output). The causal and padding masks
// come from the accumulator's (row, key) mapping, on the diagonal block and
// the padded tail only; the online softmax runs in base 2 with the scale
// folded in, and a row with no live key keeps l = 0 and ends as O = 0, lse
// = NEG_INF. Which query block each list group owns comes from the unit
// order the wrapper passes (longest list first, built once per layout):
// the groups that share a thread block walk lists of like length, so no
// warp idles beside a long list, and the global rows' long lists start in
// the first wave instead of trailing the last. The TPU grid ran its key
// axis in order with state in VMEM scratch; here that axis is the in-block
// loop and the blocks run in parallel. q/k/v are read through their [B, L,
// H, D] strides, o and lse are contiguous.
//
// fp32 inputs keep the FMA body below, one thread block per (query block,
// head, batch) over 64-key tiles of padded fp32 rows (sparse_attention.cuh
// Geo): a bf16 or TF32 tensor-core product cannot meet the fp32 checks'
// 1e-4. The C entry picks the body by the dtype the caller passed; it is
// not a fallback.
#include "sparse_attention.cuh"

namespace {

using ds::from_f;
using ds::to_f;
using namespace ds::sparse;
using ds::mma::acc_to_a;
using ds::mma::bf16;
using ds::mma::cp_async_commit;
using ds::mma::cp_async_wait;
using ds::mma::kRowBytes;
using ds::mma::load_a;
using ds::mma::load_b;
using ds::mma::load_b_trans;
using ds::mma::load_tile_by;
using ds::mma::load_tile_gathered;
using ds::mma::mma_bf16;
using ds::mma::smem_addr;
using ds::mma::store_rows;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
// per list group: two stages of [K: KS rows][V: KS rows], then the list and its count
template <int BLK>
constexpr long long fwd_mma_smem_bytes(int max_a) {
  using G = MmaGeo<BLK>;
  return G::kGroups *
         (4LL * G::KS * kRowBytes + (max_a + 1LL) * static_cast<long long>(sizeof(int)));
}

template <int BLK>
__global__ void __launch_bounds__(MmaGeo<BLK>::kThreads)
    sparse_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, const int* __restrict__ kidx,
                          const int* __restrict__ kcnt, const int* __restrict__ order, int B,
                          int H, int L, int max_a, float scale, int causal, long long q_sb,
                          long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                          long long k_sh, long long v_sb, long long v_sl, long long v_sh) {
  using G = MmaGeo<BLK>;
  constexpr int KS = G::KS, GW = G::kGroupWarps, GT = G::kGroupThreads;
  constexpr uint32_t kHalf = KS * kRowBytes;  // one K or V tile
  constexpr uint32_t kStage = 2 * kHalf;
  extern __shared__ __align__(128) unsigned char smem_mma[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int grp = warp / GW, gtid = threadIdx.x % GT;
  int b, h, row0;
  unit_of_group<BLK>(order, B, H, L, b, h, row0);
  const int nb = L / BLK;
  const int qb = row0 / BLK;  // this group's query block (nb: none)
  const uint32_t sK = smem_addr(smem_mma) + grp * 2 * kStage;  // [2][K rows, V rows]
  int* list = reinterpret_cast<int*>(smem_mma + G::kGroups * 2 * kStage) + grp * (max_a + 1);
  const int n_live = compact_group<BLK>(kidx, kcnt, h, nb, qb, max_a,
                                        causal ? kKeepAtMost : kKeepAll, list, list + max_a);
  const int n_steps = (n_live * BLK + KS - 1) / KS;
  const int wrow = row0 + 16 * (warp % GW);  // this warp's first query row
  const bf16* kbh = k + b * k_sb + h * k_sh;
  const bf16* vbh = v + b * v_sb + h * v_sh;

  // the warp's 16 query rows wait in the group's second stage, which the
  // loop's first prefetch overwrites only after every warp holds its Q
  uint32_t qf[4][4];
  if (n_steps > 0) {
    const uint32_t sQ = sK + kStage + (warp % GW) * 16 * kRowBytes;
    load_tile_by<16, 32>(sQ, q + b * q_sb + h * q_sh, wrow, L, q_sl, lane);
    load_tile_gathered<KS, BLK, GT>(sK, kbh, list, n_live, 0, k_sl, gtid);
    load_tile_gathered<KS, BLK, GT>(sK + kHalf, vbh, list, n_live, 0, v_sl, gtid);
    cp_async_commit();
    cp_async_wait<0>();
    group_sync<GW>(grp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a(qf[kk], sQ, 0, 16 * kk, lane);
    group_sync<GW>(grp);
  }

  const float sl2 = scale * kLog2e;
  float acc[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int st = 0; st < n_steps; ++st) {
    const uint32_t cur = sK + (st & 1) * kStage;
    if (st + 1 < n_steps) {  // the next step's keys load while this one is multiplied
      const uint32_t nxt = sK + ((st + 1) & 1) * kStage;
      load_tile_gathered<KS, BLK, GT>(nxt, kbh, list, n_live, (st + 1) * KS, k_sl, gtid);
      load_tile_gathered<KS, BLK, GT>(nxt + kHalf, vbh, list, n_live, (st + 1) * KS, v_sl, gtid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync<GW>(grp);

    // S = Q K^T: the warp's 16 rows by the step's KS staged keys
    float s[KS / 8][4];
#pragma unroll
    for (int n = 0; n < KS / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < KS / 16; ++np) {
        uint32_t bk[4];
        load_b(bk, cur, 16 * np, 16 * kk, lane);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }

    // dead pairs: padding slots, and under causal the diagonal block's keys
    // past the row (an n-tile's 8 keys lie in one block)
#pragma unroll
    for (int n = 0; n < KS / 8; ++n) {
      const int slot = st * KS + 8 * n;
      const int bi = slot / BLK;
      const int kb = bi < n_live ? list[bi] : -1;
      if (kb >= 0 && !(causal && kb == qb)) continue;
      const int key = kb * BLK + slot % BLK + 2 * tq;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (kb < 0 || key + (c & 1) > wrow + g + 8 * (c >> 1)) s[n][c] = -INFINITY;
    }

    // online softmax: rows g (c = 0, 1) and g + 8 (c = 2, 3)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < KS / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hf], s[n][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      // a row that has seen no live key keeps a finite reference, so
      // exp2(-inf - ref) = 0 and never NaN
      const float ref = m_new == -INFINITY ? 0.f : m_new * sl2;
      const float alpha = exp2f(m[hf] * sl2 - ref);
      m[hf] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < KS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[n][2 * hf + e], sl2, -ref));
          s[n][2 * hf + e] = p;
          sum += p;
        }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][2 * hf] *= alpha;
        acc[n][2 * hf + 1] *= alpha;
      }
      l[hf] = l[hf] * alpha + sum;  // this lane's columns only
    }

    // O += P V, P rounded to bf16 from registers, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[4];
        load_b_trans(bv, cur + kHalf, 16 * np, 16 * kk, lane);
        mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    group_sync<GW>(grp);  // the group is done with this stage before it is refilled
  }

  float* lse_bh = lse + (static_cast<long long>(b) * H + h) * L;
  bf16* o_bh = o + static_cast<long long>(b) * L * H * kD + h * kD;
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[hf] = sum > 0.f ? 1.f / sum : 0.f;
    const int row = wrow + g + 8 * hf;
    if (tq == 0 && row < L) lse_bh[row] = sum > 0.f ? m[hf] * scale + logf(sum) : ds::kNegInf;
  }
  store_rows(o_bh, static_cast<long long>(H) * kD, wrow, L, acc, inv[0], inv[1], lane);
}

template <int BLK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        const void* kidx, const void* kcnt, const void* order, int B, int H,
                        int L, int max_a, float scale, int causal, const long long* st,
                        cudaStream_t stream) {
  using G = MmaGeo<BLK>;
  auto kernel = sparse_fwd_mma_kernel<BLK>;
  static const cudaError_t attr = opt_in_smem(kernel);
  if (attr != cudaSuccess) return attr;
  const long long smem = fwd_mma_smem_bytes<BLK>(max_a);
  const long long slots = static_cast<long long>(H) * (L / G::kUnitRows);
  const long long blocks = B * ((slots + G::kGroups - 1) / G::kGroups);
  if (smem > kMaxSmem || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), G::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<const int*>(kidx),
      static_cast<const int*>(kcnt), static_cast<const int*>(order), B, H, L, max_a, scale,
      causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA body
// ---------------------------------------------------------------------------

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

cudaError_t dispatch_block(int block, int dtype, const void* q, const void* k, const void* v,
                           void* o, void* lse, const void* kidx, const void* kcnt,
                           const void* order, int B, int H, int L, int max_a, float scale,
                           int causal, const long long* st, cudaStream_t s) {
#define DS_SPARSE_FWD_CASE(BLK)                                                                \
  case BLK:                                                                                    \
    return dtype == ds::kBFloat16                                                              \
               ? launch_bf16<BLK>(q, k, v, o, lse, kidx, kcnt, order, B, H, L, max_a, scale,   \
                                  causal, st, s)                                               \
               : launch<float, BLK>(q, k, v, o, lse, kidx, kcnt, B, H, L, max_a, scale, causal, \
                                    st, s);
  switch (block) {
    DS_SPARSE_FWD_CASE(16)
    DS_SPARSE_FWD_CASE(32)
    DS_SPARSE_FWD_CASE(64)
    DS_SPARSE_FWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef DS_SPARSE_FWD_CASE
}

}  // namespace

extern "C" {

// q/k/v: [B, L, H, D] with unit stride on D and element strides (batch, len,
// head) for each; o: contiguous [B, L, H, D] of q's dtype; lse: contiguous
// [B, H, L] fp32; kidx: contiguous [H, L/block, max_a] int32, kcnt:
// [H, L/block, 1] int32 (layout_index_lists); order: null or the bf16
// body's [H * L / min(block, 64)] int32 unit order (h * (L / min(block,
// 64)) + unit each, every entry once). D must be 64, block 16,
// 32, 64 or 128, L a multiple of block. bf16 runs on the tensor cores and
// needs 16-byte aligned q/k/v with strides that are multiples of 8
// elements; fp32 runs the FMA body.
int ds_sparse_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                  const void* kidx, const void* kcnt, const void* order, int dtype, int B, int H,
                  int L, int D, int block, int max_a, float scale, int causal, long long q_sb,
                  long long q_sl, long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                  long long v_sb, long long v_sl, long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  if (B <= 0 || H <= 0 || L <= 0 || D != kD || max_a <= 0 || block <= 0 || L % block != 0 ||
      (dtype != ds::kFloat32 && dtype != ds::kBFloat16))
    return cudaErrorInvalidValue;
  return dispatch_block(block, dtype, q, k, v, o, lse, kidx, kcnt, order, B, H, L, max_a, scale,
                        causal, st, static_cast<cudaStream_t>(stream));
}

const char* ds_sparse_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
