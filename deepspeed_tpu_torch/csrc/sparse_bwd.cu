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
//   2. dq: the query rows walk the key blocks of kidx/kcnt, as the forward
//      does: s = (q * scale) k^T, p = exp(s - lse) on live pairs, dp = dO
//      v^T, ds = p (dp - delta), dq += ds k; dq = that * scale;
//   3. dk/dv: the key rows walk the query blocks of the transposed lists
//      qidx/qcnt: dv += p^T dO, dk += ds^T (q * scale).
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
// ms against 0.040). The dq pass recomputes s and dp: 7 products executed
// for 5 needed, the price of no atomics.
//
// What the bf16 design does about it: the TPU grid carried dq's
// accumulator across the key-list steps and dk/dv's across the query-list
// steps in VMEM; here those sequential axes are loops inside a thread
// block, on the forward's tensor-core tiles (MmaGeo, sparse_attention.cuh;
// K4's products, csrc/flash_bwd.cu). Four warps own 64 rows, one m16 tile
// each, and each list group (a warp at block 16, two at 32, four at 64 and
// 128) walks its own compacted list, staging the other side's live blocks
// KS rows at a time with cp.async into swizzled bf16 tiles, double-
// buffered, with barriers of its own:
//   * dq: the warp's 16 queries are the M rows; Q's and dO's fragments stay
//     in registers, lse and delta per row too. S = Q K^T and dP = dO V^T,
//     dS = P (dP - delta) in fp32 registers, then dQ += dS K with dS
//     rounded to bf16 from registers and K through ldmatrix.trans.
//   * dk/dv: the warp's 16 keys are the M rows; K's and V's fragments stay
//     in registers. S^T = K Q^T and dP^T = V dO^T against the staged query
//     rows, lse and delta of each staged slot gathered beside them
//     (4-byte cp.async), then dV += P^T dO and dK += dS^T Q with P^T and
//     dS^T rounded to bf16 from registers.
// P and dS are rounded to bf16 before their second product, as K4 does
// (they reach only gradients). The masks come from the accumulator's (row,
// key) mapping on the diagonal block and the padded tail only. The
// transposed lists are very uneven: at the fixed layout a global key block
// is read by up to 60 query blocks, the others by at most 4; at BigBird the
// global blocks read every block. So which rows each list group owns
// comes from the unit order the wrapper passes, longest list first (built
// once per layout): the groups that share a thread block walk lists of
// like length, instead of one global block's warp working while three
// idle, and the long lists start in the first wave instead of trailing
// the last.
// Scores and their gradients never reach device memory. q, k, v and dO
// are read in place through their strides; o, lse, delta and the outputs
// are contiguous.
//
// fp32 inputs keep the FMA bodies below (one thread block per layout
// block, 64-row tiles of padded fp32 rows, sparse_attention.cuh Geo): a
// bf16 or TF32 tensor-core product cannot meet the fp32 checks' 1e-4. The
// C entry picks the bodies by the dtype the caller passed; it is not a
// fallback.
#include "sparse_attention.cuh"

namespace {

using ds::from_f;
using ds::to_f;
using namespace ds::sparse;
using ds::mma::acc_to_a;
using ds::mma::bf16;
using ds::mma::cp_async4;
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

constexpr int kDeltaThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
// per list group: two stages of [K: KS rows][V: KS rows], then the list and its count
template <int BLK>
constexpr long long dq_mma_smem_bytes(int max_a) {
  using G = MmaGeo<BLK>;
  return G::kGroups *
         (4LL * G::KS * kRowBytes + (max_a + 1LL) * static_cast<long long>(sizeof(int)));
}

// per list group: two stages of [Q: KS rows][dO: KS rows], two of [lse: KS][delta: KS]
// floats, then the list and its count
template <int BLK>
constexpr long long dkdv_mma_smem_bytes(int max_b) {
  using G = MmaGeo<BLK>;
  return G::kGroups * (4LL * G::KS * kRowBytes +
                       4LL * G::KS * static_cast<long long>(sizeof(float)) +
                       (max_b + 1LL) * static_cast<long long>(sizeof(int)));
}

template <int BLK>
__global__ void __launch_bounds__(MmaGeo<BLK>::kThreads)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ kidx, const int* __restrict__ kcnt,
                  const int* __restrict__ order, bf16* __restrict__ dq, int B, int H, int L,
                  int max_a, float scale, int causal, long long q_sb, long long q_sl,
                  long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                  long long v_sl, long long v_sh, long long do_sb, long long do_sl,
                  long long do_sh) {
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

  // the warp's 16 query and dO rows wait in the group's second stage (as in
  // the forward)
  uint32_t qf[4][4], dof[4][4];
  if (n_steps > 0) {
    const uint32_t sQ = sK + kStage + (warp % GW) * 32 * kRowBytes;
    const uint32_t sdO = sQ + 16 * kRowBytes;
    load_tile_by<16, 32>(sQ, q + b * q_sb + h * q_sh, wrow, L, q_sl, lane);
    load_tile_by<16, 32>(sdO, dout + b * do_sb + h * do_sh, wrow, L, do_sl, lane);
    load_tile_gathered<KS, BLK, GT>(sK, kbh, list, n_live, 0, k_sl, gtid);
    load_tile_gathered<KS, BLK, GT>(sK + kHalf, vbh, list, n_live, 0, v_sl, gtid);
    cp_async_commit();
    cp_async_wait<0>();
    group_sync<GW>(grp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      load_a(qf[kk], sQ, 0, 16 * kk, lane);
      load_a(dof[kk], sdO, 0, 16 * kk, lane);
    }
    group_sync<GW>(grp);
  }

  const float sl2 = scale * kLog2e;
  float lse_l2[2], dlt[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long i = (static_cast<long long>(b) * H + h) * L + min(wrow + g + 8 * hf, L - 1);
    lse_l2[hf] = lse[i] * kLog2e;
    dlt[hf] = delta[i];
  }
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int st = 0; st < n_steps; ++st) {
    const uint32_t cur = sK + (st & 1) * kStage;
    if (st + 1 < n_steps) {  // the next step's keys load while this one is used
      const uint32_t nxt = sK + ((st + 1) & 1) * kStage;
      load_tile_gathered<KS, BLK, GT>(nxt, kbh, list, n_live, (st + 1) * KS, k_sl, gtid);
      load_tile_gathered<KS, BLK, GT>(nxt + kHalf, vbh, list, n_live, (st + 1) * KS, v_sl, gtid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync<GW>(grp);

    // S = Q K^T and dP = dO V^T: the warp's 16 queries by the step's KS keys
    float s[KS / 8][4], dp[KS / 8][4];
#pragma unroll
    for (int n = 0; n < KS / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < KS / 16; ++np) {
        uint32_t bk[4], bv[4];
        load_b(bk, cur, 16 * np, 16 * kk, lane);
        load_b(bv, cur + kHalf, 16 * np, 16 * kk, lane);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        mma_bf16(dp[2 * np], dof[kk], bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], dof[kk], bv[2], bv[3]);
      }

    // dS in place of dP on live pairs, 0 elsewhere; lse and delta belong to the rows
#pragma unroll
    for (int n = 0; n < KS / 8; ++n) {
      const int slot = st * KS + 8 * n;
      const int bi = slot / BLK;
      const int kb = bi < n_live ? list[bi] : -1;
      const bool full = kb >= 0 && !(causal && kb == qb);
      const int key = kb * BLK + slot % BLK + 2 * tq;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1;
        const float p = exp2f(fmaf(s[n][c], sl2, -lse_l2[hf]));
        const bool ok = full || (kb >= 0 && key + (c & 1) <= wrow + g + 8 * hf);
        dp[n][c] = ok ? p * (dp[n][c] - dlt[hf]) : 0.f;
      }
    }

    // dQ += dS K, dS from registers, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b_trans(bk, cur, 16 * np, 16 * kk, lane);
        mma_bf16(acc[2 * np], da, bk[0], bk[1]);
        mma_bf16(acc[2 * np + 1], da, bk[2], bk[3]);
      }
    }
    group_sync<GW>(grp);  // the group is done with this stage before it is refilled
  }

  const long long ld = static_cast<long long>(H) * kD;
  store_rows(dq + static_cast<long long>(b) * L * ld + h * kD, ld, wrow, L, acc, scale, scale,
             lane);
}

template <int BLK>
__global__ void __launch_bounds__(MmaGeo<BLK>::kThreads)
    dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ qidx, const int* __restrict__ qcnt,
                    const int* __restrict__ order, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int B, int H, int L, int max_b, float scale, int causal, long long q_sb,
                    long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                    long long k_sh, long long v_sb, long long v_sl, long long v_sh,
                    long long do_sb, long long do_sl, long long do_sh) {
  using G = MmaGeo<BLK>;
  constexpr int KS = G::KS, GW = G::kGroupWarps, GT = G::kGroupThreads;
  constexpr uint32_t kHalf = KS * kRowBytes;  // one Q or dO tile
  constexpr uint32_t kStage = 2 * kHalf;
  extern __shared__ __align__(128) unsigned char smem_mma[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int grp = warp / GW, gtid = threadIdx.x % GT;
  int b, h, row0;
  unit_of_group<BLK>(order, B, H, L, b, h, row0);
  const int nb = L / BLK;
  const int kb = row0 / BLK;  // this group's key block (nb: none)
  const uint32_t sQ = smem_addr(smem_mma) + grp * 2 * kStage;  // [2][Q rows, dO rows]
  float* sLD = reinterpret_cast<float*>(smem_mma + G::kGroups * 2 * kStage) + grp * 4 * KS;
  int* list = reinterpret_cast<int*>(smem_mma + G::kGroups * (2 * kStage + 4 * KS * 4)) +
              grp * (max_b + 1);
  const int n_live = compact_group<BLK>(qidx, qcnt, h, nb, kb, max_b,
                                        causal ? kKeepAtLeast : kKeepAll, list, list + max_b);
  const int n_steps = (n_live * BLK + KS - 1) / KS;
  const int wrow = row0 + 16 * (warp % GW);  // this warp's first key
  const bf16* qbh = q + b * q_sb + h * q_sh;
  const bf16* dobh = dout + b * do_sb + h * do_sh;
  const float* lse_bh = lse + (static_cast<long long>(b) * H + h) * L;
  const float* delta_bh = delta + (static_cast<long long>(b) * H + h) * L;

  // step `step`'s query rows, dO rows and their lse and delta into `stage`
  auto load_step = [&](int step, int stage) {
    const uint32_t t = sQ + stage * kStage;
    load_tile_gathered<KS, BLK, GT>(t, qbh, list, n_live, step * KS, q_sl, gtid);
    load_tile_gathered<KS, BLK, GT>(t + kHalf, dobh, list, n_live, step * KS, do_sl, gtid);
    for (int i = gtid; i < 2 * KS; i += GT) {
      const int s = step * KS + i % KS;
      const int bi = s / BLK;
      const bool ok = bi < n_live;
      const int pos = ok ? list[bi] * BLK + s % BLK : 0;
      cp_async4(smem_addr(sLD + stage * 2 * KS + i), (i < KS ? lse_bh : delta_bh) + pos, ok);
    }
  };

  // the warp's 16 key and value rows wait in the group's second stage
  uint32_t ka[4][4], va[4][4];
  if (n_steps > 0) {
    const uint32_t sKo = sQ + kStage + (warp % GW) * 32 * kRowBytes;
    const uint32_t sVo = sKo + 16 * kRowBytes;
    load_tile_by<16, 32>(sKo, k + b * k_sb + h * k_sh, wrow, L, k_sl, lane);
    load_tile_by<16, 32>(sVo, v + b * v_sb + h * v_sh, wrow, L, v_sl, lane);
    load_step(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    group_sync<GW>(grp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      load_a(ka[kk], sKo, 0, 16 * kk, lane);
      load_a(va[kk], sVo, 0, 16 * kk, lane);
    }
    group_sync<GW>(grp);
  }

  const float sl2 = scale * kLog2e;
  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[n][c] = acc_dv[n][c] = 0.f;

  for (int st = 0; st < n_steps; ++st) {
    const int stage = st & 1;
    if (st + 1 < n_steps) {  // the next step's query rows load while this one is used
      load_step(st + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync<GW>(grp);
    const uint32_t tQ = sQ + stage * kStage, tdO = tQ + kHalf;
    const float* Ls = sLD + stage * 2 * KS;
    const float* Ds = Ls + KS;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys by the step's KS queries
    float sT[KS / 8][4], dpT[KS / 8][4];
#pragma unroll
    for (int n = 0; n < KS / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) sT[n][c] = dpT[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < KS / 16; ++np) {
        uint32_t bq[4], bo[4];
        load_b(bq, tQ, 16 * np, 16 * kk, lane);
        load_b(bo, tdO, 16 * np, 16 * kk, lane);
        mma_bf16(sT[2 * np], ka[kk], bq[0], bq[1]);
        mma_bf16(sT[2 * np + 1], ka[kk], bq[2], bq[3]);
        mma_bf16(dpT[2 * np], va[kk], bo[0], bo[1]);
        mma_bf16(dpT[2 * np + 1], va[kk], bo[2], bo[3]);
      }

    // P^T and dS^T in place on live pairs, 0 elsewhere; lse and delta belong
    // to the columns (queries)
#pragma unroll
    for (int n = 0; n < KS / 8; ++n) {
      const int slot = st * KS + 8 * n;
      const int bi = slot / BLK;
      const int qblk = bi < n_live ? list[bi] : -1;
      const bool full = qblk >= 0 && !(causal && qblk == kb);
      const int qpos = qblk * BLK + slot % BLK + 2 * tq;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * n + 2 * tq + (c & 1);
        const float p = exp2f(fmaf(sT[n][c], sl2, -Ls[col] * kLog2e));
        const bool ok = full || (qblk >= 0 && wrow + g + 8 * (c >> 1) <= qpos + (c & 1));
        sT[n][c] = ok ? p : 0.f;
        dpT[n][c] = ok ? p * (dpT[n][c] - Ds[col]) : 0.f;
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T from registers
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
      acc_to_a(da, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bo[4], bq[4];
        load_b_trans(bo, tdO, 16 * np, 16 * kk, lane);
        load_b_trans(bq, tQ, 16 * np, 16 * kk, lane);
        mma_bf16(acc_dv[2 * np], pa, bo[0], bo[1]);
        mma_bf16(acc_dv[2 * np + 1], pa, bo[2], bo[3]);
        mma_bf16(acc_dk[2 * np], da, bq[0], bq[1]);
        mma_bf16(acc_dk[2 * np + 1], da, bq[2], bq[3]);
      }
    }
    group_sync<GW>(grp);  // the group is done with this stage before it is refilled
  }

  const long long ld = static_cast<long long>(H) * kD;
  const long long base = static_cast<long long>(b) * L * ld + h * kD;
  store_rows(dk + base, ld, wrow, L, acc_dk, scale, scale, lane);
  store_rows(dv + base, ld, wrow, L, acc_dv, 1.f, 1.f, lane);
}

// ---------------------------------------------------------------------------
// fp32: FMA bodies
// ---------------------------------------------------------------------------
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

template <int BLK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* lse, const void* dout, const void* kidx, const void* kcnt,
                        const void* qidx, const void* qcnt, const void* q_order,
                        const void* k_order, void* delta, void* dq, void* dk, void* dv, int B,
                        int H, int L, int max_a, int max_b, float scale, int causal,
                        const long long* st, cudaStream_t stream) {
  using G = MmaGeo<BLK>;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lsep = static_cast<const float*>(lse);
  float* deltap = static_cast<float*>(delta);

  auto dq_k = dq_mma_kernel<BLK>;
  auto dkdv_k = dkdv_mma_kernel<BLK>;
  static const cudaError_t dq_attr = opt_in_smem(dq_k);
  static const cudaError_t kv_attr = opt_in_smem(dkdv_k);
  if (dq_attr != cudaSuccess) return dq_attr;
  if (kv_attr != cudaSuccess) return kv_attr;
  const long long dq_smem = dq_mma_smem_bytes<BLK>(max_a);
  const long long kv_smem = dkdv_mma_smem_bytes<BLK>(max_b);
  const long long slots = static_cast<long long>(H) * (L / G::kUnitRows);
  const long long blocks = B * ((slots + G::kGroups - 1) / G::kGroups);
  if (dq_smem > kMaxSmem || kv_smem > kMaxSmem || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;

  dim3 dgrid((L * H + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32), B);
  delta_kernel<bf16><<<dgrid, kDeltaThreads, 0, stream>>>(static_cast<const bf16*>(o), dop, deltap,
                                                           H, L, st[9], st[10], st[11]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const unsigned grid = static_cast<unsigned>(blocks);
  dq_k<<<grid, G::kThreads, dq_smem, stream>>>(
      qp, kp, vp, dop, lsep, deltap, static_cast<const int*>(kidx), static_cast<const int*>(kcnt),
      static_cast<const int*>(q_order), static_cast<bf16*>(dq), B, H, L, max_a, scale, causal,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dkdv_k<<<grid, G::kThreads, kv_smem, stream>>>(
      qp, kp, vp, dop, lsep, deltap, static_cast<const int*>(qidx), static_cast<const int*>(qcnt),
      static_cast<const int*>(k_order), static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, L,
      max_b, scale, causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return cudaGetLastError();
}

cudaError_t dispatch_block(int block, int dtype, const void* q, const void* k, const void* v,
                           const void* o, const void* lse, const void* dout, const void* kidx,
                           const void* kcnt, const void* qidx, const void* qcnt,
                           const void* q_order, const void* k_order, void* delta, void* dq,
                           void* dk, void* dv, int B, int H, int L, int max_a, int max_b,
                           float scale, int causal, const long long* st, cudaStream_t s) {
#define DS_SPARSE_BWD_CASE(BLK)                                                                  \
  case BLK:                                                                                      \
    return dtype == ds::kBFloat16                                                                \
               ? launch_bf16<BLK>(q, k, v, o, lse, dout, kidx, kcnt, qidx, qcnt, q_order,        \
                                  k_order, delta, dq, dk, dv, B, H, L, max_a, max_b, scale,      \
                                  causal, st, s)                                                 \
               : launch<float, BLK>(q, k, v, o, lse, dout, kidx, kcnt, qidx, qcnt, delta, dq, dk, \
                                    dv, B, H, L, max_a, max_b, scale, causal, st, s);
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
// (layout_index_lists); q_order, k_order: null or the bf16 bodies' [H * L
// / min(block, 64)] int32 unit orders of the dq and the dk/dv pass (h * (L
// / min(block, 64)) + unit each, every entry once); delta: [B, H, L]
// fp32 scratch; dq, dk, dv: contiguous [B, L, H, D] of q's dtype. D must be
// 64, block 16, 32, 64 or 128, L a multiple of block. bf16 runs on the
// tensor cores and needs 16-byte aligned q/k/v/dout with strides that are
// multiples of 8 elements; fp32 runs the FMA bodies.
int ds_sparse_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                  const void* dout, const void* kidx, const void* kcnt, const void* qidx,
                  const void* qcnt, const void* q_order, const void* k_order, void* delta,
                  void* dq, void* dk, void* dv, int dtype, int B, int H, int L, int D, int block,
                  int max_a, int max_b, float scale, int causal, long long q_sb, long long q_sl,
                  long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                  long long v_sl, long long v_sh, long long do_sb, long long do_sl,
                  long long do_sh, void* stream) {
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, do_sb, do_sl, do_sh};
  if (B <= 0 || H <= 0 || L <= 0 || D != kD || max_a <= 0 || max_b <= 0 || block <= 0 ||
      L % block != 0 || (dtype != ds::kFloat32 && dtype != ds::kBFloat16))
    return cudaErrorInvalidValue;
  return dispatch_block(block, dtype, q, k, v, o, lse, dout, kidx, kcnt, qidx, qcnt, q_order,
                        k_order, delta, dq, dk, dv, B, H, L, max_a, max_b, scale, causal, st,
                        static_cast<cudaStream_t>(stream));
}

const char* ds_sparse_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
