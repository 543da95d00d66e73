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
// ds^T (q * scale), dv = p^T dO. A row with no live key carries lse =
// NEG_INF/2 from K1; its pairs are all masked, so p and ds are exactly 0 and
// its gradients are 0, never NaN.
//
// What bounds it on the H100: at the training shape (B=8, H=16, L=1024,
// D=64, causal, bf16) the function needs 5 products of 2 D FLOPs per live
// (query, key) pair, 43 GFLOP, against ~135 MB of traffic (q, k, v, o, dO
// read once, dq, dk, dv written once, lse): ~320 FLOP/byte, over the 295
// FLOP/byte ridge, so bound by operations on the bf16 tensor cores at 0.0435
// ms, with bytes close behind (0.040 ms). FMA products (67 TFLOP/s fp32)
// cannot come within 15x of that. At head dim 128 (LLaMA-1b's training
// shape [4, 2048, 16, 128] causal) the same count gives 171.9 GFLOP against
// 268 MB: 0.174 ms by operations, twice its bytes' 0.080 ms.
//
// What the design does about it: the TPU grid carried dq's accumulator
// across its K-block steps and dk/dv's across its Q-block steps in VMEM
// scratch. Here those sequential axes become loops inside a block, split as
// FlashAttention-2 does into two kernels with no atomics, so the result is
// deterministic: a delta pre-pass (one warp per query row); a dk/dv kernel,
// one block per (64-key tile, head, batch) looping over the live query
// tiles; a dq kernel, one block per (64-query tile, head, batch) looping
// over the live key tiles. The dq pass recomputes s and dp, so 7 products
// run for the 5 needed: the price of no atomics. Both loops skip dead tiles
// (causal, sliding window, keys past kv_lengths), which is what either JAX
// `bwd_skip` setting computes; a key tile wholly past kv_lengths writes
// zeros. One ds_flash_bwd call is one launch of K4.
//
// bf16 runs every product on the tensor cores (mma.sync.m16n8k16, fp32
// accumulators; csrc/mma.cuh), four warps of 16 rows each (64 rows a block;
// the walked query or key tiles are 64 rows at head dim 64 and 32 at 128,
// BwdTile below):
//   * dk/dv: the warp's 16 keys are the M rows. S^T = K Q^T and dP^T =
//     V dO^T (A from ldmatrix on K and V, B from ldmatrix on the Q and dO
//     rows); P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) in
//     fp32 registers, with lse and delta read per column from shared
//     memory; then dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded
//     to bf16 and taken from registers as A, and dO, Q through
//     ldmatrix.trans.
//   * dq: the warp's 16 queries are the M rows. S = Q K^T, dP = dO V^T
//     with Q's and dO's fragments held in registers, then dQ += dS K with
//     dS from registers and K through ldmatrix.trans.
// Q/dO (dk/dv) and K/V (dq) tiles are double-buffered with 16-byte
// cp.async into XOR-swizzled rows (rows past L zero-filled, never read);
// the other operand pair stays in shared memory for the whole loop.
// Accumulators stay in fp32 registers and are written once, rounded to the
// tensors' dtype, dk and dq times scale. Only tiles that straddle a mask
// boundary pay for the mask. P and dS are rounded to bf16 before their
// second product, as FlashAttention-2 does; the plain version keeps them in
// fp32. (K1 splits its P into bf16 hi + lo, because its O decides MoE
// routing downstream; K4's rounding reaches only gradients, and the dense
// bf16 gradcheck of chip_smoke.py stays at about half its limit with it.)
//
// fp16 inputs run the same tensor-core body on the f16 form of mma.sync
// (the JAX kernels take fp16 and compute in fp32; their outputs are q's
// dtype). There rounding dS would be wrong: fp16 stops at 65504, and under
// fp16 training dO carries the loss scale (2^16 by default), so dS = P (dP -
// delta) in fp32 can pass 65504 where JAX's fp32 dS stays finite, and a
// cast would turn a finite gradient into inf: an overflow skip that JAX
// does not take. So each row of a dS tile (a query in the dq kernel, a key
// in dk/dv) is scaled by a power of two 2^-e before the cast, with e chosen
// from the row's largest |dS| so that it lies below 2^15 (csrc/mma.cuh
// fit_rows_f16). e only grows along the walk; when it grows the row's
// accumulator is scaled down by the same power, and the output is the
// accumulator times 2^e. Powers of two multiply exactly in fp32, so the
// scaled dS carries fp16's 11 bits (bf16's dS carries 8) and dq and dk are
// inf only where their own fp16 values are, as in the plain version and
// in JAX. P (in [0, 1]) needs no scale.
//
// fp32 inputs keep the FMA body below (256 threads, 4x4 register tiles of
// every product from 68-float padded shared rows): a bf16 or TF32 product
// cannot meet the fp32 checks' 1e-4. The C entry picks the body by the
// dtype the caller passed; it is not a fallback.
//
// Next step: wgmma with TMA and warp-specialised pipelines, as in
// FlashAttention-3: the only route to the full tensor-core rate, with a
// warpgroup owning 64 rows instead of a warp owning 16.
#include "common.cuh"
#include "mma.cuh"

namespace {

using ds::to_f;
using ds::mma::acc_to_a;
using ds::mma::bf16;
using ds::mma::cp_async4;
using ds::mma::cp_async_commit;
using ds::mma::cp_async_wait;
using ds::mma::load_a;
using ds::mma::load_b;
using ds::mma::load_b_trans;
using ds::mma::load_tile;
using ds::mma::fit_rows_f16;
using ds::mma::mma16;
using ds::mma::row_bytes;
using ds::mma::smem_addr;
using ds::mma::store_rows;

constexpr float kLog2e = 1.4426950408889634f;

// the factor that undoes fit_rows_f16's scale of a row with exponent e
// (1 for bf16, whose rows are never scaled, and for a row that saw no dS)
__device__ __forceinline__ float row_scale(int e) {
  return e == ds::mma::kNoExp ? 1.f : ds::mma::pow2(e);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kT = 64;            // rows per block: keys (dk/dv) or queries (dq)
constexpr int kThreadsMMA = 128;  // four warps of 16 rows

// The tile geometry of head dim D. A block owns kT = 64 rows (16 a warp) and
// walks the other operand in tiles of kI rows. At D = 64, kI = 64. At
// D = 128 the block's own accumulators double (dk and dv: 2 x 64 floats a
// thread; dq: 64) and so do the fragments the dq kernel holds (Q and dO, 64
// registers), so the walked tile halves to kI = 32: its S and dP tiles (2 x
// kI / 2 floats a thread) shrink by what the accumulators grew, and the
// thread stays under the 255 registers it has. The rows are 256 bytes.
template <int D>
struct BwdTile {
  static_assert(D == 64 || D == 128, "K4 is instantiated for head dims 64 and 128");
  static constexpr int kI = D == 64 ? 64 : 32;  // rows of the walked tile
  static constexpr int kRowB = row_bytes<D>();
  static constexpr uint32_t kOwnBytes = kT * kRowB;   // one tile of the block's own rows
  static constexpr uint32_t kWalkBytes = kI * kRowB;  // one tile of walked rows
  // K, V, then two stages of Q and of dO; then two stages of lse and delta
  static constexpr int kDkdvSmem = 2 * kOwnBytes + 4 * kWalkBytes + 4 * kI * sizeof(float);
  // Q, dO, then two stages of K and of V
  static constexpr int kDqSmem = 2 * kOwnBytes + 4 * kWalkBytes;
};

// Whether query `row` (position row + off) reads key `key`.
__device__ __forceinline__ bool live(int row, int key, int Lq, int kv_len, int off, int causal,
                                     int window) {
  if (row >= Lq || key >= kv_len) return false;
  const int qpos = row + off;
  if (causal && key > qpos) return false;
  if (window > 0 && key <= qpos - window) return false;
  return true;
}

// Whether every (query, key) pair of query rows q0..q0+nq-1 and keys
// k0..k0+nk-1 is live, so the tile pair needs no mask.
__device__ __forceinline__ bool interior(int q0, int nq, int k0, int nk, int Lq, int kv_len,
                                         int off, int causal, int window) {
  return q0 + nq <= Lq && k0 + nk <= kv_len && (!causal || k0 + nk - 1 <= q0 + off) &&
         (window <= 0 || k0 > q0 + nq - 1 + off - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 int H, int Lq, long long do_sb, long long do_sl, long long do_sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + warp;  // (row, head) pair
  const int b = blockIdx.y;
  if (r >= Lq * H) return;
  const int row = r / H, h = r % H;
  const T* op = o + ((static_cast<long long>(b) * Lq + row) * H + h) * D;
  const T* dp = dout + b * do_sb + static_cast<long long>(row) * do_sl + h * do_sh;
  float acc = to_f(op[lane]) * to_f(dp[lane]);
#pragma unroll
  for (int j = 1; j < D / 32; ++j) acc = fmaf(to_f(op[lane + 32 * j]), to_f(dp[lane + 32 * j]), acc);
  acc = ds::warp_sum(acc);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * Lq + row] = acc;
}

// T: bf16 or __half, the element type of q, k, v, dO and the outputs
template <typename T, int D>
__global__ void __launch_bounds__(kThreadsMMA)
    dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_lengths, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int Lq, int Lk, float scale, int causal,
                    int window, long long q_sb, long long q_sl, long long q_sh, long long k_sb,
                    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                    long long v_sh, long long do_sb, long long do_sl, long long do_sh) {
  using Tile = BwdTile<D>;
  constexpr int kI = Tile::kI;
  constexpr uint32_t kWalk = Tile::kWalkBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sK = smem_addr(smem);
  const uint32_t sV = sK + Tile::kOwnBytes;
  const uint32_t sQ = sV + Tile::kOwnBytes;  // [2][kI rows]
  const uint32_t sdO = sQ + 2 * kWalk;       // [2][kI rows]
  float* sL = reinterpret_cast<float*>(smem + 2 * Tile::kOwnBytes + 4 * kWalk);  // lse [2][kI]
  float* sD = sL + 2 * kI;                                                    // delta [2][kI]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kT;
  const int off = Lk - Lq;  // query i sits at position i + off
  const int kv_len = kv_lengths ? min(max(kv_lengths[b], 0), Lk) : Lk;

  // live query tiles of this key tile (block-uniform); none past kv_lengths
  int i_begin = 0, i_end = 0;
  if (k0 < kv_len) {
    const int k_last = min(k0 + kT, kv_len) - 1;
    const int row_first = causal ? max(k0 - off, 0) : 0;
    int row_last = Lq - 1;
    if (window > 0) row_last = min(row_last, k_last + window - 1 - off);
    if (row_last >= row_first) {
      i_begin = row_first / kI;
      i_end = row_last / kI + 1;
    }
  }

  const T* qb = q + b * q_sb + h * q_sh;
  const T* dob = dout + b * do_sb + h * do_sh;
  const float* lse_bh = lse + (static_cast<long long>(b) * H + h) * Lq;
  const float* delta_bh = delta + (static_cast<long long>(b) * H + h) * Lq;
  auto load_queries = [&](int it, int stage) {
    load_tile<kI, kThreadsMMA, D>(sQ + stage * kWalk, qb, it * kI, Lq, q_sl);
    load_tile<kI, kThreadsMMA, D>(sdO + stage * kWalk, dob, it * kI, Lq, do_sl);
    if (threadIdx.x < 2 * kI) {  // kI threads load lse, kI delta
      const int r = threadIdx.x % kI, row = it * kI + r;
      const bool ok = row < Lq;
      const float* src = threadIdx.x < kI ? lse_bh : delta_bh;
      float* dst = (threadIdx.x < kI ? sL : sD) + stage * kI + r;
      cp_async4(smem_addr(dst), src + (ok ? row : 0), ok);
    }
  };
  if (i_begin < i_end) {
    load_tile<kT, kThreadsMMA, D>(sK, k + b * k_sb + h * k_sh, k0, Lk, k_sl);
    load_tile<kT, kThreadsMMA, D>(sV, v + b * v_sb + h * v_sh, k0, Lk, v_sl);
    load_queries(i_begin, 0);
    cp_async_commit();
  }

  const float sl2 = scale * kLog2e;
  const int key_base = k0 + 16 * warp;  // this warp's first key
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[n][c] = acc_dv[n][c] = 0.f;
  int ds_exp[2] = {ds::mma::kNoExp, ds::mma::kNoExp};  // fp16: dS^T's row exponents

  for (int it = i_begin; it < i_end; ++it) {
    const int stage = (it - i_begin) & 1;
    if (it + 1 < i_end) {  // the next query tile loads while this one is used
      load_queries(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t tQ = sQ + stage * kWalk, tdO = sdO + stage * kWalk;
    const float* Ls = sL + stage * kI;
    const float* Ds = sD + stage * kI;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys by the tile's kI queries
    float st[kI / 8][4], dpt[kI / 8][4];
#pragma unroll
    for (int n = 0; n < kI / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<D>(ka, sK, 16 * warp, 16 * kk, lane);
      load_a<D>(va, sV, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < kI / 16; ++np) {
        uint32_t bq[4], bo[4];
        load_b<D>(bq, tQ, 16 * np, 16 * kk, lane);
        load_b<D>(bo, tdO, 16 * np, 16 * kk, lane);
        mma16<T>(st[2 * np], ka, bq[0], bq[1]);
        mma16<T>(st[2 * np + 1], ka, bq[2], bq[3]);
        mma16<T>(dpt[2 * np], va, bo[0], bo[1]);
        mma16<T>(dpt[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // P^T and dS^T in place; lse and delta belong to the columns (queries)
    const int q0 = it * kI;
    const bool full = interior(q0, kI, k0, kT, Lq, kv_len, off, causal, window);
#pragma unroll
    for (int n = 0; n < kI / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * n + 2 * tq + (c & 1);
        const float p = exp2f(fmaf(st[n][c], sl2, -Ls[col] * kLog2e));
        const bool ok = full || live(q0 + col, key_base + g + 8 * (c >> 1), Lq, kv_len, off,
                                     causal, window);
        st[n][c] = ok ? p : 0.f;
        dpt[n][c] = ok ? p * (dpt[n][c] - Ds[col]) : 0.f;
      }
    if constexpr (std::is_same<T, __half>::value) fit_rows_f16(dpt, ds_exp, acc_dk);

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T from registers
#pragma unroll
    for (int kk = 0; kk < kI / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a<T>(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a<T>(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bo[4], bq[4];
        load_b_trans<D>(bo, tdO, 16 * np, 16 * kk, lane);
        load_b_trans<D>(bq, tQ, 16 * np, 16 * kk, lane);
        mma16<T>(acc_dv[2 * np], pa, bo[0], bo[1]);
        mma16<T>(acc_dv[2 * np + 1], pa, bo[2], bo[3]);
        mma16<T>(acc_dk[2 * np], da, bq[0], bq[1]);
        mma16<T>(acc_dk[2 * np + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const long long ld = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * Lk * ld + h * D;
  store_rows(dk + base, ld, key_base, Lk, acc_dk, scale * row_scale(ds_exp[0]),
             scale * row_scale(ds_exp[1]), lane);
  store_rows(dv + base, ld, key_base, Lk, acc_dv, 1.f, 1.f, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsMMA)
    dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ kv_lengths, T* __restrict__ dq, int H, int Lq,
                  int Lk, float scale, int causal, int window, int n_qt, long long q_sb,
                  long long q_sl, long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                  long long v_sb, long long v_sl, long long v_sh, long long do_sb,
                  long long do_sl, long long do_sh) {
  using Tile = BwdTile<D>;
  constexpr int kI = Tile::kI;
  constexpr uint32_t kWalk = Tile::kWalkBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sdO = sQ + Tile::kOwnBytes;
  const uint32_t sK = sdO + Tile::kOwnBytes;  // [2][kI rows]
  const uint32_t sV = sK + 2 * kWalk;         // [2][kI rows]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // under causal the longest query tiles run first
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int q0 = qt * kT;
  const int off = Lk - Lq;
  const int kv_len = kv_lengths ? min(max(kv_lengths[b], 0), Lk) : Lk;

  // live key tiles of this query tile (the keys K1 walks)
  const int q_first = q0 + off;
  const int q_last = min(q0 + kT, Lq) - 1 + off;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int t_begin = k_begin / kI;
  const int t_end = k_end > k_begin ? (k_end + kI - 1) / kI : t_begin;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  if (t_begin < t_end) {
    load_tile<kT, kThreadsMMA, D>(sQ, q + b * q_sb + h * q_sh, q0, Lq, q_sl);
    load_tile<kT, kThreadsMMA, D>(sdO, dout + b * do_sb + h * do_sh, q0, Lq, do_sl);
    load_tile<kI, kThreadsMMA, D>(sK, kb, t_begin * kI, Lk, k_sl);
    load_tile<kI, kThreadsMMA, D>(sV, vb, t_begin * kI, Lk, v_sl);
    cp_async_commit();
  }

  const float sl2 = scale * kLog2e;
  const int row_base = q0 + 16 * warp;  // this warp's first query row
  float lse_l2[2], dlt[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_base + g + 8 * hf;
    const long long i = (static_cast<long long>(b) * H + h) * Lq + min(row, Lq - 1);
    lse_l2[hf] = lse[i] * kLog2e;
    dlt[hf] = delta[i];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  int ds_exp[2] = {ds::mma::kNoExp, ds::mma::kNoExp};  // fp16: dS's row exponents
  uint32_t qf[D / 16][4], dof[D / 16][4];

  for (int t = t_begin; t < t_end; ++t) {
    const uint32_t stage = ((t - t_begin) & 1) * kWalk;
    if (t + 1 < t_end) {  // the next key tile loads while this one is used
      load_tile<kI, kThreadsMMA, D>(sK + (kWalk - stage), kb, (t + 1) * kI, Lk, k_sl);
      load_tile<kI, kThreadsMMA, D>(sV + (kWalk - stage), vb, (t + 1) * kI, Lk, v_sl);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == t_begin) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a<D>(qf[kk], sQ, 16 * warp, 16 * kk, lane);
        load_a<D>(dof[kk], sdO, 16 * warp, 16 * kk, lane);
      }
    }

    // S = Q K^T and dP = dO V^T: the warp's 16 queries by the tile's kI keys
    float s[kI / 8][4], dp[kI / 8][4];
#pragma unroll
    for (int n = 0; n < kI / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kI / 16; ++np) {
        uint32_t bk[4], bv[4];
        load_b<D>(bk, sK + stage, 16 * np, 16 * kk, lane);
        load_b<D>(bv, sV + stage, 16 * np, 16 * kk, lane);
        mma16<T>(s[2 * np], qf[kk], bk[0], bk[1]);
        mma16<T>(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        mma16<T>(dp[2 * np], dof[kk], bv[0], bv[1]);
        mma16<T>(dp[2 * np + 1], dof[kk], bv[2], bv[3]);
      }

    // dS in place of dP; lse and delta belong to the rows
    const int k0 = t * kI;
    const bool full = interior(q0, kT, k0, kI, Lq, kv_len, off, causal, window);
#pragma unroll
    for (int n = 0; n < kI / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int hf = c >> 1;
        const float p = exp2f(fmaf(s[n][c], sl2, -lse_l2[hf]));
        const bool ok = full || live(row_base + g + 8 * hf, k0 + 8 * n + 2 * tq + (c & 1), Lq,
                                     kv_len, off, causal, window);
        dp[n][c] = ok ? p * (dp[n][c] - dlt[hf]) : 0.f;
      }
    if constexpr (std::is_same<T, __half>::value) fit_rows_f16(dp, ds_exp, acc);

    // dQ += dS K, dS from registers, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kI / 16; ++kk) {
      uint32_t da[4];
      acc_to_a<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bk[4];
        load_b_trans<D>(bk, sK + stage, 16 * np, 16 * kk, lane);
        mma16<T>(acc[2 * np], da, bk[0], bk[1]);
        mma16<T>(acc[2 * np + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const long long ld = static_cast<long long>(H) * D;
  store_rows(dq + static_cast<long long>(b) * Lq * ld + h * D, ld, row_base, Lq, acc,
             scale * row_scale(ds_exp[0]), scale * row_scale(ds_exp[1]), lane);
}

// ---------------------------------------------------------------------------
// fp32: FMA body
// ---------------------------------------------------------------------------
// 256 threads each own a 4x4 register tile of every product (4 x 8 of the
// dk, dv and dq accumulators at head dim 128: two column groups of 64) and
// read 16-byte vectors from shared memory rows padded by 4 floats, so the
// inner loops need one shared load per 4 FMAs. q, k, v and dO are read in
// place through their strides (q, k, v are slices of the fused QKV
// projection); o, lse and the outputs are contiguous. A tile is kB = 64
// rows whatever the head dim; the rows are D + 4 floats (the q, k, v and dO
// tiles) or kB + 4 (the p and ds tiles, one column per key or query).
constexpr int kB = 64;          // rows per tile (queries or keys)
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kLdP = kB + 4;    // shared row stride of the p / ds tiles, in floats

template <int D>
struct FmaTile {
  static_assert(D == 64 || D == 128, "K4 is instantiated for head dims 64 and 128");
  static constexpr int kLd = D + 4;        // shared row stride of a q/k/v/dO tile
  static constexpr int kTile = kB * kLd;   // floats per q/k/v/dO tile
  static constexpr int kTileP = kB * kLdP;  // floats per p/ds tile
  static constexpr int kGroups = D / 64;   // output column groups of 64
  static constexpr int kDkdvSmem = (4 * kTile + 2 * kTileP + 2 * kB) * sizeof(float);
  static constexpr int kDqSmem = (4 * kTile + kTileP + 2 * kB) * sizeof(float);
};

// Rows row0..row0+63 of one (batch, head) slice of a [B, L, H, D] tensor
// into a shared tile of row stride D + 4, times `mul`; rows past L read as 0.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src, int row0,
                                              int L, long long sl, float mul) {
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * FmaTile<D>::kLd + c] = row < L ? src[static_cast<long long>(row) * sl + c] * mul : 0.f;
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

// acc[i][j] = sum_d A[ra + 16 i][d] * B[rb + 16 j][d] over the D columns of
// a tile pair of row stride LD.
template <int D, int LD>
__device__ __forceinline__ void rows_dot(const float* A, const float* B, int ra, int rb,
                                         float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * LD + d);
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
// pair (A of row stride LDA, B of LDB, row-major; ca and cb multiples of 4).
template <int LDA, int LDB>
__device__ __forceinline__ void cols_outer(const float* A, const float* B, int ca, int cb,
                                           float acc[4][4]) {
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(A + r * LDA + ca);
    const float4 b = *reinterpret_cast<const float4*>(B + r * LDB + cb);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ kv_lengths,
                float* __restrict__ dk, float* __restrict__ dv, int H, int Lq, int Lk, float scale,
                int causal, int window, long long q_sb, long long q_sl, long long q_sh,
                long long k_sb, long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                long long v_sh, long long do_sb, long long do_sl, long long do_sh) {
  using Tile = FmaTile<D>;
  constexpr int kLd = Tile::kLd;
  extern __shared__ __align__(16) float smem_f[];
  float* Ks = smem_f;               // [64 keys][kLd]
  float* Vs = Ks + Tile::kTile;
  float* Qs = Vs + Tile::kTile;     // [64 queries][kLd], pre-scaled
  float* dOs = Qs + Tile::kTile;
  float* Ps = dOs + Tile::kTile;    // p [query][key], row stride kLdP
  float* dSs = Ps + Tile::kTileP;   // ds [query][key]
  float* Ls = dSs + Tile::kTileP;   // lse [64]
  float* Ds = Ls + kB;              // delta [64]

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

  float acc_dk[Tile::kGroups][4][4], acc_dv[Tile::kGroups][4][4];
#pragma unroll
  for (int gr = 0; gr < Tile::kGroups; ++gr)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_dk[gr][i][j] = acc_dv[gr][i][j] = 0.f;

  if (i_end > i_begin) {
    load_tile_f32<D>(Ks, k + b * k_sb + h * k_sh, k0, Lk, k_sl, 1.f);
    load_tile_f32<D>(Vs, v + b * v_sb + h * v_sh, k0, Lk, v_sl, 1.f);
  }
  const float* lse_bh = lse + (static_cast<long long>(b) * H + h) * Lq;
  const float* delta_bh = delta + (static_cast<long long>(b) * H + h) * Lq;
  for (int it = i_begin; it < i_end; ++it) {
    const int q0 = it * kB;
    __syncthreads();  // the previous tile's readers are done
    load_tile_f32<D>(Qs, q + b * q_sb + h * q_sh, q0, Lq, q_sl, scale);
    load_tile_f32<D>(dOs, dout + b * do_sb + h * do_sh, q0, Lq, do_sl, 1.f);
    load_stats(Ls, Ds, lse_bh, delta_bh, q0, Lq);
    __syncthreads();

    // p and ds of this thread's (query tr + 16 i, key tc + 16 j) pairs
    float s[4][4], dp[4][4];
    rows_dot<D, kLd>(Qs, Ks, tr, tc, s);
    rows_dot<D, kLd>(dOs, Vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = live(q0 + r, k0 + c, Lq, kv_len, off, causal, window)
                            ? expf(s[i][j] - Ls[r]) : 0.f;
        Ps[r * kLdP + c] = p;
        dSs[r * kLdP + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

    // dv[key][d] += sum_q p[q][key] dO[q][d]; dk[key][d] += sum_q ds[q][key] Q[q][d]
#pragma unroll
    for (int gr = 0; gr < Tile::kGroups; ++gr) {
      cols_outer<kLdP, kLd>(Ps, dOs, 4 * tr, 64 * gr + 4 * tc, acc_dv[gr]);
      cols_outer<kLdP, kLd>(dSs, Qs, 4 * tr, 64 * gr + 4 * tc, acc_dk[gr]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * tr + i;
    if (key >= Lk) continue;
    const long long base = ((static_cast<long long>(b) * Lk + key) * H + h) * D + 4 * tc;
#pragma unroll
    for (int gr = 0; gr < Tile::kGroups; ++gr)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dk[base + 64 * gr + j] = acc_dk[gr][i][j];
        dv[base + 64 * gr + j] = acc_dv[gr][i][j];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, const int* __restrict__ kv_lengths,
              float* __restrict__ dq, int H, int Lq, int Lk, float scale, int causal, int window,
              long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
              long long k_sh, long long v_sb, long long v_sl, long long v_sh, long long do_sb,
              long long do_sl, long long do_sh) {
  using Tile = FmaTile<D>;
  constexpr int kLd = Tile::kLd;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;               // [64 queries][kLd], pre-scaled
  float* dOs = Qs + Tile::kTile;
  float* Ks = dOs + Tile::kTile;    // [64 keys][kLd]
  float* Vs = Ks + Tile::kTile;
  float* dSt = Vs + Tile::kTile;    // ds transposed: [key][query], row stride kLdP
  float* Ls = dSt + Tile::kTileP;
  float* Ds = Ls + kB;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kB;
  const int off = Lk - Lq;
  const int kv_len = kv_lengths ? min(max(kv_lengths[b], 0), Lk) : Lk;

  // live key tiles of this query tile (the keys K1 walks)
  const int q_first = q0 + off;
  const int q_last = min(q0 + kB, Lq) - 1 + off;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int t_begin = k_begin / kB;
  const int t_end = k_end > k_begin ? (k_end + kB - 1) / kB : t_begin;

  load_tile_f32<D>(Qs, q + b * q_sb + h * q_sh, q0, Lq, q_sl, scale);
  load_tile_f32<D>(dOs, dout + b * do_sb + h * do_sh, q0, Lq, do_sl, 1.f);
  load_stats(Ls, Ds, lse + (static_cast<long long>(b) * H + h) * Lq,
             delta + (static_cast<long long>(b) * H + h) * Lq, q0, Lq);

  float acc[Tile::kGroups][4][4];
#pragma unroll
  for (int gr = 0; gr < Tile::kGroups; ++gr)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[gr][i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // Q/dO are loaded; the previous tile's readers are done
    load_tile_f32<D>(Ks, k + b * k_sb + h * k_sh, k0, Lk, k_sl, 1.f);
    load_tile_f32<D>(Vs, v + b * v_sb + h * v_sh, k0, Lk, v_sl, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    rows_dot<D, kLd>(Qs, Ks, tr, tc, s);
    rows_dot<D, kLd>(dOs, Vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = live(q0 + r, k0 + c, Lq, kv_len, off, causal, window)
                            ? expf(s[i][j] - Ls[r]) : 0.f;
        dSt[c * kLdP + r] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

    // dq[query][d] += sum_key ds[query][key] K[key][d]
#pragma unroll
    for (int gr = 0; gr < Tile::kGroups; ++gr)
      cols_outer<kLdP, kLd>(dSt, Ks, 4 * tr, 64 * gr + 4 * tc, acc[gr]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= Lq) continue;
    const long long base = ((static_cast<long long>(b) * Lq + row) * H + h) * D + 4 * tc;
#pragma unroll
    for (int gr = 0; gr < Tile::kGroups; ++gr)
#pragma unroll
      for (int j = 0; j < 4; ++j) dq[base + 64 * gr + j] = acc[gr][i][j] * scale;
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, const int* lens, void* dq, void* dk,
                        void* dv, int B, int H, int Lq, int Lk, float scale, int causal,
                        int window, const long long* st, cudaStream_t stream) {
  using Tile = FmaTile<D>;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  static cudaError_t dq_attr = ds::allow_smem(dq_kernel<D>, Tile::kDqSmem);
  if (dq_attr != cudaSuccess) return dq_attr;
  dim3 qgrid((Lq + kB - 1) / kB, H, B);
  dq_kernel<D><<<qgrid, kThreads, Tile::kDqSmem, stream>>>(
      qp, kp, vp, dop, lse, delta, lens, static_cast<float*>(dq), H, Lq, Lk, scale, causal,
      window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static cudaError_t kv_attr = ds::allow_smem(dkdv_kernel<D>, Tile::kDkdvSmem);
  if (kv_attr != cudaSuccess) return kv_attr;
  dim3 kgrid((Lk + kB - 1) / kB, H, B);
  dkdv_kernel<D><<<kgrid, kThreads, Tile::kDkdvSmem, stream>>>(
      qp, kp, vp, dop, lse, delta, lens, static_cast<float*>(dk), static_cast<float*>(dv), H, Lq,
      Lk, scale, causal, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* lens, void* dq, void* dk,
                       void* dv, int B, int H, int Lq, int Lk, float scale, int causal,
                       int window, const long long* st, cudaStream_t stream) {
  using Tile = BwdTile<D>;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int n_qt = (Lq + kT - 1) / kT, n_kt = (Lk + kT - 1) / kT;
  if (n_qt > 65535 || n_kt > 65535) return cudaErrorInvalidValue;
  static cudaError_t dq_attr = ds::allow_smem(dq_mma_kernel<T, D>, Tile::kDqSmem);
  if (dq_attr != cudaSuccess) return dq_attr;
  dq_mma_kernel<T, D><<<dim3(B * H, n_qt), kThreadsMMA, Tile::kDqSmem, stream>>>(
      qp, kp, vp, dop, lse, delta, lens, static_cast<T*>(dq), H, Lq, Lk, scale, causal, window,
      n_qt, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static cudaError_t kv_attr = ds::allow_smem(dkdv_mma_kernel<T, D>, Tile::kDkdvSmem);
  if (kv_attr != cudaSuccess) return kv_attr;
  dkdv_mma_kernel<T, D><<<dim3(B * H, n_kt), kThreadsMMA, Tile::kDkdvSmem, stream>>>(
      qp, kp, vp, dop, lse, delta, lens, static_cast<T*>(dk), static_cast<T*>(dv), H, Lq,
      Lk, scale, causal, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int H, int Lq,
                         const long long* st, cudaStream_t stream) {
  delta_kernel<T, D><<<dim3((Lq * H + 7) / 8, B), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, Lq, st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, const int* lens, void* dq,
                   void* dk, void* dv, int B, int H, int Lq, int Lk, float scale, int causal,
                   int window, const long long* st, cudaStream_t s) {
  cudaError_t err;
  if (dtype == ds::kFloat32) {
    err = launch_delta<float, D>(o, dout, delta, B, H, Lq, st, s);
    if (err != cudaSuccess) return err;
    return launch_fp32<D>(q, k, v, dout, lse, delta, lens, dq, dk, dv, B, H, Lq, Lk, scale,
                          causal, window, st, s);
  }
  if (dtype == ds::kBFloat16) {
    err = launch_delta<bf16, D>(o, dout, delta, B, H, Lq, st, s);
    if (err != cudaSuccess) return err;
    return launch_mma<bf16, D>(q, k, v, dout, lse, delta, lens, dq, dk, dv, B, H, Lq, Lk, scale,
                               causal, window, st, s);
  }
  if (dtype == ds::kFloat16) {
    err = launch_delta<__half, D>(o, dout, delta, B, H, Lq, st, s);
    if (err != cudaSuccess) return err;
    return launch_mma<__half, D>(q, k, v, dout, lse, delta, lens, dq, dk, dv, B, H, Lq, Lk,
                                 scale, causal, window, st, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q/k/v/dout: [B, L, H, D] with unit stride on D and element strides
// (batch, len, head) for each, D 64 or 128; o: contiguous [B, Lq, H, D] of q's dtype;
// lse: contiguous [B, H, Lq] fp32; kv_lengths: [B] int32 or null; delta:
// [B, H, Lq] fp32 scratch; dq: contiguous [B, Lq, H, D] of q's dtype; dk,
// dv: contiguous [B, Lk, H, D] of k's dtype; window <= 0 means none. bf16
// and fp16 run on the tensor cores and need 16-byte aligned q/k/v/dout with
// strides that are multiples of 8 elements; fp32 runs the FMA body.
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
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  const float* lsep = static_cast<const float*>(lse);
  float* deltap = static_cast<float*>(delta);
  const int* lens = static_cast<const int*>(kv_lengths);
  if (D == 64)
    return launch<64>(dtype, q, k, v, o, dout, lsep, deltap, lens, dq, dk, dv, B, H, Lq, Lk,
                      scale, causal, window, st, s);
  if (D == 128)
    return launch<128>(dtype, q, k, v, o, dout, lsep, deltap, lens, dq, dk, dv, B, H, Lq, Lk,
                       scale, causal, window, st, s);
  return cudaErrorInvalidValue;
}

const char* ds_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
