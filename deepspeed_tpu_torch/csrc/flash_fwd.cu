// K1: causal / length-masked / sliding-window flash attention forward.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (deepspeed_tpu/ops/pallas/
// flash_attention.py:117, launched by `_flash_fwd` :234): online-softmax
// attention over [B, L, H, D] tensors with fp32 accumulation, emitting O and
// the log-sum-exp [B, H, Lq] in natural-log units (NEG_INF/2 and O = 0 on a
// row with no live key). Query i sits at position i + Lk - Lq.
//
// What bounds it on the H100: at the training shape (B=8, H=16, L=1024,
// D=64, causal, bf16) it reads q, k, v and writes o and lse once, ~67 MB, and
// does 4 D FLOPs per live pair, 17.2 GFLOP: bound by bytes at 0.0202 ms,
// with the bf16 tensor cores close behind (0.0174 ms at 989 TFLOP/s). So a
// kernel near the bound must both feed the tensor cores and keep its loads
// streaming; a kernel that multiplies with fp32 FMAs (67 TFLOP/s) cannot get
// within 10x of it.
//
// At head dim 128 (the LLaMA family: [4, 2048, 16, 128] causal in training)
// a pair costs twice the FLOPs for the same bytes per row: 68.7 GFLOP
// against 134.7 MB, bound by operations at 0.0695 ms.
//
// What the bf16 design does about it (FlashAttention-2's): one thread block
// of four warps per (tile of 128 query rows, head, batch); each warp owns
// 32 query rows (at head dim 128: 64 rows a block, 16 a warp, FwdTile
// below) and runs every product as
// mma.sync.m16n8k16 bf16 with fp32 accumulators (csrc/mma.cuh). Q, K and V
// tiles reach shared memory with 16-byte cp.async into XOR-swizzled rows, so
// that ldmatrix reads them without bank conflicts; the next 64-key K/V tile
// loads while the current one is multiplied (two stages). Q's fragments stay
// in registers for the whole loop. S = Q K^T (B from ldmatrix on K's rows),
// then the scale, the mask and the online softmax in fp32 registers (running
// max per row, reduced over the four lanes that share a row; the row sums
// are kept per lane and reduced once at the end); P is split into bf16 hi +
// lo and used from registers as the A operand of two products O += P_hi V +
// P_lo V (the accumulator layout of two n8 tiles is the A layout of one k16
// step), with V's B operand from ldmatrix.trans. Only tiles that hold a key some row of the block reads
// are loaded (causal, window, kv_lengths), and only tiles that straddle a
// boundary pay for the mask. Under causal the query tiles run longest
// first, so the short tail of the triangle fills the card's last wave.
// Rows past L are zero-filled by cp.async and never read from memory, so a
// NaN there cannot reach a live row. P and the exponent run in base 2 with
// scale * log2(e) folded in; l is summed from the fp32 p, as in
// FlashAttention-2. P V with P rounded to bf16 alone (FlashAttention-2's and
// SDPA's choice) put O 2e-3 to 5e-3 of max|O| off the fp32 plain version,
// and O decides MoE routing downstream: the bf16 MoE gradcheck of
// chip_smoke.py, whose margin routing flips set, read 0.91 of its limit.
// hi + lo carries P to 2^-17, so O is as close to the plain version as its
// own bf16 rounding allows, for one more product per tile (P V costs two of
// the three) and about a fifth more time.
//
// fp16 inputs run the same tensor-core body on the f16 form of mma.sync
// (the JAX kernel takes fp16 and computes in fp32 the same way: its output
// is q's dtype). Only P's split differs: fp16's hi keeps 11 bits against
// bf16's 8, but lo has no exponent below 2^-24, so hi + lo carries p in [0, 1]
// to within 2^-25 absolute (bf16's pair: 2^-17 relative, csrc/mma.cuh
// split_f16). O = (sum_j p_j v_j) / l with l >= 1 is then off by at most
// 2^-25 Lk max|v| from the split, 6.1e-5 max|v| at Lk 2048, under O's own
// fp16 rounding of 2^-11 relative: the fp16 checks hold O to 2e-3 of
// max|O| of the plain version, tenfold tighter than bf16's 2e-2.
//
// fp32 inputs keep the FMA body below (two threads per query row, fp32
// products from padded shared rows; instantiated for head dims 64 and 128,
// where a thread holds its 128-float query row and 64 output columns in
// registers): a bf16 or TF32 tensor-core product
// cannot meet the fp32 checks' 1e-4. The C entry picks the body by the
// dtype the caller passed; it is not a fallback.
//
// Head dims 96 (GPT-NeoX-20b) and 256 (GPT-J-6b) are the same body with
// two changes, each built as a library of its own (-DDS_HEAD_DIM=96 or
// 256, so that the parallel build compiles them beside the 64/128 library).
// At 96 a head row is 12 16-byte chunks, which the 8-row XOR swizzle cannot
// fold into the row; the shared rows are laid out 128 columns wide and only
// the first 96 are loaded and read (csrc/mma.cuh tile_cols): 6 k16 steps of
// Q K^T, 12 n8 tiles of P V, the bank pattern of head dim 128, and a
// quarter of the shared rows idle. At 256 one warp's 16 rows of O alone are
// 128 fp32 registers a thread, and Q's fragments would be 64 more; Q stays
// in shared memory and each k16 step of Q K^T reads its fragment with one
// ldmatrix (16 more per key tile, against 64 products), which leaves O,
// one S tile and the operands of one step in registers. Its shared memory is
// 64 rows of Q and two stages of 64-key K and V tiles of 512-byte rows,
// 160 KB. The fp32 body keeps the query row in registers up to head dim 128
// and in shared memory at 256 (the row and 128 output columns would not fit
// in 255 registers).
//
// Next step: wgmma with TMA loads and a warp-specialised pipeline
// (FlashAttention-3's design). wgmma is the only route to the full
// tensor-core rate, and TMA frees the registers and issue slots the
// cp.async address arithmetic takes; both need a different tile ownership
// (a warpgroup per 64 rows) and mbarrier pipelines, a redesign of its own.
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace ds::mma;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kKeys = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreadsBF16 = 32 * kWarps;

// The tile geometry of head dim D. Each warp holds its O accumulator
// (16 kMT rows x D fp32) and Q's fragments (16 kMT rows x D bf16) in
// registers for the whole loop, beside one tile of S (16 kMT x 64 fp32). At
// D = 64 a warp takes 32 rows (kMT = 2): 128 query rows per block, 48 KB of
// shared memory. At D = 128 the same 32 rows would double the accumulator
// and the fragments, past the 255 registers a thread has; a warp takes 16
// rows (kMT = 1) instead, so a block covers 64 query rows and a thread holds
// what it held at D = 64, less one S tile. Q stays in registers (reading it
// from shared memory at every tile would add D / 16 ldmatrix per key tile
// for no saved product), and the K/V tiles, 256-byte rows, take 80 KB.
template <int D>
struct FwdTile {
  static_assert(D == 64 || D == 96 || D == 128 || D == 256,
                "K1 is instantiated for head dims 64, 96, 128 and 256");
  static constexpr int kMT = D == 64 ? 2 : 1;        // m16 tiles per warp
  static constexpr int kRows = 16 * kMT * kWarps;    // query rows per block
  static constexpr int kCols = tile_cols<D>();       // columns of a shared row
  static constexpr int kRowB = row_bytes<kCols>();
  static constexpr int kSmem = (kRows + 4 * kKeys) * kRowB;  // Q + two K/V stages
  static constexpr bool kQRegs = D <= 128;  // Q's fragments in registers for the whole loop
};

// T: bf16 or __half, the element type of q, k, v and o
template <typename T, int D>
__global__ void __launch_bounds__(kThreadsBF16)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                         const int* __restrict__ kv_lengths, int H, int Lq, int Lk, float scale,
                         int causal, int window, int n_qt, long long q_sb, long long q_sl,
                         long long q_sh, long long k_sb, long long k_sl, long long k_sh,
                         long long v_sb, long long v_sl, long long v_sh) {
  using Tile = FwdTile<D>;
  constexpr int kMT = Tile::kMT, kRows = Tile::kRows, kCols = Tile::kCols;
  constexpr bool kQRegs = Tile::kQRegs;
  constexpr int kKD = D / 16;  // k16 steps of Q K^T; n16 pairs of P V
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK = sQ + kRows * Tile::kRowB;    // [2][kKeys rows]
  const uint32_t sV = sK + 2 * kKeys * Tile::kRowB;  // [2][kKeys rows]
  constexpr uint32_t kStage = kKeys * Tile::kRowB;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int q0 = qt * kRows;
  const int off = Lk - Lq;  // query i sits at position i + off
  const int kv_len = kv_lengths ? min(max(kv_lengths[b], 0), Lk) : Lk;

  // live key tiles of the whole block (block-uniform: every thread runs the
  // same loop, so the barriers inside it are safe)
  const int q_first = q0 + off;
  const int q_last = min(q0 + kRows, Lq) - 1 + off;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int t_begin = k_begin / kKeys;
  const int t_end = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : t_begin;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  if (t_begin < t_end) {  // a block with no live key loads nothing
    load_tile<kRows, kThreadsBF16, kCols, T, D>(sQ, q + b * q_sb + h * q_sh, q0, Lq, q_sl);
    load_tile<kKeys, kThreadsBF16, kCols, T, D>(sK, kb, t_begin * kKeys, Lk, k_sl);
    load_tile<kKeys, kThreadsBF16, kCols, T, D>(sV, vb, t_begin * kKeys, Lk, v_sl);
    cp_async_commit();
  }

  const float sl2 = scale * kLog2e;
  const int row_base = q0 + warp * 16 * kMT;  // this warp's first query row
  float acc[kMT][D / 8][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][n][c] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  uint32_t qf[kQRegs ? kMT : 1][kQRegs ? kKD : 1][4];

  for (int t = t_begin; t < t_end; ++t) {
    const uint32_t stage = ((t - t_begin) & 1) * kStage;
    if (t + 1 < t_end) {  // the next tile loads while this one is multiplied
      load_tile<kKeys, kThreadsBF16, kCols, T, D>(sK + (kStage - stage), kb, (t + 1) * kKeys, Lk,
                                                  k_sl);
      load_tile<kKeys, kThreadsBF16, kCols, T, D>(sV + (kStage - stage), vb, (t + 1) * kKeys, Lk,
                                                  v_sl);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (t == t_begin) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int kk = 0; kk < kKD; ++kk)
            load_a<kCols>(qf[mt][kk], sQ, (row_base - q0) + 16 * mt, 16 * kk, lane);
      }
    }

    // S = Q K^T for this warp's rows and the tile's 64 keys
    float s[kMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[mt][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t qs[kMT][4];  // this step's Q fragment, read from shared memory (head dim 256)
      if constexpr (!kQRegs) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          load_a<kCols>(qs[mt], sQ, (row_base - q0) + 16 * mt, 16 * kk, lane);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b<kCols>(bk, sK + stage, 16 * np, 16 * kk, lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if constexpr (kQRegs) {
            mma16<T>(s[mt][2 * np], qf[mt][kk], bk[0], bk[1]);
            mma16<T>(s[mt][2 * np + 1], qf[mt][kk], bk[2], bk[3]);
          } else {
            mma16<T>(s[mt][2 * np], qs[mt], bk[0], bk[1]);
            mma16<T>(s[mt][2 * np + 1], qs[mt], bk[2], bk[3]);
          }
        }
      }
    }

    // mask only a tile that straddles a boundary of some row of the block
    const int k0 = t * kKeys;
    const bool interior = q0 + kRows <= Lq && k0 + kKeys <= kv_len &&
                          (!causal || k0 + kKeys - 1 <= q_first) &&
                          (window <= 0 || k0 > q0 + kRows - 1 + off - window);
    if (!interior) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = row_base + 16 * mt + g + 8 * (c >> 1);
            const int key = k0 + 8 * n + 2 * tq + (c & 1);
            const int qpos = row + off;
            bool ok = row < Lq && key < kv_len;
            if (causal) ok = ok && key <= qpos;
            if (window > 0) ok = ok && key > qpos - window;
            if (!ok) s[mt][n][c] = -INFINITY;
          }
    }

    // online softmax: rows g (c = 0, 1) and g + 8 (c = 2, 3) of each m-tile
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[mt][n][2 * hf], s[mt][n][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][hf], mx);
        // a row that has seen no live key keeps a finite reference, so
        // exp2(-inf - ref) = 0 and never NaN
        const float ref = m_new == -INFINITY ? 0.f : m_new * sl2;
        const float alpha = exp2f(m[mt][hf] * sl2 - ref);
        m[mt][hf] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(s[mt][n][2 * hf + e], sl2, -ref));
            s[mt][n][2 * hf + e] = p;
            sum += p;
          }
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[mt][n][2 * hf] *= alpha;
          acc[mt][n][2 * hf + 1] *= alpha;
        }
        l[mt][hf] = l[mt][hf] * alpha + sum;  // this lane's columns only
      }
    }

    // O += P V, P from registers as a T hi + lo pair
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t pa[kMT][4], pl[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        acc_to_a_split<T>(pa[mt], pl[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < kKD; ++np) {
        uint32_t bv[4];
        load_b_trans<kCols>(bv, sV + stage, 16 * np, 16 * kk, lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma16<T>(acc[mt][2 * np], pa[mt], bv[0], bv[1]);
          mma16<T>(acc[mt][2 * np + 1], pa[mt], bv[2], bv[3]);
          mma16<T>(acc[mt][2 * np], pl[mt], bv[0], bv[1]);
          mma16<T>(acc[mt][2 * np + 1], pl[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float* lse_bh = lse + (static_cast<long long>(b) * H + h) * Lq;
  T* o_bh = o + static_cast<long long>(b) * Lq * H * D + h * D;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sum = l[mt][hf];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[hf] = sum > 0.f ? 1.f / sum : 0.f;
      const int row = row_base + 16 * mt + g + 8 * hf;
      if (tq == 0 && row < Lq)
        lse_bh[row] = sum > 0.f ? m[mt][hf] * scale + logf(sum) : ds::kNegInf / 2;
    }
    store_rows(o_bh, static_cast<long long>(H) * D, row_base + 16 * mt, Lq, acc[mt], inv[0],
               inv[1], lane);
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA body
// ---------------------------------------------------------------------------
// One thread block per (q-tile of 64 rows, head, batch) loops over K/V
// tiles, keeping the running max, denominator and output accumulator in
// registers. Two threads share one query row: each owns the even or odd key
// columns of a tile and the even or odd output columns, and the pair
// combines its row max and row sum with one shuffle. Shared-memory rows are
// padded by one float so the pair's accesses fall in different banks.
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;  // two threads per query row

// the query rows stay in registers up to head dim 128 and in shared memory
// above it (kBQ rows of D + 1 floats after Ps)
template <int D>
__host__ __device__ constexpr bool q_in_smem() {
  return D > 128;
}

template <int D>
constexpr int smem_bytes() {
  return (2 * kBK * (D + 1) + kBQ * (kBK + 1) + (q_in_smem<D>() ? kBQ * (D + 1) : 0)) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ kv_lengths, int H, int Lq, int Lk, float scale,
                     int causal, int window, long long q_sb, long long q_sl, long long q_sh,
                     long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                     long long v_sl, long long v_sh) {
  extern __shared__ float smem_f[];
  float* Ks = smem_f;                // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);    // [kBK][D + 1]
  float* Ps = Vs + kBK * (D + 1);    // [kBQ][kBK + 1]
  float* Qs = Ps + kBQ * (kBK + 1);  // [kBQ][D + 1], head dims above 128
  constexpr bool kQs = q_in_smem<D>();

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

  float qr[kQs ? 1 : D];
  if constexpr (kQs) {  // the tile's rows, scaled; the loop's first barrier publishes them
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int rr = idx / D, d = idx % D, qrow = qt * kBQ + rr;
      Qs[rr * (D + 1) + d] =
          qrow < Lq ? q[b * q_sb + (long long)qrow * q_sl + h * q_sh + d] * scale : 0.f;
    }
  } else {
    const float* qp = q + b * q_sb + (long long)min(row, Lq - 1) * q_sl + h * q_sh;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = row_ok ? qp[d] * scale : 0.f;
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
        kv = k[b * k_sb + (long long)kj * k_sl + h * k_sh + d];
        vv = v[b * v_sb + (long long)kj * v_sl + h * v_sh + d];
      }
      Ks[j * (D + 1) + d] = kv;
      Vs[j * (D + 1) + d] = vv;
    }
    __syncthreads();

    // the row's scores go to its row of Ps (each thread its own columns)
    // and are read back as probabilities: a register array of them would
    // unroll the key loop with the head-dim loop inside it, which took
    // nvcc a minute at head dim 128
    float* s = Ps + r * (kBK + 1) + half;
    float tmax = ds::kNegInf;
#pragma unroll 1
    for (int jj = 0; jj < kBK / 2; ++jj) {
      const int j = 2 * jj + half;
      const int kj = k0 + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d)
        if constexpr (kQs)
          dot = fmaf(Qs[r * (D + 1) + d], Ks[j * (D + 1) + d], dot);
        else
          dot = fmaf(qr[d], Ks[j * (D + 1) + d], dot);
      bool ok = row_ok && kj < kv_len;
      if (causal) ok = ok && kj <= qpos;
      if (window > 0) ok = ok && kj > qpos - window;
      s[2 * jj] = ok ? dot : ds::kNegInf;
      tmax = fmaxf(tmax, s[2 * jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 1 while the row has seen no live key
    float psum = 0.f;
#pragma unroll 8
    for (int jj = 0; jj < kBK / 2; ++jj) {
      // masked keys contribute an explicit 0, so a row with no live key
      // keeps l = 0 and finishes as zeros
      const float p = s[2 * jj] == ds::kNegInf ? 0.f : expf(s[2 * jj] - m_new);
      s[2 * jj] = p;
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
  float* op = o + (((long long)b * Lq + row) * H + h) * D;
#pragma unroll
  for (int cc = 0; cc < D / 2; ++cc) op[2 * cc + half] = acc[cc] / l_safe;
  if (half == 0) lse[((long long)b * H + h) * Lq + row] = l > 0.f ? m + logf(l) : ds::kNegInf / 2;
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, void* lse,
                        const void* kv_lengths, int B, int H, int Lq, int Lk, float scale,
                        int causal, int window, const long long* st, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  const int smem = smem_bytes<D>();
  static cudaError_t attr = ds::allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_lengths), H,
      Lq, Lk, scale, causal, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                       const void* kv_lengths, int B, int H, int Lq, int Lk, float scale,
                       int causal, int window, const long long* st, cudaStream_t stream) {
  using Tile = FwdTile<D>;
  static cudaError_t attr = ds::allow_smem(flash_fwd_mma_kernel<T, D>, Tile::kSmem);
  if (attr != cudaSuccess) return attr;
  const int n_qt = (Lq + Tile::kRows - 1) / Tile::kRows;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  dim3 grid(B * H, n_qt);
  flash_fwd_mma_kernel<T, D><<<grid, kThreadsBF16, Tile::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_lengths), H,
      Lq, Lk, scale, causal, window, n_qt, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                   const void* kv_lengths, int B, int H, int Lq, int Lk, float scale, int causal,
                   int window, const long long* st, cudaStream_t stream) {
  if (dtype == ds::kFloat32)
    return launch_fp32<D>(q, k, v, o, lse, kv_lengths, B, H, Lq, Lk, scale, causal, window, st,
                          stream);
  if (dtype == ds::kBFloat16)
    return launch_mma<bf16, D>(q, k, v, o, lse, kv_lengths, B, H, Lq, Lk, scale, causal, window,
                               st, stream);
  if (dtype == ds::kFloat16)
    return launch_mma<__half, D>(q, k, v, o, lse, kv_lengths, B, H, Lq, Lk, scale, causal, window,
                               st, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q/k/v: [B, L, H, D] with unit stride on D and element strides (batch, len,
// head) for each, D 64 or 128 (96 or 256 in the library built with
// -DDS_HEAD_DIM=96 or 256); o: contiguous [B, Lq, H, D] of q's dtype; lse:
// contiguous [B, H, Lq] fp32; kv_lengths: [B] int32 or null; window <= 0
// means none.
// bf16 and fp16 run on the tensor cores and need 16-byte aligned q/k/v with
// strides that are multiples of 8 elements; fp32 runs the FMA body.
int ds_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                 const void* kv_lengths, int dtype, int B, int H, int Lq, int Lk, int D,
                 float scale, int causal, int window, long long q_sb, long long q_sl,
                 long long q_sh, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
                 long long v_sl, long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
#ifdef DS_HEAD_DIM
  // a library of one head dim (ops/cuda/build.py VARIANTS)
  if (D == DS_HEAD_DIM)
    return launch<DS_HEAD_DIM>(dtype, q, k, v, o, lse, kv_lengths, B, H, Lq, Lk, scale, causal,
                               window, st, s);
#else
  if (D == 64)
    return launch<64>(dtype, q, k, v, o, lse, kv_lengths, B, H, Lq, Lk, scale, causal, window,
                      st, s);
  if (D == 128)
    return launch<128>(dtype, q, k, v, o, lse, kv_lengths, B, H, Lq, Lk, scale, causal, window,
                       st, s);
#endif
  return cudaErrorInvalidValue;
}

const char* ds_flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
