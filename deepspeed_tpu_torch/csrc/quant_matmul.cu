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
// What bounds it on the H100: at decode (M = 8) bytes -- each code byte is
// used by 8 rows, so the least time is the code bytes over 3.35 TB/s
// (0.0003-0.0014 ms at the serving shapes), and at that size a call is a
// chain of latencies (load, product, the split's sum) more than a stream;
// at a prefill chunk (M = 128) the two bounds are close (~256 FLOP per code
// byte), so the products must run on the tensor cores.
//
// What the design does about it: codes move from device memory as int8
// (or packed int4) and are expanded only in registers or shared memory, so
// the dequantised weight never exists in device memory. Three bodies; the
// wrapper picks one (ops/cuda/quant_matmul.py `qmm_body`):
// * decode body (bf16 x, M <= 16): out^T = W^T x^T on mma.sync m16n8k16,
//   so x's (up to) 8 rows are the n8 side of the product and no row is
//   padding at M = 8. A block owns 128 columns and a K range of at most 512
//   rows, and issues every load of it at once with 16-byte cp.async
//   (neighbouring threads on neighbouring columns): the int8 codes, the
//   scale rows of its groups and x's rows, so one latency covers them. Each
//   lane then reads 16 bytes of each of four code rows of a k16 step (int4:
//   two packed rows) from shared memory: its 16 columns map onto rows g and
//   g + 8 of eight 16-row A tiles, so the bytes are the A fragments with no
//   shuffle; they are expanded to exact floats by a byte permute (no
//   quarter-rate int-to-float conversion), scaled by the group's scale,
//   rounded to bf16 in registers and multiplied. Eight warps take turns
//   over the k16 steps and sum their accumulators in shared memory in warp
//   order.
// * prefill body (bf16 x, M > 16): 128 x 64 output tiles, eight warps of
//   16 rows, so each code is dequantised once for all 128 rows of a prefill
//   tick. The K loop runs in 64-deep steps through a ring of four stages:
//   x's tile (swizzled rows), the int8 code tile and its scale rows arrive
//   by 16-byte cp.async, up to three steps ahead; each step's codes are
//   expanded and scaled into one of two swizzled bf16 W tiles while the
//   step before multiplies, A coming from x by ldmatrix, B from W by
//   ldmatrix.trans (csrc/mma.cuh, as K1's P V), fp32 accumulators.
// * general body (fp32 x, and what the two above do not take: N or the
//   group size not a multiple of 16, x, codes or scales not 16-byte
//   aligned): the original body, 32 x 64 tiles of fp32 FMAs from shared
//   memory, which takes any shape and any group size. An fp32 product on
//   the tensor cores could not meet the fp32 checks.
// With few output tiles the K axis is split over blocks so that enough of
// them stream codes at once. The tensor-core bodies launch a tile's splits
// (at most 8) as one thread-block cluster and sum them through distributed
// shared memory (`ClusterSum`); the general body stores fp32 partials and
// the tile's last block sums them (common.cuh arrive_last). Either way one
// launch per projection, in a fixed order, no atomic on any value.
//
// Where the time still goes (NVIDIA H100 80GB HBM3, PERF.md): the decode
// body is a chain of latencies -- the loads, the products and conversions,
// the cluster barrier -- where the library's GEMV streams;
// the prefill body rereads x once per 64 output columns (four times the
// code bytes at M = 128) and pays a per-step latency that only more splits
// hide. A persistent, pipelined decode body and wgmma with TMA multicast
// of x across a cluster for the prefill body are the next steps.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;
using ds::from_f;
using ds::to_f;

constexpr int kThreads = 128;  // the general body: four warps
constexpr int kKStep = 64;     // every split's K range is a multiple of this
// general body
constexpr int kBM = 32;
constexpr int kBN = 64;
constexpr int kBK = 32;
// decode body: eight warps take turns over the k16 steps
constexpr int kGemvBN = 128;
constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = 32 * kGemvWarps;
// prefill body: eight warps of 16 rows
constexpr int kMmaBM = 128;
constexpr int kMmaBN = 64;
constexpr int kMmaBK = 64;
constexpr int kMmaThreads = 256;

__device__ __forceinline__ uint32_t word(const uint4& u, int c) {
  return c == 0 ? u.x : c == 1 ? u.y : c == 2 ? u.z : u.w;
}

// Code j (0..15) of a 16-byte int8 vector, or the even-row (low) or
// odd-row (high) nibble of byte j of a packed int4 vector, as an exact
// float without the quarter-rate int-to-float conversion: the code, offset
// to unsigned, becomes the low mantissa bits of 2^23 (one byte permute),
// and one exact subtraction removes 2^23 plus the offset.
__device__ __forceinline__ float fcode8(const uint4& u, int j) {
  const uint32_t w = word(u, j / 4) ^ 0x80808080u;
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | (j % 4))) - 8388736.f;
}

__device__ __forceinline__ float fcode4(const uint4& u, int j, bool high) {
  const uint32_t w = ((word(u, j / 4) >> (8 * (j % 4) + (high ? 4 : 0))) & 0xFu) ^ 0x8u;
  return __uint_as_float(0x4B000000u | w) - 8388616.f;
}

// Every split's partial of the tile (m0, n0, bm, bn) summed in split order
// and written to out: run by the tile's last block.
template <typename T>
__device__ void finish_tile(const float* __restrict__ partial, T* __restrict__ out, int M, int N,
                            int m0, int n0, int bm, int bn, int splits) {
  const long long mn = (long long)M * N;
  for (int e = threadIdx.x; e < bm * bn; e += blockDim.x) {
    const int m = m0 + e / bn, n = n0 + e % bn;
    if (m >= M || n >= N) continue;
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += __ldcg(partial + z * mn + (long long)m * N + n);
    out[(long long)m * N + n] = from_f<T>(sum);
  }
}

// The split over K of the tensor-core bodies: the blocks of one output tile
// form a thread-block cluster along z, and each owns a slice of the tile.
// Every block sends each value of its fp32 partial tile (`n` values) to
// the owner's `inbox` ([blocks][slice] floats in every block's shared
// memory), writing the owner's shared memory directly; after a cluster
// barrier each block sums its slice over the blocks in rank order and
// `store(e, sum)` writes value e. Deterministic, one launch, no workspace
// and no atomic. A block writes into another only after that one has
// started and, where the inbox reuses shared memory the kernel worked in,
// finished with it: `ready()` waits for the cluster barrier the kernel
// arrived at (`arrive()`) when that was true.
struct ClusterSum {
  cg::cluster_group cluster;
  float* inbox;
  int n, rank, blocks, slice;

  __device__ ClusterSum(float* inbox_, int n_)
      : cluster(cg::this_cluster()), inbox(inbox_), n(n_), rank(cluster.block_rank()),
        blocks(cluster.num_blocks()), slice((n_ + blocks - 1) / blocks) {}

  static __device__ __forceinline__ void arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  static __device__ __forceinline__ void ready() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }

  // value e of this block's partial tile, into its owner's inbox
  __device__ __forceinline__ void send(int e, float v) const {
    cluster.map_shared_rank(inbox, e / slice)[rank * slice + e % slice] = v;
  }

  // after every block's sends: this block's slice, summed in rank order
  template <typename Store>
  __device__ __forceinline__ void finish(Store store) {
    cluster.sync();
    for (int i = threadIdx.x; i < slice && rank * slice + i < n; i += blockDim.x) {
      float sum = 0.f;
      for (int z = 0; z < blocks; ++z) sum += inbox[z * slice + i];
      store(rank * slice + i, sum);
    }
  }
};

// ---------------------------------------------------------------------------
// general body: fp32 FMAs from shared memory, any shape
// ---------------------------------------------------------------------------
template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
    qmm_fma_kernel(const T* __restrict__ x, const int8_t* __restrict__ codes,
                   const float* __restrict__ scale, T* __restrict__ out, float* __restrict__ partial,
                   int* __restrict__ counters, int M, int K, int N, int group_size, long long ldx,
                   int k_chunk) {
  __shared__ float Xs[kBM][kBK + 1];
  __shared__ float Ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 x 8 threads, 4 x 4 outputs each
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
  if (partial != nullptr &&
      ds::arrive_last(counters + blockIdx.y * gridDim.x + blockIdx.x, gridDim.z))
    finish_tile(partial, out, M, N, m0, n0, kBM, kBN, gridDim.z);
}

// ---------------------------------------------------------------------------
// decode body: out^T = W^T x^T, codes straight into A fragments
// ---------------------------------------------------------------------------

// Shared memory of the decode body: the block's whole K range of codes
// (rows of 128 columns at a 144-byte stride, so the 16-byte fragment reads
// of a quarter warp fall in distinct banks; int4: packed rows), the scale
// rows of the groups it touches, and x's rows, all loaded at once.
constexpr int kGemvCodeLd = kGemvBN + 16;
constexpr int kGemvMaxKChunk = 512;

__host__ __device__ constexpr int gemv_scale_rows(int k_chunk, int group_size) {
  return (k_chunk + group_size - 1) / group_size + 1;
}

template <int BITS, int MT8>
__host__ __device__ constexpr int gemv_smem_bytes(int k_chunk, int group_size) {
  const int codes = (BITS == 8 ? k_chunk : k_chunk / 2) * kGemvCodeLd;
  const int scales = gemv_scale_rows(k_chunk, group_size) * kGemvBN * 4;
  const int xs = 8 * MT8 * (k_chunk + 8) * 2;
  const int red = kGemvWarps * MT8 * 32 * 32 * 4;  // reuses the codes once they are read
  const int inbox = (MT8 * 32 * 32 + 8) * 4;  // the cluster sum's: a tile and a slice's rounding
  return (codes > red ? codes : red) + scales + xs + inbox;
}

template <int BITS, int MT8>
__global__ void __launch_bounds__(kGemvThreads)
    qmm_gemv_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ codes,
                    const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int N,
                    int group_size, long long ldx, int k_chunk) {
  using namespace ds::mma;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRowsPer = BITS == 8 ? 1 : 2;  // k rows per stored code row
  const int code_rows = k_chunk / kRowsPer;
  const int code_bytes = max(code_rows * kGemvCodeLd, kGemvWarps * MT8 * 32 * 32 * 4);
  unsigned char* cs = smem;                                          // codes
  float* ss = reinterpret_cast<float*>(smem + code_bytes);           // [group][128] scales
  bf16* xs = reinterpret_cast<bf16*>(ss + gemv_scale_rows(k_chunk, group_size) * kGemvBN);
  const int xs_ld = k_chunk + 8;  // 4 words of pad: conflict-free fragment reads
  float* inbox = reinterpret_cast<float*>(xs + 8 * MT8 * xs_ld);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_base = blockIdx.x * kGemvBN, m0 = blockIdx.y * 8 * MT8;
  const int k_lo = blockIdx.z * k_chunk, k_hi = min(K, k_lo + k_chunk);
  const int g_lo = k_lo / group_size;
  if (gridDim.z > 1) ClusterSum::arrive();  // this block has started: its inbox may fill

  // every load of the block at once: codes, scales, x
  for (int i = tid; i < code_rows * (kGemvBN / 16); i += kGemvThreads) {
    const int r = i / (kGemvBN / 16), c = i % (kGemvBN / 16);
    const int row = k_lo / kRowsPer + r, n = n_base + 16 * c;
    const bool ok = n < N && row * kRowsPer < k_hi;
    cp_async16(smem_addr(cs + r * kGemvCodeLd + 16 * c), codes + (ok ? (long long)row * N + n : 0), ok);
  }
  const int s_rows = (k_hi - 1) / group_size - g_lo + 1;
  for (int i = tid; i < s_rows * (kGemvBN / 4); i += kGemvThreads) {
    const int r = i / (kGemvBN / 4), c = i % (kGemvBN / 4);
    const bool ok = n_base + 4 * c < N;
    cp_async16(smem_addr(ss + r * kGemvBN + 4 * c),
               scale + (ok ? (long long)(g_lo + r) * N + n_base + 4 * c : 0), ok);
  }
  const int vecs = k_chunk / 8;
  for (int i = tid; i < 8 * MT8 * vecs; i += kGemvThreads) {
    const int r = i / vecs, c = i % vecs;
    const int m = m0 + r, kk = k_lo + 8 * c;
    const bool ok = m < M && kk < k_hi;
    cp_async16(smem_addr(xs + r * xs_ld + 8 * c), x + (ok ? (long long)m * ldx + kk : 0), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this lane's 16 columns: rows g (columns col + j) and g + 8 (col + 8 + j)
  // of A tile j; its fragment rows of a k16 step are 2t, 2t+1, 2t+8, 2t+9
  // (int4: the packed rows t and t + 4 of the step hold the same four)
  float acc[MT8][8][4];
#pragma unroll
  for (int mt = 0; mt < MT8; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;
  const int steps = (k_hi - k_lo + 15) / 16;
  for (int st = warp; st < steps; st += kGemvWarps) {
    const int kr = 16 * st;  // the step's first row within the block's range
    uint4 r[4];
#pragma unroll
    for (int i = 0; i < (BITS == 8 ? 4 : 2); ++i) {
      const int row = BITS == 8 ? kr + 2 * t + (i & 1) + 8 * (i >> 1) : kr / 2 + t + 4 * i;
      r[i] = *reinterpret_cast<const uint4*>(cs + row * kGemvCodeLd + 16 * g);
    }
    float sc[16];
    const float4* sp = reinterpret_cast<const float4*>(ss + ((k_lo + kr) / group_size - g_lo) * kGemvBN + 16 * g);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 f = sp[v];
      sc[4 * v] = f.x;
      sc[4 * v + 1] = f.y;
      sc[4 * v + 2] = f.z;
      sc[4 * v + 3] = f.w;
    }
    // the code of fragment row i (0: 2t, 1: 2t+1, 2: 2t+8, 3: 2t+9) at column j
    auto code = [&](int i, int j) { return BITS == 8 ? fcode8(r[i], j) : fcode4(r[i >> 1], j, i & 1); };
    uint32_t b[MT8][2];
#pragma unroll
    for (int mt = 0; mt < MT8; ++mt) {
      const bf16* xr = xs + (8 * mt + g) * xs_ld + kr + 2 * t;
      b[mt][0] = *reinterpret_cast<const uint32_t*>(xr);
      b[mt][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // dequantise in fp32, round to bf16 (as the JAX kernel feeds the MXU)
      uint32_t a[4];
      a[0] = pack_bf16(code(0, j) * sc[j], code(1, j) * sc[j]);
      a[1] = pack_bf16(code(0, 8 + j) * sc[8 + j], code(1, 8 + j) * sc[8 + j]);
      a[2] = pack_bf16(code(2, j) * sc[j], code(3, j) * sc[j]);
      a[3] = pack_bf16(code(2, 8 + j) * sc[8 + j], code(3, 8 + j) * sc[8 + j]);
#pragma unroll
      for (int mt = 0; mt < MT8; ++mt) mma_bf16(acc[mt][j], a, b[mt][0], b[mt][1]);
    }
  }
  __syncthreads();  // the codes are read: the warps' sums reuse their space

  // acc[mt][j][c] is out[m0 + 8 mt + 2t + (c & 1)][n_base + 16 g + j + 8 (c >> 1)]
  constexpr int kE = MT8 * 8 * 4;  // values per lane
  float* red = reinterpret_cast<float*>(cs);  // [warp][value][lane]
#pragma unroll
  for (int mt = 0; mt < MT8; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(warp * kE + (mt * 8 + j) * 4 + c) * 32 + lane] = acc[mt][j][c];
  __syncthreads();
  auto store = [&](int e, float sum) {
    const int ln = e % 32, v = e / 32;
    const int c = v % 4, j = (v / 4) % 8, mt = v / 32;
    const int m = m0 + 8 * mt + 2 * (ln & 3) + (c & 1);
    const int n = n_base + 16 * (ln >> 2) + j + 8 * (c >> 1);
    if (m < M && n < N) out[(long long)m * N + n] = from_f<bf16>(sum);
  };
  ClusterSum sum_over(inbox, kE * 32);
  if (gridDim.z > 1) ClusterSum::ready();  // every block of the cluster has started
  for (int e = tid; e < kE * 32; e += kGemvThreads) {
    float sum = red[e];
#pragma unroll
    for (int w = 1; w < kGemvWarps; ++w) sum += red[w * kE * 32 + e];
    if (gridDim.z == 1)
      store(e, sum);
    else
      sum_over.send(e, sum);
  }
  if (gridDim.z > 1) sum_over.finish(store);
}

// ---------------------------------------------------------------------------
// prefill body: x A tiles, dequantised W B tiles, cp.async double buffer
// ---------------------------------------------------------------------------
constexpr int kMmaScaleRows = kMmaBK / 16 + 1;  // groups one 64-row step can touch
constexpr int kStages = 4;                       // a ring of steps' tiles in shared memory

template <int BITS>
struct MmaSmem {
  static constexpr int kCodeRows = BITS == 8 ? kMmaBK : kMmaBK / 2;  // stored rows of a code tile
  unsigned char x[kStages][kMmaBM * ds::mma::kRowBytes];
  unsigned char c[kStages][kMmaBK * kMmaBN];  // int4 fills half
  float s[kStages][kMmaScaleRows][kMmaBN];    // each step's group scales
  unsigned char w[2][kMmaBK * ds::mma::kRowBytes];  // two steps' W: swizzled rows k
};

template <int BITS>
__global__ void __launch_bounds__(kMmaThreads)
    qmm_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ codes,
                   const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int N,
                   int group_size, long long ldx, int k_chunk) {
  using namespace ds::mma;
  constexpr int kCodeRows = MmaSmem<BITS>::kCodeRows;
  constexpr int kChunks = kCodeRows * kMmaBN / 16;  // 16-byte chunks of a code tile
  constexpr int kRowChunks = kMmaBN / 16;           // of one code row
  extern __shared__ __align__(128) unsigned char smem[];
  auto& sm = *reinterpret_cast<MmaSmem<BITS>*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kMmaBN, m0 = blockIdx.y * kMmaBM;
  const int k_lo = blockIdx.z * k_chunk, k_hi = min(K, k_lo + k_chunk);
  const int steps = (k_hi - k_lo + kMmaBK - 1) / kMmaBK;

  auto load_stage = [&](int i) {
    const int k0 = k_lo + i * kMmaBK, buf = i % kStages;
    const uint32_t xt = smem_addr(sm.x[buf]);
    for (int e = tid; e < kMmaBM * 8; e += kMmaThreads) {
      const int r = e >> 3, c = e & 7;
      const int m = m0 + r, kk = k0 + 8 * c;
      const bool ok = m < M && kk < k_hi;
      cp_async16(xt + swizzle(r, c), x + (ok ? (long long)m * ldx + kk : 0), ok);
    }
    const uint32_t ct = smem_addr(sm.c[buf]);
    for (int e = tid; e < kChunks; e += kMmaThreads) {
      const int r = e / kRowChunks, c = e % kRowChunks;
      const int row = (BITS == 8 ? k0 : k0 / 2) + r, n = n0 + 16 * c;
      const bool ok = n < N && (BITS == 8 ? row : 2 * row) < k_hi;
      cp_async16(ct + r * kMmaBN + 16 * c, codes + (ok ? (long long)row * N + n : 0), ok);
    }
    // scale rows of the groups k0 / group_size .. (last row) / group_size
    const int g0 = k0 / group_size, rows = (min(k_hi, k0 + kMmaBK) - 1) / group_size - g0 + 1;
    const uint32_t st = smem_addr(sm.s[buf]);
    if (tid < rows * kMmaBN / 4) {
      const int r = tid / (kMmaBN / 4), c = tid % (kMmaBN / 4);
      const bool ok = n0 + 4 * c < N;
      cp_async16(st + (r * kMmaBN + 4 * c) * 4, scale + (ok ? (long long)(g0 + r) * N + n0 + 4 * c : 0), ok);
    }
  };

  // the codes of step i -> bf16 W rows k (swizzled, contiguous in n), in
  // W buffer i & 1
  auto dequant = [&](int i) {
    const int k0 = k_lo + i * kMmaBK, buf = i % kStages;
    for (int e = tid; e < kChunks; e += kMmaThreads) {
      const int r = e / kRowChunks, c = e % kRowChunks;
      const uint4 u = *reinterpret_cast<const uint4*>(sm.c[buf] + r * kMmaBN + 16 * c);
      const int k_row = k0 + (BITS == 8 ? r : 2 * r);  // int4: rows 2r, 2r + 1 share a group
      const float* sp = sm.s[buf][k_row / group_size - k0 / group_size] + 16 * c;
      float sc[16];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 f = reinterpret_cast<const float4*>(sp)[v];
        sc[4 * v] = f.x;
        sc[4 * v + 1] = f.y;
        sc[4 * v + 2] = f.z;
        sc[4 * v + 3] = f.w;
      }
      const uint32_t wt = smem_addr(sm.w[i & 1]);
#pragma unroll
      for (int half = 0; half < (BITS == 8 ? 1 : 2); ++half) {
        uint32_t w[8];
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          const float c0 = BITS == 8 ? fcode8(u, j) : fcode4(u, j, half);
          const float c1 = BITS == 8 ? fcode8(u, j + 1) : fcode4(u, j + 1, half);
          w[j / 2] = pack_bf16(c0 * sc[j], c1 * sc[j + 1]);
        }
        const int wr = BITS == 8 ? r : 2 * r + half;
        st_shared16(wt + swizzle(wr, 2 * c), w[0], w[1], w[2], w[3]);
        st_shared16(wt + swizzle(wr, 2 * c + 1), w[4], w[5], w[6], w[7]);
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  // One commit group per step (empty past the end). Step i multiplies while
  // step i + 1 is dequantised into the other W buffer and steps i + 2 and
  // i + 3 load.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) load_stage(i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  dequant(0);
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 3>();  // step i + 1 landed
    __syncthreads();  // W of step i is written; every warp is done with step i - 1
    if (i + kStages - 1 < steps) load_stage(i + kStages - 1);  // into step i - 1's buffers
    cp_async_commit();
    const uint32_t xt = smem_addr(sm.x[i % kStages]), wt = smem_addr(sm.w[i & 1]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      load_a(a, xt, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        uint32_t b[4];
        load_b_trans(b, wt, 16 * jn, 16 * kk, lane);
        mma_bf16(acc[2 * jn], a, b[0], b[1]);
        mma_bf16(acc[2 * jn + 1], a, b[2], b[3]);
      }
    }
    if (i + 1 < steps) dequant(i + 1);
  }

  // acc[n][c] is out[m0 + 16 warp + g + 8 (c >> 1)][n0 + 8 n + 2t + (c & 1)]
  const int g = lane >> 2, t = lane & 3;
  if (gridDim.z == 1) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + 16 * warp + g + 8 * half, col = n0 + 8 * n + 2 * t;
        if (m < M && col < N)
          *reinterpret_cast<uint32_t*>(out + (long long)m * N + col) =
              pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
      }
    return;
  }
  // the inbox reuses the x tiles: every block of the cluster must be done
  // with its own before any block sends
  static_assert(sizeof(MmaSmem<BITS>::x) >= (kMmaBM * kMmaBN + 8) * 4,
                "the cluster sum's inbox must fit in the x tiles");
  cp_async_wait<0>();  // only empty groups are left
  ClusterSum sum_over(reinterpret_cast<float*>(smem), kMmaBM * kMmaBN);
  ClusterSum::arrive();
  ClusterSum::ready();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sum_over.send((16 * warp + g + 8 * (c >> 1)) * kMmaBN + 8 * n + 2 * t + (c & 1), acc[n][c]);
  sum_over.finish([&](int e, float sum) {
    const int m = m0 + e / kMmaBN, n = n0 + e % kMmaBN;
    if (m < M && n < N) out[(long long)m * N + n] = from_f<bf16>(sum);
  });
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
struct Call {
  const void* x;
  const void* codes;
  const void* scale;
  void* out;
  float* partial;  // general body: null when splits == 1
  int* counters;
  int M, K, N, group_size;
  long long ldx;
  int k_chunk, splits;
};

constexpr int kMaxCluster = 8;  // the portable cluster size: the tensor-core bodies' largest split

template <typename T, int BITS>
cudaError_t launch_fma(const Call& c, cudaStream_t stream) {
  dim3 grid((c.N + kBN - 1) / kBN, (c.M + kBM - 1) / kBM, c.splits);
  qmm_fma_kernel<T, BITS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(c.x), static_cast<const int8_t*>(c.codes),
      static_cast<const float*>(c.scale), static_cast<T*>(c.out), c.partial, c.counters, c.M, c.K,
      c.N, c.group_size, c.ldx, c.k_chunk);
  return cudaGetLastError();
}

// a tensor-core body, its splits as one cluster per output tile
template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, int smem, const Call& c,
                           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = c.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(c.x), static_cast<const int8_t*>(c.codes),
      static_cast<const float*>(c.scale), static_cast<bf16*>(c.out), c.M, c.K, c.N, c.group_size,
      c.ldx, c.k_chunk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BITS, int MT8>
cudaError_t launch_gemv(const Call& c, cudaStream_t stream) {
  auto kernel = qmm_gemv_kernel<BITS, MT8>;
  // the most any call takes: the longest K range at the smallest group
  static cudaError_t attr = ds::allow_smem(kernel, gemv_smem_bytes<BITS, MT8>(kGemvMaxKChunk, 16));
  if (attr != cudaSuccess) return attr;
  dim3 grid((c.N + kGemvBN - 1) / kGemvBN, (c.M + 8 * MT8 - 1) / (8 * MT8), c.splits);
  return launch_cluster(kernel, grid, kGemvThreads, gemv_smem_bytes<BITS, MT8>(c.k_chunk, c.group_size),
                        c, stream);
}

template <int BITS>
cudaError_t launch_mma(const Call& c, cudaStream_t stream) {
  constexpr int smem = sizeof(MmaSmem<BITS>);
  static cudaError_t attr = ds::allow_smem(qmm_mma_kernel<BITS>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((c.N + kMmaBN - 1) / kMmaBN, (c.M + kMmaBM - 1) / kMmaBM, c.splits);
  return launch_cluster(qmm_mma_kernel<BITS>, grid, kMmaThreads, smem, c, stream);
}

template <int BITS>
cudaError_t dispatch(int dtype, int body, const Call& c, cudaStream_t stream) {
  if (body == 0 && dtype == ds::kFloat32) return launch_fma<float, BITS>(c, stream);
  if (body == 0 && dtype == ds::kBFloat16) return launch_fma<bf16, BITS>(c, stream);
  if (dtype != ds::kBFloat16 || c.N % 16 || c.group_size % 16 || c.ldx % 8 || c.splits > kMaxCluster)
    return cudaErrorInvalidValue;
  if (body == 1 && c.M <= 16 && c.k_chunk <= kGemvMaxKChunk)
    return c.M <= 8 ? launch_gemv<BITS, 1>(c, stream) : launch_gemv<BITS, 2>(c, stream);
  if (body == 2) return launch_mma<BITS>(c, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: [M, K] (unit stride on K, row stride ldx); codes: contiguous int8 [K, N]
// (bits 8) or [K/2, N] (bits 4); scale: contiguous fp32 [K/group_size, N];
// out: contiguous [M, N] of x's dtype. body 0 is the general body, 1 the
// decode body (bf16, M <= 16), 2 the prefill body (bf16); bodies 1 and 2
// need N and the group size multiples of 16, ldx a multiple of 8 and
// 16-byte aligned x, codes and scales. Each split covers k_chunk rows of K
// (a multiple of 64; body 1: at most 2048). Bodies 1 and 2 take at most 8
// splits, reduced within a cluster; body 0 with splits > 1 needs an fp32
// workspace of splits * M * N and a zeroed counter per output tile, which
// the launch leaves zero.
int ds_quant_matmul(const void* x, const void* codes, const void* scale, void* out,
                    void* workspace, void* counters, int dtype, int bits, int body, int M, int K,
                    int N, int group_size, long long ldx, int k_chunk, int splits, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || group_size <= 0 || K % group_size != 0)
    return cudaErrorInvalidValue;
  if (k_chunk <= 0 || k_chunk % kKStep != 0 || splits < 1 ||
      (long long)(splits - 1) * k_chunk >= K || (long long)splits * k_chunk < K)
    return cudaErrorInvalidValue;
  if (body == 0 && splits > 1 && (workspace == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  const Call c{x, codes, scale, out, splits > 1 ? static_cast<float*>(workspace) : nullptr,
               static_cast<int*>(counters), M, K, N, group_size, ldx, k_chunk, splits};
  if (bits == 8) return dispatch<8>(dtype, body, c, cs);
  if (bits == 4) return dispatch<4>(dtype, body, c, cs);
  return cudaErrorInvalidValue;
}

const char* ds_quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
