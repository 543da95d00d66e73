// K3: length-masked decode attention against a per-slot KV cache, split
// over the cache, reading the cache as values or as int8 codes.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (deepspeed_tpu/ops/pallas/
// flash_attention.py:555, launched by `flash_decode` :602): the newest Lq
// query tokens of each slot attend its [P, H, D] cache, where row i sits at
// position lengths[s] - Lq + i and sees the keys at or before it, inside
// min(lengths[s], P) (a parked slot carries length P + Lq; the TPU grid
// never ran past the pool's blocks). Rows with no live key, and slots with
// length 0, return zeros. The cache comes as values of q's dtype, or as
// int8 codes with per-(slot, position, head) scales of q's dtype that are
// dequantised on read exactly as the plain version dequantises the pool,
// T(float(code) * float(scale)); the two forms then run the same arithmetic
// after the load, so one pool gives the same bits either way.
//
// What bounds it on the H100: bytes. Each live key and value is used by at
// most Lq (1 or 16) query rows, a few FLOPs per byte read, two orders of
// magnitude under the 295 FLOP/byte ridge; the least time is the live K/V
// bytes (int8: codes plus scales) over 3.35 TB/s.
//
// What the design does about it:
// * Split over the cache (flash-decoding). A block owns one chunk of keys
//   of one (slot, head) for one query row (row body) or one tile of 16 rows
//   (tile body) and computes its partial (m, l, acc). The grid spans the
//   pool's chunks; a block whose chunk starts past the live keys of its rows
//   returns before it loads anything, so the work follows the live lengths
//   and one long slot spreads over many SMs. With one live chunk the block
//   writes o itself; otherwise each block stores its partial and the last
//   to arrive (common.cuh arrive_last) merges them in chunk order: one
//   launch, deterministic, no atomic on any value. A row with no live key
//   is written as zeros by chunk 0's block; a row of a tile with no live key
//   in some chunk gives that chunk l = 0, which the merge weighs as nothing.
// * Row body (Lq = 1, the decode tick, and every fp32 call): no idle rows.
//   Four lanes share a key, 16 dims each, so one warp reads 8 key rows of a
//   head per step, each a whole 128-byte (bf16) or 64-byte (int8) row (at
//   head dim 128: eight lanes a key, 4 rows of 256 or 128 bytes a step); a
//   block covers 64 keys, two per lane group, all loaded at once as 16-byte
//   vectors into registers (each key is read by one warp once, so a staging
//   copy through shared memory would buy nothing). Scores reduce over the
//   four lanes; the chunk's max and sums over the block, in a fixed order.
// * Tile body (bf16, Lq > 1: a prefill chunk of 16 rows is one m16 tile):
//   the tensor cores, as K1 (rows of D bf16: at head dim 128 the block's
//   tiles take 132 KB of shared memory). Each warp takes 64 keys of a 256-key chunk; its
//   K and V tiles arrive by 16-byte cp.async into swizzled rows (bf16), or
//   by 16-byte loads of the codes, dequantised into the same swizzled bf16
//   tile (int8); then S = Q K^T and O += P V run on mma.sync m16n8k16 with
//   fp32 accumulators, P split into bf16 hi + lo as in K1, and the four
//   warps' partials merge in shared memory. All of a block's loads are in
//   flight at once, which is what a double buffer buys a longer loop.
// * Head dims 96 (GPT-NeoX-20b) and 256 (GPT-J-6b), each a library of its
//   own (-DDS_HEAD_DIM=96 or 256). The row body gives a key eight lanes of
//   16 dims at 96 as at 128, and the lanes past dim 96 load nothing and add
//   0; at 256 a key takes 16 lanes, and in fp32 the value rows load after
//   the scores (K and V rows of 64 keys at once would be 256 registers a
//   thread). The tile body lays its rows out 128 columns wide at 96 (K1's
//   layout, csrc/mma.cuh tile_cols); at 256 each warp takes 32 keys of a
//   128-key chunk (64 keys would need 270 KB of shared memory) and reads
//   Q's fragment from shared memory at each k16 step (its O is already 128
//   registers a thread), so the chunk of the tile body is 128 keys there
//   (ops/cuda/attention_geometry.py decode_chunk).
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ds::from_f;
using ds::kNegInf;
using ds::to_f;

constexpr int kThreads = 128;    // four warps
constexpr int kWarps = 4;
constexpr int kRowChunk = 64;    // keys per block, row body (DECODE_CHUNK["rows"])
constexpr int kTileRows = 16;    // query rows per block, tile body

// head dim D (ops/cuda/attention_geometry.py KERNEL_HEAD_DIMS): one stored
// partial (m, l, acc[D]), the columns of a shared row (tile_cols), the keys
// of a tile body's warp and block (DECODE_CHUNK["tiles"], 128 at head dim
// 256: decode_chunk) and its shared memory (q's tile and each warp's K and
// V tiles)
template <int D>
struct Dim {
  static_assert(D == 64 || D == 96 || D == 128 || D == 256,
                "K3 is instantiated for head dims 64, 96, 128 and 256");
  static constexpr int kPart = D + 2;
  static constexpr int kCols = ds::mma::tile_cols<D>();
  static constexpr int kWarpKeys = D <= 128 ? 64 : 32;
  static constexpr int kTileChunk = kWarps * kWarpKeys;
  static constexpr int kTileSmem =
      (kTileRows + kWarps * 2 * kWarpKeys) * ds::mma::row_bytes<kCols>();
  static constexpr bool kQRegs = D <= 128;  // the tile body's Q fragments in registers
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* ks;  // int8 form: scales [S, P, H, 1] of q's dtype; otherwise null
  const void* vs;
  const int* lengths;
  void* o;
  float* ws;       // partials [S, H, Lq, chunks of P, kPart]
  int* counters;   // >= S * H * Lq zeroed arrival counters
  int S, H, Lq, P;
  float scale;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  long long ks_sb, ks_sl, ks_sh, vs_sb, vs_sl, vs_sh;
};

// keys [0, limit) are live for query row `row` of a slot of `length`: at or
// before the row's position and inside the pool
__device__ __forceinline__ int row_limit(int length, int P, int Lq, int row) {
  const int n_live = min(max(length, 0), P);
  return max(0, min(n_live, length - Lq + row + 1));
}

template <int D>
__device__ __forceinline__ float* part_of(const Args& a, int s, int h, int row, int chunk_keys) {
  const int n_chunks = (a.P + chunk_keys - 1) / chunk_keys;
  return a.ws + ((((long long)s * a.H + h) * a.Lq + row) * n_chunks) * Dim<D>::kPart;
}

// dim d of one row's output from its n stored partials, merged in chunk
// order; a row whose partials all have l = 0 gives 0
template <int D>
__device__ __forceinline__ float merge_partials(const float* part, int n, int d) {
  constexpr int kPart = Dim<D>::kPart;
  float m = kNegInf;
  for (int c = 0; c < n; ++c) m = fmaxf(m, __ldcg(part + c * kPart));
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < n; ++c) {
    const float f = expf(__ldcg(part + c * kPart) - m);
    l = fmaf(__ldcg(part + c * kPart + 1), f, l);
    acc = fmaf(__ldcg(part + c * kPart + 2 + d), f, acc);
  }
  return acc / fmaxf(l, 1e-37f);
}

// ---------------------------------------------------------------------------
// 16 consecutive dims of one key row, as loaded and as read
// ---------------------------------------------------------------------------
template <typename KV>
struct Raw {
  static constexpr int kVec = sizeof(KV);  // 16-byte vectors per 16 elements
  uint4 u[kVec];
};

template <typename KV>
__device__ __forceinline__ void load_raw(Raw<KV>& r, const KV* p, bool ok) {
#pragma unroll
  for (int i = 0; i < Raw<KV>::kVec; ++i)
    r.u[i] = ok ? __ldg(reinterpret_cast<const uint4*>(p) + i) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ uint32_t word(const uint4& u, int c) {
  return c == 0 ? u.x : c == 1 ? u.y : c == 2 ? u.z : u.w;
}

template <typename T>
__device__ __forceinline__ void to_floats(const Raw<float>& r, float, float (&w)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) w[e] = __uint_as_float(word(r.u[e / 4], e % 4));
}

template <typename T>
__device__ __forceinline__ void to_floats(const Raw<bf16>& r, float, float (&w)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const uint32_t x = word(r.u[e / 8], (e % 8) / 2);
    w[e] = __uint_as_float(e % 2 ? x & 0xffff0000u : x << 16);
  }
}

// int8 codes: T(float(code) * scale), the plain version's dequantised pool
template <typename T>
__device__ __forceinline__ void to_floats(const Raw<int8_t>& r, float sc, float (&w)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int code = static_cast<int8_t>(word(r.u[0], e / 4) >> (8 * (e % 4)));
    w[e] = to_f(from_f<T>(static_cast<float>(code) * sc));
  }
}

template <typename T, typename KV>
__device__ __forceinline__ float scale_of(const void* sc, long long idx, bool ok) {
  if constexpr (sizeof(KV) == 1) return ok ? to_f(static_cast<const T*>(sc)[idx]) : 0.f;
  return 0.f;
}

// ---------------------------------------------------------------------------
// row body: one query row per block, lanes on keys
// ---------------------------------------------------------------------------
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads) decode_rows_kernel(const Args a) {
  __shared__ float red[kWarps];
  __shared__ float acc_s[kWarps][D];
  constexpr int kLanes = Dim<D>::kCols / 16;             // lanes that share a key
  constexpr int kLive = D / 16;                          // of which hold dims (6 of 8 at 96)
  constexpr int kGroups = 32 / kLanes;                   // keys a warp reads per step
  constexpr int kSteps = kRowChunk / (kWarps * kGroups);  // keys per lane group
  constexpr int kPart = Dim<D>::kPart;
  // K and V rows of all the steps at once, in 32-bit registers; past 128 the
  // value rows load after the scores instead (fp32 at head dim 256)
  constexpr bool kLateV = kSteps * Raw<KV>::kVec * 4 * 2 > 128;

  const int chunk = blockIdx.x, h = blockIdx.y;
  const int s = blockIdx.z / a.Lq, row = blockIdx.z % a.Lq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = a.lengths[s];
  const int limit = row_limit(length, a.P, a.Lq, row);
  const int n_chunks = (limit + kRowChunk - 1) / kRowChunk;
  T* out = static_cast<T*>(a.o) + (((long long)s * a.Lq + row) * a.H + h) * D;
  if (chunk >= max(n_chunks, 1)) return;
  if (n_chunks == 0) {  // no live key: zeros, written by chunk 0's block
    for (int d = tid; d < D; d += kThreads) out[d] = from_f<T>(0.f);
    return;
  }

  const int kg = lane / kLanes, dq = lane % kLanes;  // key of the warp's step; dims 16 dq ..
  const bool dims = dq < kLive;                      // a lane past the head dim loads nothing
  const KV* kp = static_cast<const KV*>(a.k) + s * a.k_sb + h * a.k_sh + 16 * dq;
  const KV* vp = static_cast<const KV*>(a.v) + s * a.v_sb + h * a.v_sh + 16 * dq;
  Raw<KV> kr[kSteps], vr[kSteps];
  float ksc[kSteps], vsc[kSteps];
  int key[kSteps];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    key[st] = chunk * kRowChunk + warp * kGroups * kSteps + kGroups * st + kg;
    const bool ok = key[st] < limit;
    load_raw(kr[st], kp + key[st] * a.k_sl, ok && dims);
    if constexpr (!kLateV) load_raw(vr[st], vp + key[st] * a.v_sl, ok && dims);
    ksc[st] = scale_of<T, KV>(a.ks, s * a.ks_sb + key[st] * a.ks_sl + h * a.ks_sh, ok);
    vsc[st] = scale_of<T, KV>(a.vs, s * a.vs_sb + key[st] * a.vs_sl + h * a.vs_sh, ok);
  }
  const T* qp = static_cast<const T*>(a.q) + s * a.q_sb + row * a.q_sl + h * a.q_sh + 16 * dq;
  float qv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qv[i] = dims ? to_f(qp[i]) * a.scale : 0.f;

  float sc[kSteps], mx = kNegInf;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    float w[16];
    to_floats<T>(kr[st], ksc[st], w);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dot = fmaf(qv[i], w[i], dot);
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    sc[st] = key[st] < limit ? dot : kNegInf;
    mx = fmaxf(mx, sc[st]);
  }
  mx = ds::warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  const float m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();  // red is reused below

  if constexpr (kLateV) {
#pragma unroll
    for (int st = 0; st < kSteps; ++st) load_raw(vr[st], vp + key[st] * a.v_sl, key[st] < limit && dims);
  }
  float lsum = 0.f, acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    // masked keys give an explicit 0
    const float p = key[st] < limit ? expf(sc[st] - m) : 0.f;
    lsum += p;
    float w[16];
    to_floats<T>(vr[st], vsc[st], w);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = fmaf(p, w[i], acc[i]);
  }
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {  // over the warp's key groups
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (kg == 0 && dims) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc_s[warp][16 * dq + i] = acc[i];
  }
  if (lane == 0) red[warp] = lsum;
  __syncthreads();

  const float l = red[0] + red[1] + red[2] + red[3];
  if (n_chunks == 1) {
    for (int d = tid; d < D; d += kThreads) {
      const float o = acc_s[0][d] + acc_s[1][d] + acc_s[2][d] + acc_s[3][d];
      out[d] = from_f<T>(o / fmaxf(l, 1e-37f));
    }
    return;
  }
  float* part = part_of<D>(a, s, h, row, kRowChunk);
  for (int d = tid; d < D; d += kThreads)
    part[chunk * kPart + 2 + d] = acc_s[0][d] + acc_s[1][d] + acc_s[2][d] + acc_s[3][d];
  if (tid == 0) {
    part[chunk * kPart] = m;
    part[chunk * kPart + 1] = l;
  }
  if (ds::arrive_last(a.counters + ((long long)s * a.H + h) * a.Lq + row, n_chunks))
    for (int d = tid; d < D; d += kThreads) out[d] = from_f<T>(merge_partials<D>(part, n_chunks, d));
}

// ---------------------------------------------------------------------------
// tile body (bf16): 16 query rows per block on the tensor cores
// ---------------------------------------------------------------------------

// Rows key0 .. key0 + 63 of a [L, D] int8 code slice (row stride `ld`
// bytes) with their scales (stride `sld` elements) into a swizzled bf16
// tile, dequantised as the row body reads them; rows >= limit are zeros.
// D / 16 lanes per row, 16 codes each, all the loads a lane makes at once;
// rows of Dim<D>::kCols columns (the first D written).
template <int D>
__device__ __forceinline__ void load_codes_tile(uint32_t tile, const int8_t* __restrict__ src,
                                                const bf16* __restrict__ sc, int key0, int limit,
                                                long long ld, long long sld, int lane) {
  constexpr int kLanes = D / 16;
  constexpr int kIt = Dim<D>::kWarpKeys * kLanes / 32;
  constexpr int kCols = Dim<D>::kCols;
  // i / kLanes and i % kLanes: a shift and a mask where kLanes is a power of
  // two (the unsigned division compiles to them), a multiply at 96
  const auto row_of = [](int i) { return static_cast<int>(static_cast<unsigned>(i) / kLanes); };
  const auto col_of = [](int i) { return static_cast<int>(static_cast<unsigned>(i) % kLanes); };
  uint4 u[kIt];
  float f[kIt];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = lane + 32 * it, key = key0 + row_of(i);
    const bool ok = key < limit;
    u[it] = ok ? __ldg(reinterpret_cast<const uint4*>(src + key * ld + 16 * col_of(i)))
               : make_uint4(0, 0, 0, 0);
    f[it] = ok ? __bfloat162float(sc[key * sld]) : 0.f;
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int i = lane + 32 * it, r = row_of(i), c = col_of(i);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const uint32_t x = word(u[it], e / 4);
      const int c0 = static_cast<int8_t>(x >> (8 * (e % 4)));
      const int c1 = static_cast<int8_t>(x >> (8 * (e % 4) + 8));
      w[e / 2] = ds::mma::pack_bf16(static_cast<float>(c0) * f[it], static_cast<float>(c1) * f[it]);
    }
    ds::mma::st_shared16(tile + ds::mma::swizzle<kCols>(r, 2 * c), w[0], w[1], w[2], w[3]);
    ds::mma::st_shared16(tile + ds::mma::swizzle<kCols>(r, 2 * c + 1), w[4], w[5], w[6], w[7]);
  }
}

template <typename KV, int D>
__global__ void __launch_bounds__(kThreads) decode_tile_kernel(const Args a) {
  using namespace ds::mma;
  constexpr int kCols = Dim<D>::kCols;
  constexpr int kRowB = row_bytes<kCols>();
  constexpr int kPart = Dim<D>::kPart;
  constexpr int kWarpKeys = Dim<D>::kWarpKeys, kTileChunk = Dim<D>::kTileChunk;
  constexpr int kN8 = kWarpKeys / 8;  // n8 tiles of a warp's scores
  constexpr bool kQRegs = Dim<D>::kQRegs;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_tiles = (a.Lq + kTileRows - 1) / kTileRows;
  const int chunk = blockIdx.x, h = blockIdx.y;
  const int s = blockIdx.z / row_tiles, row0 = (blockIdx.z % row_tiles) * kTileRows;
  const int rows_end = min(a.Lq, row0 + kTileRows);
  const int length = a.lengths[s];
  // the tile's last row sees the most keys
  const int limit_max = row_limit(length, a.P, a.Lq, rows_end - 1);
  const int n_chunks = (limit_max + kTileChunk - 1) / kTileChunk;
  bf16* out = static_cast<bf16*>(a.o);
  const long long o_row = (long long)a.H * D;  // between query rows of a slot
  const long long o_base = ((long long)s * a.Lq * a.H + h) * D;
  if (chunk >= max(n_chunks, 1)) return;
  if (n_chunks == 0) {  // no live key in any row: zeros, written by chunk 0's block
    for (int i = tid; i < kTileRows * D; i += kThreads)
      if (row0 + i / D < rows_end) out[o_base + (row0 + i / D) * o_row + i % D] = from_f<bf16>(0.f);
    return;
  }

  const uint32_t q_tile = smem_addr(smem);
  const uint32_t k_tile = q_tile + (kTileRows + warp * 2 * kWarpKeys) * kRowB;
  const uint32_t v_tile = k_tile + kWarpKeys * kRowB;
  load_tile_by<kTileRows, kThreads, kCols, bf16, D>(
      q_tile, static_cast<const bf16*>(a.q) + s * a.q_sb + h * a.q_sh, row0, a.Lq, a.q_sl, tid);
  const int key0 = chunk * kTileChunk + warp * kWarpKeys;
  const bool warp_live = key0 < limit_max;
  if (warp_live) {
    if constexpr (sizeof(KV) == 1) {
      load_codes_tile<D>(k_tile, static_cast<const int8_t*>(a.k) + s * a.k_sb + h * a.k_sh,
                      static_cast<const bf16*>(a.ks) + s * a.ks_sb + h * a.ks_sh, key0, limit_max,
                      a.k_sl, a.ks_sl, lane);
      load_codes_tile<D>(v_tile, static_cast<const int8_t*>(a.v) + s * a.v_sb + h * a.v_sh,
                      static_cast<const bf16*>(a.vs) + s * a.vs_sb + h * a.vs_sh, key0, limit_max,
                      a.v_sl, a.vs_sl, lane);
    } else {
      load_tile_by<kWarpKeys, 32, kCols, bf16, D>(
          k_tile, static_cast<const bf16*>(a.k) + s * a.k_sb + h * a.k_sh, key0, limit_max, a.k_sl,
          lane);
      load_tile_by<kWarpKeys, 32, kCols, bf16, D>(
          v_tile, static_cast<const bf16*>(a.v) + s * a.v_sb + h * a.v_sh, key0, limit_max, a.v_sl,
          lane);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r_lo = row0 + g, r_hi = r_lo + 8;
  const int lim_lo = r_lo < a.Lq ? row_limit(length, a.P, a.Lq, r_lo) : 0;
  const int lim_hi = r_hi < a.Lq ? row_limit(length, a.P, a.Lq, r_hi) : 0;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  if (warp_live) {
    uint32_t qa[kQRegs ? D / 16 : 1][4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a<kCols>(qa[kk], q_tile, 0, 16 * kk, lane);
    }
    float sacc[kN8][4];
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[n][c] = 0.f;
#pragma unroll
    for (int j = 0; j < kN8 / 2; ++j)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        load_b<kCols>(b, k_tile, 16 * j, 16 * kk, lane);
        if constexpr (kQRegs) {
          mma_bf16(sacc[2 * j], qa[kk], b[0], b[1]);
          mma_bf16(sacc[2 * j + 1], qa[kk], b[2], b[3]);
        } else {  // head dim 256: this step's Q fragment from shared memory
          uint32_t qs[4];
          load_a<kCols>(qs, q_tile, 0, 16 * kk, lane);
          mma_bf16(sacc[2 * j], qs, b[0], b[1]);
          mma_bf16(sacc[2 * j + 1], qs, b[2], b[3]);
        }
      }
    // scale and mask; a dead key keeps kNegInf and gets an explicit p = 0
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = key0 + 8 * n + 2 * t + (c & 1);
        sacc[n][c] = key < (c < 2 ? lim_lo : lim_hi) ? sacc[n][c] * a.scale : kNegInf;
        if (c < 2)
          m_lo = fmaxf(m_lo, sacc[n][c]);
        else
          m_hi = fmaxf(m_hi, sacc[n][c]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
    }
#pragma unroll
    for (int n = 0; n < kN8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = key0 + 8 * n + 2 * t + (c & 1);
        const bool live = key < (c < 2 ? lim_lo : lim_hi);
        const float p = live ? expf(sacc[n][c] - (c < 2 ? m_lo : m_hi)) : 0.f;
        sacc[n][c] = p;
        if (c < 2)
          l_lo += p;
        else
          l_hi += p;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
#pragma unroll
    for (int kk = 0; kk < kN8 / 2; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a_split(hi, lo, sacc[2 * kk], sacc[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t b[4];
        load_b_trans<kCols>(b, v_tile, 16 * jd, 16 * kk, lane);
        mma_bf16(o[2 * jd], hi, b[0], b[1]);
        mma_bf16(o[2 * jd], lo, b[0], b[1]);
        mma_bf16(o[2 * jd + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * jd + 1], lo, b[2], b[3]);
      }
    }
  }
  __syncthreads();  // the tiles are read: the merge reuses their space

  // the four warps' (m, l, o) of each row, merged in warp order
  float* ms = reinterpret_cast<float*>(smem);   // [warp][row]
  float* ls = ms + kWarps * kTileRows;          // [warp][row]
  float* os = ls + kWarps * kTileRows;          // [warp][row][dim]
  if (t == 0) {
    ms[warp * kTileRows + g] = m_lo;
    ms[warp * kTileRows + g + 8] = m_hi;
    ls[warp * kTileRows + g] = l_lo;
    ls[warp * kTileRows + g + 8] = l_hi;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      os[(warp * kTileRows + g + 8 * (c >> 1)) * D + 8 * n + 2 * t + (c & 1)] = o[n][c];
  __syncthreads();

  float* part = n_chunks > 1 ? part_of<D>(a, s, h, 0, kTileChunk) : nullptr;
  const long long part_row = (long long)((a.P + kTileChunk - 1) / kTileChunk) * kPart;
  for (int i = tid; i < kTileRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (row0 + r >= rows_end) continue;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ms[w * kTileRows + r]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(ms[w * kTileRows + r] - m);
      l = fmaf(ls[w * kTileRows + r], f, l);
      acc = fmaf(os[(w * kTileRows + r) * D + d], f, acc);
    }
    if (part == nullptr) {
      out[o_base + (row0 + r) * o_row + d] = from_f<bf16>(acc / fmaxf(l, 1e-37f));
    } else {
      float* p = part + (row0 + r) * part_row + chunk * kPart;
      p[2 + d] = acc;
      if (d == 0) {
        p[0] = m;
        p[1] = l;
      }
    }
  }
  if (part == nullptr) return;
  if (!ds::arrive_last(a.counters + ((long long)s * a.H + h) * a.Lq + row0, n_chunks)) return;
  for (int i = tid; i < kTileRows * D; i += kThreads) {
    const int r = i / D;
    if (row0 + r < rows_end)
      out[o_base + (row0 + r) * o_row + i % D] =
          from_f<bf16>(merge_partials<D>(part + (row0 + r) * part_row, n_chunks, i % D));
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename T, typename KV, int D>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  if ((long long)a.S * a.Lq > 65535) return cudaErrorInvalidValue;
  dim3 grid((a.P + kRowChunk - 1) / kRowChunk, a.H, a.S * a.Lq);
  decode_rows_kernel<T, KV, D><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename KV, int D>
cudaError_t launch_tiles(const Args& a, cudaStream_t stream) {
  auto kernel = decode_tile_kernel<KV, D>;
  constexpr int kSmem = Dim<D>::kTileSmem, kTileChunk = Dim<D>::kTileChunk;
  static cudaError_t attr = ds::allow_smem(kernel, kSmem);
  if (attr != cudaSuccess) return attr;
  const int row_tiles = (a.Lq + kTileRows - 1) / kTileRows;
  if ((long long)a.S * row_tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid((a.P + kTileChunk - 1) / kTileChunk, a.H, a.S * row_tiles);
  kernel<<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, int dtype, int body, bool codes, cudaStream_t cs) {
  if (body == 0 && dtype == ds::kFloat32)
    return codes ? launch_rows<float, int8_t, D>(a, cs) : launch_rows<float, float, D>(a, cs);
  if (body == 0 && dtype == ds::kBFloat16)
    return codes ? launch_rows<bf16, int8_t, D>(a, cs) : launch_rows<bf16, bf16, D>(a, cs);
  if (body == 1 && dtype == ds::kBFloat16)
    return codes ? launch_tiles<int8_t, D>(a, cs) : launch_tiles<bf16, D>(a, cs);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: [S, Lq, H, D], D 64 or 128 (96 or 256 in the library built with
// -DDS_HEAD_DIM=96 or 256); k/v: [S, P, H, D] values of q's dtype, or int8 codes
// with k_scale/v_scale [S, P, H, 1] of q's dtype (both null for values);
// unit stride on D, element strides (slot, position, head) for each, k and
// v 16-byte aligned with strides of 16 bytes' multiples (and q too for the
// tile body). lengths: [S] int32; o: contiguous [S, Lq, H, D]. body 0 is
// the row body (any dtype and Lq), 1 the tile body (bf16). ws: fp32
// partials [S, H, Lq, ceil(P / chunk), D + 2], chunk = 64 (body 0) or 256
// (body 1; 128 at head dim 256); counters: >= S * H * Lq int32, zero, and left zero.
int ds_flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                    const void* v_scale, const void* lengths, void* o, void* ws, void* counters,
                    int dtype, int body, int S, int H, int Lq, int P, int D, float scale,
                    long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl,
                    long long k_sh, long long v_sb, long long v_sl, long long v_sh,
                    long long ks_sb, long long ks_sl, long long ks_sh, long long vs_sb,
                    long long vs_sl, long long vs_sh, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (S <= 0 || H <= 0 || Lq <= 0 || P <= 0 || ws == nullptr || counters == nullptr)
    return cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  const bool codes = k_scale != nullptr;
  const Args a{q,    k,    v,    k_scale, v_scale, static_cast<const int*>(lengths),
               o,    static_cast<float*>(ws),     static_cast<int*>(counters),
               S,    H,    Lq,   P,       scale,   q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
               v_sb, v_sl, v_sh, ks_sb,   ks_sl,   ks_sh, vs_sb, vs_sl, vs_sh};
#ifdef DS_HEAD_DIM
  // a library of one head dim (ops/cuda/build.py VARIANTS)
  if (D == DS_HEAD_DIM) return launch<DS_HEAD_DIM>(a, dtype, body, codes, cs);
#else
  if (D == 64) return launch<64>(a, dtype, body, codes, cs);
  if (D == 128) return launch<128>(a, dtype, body, codes, cs);
#endif
  return cudaErrorInvalidValue;
}

const char* ds_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
