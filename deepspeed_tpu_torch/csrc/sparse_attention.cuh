// Shared pieces of K6, the block-sparse flash attention kernels
// (csrc/sparse_fwd.cu and csrc/sparse_bwd.cu).
//
// Both passes own one side's rows (query rows in the forward and dq passes,
// key rows in the dk/dv pass) and walk the other side's active blocks from
// the layout's index lists. Those blocks are not contiguous in memory, so
// each pass stages them into shared tiles taken from the concatenation of
// the live blocks in list order. Slots past the last live block are
// padding: they are never loaded (their rows read 0) and every pair with
// them is dead. The lists are compacted first with warp ballots (which
// entries a pass keeps: `Keep`).
//
// bf16 (`MmaGeo`, the tensor-core bodies on csrc/mma.cuh): a thread block
// of four warps owns 64 rows, one m16 tile per warp. The warps that own one
// layout block share its list: at block 16 each warp walks its own block's
// list, at 32 pairs of warps do, at 64 and 128 all four (a 128 block spans
// two thread blocks). Each list group stages its live blocks KS rows at a
// time with cp.async into swizzled tiles, double-buffered, and meets only
// its own warps at a barrier, so groups that walk lists of other lengths
// never wait for each other. Which rows a group owns comes from a unit
// order (`unit_of_group`): longest list first, so the groups that share a
// thread block walk lists of like length and the longest start first.
//
// fp32 (`Geo`, the FMA bodies): a thread block owns one layout block of BLK
// rows of one (batch, head) and stages 64-row tiles: four blocks of 16, two
// of 32, one of 64, or half of a 128 block per tile. Thread layout: (BLK /
// RI) x 16 threads. Thread (tr, tc) owns rows tr + TR i (i < RI) of its
// block; in a [BLK, 64] score tile it owns the staged slots tc + 16 j, in a
// [BLK, 64] output tile the head-dim columns 4 tc + j (j < 4). The 16
// threads of one row group are 16 consecutive lanes of a warp, so row
// maxima and sums reduce with four shuffles and a row's probabilities are
// written and read back by the same lanes (__syncwarp). Shared rows are
// padded to 68 floats: 16-byte vector loads along a row, and the 16 rows
// one load instruction touches fall in distinct banks.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace ds {
namespace sparse {

constexpr int kD = 64;         // head dim
constexpr int kT = 64;         // rows of a staged tile
constexpr int kLd = 68;        // shared row stride in floats
constexpr int kTile = kT * kLd;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block may opt into

template <int BLK>
struct Geo {
  static constexpr int RI = BLK >= 32 ? 4 : 2;  // rows per thread
  static constexpr int TR = BLK / RI;            // row groups
  static constexpr int kThreads = TR * 16;
};

// Which list entries a pass keeps: all, or under causal the blocks not wholly
// above the diagonal (key blocks j <= the query block, query blocks i >= the
// key block).
enum Keep { kKeepAll = 0, kKeepAtMost = 1, kKeepAtLeast = 2 };

// Copy the in-range entries idx[t] (t < cnt) that `keep` admits, in order,
// into list, by one warp with ballots; every lane returns their number.
__device__ __forceinline__ int compact_warp(const int* __restrict__ idx, int cnt, int n, int keep,
                                            int pivot, int* list, int lane) {
  int base = 0;
  for (int t0 = 0; t0 < cnt; t0 += 32) {
    const int t = t0 + lane;
    const int j = t < cnt ? idx[t] : -1;
    bool ok = j >= 0 && j < n;
    if (keep == kKeepAtMost) ok = ok && j <= pivot;
    if (keep == kKeepAtLeast) ok = ok && j >= pivot;
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (ok) list[base + __popc(ballot & ((1u << lane) - 1u))] = j;
    base += __popc(ballot);
  }
  return base;
}

// compact_warp by warp 0 for the whole thread block; every thread must
// call it (it ends in a barrier) and gets the count.
__device__ __forceinline__ int compact(const int* __restrict__ idx, int cnt, int n, int keep,
                                       int pivot, int* list, int* count) {
  if (threadIdx.x < 32) {
    const int base = compact_warp(idx, cnt, n, keep, pivot, list, threadIdx.x);
    if (threadIdx.x == 0) *count = base;
  }
  __syncthreads();
  return *count;
}

// Row position in [0, L) of slot s of staged tile tt, or -1 for padding.
template <int BLK>
__device__ __forceinline__ int slot_pos(const int* list, int n_live, int tt, int s) {
  const int v = tt * kT + s;
  const int blk = v / BLK;
  return blk < n_live ? list[blk] * BLK + v % BLK : -1;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core geometry
// ---------------------------------------------------------------------------
template <int BLK>
struct MmaGeo {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kGroupWarps = BLK >= 64 ? kWarps : BLK / 16;  // warps per list
  static constexpr int kGroups = kWarps / kGroupWarps;                 // lists per thread block
  static constexpr int kGroupThreads = 32 * kGroupWarps;
  static constexpr int kUnitRows = 16 * kGroupWarps;  // rows a list group owns
  // rows staged per step: 32 at block 16 keeps four groups' double buffers
  // at 64 KB (three thread blocks per SM), 64 otherwise
  static constexpr int KS = BLK == 16 ? 32 : 64;
};

// The barrier of one list group: a warp, a named barrier of two warps, or
// the whole thread block.
template <int GROUP_WARPS>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (GROUP_WARPS == 1) {
    __syncwarp();
  } else if constexpr (GROUP_WARPS == 4) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * GROUP_WARPS) : "memory");
  }
}

// What this warp's list group owns: a unit of kUnitRows rows (a layout
// block, or half of a 128 block) of one (batch, head). The grid is 1-D, B
// thread blocks per kGroups consecutive slots of the unit order `order`
// (h * n_units + unit each; the wrapper's longest-list-first schedule, so
// one thread block's groups walk lists of like length), or of the natural
// order when it is null. Sets row0 = L for a slot past the last unit (the
// group then owns nothing).
template <int BLK>
__device__ __forceinline__ void unit_of_group(const int* __restrict__ order, int B, int H, int L,
                                              int& b, int& h, int& row0) {
  using G = MmaGeo<BLK>;
  const int n_units = L / G::kUnitRows;
  const int idx = blockIdx.x;
  const int slot = (idx / B) * G::kGroups + (threadIdx.x >> 5) / G::kGroupWarps;
  b = idx % B;
  h = 0;
  row0 = L;
  if (slot < H * n_units) {
    const int e = order ? order[slot] : slot;
    h = e / n_units;
    row0 = (e % n_units) * G::kUnitRows;
  }
}

// The list of the group this warp belongs to (the one of layout block
// `blk` of head h), compacted by the group's first warp into `list`; an
// out-of-range block (the tail tile of a length that is not a multiple of
// 64) gets none. Every thread must call it (it ends in a barrier).
template <int BLK>
__device__ __forceinline__ int compact_group(const int* __restrict__ idx,
                                             const int* __restrict__ cnt, int h, int nb, int blk,
                                             int max_len, int keep, int* list, int* count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp % MmaGeo<BLK>::kGroupWarps == 0) {
    int n = 0;
    if (blk < nb) {
      const long long row = static_cast<long long>(h) * nb + blk;
      n = compact_warp(idx + row * max_len, min(cnt[row], max_len), nb, keep, blk, list, lane);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// ---------------------------------------------------------------------------
// fp32: FMA bodies
// ---------------------------------------------------------------------------
// Staged tile tt of one (batch, head) slice of a [B, L, H, 64] tensor (`src`
// at that slice, row stride sl) into dst [64][kLd], times mul; padding reads 0.
template <typename T, int BLK, int NT>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, long long sl,
                                      const int* list, int n_live, int tt, float mul) {
  for (int idx = threadIdx.x; idx < kT * kD; idx += NT) {
    const int s = idx >> 6, c = idx & 63;
    const int pos = slot_pos<BLK>(list, n_live, tt, s);
    dst[s * kLd + c] = pos >= 0 ? to_f(src[static_cast<long long>(pos) * sl + c]) * mul : 0.f;
  }
}

// Rows row0 .. row0 + BLK - 1 of one (batch, head) slice into dst [BLK][kLd], times mul.
template <typename T, int BLK, int NT>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                                          long long sl, float mul) {
  for (int idx = threadIdx.x; idx < BLK * kD; idx += NT) {
    const int r = idx >> 6, c = idx & 63;
    dst[r * kLd + c] = to_f(src[static_cast<long long>(row0 + r) * sl + c]) * mul;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// acc[i][j] = sum_d A[ra + TR i][d] * B[rb + 16 j][d] over the 64 head-dim
// columns (both row-major, d contiguous).
template <int RI, int TR>
__device__ __forceinline__ void dot_rows(const float* A, const float* B, int ra, int rb,
                                         float (&acc)[RI][4]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 a[RI], b[4];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ra + TR * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
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

// acc[i][j] += sum_s A[ra + TR i][s] * B[s][cb + j] over the 64 staged slots
// s (A row-major with s contiguous, B a staged tile [64][kLd], cb a multiple of 4).
template <int RI, int TR>
__device__ __forceinline__ void acc_rows(const float* A, const float* B, int ra, int cb,
                                         float (&acc)[RI][4]) {
#pragma unroll 2
  for (int s = 0; s < kT; s += 4) {
    float4 a[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ra + TR * i) * kLd + s);
#pragma unroll
    for (int ss = 0; ss < 4; ++ss) {
      const float4 b = *reinterpret_cast<const float4*>(B + (s + ss) * kLd + cb);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float av = lane_of(a[i], ss);
        acc[i][0] = fmaf(av, b.x, acc[i][0]);
        acc[i][1] = fmaf(av, b.y, acc[i][1]);
        acc[i][2] = fmaf(av, b.z, acc[i][2]);
        acc[i][3] = fmaf(av, b.w, acc[i][3]);
      }
    }
  }
}

// Reductions over the 16 lanes of one row group.
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Let one kernel instantiation use the largest dynamic shared memory (the
// launcher calls it once per instantiation and refuses a launch whose index
// list would not fit).
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace sparse
}  // namespace ds
