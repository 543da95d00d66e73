// Tensor-core building blocks for the bf16 attention kernels (K1, K4, K6):
// cp.async tile loads into swizzled shared memory (rows in order, or
// gathered from a block list), ldmatrix fragment loads and the mma.sync
// m16n8k16 bf16 product with fp32 accumulation.
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), for lane l with g = l / 4 and t = l % 4:
//   * accumulator C/D (16 x 8 fp32): c0, c1 at row g, columns 2t and 2t+1;
//     c2, c3 at row g + 8, the same columns;
//   * A (16 x 16 bf16, row-major), four registers of two values each:
//     a0 = row g, k 2t..2t+1; a1 = row g+8, k 2t..; a2 = row g, k 2t+8..;
//     a3 = row g+8, k 2t+8..;
//   * B (16 x 8 bf16, "col"): b0 = k 2t..2t+1 at column g; b1 = k 2t+8.. .
// So the accumulators of two neighbouring n-tiles (columns 0-7 and 8-15)
// are, packed to bf16 pairs, exactly the A operand of one k16 step: a
// product's output feeds the next product from registers.
//
// Shared tiles hold rows of COLS bf16 (the head dim: 64 or 128, i.e. 128
// or 256 bytes, eight or sixteen 16-byte chunks). Chunk c of row r sits at
// chunk c ^ (r % 8), so the eight rows one ldmatrix 8x8 matrix reads fall in
// eight different bank groups, and the 16-byte cp.async writes of eight
// consecutive chunks do too. COLS defaults to 64, so a caller that names no
// width (K2, K3 at head dim 64, K6) compiles to what it did before the width
// became a parameter.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ds {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kRowBytes = 128;  // one row of a shared tile of the default width: 64 bf16

// bytes of one row of a shared tile of COLS bf16
template <int COLS>
__host__ __device__ constexpr int row_bytes() {
  static_assert(COLS % 64 == 0, "rows are whole multiples of eight 16-byte chunks");
  return COLS * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
template <int COLS = 64>
__device__ __forceinline__ uint32_t swizzle(int row, int chunk) {
  return row * row_bytes<COLS>() + ((chunk ^ (row & 7)) << 4);
}

// 16 bytes global -> shared, asynchronously; with valid false nothing is
// read and the 16 bytes are zero-filled (rows past the end of a tensor)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously, zero-filled when not valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + ROWS - 1 of a [L, COLS] bf16 slice with row stride
// `ld` elements into a swizzled shared tile, by the THREADS threads numbered
// `tid` = 0 .. THREADS - 1 (the thread block, one warp, or the warps that
// share a block list in K6); rows >= L are zero-filled and never read.
// Needs a 16-byte aligned `src` and `ld` a multiple of 8 (the Python
// wrappers check both).
template <int ROWS, int THREADS, int COLS = 64>
__device__ __forceinline__ void load_tile_by(uint32_t tile, const bf16* __restrict__ src, int row0,
                                             int L, long long ld, int tid) {
  constexpr int kChunks = COLS / 8;  // 16-byte chunks per row
  // log2(kChunks): a shift and a mask, where a signed i / kChunks would add
  // a sign fix-up and change the code of the default width
  constexpr int kShift = COLS == 64 ? 3 : 4;
  static_assert(kChunks == 1 << kShift, "rows of 64 or 128 bf16");
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i >> kShift, chunk = i & (kChunks - 1);
    const int row = row0 + r;
    const bool ok = row < L;
    cp_async16(tile + swizzle<COLS>(r, chunk), src + (ok ? row * ld + chunk * 8 : 0), ok);
  }
}

// load_tile_by the whole thread block of THREADS threads
template <int ROWS, int THREADS, int COLS = 64>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* __restrict__ src, int row0,
                                          int L, long long ld) {
  load_tile_by<ROWS, THREADS, COLS>(tile, src, row0, L, ld, threadIdx.x);
}

// A gathered tile (K6): tile row r holds slot s0 + r of the concatenation
// of the blocks of a compacted block list, block list[j] of BLK rows at
// slots j BLK .. j BLK + BLK - 1. Slots past the n_live listed blocks are
// padding: zero-filled, nothing read. Loaded by THREADS threads numbered
// `tid`; the same alignment rule as load_tile.
template <int ROWS, int BLK, int THREADS>
__device__ __forceinline__ void load_tile_gathered(uint32_t tile, const bf16* __restrict__ src,
                                                   const int* list, int n_live, int s0,
                                                   long long ld, int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * 8; i += THREADS) {
    const int r = i >> 3, chunk = i & 7;
    const int s = s0 + r;
    const int blk = s / BLK;
    const bool ok = blk < n_live;
    const long long row = ok ? static_cast<long long>(list[blk]) * BLK + s % BLK : 0;
    cp_async16(tile + swizzle(r, chunk), src + row * ld + chunk * 8, ok);
  }
}

// 16 bytes from registers into shared memory (a tile the thread filled
// itself, e.g. int8 codes dequantised to bf16 on their way in)
__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A operand of rows m0..m0+15, k k0..k0+15 of a swizzled row-major tile
template <int COLS = 64>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile, int m0, int k0, int lane) {
  ldsm_x4(a, tile + swizzle<COLS>(m0 + (lane & 15), (k0 >> 3) + (lane >> 4)));
}

// B operands of the two n-tiles n0..n0+7 and n0+8..n0+15 at k k0..k0+15,
// where the tile holds B transposed: row n, contiguous in k (K for Q K^T).
// b[0], b[1] are the first n-tile's b0, b1; b[2], b[3] the second's.
template <int COLS = 64>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], uint32_t tile, int n0, int k0, int lane) {
  ldsm_x4(b, tile + swizzle<COLS>(n0 + (lane & 7) + ((lane >> 4) << 3),
                                  (k0 >> 3) + ((lane >> 3) & 1)));
}

// B operands of the two n-tiles n0.. and n0+8.. at k k0..k0+15, where the
// tile holds B as it is: row k, contiguous in n (V for P V).
template <int COLS = 64>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], uint32_t tile, int n0, int k0,
                                             int lane) {
  ldsm_x4_trans(b, tile + swizzle<COLS>(k0 + (lane & 15), (n0 >> 3) + (lane >> 4)));
}

// d += a * b over one m16n8k16 step, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest even into one bf16 pair, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-step kk (columns 16 kk .. 16 kk + 15) from the fp32
// accumulators of n-tiles 2 kk and 2 kk + 1, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The same A operand as an unevaluated bf16 sum hi + lo: hi is the
// accumulators rounded to bf16, lo their rounding error rounded to bf16, so
// hi + lo carries each fp32 value to within 2^-17 of it. Two products, one
// with hi and one with lo, then give the product of the fp32 values to
// within that error, where one product with hi alone is off by up to 2^-9.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&c0)[4], const float (&c1)[4]) {
  split_bf16(hi[0], lo[0], c0[0], c0[1]);
  split_bf16(hi[1], lo[1], c0[2], c0[3]);
  split_bf16(hi[2], lo[2], c1[0], c1[1]);
  split_bf16(hi[3], lo[3], c1[2], c1[3]);
}

// acc[n][c] (the N8 n-tiles of a 16 x 8 N8 result) times `mul`, rounded to
// bf16 and stored as pairs into rows row0 + g and row0 + g + 8 of a
// [rows, 8 N8] tensor with row stride `ld`; rows >= rows_end are skipped.
template <int N8>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long long ld, int row0,
                                           int rows_end, const float (&acc)[N8][4], float mul0,
                                           float mul1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= rows_end) continue;
    const float mul = half ? mul1 : mul0;
    bf16* p = dst + row * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < N8; ++n)
      *reinterpret_cast<uint32_t*>(p + 8 * n) =
          pack_bf16(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

}  // namespace mma
}  // namespace ds
