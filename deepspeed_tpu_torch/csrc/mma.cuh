// Tensor-core building blocks for the bf16 and fp16 attention kernels (K1,
// K4, K6): cp.async tile loads into swizzled shared memory (rows in order, or
// gathered from a block list), ldmatrix fragment loads and the mma.sync
// m16n8k16 bf16 and f16 products with fp32 accumulation. Both 16-bit types
// share every layout below (two bytes an element); only the product's
// instruction and the rounding of fp32 into a register pair differ, so the
// helpers that touch values take the element type T (bf16 by default, what
// the kernels that name none compile to) and the loads deduce it.
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
// Shared tiles hold rows of COLS bf16 (the head dim: 64, 128 or 256, i.e.
// 128, 256 or 512 bytes, 8, 16 or 32 16-byte chunks). Chunk c of row r sits
// at chunk c ^ (r % 8), so the eight rows one ldmatrix 8x8 matrix reads fall
// in eight different bank groups, and the 16-byte cp.async writes of eight
// consecutive chunks do too. COLS defaults to 64, so a caller that names no
// width (K2, K3 at head dim 64, K6) compiles to what it did before the width
// became a parameter. Head dim 96 (GPT-NeoX-20b) is 12 chunks, which the XOR
// would carry past the end of the row (chunk 11 ^ 7 = 12); its rows are laid
// out 128 columns wide (tile_cols), and only the first 96 are loaded and
// read: the swizzle, and so the bank pattern, is that of head dim 128.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace ds {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kRowBytes = 128;  // one row of a shared tile of the default width: 64 bf16

// columns of the shared rows that hold head dim D: D itself where it is a
// whole number of 64-column units, else the next such width (96 -> 128)
template <int D>
__host__ __device__ constexpr int tile_cols() {
  return (D + 63) / 64 * 64;
}

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

// Rows row0 .. row0 + ROWS - 1 of a [L, USED] bf16 slice with row stride
// `ld` elements into a swizzled shared tile of COLS-column rows (USED <=
// COLS: the columns past USED are neither written nor read), by the THREADS
// threads numbered `tid` = 0 .. THREADS - 1 (the thread block, one warp, or
// the warps that share a block list in K6); rows >= L are zero-filled and
// never read. Needs a 16-byte aligned `src` and `ld` a multiple of 8 (the
// Python wrappers check both).
template <int ROWS, int THREADS, int COLS = 64, typename T = bf16, int USED = COLS>
__device__ __forceinline__ void load_tile_by(uint32_t tile, const T* __restrict__ src, int row0,
                                             int L, long long ld, int tid) {
  constexpr int kChunks = USED / 8;  // 16-byte chunks loaded per row
  static_assert(USED % 8 == 0 && USED <= COLS, "whole 16-byte chunks inside the row");
  if constexpr (USED == COLS) {
    // log2(kChunks): a shift and a mask, where a signed i / kChunks would
    // add a sign fix-up and change the code of the default width
    constexpr int kShift = COLS == 64 ? 3 : COLS == 128 ? 4 : 5;
    static_assert(kChunks == 1 << kShift, "rows of 64, 128 or 256 bf16");
#pragma unroll
    for (int i = tid; i < ROWS * kChunks; i += THREADS) {
      const int r = i >> kShift, chunk = i & (kChunks - 1);
      const int row = row0 + r;
      const bool ok = row < L;
      cp_async16(tile + swizzle<COLS>(r, chunk), src + (ok ? row * ld + chunk * 8 : 0), ok);
    }
  } else {  // a row that is not a power of two of chunks (head dim 96: 12)
#pragma unroll
    for (int i = tid; i < ROWS * kChunks; i += THREADS) {
      const int r = static_cast<unsigned>(i) / kChunks, chunk = static_cast<unsigned>(i) % kChunks;
      const int row = row0 + r;
      const bool ok = row < L;
      cp_async16(tile + swizzle<COLS>(r, chunk), src + (ok ? row * ld + chunk * 8 : 0), ok);
    }
  }
}

// load_tile_by the whole thread block of THREADS threads
template <int ROWS, int THREADS, int COLS = 64, typename T = bf16, int USED = COLS>
__device__ __forceinline__ void load_tile(uint32_t tile, const T* __restrict__ src, int row0,
                                          int L, long long ld) {
  load_tile_by<ROWS, THREADS, COLS, T, USED>(tile, src, row0, L, ld, threadIdx.x);
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

// d += a * b over one m16n8k16 step, fp16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the m16n8k16 product of element type T
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    mma_f16(d, a, b0, b1);
  else
    mma_bf16(d, a, b0, b1);
}

// two floats rounded to nearest even into one bf16 pair, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the same into one fp16 pair (values past 65504 round to inf)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// The A operand of k-step kk (columns 16 kk .. 16 kk + 15) from the fp32
// accumulators of n-tiles 2 kk and 2 kk + 1, rounded to T.
template <typename T = bf16>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
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

// The fp16 pair: hi keeps 11 significant bits, and lo the rest down to
// fp16's least step, 2^-24 (lo of a value below 2^-3 is subnormal). So for
// K1's p in [0, 1] hi + lo is within 2^-25 of p, an absolute bound where
// bf16's hi + lo is within 2^-17 of p relative to it.
__device__ __forceinline__ void split_f16(uint32_t& hi, uint32_t& lo, float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  const float2 hf = __half22float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_f16(a - hf.x, b - hf.y);
}

template <typename T = bf16>
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&c0)[4], const float (&c1)[4]) {
  if constexpr (std::is_same<T, __half>::value) {
    split_f16(hi[0], lo[0], c0[0], c0[1]);
    split_f16(hi[1], lo[1], c0[2], c0[3]);
    split_f16(hi[2], lo[2], c1[0], c1[1]);
    split_f16(hi[3], lo[3], c1[2], c1[3]);
  } else {
    split_bf16(hi[0], lo[0], c0[0], c0[1]);
    split_bf16(hi[1], lo[1], c0[2], c0[3]);
    split_bf16(hi[2], lo[2], c1[0], c1[1]);
    split_bf16(hi[3], lo[3], c1[2], c1[3]);
  }
}

// 2^e as a float, exactly, for e in [-126, 127]
__device__ __forceinline__ float pow2(int e) { return __int_as_float((e + 127) << 23); }

// K4's fp16 dS (see flash_bwd.cu): the exponent of a row with no scale yet
constexpr int kNoExp = -1000;

// Scale each of the two rows a lane holds of a 16 x 8 N8 fp32 tile (rows g
// and g + 8: elements c = 0, 1 and c = 2, 3, shared by the four lanes of a
// quad) by 2^-e, so that the row's largest magnitude lies below 2^15 and
// rounds to a finite fp16 (max 65504). The exponent e of a row only grows
// from tile to tile; where it grows, the row of `acc` (the fp32 sum of
// products of earlier scaled tiles) is scaled down by the same power of
// two, so acc times 2^e stays the unscaled sum. Exact in fp32: only powers
// of two multiply. A non-finite row keeps its exponent and stays non-finite.
template <int N8, int NA>
__device__ __forceinline__ void fit_rows_f16(float (&x)[N8][4], int (&e)[2], float (&acc)[NA][4]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mx = 0.f;
#pragma unroll
    for (int n = 0; n < N8; ++n)
      mx = fmaxf(mx, fmaxf(fabsf(x[n][2 * hf]), fabsf(x[n][2 * hf + 1])));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (mx > 0.f && isfinite(mx)) {
      int x_exp;
      frexpf(mx, &x_exp);  // mx < 2^x_exp
      const int want = min(max(x_exp - 15, -110), 110);
      if (e[hf] == kNoExp) {
        e[hf] = want;
      } else if (want > e[hf]) {
        const float r = pow2(max(e[hf] - want, -126));
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          acc[a][2 * hf] *= r;
          acc[a][2 * hf + 1] *= r;
        }
        e[hf] = want;
      }
    }
    if (e[hf] != kNoExp) {
      const float inv = pow2(-e[hf]);
#pragma unroll
      for (int n = 0; n < N8; ++n) {
        x[n][2 * hf] *= inv;
        x[n][2 * hf + 1] *= inv;
      }
    }
  }
}

// acc[n][c] (the N8 n-tiles of a 16 x 8 N8 result) times `mul`, rounded to
// T and stored as pairs into rows row0 + g and row0 + g + 8 of a
// [rows, 8 N8] tensor with row stride `ld`; rows >= rows_end are skipped.
template <int N8, typename T = bf16>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long ld, int row0,
                                           int rows_end, const float (&acc)[N8][4], float mul0,
                                           float mul1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + g + 8 * hf;
    if (row >= rows_end) continue;
    const float mul = hf ? mul1 : mul0;
    T* p = dst + row * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < N8; ++n)
      *reinterpret_cast<uint32_t*>(p + 8 * n) =
          pack2<T>(acc[n][2 * hf] * mul, acc[n][2 * hf + 1] * mul);
  }
}

}  // namespace mma
}  // namespace ds
