// Shared by short_attn_tiled_fwd.cu and short_attn_tiled_bwd.cu: the short
// attention kernels' arithmetic (short_attn_fwd.cu, short_attn_bwd.cu) over
// tiles of queries and keys, for sequences longer than one block holds.
//
// Tiles.  A bf16 block has kTileWarps = 4 warps and owns 64 rows (queries in
// the forward and the dq kernel, keys in the dk/dv kernel), 16 a warp; it
// streams the other side in tiles of NB = 64 rows (32 at a padded head dim of
// 128, which keeps the accumulators in registers), two buffers in turn filled
// by cp.async.  The head dim D is padded with zero columns to DP in {16, 32,
// 64, 128}: a zero column adds an exact 0 to every product.  An f32 block has
// kF32Warps = 8 warps and owns 32 rows, 4 a warp; it streams tiles of 32
// rows, one a lane.
//
// The softmax is exact: the row max m is the max over every key, and
// p = exp(s - m) / l with l = sum exp(s - m).  A first pass over the key
// tiles takes m and l (l rescaled by exp(m_old - m_new) when a tile raises the
// max, the sums in a fixed order), a second forms p.  The keep mask is the
// short kernels' own hash at i S + j with S the full length.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"
#include "hash_dropout.cuh"
#include "short_mma.cuh"

namespace mmda {
namespace short_tiled {

using flash::bf16;

constexpr int kTileWarps = 4;             // bf16: 16 rows a warp, 64 a block
constexpr int kTileRows = 16 * kTileWarps;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kF32Warps = 8;              // f32: 4 rows a warp, 32 a block
constexpr int kF32Rows = 32;
constexpr int kF32RowsPerWarp = kF32Rows / kF32Warps;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kMaxD = 128;                // 4 output columns a lane (f32), DP <= 128 (bf16)
constexpr int kF32Cols = kMaxD / 32;

// The streamed tile's rows for a padded head dim DP.
template <int DP>
__host__ __device__ constexpr int stream_rows() { return DP <= 64 ? 64 : 32; }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows row0 .. row0 + R - 1 of the row-major (S, D) bf16 matrix src into dst
// (row stride DP + kRowPad), zero beyond S and D: cp.async where it can
// (short_mma::load_operand_async); the caller commits.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int R, int S,
                                          int D, int nt) {
  const int valid = min(R, S - row0);
  short_mma::load_operand_async(dst, DP + flash::kRowPad, src + (size_t)row0 * D, valid, D, R,
                                DP, nt);
}

// max and sum over the 4 lanes of a quad (the lanes that share a row of a C
// fragment), the same value in each
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc += (x as three bf16 terms) b: x a 16 x NB f32 block in C fragments, b
// the NB x DP tile b_s (the row-major rows of the streamed side)
template <int DP, int NB>
__device__ __forceinline__ void split_product(float (&acc)[DP / 8][4],
                                              const float (&x)[NB / 8][4], const bf16* b_s,
                                              int lane) {
  uint32_t a[3][NB / 16][4];
  short_mma::split_operand<NB / 16>(a, x);
#pragma unroll
  for (int t = 0; t < 3; ++t) flash::mma_pb<DP, NB / 16, DP / 8>(acc, a[t], b_s, 0, lane);
}

// Rows row0 + g, row0 + g + 8 (< S) of the accumulator block acc (16 x DP)
// times mul, columns < D, into the row-major (S, D) bf16 matrix dst.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DP / 8][4], int row0,
                                           int S, int D, float mul, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= S) continue;
    bf16* row = dst + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + t2;
      const float x0 = acc[j][2 * half] * mul, x1 = acc[j][2 * half + 1] * mul;
      if ((D & 1) == 0 && c + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < D) row[c] = __float2bfloat16_rn(x0);
        if (c + 1 < D) row[c + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// Rows r0 .. r0 + R - 1 of the row-major (S, D) f32 matrix src, times mul,
// into dst (row stride D + 1), zero beyond S; by the block's nt threads.
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int r0, int R, int S,
                                          int D, float mul, int nt) {
  for (int e = threadIdx.x; e < R * D; e += nt) {
    const int r = e / D;
    const int c = e - r * D;
    dst[r * (D + 1) + c] = r0 + r < S ? src[(size_t)(r0 + r) * D + c] * mul : 0.0f;
  }
}

}  // namespace short_tiled
}  // namespace mmda
