// Shared by the bf16 kernels of short_attn_fwd.cu and short_attn_bwd.cu: one
// (batch item, head) per block, S padded to SP and D to DP (multiples of 16,
// zero fill), the operands as bf16 tiles in shared memory (row stride DP +
// kRowPad), and the products of an f32 intermediate (pd, ds) with a bf16
// input taken as three bf16 terms on the tensor cores (flash_mma.cuh).
//
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) hold all 24 bits
// of x (x - hi and x - hi - mid are exact in f32), so each product is the f32
// product up to the order of the f32 sums; two terms keep 16 bits and miss
// the one-ulp tolerance near zero.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "flash_mma.cuh"

namespace mmda {
namespace short_mma {

using flash::bf16;
using flash::frag_addr_rows;
using flash::ldmatrix_x4_trans;
using flash::mma_bf16;

// Rows < SP and columns < DP of the row-major (S, D) bf16 matrix src into dst
// (row stride ld = DP + kRowPad), by the block's nt threads; rows >= S and
// columns >= D are zero.  16-byte loads where D is a multiple of 8 and src is
// 16-byte aligned, else one element at a time.
__device__ __forceinline__ void load_operand(bf16* dst, int ld, const bf16* src, int S, int D,
                                             int SP, int DP, int nt) {
  if ((D & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = DP / 8;
    for (int i = threadIdx.x; i < SP * chunks; i += nt) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < S && c < D) val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < SP * DP; i += nt) {
      const int r = i / DP;
      const int c = i - r * DP;
      dst[r * ld + c] = r < S && c < D ? src[(size_t)r * D + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// load_operand with every 16-byte piece in flight at once (cp.async, zero
// filled beyond S and D) where D is a multiple of 8 and src is 16-byte
// aligned; the caller commits and waits.  Else one element at a time.
__device__ __forceinline__ void load_operand_async(bf16* dst, int ld, const bf16* src, int S,
                                                   int D, int SP, int DP, int nt) {
  if ((D & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = DP / 8;
    for (int i = threadIdx.x; i < SP * chunks; i += nt) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 8;
      const bool valid = r < S && c < D;
      flash::cp_async_16(dst + r * ld + c, valid ? src + (size_t)r * D + c : src, valid);
    }
  } else {
    load_operand(dst, ld, src, S, D, SP, DP, nt);
  }
}

// x0, x1 as three bf16 pairs hi + mid + lo, packed as operand registers, the
// lower column in the lower half.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The 16 x SP f32 block c (C fragments of SP / 8 n8 tiles) as the three bf16
// terms of the A operand of a product over its SP columns: a[t][kk] is term t
// of columns 16 kk .. 16 kk + 15.
template <int K16>
__device__ __forceinline__ void split_operand(uint32_t (&a)[3][K16][4],
                                              const float (&c)[2 * K16][4]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    split3(c[2 * kk][0], c[2 * kk][1], a[0][kk][0], a[1][kk][0], a[2][kk][0]);
    split3(c[2 * kk][2], c[2 * kk][3], a[0][kk][1], a[1][kk][1], a[2][kk][1]);
    split3(c[2 * kk + 1][0], c[2 * kk + 1][1], a[0][kk][2], a[1][kk][2], a[2][kk][2]);
    split3(c[2 * kk + 1][2], c[2 * kk + 1][3], a[0][kk][3], a[1][kk][3], a[2][kk][3]);
  }
}

// Rows row0 + g and row0 + g + 8 (< S) of the row-major (S, D) bf16 matrix
// dst get (x a) b times mul, columns < D: x the 16 x SP f32 block held as its
// three bf16 terms a, b all SP rows of the row-major tile b_s; 16 columns at a
// time.
template <int K16>
__device__ __forceinline__ void product_out(bf16* dst, const uint32_t (&a)[3][K16][4],
                                            const bf16* b_s, int ld, int S, int D, int DP,
                                            int row0, float mul, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  for (int c0 = 0; c0 < DP; c0 += 16) {
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, frag_addr_rows(b_s, ld, 16 * kk, c0, lane));
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        mma_bf16(acc[0], a[t][kk], b[0], b[1]);
        mma_bf16(acc[1], a[t][kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + g + 8 * half;
      if (r >= S) continue;
      bf16* row = dst + (size_t)r * D;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = c0 + 8 * jj + t2;
        const float x0 = acc[jj][2 * half] * mul, x1 = acc[jj][2 * half + 1] * mul;
        if ((D & 1) == 0 && c + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < D) row[c] = __float2bfloat16_rn(x0);
          if (c + 1 < D) row[c + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

}  // namespace short_mma
}  // namespace mmda
