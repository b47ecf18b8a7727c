// Shared by the bf16 instantiations of flash_bwd_dq.cu and flash_bwd_dkv.cu:
// bf16 operand tiles in shared memory filled by cp.async, and the tensor-core
// product mma.sync.m16n8k16 (bf16 operands, f32 accumulators) fed by
// ldmatrix, all as inline PTX.
//
// Shared-memory tiles: rows of D bf16 with kRowPad = 8 bf16 (16 bytes) of
// padding, so a row stride of 2 D + 16 bytes.  ldmatrix has 8 lanes give the
// addresses of 8 rows of 16 bytes each; with D a multiple of 16 the stride is
// an odd multiple of 16 bytes, so the 8 rows fall on the 8 different 16-byte
// bank groups and no read conflicts.
//
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4; each 32-bit register
// holds two bf16, the lower column in the lower half):
//   A (16 x 16, row-major)  a0: (g, 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   B (16 x 8, k x n)       b0: (k 2t..2t+1, n g)  b1: (k 2t+8..2t+9, n g)
//   C (16 x 8, f32)         c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..2t+1)
// Two C tiles side by side (columns 16kk .. 16kk+15) hold exactly the values
// of one A fragment of the next product: that is how a score tile becomes an
// operand without leaving the registers (a_from_c).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace mmda {
namespace flash {

constexpr int kRowPad = 8;   // bf16 of padding per shared-memory row
// exp(x) as exp2(x log2 e): the scores, bias and lse are carried in log2
// units, so each probability costs one fma and one ex2
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read) when
// !valid.  src must be a valid address either way.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every committed group of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows row0 .. row0 + R - 1 of the row-major (S, D) bf16 matrix src into dst
// (row stride D + kRowPad), by the block's NT threads; rows >= S are zero.
template <int R, int D, int NT>
__device__ __forceinline__ void async_tile(bf16* dst, const bf16* src, int row0, int S) {
  constexpr int kChunks = D / 8;   // 16-byte pieces of a row
  for (int i = threadIdx.x; i < R * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool valid = row0 + r < S;
    cp_async_16(dst + r * (D + kRowPad) + c, valid ? src + (size_t)(row0 + r) * D + c : src,
                valid);
  }
}

// Elements row0 .. row0 + R - 1 of the f32 vector src (length S) into dst;
// elements >= S are zero.
template <int R, int NT>
__device__ __forceinline__ void async_vec(float* dst, const float* src, int row0, int S) {
  for (int i = threadIdx.x; i < R; i += NT) {
    const bool valid = row0 + i < S;
    cp_async_4(dst + i, valid ? src + row0 + i : src, valid);
  }
}

// ldmatrix .x4: four 8 x 8 bf16 matrices, lane i giving the address of row
// i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b on the tensor cores: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of the 16 x 16 block at (row0, col0) of a row-major tile
// with row stride L bf16.  The same lane addresses, read transposed, give the
// B fragments of two n8 tiles (columns col0 .. col0 + 15) of a product whose
// k runs down the rows: r0, r1 for columns col0 .., r2, r3 for col0 + 8 ..
template <int L>
__device__ __forceinline__ uint32_t frag_addr_rows(const bf16* tile, int row0, int col0,
                                                   int lane) {
  return smem_u32(tile + (row0 + (lane & 15)) * L + col0 + ((lane >> 4) << 3));
}

// The B fragments of two n8 tiles (rows n0 .. n0 + 15 of a row-major tile
// whose rows are the product's n and columns its k) at k0 .. k0 + 15:
// {r0, r1} for n0 .., {r2, r3} for n0 + 8 ..
template <int L>
__device__ __forceinline__ uint32_t frag_addr_nk(const bf16* tile, int n0, int k0, int lane) {
  return smem_u32(tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * L + k0 +
                  (((lane >> 3) & 1) << 3));
}

// acc[j] (j = 0 .. N8 - 1) += A (16 x D, rows row0 .. of the row-major tile
// a_s) times the transpose of rows 0 .. 8 N8 - 1 of the row-major tile b_s:
// a 16 x 8 N8 block of A B^T (q k^T, k q^T, do v^T, v do^T).
template <int D, int N8>
__device__ __forceinline__ void mma_abt(float (&acc)[N8][4], const bf16* a_s, int row0,
                                        const bf16* b_s, int lane) {
  constexpr int L = D + kRowPad;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, frag_addr_rows<L>(a_s, row0, k0, lane));
#pragma unroll
    for (int j = 0; j < N8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, frag_addr_nk<L>(b_s, 8 * j, k0, lane));
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc[j] (j = 0 .. N8 - 1) += P B, P a 16 x 16 K16 operand held as A
// fragments p[kk] and B rows 0 .. 16 K16 - 1 of the row-major tile b_s, its
// columns col0 .. col0 + 8 N8 - 1 (pd^T do, ds^T q, ds k).
template <int D, int K16, int N8>
__device__ __forceinline__ void mma_pb(float (&acc)[N8][4], const uint32_t (&p)[K16][4],
                                       const bf16* b_s, int col0, int lane) {
  constexpr int L = D + kRowPad;
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
#pragma unroll
    for (int j = 0; j < N8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, frag_addr_rows<L>(b_s, 16 * kk, col0 + 8 * j, lane));
      mma_bf16(acc[j], p[kk], b[0], b[1]);
      mma_bf16(acc[j + 1], p[kk], b[2], b[3]);
    }
  }
}

// 2^x on the special-function unit alone (MUFU.EX2, subnormal results
// flushed to 0: a probability below 2^-126 adds nothing a bf16 gradient holds).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// C tiles 2kk and 2kk + 1 of a 16 x 16 K16 f32 block, rounded to bf16, as the
// A fragment of columns 16kk .. 16kk + 15.
template <int K16>
__device__ __forceinline__ void a_from_c(uint32_t (&a)[K16][4], const float (&c)[2 * K16][4]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Rows row0 + g and row0 + g + 8 of the accumulator block acc (16 x 8 N8,
// columns col0 ..) times `mul`, into the row-major (S, D) bf16 matrix dst;
// rows >= S are not written.
template <int D, int N8>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[N8][4], int row0,
                                          int col0, int S, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= S) continue;
    bf16* row = dst + (size_t)r * D + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < N8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
    }
  }
}

}  // namespace flash
}  // namespace mmda
