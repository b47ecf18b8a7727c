// Hopper's warpgroup products and tensor-memory loads as inline PTX, for the
// tiled short attention kernels' bf16 instantiations (short_attn_tiled_fwd.cu,
// short_attn_tiled_bwd.cu), in the style of flash_mma.cuh.
//
// wgmma.mma_async m64nNk16 (bf16 operands, f32 accumulators): the 4 warps of a
// block (one warpgroup) own 64 rows, 16 a warp, and the accumulator of an
// m64nN product holds, in each warp, the C fragments of m16n8k16 for N / 8
// n8 tiles: d[j][e] is row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 (g
// = lane / 4, t = lane % 4), the layout the mma.sync kernels and
// short_tiled.cuh's row code already use.  An A operand from registers takes
// m16n8k16's A fragment of the warp's 16 rows (short_mma.cuh split3 terms).
//
// Shared-memory operands come from TMA (cp.async.bulk.tensor, mbarrier
// completion) in the 128-byte swizzle: a (rows x DP) bf16 tile is DP / 64
// boxes of (rows x 64), each row 128 bytes, 8 rows a 1024-byte swizzle atom,
// the boxes one after another, 1024-byte aligned.  Two descriptors read it:
//   K-major (q k^T's q and k, k q^T's k and q, do v^T, v do^T: the row is the
//   product's k): the k16 step kk starts 32 (kk % 4) bytes into box kk / 4;
//   8-row groups 1024 bytes apart (SBO).
//   MN-major (p v's v, ds k's k, pd^T do's do, ds^T q's q: the rows are the
//   product's k, the columns its n): the k16 step kk starts at row 16 kk;
//   8-row groups 1024 bytes apart (SBO), the next 64 columns one box on (LBO).
// The host encodes each (B nh, S, D) input as a 3-d tensor map (columns, rows,
// batch item x head) whose boxes past S and D read zeros.  It needs D a
// multiple of 8 (a row a multiple of 16 bytes) and a 16-byte aligned base.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums; nothing links against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "flash_mma.cuh"

namespace mmda {
namespace wgmma {

using flash::bf16;
using flash::smem_u32;

constexpr int kBoxCols = 64;     // bf16 columns of a TMA box: 128 bytes, one swizzle row
constexpr int kSmemAlign = 1024;

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no libcuda link).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Whether the (B nh, S, D) bf16 tensor at ptr can be a tensor map.
inline bool takes(const void* ptr, int D) {
  return D % 8 == 0 && (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// The (BH, S, D) bf16 tensor at ptr as boxes of (rows x 64 columns), 128-byte
// swizzle, zeros read past S and D.  False where the driver refuses it.
inline bool head_map(CUtensorMap* map, const void* ptr, int BH, int S, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(bf16), (cuuint64_t)S * D * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------- device

// The dynamic shared memory's first 1024-byte boundary (the launch asks for
// kSmemAlign bytes more than the kernel uses).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((kSmemAlign - (a & (kSmemAlign - 1))) & (kSmemAlign - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// After the barriers' init, before any thread or TMA uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival, with `bytes` more to come from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Until the barrier's phase of this parity has completed.  A load that never
// lands (a tensor map the copy cannot serve) traps after 2^24 polls: the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n) {
    if (n == (1u << 24)) __trap();
  }
}

// The box at (column c, row r, batch item x head bh) of map into dst,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int r, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r), "r"(bh)
      : "memory");
}

// The rows (0 .. rows - 1) x (0 .. DP - 1) tile at dst from map, DP / 64
// boxes, completing on bar (one thread issues).
template <int DP>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int rows, int r0, int bh) {
#pragma unroll
  for (int c = 0; c < DP / kBoxCols; ++c) {
    tma_load(dst + c * rows * kBoxCols, map, bar, c * kBoxCols, r0, bh);
  }
}

// A shared-memory matrix descriptor, 128-byte swizzle; lbo and sbo in bytes.
__device__ __forceinline__ uint64_t desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The k16 step kk of a (rows x DP) tile read K-major, and read MN-major.
__device__ __forceinline__ uint64_t k_major(const bf16* tile, int rows, int kk) {
  return desc(tile + (kk >> 2) * rows * kBoxCols + (kk & 3) * 16, 16, 1024);
}

__device__ __forceinline__ uint64_t mn_major(const bf16* tile, int rows, int kk) {
  return desc(tile + kk * 16 * kBoxCols, rows * kBoxCols * sizeof(bf16), 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator across a product
// in flight.
template <int N8>
__device__ __forceinline__ void fence_operand(float (&d)[N8][4]) {
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

// d (64 x 32) = A B^T + (accumulate ? d : 0): A (64 x 16) and B (32 x 16)
// both K-major in shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (64 x 64) = A B^T + (accumulate ? d : 0): A (64 x 16) and B (64 x 16)
// both K-major in shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (64 x 64) += A B: A (64 x 16) from registers (each warp's m16n8k16 A
// fragment of its 16 rows), B (16 x 64) MN-major in shared memory (db).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 128) += A B: A (64 x 16) from registers (each warp's m16n8k16 A
// fragment of its 16 rows), B (16 x 128) MN-major in shared memory (db).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]),
        "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]),
        "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]),
        "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]),
        "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x N) = A B^T over DP: A the (64 x DP) tile a_s, B the (N x DP) tile
// b_s, both K-major (q k^T, do v^T, k q^T, v do^T); d's old values are not
// read (the first k16 step does not accumulate).  Issued, not waited for.
template <int N, int DP>
__device__ __forceinline__ void issue_abt(float (&d)[N / 8][4], const bf16* a_s,
                                          const bf16* b_s) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if constexpr (N == 64) {
      wgmma_ss_n64(d, k_major(a_s, 64, kk), k_major(b_s, N, kk), kk > 0);
    } else {
      static_assert(N == 32, "score tiles of 32 or 64 columns");
      wgmma_ss_n32(d, k_major(a_s, 64, kk), k_major(b_s, N, kk), kk > 0);
    }
  }
}

// acc (64 x DP) += (x as its three bf16 terms a) B: B the (K x DP) tile b_s
// read MN-major (p v, ds k, pd^T do, ds^T q); issued, not waited for.
template <int DP, int K>
__device__ __forceinline__ void issue_split_product(float (&acc)[DP / 8][4],
                                                    const uint32_t (&a)[3][K / 16][4],
                                                    const bf16* b_s) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      if constexpr (DP == 64) {
        wgmma_rs_n64(acc, a[t][kk], mn_major(b_s, K, kk));
      } else {
        static_assert(DP == 128, "head dims padded to 64 or 128");
        wgmma_rs_n128(acc, a[t][kk], mn_major(b_s, K, kk));
      }
    }
  }
}

}  // namespace wgmma
}  // namespace mmda
