// Shared by flash_fwd.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu: the tile
// geometry, the attention kernels' position hash, and the f32 tile loads and
// register-tiled FMA products that the three kernels' f32 instantiations are
// made of (their bf16 instantiations run on the tensor cores, flash_mma.cuh).
//
// A block of 256 threads (16 x 16) owns a 64 x 64 tile of the score matrix;
// thread (ty, tx) holds the 4 x 4 scores at rows ty*4 + i and columns
// tx + 16*j.  Operand tiles lie in shared memory as f32, row-major with 4
// floats of padding per row.  All products are f32 FMAs in the kernels' own
// code (a TF32 tensor-core product would not meet the f32 tolerance).
//
//   nt_product     acc[i][j]  = sum_d A[ty*4+i][d] * B[tx+16j][d]     (q k^T, do v^T)
//   nn_accumulate  acc[i][jj] += sum_c P[ty*4+i][c] * B[c][col(jj)]   (p v, ds k, ...)
//
// Shared-memory banks: a row stride of D + 4 floats (D a multiple of 16) puts
// the 16-byte reads of 8 neighbouring tx on 8 different groups of 4 banks; the
// reads by ty are broadcasts; the stores of a score tile (stride 68) put the
// two ty of a warp on the two halves of the banks.

#pragma once

#include "hash_dropout.cuh"
#include "ln_dropout.cuh"

namespace mmda {
namespace flash {

constexpr int kTile = 64;            // rows and columns of a score tile
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 scores each
constexpr int kPad = 4;              // floats of padding per shared-memory row
constexpr int kLdp = kTile + kPad;   // row stride of a score tile in shared memory

// Floats of one (kTile, D) operand tile in shared memory.
template <int D>
__host__ __device__ constexpr int tile_floats() { return kTile * (D + kPad); }

// The attention kernels' position mix (attention.py::_keep_mask): row and col
// are absolute positions in the S x S matrix, base = seed * 40503 + bh * 51329
// with bh the flattened (batch, head) index; uint32 arithmetic wraps.
__device__ __forceinline__ uint32_t hash_base(const int* seed_ptr, int bh) {
  return (uint32_t)seed_ptr[0] * 40503u + (uint32_t)bh * 51329u;
}

// Which heads a launch holds: per batch item heads head0 .. head0 + local - 1
// of total (a rank's heads under tensor parallelism; {1, 1, 0} for all of
// them).  global_bh is the (batch, head) index the hash takes for the local
// index bh = b * local + h: b * total + head0 + h, bh itself at {1, 1, 0}.
struct HeadLayout {
  int local, total, head0;
};

__device__ __forceinline__ int global_bh(int bh, HeadLayout heads) {
  const int b = bh / heads.local;
  return b * heads.total + heads.head0 + (bh - b * heads.local);
}

inline bool valid_heads(int BH, int local, int total, int head0) {
  return local >= 1 && head0 >= 0 && head0 + local <= total && BH % local == 0 &&
         (long long)(BH / local) * total < (1LL << 31);
}

constexpr uint32_t kHashRow = 2654435761u;   // the row's and the column's
constexpr uint32_t kHashCol = 0x9E3779B9u;   // multipliers in the mix

__device__ __forceinline__ bool attn_keep(uint32_t base, uint32_t row,
                                          uint32_t col, float rate) {
  return hash_avalanche(row * kHashRow + col * kHashCol + base) >= rate;
}

// Rows row0 .. row0 + 63 of the row-major (S, D) matrix `src` into `dst`
// (stride D + kPad); rows >= S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int S) {
  constexpr int kVecs = D / 4;
  for (int g = threadIdx.x; g < kTile * kVecs; g += kThreads) {
    const int r = g / kVecs;
    const int c = (g % kVecs) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (row0 + r < S) {
      load_vec<4>(src + (size_t)(row0 + r) * D + c, v);
    }
    store_vec<4>(dst + r * (D + kPad) + c, v);
  }
}

// Elements row0 .. row0 + 63 of the vector `src` (length S) into dst[0..63];
// elements >= S are zero.
__device__ __forceinline__ void load_row_values(float* dst, const float* src,
                                                int row0, int S) {
  if (threadIdx.x < kTile) {
    const int r = row0 + threadIdx.x;
    dst[threadIdx.x] = r < S ? src[r] : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ void nt_product(const float* __restrict__ A,
                                           const float* __restrict__ B, int ty,
                                           int tx, float (&acc)[4][4]) {
  constexpr int L = D + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec<4>(A + (ty * 4 + i) * L + d, a[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) load_vec<4>(B + (tx + 16 * j) * L + d, b[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][e], b[j][e], acc[i][j]);
      }
    }
  }
}

// The thread's D / 16 output columns: 4 neighbouring ones per 64 (16-byte
// accesses) where it has a multiple of 4 of them, else tx + 16 jj.
template <int D>
__device__ __forceinline__ void nn_accumulate(const float* __restrict__ P,
                                              const float* __restrict__ B, int ty,
                                              int tx, float (&acc)[4][D / 16]) {
  constexpr int L = D + kPad;
  constexpr int DT = D / 16;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec<4>(P + (ty * 4 + i) * kLdp + c, p[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float b[DT];
      if constexpr (DT % 4 == 0) {
#pragma unroll
        for (int g = 0; g < DT / 4; ++g) {
          load_vec<4>(B + (c + e) * L + g * 64 + tx * 4, b + 4 * g);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < DT; ++jj) b[jj] = B[(c + e) * L + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < DT; ++jj) acc[i][jj] = fmaf(p[i][e], b[jj], acc[i][jj]);
      }
    }
  }
}

// acc (the thread's 4 rows x D / 16 columns) into rows row0 + ty*4 + i < S of
// the row-major (S, D) matrix `dst`.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, int row0, int S, int ty, int tx,
                                           const float (&acc)[4][D / 16]) {
  constexpr int DT = D / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= S) continue;
    float* row = dst + (size_t)r * D;
    if constexpr (DT % 4 == 0) {
#pragma unroll
      for (int g = 0; g < DT / 4; ++g) store_vec<4>(row + g * 64 + tx * 4, &acc[i][4 * g]);
    } else {
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) store_vec<1>(row + tx + 16 * jj, &acc[i][jj]);
    }
  }
}

// Maximum and sum over the 16 threads that share a score row (the 16 lanes of
// a half warp), the same value in each of them.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Picks the kernel for (type, D) and launches it: `Launch<T, D>::run(args...)`.
template <template <typename, int> class Launch, typename T, typename... Args>
cudaError_t dispatch_head_dim(int D, Args... args) {
  switch (D) {
    case 16: return Launch<T, 16>::run(args...);
    case 32: return Launch<T, 32>::run(args...);
    case 64: return Launch<T, 64>::run(args...);
    case 128: return Launch<T, 128>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace mmda
