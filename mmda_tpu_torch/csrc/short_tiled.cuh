// Shared by short_attn_tiled_fwd.cu and short_attn_tiled_bwd.cu: the short
// attention kernels' arithmetic (short_attn_fwd.cu, short_attn_bwd.cu) over
// tiles of queries and keys, for sequences longer than one block holds.
//
// Tiles.  A bf16 block has kTileWarps = 4 warps (one warpgroup) and owns 64
// rows (queries in the forward and the dq kernel, keys in the dk/dv kernel),
// 16 a warp; it streams the other side in tiles of NB rows (64; 32 where
// two DP = 128 accumulators must stay in registers).  The mma.sync kernels
// pad the head dim D with zero columns to DP in {16, 32, 64, 128} and fill
// two buffers in turn by cp.async; the wgmma kernels (wgmma.cuh) take DP in
// {64, 128}, their TMA boxes reading zeros past D and S.  A zero column adds
// an exact 0 to every product.  Both keep a product's f32 result in the
// fragments of m16n8k16 (a wgmma accumulator is four warps' worth of them),
// so the row code below serves both.  The f32 kernels on the tensor cores
// take the same blocks and fragments (the f32 section at the end); the f32
// FMA kernels' block has kF32Warps = 8 warps and owns 32 rows, 4 a warp; it
// streams tiles of 32 rows, one a lane.
//
// The forward's softmax is online (OnlineRows): the row max m and the sum l
// rescaled by exp(m_old - m_new) when a tile raises the max, the accumulator
// with them; o = acc (1 / l) keep_scale at the end.  The backward takes p =
// exp(s - m) (1 / l) from the forward's saved (m, l).  The keep mask is the
// short kernels' own hash at i S + j with S the full length (KeepMask).
//
// What bounds the kernels: the products and the per-score work (an exp, a
// hash, a three-way split); not the bytes.

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

// The short kernels' keep mask of one (batch item, head): query i keeps key j
// where the hash at i S + j (uint32, S the full length) clears the rate;
// always at rate 0.
struct KeepMask {
  bool drop;
  uint32_t hbase;
  int S;
  float rate;

  __device__ __forceinline__ KeepMask(const int* seed_ptr, int b, int h, int S_, float rate_)
      : drop(rate_ > 0.0f),
        hbase(rate_ > 0.0f ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u),
        S(S_),
        rate(rate_) {}

  __device__ __forceinline__ bool operator()(int i, int j) const {
    return !drop || mmda::short_attn_keep(hbase, (uint32_t)i * (uint32_t)S + (uint32_t)j, rate);
  }
};

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

// Rows row0 + g, row0 + g + 8 (< S) of the accumulator block acc (16 x DP),
// columns < D, into the row-major (S, D) f32 matrix dst.
template <int DP>
__device__ __forceinline__ void store_rows_f32(float* dst, const float (&acc)[DP / 8][4],
                                               int row0, int S, int D, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= S) continue;
    float* row = dst + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + t2;
      if ((D & 1) == 0 && c + 1 < D) {
        *reinterpret_cast<float2*>(row + c) = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      } else {
        if (c < D) row[c] = acc[j][2 * half];
        if (c + 1 < D) row[c + 1] = acc[j][2 * half + 1];
      }
    }
  }
}

// exp(x - m) as 2^(x log2 e - m log2 e) on the special-function unit
// (ex2.approx, subnormal results flushed to 0), mlog2e = m log2 e.  x log2 e
// is rounded as m log2 e was, so x = m gives exactly 2^0 at any magnitude (a
// row whose keys are all masked: every score -1e9); for the scores' range
// the roundings stay within a few f32 ulps of expf, far inside the one-ulp
// bf16 gate.  The f32 kernels keep expf.
__device__ __forceinline__ float log2e_units(float x) {
  return __fmul_rn(x, mmda::flash::kLog2e);
}

__device__ __forceinline__ float exp_minus(float x, float mlog2e) {
  return mmda::flash::exp2_ftz(__fsub_rn(log2e_units(x), mlog2e));
}

// s = s * scale + bias, in that order, rounded each time (the plain
// version's (q k^T) scale + bias): the 16 x 8 N8 score block in C fragments
// of the key columns 8 j + t2 (+ 1) of bias_t (-inf beyond S).
template <int N8>
__device__ __forceinline__ void scale_bias(float (&s)[N8][4], float scale, const float* bias_t,
                                           int t2) {
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bias_t[8 * j + t2 + (e & 1)]);
    }
  }
}

// One warp's 16 query rows of the one-pass forward: the online row max m and
// sum l of exp(s - m) over the key tiles seen so far (the lane's share of l;
// its quad holds the row), and the f32 accumulator of (exp(s - m) times the
// 0/1 mask) v, 16 x DP in C fragments.  Rows i0 = row0 + g and i0 + 8.
template <int DP>
struct OnlineRows {
  float acc[DP / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ OnlineRows() {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
  }

  // A key tile's scores s (keys c0 + 8 j + (e & 1), -inf beyond S): raises m
  // where the tile holds a larger score and rescales l and acc by exp(m_old -
  // m_new) (0 on the first tile: m_old = -inf); then s <- exp(s - m) where
  // keep(i, j), 0 where dropped, and l += exp(s - m) whether kept or not.
  // The first tile holds key 0, so m is finite from then on.
  template <int N8, class Keep>
  __device__ __forceinline__ void update(float (&s)[N8][4], const Keep& keep, int i0, int c0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < N8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      const float m_new = fmaxf(m[hh], quad_max(tmax));
      const float alpha = exp_minus(m[hh], log2e_units(m_new));
      l[hh] *= alpha;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[j][2 * hh] *= alpha;
        acc[j][2 * hh + 1] *= alpha;
      }
      m[hh] = m_new;
    }
    const float ml[2] = {log2e_units(m[0]), log2e_units(m[1])};
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = exp_minus(s[j][e], ml[e >> 1]);
        l[e >> 1] += x;
        s[j][e] = keep(i0 + 8 * (e >> 1), c0 + 8 * j + (e & 1)) ? x : 0.0f;
      }
    }
  }

  // update() in the f32 kernels' arithmetic: expf(s - m) and expf(m_old -
  // m_new), as the plain version's exp (s here already holds the bias).
  template <int N8, class Keep>
  __device__ __forceinline__ void update_f32(float (&s)[N8][4], const Keep& keep, int i0,
                                             int c0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < N8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      const float m_new = fmaxf(m[hh], quad_max(tmax));
      const float alpha = expf(m[hh] - m_new);
      l[hh] *= alpha;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[j][2 * hh] *= alpha;
        acc[j][2 * hh + 1] *= alpha;
      }
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += x;
        s[j][e] = keep(i0 + 8 * (e >> 1), c0 + 8 * j + (e & 1)) ? x : 0.0f;
      }
    }
  }

  // o = acc (1 / l) keep_scale rounded once to bf16, rows r0 + g (+ 8) < S
  // of the row-major (S, D) o; where given, the same f32 values into o32 and
  // (m, l) into stats[(row_base + row) 2 ..].  An f32 o takes the f32 values
  // (o32 is o).
  template <typename T>
  __device__ __forceinline__ void finish(T* o, float* stats, float* o32, size_t row_base,
                                         int r0, int S, int D, float keep_scale, int lane) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = quad_sum(l[hh]);
      const float f = (1.0f / l[hh]) * keep_scale;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[j][2 * hh] *= f;
        acc[j][2 * hh + 1] *= f;
      }
      const int r = r0 + g + 8 * hh;
      if (stats != nullptr && t2 == 0 && r < S) {
        *reinterpret_cast<float2*>(stats + (row_base + r) * 2) = make_float2(m[hh], l[hh]);
      }
    }
    if constexpr (sizeof(T) == sizeof(float)) {
      store_rows_f32<DP>(o, acc, r0, S, D, lane);
    } else {
      store_rows<DP>(o, acc, r0, S, D, 1.0f, lane);
      if (o32 != nullptr) store_rows_f32<DP>(o32, acc, r0, S, D, lane);
    }
  }
};

// The dq kernel's tile: s (the scores of rows i0 and i0 + 8 after
// scale_bias, keys c0 + 8 j + (e & 1), -inf beyond S) becomes ds = p (dp keep
// - r) with p = exp(s - m) (1 / l) from the saved statistics (m, 1 / l, r of
// the two rows; 0, 0, 0 beyond S), dp = do v^T as the product gave it and
// keep(i, j) the mask.
template <int N8, class Keep>
__device__ __forceinline__ void ds_of(float (&s)[N8][4], const float (&dp)[N8][4],
                                      const float (&m)[2], const float (&il)[2],
                                      const float (&rr)[2], const Keep& keep, int i0, int c0,
                                      float keep_scale) {
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      const float p = exp_minus(s[j][e], log2e_units(m[hh])) * il[hh];
      const float kp = keep(i0 + 8 * hh, c0 + 8 * j + (e & 1)) ? keep_scale : 0.0f;
      s[j][e] = p * (dp[j][e] * kp - rr[hh]);
    }
  }
}

// The dk/dv kernel's tile, transposed: sT = k q^T and dpT = v do^T as the
// products gave them, keys j0 and j0 + 8 (their bias kbl), queries i_base +
// ii with ii = 8 j + t2 + (e & 1) and st their staged (m log2 e, 1 / l, r).
// Becomes sT <- pd = p keep, dpT <- ds = p (dp keep - r), p = 0 beyond S
// (keep(i, j) the mask, keep_scale where kept).  The score goes to log2 units
// in one fma, scale_l = scale log2 e and kbl = bias log2 e: fewer registers
// and instructions than rounding s, then s log2 e, which made this kernel
// markedly slower (PERF.md).  That fma rounds once where the forward rounds
// s scale + bias, then its log2 e: at a row max near the mask's -1e9 (an
// item whose keys are all masked, kMaskedRowMax) one f32 ulp there is 64, so
// the two forms part by whole powers of 2 once the unbiased scores reach 32
// in magnitude.  Such an item (Rounded, decided per block by the caller)
// takes the forward's rounded form, the key bias bias_b[j] read where used.
template <int N8, bool Rounded, class Keep>
__device__ __forceinline__ void pd_ds_of(float (&sT)[N8][4], float (&dpT)[N8][4],
                                         const float* st, const float (&kbl)[2], float scale_l,
                                         float scale, const float* bias_b, const Keep& keep,
                                         int i_base, int t2, int j0, int S, float keep_scale) {
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = 8 * j + t2 + (e & 1), i = i_base + ii;
      const int jk = j0 + 8 * (e >> 1);
      float p = 0.0f;
      if (i < S) {
        const float t =
            !Rounded ? fmaf(sT[j][e], scale_l, kbl[e >> 1])
            : jk < S ? log2e_units(__fadd_rn(__fmul_rn(sT[j][e], scale), bias_b[jk]))
                     : -INFINITY;
        p = mmda::flash::exp2_ftz(__fsub_rn(t, st[3 * ii])) * st[3 * ii + 1];
      }
      const float kp = keep(i, jk) ? keep_scale : 0.0f;
      sT[j][e] = p * kp;
      dpT[j][e] = p * (dpT[j][e] * kp - st[3 * ii + 2]);
    }
  }
}

// A row max below this is that of a batch item whose keys are all masked
// (its scores sit at the mask's -1e9); a row of real keys never comes near.
constexpr float kMaskedRowMax = -1024.0f;

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

// ------------------------------------------------- f32 on the tensor cores
//
// The f32 kernels' tensor-core design (short_attn_tiled_fwd.cu,
// short_attn_tiled_bwd.cu): every f32 operand tile is read into registers
// and split into three bf16 term tiles in shared memory (split_rows) that
// wgmma reads; each product is six term products (wgmma.cuh
// issue_terms_*).  The score code takes the plain version's order: s =
// (q scale) k^T, then + bias, expf.
//
// The tensor cores truncate their f32 sums: each k16 step aligns its
// products and the accumulator to the largest and drops the bits below
// the f32 width, so a sum of many steps loses about an ulp of the
// accumulator a step, always toward zero.  For the scores, whose error p =
// exp(s - m) carries into every output and whose size grows with the
// softmax's peak, q scale and k are split on a grid: a row's hi terms are
// its values rounded to multiples of 2^(e - 7), e the exponent of the
// row's largest |x| (each at most 256 of them, so a bf16), mid and lo the
// rest as split3 takes it.  A product hi_q hi_k is then an integer of at
// most 2^16 units of the two rows' grids, a sum over 128 columns at most
// 2^23: every sum of hi hi products is exact in f32 in any order, and so
// in the tensor cores' truncating sums while they keep f32's 24 bits.  It
// takes its own accumulator
// (wgmma::issue_scores); the five smaller pairs, 2^-8 of it and less, lose
// what truncation takes of their own sum only.  What the grid costs: a
// value far below its row's largest keeps hi's bits on the row's grid and
// 16-17 more, so each term error is at most 2^-26 of the row's largest
// |x| (split3's is 2^-25 of the value itself).  v and do keep split3.

constexpr int kF32StreamRows = 32;   // the streamed tile of the dq and dk/dv kernels

// Whether a pointer takes 16-byte loads.
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 1.5 2^(e + 16), e the exponent of row_max (clamped to [-100, 111]): x +
// it - it rounds x (|x| < 2^(e + 1)) to a multiple of 2^(e - 7).
__device__ __forceinline__ float grid_magic(float row_max) {
  const int e = min(max((int)((__float_as_uint(row_max) >> 23) & 0xff) - 127, -100), 111);
  return __uint_as_float(((uint32_t)(e + 16 + 127) << 23) | (1u << 22));
}

// Eight f32 values y of row r, columns 8 c .. 8 c + 7, as their three bf16
// terms into the tiles dst + t term (t = 0 hi, 1 mid, 2 lo) of R rows in
// wgmma.cuh's layout, as TMA would write them: DP / 64 boxes of (R x 64), a
// row 128 bytes, its 16-byte piece c at c ^ (r % 8).  With Grid, hi is y
// on the row's grid (magic = grid_magic of the row's largest |y|) and mid,
// lo the rest as short_mma::split3 takes it; else split3.  A product reads
// the tiles through the async proxy: the caller fences
// (wgmma::fence_proxy_async) before the barrier.
template <bool Grid>
__device__ __forceinline__ void store_terms(bf16* dst, int term, int R, int r, int c,
                                            const float (&y)[8], float magic) {
  uint32_t hi[4], mid[4], lo[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if constexpr (Grid) {
      const float y0 = y[2 * u], y1 = y[2 * u + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(__fsub_rn(__fadd_rn(y0, magic), magic),
                                                     __fsub_rn(__fadd_rn(y1, magic), magic));
      const float r0 = __fsub_rn(y0, __low2float(h)), r1 = __fsub_rn(y1, __high2float(h));
      const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
      const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(r0, __low2float(m)),
                                                     __fsub_rn(r1, __high2float(m)));
      hi[u] = *reinterpret_cast<const uint32_t*>(&h);
      mid[u] = *reinterpret_cast<const uint32_t*>(&m);
      lo[u] = *reinterpret_cast<const uint32_t*>(&l);
    } else {
      short_mma::split3(y[2 * u], y[2 * u + 1], hi[u], mid[u], lo[u]);
    }
  }
  const int at = (c >> 3) * R * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
  *reinterpret_cast<uint4*>(dst + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + term + at) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
  *reinterpret_cast<uint4*>(dst + 2 * term + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Rows r0 .. r0 + R - 1 of the row-major (S, D) f32 matrix src, times mul
// (rounded, as the plain version's q * scale), as their three bf16 term
// tiles at dst (store_terms; with Grid on each row's grid), zero beyond S
// and D, read from global memory into registers (16 bytes a load where
// vec: D a multiple of 4 and src 16-byte aligned), all of a thread's loads
// ahead of its stores; by the kTileThreads threads of one warpgroup, tid
// the thread's index in it.  A row's DP / 8 pieces lie in as many
// neighbouring lanes of one warp.
template <int DP, int R, bool Grid>
__device__ __forceinline__ void split_rows(bf16* dst, int term, const float* src, int r0, int S,
                                           int D, bool vec, float mul, int tid) {
  constexpr int C8 = DP / 8, N = R * C8 / kTileThreads;
  static_assert(R * C8 % kTileThreads == 0 && 32 % C8 == 0, "whole rows a warp");
  const int valid = min(R, S - r0);
  const float* rows = src + (size_t)r0 * D;
  float x[N][8];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = tid + n * kTileThreads;
    const int r = i / C8, col = 8 * (i - r * C8);
    const float* p = rows + (size_t)r * D + col;
    if (vec) {
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
      if (r < valid && col < D) a = *reinterpret_cast<const float4*>(p);
      if (r < valid && col + 4 < D) b = *reinterpret_cast<const float4*>(p + 4);
      x[n][0] = a.x, x[n][1] = a.y, x[n][2] = a.z, x[n][3] = a.w;
      x[n][4] = b.x, x[n][5] = b.y, x[n][6] = b.z, x[n][7] = b.w;
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) x[n][u] = r < valid && col + u < D ? p[u] : 0.0f;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = tid + n * kTileThreads;
    const int r = i / C8;
    float big = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[n][u] = __fmul_rn(x[n][u], mul);
      big = fmaxf(big, fabsf(x[n][u]));
    }
    float magic = 0.0f;
    if constexpr (Grid) {
#pragma unroll
      for (int w = 1; w < C8; w <<= 1) big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, w));
      magic = grid_magic(big);
    }
    store_terms<Grid>(dst, term, R, r, i - r * C8, x[n], magic);
  }
}

// split_rows by the block's own kTileThreads threads.
template <int DP, int R, bool Grid>
__device__ __forceinline__ void split_rows(bf16* dst, int term, const float* src, int r0, int S,
                                           int D, bool vec, float mul) {
  split_rows<DP, R, Grid>(dst, term, src, r0, S, D, vec, mul, (int)threadIdx.x);
}

// Rows r0 + g, r0 + g + 8 (< S) of the 64-column block part (a product's
// columns c0 .. c0 + 63, < D), times mul, into the row-major (S, D) f32
// matrix dst.
__device__ __forceinline__ void store_cols_f32(float* dst, const float (&part)[8][4], int r0,
                                               int c0, int S, int D, float mul, int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= S) continue;
    float* row = dst + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * j + t2;
      const float x0 = part[j][2 * half] * mul, x1 = part[j][2 * half + 1] * mul;
      if ((D & 1) == 0 && c + 1 < D) {
        *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
      } else {
        if (c < D) row[c] = x0;
        if (c + 1 < D) row[c + 1] = x1;
      }
    }
  }
}

// s += bias of the key columns 8 j + t2 (+ 1) of bias_t (-inf beyond S): the
// f32 scores, (q scale) k^T + bias.
template <int N8>
__device__ __forceinline__ void add_bias(float (&s)[N8][4], const float* bias_t, int t2) {
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fadd_rn(s[j][e], bias_t[8 * j + t2 + (e & 1)]);
  }
}

// ds_of in the f32 kernels' arithmetic: s (after add_bias) becomes ds = p
// (dp keep - r), p = expf(s - m) (1 / l); keys beyond S have s = -inf, p = 0.
template <int N8, class Keep>
__device__ __forceinline__ void ds_of_f32(float (&s)[N8][4], const float (&dp)[N8][4],
                                          const float (&m)[2], const float (&il)[2],
                                          const float (&rr)[2], const Keep& keep, int i0,
                                          int c0, float keep_scale) {
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      const float p = expf(s[j][e] - m[hh]) * il[hh];
      const float kp = keep(i0 + 8 * hh, c0 + 8 * j + (e & 1)) ? keep_scale : 0.0f;
      s[j][e] = p * (dp[j][e] * kp - rr[hh]);
    }
  }
}

// pd_ds_of in the f32 kernels' arithmetic: sT = k (q scale)^T and dpT = v
// do^T as the products gave them, keys j0 and j0 + 8 (their bias kb, -inf
// beyond S), queries i_base + ii with ii = 8 j + t2 + (e & 1) and st their
// staged (m, 1 / l, r).  Becomes sT <- pd = p keep, dpT <- ds = p (dp keep
// - r), p = expf(s + bias - m) (1 / l), 0 for queries beyond S.
template <int N8, class Keep>
__device__ __forceinline__ void pd_ds_of_f32(float (&sT)[N8][4], float (&dpT)[N8][4],
                                             const float* st, const float (&kb)[2],
                                             const Keep& keep, int i_base, int t2, int j0,
                                             int S, float keep_scale) {
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = 8 * j + t2 + (e & 1), i = i_base + ii;
      const int jk = j0 + 8 * (e >> 1);
      const float p =
          i < S ? expf(__fadd_rn(sT[j][e], kb[e >> 1]) - st[3 * ii]) * st[3 * ii + 1] : 0.0f;
      const float kp = keep(i, jk) ? keep_scale : 0.0f;
      sT[j][e] = p * kp;
      dpT[j][e] = p * (dpT[j][e] * kp - st[3 * ii + 2]);
    }
  }
}

}  // namespace short_tiled
}  // namespace mmda
