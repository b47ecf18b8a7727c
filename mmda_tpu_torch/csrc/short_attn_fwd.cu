// Short-sequence multi-head attention forward for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/short_attention.py::_fwd_kernel (:61,
// launched by _fwd_call :128), which holds one batch item's attention for
// all heads in VMEM.  Per (batch item b, head h), all f32:
//
//   s  = (q k^T) * scale + bias[b]         scale = f32(1 / sqrt(D))
//   p  = exp(s - rowmax(s)) / rowsum(...)  (the exact softmax, no online one)
//   p  = p * keep * f32(1 / (1 - rate))    keep from the positional hash
//   o  = round(p v)                        once, to the input type
//
// q, k, v, o (B, nh, S, D) f32 or bf16 (widened to f32 on the way in, which
// is exact); bias (B, S) f32 additive on keys.  The keep mask is the short
// kernels' own mix of hash_dropout.cuh (r * S + c + seed * 2654435761 +
// b * 40503 + h * 51329); rate == 0 skips it (seed may be null).  Nothing is
// rounded to the operand type in between, unlike the flash kernels.
//
// What bounds it on the H100.  At the flagship shape (64, 12, 50, 64) bf16
// the call moves 19.7 MB (5.9 us at 3.35 TB/s) and does 4 B nh S^2 D =
// 4.9e8 operations (0.5 us at the 989 TFLOP/s bf16 tensor-core peak):
// bytes.  In f32 the bytes double (11.7 us) and the operations take six
// bf16 term products each (3.0 us at a sixth of the peak): bytes still.
// The S x S products are tiny (50 x 50 x 64), so the latency of loading
// one head's q, k and v and the element work of the softmax and the hash
// (in f32 also a three-way split of every operand and of pd) are what a
// block waits on; several blocks an SM fill the gaps.
//
// The TPU kernel loops over the heads of one batch item in one program, so
// Mosaic can overlap one head's softmax with the next head's matmul.  Here
// one block per (b, h) (768 blocks at the flagship shape, several per SM)
// does the same through the scheduler.
//
// bf16 (short_attn_fwd_mma_kernel<SP>): the products on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators; flash_mma.cuh), with
// the arithmetic of short_attn_bwd.cu's bf16 kernel (short_mma.cuh).  S is
// padded to SP, a multiple of 16 (the template argument), and D to DP, a
// multiple of 16, with zero fill; SP / 16 warps, warp w owning queries
// 16 w .. 16 w + 15.  q, k and v go into shared memory as bf16 (16-byte
// cp.async where D % 8 == 0), the q fragments by ldmatrix.
//   * s = q k^T straight from the bf16 inputs (exact products, f32 sums),
//     then times scale and plus the bias in f32 (scale after the product:
//     q * scale is not a bf16 value at D = 32 or 128); keys at or beyond S
//     have bias -inf.
//   * The exact softmax over the whole row in f32 on the accumulator
//     fragments: the row max and sum by quad shuffles, expf and IEEE
//     division; the keep hash at (i S + j) on the fragments.
//   * o = pd v with pd as three bf16 terms (hi, mid, lo: all its 24 bits),
//     three mma per k-step with v's fragments by ldmatrix.trans; o rounded
//     once to bf16.
// f32, on the tensor cores (short_attn_fwd_f32_wgmma_kernel<DP, NW>,
// design 0): the arithmetic of short_attn_tiled_fwd.cu's f32 kernel on a
// block that holds all S keys, so the softmax is the exact one.  q * scale,
// k and v each as three bf16 terms hi, mid, lo (q * scale and k on each
// row's grid, short_tiled.cuh, so that the scores' hi hi sums are exact in
// the tensor cores' truncating f32 and take their own accumulator; v by
// split3), every product six bf16 term products on wgmma (hi hi, hi mid, mid
// hi, hi lo, lo hi, mid mid; wgmma.cuh), each one fresh f32 sum over all S.
// wgmma and not mma.sync: S <= 128 is one or two 64-query warpgroup tiles,
// and the f32 tiled kernels' device functions (split_rows, issue_scores,
// issue_terms_product) then serve as they are, the scores the same bits in
// the forward and in both passes of the backward.  A block of NW = ceil(S /
// 64) warpgroups per (b, h); D zero-padded to DP = 64 or 128, S to 64 NW
// (padded keys have bias -inf; padded rows are never stored); three blocks
// an SM at S, D <= 64.  Steps (the kernel's note below).  expf and IEEE
// division, as the plain version.  Every S <= 128, every D <= 128.
// f32 FMAs (short_attn_fwd_f32_kernel, design 1, kept for comparison):
//   * k (row stride D + 1, so the lanes' reads of 32 keys fall in 32 banks)
//     and v are staged in shared memory as f32;
//   * a warp owns a query row: its lanes hold the row's scores, at most 4
//     keys each (S <= 128), so the row max, the exponentials and the row sum
//     are register work and two warp reductions; the probabilities go
//     through a per-warp row of shared memory to the product with v, where
//     the lanes own output columns (at most 4 each, D <= 128).  One 4-byte
//     shared load an FMA: the loads, not the FMAs, bound it.
// The whole (b, h) sits in one block, so the kernels take S <= 128; longer
// sequences go to short_attn_tiled_fwd.cu, which tiles the queries and
// streams the keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"
#include "hash_dropout.cuh"
#include "short_mma.cuh"
#include "short_tiled.cuh"
#include "wgmma.cuh"

namespace {

using mmda::flash::bf16;
using mmda::flash::frag_addr_nk;
using mmda::flash::frag_addr_rows;
using mmda::flash::kRowPad;
using mmda::flash::ldmatrix_x4;
using mmda::flash::mma_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxS = 128;                 // keys of a row: 4 per lane
constexpr int kMaxD = 128;                 // columns of a row: 4 per lane
constexpr int kKeysPerLane = kMaxS / 32;

// ------------------------------------------------------------------ f32

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

size_t smem_bytes(int S, int D) {
  return ((size_t)S * (D + 1) + (size_t)S * D + (size_t)kWarps * (D + S)) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
short_attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const int* __restrict__ seed_ptr, float* __restrict__ o, int nh,
                          int S, int D, float scale, float rate, float keep_scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;                      // (S, D + 1)
  float* v_s = k_s + S * ld;              // (S, D)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* q_row = v_s + S * D + warp * (D + S);   // this warp's q row (D) ...
  float* p_row = q_row + D;                      // ... and probability row (S)

  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  for (int e = threadIdx.x; e < S * D; e += kThreads) {
    const int r = e / D;
    k_s[r * ld + (e - r * D)] = k[base + e];
    v_s[e] = v[base + e];
  }
  __syncthreads();

  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;
  const float* bias_b = bias + (size_t)b * S;
  for (int i = warp; i < S; i += kWarps) {
    for (int c = lane; c < D; c += 32) q_row[c] = q[base + (size_t)i * D + c] * scale;
    __syncwarp();
    float s[kKeysPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < S) {
        const float* kj = k_s + j * ld;
        float acc = 0.0f;
        for (int c = 0; c < D; ++c) acc = fmaf(q_row[c], kj[c], acc);
        s[t] = acc + bias_b[j];
        m = fmaxf(m, s[t]);
      }
    }
    m = warp_max(m);
    float l = 0.0f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      s[t] = lane + 32 * t < S ? expf(s[t] - m) : 0.0f;
      l += s[t];
    }
    l = warp_sum(l);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < S) {
        float p = s[t] / l;
        if (drop) {
          p = mmda::short_attn_keep(hbase, (uint32_t)(i * S + j), rate) ? p * keep_scale : 0.0f;
        }
        p_row[j] = p;
      }
    }
    __syncwarp();
    for (int c = lane; c < D; c += 32) {
      float acc = 0.0f;
      for (int j = 0; j < S; ++j) acc = fmaf(p_row[j], v_s[j * D + c], acc);
      o[base + (size_t)i * D + c] = acc;
    }
    __syncwarp();   // the next row overwrites q_row and p_row
  }
}

// f32 on the tensor cores (design 0): a block of NW = ceil(S / 64)
// warpgroups per (b, h), warpgroup w owning queries 64 w .. 64 w + 63.  The
// operands go into shared memory as three bf16 term tiles each, 64 rows a
// tile, in wgmma.cuh's layout (short_tiled.cuh split_rows: q * scale and k on
// each row's grid, v by split3), each warpgroup splitting its own rows; every
// product is six term products (wgmma.cuh), summed in one fresh f32
// accumulator over all S keys.
//   1. q * scale and k are split, the key bias staged; s = (q scale) k^T
//      against every 64-key tile (wgmma::issue_scores: the hi hi sum in its
//      own accumulator), + bias.
//   2. v's terms replace q's (q is not read again) while the exact softmax
//      runs on the accumulator fragments: the row max and sum by quad
//      shuffles, expf and IEEE division, then the keep hash at i S + j; pd is
//      split into its terms in registers (the A operand).
//   3. o = pd v, 64 output columns at a time, written once.
// Two term slots of NW 64-row tiles: 48 KB at S, D <= 64, four blocks an SM.
// A slot for each operand (72 KB, three blocks an SM) was slower at every
// shape timed (PERF.md): the blocks beside it hide v's later split.
template <int DP, int NW>
__host__ __device__ constexpr size_t f32_wgmma_smem_bytes() {
  // q's terms, then v's; k's terms; the key bias
  return (size_t)2 * 3 * NW * mmda::short_tiled::kTileRows * DP * sizeof(bf16) +
         NW * mmda::short_tiled::kTileRows * sizeof(float) + mmda::wgmma::kSmemAlign;
}

// The blocks an SM holds by their shared memory (228 KB an SM, 1 KB of it
// reserved a block), at most 4: the kernel's launch bound.
template <int DP, int NW>
__host__ __device__ constexpr int f32_min_blocks() {
  return 233472 / (f32_wgmma_smem_bytes<DP, NW>() + 1024) < 4
             ? 233472 / (f32_wgmma_smem_bytes<DP, NW>() + 1024)
             : 4;
}

template <int DP, int NW>
__global__ void __launch_bounds__(NW * mmda::short_tiled::kTileThreads,
                                  f32_min_blocks<DP, NW>())
short_attn_fwd_f32_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ bias,
                                const int* __restrict__ seed_ptr, float* __restrict__ o, int nh,
                                int S, int D, float scale, float rate, float keep_scale,
                                int vec) {
  namespace wg = mmda::wgmma;
  namespace st = mmda::short_tiled;
  constexpr int R = st::kTileRows, N8 = R / 8;
  constexpr int T = R * DP;                  // elements of one 64-row term tile
  extern __shared__ unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(wg::align_smem(smem_raw));   // NW x 3 x (64, DP): q scale, v
  bf16* k_s = x_s + NW * 3 * T;                                     // NW x 3 x (64, DP): k
  float* bias_s = reinterpret_cast<float*>(k_s + NW * 3 * T);      // NW 64; -inf beyond S

  const int w = threadIdx.x / st::kTileThreads;   // the warpgroup: queries 64 w ..
  const int tid = threadIdx.x - w * st::kTileThreads;
  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const int lane = threadIdx.x & 31;
  const int row0 = R * w + 16 * (tid >> 5);       // the warp's queries
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  bf16* own = x_s + w * 3 * T;

  st::split_rows<DP, R, true>(own, T, q + base, R * w, S, D, vec, scale, tid);
  st::split_rows<DP, R, true>(k_s + w * 3 * T, T, k + base, R * w, S, D, vec, 1.0f, tid);
  for (int j = threadIdx.x; j < NW * R; j += NW * st::kTileThreads) {
    bias_s[j] = j < S ? bias[(size_t)b * S + j] : -INFINITY;
  }
  wg::fence_proxy_async();
  __syncthreads();   // the terms are in

  // s[kt][j][e]: query row0 + g + 8 (e / 2), key 64 kt + 8 j + t2 + e % 2
  float s[NW][N8][4];
  {
    float hh[NW][N8][4];
    wg::fence();
#pragma unroll
    for (int kt = 0; kt < NW; ++kt) {
      wg::issue_scores<R, DP>(hh[kt], s[kt], own, T, k_s + kt * 3 * T, T);
    }
    wg::commit();
    wg::wait_all();
#pragma unroll
    for (int kt = 0; kt < NW; ++kt) {
      wg::fence_operand(s[kt]);
      wg::fence_operand(hh[kt]);
      wg::sum_scores(s[kt], hh[kt]);
      st::add_bias<N8>(s[kt], bias_s + R * kt, t2);
    }
  }
  __syncthreads();   // every warpgroup done with q's terms
  st::split_rows<DP, R, false>(own, T, v + base, R * w, S, D, vec, 1.0f, tid);
  wg::fence_proxy_async();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kt = 0; kt < NW; ++kt) {
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[kt][j][e]);
    }
  }
  m[0] = st::quad_max(m[0]);
  m[1] = st::quad_max(m[1]);
#pragma unroll
  for (int kt = 0; kt < NW; ++kt) {
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[kt][j][e] = expf(s[kt][j][e] - m[e >> 1]);
        l[e >> 1] += s[kt][j][e];
      }
    }
  }
  l[0] = st::quad_sum(l[0]);
  l[1] = st::quad_sum(l[1]);
  const st::KeepMask keep(seed_ptr, b, h, S, rate);
  uint32_t a[NW][3][R / 16][4];
#pragma unroll
  for (int kt = 0; kt < NW; ++kt) {
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = s[kt][j][e] / l[e >> 1];
        if (keep.drop) {
          p = keep(row0 + g + 8 * (e >> 1), R * kt + 8 * j + t2 + (e & 1)) ? p * keep_scale
                                                                           : 0.0f;
        }
        s[kt][j][e] = p;   // pd
      }
    }
    mmda::short_mma::split_operand<R / 16>(a[kt], s[kt]);
  }
  __syncthreads();   // v's terms are in

#pragma unroll
  for (int hb = 0; hb < DP / 64; ++hb) {
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
    }
    wg::fence_operand(part);
    wg::fence();
#pragma unroll
    for (int kt = 0; kt < NW; ++kt) {
      wg::issue_terms_product<R>(part, a[kt], x_s + kt * 3 * T + hb * R * wg::kBoxCols, T);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operand(part);
    st::store_cols_f32(o + base, part, row0, 64 * hb, S, D, 1.0f, lane);
  }
}

template <int DP, int NW>
cudaError_t launch_f32_wgmma(const void* q, const void* k, const void* v, const float* bias,
                             const int* seed, void* o, int BH, int nh, int S, int D,
                             float scale, float rate, float keep_scale, cudaStream_t stream) {
  constexpr size_t bytes = f32_wgmma_smem_bytes<DP, NW>();
  cudaError_t err = cudaFuncSetAttribute(short_attn_fwd_f32_wgmma_kernel<DP, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int vec = D % 4 == 0 && mmda::short_tiled::aligned16(q) &&
                  mmda::short_tiled::aligned16(k) && mmda::short_tiled::aligned16(v);
  short_attn_fwd_f32_wgmma_kernel<DP, NW>
      <<<BH, NW * mmda::short_tiled::kTileThreads, bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), bias, seed, static_cast<float*>(o), nh, S, D, scale, rate,
          keep_scale, vec);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16

template <int SP>
size_t mma_smem_bytes(int DP) {
  // q, k, v; per key: the bias
  return 3 * (size_t)SP * (DP + kRowPad) * sizeof(bf16) + SP * sizeof(float);
}

template <int SP>
__global__ void __launch_bounds__(2 * SP)
short_attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const int* __restrict__ seed_ptr, bf16* __restrict__ o, int nh,
                          int S, int D, int DP, float scale, float rate, float keep_scale) {
  constexpr int NT = 2 * SP;     // SP / 16 warps
  constexpr int N8 = SP / 8;     // n8 tiles of a 16 x SP block
  constexpr int K16 = SP / 16;   // k16 slices of it as an operand
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = DP + kRowPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + SP * ld;
  bf16* v_s = k_s + SP * ld;
  float* bias_s = reinterpret_cast<float*>(v_s + SP * ld);   // per key; -inf beyond S

  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  mmda::short_mma::load_operand_async(q_s, ld, q + base, S, D, SP, DP, NT);
  mmda::short_mma::load_operand_async(k_s, ld, k + base, S, D, SP, DP, NT);
  mmda::short_mma::load_operand_async(v_s, ld, v + base, S, D, SP, DP, NT);
  mmda::flash::cp_async_commit();
  for (int j = threadIdx.x; j < SP; j += NT) {
    bias_s[j] = j < S ? bias[(size_t)b * S + j] : -INFINITY;
  }
  mmda::flash::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);   // the warp's queries
  const int g = lane >> 2, t2 = 2 * (lane & 3);

  // [j][e] is query row0 + g + 8 (e / 2), key 8 j + t2 + e % 2
  float s[N8][4];
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  }
  for (int k0 = 0; k0 < DP; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, frag_addr_rows(q_s, ld, row0, k0, lane));
#pragma unroll
    for (int j = 0; j < N8; j += 2) {
      uint32_t bk[4];
      ldmatrix_x4(bk, frag_addr_nk(k_s, ld, 8 * j, k0, lane));
      mma_bf16(s[j], a, bk[0], bk[1]);
      mma_bf16(s[j + 1], a, bk[2], bk[3]);
    }
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bias_s[8 * j + t2 + (e & 1)]);
      m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
  }
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = s[j][e] / l[e >> 1];   // p
      if (drop) {
        const int i = row0 + g + 8 * (e >> 1), jk = 8 * j + t2 + (e & 1);
        s[j][e] *= mmda::short_attn_keep(hbase, (uint32_t)(i * S + jk), rate) ? keep_scale
                                                                              : 0.0f;
      }
    }
  }
  uint32_t pd[3][K16][4];
  mmda::short_mma::split_operand<K16>(pd, s);
  mmda::short_mma::product_out<K16>(o + base, pd, v_s, ld, S, D, DP, row0, 1.0f, lane);
}

template <int SP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, void* o, int BH, int nh, int S, int D, float scale,
                       float rate, float keep_scale, cudaStream_t stream) {
  const int DP = (D + 15) / 16 * 16;
  const size_t bytes = mma_smem_bytes<SP>(DP);
  cudaError_t err = cudaFuncSetAttribute(
      short_attn_fwd_mma_kernel<SP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  short_attn_fwd_mma_kernel<SP><<<BH, 2 * SP, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, seed, static_cast<bf16*>(o), nh, S, D, DP, scale, rate, keep_scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, void* o, int BH, int nh, int S, int D, float scale,
                       float rate, float keep_scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      short_attn_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  short_attn_fwd_f32_kernel<<<BH, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, seed, static_cast<float*>(o), nh, S, D, scale, rate, keep_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, o (B, nh, S, D): bf16 when is_bf16 else f32, contiguous;
// 1 <= S <= 128, 1 <= D <= 128 (f32 design 1: the shape's shared memory,
// smem_bytes, within the card's opt-in limit).  impl: the f32 design, 0 the
// six bf16 term products on wgmma, 1 f32 FMAs; bf16 has one.  scale = 1 /
// sqrt(D), rate and keep_scale = 1 / (1 - rate) already rounded to f32;
// seed (device int32) is read only when rate > 0.
int mmda_short_attn_fwd(const void* q, const void* k, const void* v, const float* bias,
                        const int* seed, void* o, int B, int nh, int S, int D,
                        int is_bf16, int impl, float scale, float rate, float keep_scale,
                        void* stream) {
  if (B < 1 || nh < 1 || S < 1 || S > kMaxS || D < 1 || D > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * nh;
  if (!is_bf16) {
    if (impl == 1) {
      return (int)launch_f32(q, k, v, bias, seed, o, BH, nh, S, D, scale, rate, keep_scale, st);
    }
#define MMDA_SHORT_FWD_F32(DP, NW)                                                        \
  return (int)launch_f32_wgmma<DP, NW>(q, k, v, bias, seed, o, BH, nh, S, D, scale, rate, \
                                       keep_scale, st)
    if (S <= 64) {
      if (D <= 64) MMDA_SHORT_FWD_F32(64, 1);
      MMDA_SHORT_FWD_F32(128, 1);
    }
    if (D <= 64) MMDA_SHORT_FWD_F32(64, 2);
    MMDA_SHORT_FWD_F32(128, 2);
#undef MMDA_SHORT_FWD_F32
  }
  switch ((S + 15) / 16) {
#define MMDA_SHORT_FWD_CASE(n)                                                              \
  case n:                                                                                   \
    return (int)launch_mma<16 * n>(q, k, v, bias, seed, o, BH, nh, S, D, scale, rate,       \
                                   keep_scale, st);
    MMDA_SHORT_FWD_CASE(1)
    MMDA_SHORT_FWD_CASE(2)
    MMDA_SHORT_FWD_CASE(3)
    MMDA_SHORT_FWD_CASE(4)
    MMDA_SHORT_FWD_CASE(5)
    MMDA_SHORT_FWD_CASE(6)
    MMDA_SHORT_FWD_CASE(7)
    MMDA_SHORT_FWD_CASE(8)
#undef MMDA_SHORT_FWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
