// Short attention forward over query and key tiles, for Hopper (sm_90a),
// plain C entry point: the sequences that short_attn_fwd.cu's one block per
// (batch item, head) cannot hold (S > 128, or an f32 shape beyond its shared
// memory).
//
// Replaces mmda_tpu/ops/pallas/short_attention.py::_fwd_kernel (:61,
// launched by _fwd_call :128) at any S, with its function: per (batch item
// b, head h), all f32,
//
//   s  = (q * scale) k^T + bias[b]         scale = f32(1 / sqrt(D))
//   p  = exp(s - m) / l                    m the row max, l = sum exp(s - m)
//   o  = round((p * keep * f32(1 / (1 - rate))) v)    once, to the input type
//
// with the short kernels' own keep hash at i S + j (hash_dropout.cuh).
//
// Design (short_tiled.cuh).  A block per (64 queries, b, h) (32 in the f32
// FMA design), one pass over the key tiles with the online max and
// sum: s formed once, exp once a score; when a tile raises a row's max, its l
// and f32 accumulator are rescaled by exp(m_old - m_new); the accumulator
// takes exp(s - m) times the 0/1 mask, times v; at the end o = acc (1 / l)
// keep_scale, one multiply an output, no division a score.  This differs from
// the exact two-pass softmax by f32 rounding only (tests/
// test_torch_kernel_domain.py models it against the one-ulp bf16 gate).  For
// training it also writes each query's (m, l) and, in bf16, o before its
// rounding (o32): the backward reads them instead of a pass over the keys.
//   bf16, wgmma fed by TMA (wgmma.cuh), where D is a multiple of 8 above 32
//   and the inputs 16-byte aligned: q k^T as m64n64k16 from shared memory,
//   the scores and the online softmax in the accumulator fragments, pd v as
//   three m64nDPk16 issues with the three bf16 terms of pd (short_mma.cuh) as
//   the A operand from registers and v read MN-major; k and v a 64-key tile
//   at a time through a two-stage TMA ring, one thread issuing.  Every other
//   head dim: mma.sync m16n8k16 with the same arithmetic, k and v through two
//   cp.async buffers.  scale after q k^T, as short_attn_fwd.cu's bf16 kernel.
//   f32, on the tensor cores (impl 0, every head dim): q * scale first, as
//   the plain version; q * scale, k and v each as three bf16 terms hi, mid,
//   lo (v all 24 bits: short_mma.cuh split3; q * scale and k on each row's
//   grid, short_tiled.cuh, so that the scores' hi hi sums are exact in the
//   tensor cores' truncating f32 and take their own accumulator) and each
//   product as six bf16 term products on wgmma (hi hi, hi mid, mid hi, hi
//   lo, lo hi, mid mid; the terms left out weigh 2^-24 and less), 12 a key
//   tile: q k^T from shared memory (wgmma::issue_scores), pd v with pd's
//   terms from registers and v's read MN-major.  k and
//   v (64 keys a tile at D <= 64, 32 at D <= 128) are read from global
//   memory into registers (16 bytes a load where D % 4 == 0, else 4) and
//   split by all threads into swizzled bf16 term tiles: no f32 copy in shared
//   memory, so three blocks share an SM at D <= 64 (73 KB each), where an f32
//   staging area left room for two; D is zero-padded to 64 or 128 columns.
//   A tile's pd v is summed in a fresh accumulator and added to the running
//   one in f32, so the tensor cores' own sums (in their order and rounding,
//   not the plain version's) stay within a tile: o lies within the f32 gate
//   of the plain version, not on its bits, and closer to float64 than it
//   (PERF.md).  At hd = 8 and 33 it also beats the FMAs (PERF.md), so every
//   head dim takes it.  f32 FMAs (impl 1, kept for
//   comparison): a lane per key of a 32-query, 32-key tile for the scores, a
//   lane per output column for pd v; about 1.25 shared-memory loads an FMA.
//
// exp(s - m) is ex2.approx of (s - m) log2 e in the bf16 kernels (within a
// few f32 ulps; the f32 kernels keep expf).
//
// What bounds it on the H100 at the long step's call (32, 12, 514, 64) bf16:
// 4 S^2 D operations a head as the bound counts them (q k^T, pd v) take 0.026
// ms at the bf16 peak, the 101 MB of q, k, v and o 0.030 ms: the bytes.  The
// kernel does q k^T once and pd v three times over (each f32 term a bf16
// product), and a hash, an exp and a three-way split per score, serialised
// with the products within each warpgroup; the blocks resident beside it on
// an SM fill the gaps.  Its times beside the mma.sync design's: PERF.md.
// In f32 the same call's bound is the 12.99 GFLOP of its two products at a
// sixth of the bf16 peak (the six term products): 0.158 ms, above the 0.060
// ms of its 202 MB.  The kernel adds a three-way split of every element it
// reads and of every score, an expf and a hash a score, serialised with the
// products within each warpgroup; three blocks share an SM at D <= 64.

#include "short_tiled.cuh"
#include "wgmma.cuh"

namespace {

using mmda::flash::bf16;
using mmda::flash::kRowPad;
using namespace mmda::short_tiled;

// ----------------------------------------------------------------- bf16

template <int DP>
size_t mma_smem_bytes() {
  constexpr int NB = stream_rows<DP>();
  return ((size_t)kTileRows + 4 * NB) * (DP + kRowPad) * sizeof(bf16) +
         2 * NB * sizeof(float);
}

// mma.sync m16n8k16, k, v and the key bias through two cp.async buffers.
template <int DP>
__global__ void __launch_bounds__(kTileThreads)
tiled_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, bf16* __restrict__ o,
                     float* __restrict__ stats, float* __restrict__ o32, int nh, int head0, int S,
                     int D, int q_tiles, float scale, float rate, float keep_scale) {
  constexpr int NB = stream_rows<DP>();
  constexpr int N8 = NB / 8;
  constexpr int L = DP + kRowPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // (64, L)
  bf16* k_s = q_s + kTileRows * L;                 // 2 x (NB, L)
  bf16* v_s = k_s + 2 * NB * L;                    // 2 x (NB, L)
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * NB * L);   // 2 x NB; -inf beyond S

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = head0 + bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* bias_b = bias + (size_t)b * S;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int k_tiles = (S + NB - 1) / NB;
  const KeepMask keep(seed_ptr, b, h, S, rate);

  load_rows<DP>(q_s, q + base, q0, kTileRows, S, D, kTileThreads);
  auto stage = [&](int t) {
    const int buf = t & 1;
    load_rows<DP>(k_s + buf * NB * L, k + base, t * NB, NB, S, D, kTileThreads);
    load_rows<DP>(v_s + buf * NB * L, v + base, t * NB, NB, S, D, kTileThreads);
    for (int j = threadIdx.x; j < NB; j += kTileThreads) {
      bias_s[buf * NB + j] = t * NB + j < S ? bias_b[t * NB + j] : -INFINITY;
    }
    mmda::flash::cp_async_commit();
  };

  OnlineRows<DP> rows;
  stage(0);
  for (int t = 0; t < k_tiles; ++t) {
    if (t + 1 < k_tiles) {
      stage(t + 1);
      cp_async_wait_one();
    } else {
      mmda::flash::cp_async_wait_all();
    }
    __syncthreads();
    const int buf = t & 1;
    float s[N8][4];
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
    mmda::flash::mma_abt<DP, N8>(s, q_s, row0, k_s + buf * NB * L, lane);
    scale_bias<N8>(s, scale, bias_s + buf * NB, t2);
    rows.update(s, keep, q0 + row0 + g, t * NB + t2);
    split_product<DP, NB>(rows.acc, s, v_s + buf * NB * L, lane);
    __syncthreads();
  }
  rows.finish(o + base, stats, o32 == nullptr ? nullptr : o32 + base, (size_t)bh * S,
              q0 + row0, S, D, keep_scale, lane);
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, void* o, float* stats, float* o32, int BH, int nh,
                       int head0, int S, int D, float scale, float rate, float keep_scale,
                       cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(tiled_fwd_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (S + kTileRows - 1) / kTileRows;
  tiled_fwd_mma_kernel<DP><<<BH * q_tiles, kTileThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, seed, static_cast<bf16*>(o), stats, o32, nh, head0, S, D, q_tiles, scale, rate,
      keep_scale);
  return cudaGetLastError();
}

// wgmma fed by TMA: q, and k, v a key tile at a time through a ring of
// kStages buffers, one thread issuing; the key bias staged by every thread.
constexpr int kStages = 2;
constexpr int kWgNB = 64;        // keys a tile

template <int DP>
constexpr size_t wgmma_smem_bytes() {
  return ((size_t)kTileRows * DP + 2 * kStages * kWgNB * DP) * sizeof(bf16) +
         kStages * kWgNB * sizeof(float) + (kStages + 1) * sizeof(uint64_t) +
         mmda::wgmma::kSmemAlign;
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads)
tiled_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const float* __restrict__ bias,
                       const int* __restrict__ seed_ptr, bf16* __restrict__ o,
                       float* __restrict__ stats, float* __restrict__ o32, int nh, int head0, int S,
                       int D, int q_tiles, float scale, float rate, float keep_scale) {
  namespace wg = mmda::wgmma;
  constexpr int NB = kWgNB, N8 = NB / 8, TILE = NB * DP;
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(wg::align_smem(smem_raw));   // (64, DP)
  bf16* k_s = q_s + kTileRows * DP;                // kStages x (NB, DP)
  bf16* v_s = k_s + kStages * TILE;                // kStages x (NB, DP)
  float* bias_s = reinterpret_cast<float*>(v_s + kStages * TILE);   // kStages x NB
  uint64_t* bar = reinterpret_cast<uint64_t*>(bias_s + kStages * NB);   // k, v stages; q

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = head0 + bh - b * nh;
  const float* bias_b = bias + (size_t)b * S;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int k_tiles = (S + NB - 1) / NB;
  const KeepMask keep(seed_ptr, b, h, S, rate);

  auto issue = [&](int t) {        // thread 0: key tile t into its stage
    uint64_t* full = bar + t % kStages;
    wg::mbar_expect_tx(full, 2 * TILE * sizeof(bf16));
    wg::tma_tile<DP>(k_s + (t % kStages) * TILE, &tk, full, NB, t * NB, bh);
    wg::tma_tile<DP>(v_s + (t % kStages) * TILE, &tv, full, NB, t * NB, bh);
  };
  auto stage_bias = [&](int t) {
    for (int j = threadIdx.x; j < NB; j += kTileThreads) {
      bias_s[(t % kStages) * NB + j] = t * NB + j < S ? bias_b[t * NB + j] : -INFINITY;
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) wg::mbar_init(bar + i, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_expect_tx(bar + kStages, kTileRows * DP * sizeof(bf16));
    wg::tma_tile<DP>(q_s, &tq, bar + kStages, kTileRows, q0, bh);
    issue(0);
  }
  stage_bias(0);
  wg::mbar_wait(bar + kStages, 0);

  OnlineRows<DP> rows;
  for (int t = 0; t < k_tiles; ++t) {
    const int st = t % kStages;
    __syncthreads();     // tile t - 1's buffers are free; tile t's bias is in
    if (t + 1 < k_tiles) {
      if (threadIdx.x == 0) issue(t + 1);
      stage_bias(t + 1);
    }
    wg::mbar_wait(bar + st, (t / kStages) & 1);
    float s[N8][4];
    wg::fence();
    wg::issue_abt<NB, DP>(s, q_s, k_s + st * TILE);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(s);
    scale_bias<N8>(s, scale, bias_s + st * NB, t2);
    rows.update(s, keep, q0 + row0 + g, t * NB + t2);
    uint32_t a[3][NB / 16][4];
    mmda::short_mma::split_operand<NB / 16>(a, s);
    wg::fence_operand(rows.acc);
    wg::fence();
    wg::issue_split_product<DP, NB>(rows.acc, a, v_s + st * TILE);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(rows.acc);
  }
  const size_t base = (size_t)bh * S * D;
  rows.finish(o + base, stats, o32 == nullptr ? nullptr : o32 + base, (size_t)bh * S,
              q0 + row0, S, D, keep_scale, lane);
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* bias,
                         const int* seed, void* o, float* stats, float* o32, int BH, int nh,
                         int head0, int S, int D, float scale, float rate, float keep_scale,
                         cudaStream_t stream) {
  namespace wg = mmda::wgmma;
  CUtensorMap tq, tk, tv;
  if (!wg::head_map(&tq, q, BH, S, D, kTileRows) || !wg::head_map(&tk, k, BH, S, D, kWgNB) ||
      !wg::head_map(&tv, v, BH, S, D, kWgNB)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t bytes = wgmma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(tiled_fwd_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (S + kTileRows - 1) / kTileRows;
  tiled_fwd_wgmma_kernel<DP><<<BH * q_tiles, kTileThreads, bytes, stream>>>(
      tq, tk, tv, bias, seed, static_cast<bf16*>(o), stats, o32, nh, head0, S, D, q_tiles, scale,
      rate, keep_scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32

size_t f32_smem_bytes(int D) {
  // k (stride D + 1) and v tiles; per warp its 4 q * scale rows and 4 p rows
  return ((size_t)kF32Rows * (D + 1) + (size_t)kF32Rows * D +
          (size_t)kF32Warps * kF32RowsPerWarp * (D + kF32Rows)) * sizeof(float);
}

__global__ void __launch_bounds__(kF32Threads)
tiled_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, float* __restrict__ o,
                     float* __restrict__ stats, int nh, int head0, int S, int D, int q_tiles,
                     float scale, float rate, float keep_scale) {
  constexpr int R = kF32RowsPerWarp;
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* k_s = smem;                                  // (32, D + 1)
  float* v_s = k_s + kF32Rows * ld;                   // (32, D)
  float* q_w = v_s + kF32Rows * D + warp * R * (D + kF32Rows);   // this warp's (R, D) q rows
  float* p_w = q_w + R * D;                           // ... and (R, 32) p rows

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kF32Rows + warp * R;   // the warp's rows
  const int b = bh / nh;
  const int h = head0 + bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* bias_b = bias + (size_t)b * S;
  const KeepMask keep(seed_ptr, b, h, S, rate);
  const int k_tiles = (S + kF32Rows - 1) / kF32Rows;

  for (int e = lane; e < R * D; e += 32) {
    const int r = e / D;
    q_w[e] = q0 + r < S ? q[base + (size_t)(q0 + r) * D + (e - r * D)] * scale : 0.0f;
  }
  __syncwarp();

  // per row: the online max m, the lane's share of l, the accumulator of
  // (exp(s - m) times the 0/1 mask) v over the lane's columns
  float m[R], l[R], acc[R][kF32Cols] = {};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
  for (int t = 0; t < k_tiles; ++t) {
    const int k0 = t * kF32Rows;
    stage_f32(k_s, k + base, k0, kF32Rows, S, D, 1.0f, kF32Threads);
    for (int e = threadIdx.x; e < kF32Rows * D; e += kF32Threads) {
      const int r = e / D;
      v_s[e] = k0 + r < S ? v[base + (size_t)k0 * D + e] : 0.0f;
    }
    __syncthreads();
    // the scores of the warp's R rows with key k0 + lane (-inf beyond S)
    const int j = k0 + lane;
    const float* kj = k_s + lane * ld;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float kc = kj[c];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(q_w[r * D + c], kc, s[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = j < S ? s[r] + bias_b[j] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      const float alpha = expf(m[r] - m_new);
      const float x = expf(s[r] - m_new);
      l[r] = l[r] * alpha + x;
      m[r] = m_new;
#pragma unroll
      for (int u = 0; u < kF32Cols; ++u) acc[r][u] *= alpha;
      p_w[r * kF32Rows + lane] = keep(q0 + r, j) ? x : 0.0f;
    }
    __syncwarp();
    const int n = min(kF32Rows, S - k0);
    for (int jj = 0; jj < n; ++jj) {
#pragma unroll
      for (int u = 0; u < kF32Cols; ++u) {
        const int c = lane + 32 * u;
        if (c < D) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][u] = fmaf(p_w[r * kF32Rows + jj], v_s[jj * D + c], acc[r][u]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] = warp_sum(l[r]);
    if (q0 + r >= S) continue;
    const float f = (1.0f / l[r]) * keep_scale;
    if (stats != nullptr && lane == 0) {
      *reinterpret_cast<float2*>(stats + ((size_t)bh * S + q0 + r) * 2) = make_float2(m[r], l[r]);
    }
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      if (c < D) o[base + (size_t)(q0 + r) * D + c] = acc[r][u] * f;
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, void* o, float* stats, int BH, int nh, int head0, int S,
                       int D, float scale, float rate, float keep_scale, cudaStream_t stream) {
  const size_t bytes = f32_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(tiled_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (S + kF32Rows - 1) / kF32Rows;
  tiled_fwd_f32_kernel<<<BH * q_tiles, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, seed, static_cast<float*>(o), stats, nh, head0, S, D, q_tiles, scale, rate, keep_scale);
  return cudaGetLastError();
}

// f32 on wgmma: q * scale, k and v as three bf16 terms each, every product
// six term products (wgmma.cuh issue_terms_*); k and v a key tile at a time,
// read from global memory into registers and split into their term tiles by
// all threads (no f32 staging in shared memory: three blocks share an SM at
// D <= 64).  A key tile's pd v is summed in a fresh accumulator, 64 output
// columns at a time, then added to the running one in f32: the tensor
// cores' sums stay within the tile.
template <int DP>
__host__ __device__ constexpr int f32_key_rows() { return DP <= 64 ? 64 : 32; }

template <int DP>
constexpr size_t f32_wgmma_smem_bytes() {
  // q's terms; k's and v's terms; the key bias
  constexpr int NB = f32_key_rows<DP>();
  return (size_t)3 * (kTileRows + 2 * NB) * DP * sizeof(bf16) + NB * sizeof(float) +
         mmda::wgmma::kSmemAlign;
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads, DP == 64 ? 3 : 1)
tiled_fwd_f32_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           const int* __restrict__ seed_ptr, float* __restrict__ o,
                           float* __restrict__ stats, int nh, int head0, int S, int D, int q_tiles,
                           float scale, float rate, float keep_scale, int vec) {
  namespace wg = mmda::wgmma;
  constexpr int NB = f32_key_rows<DP>(), N8 = NB / 8;
  constexpr int QT = kTileRows * DP, KT = NB * DP;   // elements of a term tile
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(wg::align_smem(smem_raw));   // 3 x (64, DP)
  bf16* k_s = q_s + 3 * QT;                          // 3 x (NB, DP)
  bf16* v_s = k_s + 3 * KT;                          // 3 x (NB, DP)
  float* bias_s = reinterpret_cast<float*>(v_s + 3 * KT);   // NB; -inf beyond S

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = head0 + bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* bias_b = bias + (size_t)b * S;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int k_tiles = (S + NB - 1) / NB;
  const KeepMask keep(seed_ptr, b, h, S, rate);

  split_rows<DP, kTileRows, true>(q_s, QT, q + base, q0, S, D, vec, scale);
  OnlineRows<DP> rows;
  for (int t = 0; t < k_tiles; ++t) {
    __syncthreads();   // every warp done with tile t - 1's terms
    split_rows<DP, NB, true>(k_s, KT, k + base, t * NB, S, D, vec, 1.0f);
    split_rows<DP, NB, false>(v_s, KT, v + base, t * NB, S, D, vec, 1.0f);
    for (int j = threadIdx.x; j < NB; j += kTileThreads) {
      bias_s[j] = t * NB + j < S ? bias_b[t * NB + j] : -INFINITY;
    }
    wg::fence_proxy_async();
    __syncthreads();   // the terms are in
    float s[N8][4], s_hh[N8][4];
    wg::fence();
    wg::issue_scores<NB, DP>(s_hh, s, q_s, QT, k_s, KT);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(s);
    wg::fence_operand(s_hh);
    wg::sum_scores(s, s_hh);
    add_bias<N8>(s, bias_s, t2);
    rows.update_f32(s, keep, q0 + row0 + g, t * NB + t2);
    uint32_t a[3][NB / 16][4];
    mmda::short_mma::split_operand<NB / 16>(a, s);
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
      wg::issue_terms_product<NB>(part, a, v_s + hb * NB * wg::kBoxCols, KT);
      wg::commit();
      wg::wait_all();
      wg::fence_operand(part);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rows.acc[8 * hb + j][e] += part[j][e];
      }
    }
  }
  rows.finish(o + base, stats, nullptr, (size_t)bh * S, q0 + row0, S, D, keep_scale, lane);
}

template <int DP>
cudaError_t launch_f32_wgmma(const void* q, const void* k, const void* v, const float* bias,
                             const int* seed, void* o, float* stats, int BH, int nh, int head0,
                             int S, int D, float scale, float rate, float keep_scale,
                             cudaStream_t stream) {
  constexpr size_t bytes = f32_wgmma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(tiled_fwd_f32_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (S + kTileRows - 1) / kTileRows;
  const int vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  tiled_fwd_f32_wgmma_kernel<DP><<<BH * q_tiles, kTileThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, seed, static_cast<float*>(o), stats, nh, head0, S, D, q_tiles, scale, rate, keep_scale,
      vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, o (B, nh, S, D): bf16 when is_bf16 else f32, contiguous; S >= 1,
// 1 <= D <= 128, B nh ceil(S / 32) < 2^31.  stats (B nh S x 2 f32: each
// query's m and l) and, in bf16, o32 ((B, nh, S, D) f32: o before its
// rounding) are written where not NULL (the training forward; in f32 o is
// o32).  impl: the design; bf16 0 by shape (wgmma where D is a multiple of 8
// above 32 and q, k, v 16-byte aligned, else mma.sync), 1 mma.sync; f32 0
// the six bf16 term products on wgmma (any D), 1 f32 FMAs.  scale = 1 /
// sqrt(D), rate and keep_scale = 1 / (1 - rate) already rounded to f32;
// seed (device int32) is read only when rate > 0.
// head0: q, k, v hold heads head0 .. head0 + nh - 1 of a larger set (a rank's
// heads under tensor parallelism); the dropout hash takes h = head0 + the
// local head, so 0 gives every head of one process its own mask.
int mmda_short_attn_tiled_fwd(const void* q, const void* k, const void* v, const float* bias,
                              const int* seed, void* o, float* stats, float* o32, int B, int nh,
                              int S, int D, int is_bf16, int impl, int head0, float scale,
                              float rate, float keep_scale, void* stream) {
  if (B < 1 || nh < 1 || head0 < 0 || S < 1 || D < 1 || D > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * nh;
  if (!is_bf16) {
    if (impl == 1) {
      return (int)launch_f32(q, k, v, bias, seed, o, stats, BH, nh, head0, S, D, scale, rate,
                             keep_scale, st);
    }
    if (D <= 64) {
      return (int)launch_f32_wgmma<64>(q, k, v, bias, seed, o, stats, BH, nh, head0, S, D, scale,
                                       rate, keep_scale, st);
    }
    return (int)launch_f32_wgmma<128>(q, k, v, bias, seed, o, stats, BH, nh, head0, S, D, scale,
                                      rate, keep_scale, st);
  }
#define MMDA_TILED_FWD(DP)                                                                \
  return (int)launch_mma<DP>(q, k, v, bias, seed, o, stats, o32, BH, nh, head0, S, D, scale, rate, \
                             keep_scale, st)
  if (impl != 1 && D > 32 && mmda::wgmma::takes(q, D) && mmda::wgmma::takes(k, D) &&
      mmda::wgmma::takes(v, D)) {
    if (D <= 64) {
      return (int)launch_wgmma<64>(q, k, v, bias, seed, o, stats, o32, BH, nh, head0, S, D, scale,
                                   rate, keep_scale, st);
    }
    return (int)launch_wgmma<128>(q, k, v, bias, seed, o, stats, o32, BH, nh, head0, S, D, scale,
                                  rate, keep_scale, st);
  }
  if (D <= 16) MMDA_TILED_FWD(16);
  if (D <= 32) MMDA_TILED_FWD(32);
  if (D <= 64) MMDA_TILED_FWD(64);
  MMDA_TILED_FWD(128);
#undef MMDA_TILED_FWD
}

}  // extern "C"
