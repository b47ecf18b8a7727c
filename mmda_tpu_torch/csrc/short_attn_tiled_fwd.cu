// Short attention forward over query and key tiles, for Hopper (sm_90a),
// plain C entry point: the sequences that short_attn_fwd.cu's one block per
// (batch item, head) cannot hold (S > 128, or an f32 shape beyond its shared
// memory).
//
// Replaces mmda_tpu/ops/pallas/short_attention.py::_fwd_kernel (:61,
// launched by _fwd_call :128) at any S, with its arithmetic: per (batch item
// b, head h), all f32,
//
//   s  = (q * scale) k^T + bias[b]         scale = f32(1 / sqrt(D))
//   p  = exp(s - m) / l                    m the exact row max, l = sum exp(s - m)
//   o  = round((p * keep * f32(1 / (1 - rate))) v)    once, to the input type
//
// with the short kernels' own keep hash at i S + j (hash_dropout.cuh).
//
// Design (short_tiled.cuh).  A block per (64 queries, b, h) in bf16, (32
// queries, b, h) in f32; two passes over the key tiles: the first takes each
// row's m and l, the second forms p exactly, applies the mask and
// accumulates pd v.  Nothing of S x S size is written.
//   bf16: q k^T on the tensor cores straight from the bf16 inputs (exact
//   products, f32 sums), then times scale and plus the bias in f32; pd v with
//   pd as three bf16 terms (short_mma.cuh): the arithmetic of
//   short_attn_fwd.cu's bf16 kernel.  k and v tiles stream through two
//   shared-memory buffers by cp.async.
//   f32: f32 FMAs, q * scale first; a lane per key of the 32-key tile for the
//   scores, a lane per output column (4 each, D <= 128) for pd v.
//
// What bounds it on the H100 at the long step's call (32, 12, 514, 64) bf16:
// the products, 3 S^2 D a head (q k^T twice, pd v as three terms counted
// once), not the 50.6 MB of q, k, v and o.

#include "short_tiled.cuh"

namespace {

using mmda::flash::bf16;
using mmda::flash::kRowPad;
using namespace mmda::short_tiled;

// The scaled keep mask of query i, key j: keep_scale, or 0 where dropped (1
// at rate 0); the hash at i S + j in uint32 with S the full length.
__device__ __forceinline__ float keep_of(bool drop, uint32_t hbase, int i, int j, int S,
                                         float rate, float keep_scale) {
  if (!drop) return 1.0f;
  return mmda::short_attn_keep(hbase, (uint32_t)i * (uint32_t)S + (uint32_t)j, rate)
             ? keep_scale
             : 0.0f;
}

// ----------------------------------------------------------------- bf16

template <int DP>
size_t mma_smem_bytes() {
  constexpr int NB = stream_rows<DP>();
  return ((size_t)kTileRows + 4 * NB) * (DP + kRowPad) * sizeof(bf16) +
         2 * NB * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads)
tiled_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, bf16* __restrict__ o, int nh, int S,
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
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* bias_b = bias + (size_t)b * S;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int k_tiles = (S + NB - 1) / NB;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;

  load_rows<DP>(q_s, q + base, q0, kTileRows, S, D, kTileThreads);
  auto stage = [&](int t, bool with_v) {
    const int buf = t & 1;
    load_rows<DP>(k_s + buf * NB * L, k + base, t * NB, NB, S, D, kTileThreads);
    if (with_v) load_rows<DP>(v_s + buf * NB * L, v + base, t * NB, NB, S, D, kTileThreads);
    for (int j = threadIdx.x; j < NB; j += kTileThreads) {
      bias_s[buf * NB + j] = t * NB + j < S ? bias_b[t * NB + j] : -INFINITY;
    }
    mmda::flash::cp_async_commit();
  };
  // s = q k^T * scale + bias of key tile t (in buffer t & 1)
  auto scores = [&](int t, float (&s)[N8][4]) {
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
    mmda::flash::mma_abt<DP, N8>(s, q_s, row0, k_s + (t & 1) * NB * L, lane);
    const float* bt = bias_s + (t & 1) * NB;
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bt[8 * j + t2 + (e & 1)]);
      }
    }
  };

  // pass 1: m and l of the rows row0 + g and row0 + g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  stage(0, false);
  for (int t = 0; t < k_tiles; ++t) {
    if (t + 1 < k_tiles) {
      stage(t + 1, false);
      cp_async_wait_one();
    } else {
      mmda::flash::cp_async_wait_all();
    }
    __syncthreads();
    float s[N8][4];
    scores(t, s);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < N8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      const float m_new = fmaxf(m[hh], quad_max(tmax));   // finite: key t NB < S
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        sum += expf(s[j][2 * hh] - m_new) + expf(s[j][2 * hh + 1] - m_new);
      }
      l[hh] = l[hh] * expf(m[hh] - m_new) + sum;
      m[hh] = m_new;
    }
    __syncthreads();
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);

  // pass 2: p exactly, the mask, o += pd v
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  stage(0, true);
  for (int t = 0; t < k_tiles; ++t) {
    if (t + 1 < k_tiles) {
      stage(t + 1, true);
      cp_async_wait_one();
    } else {
      mmda::flash::cp_async_wait_all();
    }
    __syncthreads();
    float s[N8][4];
    scores(t, s);
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = q0 + row0 + g + 8 * (e >> 1), jk = t * NB + 8 * j + t2 + (e & 1);
        const float p = expf(s[j][e] - m[e >> 1]) / l[e >> 1];
        s[j][e] = p * keep_of(drop, hbase, i, jk, S, rate, keep_scale);
      }
    }
    split_product<DP, NB>(acc, s, v_s + (t & 1) * NB * L, lane);
    __syncthreads();
  }
  store_rows<DP>(o + base, acc, q0 + row0, S, D, 1.0f, lane);
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, void* o, int BH, int nh, int S, int D, float scale,
                       float rate, float keep_scale, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(tiled_fwd_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (S + kTileRows - 1) / kTileRows;
  tiled_fwd_mma_kernel<DP><<<BH * q_tiles, kTileThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, seed, static_cast<bf16*>(o), nh, S, D, q_tiles, scale, rate, keep_scale);
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
                     const int* __restrict__ seed_ptr, float* __restrict__ o, int nh, int S,
                     int D, int q_tiles, float scale, float rate, float keep_scale) {
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
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* bias_b = bias + (size_t)b * S;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;
  const int k_tiles = (S + kF32Rows - 1) / kF32Rows;

  for (int e = lane; e < R * D; e += 32) {
    const int r = e / D;
    q_w[e] = q0 + r < S ? q[base + (size_t)(q0 + r) * D + (e - r * D)] * scale : 0.0f;
  }
  __syncwarp();
  // the scores of the warp's R rows with key k0 + lane (-inf beyond S)
  auto scores = [&](int k0, float (&s)[R]) {
    const int j = k0 + lane;
    const float* kj = k_s + lane * ld;
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float kc = kj[c];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(q_w[r * D + c], kc, s[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = j < S ? s[r] + bias_b[j] : -INFINITY;
  };

  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
  for (int t = 0; t < k_tiles; ++t) {
    stage_f32(k_s, k + base, t * kF32Rows, kF32Rows, S, D, 1.0f, kF32Threads);
    __syncthreads();
    float s[R];
    scores(t * kF32Rows, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      l[r] = l[r] * expf(m[r] - m_new) + expf(s[r] - m_new);
      m[r] = m_new;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) l[r] = warp_sum(l[r]);

  float acc[R][kF32Cols] = {};
  for (int t = 0; t < k_tiles; ++t) {
    const int k0 = t * kF32Rows;
    stage_f32(k_s, k + base, k0, kF32Rows, S, D, 1.0f, kF32Threads);
    for (int e = threadIdx.x; e < kF32Rows * D; e += kF32Threads) {
      const int r = e / D;
      v_s[e] = k0 + r < S ? v[base + (size_t)k0 * D + e] : 0.0f;
    }
    __syncthreads();
    float s[R];
    scores(k0, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = expf(s[r] - m[r]) / l[r];
      p_w[r * kF32Rows + lane] =
          p * keep_of(drop, hbase, q0 + r, k0 + lane, S, rate, keep_scale);
    }
    __syncwarp();
    const int n = min(kF32Rows, S - k0);
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int u = 0; u < kF32Cols; ++u) {
        const int c = lane + 32 * u;
        if (c < D) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][u] = fmaf(p_w[r * kF32Rows + j], v_s[j * D + c], acc[r][u]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (q0 + r >= S) continue;
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      if (c < D) o[base + (size_t)(q0 + r) * D + c] = acc[r][u];
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, void* o, int BH, int nh, int S, int D, float scale,
                       float rate, float keep_scale, cudaStream_t stream) {
  const size_t bytes = f32_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(tiled_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (S + kF32Rows - 1) / kF32Rows;
  tiled_fwd_f32_kernel<<<BH * q_tiles, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, seed, static_cast<float*>(o), nh, S, D, q_tiles, scale, rate, keep_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, o (B, nh, S, D): bf16 when is_bf16 else f32, contiguous; S >= 1,
// 1 <= D <= 128, B nh ceil(S / 32) < 2^31.  scale = 1 / sqrt(D), rate and
// keep_scale = 1 / (1 - rate) already rounded to f32; seed (device int32) is
// read only when rate > 0.
int mmda_short_attn_tiled_fwd(const void* q, const void* k, const void* v, const float* bias,
                              const int* seed, void* o, int B, int nh, int S, int D,
                              int is_bf16, float scale, float rate, float keep_scale,
                              void* stream) {
  if (B < 1 || nh < 1 || S < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * nh;
  if (!is_bf16) {
    return (int)launch_f32(q, k, v, bias, seed, o, BH, nh, S, D, scale, rate, keep_scale, st);
  }
  if (D <= 16) return (int)launch_mma<16>(q, k, v, bias, seed, o, BH, nh, S, D, scale, rate,
                                           keep_scale, st);
  if (D <= 32) return (int)launch_mma<32>(q, k, v, bias, seed, o, BH, nh, S, D, scale, rate,
                                           keep_scale, st);
  if (D <= 64) return (int)launch_mma<64>(q, k, v, bias, seed, o, BH, nh, S, D, scale, rate,
                                           keep_scale, st);
  return (int)launch_mma<128>(q, k, v, bias, seed, o, BH, nh, S, D, scale, rate, keep_scale,
                              st);
}

}  // extern "C"
