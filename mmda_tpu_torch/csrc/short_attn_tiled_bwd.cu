// Short attention backward over query and key tiles, for Hopper (sm_90a),
// plain C entry point: the sequences that short_attn_bwd.cu's one block per
// (batch item, head) cannot hold (S > 128, or an f32 shape beyond its shared
// memory).
//
// Replaces mmda_tpu/ops/pallas/short_attention.py::_bwd_kernel (:82,
// launched by _bwd_call :143) at any S, with its arithmetic: from the saved
// q, k, v, bias and seed alone, per (batch item b, head h), all f32,
//
//   p    = exp(s - m) / l, s = (q * scale) k^T + bias[b]   recomputed, pre-dropout
//   keep = mask * f32(1 / (1 - rate))                      the forward's mask, rehashed
//   dp   = (do v^T) * keep;  r = rowsum(dp * p)
//   ds   = p * (dp - r)
//   dq   = (ds k) * scale;  dk = ds^T (q * scale);  dv = (p * keep)^T do
//
// each of dq, dk, dv rounded once to the input type; nothing rounded in
// between.
//
// Two kernels, so that no sum needs an atomic (short_tiled.cuh's tiles):
//   1. tiled_dq: a block per query tile.  A first pass over the key tiles
//      takes each row's m, l and r (r as sum dp exp(s - m) over l, rescaled
//      with l), a second forms p and ds exactly and accumulates dq = ds k.
//      It writes (m, l, r) per query to `stats` (B nh S x 3 f32).
//   2. tiled_dkv: a block per key tile streams the query tiles, recomputes
//      the transposed scores k q^T and v do^T, p from the saved m and l, the
//      mask, pd and ds from r, and accumulates dv = pd^T do and dk = ds^T q.
// Every sum runs in a fixed order: two launches give the same bits.
// bf16: the products on the tensor cores with short_attn_bwd.cu's arithmetic
// (q k^T and do v^T straight from the inputs, scale after the product, pd and
// ds as three bf16 terms); f32: f32 FMAs, q * scale first.
//
// What bounds it on the H100 at the long step's call (32, 12, 514, 64) bf16:
// the products, 9 S^2 D a head (q k^T and do v^T twice in the dq kernel and
// once in the dk/dv one, ds k, pd^T do, ds^T q; the three-term products
// counted once).

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
size_t dq_smem_bytes() {
  constexpr int NB = stream_rows<DP>();
  // q, do; 2 x (k, v); 2 x the key bias
  return ((size_t)2 * kTileRows + 4 * NB) * (DP + kRowPad) * sizeof(bf16) +
         2 * NB * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads)
tiled_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ seed_ptr, const bf16* __restrict__ d_out,
                    bf16* __restrict__ dq, float* __restrict__ stats, int nh, int S, int D,
                    int q_tiles, float scale, float rate, float keep_scale) {
  constexpr int NB = stream_rows<DP>();
  constexpr int N8 = NB / 8;
  constexpr int L = DP + kRowPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // (64, L)
  bf16* do_s = q_s + kTileRows * L;                // (64, L)
  bf16* k_s = do_s + kTileRows * L;                // 2 x (NB, L)
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
  load_rows<DP>(do_s, d_out + base, q0, kTileRows, S, D, kTileThreads);
  auto stage = [&](int t) {
    const int buf = t & 1;
    load_rows<DP>(k_s + buf * NB * L, k + base, t * NB, NB, S, D, kTileThreads);
    load_rows<DP>(v_s + buf * NB * L, v + base, t * NB, NB, S, D, kTileThreads);
    for (int j = threadIdx.x; j < NB; j += kTileThreads) {
      bias_s[buf * NB + j] = t * NB + j < S ? bias_b[t * NB + j] : -INFINITY;
    }
    mmda::flash::cp_async_commit();
  };
  // s = q k^T * scale + bias and dp = (do v^T) * keep of key tile t
  auto tile = [&](int t, float (&s)[N8][4], float (&dp)[N8][4]) {
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
    const int buf = t & 1;
    mmda::flash::mma_abt<DP, N8>(s, q_s, row0, k_s + buf * NB * L, lane);
    mmda::flash::mma_abt<DP, N8>(dp, do_s, row0, v_s + buf * NB * L, lane);
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = q0 + row0 + g + 8 * (e >> 1), jk = t * NB + 8 * j + t2 + (e & 1);
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bias_s[buf * NB + 8 * j + t2 + (e & 1)]);
        dp[j][e] *= keep_of(drop, hbase, i, jk, S, rate, keep_scale);
      }
    }
  };
  auto next = [&](int t) {
    if (t + 1 < k_tiles) {
      stage(t + 1);
      cp_async_wait_one();
    } else {
      mmda::flash::cp_async_wait_all();
    }
    __syncthreads();
  };

  // pass 1: m, l and r = sum dp p of the rows row0 + g and row0 + g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, rr[2] = {0.0f, 0.0f};
  stage(0);
  for (int t = 0; t < k_tiles; ++t) {
    next(t);
    float s[N8][4], dp[N8][4];
    tile(t, s, dp);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < N8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      const float m_new = fmaxf(m[hh], quad_max(tmax));
      const float alpha = expf(m[hh] - m_new);
      float sum = 0.0f, dsum = 0.0f;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float x = expf(s[j][e] - m_new);
          sum += x;
          dsum += dp[j][e] * x;
        }
      }
      l[hh] = l[hh] * alpha + sum;
      rr[hh] = rr[hh] * alpha + dsum;
      m[hh] = m_new;
    }
    __syncthreads();
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = quad_sum(l[hh]);
    rr[hh] = quad_sum(rr[hh]) / l[hh];
    const int i = q0 + row0 + g + 8 * hh;
    if (t2 == 0 && i < S) {
      float* st = stats + ((size_t)bh * S + i) * 3;
      st[0] = m[hh];
      st[1] = l[hh];
      st[2] = rr[hh];
    }
  }

  // pass 2: ds = p (dp - r) exactly, dq += ds k
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  stage(0);
  for (int t = 0; t < k_tiles; ++t) {
    next(t);
    float s[N8][4], dp[N8][4];
    tile(t, s, dp);
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]) / l[e >> 1];
        s[j][e] = p * (dp[j][e] - rr[e >> 1]);
      }
    }
    split_product<DP, NB>(acc, s, k_s + (t & 1) * NB * L, lane);
    __syncthreads();
  }
  store_rows<DP>(dq + base, acc, q0 + row0, S, D, scale, lane);
}

template <int DP>
size_t dkv_smem_bytes() {
  constexpr int NB = stream_rows<DP>();
  // k, v; 2 x (q, do); 2 x (m, l, r) per query
  return ((size_t)2 * kTileRows + 4 * NB) * (DP + kRowPad) * sizeof(bf16) +
         2 * 3 * NB * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads)
tiled_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, const bf16* __restrict__ d_out,
                     const float* __restrict__ stats, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int nh, int S, int D, int k_tiles, float scale,
                     float rate, float keep_scale) {
  constexpr int NB = stream_rows<DP>();
  constexpr int N8 = NB / 8;
  constexpr int L = DP + kRowPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // (64, L)
  bf16* v_s = k_s + kTileRows * L;                 // (64, L)
  bf16* q_s = v_s + kTileRows * L;                 // 2 x (NB, L)
  bf16* do_s = q_s + 2 * NB * L;                   // 2 x (NB, L)
  float* st_s = reinterpret_cast<float*>(do_s + 2 * NB * L);   // 2 x (NB, 3)

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x - bh * k_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* st_g = stats + (size_t)bh * S * 3;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int q_tiles = (S + NB - 1) / NB;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;
  // the key bias of the warp's keys k0 + row0 + g (+ 8): -inf beyond S
  float kb[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int jk = k0 + row0 + g + 8 * hh;
    kb[hh] = jk < S ? bias[(size_t)b * S + jk] : -INFINITY;
  }

  load_rows<DP>(k_s, k + base, k0, kTileRows, S, D, kTileThreads);
  load_rows<DP>(v_s, v + base, k0, kTileRows, S, D, kTileThreads);
  auto stage = [&](int t) {
    const int buf = t & 1;
    load_rows<DP>(q_s + buf * NB * L, q + base, t * NB, NB, S, D, kTileThreads);
    load_rows<DP>(do_s + buf * NB * L, d_out + base, t * NB, NB, S, D, kTileThreads);
    // queries beyond S: m = 0, l = 1, r = 0 (their p is 0 either way)
    for (int e = threadIdx.x; e < 3 * NB; e += kTileThreads) {
      const int i = t * NB + e / 3;
      st_s[buf * 3 * NB + e] = i < S ? st_g[(size_t)t * NB * 3 + e] : (e % 3 == 1 ? 1.0f : 0.0f);
    }
    mmda::flash::cp_async_commit();
  };

  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.0f;
  }
  stage(0);
  for (int t = 0; t < q_tiles; ++t) {
    if (t + 1 < q_tiles) {
      stage(t + 1);
      cp_async_wait_one();
    } else {
      mmda::flash::cp_async_wait_all();
    }
    __syncthreads();
    const int buf = t & 1;
    const bf16* qt = q_s + buf * NB * L;
    const bf16* dot = do_s + buf * NB * L;
    const float* st = st_s + buf * 3 * NB;
    // [j][e]: key k0 + row0 + g + 8 (e / 2), query t NB + 8 j + t2 + e % 2
    float sT[N8][4], dpT[N8][4];
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.0f;
    }
    mmda::flash::mma_abt<DP, N8>(sT, k_s, row0, qt, lane);
    mmda::flash::mma_abt<DP, N8>(dpT, v_s, row0, dot, lane);
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = 8 * j + t2 + (e & 1), i = t * NB + ii;
        const int jk = k0 + row0 + g + 8 * (e >> 1);
        float p = 0.0f;
        if (i < S) {
          const float sv = __fadd_rn(__fmul_rn(sT[j][e], scale), kb[e >> 1]);
          p = expf(sv - st[3 * ii]) / st[3 * ii + 1];
        }
        const float keep = keep_of(drop, hbase, i, jk, S, rate, keep_scale);
        sT[j][e] = p * keep;                                  // pd
        dpT[j][e] = p * (dpT[j][e] * keep - st[3 * ii + 2]);  // ds
      }
    }
    split_product<DP, NB>(acc_v, sT, dot, lane);
    split_product<DP, NB>(acc_k, dpT, qt, lane);
    __syncthreads();
  }
  store_rows<DP>(dv + base, acc_v, k0 + row0, S, D, 1.0f, lane);
  store_rows<DP>(dk + base, acc_k, k0 + row0, S, D, scale, lane);
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                       float* stats, int BH, int nh, int S, int D, float scale, float rate,
                       float keep_scale, cudaStream_t stream) {
  const size_t dq_bytes = dq_smem_bytes<DP>(), dkv_bytes = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      tiled_dq_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_dkv_mma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  tiled_dq_mma_kernel<DP><<<BH * tiles, kTileThreads, dq_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, seed, static_cast<const bf16*>(d_out), static_cast<bf16*>(dq), stats, nh, S, D,
      tiles, scale, rate, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_dkv_mma_kernel<DP><<<BH * tiles, kTileThreads, dkv_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, seed, static_cast<const bf16*>(d_out), stats, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), nh, S, D, tiles, scale, rate, keep_scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32

size_t dq_f32_smem_bytes(int D) {
  // k and v tiles (stride D + 1); per warp its 4 q * scale rows, 4 do rows
  // and 4 ds rows
  return (2 * (size_t)kF32Rows * (D + 1) +
          (size_t)kF32Warps * kF32RowsPerWarp * (2 * D + kF32Rows)) * sizeof(float);
}

__global__ void __launch_bounds__(kF32Threads)
tiled_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ seed_ptr, const float* __restrict__ d_out,
                    float* __restrict__ dq, float* __restrict__ stats, int nh, int S, int D,
                    int q_tiles, float scale, float rate, float keep_scale) {
  constexpr int R = kF32RowsPerWarp;
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* k_s = smem;                                  // (32, D + 1)
  float* v_s = k_s + kF32Rows * ld;                   // (32, D + 1)
  float* q_w = v_s + kF32Rows * ld + warp * R * (2 * D + kF32Rows);   // (R, D) q * scale
  float* do_w = q_w + R * D;                          // (R, D) do
  float* ds_w = do_w + R * D;                         // (R, 32) ds

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kF32Rows + warp * R;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* bias_b = bias + (size_t)b * S;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;
  const int k_tiles = (S + kF32Rows - 1) / kF32Rows;

  for (int e = lane; e < R * D; e += 32) {
    const int r = e / D;
    const bool ok = q0 + r < S;
    const size_t at = base + (size_t)(q0 + r) * D + (e - r * D);
    q_w[e] = ok ? q[at] * scale : 0.0f;
    do_w[e] = ok ? d_out[at] : 0.0f;
  }
  __syncwarp();
  // the warp's R rows with key k0 + lane: s (-inf beyond S) and dp
  auto tile = [&](int k0, float (&s)[R], float (&dp)[R]) {
    const int j = k0 + lane;
    const float* kj = k_s + lane * ld;
    const float* vj = v_s + lane * ld;
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float kc = kj[c], vc = vj[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(q_w[r * D + c], kc, s[r]);
        dp[r] = fmaf(do_w[r * D + c], vc, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[r] = j < S ? s[r] + bias_b[j] : -INFINITY;
      dp[r] = j < S ? dp[r] * keep_of(drop, hbase, q0 + r, j, S, rate, keep_scale) : 0.0f;
    }
  };
  auto stage = [&](int k0) {
    stage_f32(k_s, k + base, k0, kF32Rows, S, D, 1.0f, kF32Threads);
    stage_f32(v_s, v + base, k0, kF32Rows, S, D, 1.0f, kF32Threads);
    __syncthreads();
  };

  float m[R], l[R], rr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = rr[r] = 0.0f;
  }
  for (int t = 0; t < k_tiles; ++t) {
    stage(t * kF32Rows);
    float s[R], dp[R];
    tile(t * kF32Rows, s, dp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      const float alpha = expf(m[r] - m_new), x = expf(s[r] - m_new);
      l[r] = l[r] * alpha + x;
      rr[r] = rr[r] * alpha + dp[r] * x;
      m[r] = m_new;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] = warp_sum(l[r]);
    rr[r] = warp_sum(rr[r]) / l[r];
    if (lane == 0 && q0 + r < S) {
      float* st = stats + ((size_t)bh * S + q0 + r) * 3;
      st[0] = m[r];
      st[1] = l[r];
      st[2] = rr[r];
    }
  }

  float acc[R][kF32Cols] = {};
  for (int t = 0; t < k_tiles; ++t) {
    const int k0 = t * kF32Rows;
    stage(k0);
    float s[R], dp[R];
    tile(k0, s, dp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = expf(s[r] - m[r]) / l[r];
      ds_w[r * kF32Rows + lane] = p * (dp[r] - rr[r]);
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
            acc[r][u] = fmaf(ds_w[r * kF32Rows + j], k_s[j * ld + c], acc[r][u]);
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
      if (c < D) dq[base + (size_t)(q0 + r) * D + c] = acc[r][u] * scale;
    }
  }
}

size_t dkv_f32_smem_bytes(int D) {
  // the block's k and v rows, the streamed q * scale and do tiles (stride
  // D + 1), their (m, l, r); per warp its 4 keys' pd and ds rows
  return (4 * (size_t)kF32Rows * (D + 1) + 3 * kF32Rows +
          (size_t)kF32Warps * kF32RowsPerWarp * 2 * kF32Rows) * sizeof(float);
}

__global__ void __launch_bounds__(kF32Threads)
tiled_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, const float* __restrict__ d_out,
                     const float* __restrict__ stats, float* __restrict__ dk,
                     float* __restrict__ dv, int nh, int S, int D, int k_tiles, float scale,
                     float rate, float keep_scale) {
  constexpr int R = kF32RowsPerWarp;
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* k_s = smem;                     // (32, D + 1): the block's keys
  float* v_s = k_s + kF32Rows * ld;
  float* q_s = v_s + kF32Rows * ld;      // (32, D + 1): q * scale of a query tile
  float* do_s = q_s + kF32Rows * ld;
  float* st_s = do_s + kF32Rows * ld;    // (32, 3)
  float* pd_w = st_s + 3 * kF32Rows + warp * R * 2 * kF32Rows;   // (R, 32) pd
  float* ds_w = pd_w + R * kF32Rows;                             // (R, 32) ds

  const int bh = blockIdx.x / k_tiles;
  const int kb0 = (blockIdx.x - bh * k_tiles) * kF32Rows;
  const int k0 = kb0 + warp * R;          // the warp's keys
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;
  const int q_tiles = (S + kF32Rows - 1) / kF32Rows;
  float kb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) kb[r] = k0 + r < S ? bias[(size_t)b * S + k0 + r] : -INFINITY;

  stage_f32(k_s, k + base, kb0, kF32Rows, S, D, 1.0f, kF32Threads);
  stage_f32(v_s, v + base, kb0, kF32Rows, S, D, 1.0f, kF32Threads);
  float acc_k[R][kF32Cols] = {}, acc_v[R][kF32Cols] = {};
  for (int t = 0; t < q_tiles; ++t) {
    const int i0 = t * kF32Rows;
    stage_f32(q_s, q + base, i0, kF32Rows, S, D, scale, kF32Threads);
    stage_f32(do_s, d_out + base, i0, kF32Rows, S, D, 1.0f, kF32Threads);
    for (int e = threadIdx.x; e < 3 * kF32Rows; e += kF32Threads) {
      st_s[e] = i0 + e / 3 < S ? stats[((size_t)bh * S + i0) * 3 + e] : (e % 3 == 1 ? 1.0f : 0.0f);
    }
    __syncthreads();
    // the lane's query i0 + lane against the warp's R keys
    const int i = i0 + lane;
    const float* qi = q_s + lane * ld;
    const float* doi = do_s + lane * ld;
    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float qc = qi[c], dc = doi[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(qc, k_s[(warp * R + r) * ld + c], s[r]);
        dp[r] = fmaf(dc, v_s[(warp * R + r) * ld + c], dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = i < S ? expf(s[r] + kb[r] - st_s[3 * lane]) / st_s[3 * lane + 1] : 0.0f;
      const float keep = keep_of(drop, hbase, i, k0 + r, S, rate, keep_scale);
      pd_w[r * kF32Rows + lane] = p * keep;
      ds_w[r * kF32Rows + lane] = p * (dp[r] * keep - st_s[3 * lane + 2]);
    }
    __syncwarp();
    const int n = min(kF32Rows, S - i0);
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int u = 0; u < kF32Cols; ++u) {
        const int c = lane + 32 * u;
        if (c < D) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc_v[r][u] = fmaf(pd_w[r * kF32Rows + j], do_s[j * ld + c], acc_v[r][u]);
            acc_k[r][u] = fmaf(ds_w[r * kF32Rows + j], q_s[j * ld + c], acc_k[r][u]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (k0 + r >= S) continue;
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      if (c < D) {
        dk[base + (size_t)(k0 + r) * D + c] = acc_k[r][u];
        dv[base + (size_t)(k0 + r) * D + c] = acc_v[r][u];
      }
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                       float* stats, int BH, int nh, int S, int D, float scale, float rate,
                       float keep_scale, cudaStream_t stream) {
  const size_t dq_bytes = dq_f32_smem_bytes(D), dkv_bytes = dkv_f32_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(tiled_dq_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kF32Rows - 1) / kF32Rows;
  tiled_dq_f32_kernel<<<BH * tiles, kF32Threads, dq_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, seed, static_cast<const float*>(d_out), static_cast<float*>(dq), stats, nh, S, D,
      tiles, scale, rate, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_dkv_f32_kernel<<<BH * tiles, kF32Threads, dkv_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, seed, static_cast<const float*>(d_out), stats, static_cast<float*>(dk),
      static_cast<float*>(dv), nh, S, D, tiles, scale, rate, keep_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the dq kernel, then the dk/dv kernel, on `stream`; returns the
// first nonzero cudaError as an int (0 = ok).  q, k, v, d_out, dq, dk, dv
// (B, nh, S, D): bf16 when is_bf16 else f32, contiguous; S >= 1, 1 <= D <=
// 128, B nh ceil(S / 32) < 2^31.  stats: (B nh S x 3) f32 scratch the caller
// allocates.  scale, rate and keep_scale as for mmda_short_attn_tiled_fwd;
// seed (device int32) is read only when rate > 0.
int mmda_short_attn_tiled_bwd(const void* q, const void* k, const void* v, const float* bias,
                              const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                              float* stats, int B, int nh, int S, int D, int is_bf16,
                              float scale, float rate, float keep_scale, void* stream) {
  if (B < 1 || nh < 1 || S < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * nh;
  if (!is_bf16) {
    return (int)launch_f32(q, k, v, bias, seed, d_out, dq, dk, dv, stats, BH, nh, S, D, scale,
                           rate, keep_scale, st);
  }
#define MMDA_TILED_BWD(DP)                                                                 \
  return (int)launch_mma<DP>(q, k, v, bias, seed, d_out, dq, dk, dv, stats, BH, nh, S, D,  \
                             scale, rate, keep_scale, st)
  if (D <= 16) MMDA_TILED_BWD(16);
  if (D <= 32) MMDA_TILED_BWD(32);
  if (D <= 64) MMDA_TILED_BWD(64);
  MMDA_TILED_BWD(128);
#undef MMDA_TILED_BWD
}

}  // extern "C"
