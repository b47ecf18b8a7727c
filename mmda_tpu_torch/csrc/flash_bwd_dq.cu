// Blockwise attention backward, the dq pass, for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/attention.py::_bwd_dq_kernel (:136, launched by
// _flash_backward :567) and ::_bwd_dq_kernel_ragged (:327, launched at :644):
//
//   p  = exp((q k^T) * scale + bias - lse)      the true probabilities, from
//                                               the forward's saved lse
//   dp = (do v^T) * keep / (1 - rate)           the regenerated keep mask
//   ds = p * (dp - dsum)                        dsum = rowsum(do * o), f32
//   dq = scale * (round(ds) k)                  rounded to q's type
//
// q, k, v, do (BH, S, D) in the operand type, f32 or bf16 (do was rounded to
// it once by the caller; dsum was taken from the f32 do); bias, lse, dsum
// (BH, S) f32; dq in q's type.
//
// What bounds it on the H100: operations, 6 S^2 D per (batch, head) in three
// products, against the 989 TFLOP/s bf16 dense tensor-core peak.  One block
// per (batch * head, 64-row q tile) owns its dq rows and loops over the
// 64-key tiles; keys beyond S get probability 0, rows beyond S are not
// written; no padded copies of q, k, v or do.
//
// bf16 (flash_mma.cuh): every product on the tensor cores, mma.sync m16n8k16
// with bf16 operands and f32 accumulators.  q and do lie in shared memory as
// bf16 with a two-stage ring of (k, v, bias) tiles, filled by cp.async: the
// next key tile loads while this one is multiplied, one barrier a tile.  Each
// warp owns 16 query rows and steps over the key tile 32 keys at a time: its
// 16 x 32 blocks of q k^T and do v^T go into accumulator fragments; p, the
// keep mask and ds are formed there, rounded to bf16 (the rounding site) and
// used directly as the A operand of dq += ds k, whose B operand (k) comes
// from shared memory through ldmatrix.trans.  In the accumulator of n8 tile
// j of the step at key k0, lane l holds queries row0 + 16 w + l / 4 (and + 8)
// and keys c0 + k0 + 8 j + 2 (l % 4) (and + 1): the (query, key) the hash is
// drawn at.  32-key steps keep the score blocks at 32 registers a thread, so
// three blocks fit on an SM; at D = 128 the dq accumulators take 64.
//
// f32: the FMA design of flash_common.cuh (f32 tiles, 4 x 4 register tiles),
// as a TF32 tensor-core product cannot meet the f32 tolerance.

#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace mmda::flash;
using mmda::hash_bits;
using mmda::keep_threshold;

// ------------------------------------------------------------------ f32

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        const int* __restrict__ seed_ptr, const float* __restrict__ d_out,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        float* __restrict__ dq, HeadLayout heads, int S, int q_tiles, float scale,
                        float rate, float keep_scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DT = D / 16;
  float* q_s = smem;
  float* do_s = q_s + tile_floats<D>();
  float* k_s = do_s + tile_floats<D>();
  float* v_s = k_s + tile_floats<D>();
  float* ds_s = v_s + tile_floats<D>();
  float* bias_s = ds_s + kTile * kLdp;

  const int bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = (size_t)bh * S * D;
  const size_t vec_base = (size_t)bh * S;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? hash_base(seed_ptr, global_bh(bh, heads)) : 0u;

  load_tile<D>(q_s, q + base, row0, S);
  load_tile<D>(do_s, d_out + base, row0, S);

  float lse_r[4], dsum_r[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    lse_r[i] = r < S ? lse[vec_base + r] : 0.0f;
    dsum_r[i] = r < S ? dsum[vec_base + r] : 0.0f;
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) acc[i][jj] = 0.0f;
  }

  for (int c0 = 0; c0 < S; c0 += kTile) {
    load_tile<D>(k_s, k + base, c0, S);
    load_tile<D>(v_s, v + base, c0, S);
    load_row_values(bias_s, bias + vec_base, c0, S);
    __syncthreads();

    float p[4][4], dp[4][4];
    nt_product<D>(q_s, k_s, ty, tx, p);
    nt_product<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t row = (uint32_t)(row0 + ty * 4 + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float prob =
            c0 + c < S ? expf(p[i][j] * scale + bias_s[c] - lse_r[i]) : 0.0f;
        float g = dp[i][j];
        if (drop) {
          g = attn_keep(hbase, row, (uint32_t)(c0 + c), rate) ? g * keep_scale : 0.0f;
        }
        ds_s[(ty * 4 + i) * kLdp + c] = prob * (g - dsum_r[i]);
      }
    }
    __syncthreads();
    nn_accumulate<D>(ds_s, k_s, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) acc[i][jj] *= scale;
  }
  store_rows<D>(dq + base, row0, S, ty, tx, acc);
}

// ----------------------------------------------------------------- bf16

constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows
constexpr int kKeyStep = 32;       // keys of a score block

template <int D>
struct DqGeometry {
  static constexpr int kTileElems = kTile * (D + kRowPad);
  // q, do, then two stages of (k, v) tiles; two stages of bias
  static constexpr size_t kSmemBytes =
      6 * kTileElems * sizeof(bf16) + 2 * kTile * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const int* __restrict__ seed_ptr, const bf16* __restrict__ d_out,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        bf16* __restrict__ dq, HeadLayout heads, int S, int q_tiles, float scale,
                        float rate,
                        float keep_scale) {
  constexpr int TE = DqGeometry<D>::kTileElems;
  constexpr int L = D + kRowPad;
  constexpr int N8 = kKeyStep / 8;    // n8 tiles of a score block
  constexpr int K16 = kKeyStep / 16;  // k16 slices of it as an operand
  constexpr int DN8 = D / 8;          // n8 tiles of dq's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + TE;
  bf16* kv_s = do_s + TE;                                  // stage s: k, v at 2s, 2s + 1
  float* bias_s = reinterpret_cast<float*>(kv_s + 4 * TE);  // stage s at s * kTile

  const int bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * kTile;
  const int lane = threadIdx.x & 31;
  const int q_row = 16 * (threadIdx.x >> 5);       // the warp's rows in the tile
  const int query0 = row0 + q_row + (lane >> 2);   // the lane's rows: query0, query0 + 8
  const int t2 = 2 * (lane & 3);
  const size_t base = (size_t)bh * S * D;
  const size_t vec_base = (size_t)bh * S;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? hash_base(seed_ptr, global_bh(bh, heads)) : 0u;
  const int k_tiles = (S + kTile - 1) / kTile;

  auto load_stage = [&](int s, int c0) {
    async_tile<kTile, D, kMmaThreads>(kv_s + 2 * s * TE, k + base, c0, S);
    async_tile<kTile, D, kMmaThreads>(kv_s + (2 * s + 1) * TE, v + base, c0, S);
    async_vec<kTile, kMmaThreads>(bias_s + s * kTile, bias + vec_base, c0, S);
  };
  async_tile<kTile, D, kMmaThreads>(q_s, q + base, row0, S);
  async_tile<kTile, D, kMmaThreads>(do_s, d_out + base, row0, S);
  load_stage(0, 0);
  cp_async_commit();

  // per query: lse in log2 units, dsum, the query's share of the hash mix
  float lse_l2[2], dsum_r[2];
  uint32_t hash_q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = query0 + 8 * h;
    lse_l2[h] = r < S ? lse[vec_base + r] * kLog2e : 0.0f;
    dsum_r[h] = r < S ? dsum[vec_base + r] : 0.0f;
    hash_q[h] = (uint32_t)r * kHashRow + hbase;
  }
  const float scale_l2 = scale * kLog2e;
  const uint32_t keep_min = keep_threshold(rate);
  float acc[DN8][4];
#pragma unroll
  for (int j = 0; j < DN8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }

  for (int it = 0; it < k_tiles; ++it) {
    // tile it has arrived, and every warp is done with the stage it replaces
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < k_tiles) {
      load_stage((it + 1) & 1, (it + 1) * kTile);
      cp_async_commit();
    }
    const int c0 = it * kTile;
    const bf16* k_s = kv_s + 2 * (it & 1) * TE;
    const bf16* v_s = k_s + TE;
    const float* b_s = bias_s + (it & 1) * kTile;

    for (int k0 = 0; k0 < kTile; k0 += kKeyStep) {
      // [j][e] is query query0 + 8 (e / 2), key c0 + k0 + 8 j + t2 + e % 2
      const bf16* kk_s = k_s + k0 * L;
      float s[N8][4], dp[N8][4];
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.0f;
          dp[j][e] = 0.0f;
        }
      }
      mma_abt<D, N8>(s, q_s, q_row, kk_s, lane);
      mma_abt<D, N8>(dp, do_s, q_row, v_s + k0 * L, lane);
      const uint32_t hash_k = (uint32_t)(c0 + k0 + t2) * kHashCol;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        // the lane's two keys c0 + c + o: the bias in log2 units (-inf beyond
        // S, which makes p 0)
        const int c = k0 + 8 * j + t2;
        const float2 bias2 = *reinterpret_cast<const float2*>(b_s + c);
        const int k_left = S - (c0 + c);
        const float bias_l2[2] = {k_left > 0 ? bias2.x * kLog2e : -INFINITY,
                                  k_left > 1 ? bias2.y * kLog2e : -INFINITY};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, o = e & 1;
          const float prob = exp2_ftz(fmaf(s[j][e], scale_l2, bias_l2[o] - lse_l2[h]));
          float g = dp[j][e];
          if (drop) {
            // attn_keep at (query query0 + 8 h, key c0 + c + o)
            const bool keep =
                hash_bits(hash_q[h] + hash_k + (uint32_t)(8 * j + o) * kHashCol) >= keep_min;
            g = keep ? g * keep_scale : 0.0f;
          }
          s[j][e] = prob * (g - dsum_r[h]);
        }
      }
      uint32_t ds_a[K16][4];
      a_from_c<K16>(ds_a, s);
      mma_pb<D, K16, DN8>(acc, ds_a, kk_s, 0, lane);
    }
  }

  store_acc<D, DN8>(dq + base, acc, row0 + q_row, 0, S, scale, lane);
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const float* bias, const int* seed, const void* d_out,
                         const float* lse, const float* dsum, void* dq, int BH,
                         HeadLayout heads, int S, float scale, float rate, float keep_scale,
                         cudaStream_t stream) {
    const int q_tiles = (S + kTile - 1) / kTile;
    if constexpr (sizeof(T) == 2) {
      constexpr size_t smem_bytes = DqGeometry<D>::kSmemBytes;
      cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem_bytes);
      if (err != cudaSuccess) return err;
      flash_bwd_dq_mma_kernel<D><<<BH * q_tiles, kMmaThreads, smem_bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), bias, seed, static_cast<const bf16*>(d_out), lse,
          dsum, static_cast<bf16*>(dq), heads, S, q_tiles, scale, rate, keep_scale);
    } else {
      const size_t smem_bytes =
          (4 * tile_floats<D>() + kTile * kLdp + kTile) * sizeof(float);
      cudaError_t err = cudaFuncSetAttribute(
          flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem_bytes);
      if (err != cudaSuccess) return err;
      flash_bwd_dq_f32_kernel<D><<<BH * q_tiles, kThreads, smem_bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), bias, seed, static_cast<const float*>(d_out), lse,
          dsum, static_cast<float*>(dq), heads, S, q_tiles, scale, rate, keep_scale);
    }
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, d_out, dq: bf16 when is_bf16 else f32; everything contiguous and
// 16-byte aligned; D in {16, 32, 64, 128}.  rate and keep_scale =
// 1 / (1 - rate) already rounded to f32; seed (device int32) is read only when
// rate > 0.  The BH axis holds heads head0 .. head0 + heads_local - 1 of
// heads_total per batch item (`HeadLayout`); (1, 1, 0) for all of them.
int mmda_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const float* bias, const int* seed, const void* d_out,
                      const float* lse, const float* dsum, void* dq, int BH, int S,
                      int D, int is_bf16, int heads_local, int heads_total,
                      int head0, float scale, float rate, float keep_scale,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || S < 1 || !valid_heads(BH, heads_local, heads_total, head0)) {
    return (int)cudaErrorInvalidValue;
  }
  const HeadLayout heads{heads_local, heads_total, head0};
  if (is_bf16) {
    return (int)dispatch_head_dim<Launch, __nv_bfloat16>(
        D, q, k, v, bias, seed, d_out, lse, dsum, dq, BH, heads, S, scale, rate, keep_scale,
        st);
  }
  return (int)dispatch_head_dim<Launch, float>(
      D, q, k, v, bias, seed, d_out, lse, dsum, dq, BH, heads, S, scale, rate, keep_scale,
      st);
}

}  // extern "C"
