// Blockwise attention backward, the dk/dv pass, for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/attention.py::_bwd_dkv_kernel (:172, launched
// by _flash_backward :585) and ::_bwd_dkv_kernel_ragged (:360, launched at
// :670):
//
//   p  = exp((q k^T) * scale + bias - lse)
//   pd = p * keep / (1 - rate);   dv = round(pd)^T do
//   dp = (do v^T) * keep / (1 - rate);   ds = p * (dp - dsum)
//   dk = scale * (round(ds)^T q)             dk, dv rounded to k's, v's type
//
// q, k, v, do (BH, S, D) in the operand type, f32 or bf16 (do was rounded to
// it once by the caller; dsum was taken from the f32 do); bias, lse, dsum
// (BH, S) f32.
//
// What bounds it on the H100: operations, 8 S^2 D per (batch, head) in four
// products, against the 989 TFLOP/s bf16 dense tensor-core peak.  One block
// per (batch * head, 64-key tile) owns its dk and dv rows and loops over the
// 64-row q tiles in a fixed order: no atomics, the same bits on every run.
// Queries and keys beyond S get probability 0 and rows beyond S are not
// written, so nothing is padded.  The block computes its score tile
// transposed (keys down, queries across: k q^T and v do^T); the hash still
// takes (query, key).
//
// bf16 (flash_mma.cuh): every product on the tensor cores, mma.sync m16n8k16
// with bf16 operands and f32 accumulators.  k, v and a two-stage ring of
// (q, do, lse, dsum) tiles lie in shared memory as bf16, filled by cp.async:
// the next q tile loads while this one is multiplied, one barrier a tile.
// Each warp owns 16 keys and steps over the q tile 32 queries at a time: its
// 16 x 32 blocks of k q^T and v do^T go into accumulator fragments; p, the
// keep mask and ds are formed there, rounded to bf16 (the rounding site) and
// used directly as the A operands of dv += pd^T do and dk += ds^T q, whose B
// operands (do, q) come from shared memory through ldmatrix.trans.  In the
// accumulator of n8 tile j of the step at query q0, lane l holds keys
// c0 + 16 w + l / 4 (and + 8) and queries r0 + q0 + 8 j + 2 (l % 4) (and + 1):
// the (query, key) the hash is drawn at.  32-query steps keep the score
// blocks at 32 registers a thread beside the 64 of the dk, dv accumulators,
// so three blocks fit on an SM.  At D = 128 two warps share a key group, each
// accumulating half of dk's and dv's columns (8 warps: 64 accumulator
// registers a thread instead of 128), and both form the same score blocks.
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
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const int* __restrict__ seed_ptr,
                         const float* __restrict__ d_out, const float* __restrict__ lse,
                         const float* __restrict__ dsum, float* __restrict__ dk,
                         float* __restrict__ dv, HeadLayout heads, int S, int k_tiles, float scale,
                         float rate, float keep_scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DT = D / 16;
  float* k_s = smem;
  float* v_s = k_s + tile_floats<D>();
  float* q_s = v_s + tile_floats<D>();
  float* do_s = q_s + tile_floats<D>();
  float* pd_s = do_s + tile_floats<D>();
  float* ds_s = pd_s + kTile * kLdp;
  float* lse_s = ds_s + kTile * kLdp;
  float* dsum_s = lse_s + kTile;

  const int bh = blockIdx.x / k_tiles;
  const int c0 = (blockIdx.x % k_tiles) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = (size_t)bh * S * D;
  const size_t vec_base = (size_t)bh * S;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? hash_base(seed_ptr, global_bh(bh, heads)) : 0u;

  load_tile<D>(k_s, k + base, c0, S);
  load_tile<D>(v_s, v + base, c0, S);

  float bias_r[4], dk_acc[4][DT], dv_acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    bias_r[i] = c < S ? bias[vec_base + c] : 0.0f;
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) {
      dk_acc[i][jj] = 0.0f;
      dv_acc[i][jj] = 0.0f;
    }
  }

  for (int r0 = 0; r0 < S; r0 += kTile) {
    load_tile<D>(q_s, q + base, r0, S);
    load_tile<D>(do_s, d_out + base, r0, S);
    load_row_values(lse_s, lse + vec_base, r0, S);
    load_row_values(dsum_s, dsum + vec_base, r0, S);
    __syncthreads();

    // transposed tiles: entry [i][j] is key c0 + ty*4 + i, query r0 + tx + 16j
    float p[4][4], dp[4][4];
    nt_product<D>(k_s, q_s, ty, tx, p);
    nt_product<D>(v_s, do_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float prob = (col < S && r0 + r < S)
            ? expf(p[i][j] * scale + bias_r[i] - lse_s[r]) : 0.0f;
        float pd = prob;
        float g = dp[i][j];
        if (drop) {
          const bool keep = attn_keep(hbase, (uint32_t)(r0 + r), (uint32_t)col, rate);
          pd = keep ? prob * keep_scale : 0.0f;
          g = keep ? g * keep_scale : 0.0f;
        }
        pd_s[(ty * 4 + i) * kLdp + r] = pd;
        ds_s[(ty * 4 + i) * kLdp + r] = prob * (g - dsum_s[r]);
      }
    }
    __syncthreads();
    nn_accumulate<D>(pd_s, do_s, ty, tx, dv_acc);
    nn_accumulate<D>(ds_s, q_s, ty, tx, dk_acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) dk_acc[i][jj] *= scale;
  }
  store_rows<D>(dk + base, c0, S, ty, tx, dk_acc);
  store_rows<D>(dv + base, c0, S, ty, tx, dv_acc);
}

// ----------------------------------------------------------------- bf16

template <int D>
struct DkvGeometry {
  static constexpr int kSplit = D == 128 ? 2 : 1;   // warps sharing a key group
  static constexpr int kThreads = 32 * 4 * kSplit;
  static constexpr int kCols = D / kSplit;          // dk, dv columns of a warp
  static constexpr int kQStep = 32;                 // queries of a score block
  static constexpr int kTileElems = kTile * (D + kRowPad);
  // k, v, then two stages of (q, do) tiles; two stages of (lse, dsum)
  static constexpr size_t kSmemBytes =
      6 * kTileElems * sizeof(bf16) + 4 * kTile * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(DkvGeometry<D>::kThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         const int* __restrict__ seed_ptr, const bf16* __restrict__ d_out,
                         const float* __restrict__ lse, const float* __restrict__ dsum,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, HeadLayout heads, int S,
                         int k_tiles,
                         float scale, float rate, float keep_scale) {
  using G = DkvGeometry<D>;
  constexpr int TE = G::kTileElems;
  constexpr int L = D + kRowPad;
  constexpr int N8 = G::kQStep / 8;      // n8 tiles of a score block
  constexpr int K16 = G::kQStep / 16;    // k16 slices of it as an operand
  constexpr int CN8 = G::kCols / 8;      // n8 tiles of the warp's dk, dv columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + TE;
  bf16* qdo_s = v_s + TE;                                  // stage s: q, do at 2s, 2s + 1
  float* vec_s = reinterpret_cast<float*>(qdo_s + 4 * TE);  // stage s: lse, dsum

  const int bh = blockIdx.x / k_tiles;
  const int c0 = (blockIdx.x % k_tiles) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int key_row = 16 * (warp & 3);          // the warp's keys in the tile
  const int col0 = (warp >> 2) * G::kCols;      // its dk, dv columns
  const int key0 = c0 + key_row + (lane >> 2);  // the lane's keys: key0, key0 + 8
  const int t2 = 2 * (lane & 3);
  const size_t base = (size_t)bh * S * D;
  const size_t vec_base = (size_t)bh * S;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? hash_base(seed_ptr, global_bh(bh, heads)) : 0u;
  const int q_tiles = (S + kTile - 1) / kTile;

  auto load_stage = [&](int s, int r0) {
    async_tile<kTile, D, G::kThreads>(qdo_s + 2 * s * TE, q + base, r0, S);
    async_tile<kTile, D, G::kThreads>(qdo_s + (2 * s + 1) * TE, d_out + base, r0, S);
    async_vec<kTile, G::kThreads>(vec_s + 2 * s * kTile, lse + vec_base, r0, S);
    async_vec<kTile, G::kThreads>(vec_s + (2 * s + 1) * kTile, dsum + vec_base, r0, S);
  };
  async_tile<kTile, D, G::kThreads>(k_s, k + base, c0, S);
  async_tile<kTile, D, G::kThreads>(v_s, v + base, c0, S);
  load_stage(0, 0);
  cp_async_commit();

  // per key: the bias in log2 units (-inf beyond S, which makes p 0) and the
  // key's share of the hash mix
  float bias_l2[2];
  uint32_t hash_k[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    bias_l2[h] = key < S ? bias[vec_base + key] * kLog2e : -INFINITY;
    hash_k[h] = (uint32_t)key * kHashCol + hbase;
  }
  const float scale_l2 = scale * kLog2e;
  const uint32_t keep_min = keep_threshold(rate);
  float dk_acc[CN8][4], dv_acc[CN8][4];
#pragma unroll
  for (int j = 0; j < CN8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.0f;
      dv_acc[j][e] = 0.0f;
    }
  }

  for (int it = 0; it < q_tiles; ++it) {
    // tile it has arrived, and every warp is done with the stage it replaces
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < q_tiles) {
      load_stage((it + 1) & 1, (it + 1) * kTile);
      cp_async_commit();
    }
    const int r0 = it * kTile;
    const bf16* q_s = qdo_s + 2 * (it & 1) * TE;
    const bf16* do_s = q_s + TE;
    const float* lse_s = vec_s + 2 * (it & 1) * kTile;
    const float* dsum_s = lse_s + kTile;

    for (int q0 = 0; q0 < kTile; q0 += G::kQStep) {
      // transposed blocks: [j][e] is key key0 + 8 (e / 2), query
      // r0 + q0 + 8 j + t2 + e % 2
      const bf16* qq_s = q_s + q0 * L;
      const bf16* dq_s = do_s + q0 * L;
      float st[N8][4], dpt[N8][4];
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.0f;
          dpt[j][e] = 0.0f;
        }
      }
      mma_abt<D, N8>(st, k_s, key_row, qq_s, lane);
      mma_abt<D, N8>(dpt, v_s, key_row, dq_s, lane);
      const uint32_t hash_q = (uint32_t)(r0 + q0 + t2) * kHashRow;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        // the lane's two queries r0 + q0 + 8 j + t2 + o: lse in log2 units
        // (+inf beyond S, which makes p 0) and dsum
        const int c = q0 + 8 * j + t2;
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dsum2 = *reinterpret_cast<const float2*>(dsum_s + c);
        const int q_left = S - (r0 + c);
        const float lse_l2[2] = {q_left > 0 ? lse2.x * kLog2e : INFINITY,
                                 q_left > 1 ? lse2.y * kLog2e : INFINITY};
        const float dsum_q[2] = {dsum2.x, dsum2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, o = e & 1;
          const float prob = exp2_ftz(fmaf(st[j][e], scale_l2, bias_l2[h] - lse_l2[o]));
          float pd = prob;
          float g = dpt[j][e];
          if (drop) {
            // attn_keep at (query r0 + c + o, key key0 + 8 h)
            const bool keep =
                hash_bits(hash_q + hash_k[h] + (uint32_t)(8 * j + o) * kHashRow) >= keep_min;
            pd = keep ? prob * keep_scale : 0.0f;
            g = keep ? g * keep_scale : 0.0f;
          }
          st[j][e] = pd;
          dpt[j][e] = prob * (g - dsum_q[o]);
        }
      }
      uint32_t pd_a[K16][4], ds_a[K16][4];
      a_from_c<K16>(pd_a, st);
      a_from_c<K16>(ds_a, dpt);
      mma_pb<D, K16, CN8>(dv_acc, pd_a, dq_s, col0, lane);
      mma_pb<D, K16, CN8>(dk_acc, ds_a, qq_s, col0, lane);
    }
  }

  store_acc<D, CN8>(dk + base, dk_acc, c0 + key_row, col0, S, scale, lane);
  store_acc<D, CN8>(dv + base, dv_acc, c0 + key_row, col0, S, 1.0f, lane);
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const float* bias, const int* seed, const void* d_out,
                         const float* lse, const float* dsum, void* dk, void* dv,
                         int BH, HeadLayout heads, int S, float scale, float rate,
                         float keep_scale,
                         cudaStream_t stream) {
    const int k_tiles = (S + kTile - 1) / kTile;
    if constexpr (sizeof(T) == 2) {
      using G = DkvGeometry<D>;
      cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)G::kSmemBytes);
      if (err != cudaSuccess) return err;
      flash_bwd_dkv_mma_kernel<D><<<BH * k_tiles, G::kThreads, G::kSmemBytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), bias, seed, static_cast<const bf16*>(d_out), lse,
          dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, S, k_tiles, scale, rate,
          keep_scale);
    } else {
      const size_t smem_bytes =
          (4 * tile_floats<D>() + 2 * kTile * kLdp + 2 * kTile) * sizeof(float);
      cudaError_t err = cudaFuncSetAttribute(
          flash_bwd_dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem_bytes);
      if (err != cudaSuccess) return err;
      flash_bwd_dkv_f32_kernel<D><<<BH * k_tiles, kThreads, smem_bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), bias, seed, static_cast<const float*>(d_out), lse,
          dsum, static_cast<float*>(dk), static_cast<float*>(dv), heads, S, k_tiles, scale, rate,
          keep_scale);
    }
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, d_out, dk, dv: bf16 when is_bf16 else f32; everything contiguous
// and 16-byte aligned; D in {16, 32, 64, 128}.  rate and keep_scale =
// 1 / (1 - rate) already rounded to f32; seed (device int32) is read only
// when rate > 0.  The BH axis holds heads head0 .. head0 + heads_local - 1
// of heads_total per batch item (`HeadLayout`); (1, 1, 0) for all of them.
int mmda_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const float* bias, const int* seed, const void* d_out,
                       const float* lse, const float* dsum, void* dk, void* dv,
                       int BH, int S, int D, int is_bf16, int heads_local,
                       int heads_total, int head0, float scale, float rate,
                       float keep_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || S < 1 || !valid_heads(BH, heads_local, heads_total, head0)) {
    return (int)cudaErrorInvalidValue;
  }
  const HeadLayout heads{heads_local, heads_total, head0};
  if (is_bf16) {
    return (int)dispatch_head_dim<Launch, __nv_bfloat16>(
        D, q, k, v, bias, seed, d_out, lse, dsum, dk, dv, BH, heads, S, scale, rate,
        keep_scale, st);
  }
  return (int)dispatch_head_dim<Launch, float>(
      D, q, k, v, bias, seed, d_out, lse, dsum, dk, dv, BH, heads, S, scale, rate,
      keep_scale, st);
}

}  // extern "C"
