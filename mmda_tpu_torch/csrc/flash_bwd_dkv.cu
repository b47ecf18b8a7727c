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
// q, k, v (BH, S, D) f32 or bf16; do (BH, S, D) f32, rounded to the operand
// type as it is staged; bias, lse, dsum (BH, S) f32.
//
// What bounds it on the H100: operations, 8 S^2 D per (batch, head) in four
// products, here as f32 FMAs.  One block per (batch * head, 64-key tile) owns
// its dk and dv rows and loops over the 64-row q tiles in a fixed order: no
// atomics, the same bits on every run.  The block computes its score tile
// transposed (keys down, queries across: k q^T and v do^T), so that the two
// accumulating products read it the way flash_fwd.cu reads its probabilities;
// the hash still takes (query, key).  Queries and keys beyond S get
// probability 0 and rows beyond S are not written, so nothing is padded.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace mmda::flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr,
                     const float* __restrict__ d_out, const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int k_tiles, float scale, float rate,
                     float keep_scale) {
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
  const uint32_t hbase = drop ? hash_base(seed_ptr, bh) : 0u;

  load_tile<T, D>(k_s, k + base, c0, S);
  load_tile<T, D>(v_s, v + base, c0, S);

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
    load_tile<T, D>(q_s, q + base, r0, S);
    load_tile<T, D>(do_s, d_out + base, r0, S);
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
        pd_s[(ty * 4 + i) * kLdp + r] = round_to<T>(pd);
        ds_s[(ty * 4 + i) * kLdp + r] = round_to<T>(prob * (g - dsum_s[r]));
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
  store_rows<T, D>(dk + base, c0, S, ty, tx, dk_acc);
  store_rows<T, D>(dv + base, c0, S, ty, tx, dv_acc);
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const float* bias, const int* seed, const float* d_out,
                         const float* lse, const float* dsum, void* dk, void* dv,
                         int BH, int S, float scale, float rate, float keep_scale,
                         cudaStream_t stream) {
    const size_t smem_bytes =
        (4 * tile_floats<D>() + 2 * kTile * kLdp + 2 * kTile) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return err;
    const int k_tiles = (S + kTile - 1) / kTile;
    flash_bwd_dkv_kernel<T, D><<<BH * k_tiles, kThreads, smem_bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bias, seed, d_out, lse, dsum,
        static_cast<T*>(dk), static_cast<T*>(dv), S, k_tiles, scale, rate,
        keep_scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, dk, dv: bf16 when is_bf16 else f32; d_out f32; everything
// contiguous and 16-byte aligned; D in {16, 32, 64, 128}.  rate and keep_scale
// = 1 / (1 - rate) already rounded to f32; seed (device int32) is read only
// when rate > 0.
int mmda_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const float* bias, const int* seed, const float* d_out,
                       const float* lse, const float* dsum, void* dk, void* dv,
                       int BH, int S, int D, int is_bf16, float scale, float rate,
                       float keep_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    return (int)dispatch_head_dim<Launch, __nv_bfloat16>(
        D, q, k, v, bias, seed, d_out, lse, dsum, dk, dv, BH, S, scale, rate,
        keep_scale, st);
  }
  return (int)dispatch_head_dim<Launch, float>(
      D, q, k, v, bias, seed, d_out, lse, dsum, dk, dv, BH, S, scale, rate,
      keep_scale, st);
}

}  // extern "C"
