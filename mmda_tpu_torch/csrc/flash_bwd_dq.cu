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
// q, k, v (BH, S, D) f32 or bf16; do (BH, S, D) f32, rounded to the operand
// type as it is staged (dsum was taken from the f32 do by the caller); bias,
// lse, dsum (BH, S) f32; dq in q's type.
//
// What bounds it on the H100: operations, 6 S^2 D per (batch, head) in three
// products, here as f32 FMAs.  Same design as flash_fwd.cu: one block per
// (batch * head, 64-row q tile) owns its dq rows and loops over the 64-key
// tiles; keys beyond S get probability 0, rows beyond S are not written; no
// padded copies of q, k, v or do, no lanes-broadcast statistics.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace mmda::flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ seed_ptr, const float* __restrict__ d_out,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    T* __restrict__ dq, int S, int q_tiles, float scale, float rate,
                    float keep_scale) {
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
  const uint32_t hbase = drop ? hash_base(seed_ptr, bh) : 0u;

  load_tile<T, D>(q_s, q + base, row0, S);
  load_tile<T, D>(do_s, d_out + base, row0, S);

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
    load_tile<T, D>(k_s, k + base, c0, S);
    load_tile<T, D>(v_s, v + base, c0, S);
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
        ds_s[(ty * 4 + i) * kLdp + c] = round_to<T>(prob * (g - dsum_r[i]));
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
  store_rows<T, D>(dq + base, row0, S, ty, tx, acc);
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const float* bias, const int* seed, const float* d_out,
                         const float* lse, const float* dsum, void* dq, int BH,
                         int S, float scale, float rate, float keep_scale,
                         cudaStream_t stream) {
    const size_t smem_bytes =
        (4 * tile_floats<D>() + kTile * kLdp + kTile) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return err;
    const int q_tiles = (S + kTile - 1) / kTile;
    flash_bwd_dq_kernel<T, D><<<BH * q_tiles, kThreads, smem_bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bias, seed, d_out, lse, dsum,
        static_cast<T*>(dq), S, q_tiles, scale, rate, keep_scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, dq: bf16 when is_bf16 else f32; d_out f32; everything contiguous
// and 16-byte aligned; D in {16, 32, 64, 128}.  rate and keep_scale =
// 1 / (1 - rate) already rounded to f32; seed (device int32) is read only when
// rate > 0.
int mmda_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const float* bias, const int* seed, const float* d_out,
                      const float* lse, const float* dsum, void* dq, int BH, int S,
                      int D, int is_bf16, float scale, float rate, float keep_scale,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    return (int)dispatch_head_dim<Launch, __nv_bfloat16>(
        D, q, k, v, bias, seed, d_out, lse, dsum, dq, BH, S, scale, rate,
        keep_scale, st);
  }
  return (int)dispatch_head_dim<Launch, float>(
      D, q, k, v, bias, seed, d_out, lse, dsum, dq, BH, S, scale, rate, keep_scale,
      st);
}

}  // extern "C"
