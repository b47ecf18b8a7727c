// Blockwise (online-softmax) attention forward for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/attention.py::_flash_kernel (:72, launched by
// _flash_forward :490) and ::_flash_kernel_ragged (:289, launched at :451):
//
//   s   = (q k^T) * scale + bias[key]          f32 accumulation, scale after
//   m, l  running row max and running sum of the RAW probabilities exp(s - m)
//   acc += round(p * keep / (1 - rate)) v      the DROPPED ones, rounded to
//                                              the operand type, f32 sum
//   o = acc / l (f32),  lse = m + log(l)
//
// q, k, v (BH, S, D) f32 or bf16, bias (BH, S) f32 additive on keys, o
// (BH, S, D) f32, lse (BH, S) f32.  The keep mask is the positional hash of
// flash_common.cuh on the absolute (query, key) position, the flattened
// (batch, head) index and a seed read from device memory; the backward
// kernels regenerate it.  rate == 0 skips the mask (seed may be null).
//
// What bounds it on the H100: operations.  4 S^2 D per (batch, head) against
// 3 S D operands read and S D written: at S = 514, D = 64 about 250 operations
// per byte.  These products are f32 FMAs (67 TFLOP/s peak), so this first
// kernel sits far above the bound a tensor-core kernel would be held to.
//
// What the design does about it.  The TPU kernel has a gridded and a ragged
// twin, pads q, k, v and the bias to its 128-wide blocks and writes lse
// broadcast over lanes, all for Mosaic's aligned static slices.  Here one
// kernel serves any S: one block per (batch * head, 64-row q tile), a loop
// over 64-key tiles staged in shared memory (opted-in dynamic shared memory),
// keys beyond S get probability 0, rows beyond S are not written, lse is a
// plain (BH, S) array.  Each thread keeps a 4 x 4 piece of the score tile and
// 4 x D/16 of the accumulator in registers; the probabilities go through
// shared memory once per tile for the second product.  expf and logf, not the
// fast intrinsics.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace mmda::flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ seed_ptr, float* __restrict__ o,
                 float* __restrict__ lse, int S, int q_tiles, float scale,
                 float rate, float keep_scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DT = D / 16;
  float* q_s = smem;
  float* k_s = q_s + tile_floats<D>();
  float* v_s = k_s + tile_floats<D>();
  float* p_s = v_s + tile_floats<D>();
  float* bias_s = p_s + kTile * kLdp;

  const int bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = (size_t)bh * S * D;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? hash_base(seed_ptr, bh) : 0u;

  load_tile<T, D>(q_s, q + base, row0, S);

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) acc[i][jj] = 0.0f;
  }

  for (int c0 = 0; c0 < S; c0 += kTile) {
    load_tile<T, D>(k_s, k + base, c0, S);
    load_tile<T, D>(v_s, v + base, c0, S);
    load_row_values(bias_s, bias + (size_t)bh * S, c0, S);
    __syncthreads();

    float s[4][4];
    nt_product<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t row = (uint32_t)(row0 + ty * 4 + i);
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = c0 + c < S ? s[i][j] * scale + bias_s[c] : -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float tile_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = expf(s[i][j] - m_new);
        tile_sum += p;
        float pd = p;
        if (drop) {
          pd = attn_keep(hbase, row, (uint32_t)(c0 + c), rate) ? p * keep_scale : 0.0f;
        }
        p_s[(ty * 4 + i) * kLdp + c] = round_to<T>(pd);
      }
      l[i] = l[i] * alpha + row_sum(tile_sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    nn_accumulate<D>(p_s, v_s, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) acc[i][jj] = acc[i][jj] / l[i];
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < S) lse[(size_t)bh * S + r] = m[i] + logf(l[i]);
  }
  store_rows<float, D>(o + base, row0, S, ty, tx, acc);
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const float* bias, const int* seed, float* o, float* lse,
                         int BH, int S, float scale, float rate, float keep_scale,
                         cudaStream_t stream) {
    const size_t smem_bytes =
        (3 * tile_floats<D>() + kTile * kLdp + kTile) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return err;
    const int q_tiles = (S + kTile - 1) / kTile;
    flash_fwd_kernel<T, D><<<BH * q_tiles, kThreads, smem_bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bias, seed, o, lse, S, q_tiles, scale, rate,
        keep_scale);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v: bf16 when is_bf16 else f32, contiguous and 16-byte aligned; D in
// {16, 32, 64, 128}.  rate and keep_scale = 1 / (1 - rate) already rounded to
// f32; seed (device int32) is read only when rate > 0.
int mmda_flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                   const int* seed, float* o, float* lse, int BH, int S, int D,
                   int is_bf16, float scale, float rate, float keep_scale,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    return (int)dispatch_head_dim<Launch, __nv_bfloat16>(
        D, q, k, v, bias, seed, o, lse, BH, S, scale, rate, keep_scale, st);
  }
  return (int)dispatch_head_dim<Launch, float>(
      D, q, k, v, bias, seed, o, lse, BH, S, scale, rate, keep_scale, st);
}

}  // extern "C"
