// Short-sequence multi-head attention forward for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/short_attention.py::_fwd_kernel (:61,
// launched by _fwd_call :128), which holds one batch item's attention for
// all heads in VMEM.  Per (batch item b, head h), all f32:
//
//   s  = (q * scale) k^T + bias[b]         scale = f32(1 / sqrt(D)) on q first
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
// 4.9e8 f32 operations (7.3 us at 67 TFLOP/s): operations, by a little.  The
// S x S products are tiny (50 x 50 x 64), so the real limits are the
// latency of loading one head's k and v and the f32 FMA rate.
//
// What the design does about it.  The TPU kernel loops over the heads of one
// batch item in one program, so Mosaic can overlap one head's softmax with
// the next head's matmul.  Here one block per (b, h) (768 blocks at the
// flagship shape, several per SM) does the same through the scheduler:
//   * k (row stride D + 1, so the lanes' reads of 32 keys fall in 32 banks)
//     and v are staged in shared memory as f32;
//   * a warp owns a query row: its lanes hold the row's scores, at most 4
//     keys each (S <= 128), so the row max, the exponentials and the row sum
//     are register work and two warp reductions; the probabilities go
//     through a per-warp row of shared memory to the product with v, where
//     the lanes own output columns (at most 4 each, D <= 128);
//   * plain f32 FMAs, expf and IEEE division: no tensor cores (TF32 or bf16
//     products would change the numbers the JAX package computes).
// The whole (b, h) sits in one block's shared memory, so the kernel takes
// S <= 128 (the wrapper raises above that and names attn_impl="flash").
// Tensor-core products and a tile over query rows for longer S are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hash_dropout.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxS = 128;                 // keys of a row: 4 per lane
constexpr int kMaxD = 128;                 // columns of a row: 4 per lane
constexpr int kKeysPerLane = kMaxS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

size_t smem_bytes(int S, int D) {
  return ((size_t)S * (D + 1) + (size_t)S * D + (size_t)kWarps * (D + S)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
short_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ seed_ptr, T* __restrict__ o, int nh,
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
    k_s[r * ld + (e - r * D)] = to_f32(k[base + e]);
    v_s[e] = to_f32(v[base + e]);
  }
  __syncthreads();

  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;
  const float* bias_b = bias + (size_t)b * S;
  for (int i = warp; i < S; i += kWarps) {
    for (int c = lane; c < D; c += 32) q_row[c] = to_f32(q[base + (size_t)i * D + c]) * scale;
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
      o[base + (size_t)i * D + c] = from_f32<T>(acc);
    }
    __syncwarp();   // the next row overwrites q_row and p_row
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const int* seed, void* o, int BH, int nh, int S, int D, float scale,
                   float rate, float keep_scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      short_attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  short_attn_fwd_kernel<T><<<BH, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      seed, static_cast<T*>(o), nh, S, D, scale, rate, keep_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, o (B, nh, S, D): bf16 when is_bf16 else f32, contiguous;
// 1 <= S <= 128, 1 <= D <= 128.  scale = 1 / sqrt(D), rate and keep_scale =
// 1 / (1 - rate) already rounded to f32; seed (device int32) is read only
// when rate > 0.
int mmda_short_attn_fwd(const void* q, const void* k, const void* v, const float* bias,
                        const int* seed, void* o, int B, int nh, int S, int D,
                        int is_bf16, float scale, float rate, float keep_scale,
                        void* stream) {
  if (B < 1 || nh < 1 || S < 1 || S > kMaxS || D < 1 || D > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return (int)launch<__nv_bfloat16>(q, k, v, bias, seed, o, B * nh, nh, S, D, scale, rate,
                                      keep_scale, st);
  }
  return (int)launch<float>(q, k, v, bias, seed, o, B * nh, nh, S, D, scale, rate,
                            keep_scale, st);
}

}  // extern "C"
