// Short-sequence multi-head attention backward for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/short_attention.py::_bwd_kernel (:82,
// launched by _bwd_call :143).  From the saved q, k, v, bias and seed alone
// (no S x S tensor was kept), per (batch item b, head h), all f32:
//
//   p    = softmax((q * scale) k^T + bias[b])      recomputed, pre-dropout
//   keep = mask * f32(1 / (1 - rate))              the forward's mask, rehashed
//   pd   = p * keep;  dv = pd^T do
//   dp   = (do v^T) * keep
//   ds   = p * (dp - rowsum(dp * p))
//   dq   = (ds k) * scale;  dk = ds^T (q * scale)
//
// each of dq, dk, dv rounded once to the input type; do (the incoming
// gradient of o, in the input type) widened to f32.  Nothing is rounded in
// between, unlike the flash kernels.
//
// What bounds it on the H100.  At (64, 12, 50, 64) bf16 the call reads q, k,
// v, do and writes dq, dk, dv: 34.4 MB (10.3 us at 3.35 TB/s), and does
// 10 B nh S^2 D = 1.23e9 f32 operations (18.3 us at 67 TFLOP/s):
// operations.
//
// What the design does about it.  The TPU kernel loops over the heads of one
// batch item in one program and writes dk, dv once per head.  Here one block
// owns all S rows and keys of one (b, h), so dq, dk and dv are each written
// once, with no atomics and no second pass:
//   1. k and v are staged in shared memory as f32 (row stride D + 1);
//   2. a warp per query row recomputes that row's scores, softmax and keep
//      mask in registers (at most 4 keys per lane, S <= 128), and forms dpd =
//      do v^T for the row the same way, so the row sum of dp * p is a warp
//      reduction; it writes the row of pd and of ds to shared memory (S x S
//      each);
//   3. do replaces v in shared memory: dv = pd^T do and dq = ds k, a thread
//      per output element;
//   4. q * scale replaces do: dk = ds^T (q * scale).
// Plain f32 FMAs, expf and IEEE division, as the forward.  Two S x S
// matrices and two operand tiles fill the block's shared memory: S <= 128 at
// D = 64 (the wrapper raises where a shape does not fit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hash_dropout.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxS = 128;
constexpr int kMaxD = 128;
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
  return (2 * (size_t)S * (D + 1) + 2 * (size_t)S * S + (size_t)kWarps * 2 * D) *
         sizeof(float);
}

// Rows of the (S, D) matrix src into dst (row stride D + 1) as f32, each
// value times mul.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int S, int D, float mul) {
  for (int e = threadIdx.x; e < S * D; e += kThreads) {
    const int r = e / D;
    dst[r * (D + 1) + (e - r * D)] = to_f32(src[e]) * mul;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
short_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const int* __restrict__ seed_ptr, const T* __restrict__ d_out,
                      T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int nh,
                      int S, int D, float scale, float rate, float keep_scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;                      // (S, D + 1): k
  float* x_s = k_s + S * ld;              // (S, D + 1): v, then do, then q * scale
  float* pd_s = x_s + S * ld;             // (S, S) dropped probabilities
  float* ds_s = pd_s + S * S;             // (S, S) score gradients
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* q_row = ds_s + S * S + warp * 2 * D;   // this warp's q * scale row ...
  float* do_row = q_row + D;                    // ... and do row

  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  stage(k_s, k + base, S, D, 1.0f);
  stage(x_s, v + base, S, D, 1.0f);
  __syncthreads();

  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;
  const float* bias_b = bias + (size_t)b * S;
  for (int i = warp; i < S; i += kWarps) {
    for (int c = lane; c < D; c += 32) {
      q_row[c] = to_f32(q[base + (size_t)i * D + c]) * scale;
      do_row[c] = to_f32(d_out[base + (size_t)i * D + c]);
    }
    __syncwarp();
    float s[kKeysPerLane], dpd[kKeysPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      dpd[t] = 0.0f;
      if (j < S) {
        const float* kj = k_s + j * ld;
        const float* vj = x_s + j * ld;
        float acc = 0.0f, dacc = 0.0f;
        for (int c = 0; c < D; ++c) {
          acc = fmaf(q_row[c], kj[c], acc);
          dacc = fmaf(do_row[c], vj[c], dacc);
        }
        s[t] = acc + bias_b[j];
        dpd[t] = dacc;
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
    float r = 0.0f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = s[t] / l;                    // p
      float pd = s[t];
      if (drop && j < S) {
        const float keep =
            mmda::short_attn_keep(hbase, (uint32_t)(i * S + j), rate) ? keep_scale : 0.0f;
        pd = s[t] * keep;
        dpd[t] = dpd[t] * keep;           // dp
      }
      if (j < S) pd_s[i * S + j] = pd;
      r += dpd[t] * s[t];
    }
    r = warp_sum(r);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < S) ds_s[i * S + j] = s[t] * (dpd[t] - r);
    }
    __syncwarp();   // the next row overwrites q_row and do_row
  }
  __syncthreads();

  stage(x_s, d_out + base, S, D, 1.0f);
  __syncthreads();
  for (int e = threadIdx.x; e < S * D; e += kThreads) {
    const int j = e / D;                  // key row of dv, query row of dq
    const int c = e - j * D;
    float acc_v = 0.0f, acc_q = 0.0f;
    for (int i = 0; i < S; ++i) {
      acc_v = fmaf(pd_s[i * S + j], x_s[i * ld + c], acc_v);
      acc_q = fmaf(ds_s[j * S + i], k_s[i * ld + c], acc_q);
    }
    dv[base + e] = from_f32<T>(acc_v);
    dq[base + e] = from_f32<T>(acc_q * scale);
  }
  __syncthreads();

  stage(x_s, q + base, S, D, scale);
  __syncthreads();
  for (int e = threadIdx.x; e < S * D; e += kThreads) {
    const int j = e / D;
    const int c = e - j * D;
    float acc = 0.0f;
    for (int i = 0; i < S; ++i) acc = fmaf(ds_s[i * S + j], x_s[i * ld + c], acc);
    dk[base + e] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const int* seed, const void* d_out, void* dq, void* dk, void* dv, int BH,
                   int nh, int S, int D, float scale, float rate, float keep_scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      short_attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  short_attn_bwd_kernel<T><<<BH, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      seed, static_cast<const T*>(d_out), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), nh, S, D, scale, rate, keep_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, d_out, dq, dk, dv (B, nh, S, D): bf16 when is_bf16 else f32,
// contiguous; 1 <= S <= 128, 1 <= D <= 128, and the shape's shared memory
// within the card's opt-in limit.  scale, rate and keep_scale as for
// mmda_short_attn_fwd; seed (device int32) is read only when rate > 0.
int mmda_short_attn_bwd(const void* q, const void* k, const void* v, const float* bias,
                        const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                        int B, int nh, int S, int D, int is_bf16, float scale, float rate,
                        float keep_scale, void* stream) {
  if (B < 1 || nh < 1 || S < 1 || S > kMaxS || D < 1 || D > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return (int)launch<__nv_bfloat16>(q, k, v, bias, seed, d_out, dq, dk, dv, B * nh, nh, S,
                                      D, scale, rate, keep_scale, st);
  }
  return (int)launch<float>(q, k, v, bias, seed, d_out, dq, dk, dv, B * nh, nh, S, D, scale,
                            rate, keep_scale, st);
}

}  // extern "C"
