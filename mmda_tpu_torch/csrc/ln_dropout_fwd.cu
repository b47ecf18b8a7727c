// Fused residual + dropout + LayerNorm forward for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/layernorm.py::_fwd_kernel (:58, launched by
// _fwd_call :130):
//
//   z   = x + y * keep * (1 / (1 - rate))       keep from the positional hash
//   mu  = mean(z);  var = mean((z - mu)^2)      (two passes, f32)
//   out = (z - mu) * rsqrt(var + eps) * g + b   rounded once to x's dtype
//
// x, y, out (N, H) in f32 or bf16, g, b (H,) f32, all arithmetic f32.  The
// keep mask is hash_dropout.cuh's, on the absolute (row, column) and the
// seed read from device memory (the caller never copies it to the host), so
// the mask, the dropout output and the normalised intermediate never exist
// in device memory.  rate == 0 skips the mask (seed may be null).
//
// What bounds it on the H100: bytes.  Three passes over N * H elements (x and
// y read, out written): 14.7 MB in bf16 at N=3200, H=768, 4.4 us at
// 3.35 TB/s; the arithmetic is a few dozen operations per element.
//
// What the design does about it.  The TPU kernel takes 128-row blocks through
// a sequential grid (and pads N up to them); here one warp owns one row, four
// rows per block, N / 4 blocks in flight over the SMs, no padding: the hash
// takes the absolute row.  Each lane reads its columns once, 4 at a time
// (16-byte or 8-byte accesses) where H and the pointers allow, keeps z in
// shared memory for the second statistics pass and the output pass (its own
// columns only, 4 at a time as well: a lane's four neighbouring floats one
// by one would meet the next lanes' in the same banks), and the row sums are
// warp shuffles: no block-level barrier.

#include "hash_dropout.cuh"
#include "ln_dropout.cuh"

namespace {

using mmda::kWarpsPerBlock;

template <typename T, int V>
__global__ void ln_dropout_fwd_kernel(const T* __restrict__ x,     // (N, H)
                                      const T* __restrict__ y,     // (N, H)
                                      const float* __restrict__ g, // (H,)
                                      const float* __restrict__ b, // (H,)
                                      const int* __restrict__ seed_ptr,
                                      T* __restrict__ out,         // (N, H)
                                      int N, int H, float rate, float scale,
                                      float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= N) return;                 // whole warps leave; no barrier below
  float* z_s = smem + warp * H;         // each lane reads back only its own
  const bool drop = rate > 0.0f;
  const uint32_t seed = drop ? (uint32_t)seed_ptr[0] : 0u;
  const size_t base = (size_t)row * H;

  float sum = 0.0f;
  for (int c = lane * V; c < H; c += 32 * V) {
    float xv[V], yv[V], zv[V];
    mmda::load_vec<V>(x + base + c, xv);
    mmda::load_vec<V>(y + base + c, yv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float yi = yv[i];
      if (drop) {
        yi = mmda::hash_keep(seed, (uint32_t)row, (uint32_t)(c + i), rate)
                 ? yi * scale : 0.0f;
      }
      zv[i] = xv[i] + yi;
      sum += zv[i];
    }
    mmda::store_vec<V>(z_s + c, zv);
  }
  const float mu = mmda::warp_sum(sum) / (float)H;
  float sq = 0.0f;
  for (int c = lane * V; c < H; c += 32 * V) {
    float zv[V];
    mmda::load_vec<V>(z_s + c, zv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = zv[i] - mu;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(mmda::warp_sum(sq) / (float)H + eps);
  for (int c = lane * V; c < H; c += 32 * V) {
    float zv[V], gv[V], bv[V], ov[V];
    mmda::load_vec<V>(z_s + c, zv);
    mmda::load_vec<V>(g + c, gv);
    mmda::load_vec<V>(b + c, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ov[i] = (zv[i] - mu) * rstd * gv[i] + bv[i];
    }
    mmda::store_vec<V>(out + base + c, ov);
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* y, const float* g, const float* b,
                   const int* seed, void* out, int N, int H, float rate,
                   float scale, float eps, cudaStream_t stream) {
  const size_t smem_bytes = (size_t)kWarpsPerBlock * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_dropout_fwd_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ln_dropout_fwd_kernel<T, V><<<blocks, 32 * kWarpsPerBlock, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), g, b, seed,
      static_cast<T*>(out), N, H, rate, scale, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// x, y, out: bf16 when is_bf16 else f32.  vec is 4 (H % 4 == 0 and every
// pointer 16-byte aligned) or 1.  rate and scale = 1 / (1 - rate) already
// rounded to f32; seed (device int32) is read only when rate > 0.
int mmda_ln_dropout_fwd(const void* x, const void* y, const float* g,
                        const float* b, const int* seed, void* out, int N,
                        int H, int is_bf16, int vec, float rate, float scale,
                        float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    return (int)(vec == 4
        ? launch<__nv_bfloat16, 4>(x, y, g, b, seed, out, N, H, rate, scale, eps, st)
        : launch<__nv_bfloat16, 1>(x, y, g, b, seed, out, N, H, rate, scale, eps, st));
  }
  return (int)(vec == 4
      ? launch<float, 4>(x, y, g, b, seed, out, N, H, rate, scale, eps, st)
      : launch<float, 1>(x, y, g, b, seed, out, N, H, rate, scale, eps, st));
}

}  // extern "C"
