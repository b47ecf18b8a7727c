// Fused residual + dropout + LayerNorm backward for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/layernorm.py::_bwd_kernel (:74, launched by
// _bwd_call :152).  Nothing but x, y, g and the seed was saved: per row it
// regenerates the keep mask (hash_dropout.cuh), recomputes z, mu, rstd and
// zhat = (z - mu) * rstd as ln_dropout_fwd.cu does, and then
//
//   dzhat = do * g
//   dz    = rstd * (dzhat - mean(dzhat) - zhat * mean(dzhat * zhat))
//   dx    = dz;   dy = dz * keep * (1 / (1 - rate))
//   dg    = sum over rows of do * zhat;   db = sum over rows of do
//
// x, y, do, dx, dy (N, H) in f32 or bf16, g, dg, db (H,) f32, arithmetic f32.
//
// What bounds it on the H100: bytes.  Five passes over N * H elements (x, y,
// do read, dx, dy written): 24.6 MB in bf16 at N=3200, H=768, 7.3 us at
// 3.35 TB/s.
//
// What the design does about it.  One warp per row as in the forward, but a
// block walks over many rows (the caller picks the grid, about two blocks
// per SM) so that the column sums stay in the block: every lane owns its
// columns of its warp's dg and db rows in shared memory, adds each row it
// processes to them, and at the end the block adds its warps' rows in order
// and writes one (2, H) f32 partial.  The TPU kernel accumulates dg and db
// across a grid that runs in order; here ln_dropout_dgb_sum_kernel adds the
// blocks' partials in block order in a second pass: deterministic, no
// atomics.  do is read again (from L1/L2) in the last pass rather than kept.
// Shared memory is read and written 4 values at a time like device memory: a
// lane's four neighbouring floats taken one by one would meet the next
// lanes' in the same banks.

#include "hash_dropout.cuh"
#include "ln_dropout.cuh"

namespace {

using mmda::kWarpsPerBlock;

template <typename T, int V>
__global__ void ln_dropout_bwd_kernel(const T* __restrict__ x,      // (N, H)
                                      const T* __restrict__ y,      // (N, H)
                                      const float* __restrict__ g,  // (H,)
                                      const T* __restrict__ dout,   // (N, H)
                                      const int* __restrict__ seed_ptr,
                                      T* __restrict__ dx,           // (N, H)
                                      T* __restrict__ dy,           // (N, H)
                                      float* __restrict__ partial,  // (blocks, 2, H)
                                      int N, int H, float rate, float scale,
                                      float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* z_s = smem + warp * H;                          // z, then zhat
  float* dg_s = smem + (kWarpsPerBlock + warp) * H;      // this warp's sums
  float* db_s = smem + (2 * kWarpsPerBlock + warp) * H;
  const bool drop = rate > 0.0f;
  const uint32_t seed = drop ? (uint32_t)seed_ptr[0] : 0u;

  // every column of the warp's rows is owned by one lane: zeroed and added
  // to by it alone, so only the block's final sum needs a barrier
  for (int c = lane * V; c < H; c += 32 * V) {
    const float zero[V] = {};
    mmda::store_vec<V>(dg_s + c, zero);
    mmda::store_vec<V>(db_s + c, zero);
  }
  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < N;
       row += gridDim.x * kWarpsPerBlock) {
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

    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane * V; c < H; c += 32 * V) {
      float gv[V], dv[V], zv[V], dgv[V], dbv[V];
      mmda::load_vec<V>(g + c, gv);
      mmda::load_vec<V>(dout + base + c, dv);
      mmda::load_vec<V>(z_s + c, zv);
      mmda::load_vec<V>(dg_s + c, dgv);
      mmda::load_vec<V>(db_s + c, dbv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float zhat = (zv[i] - mu) * rstd;
        const float dzhat = dv[i] * gv[i];
        zv[i] = zhat;
        s1 += dzhat;
        s2 += dzhat * zhat;
        dgv[i] += dv[i] * zhat;
        dbv[i] += dv[i];
      }
      mmda::store_vec<V>(z_s + c, zv);
      mmda::store_vec<V>(dg_s + c, dgv);
      mmda::store_vec<V>(db_s + c, dbv);
    }
    const float m1 = mmda::warp_sum(s1) / (float)H;
    const float m2 = mmda::warp_sum(s2) / (float)H;
    for (int c = lane * V; c < H; c += 32 * V) {
      float gv[V], dv[V], zv[V], dxv[V], dyv[V];
      mmda::load_vec<V>(g + c, gv);
      mmda::load_vec<V>(dout + base + c, dv);
      mmda::load_vec<V>(z_s + c, zv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float dz = rstd * (dv[i] * gv[i] - m1 - zv[i] * m2);
        dxv[i] = dz;
        dyv[i] = dz;
        if (drop) {
          dyv[i] = mmda::hash_keep(seed, (uint32_t)row, (uint32_t)(c + i), rate)
                       ? dz * scale : 0.0f;
        }
      }
      mmda::store_vec<V>(dx + base + c, dxv);
      mmda::store_vec<V>(dy + base + c, dyv);
    }
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * 2 * H;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float sg = 0.0f, sb = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      sg += smem[(kWarpsPerBlock + w) * H + c];
      sb += smem[(2 * kWarpsPerBlock + w) * H + c];
    }
    out[c] = sg;
    out[H + c] = sb;
  }
}

// dg, db = the blocks' partials added in block order.
__global__ void ln_dropout_dgb_sum_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dg,
                                          float* __restrict__ db, int blocks,
                                          int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // (which, column)
  if (i >= 2 * H) return;
  float sum = 0.0f;
  for (int k = 0; k < blocks; ++k) sum += partial[(size_t)k * 2 * H + i];
  if (i < H) {
    dg[i] = sum;
  } else {
    db[i - H] = sum;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* y, const float* g,
                   const void* dout, const int* seed, void* dx, void* dy,
                   float* partial, int N, int H, int blocks, float rate,
                   float scale, float eps, cudaStream_t stream) {
  const size_t smem_bytes = (size_t)3 * kWarpsPerBlock * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_dropout_bwd_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return err;
  ln_dropout_bwd_kernel<T, V><<<blocks, 32 * kWarpsPerBlock, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), g,
      static_cast<const T*>(dout), seed, static_cast<T*>(dx),
      static_cast<T*>(dy), partial, N, H, rate, scale, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the two kernels on `stream` (the rows' pass, then the sum of its
// partials) and returns the first nonzero cudaError as an int (0 = ok).
// x, y, dout, dx, dy: bf16 when is_bf16 else f32.  vec is 4 (H % 4 == 0 and
// every pointer 16-byte aligned) or 1.  The caller allocates dx, dy, dg, db
// and the (blocks, 2, H) f32 scratch `partial`; blocks >= 1.  rate and
// scale = 1 / (1 - rate) already rounded to f32; seed (device int32) is read
// only when rate > 0.
int mmda_ln_dropout_bwd(const void* x, const void* y, const float* g,
                        const void* dout, const int* seed, void* dx, void* dy,
                        float* dg, float* db, float* partial, int N, int H,
                        int is_bf16, int vec, int blocks, float rate,
                        float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((vec != 1 && vec != 4) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (is_bf16) {
    err = vec == 4
        ? launch<__nv_bfloat16, 4>(x, y, g, dout, seed, dx, dy, partial, N, H,
                                   blocks, rate, scale, eps, st)
        : launch<__nv_bfloat16, 1>(x, y, g, dout, seed, dx, dy, partial, N, H,
                                   blocks, rate, scale, eps, st);
  } else {
    err = vec == 4
        ? launch<float, 4>(x, y, g, dout, seed, dx, dy, partial, N, H, blocks,
                           rate, scale, eps, st)
        : launch<float, 1>(x, y, g, dout, seed, dx, dy, partial, N, H, blocks,
                           rate, scale, eps, st);
  }
  if (err != cudaSuccess) return (int)err;
  ln_dropout_dgb_sum_kernel<<<(2 * H + 255) / 256, 256, 0, st>>>(partial, dg, db,
                                                                 blocks, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
