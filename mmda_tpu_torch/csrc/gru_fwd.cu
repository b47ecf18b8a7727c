// Masked GRU forward recurrence for Hopper (sm_90a), plain C entry point.
//
// Replaces mmda_tpu/ops/pallas/gru.py::_fwd_kernel (:142, whole-T, launched
// by _whole_fwd_call) and ::_stream_fwd_kernel (:284, its time-chunked twin
// for long T).  Both compute the same function, _cell_fwd (:45) applied over
// t = 0..T-1 (or T-1..0 when reverse), torch GRU semantics, gates r, z, n:
//
//   hh = h @ w_hh_t + b_hh
//   r  = sigmoid(x_r + hh_r)
//   z  = sigmoid(x_z + hh_z)
//   n  = tanh(x_n + r * hh_n)          (b_hh_n inside the r product)
//   h' = (1 - z) * n + z * h
//   h  = m * h' + (1 - m) * h          (m = mask[t, b])
//
// writing ys[t] = h and the final h.  All f32; x_proj holds x @ W_ih^T + b_ih
// only, b_hh comes separately because of the r product.
//
// What bounds it on the H100.  As for the LSTM forward (lstm_fwd.cu): the
// inputs and outputs are a few MB and the arithmetic a few MFLOP at the
// tower shapes, about a microsecond of either; the T steps are dependent, so
// the time is T times the latency of one step -- a (rows, H) x (H, 3H)
// product, the gate math and a barrier.
//
// What the design does about it.  The same as lstm_fwd.cu: one thread block
// owns `rows` batch rows (spread over the SMs by the caller) and loops over
// all T steps, so the TPU's time-chunked streaming kernel is not needed; one
// thread per (row, hidden unit) computes its unit's three gate dot products
// and keeps its own h in a register (h' = (1 - z) n + z h needs only that);
// h is double-buffered in shared memory, one __syncthreads per step; w_hh_t
// sits in opted-in dynamic shared memory when it fits (H=74: 65.7 KB) and
// is read through L1/L2 otherwise (H=300: 1.08 MB).  Plain f32 FMAs, no
// tensor cores: TF32 would change the numbers the JAX package computes.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kWeightsInSmem>
__global__ void gru_fwd_kernel(const float* __restrict__ x_proj,  // (T, B, 3H)
                               const float* __restrict__ w_hh_t,  // (H, 3H)
                               const float* __restrict__ b_hh,    // (3H,)
                               const float* __restrict__ mask,    // (T, B)
                               float* __restrict__ ys,            // (T, B, H)
                               float* __restrict__ h_fin,         // (B, H)
                               int T, int B, int H, int rows, int reverse) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  float* h_s = smem + (kWeightsInSmem ? H * G : 0);  // (2, rows, H)
  const float* w = kWeightsInSmem ? smem : w_hh_t;

  if (kWeightsInSmem) {
    for (int i = threadIdx.x; i < H * G; i += blockDim.x) smem[i] = w_hh_t[i];
  }
  for (int i = threadIdx.x; i < 2 * rows * H; i += blockDim.x) h_s[i] = 0.0f;
  __syncthreads();

  const int r = threadIdx.x / H;      // row within the block
  const int j = threadIdx.x - r * H;  // hidden unit
  const int b = blockIdx.x * rows + r;
  const bool active = r < rows && b < B;

  float br = 0.0f, bz = 0.0f, bn = 0.0f;
  if (active) {
    br = b_hh[j];
    bz = b_hh[H + j];
    bn = b_hh[2 * H + j];
  }
  float h = 0.0f;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* h_cur = h_s + (s & 1) * rows * H + r * H;
    float* h_nxt = h_s + ((s & 1) ^ 1) * rows * H + r * H;
    if (active) {
      float ar = 0.0f, az = 0.0f, an = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float hk = h_cur[k];
        const float* wk = w + (size_t)k * G + j;
        ar = fmaf(hk, wk[0], ar);
        az = fmaf(hk, wk[H], az);
        an = fmaf(hk, wk[2 * H], an);
      }
      const size_t row = (size_t)t * B + b;
      const float* xp = x_proj + row * G + j;
      const float rg = sigmoid_f(xp[0] + (ar + br));
      const float zg = sigmoid_f(xp[H] + (az + bz));
      const float ng = tanhf(xp[2 * H] + rg * (an + bn));
      const float h_new = (1.0f - zg) * ng + zg * h;
      const float m = mask[row];
      h = m * h_new + (1.0f - m) * h;
      h_nxt[j] = h;
      ys[row * H + j] = h;
    }
    __syncthreads();
  }
  if (active) h_fin[(size_t)b * H + j] = h;
}

template <bool kWeightsInSmem>
cudaError_t launch(const float* x_proj, const float* w_hh_t, const float* b_hh,
                   const float* mask, float* ys, float* h_fin, int T, int B,
                   int H, int rows, int reverse, size_t smem_bytes,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<kWeightsInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = (rows * H + 31) / 32 * 32;
  const int blocks = (B + rows - 1) / rows;
  gru_fwd_kernel<kWeightsInSmem><<<blocks, threads, smem_bytes, stream>>>(
      x_proj, w_hh_t, b_hh, mask, ys, h_fin, T, B, H, rows, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// The caller allocates every output.  rows * H <= 1024.
int mmda_gru_fwd(const float* x_proj, const float* w_hh_t, const float* b_hh,
                 const float* mask, float* ys, float* h_fin, int T, int B,
                 int H, int rows, int reverse, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t h_bytes = 2 * (size_t)rows * H * sizeof(float);
  const size_t w_bytes = (size_t)H * 3 * H * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bytes + h_bytes <= (size_t)smem_optin) {
    return (int)launch<true>(x_proj, w_hh_t, b_hh, mask, ys, h_fin, T, B, H,
                             rows, reverse, w_bytes + h_bytes, st);
  }
  return (int)launch<false>(x_proj, w_hh_t, b_hh, mask, ys, h_fin, T, B, H,
                            rows, reverse, h_bytes, st);
}

}  // extern "C"
