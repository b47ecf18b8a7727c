// Masked LSTM forward recurrence for Hopper (sm_90a), plain C entry point.
//
// Replaces mmda_tpu/ops/pallas/lstm.py::_fwd_kernel (whole-T kernel,
// launched by _whole_fwd_call) and ::_stream_fwd_kernel (its time-chunked
// twin for long T).  Both compute the same function, _cell_fwd applied over
// t = 0..T-1 (or T-1..0 when reverse):
//
//   gates = x_proj[t] + h @ w_hh_t            (gate order i, f, g, o)
//   c'    = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h'    = sigmoid(o) * tanh(c')
//   h, c  = m * h' + (1 - m) * h,  m * c' + (1 - m) * c     (m = mask[t, b])
//
// writing ys[t] = h (and cs[t] = c when cs is not null) and the final h, c.
// All f32; x_proj already holds x @ W_ih^T + b_ih + b_hh.
//
// What bounds it on the H100.  The inputs and outputs are a few MB at the
// serving shapes (T=48, B=64, H=35/74: under 5 MB, about 1.5 us at
// 3.35 TB/s) and the arithmetic is ~14 MFLOP (0.2 us at 67 TFLOP/s f32).
// Neither is the limit: the T steps are dependent, so the time is T times
// the latency of one step -- a (rows, H) x (H, 4H) product, the gate math
// and a barrier.
//
// What the design does about it.  The TPU kernels hold the whole T extent
// (or a time chunk) in VMEM and loop over time inside one program; here one
// thread block owns `rows` batch rows and loops over all T steps itself, so
// the time-chunking of the streaming kernel is not needed (no VMEM budget).
//   * Batch rows are spread over as many blocks as the card has SMs (the
//     caller picks `rows`), so each step's latency is that of one short
//     block, not of a long serial block.
//   * One thread per (row, hidden unit) computes the four gate dot products
//     of its unit; the cell update then needs no exchange between threads.
//   * h is double-buffered in shared memory: a step reads one buffer and
//     writes the other, so one __syncthreads per step is enough.  c stays
//     in a register.
//   * w_hh_t sits in dynamic shared memory when it fits (H=74: 87.6 KB,
//     above the 48 KB default, hence cudaFuncSetAttribute); larger H
//     (H=300: 1.44 MB) reads it from global memory through L1/L2.
//   * Plain f32 FMAs, no tensor cores: TF32 or bf16 would change the
//     numbers the JAX package computes.
// Making the step shorter (several rows per thread, warp-level splits of
// the dot products, wgmma) is later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kWeightsInSmem>
__global__ void lstm_fwd_kernel(const float* __restrict__ x_proj,  // (T, B, 4H)
                                const float* __restrict__ w_hh_t,  // (H, 4H)
                                const float* __restrict__ mask,    // (T, B)
                                float* __restrict__ ys,            // (T, B, H)
                                float* __restrict__ cs,            // (T, B, H) or null
                                float* __restrict__ h_fin,         // (B, H)
                                float* __restrict__ c_fin,         // (B, H)
                                int T, int B, int H, int rows, int reverse) {
  extern __shared__ float smem[];
  const int G = 4 * H;
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

  float h = 0.0f;
  float c = 0.0f;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* h_cur = h_s + (s & 1) * rows * H + r * H;
    float* h_nxt = h_s + ((s & 1) ^ 1) * rows * H + r * H;
    if (active) {
      float ai = 0.0f, af = 0.0f, ag = 0.0f, ao = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float hk = h_cur[k];
        const float* wk = w + (size_t)k * G + j;
        ai = fmaf(hk, wk[0], ai);
        af = fmaf(hk, wk[H], af);
        ag = fmaf(hk, wk[2 * H], ag);
        ao = fmaf(hk, wk[3 * H], ao);
      }
      const size_t row = (size_t)t * B + b;
      const float* xp = x_proj + row * G + j;
      const float ig = sigmoid_f(xp[0] + ai);
      const float fg = sigmoid_f(xp[H] + af);
      const float gg = tanhf(xp[2 * H] + ag);
      const float og = sigmoid_f(xp[3 * H] + ao);
      const float c_new = fg * c + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float m = mask[row];
      h = m * h_new + (1.0f - m) * h;
      c = m * c_new + (1.0f - m) * c;
      h_nxt[j] = h;
      ys[row * H + j] = h;
      if (cs != nullptr) cs[row * H + j] = c;
    }
    __syncthreads();
  }
  if (active) {
    h_fin[(size_t)b * H + j] = h;
    c_fin[(size_t)b * H + j] = c;
  }
}

template <bool kWeightsInSmem>
cudaError_t launch(const float* x_proj, const float* w_hh_t, const float* mask,
                   float* ys, float* cs, float* h_fin, float* c_fin, int T,
                   int B, int H, int rows, int reverse, size_t smem_bytes,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<kWeightsInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = (rows * H + 31) / 32 * 32;
  const int blocks = (B + rows - 1) / rows;
  lstm_fwd_kernel<kWeightsInSmem><<<blocks, threads, smem_bytes, stream>>>(
      x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B, H, rows, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// The caller allocates every output; cs may be null.  rows * H <= 1024.
int mmda_lstm_fwd(const float* x_proj, const float* w_hh_t, const float* mask,
                  float* ys, float* cs, float* h_fin, float* c_fin, int T,
                  int B, int H, int rows, int reverse, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t h_bytes = 2 * (size_t)rows * H * sizeof(float);
  const size_t w_bytes = (size_t)H * 4 * H * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bytes + h_bytes <= (size_t)smem_optin) {
    return (int)launch<true>(x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B,
                             H, rows, reverse, w_bytes + h_bytes, st);
  }
  return (int)launch<false>(x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B,
                            H, rows, reverse, h_bytes, st);
}

}  // extern "C"
