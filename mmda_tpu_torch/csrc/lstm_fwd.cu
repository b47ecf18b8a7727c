// Masked LSTM forward recurrence for Hopper (sm_90a), plain C entry point.
//
// Replaces mmda_tpu/ops/pallas/lstm.py::_fwd_kernel (:97, whole-T kernel,
// launched by _whole_fwd_call) and ::_stream_fwd_kernel (:382, its
// time-chunked twin for long T).  Both compute the same function, _cell_fwd
// applied over t = 0..T-1 (or T-1..0 when reverse):
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
// the latency of one step.
//
// What the design does about it: the serial chain of a step holds only the
// product h @ w_hh_t of the row, the gate activations and the cell.
//   * Batch rows are spread over the SMs (the caller picks `rows`), four
//     threads per (row, hidden unit j), gate fastest, so that a unit's four
//     threads form one quad of a warp.  Thread (j, q) forms gate q's
//     product h . w_hh_t[:, qH + j] from h in shared memory (float4 reads,
//     four accumulators strided over k, added as (a0 + a1) + (a2 + a3)) and
//     the column held in registers where H <= 80 (11 or 21 float4s), else
//     read from global memory with several units per quad (H up to 1024).
//   * x_proj[t] and the mask never depend on the carry: they come from a
//     shared-memory ring that cp.async fills kFwdRing - 1 steps ahead, and are
//     read into registers while the step before finishes, so no global-
//     memory latency is left on the chain.
//   * Thread q applies its gate's activation; the quad exchanges the four
//     by __shfl_sync and every thread of it runs the same cell update, so
//     the carries stay equal bit for bit.  Thread 0 of the quad writes h to
//     shared memory and ys, thread 1 writes cs: stores, nothing waits on them.
//   * h is double-buffered in shared memory by step parity, and the ring's
//     slot of a step is refilled only after the barrier that follows its
//     read, so one __syncthreads per step orders both.
//   * Plain f32 FMAs, no tensor cores: TF32 or bf16 would change the
//     numbers the JAX package computes.
// The pass itself is lstm_fwd_pass in lstm_passes.cuh, which
// lstm_multi_fwd.cu runs too.

#include "lstm_passes.cuh"

namespace {

template <int NC>
__global__ void __launch_bounds__(bptt_max_threads(NC))
lstm_fwd_kernel(const float* __restrict__ x_proj,  // (T, B, 4H)
                const float* __restrict__ w_hh_t,  // (H, 4H)
                const float* __restrict__ mask,    // (T, B)
                float* __restrict__ ys,            // (T, B, H)
                float* __restrict__ cs,            // (T, B, H) or null
                float* __restrict__ h_fin,         // (B, H)
                float* __restrict__ c_fin,         // (B, H)
                int T, int B, int H, int rows, int units, int reverse) {
  extern __shared__ __align__(16) float smem[];
  lstm_fwd_pass<NC>(x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B, H, rows, units, reverse,
                    blockIdx.x * rows, threadIdx.x, blockDim.x, smem, BlockSync{});
}

template <int NC>
cudaError_t launch(const float* x_proj, const float* w_hh_t, const float* mask, float* ys,
                   float* cs, float* h_fin, float* c_fin, int T, int B, int H, int rows,
                   int units, int reverse, cudaStream_t stream) {
  const int groups = (H + units - 1) / units;
  const int per_row = 4 * groups;
  if (rows < 1 || rows * per_row > bptt_max_threads(NC)) return cudaErrorInvalidValue;
  const size_t smem_bytes = (size_t)lstm_fwd_smem_floats(H, rows, groups, units) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = (rows * per_row + 31) / 32 * 32;
  const int blocks = (B + rows - 1) / rows;
  lstm_fwd_kernel<NC><<<blocks, threads, smem_bytes, stream>>>(
      x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B, H, rows, units, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// The caller allocates every output; cs may be null.  1 <= H <= 1024, and
// rows batch rows of 4 ceil(H / units) threads each within the block limit
// (bptt_max_threads: 640 threads where H <= 44, 384 where H <= 80, else
// 1024; units = 1 up to H = 256, then ceil(H / 256)), as for lstm_bwd.cu's
// serial pass.
int mmda_lstm_fwd(const float* x_proj, const float* w_hh_t, const float* mask,
                  float* ys, float* cs, float* h_fin, float* c_fin, int T,
                  int B, int H, int rows, int reverse, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxUnits * 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lstm_nc(H)) {
    case 11:
      return (int)launch<11>(x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B, H, rows, 1,
                             reverse, st);
    case 21:
      return (int)launch<21>(x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B, H, rows, 1,
                             reverse, st);
    default:
      return (int)launch<0>(x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B, H, rows,
                            (H + 255) / 256, reverse, st);
  }
}

}  // extern "C"
