// Masked LSTM backward recurrence (BPTT) for Hopper (sm_90a), plain C entry.
//
// Replaces mmda_tpu/ops/pallas/lstm.py::_bwd_kernel (:285, whole-T, launched
// by _whole_bwd_call) and ::_stream_bwd_kernel (:452, its time-chunked twin
// for long T).  Both compute the same function: the gradient of the masked
// forward recurrence of lstm_fwd.cu, walking the steps in the reverse of the
// forward's processing order and recomputing the gates from the saved
// states (_cell_bwd, :53):
//
//   h_prev, c_prev = ys, cs at the previous processed step (0 at the first)
//   dh             = dh_carry + dys[t]
//   gates          = x_proj[t] + h_prev @ w_hh_t        (i, f, g, o)
//   dh_new, dc_new = m * dh, m * dc;  dh_pass, dc_pass = (1 - m) * dh, dc
//   dc_new        += dh_new * o * (1 - tanh(c_new)^2)
//   dgates         = [dc_new g i(1-i), dc_new c_prev f(1-f),
//                     dc_new i (1-g^2), dh_new tanh(c_new) o(1-o)]
//   dx_proj[t]     = dgates
//   dh_carry       = dgates @ w_hh_t^T + dh_pass
//   dc_carry       = dc_new * f + dc_pass
//   dw_hh_t        = sum over t, b of h_prev^T dgates
//
// All f32; dh_carry starts at dh_fin and dc_carry at dc_fin (0 when null).
//
// What bounds it on the H100.  At the long step's shape (T=512, B=32, H=74)
// the inputs and outputs are about 52 MB (16 us at 3.35 TB/s) and the
// arithmetic 1.2 GFLOP (18 us at 67 TFLOP/s f32).  Neither is the limit:
// the T steps are dependent, so the time is T times one step's latency.
//
// What the design does about it.  The gates at step t depend only on the
// saved states and x_proj[t], never on the backward carry: the TPU kernel
// recomputes them inside its serial loop only because a TPU core runs one
// program.  Here the work is split in four kernels of this file, so that
// the serial chain of a step holds only the cell backward and dh_prev:
//   * lstm_gates_kernel: the gate activations i, f, g, o of every (t, b) at
//     once, gates = x_proj[t] + h_prev @ w_hh_t as a tiled (T*B x H) x
//     (H x 4H) product on all SMs (f32 FMAs in ascending k, the order of the
//     serial recompute it replaces), written into dx_proj's own storage: no
//     (T, B, 4H) scratch.
//   * lstm_bptt_kernel: batch rows spread over the SMs (the caller picks
//     `rows`), four threads per (row, hidden unit j), gate fastest, so a
//     unit's four threads form one quad of a warp.  Unit j's activations,
//     c_prev, dys and the mask come from a shared-memory ring that cp.async
//     fills kBpttRing - 1 steps ahead (none of them depends on the carry), and
//     tanh(c_new) is recomputed from them (one tanhf, no scratch) while the
//     step before finishes.  All four threads run the cell backward on the
//     same values, with no branch on the gate; thread q writes dgate q over
//     the activation in dx_proj (the ring read it steps before) and to
//     shared memory.  After the step's one barrier, thread (j, q) forms the
//     gate-q part of dh_prev[j] from the row's dgates of gate q (float4
//     reads, four accumulators) and row j of w_hh_t's gate-q columns, held
//     in registers where H <= 80 (11 or 21 float4s), else read from global
//     memory with several units per quad (H up to 1024); two
//     __shfl_xor_sync add the quad's four parts.  The dgates sit in two
//     shared buffers, one per step parity, so one barrier per step orders
//     both their exchange and the ring.
//   * lstm_dw_partial_kernel + lstm_dw_sum_kernel: dW_hh^T = sum over (t, b)
//     of h_prev^T dgates as a tiled (H x T*B) x (T*B x 4H) product over the
//     dx_proj just written and ys shifted by one processed step, 4 x 4 f64
//     accumulators a thread.  The rows are cut into `splits` runs (the
//     caller picks enough to fill the SMs: H=74 has only 15 output tiles),
//     each block sums its tile over its run, and a second pass adds the runs
//     in order.  All sums in f64 (exact products, so T * B terms do not drift
//     with the order): deterministic, no atomics.
//   * Otherwise plain f32 FMAs, no tensor cores (TF32 would change the
//     numbers the JAX package computes).
// Fusing the dW reduction into the BPTT loop is later work.  The passes
// themselves are lstm_passes.cuh's device functions, which
// lstm_multi_bwd.cu runs too.

#include "lstm_passes.cuh"

namespace {

__global__ void __launch_bounds__(kGateThreads)
lstm_gates_kernel(const float* __restrict__ x_proj,  // (T, B, 4H)
                  const float* __restrict__ w_hh_t,  // (H, 4H)
                  const float* __restrict__ ys,      // (T, B, H)
                  float* __restrict__ gates,         // (T, B, 4H)
                  int T, int B, int H, int reverse) {
  lstm_gates_tile(x_proj, w_hh_t, ys, gates, T, B, H, reverse, blockIdx.x, blockIdx.y);
}

template <int NC>
__global__ void __launch_bounds__(bptt_max_threads(NC))
lstm_bptt_kernel(const float* __restrict__ w_hh_t,  // (H, 4H)
                 const float* __restrict__ mask,    // (T, B)
                 const float* __restrict__ cs,      // (T, B, H)
                 const float* __restrict__ dys,     // (T, B, H)
                 const float* __restrict__ dh_fin,  // (B, H)
                 const float* __restrict__ dc_fin,  // (B, H) or null
                 float* dx_proj,                    // (T, B, 4H)
                 int T, int B, int H, int rows, int units, int reverse) {
  extern __shared__ __align__(16) float smem[];
  lstm_bptt_pass<NC>(w_hh_t, mask, cs, dys, dh_fin, dc_fin, dx_proj, T, B, H, rows, units,
                     reverse, blockIdx.x * rows, threadIdx.x, blockDim.x, smem, BlockSync{});
}

// Block (x, y, z) sums the (32 x 64) tile (y, x) of dW_hh^T over the z-th of
// gridDim.z runs of rows into dw_partial[z].
__global__ void __launch_bounds__(kDwThreads)
lstm_dw_partial_kernel(const float* __restrict__ ys,       // (T, B, H)
                       const float* __restrict__ dx_proj,  // (T, B, 4H)
                       double* __restrict__ dw_partial,    // (splits, H, 4H)
                       int T, int B, int H, int reverse) {
  lstm_dw_partial_tile(ys, dx_proj, dw_partial + (size_t)blockIdx.z * H * 4 * H, T, B, H,
                       reverse, blockIdx.x, blockIdx.y, blockIdx.z, gridDim.z);
}

__global__ void lstm_dw_sum_kernel(const double* __restrict__ dw_partial,
                                   float* __restrict__ dw_hh_t, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) lstm_dw_sum_at(dw_partial, dw_hh_t, n, splits, i);
}

template <int NC>
cudaError_t launch_bptt(const float* w_hh_t, const float* mask, const float* cs,
                        const float* dys, const float* dh_fin, const float* dc_fin,
                        float* dx_proj, int T, int B, int H, int rows, int units, int reverse,
                        cudaStream_t stream) {
  const int groups = (H + units - 1) / units;
  const int per_row = 4 * groups;
  if (rows < 1 || rows * per_row > bptt_max_threads(NC)) return cudaErrorInvalidValue;
  const size_t smem_bytes =
      (size_t)lstm_bptt_smem_floats(H, rows, groups, units) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bptt_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = (rows * per_row + 31) / 32 * 32;
  const int blocks = (B + rows - 1) / rows;
  lstm_bptt_kernel<NC><<<blocks, threads, smem_bytes, stream>>>(
      w_hh_t, mask, cs, dys, dh_fin, dc_fin, dx_proj, T, B, H, rows, units, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the four kernels on `stream` (the gate pass into dx_proj, the
// BPTT pass over it, then the dW partials, which read the dgates the BPTT
// pass left in dx_proj, then their sum) and returns the first nonzero
// cudaError as an int (0 = ok).  The caller allocates dx_proj, dw_hh_t and
// the (splits, H, 4H) f64 scratch dw_partial; dc_fin may be null (zeros).
// 1 <= H <= 1024, splits >= 1, and rows batch rows of 4 ceil(H / units)
// threads each within the block limit of the serial pass (bptt_max_threads:
// 640 threads where H <= 44, 384 where H <= 80, else 1024; units = 1 up to
// H = 256, then ceil(H / 256)).
int mmda_lstm_bwd(const float* x_proj, const float* w_hh_t, const float* mask,
                  const float* ys, const float* cs, const float* dys,
                  const float* dh_fin, const float* dc_fin, float* dx_proj,
                  float* dw_hh_t, double* dw_partial, int T, int B, int H,
                  int rows, int reverse, int splits, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxUnits * 256 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = 4 * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 gate_grid((T * B + kGateTileN - 1) / kGateTileN, (G + kGateTileG - 1) / kGateTileG);
  lstm_gates_kernel<<<gate_grid, kGateThreads, 0, st>>>(x_proj, w_hh_t, ys, dx_proj, T, B, H,
                                                        reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (lstm_nc(H)) {
    case 11:
      err = launch_bptt<11>(w_hh_t, mask, cs, dys, dh_fin, dc_fin, dx_proj, T, B, H, rows, 1,
                            reverse, st);
      break;
    case 21:
      err = launch_bptt<21>(w_hh_t, mask, cs, dys, dh_fin, dc_fin, dx_proj, T, B, H, rows, 1,
                            reverse, st);
      break;
    default:
      err = launch_bptt<0>(w_hh_t, mask, cs, dys, dh_fin, dc_fin, dx_proj, T, B, H, rows,
                           (H + 255) / 256, reverse, st);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + kDwTileG - 1) / kDwTileG, (H + kDwTileK - 1) / kDwTileK,
                  splits);
  lstm_dw_partial_kernel<<<grid, kDwThreads, 0, st>>>(ys, dx_proj, dw_partial, T, B, H,
                                                      reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * G;
  lstm_dw_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(dw_partial, dw_hh_t, n,
                                                       splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
