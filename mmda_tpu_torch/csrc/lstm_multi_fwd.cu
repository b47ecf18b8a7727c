// Several masked LSTM forward recurrences in one launch, for Hopper
// (sm_90a), plain C entry point.
//
// Replaces mmda_tpu/ops/pallas/lstm_multi.py::_fwd_kernel (:48, launched by
// _fwd_call :139): D independent directions (2 towers x 2 directions of
// one stacked layer) in one kernel.  Each direction d runs lstm_fwd.cu's
// recurrence on its own operands
//
//   gates = x_proj_d[t] + h @ w_hh_t_d        (gate order i, f, g, o)
//   c'    = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//   h, c  = m * h' + (1 - m) * h,  m * c' + (1 - m) * c     (m = mask_d[t, b])
//
// over t = 0..T-1, or T-1..0 when reverse_d, writing ys_d[t] = h, cs_d[t] = c
// (when cs_d is not null) and h_fin_d.  All f32.  Each direction keeps its
// own hidden size H_d: the TPU kernel pads every direction to HP = 128 lanes
// (one MXU tile) and the caller time-flips the reverse ones; neither is
// needed here.
//
// What bounds it on the H100.  At the towers' serving shape (T=48, B=64,
// H = 35, 35, 74, 74) the operands are under 10 MB (3 us at 3.35 TB/s) and
// the arithmetic about 40 MFLOP (0.6 us at 67 TFLOP/s); neither is the
// limit.  The T steps of a direction are dependent, so the time is T times
// one step's latency, as for lstm_fwd.cu: the launch has to hold every
// direction's rows on the SMs at once, in one wave.
//
// What the design does about it.  Every row runs lstm_fwd.cu's serial pass
// (lstm_fwd_pass in lstm_passes.cuh: a quad a hidden unit, the gate column in
// registers up to H = 80, x_proj and the mask through a cp.async ring, one
// barrier a step), at the instantiation of its direction's H (11 or 21
// float4s of weights, 0: from global memory).  Where one row a block of
// each direction would take more blocks than the card has SMs (B = 64: 256),
// the caller packs a narrow direction's row beside a wide one's in one block
// (35 + 74: 160 + 320 threads), each group on its own named barrier, so the
// launch stays one wave (lstm_multi.cuh; the plan is lstm_multi.py's
// `geometry`).

#include "lstm_multi.cuh"

namespace {

// One launch's directions and where their rows run, passed by value.
struct Dirs {
  const float* x_proj[kMaxDirs];   // (T, B, 4 H_d)
  const float* w_hh_t[kMaxDirs];   // (H_d, 4 H_d)
  const float* mask[kMaxDirs];     // (T, B)
  float* ys[kMaxDirs];             // (T, B, H_d)
  float* cs[kMaxDirs];             // (T, B, H_d) or null
  float* h_fin[kMaxDirs];          // (B, H_d)
  int H[kMaxDirs];
  int reverse[kMaxDirs];
  Group group[kMaxDirs];
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
lstm_multi_fwd_kernel(const __grid_constant__ Dirs dirs, int D, int T, int B) {
  extern __shared__ __align__(16) float smem[];
  const int d = find_group(dirs.group, D);
  if (d < 0) return;
  const Group& g = dirs.group[d];
  const int H = dirs.H[d];
  const int row0 = ((int)blockIdx.x - g.block0) * g.rows;
  const int tid = (int)threadIdx.x - g.thread0;
  const NamedSync sync{1 + d, g.threads};
  switch (lstm_nc(H)) {
    case 11:
      lstm_fwd_pass<11>(dirs.x_proj[d], dirs.w_hh_t[d], dirs.mask[d], dirs.ys[d], dirs.cs[d],
                        dirs.h_fin[d], nullptr, T, B, H, g.rows, g.units, dirs.reverse[d],
                        row0, tid, g.threads, smem + g.smem0, sync);
      break;
    case 21:
      lstm_fwd_pass<21>(dirs.x_proj[d], dirs.w_hh_t[d], dirs.mask[d], dirs.ys[d], dirs.cs[d],
                        dirs.h_fin[d], nullptr, T, B, H, g.rows, g.units, dirs.reverse[d],
                        row0, tid, g.threads, smem + g.smem0, sync);
      break;
    default:
      lstm_fwd_pass<0>(dirs.x_proj[d], dirs.w_hh_t[d], dirs.mask[d], dirs.ys[d], dirs.cs[d],
                       dirs.h_fin[d], nullptr, T, B, H, g.rows, g.units, dirs.reverse[d],
                       row0, tid, g.threads, smem + g.smem0, sync);
  }
}

// The instantiation for blocks of `threads` threads.
auto kernel_for(int threads) {
  return threads <= kLeanThreads ? lstm_multi_fwd_kernel<kLeanThreads>
                                 : lstm_multi_fwd_kernel<kMultiThreads>;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// x_proj, w_hh_t, mask, ys, cs, h_fin: host arrays of D device pointers (an
// entry of cs may be null: that direction's cs is not written); H, reverse:
// host arrays of D ints; plan: kPlanInts ints a direction (lstm_multi.cuh).
// 1 <= D <= 8.  The caller allocates every output.
int mmda_lstm_multi_fwd(const float* const* x_proj, const float* const* w_hh_t,
                        const float* const* mask, float* const* ys, float* const* cs,
                        float* const* h_fin, const int* H, const int* reverse, const int* plan,
                        int D, int T, int B, void* stream) {
  Dirs dirs = {};
  int grid = 0, threads = 0;
  size_t smem_bytes = 0;
  if (T < 1 ||
      !make_groups(H, plan, D, B, lstm_fwd_smem_floats, dirs.group, &grid, &threads, &smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int d = 0; d < D; ++d) {
    dirs.x_proj[d] = x_proj[d];
    dirs.w_hh_t[d] = w_hh_t[d];
    dirs.mask[d] = mask[d];
    dirs.ys[d] = ys[d];
    dirs.cs[d] = cs[d];
    dirs.h_fin[d] = h_fin[d];
    dirs.H[d] = H[d];
    dirs.reverse[d] = reverse[d];
  }
  const auto kernel = kernel_for(threads);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(dirs, D, T, B);
  return (int)cudaGetLastError();
}

// The launch a plan makes, launching nothing (lstm_multi.cuh's occupancy:
// registers, local memory, blocks, threads, shared memory, resident blocks
// an SM into out[0 .. 5]); 0 = ok.
int mmda_lstm_multi_fwd_geometry(const int* H, const int* plan, int D, int B, int* out) {
  Dirs dirs = {};
  int grid = 0, threads = 0;
  size_t smem_bytes = 0;
  if (!make_groups(H, plan, D, B, lstm_fwd_smem_floats, dirs.group, &grid, &threads, &smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  return occupancy(kernel_for(threads), grid, threads, smem_bytes, out);
}

}  // extern "C"
