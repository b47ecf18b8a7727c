// The backward (BPTT) of several masked LSTM recurrences in one launch, for
// Hopper (sm_90a), plain C entry point.
//
// Replaces mmda_tpu/ops/pallas/lstm_multi.py::_bwd_kernel (:74, launched by
// _bwd_call :157): for each of D directions, the gradient of
// lstm_multi_fwd.cu's recurrence, walking the steps in the reverse of that
// direction's processing order and recomputing the gates from the saved
// states, exactly as lstm_bwd.cu does for one direction:
//
//   h_prev, c_prev = ys_d, cs_d at the previous processed step (0 at the first)
//   dh             = dh_carry + dys_d[t]
//   gates          = x_proj_d[t] + h_prev @ w_hh_t_d        (i, f, g, o)
//   dh_new, dc_new = m * dh, m * dc;  dh_pass, dc_pass = (1 - m) * dh, dc
//   dc_new        += dh_new * o * (1 - tanh(c_new)^2)
//   dgates         = [dc_new g i(1-i), dc_new c_prev f(1-f),
//                     dc_new i (1-g^2), dh_new tanh(c_new) o(1-o)]
//   dx_proj_d[t]   = dgates;  dh_carry = dgates @ w_hh_t_d^T + dh_pass
//   dc_carry       = dc_new * f + dc_pass
//   dw_hh_t_d      = sum over t, b of h_prev^T dgates
//
// dh_carry starts at dh_fin_d, dc_carry at 0 (the TPU kernel's).  All f32,
// dW_hh summed in f64 and rounded once.  Each direction keeps its own H.
//
// What bounds it on the H100.  At (T=48, B=64, H = 35, 35, 74, 74) about
// 20 MB move (6 us at 3.35 TB/s) and 0.6 GFLOP are done (9 us at 67
// TFLOP/s); the T dependent steps of each direction are the limit, as for
// lstm_bwd.cu.
//
// What the design does about it.  The TPU kernel runs the directions as a
// sequential grid and carries dW_hh in a VMEM accumulator.  Here the four
// passes of lstm_bwd.cu (lstm_passes.cuh), each one launch for all D
// directions:
//   * lstm_multi_gates_kernel: the gate activations of every direction's
//     (t, b) into its dx_proj, off the serial chain; grid x over every
//     direction's 64 x 64 tiles;
//   * lstm_multi_bptt_kernel: the serial pass (a quad a hidden unit, the
//     weights in registers up to H = 80, the inputs through a cp.async ring,
//     one barrier a step) on the groups of lstm_multi.cuh's plan, as
//     lstm_multi_fwd.cu's, so the rows of all directions run in one wave;
//   * lstm_multi_dw_partial_kernel: dW_hh_d^T as 32 x 64 tiles, 4 x 4 f64
//     accumulators a thread, over `splits_d` runs of d's (t, b) rows; grid z
//     over (direction, run), tiles beyond a direction's H or 4H exit at once;
//   * lstm_multi_dw_sum_kernel: each direction's runs added in order,
//     rounded once, one grid row per direction.  No atomics.

#include "lstm_multi.cuh"

namespace {

// One launch's directions, passed by value.
struct Dirs {
  const float* x_proj[kMaxDirs];   // (T, B, 4 H_d)
  const float* w_hh_t[kMaxDirs];   // (H_d, 4 H_d)
  const float* mask[kMaxDirs];     // (T, B)
  const float* ys[kMaxDirs];       // (T, B, H_d)
  const float* cs[kMaxDirs];       // (T, B, H_d)
  const float* dys[kMaxDirs];      // (T, B, H_d)
  const float* dh_fin[kMaxDirs];   // (B, H_d)
  float* dx_proj[kMaxDirs];        // (T, B, 4 H_d)
  float* dw_hh_t[kMaxDirs];        // (H_d, 4 H_d)
  double* dw_partial[kMaxDirs];    // (splits_d, H_d, 4 H_d)
  int H[kMaxDirs];
  int reverse[kMaxDirs];
  int splits[kMaxDirs];
  int tile0[kMaxDirs];             // d's first block of the gate pass
  int split0[kMaxDirs];            // d's first z of the dW partials
  Group group[kMaxDirs];
};

// The last direction whose range of a grid dimension starts at or before i.
__device__ __forceinline__ int direction_at(const int* first, int D, int i) {
  int d = 0;
  while (d + 1 < D && first[d + 1] <= i) ++d;
  return d;
}

__global__ void __launch_bounds__(kGateThreads)
lstm_multi_gates_kernel(const __grid_constant__ Dirs dirs, int D, int T, int B) {
  const int d = direction_at(dirs.tile0, D, blockIdx.x);
  const int H = dirs.H[d];
  const int tiles_g = (4 * H + kGateTileG - 1) / kGateTileG;
  const int tile = blockIdx.x - dirs.tile0[d];
  lstm_gates_tile(dirs.x_proj[d], dirs.w_hh_t[d], dirs.ys[d], dirs.dx_proj[d], T, B, H,
                  dirs.reverse[d], tile / tiles_g, tile % tiles_g);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
lstm_multi_bptt_kernel(const __grid_constant__ Dirs dirs, int D, int T, int B) {
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
      lstm_bptt_pass<11>(dirs.w_hh_t[d], dirs.mask[d], dirs.cs[d], dirs.dys[d], dirs.dh_fin[d],
                         nullptr, dirs.dx_proj[d], T, B, H, g.rows, g.units, dirs.reverse[d],
                         row0, tid, g.threads, smem + g.smem0, sync);
      break;
    case 21:
      lstm_bptt_pass<21>(dirs.w_hh_t[d], dirs.mask[d], dirs.cs[d], dirs.dys[d], dirs.dh_fin[d],
                         nullptr, dirs.dx_proj[d], T, B, H, g.rows, g.units, dirs.reverse[d],
                         row0, tid, g.threads, smem + g.smem0, sync);
      break;
    default:
      lstm_bptt_pass<0>(dirs.w_hh_t[d], dirs.mask[d], dirs.cs[d], dirs.dys[d], dirs.dh_fin[d],
                        nullptr, dirs.dx_proj[d], T, B, H, g.rows, g.units, dirs.reverse[d],
                        row0, tid, g.threads, smem + g.smem0, sync);
  }
}

// Block (x, y, z), z = split0[d] + split: the (32 x 64) tile (y, x) of
// dW_hh_d^T over run `split` of d's rows.
__global__ void __launch_bounds__(kDwThreads)
lstm_multi_dw_partial_kernel(const __grid_constant__ Dirs dirs, int D, int T, int B) {
  const int d = direction_at(dirs.split0, D, blockIdx.z);
  const int H = dirs.H[d];
  if ((int)blockIdx.x * kDwTileG >= 4 * H || (int)blockIdx.y * kDwTileK >= H) return;
  const int split = blockIdx.z - dirs.split0[d];
  lstm_dw_partial_tile(dirs.ys[d], dirs.dx_proj[d],
                       dirs.dw_partial[d] + (size_t)split * H * 4 * H, T, B, H, dirs.reverse[d],
                       blockIdx.x, blockIdx.y, split, dirs.splits[d]);
}

__global__ void lstm_multi_dw_sum_kernel(const __grid_constant__ Dirs dirs) {
  const int d = blockIdx.y;
  const int n = dirs.H[d] * 4 * dirs.H[d];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) lstm_dw_sum_at(dirs.dw_partial[d], dirs.dw_hh_t[d], n, dirs.splits[d], i);
}

// The BPTT instantiation for blocks of `threads` threads.
auto bptt_kernel_for(int threads) {
  return threads <= kLeanThreads ? lstm_multi_bptt_kernel<kLeanThreads>
                                 : lstm_multi_bptt_kernel<kMultiThreads>;
}

}  // namespace

extern "C" {

// Launches the four kernels on `stream` (the gate pass into dx_proj, the
// BPTT pass over it, then the dW partials, which read the dgates the BPTT
// pass left in dx_proj, then their sums) and returns the first nonzero
// cudaError as an int (0 = ok).  x_proj .. dw_hh_t: host arrays of D device
// pointers; H, reverse, splits: host arrays of D ints (splits >= 1);
// dw_partial: device f64 scratch of sum over d of splits_d H_d 4 H_d,
// direction after direction; plan: kPlanInts ints a direction
// (lstm_multi.cuh).  1 <= D <= 8.
int mmda_lstm_multi_bwd(const float* const* x_proj, const float* const* w_hh_t,
                        const float* const* mask, const float* const* ys,
                        const float* const* cs, const float* const* dys,
                        const float* const* dh_fin, float* const* dx_proj,
                        float* const* dw_hh_t, double* dw_partial, const int* H,
                        const int* reverse, const int* splits, const int* plan, int D, int T,
                        int B, void* stream) {
  Dirs dirs = {};
  int grid = 0, threads = 0;
  size_t smem_bytes = 0;
  if (T < 1 ||
      !make_groups(H, plan, D, B, lstm_bptt_smem_floats, dirs.group, &grid, &threads,
                   &smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  int gate_tiles = 0, runs = 0, n_max = 0, h_max = 0;
  size_t partial = 0;
  for (int d = 0; d < D; ++d) {
    if (splits[d] < 1) return (int)cudaErrorInvalidValue;
    dirs.x_proj[d] = x_proj[d];
    dirs.w_hh_t[d] = w_hh_t[d];
    dirs.mask[d] = mask[d];
    dirs.ys[d] = ys[d];
    dirs.cs[d] = cs[d];
    dirs.dys[d] = dys[d];
    dirs.dh_fin[d] = dh_fin[d];
    dirs.dx_proj[d] = dx_proj[d];
    dirs.dw_hh_t[d] = dw_hh_t[d];
    dirs.dw_partial[d] = dw_partial + partial;
    dirs.H[d] = H[d];
    dirs.reverse[d] = reverse[d];
    dirs.splits[d] = splits[d];
    dirs.tile0[d] = gate_tiles;
    dirs.split0[d] = runs;
    const int G = 4 * H[d];
    gate_tiles += (T * B + kGateTileN - 1) / kGateTileN * ((G + kGateTileG - 1) / kGateTileG);
    runs += splits[d];
    partial += (size_t)splits[d] * H[d] * G;
    n_max = imax(n_max, H[d] * G);
    h_max = imax(h_max, H[d]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lstm_multi_gates_kernel<<<gate_tiles, kGateThreads, 0, st>>>(dirs, D, T, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto bptt = bptt_kernel_for(threads);
  err = cudaFuncSetAttribute(bptt, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  bptt<<<grid, threads, smem_bytes, st>>>(dirs, D, T, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 dw_grid((4 * h_max + kDwTileG - 1) / kDwTileG, (h_max + kDwTileK - 1) / kDwTileK,
                     runs);
  lstm_multi_dw_partial_kernel<<<dw_grid, kDwThreads, 0, st>>>(dirs, D, T, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstm_multi_dw_sum_kernel<<<dim3((n_max + 255) / 256, D), 256, 0, st>>>(dirs);
  return (int)cudaGetLastError();
}

// The BPTT launch a plan makes, launching nothing (lstm_multi.cuh's
// occupancy into out[0 .. 5]); 0 = ok.
int mmda_lstm_multi_bwd_geometry(const int* H, const int* plan, int D, int B, int* out) {
  Dirs dirs = {};
  int grid = 0, threads = 0;
  size_t smem_bytes = 0;
  if (!make_groups(H, plan, D, B, lstm_bptt_smem_floats, dirs.group, &grid, &threads,
                   &smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  return occupancy(bptt_kernel_for(threads), grid, threads, smem_bytes, out);
}

}  // extern "C"
