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
// sequential grid and carries dW_hh in a VMEM accumulator.  Here three
// kernels of this file, each one launch for all D directions:
//   * lstm_multi_bptt_kernel: grid (batch-row block, direction), the
//     lstm_bwd.cu loop in each block (one thread per (row, hidden unit), w_hh_t
//     in shared memory with row stride 4H + 1, two barriers per step), sized
//     for the largest H;
//   * lstm_multi_dw_partial_kernel: dW_hh_d^T as a tiled (H x T*B) x
//     (T*B x 4H) product over the dx_proj_d just written and ys_d shifted by
//     one processed step; grid z runs over (direction, run of steps), tiles
//     beyond a direction's H or 4H exit at once; f64 sums, no atomics;
//   * lstm_multi_dw_sum_kernel: the runs added in order, rounded once, one
//     grid row per direction.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDirs = 8;
constexpr int kDwTileK = 16;   // dW tile: 16 hidden units (rows of dW_hh^T)
constexpr int kDwTileG = 64;   // x 64 gate columns, 256 threads
constexpr int kDwChunk = 32;   // batch rows of one step per shared-memory pass

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
  int H[kMaxDirs];
  int reverse[kMaxDirs];
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kWeightsInSmem>
__global__ void lstm_multi_bptt_kernel(Dirs dirs, int T, int B, int rows, int h_max) {
  extern __shared__ float smem[];
  const int d = blockIdx.y;
  const int H = dirs.H[d];
  const int G = 4 * H;
  const float* __restrict__ x_proj = dirs.x_proj[d];
  const float* __restrict__ mask = dirs.mask[d];
  const float* __restrict__ ys = dirs.ys[d];
  const float* __restrict__ cs = dirs.cs[d];
  const float* __restrict__ dys = dirs.dys[d];
  float* __restrict__ dx_proj = dirs.dx_proj[d];
  const int reverse = dirs.reverse[d];
  // w row stride: 4H + 1 in shared memory (bank spread for the row reads)
  const int ws = kWeightsInSmem ? G + 1 : G;
  float* h_s = smem + (kWeightsInSmem ? h_max * (4 * h_max + 1) : 0);   // (rows, H)
  float* dg_s = h_s + rows * H;                                        // (rows, 4H)
  const float* w = kWeightsInSmem ? smem : dirs.w_hh_t[d];

  if (kWeightsInSmem) {
    for (int i = threadIdx.x; i < H * G; i += blockDim.x) {
      const int k = i / G;
      smem[k * ws + (i - k * G)] = dirs.w_hh_t[d][i];
    }
  }

  const int r = threadIdx.x / H;      // row within the block
  const int j = threadIdx.x - r * H;  // hidden unit
  const int b = blockIdx.x * rows + r;
  const bool active = r < rows && b < B;

  float dh = 0.0f;
  float dc = 0.0f;
  if (active) dh = dirs.dh_fin[d][(size_t)b * H + j];
  for (int s = 0; s < T; ++s) {
    // reverse of the forward's processing order
    const int t = reverse ? s : T - 1 - s;
    const bool first = reverse ? (t == T - 1) : (t == 0);
    const int prev_t = reverse ? t + 1 : t - 1;   // read only when !first
    const size_t row = (size_t)t * B + b;
    float c_prev = 0.0f;
    if (active) {
      float h_prev = 0.0f;
      if (!first) {
        const size_t prow = ((size_t)prev_t * B + b) * H + j;
        h_prev = ys[prow];
        c_prev = cs[prow];
      }
      h_s[r * H + j] = h_prev;
    }
    __syncthreads();
    if (active) {
      const float* hp = h_s + r * H;
      float ai = 0.0f, af = 0.0f, ag = 0.0f, ao = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float hk = hp[k];
        const float* wk = w + (size_t)k * ws + j;
        ai = fmaf(hk, wk[0], ai);
        af = fmaf(hk, wk[H], af);
        ag = fmaf(hk, wk[2 * H], ag);
        ao = fmaf(hk, wk[3 * H], ao);
      }
      const float* xp = x_proj + row * G + j;
      const float ig = sigmoid_f(xp[0] + ai);
      const float fg = sigmoid_f(xp[H] + af);
      const float gg = tanhf(xp[2 * H] + ag);
      const float og = sigmoid_f(xp[3 * H] + ao);
      const float c_new = fg * c_prev + ig * gg;
      const float tanh_c = tanhf(c_new);

      const float m = mask[row];
      dh += dys[row * H + j];
      const float dh_new = m * dh;
      float dc_new = m * dc;
      const float dh_pass = (1.0f - m) * dh;
      const float dc_pass = (1.0f - m) * dc;
      dc_new = dc_new + dh_new * og * (1.0f - tanh_c * tanh_c);
      const float d_og = dh_new * tanh_c;
      const float d_ig = dc_new * gg;
      const float d_fg = dc_new * c_prev;
      const float d_gg = dc_new * ig;
      dc = dc_new * fg + dc_pass;

      const float dgi = d_ig * ig * (1.0f - ig);
      const float dgf = d_fg * fg * (1.0f - fg);
      const float dgg = d_gg * (1.0f - gg * gg);
      const float dgo = d_og * og * (1.0f - og);
      float* dx = dx_proj + row * G + j;
      dx[0] = dgi;
      dx[H] = dgf;
      dx[2 * H] = dgg;
      dx[3 * H] = dgo;
      float* dg = dg_s + r * G + j;
      dg[0] = dgi;
      dg[H] = dgf;
      dg[2 * H] = dgg;
      dg[3 * H] = dgo;
      dh = dh_pass;   // dh_prev = dgates @ w_hh_t^T + dh_pass, summed below
    }
    __syncthreads();
    if (active) {
      const float* dg = dg_s + r * G;
      const float* wj = w + (size_t)j * ws;
      float acc = 0.0f;
      for (int g = 0; g < G; ++g) acc = fmaf(dg[g], wj[g], acc);
      dh += acc;
    }
    // the next step's first barrier orders these dg_s reads before its writes
  }
}

// Block (x, y, z) with z = d * splits + split sums the (16 x 64) tile (y, x)
// of dW_hh_d^T over the split-th of `splits` equal runs of d's processed
// steps (the first processed step adds 0), one thread per 4 outputs, and
// writes its f64 partial to dw_partial[d][split] (row stride 4 h_max).
__global__ void lstm_multi_dw_partial_kernel(Dirs dirs, double* __restrict__ dw_partial,
                                             int T, int B, int h_max, int splits) {
  __shared__ float h_s[kDwChunk][kDwTileK];
  __shared__ float d_s[kDwChunk][kDwTileG];
  const int d = blockIdx.z / splits;
  const int split = blockIdx.z - d * splits;
  const int H = dirs.H[d];
  const int G = 4 * H;
  const int g0 = blockIdx.x * kDwTileG;
  const int k0 = blockIdx.y * kDwTileK;
  if (g0 >= G || k0 >= H) return;     // a tile of a larger direction
  const float* __restrict__ ys = dirs.ys[d];
  const float* __restrict__ dx_proj = dirs.dx_proj[d];
  const int reverse = dirs.reverse[d];
  const int tx = threadIdx.x;                 // 0..63: gate column in the tile
  const int ty = threadIdx.y;                 // 0..3
  const int tid = ty * kDwTileG + tx;
  const int per_split = (T - 1 + splits - 1) / splits;
  const int s_begin = split * per_split;
  const int s_end = min(T - 1, s_begin + per_split);
  double acc[kDwTileK / 4] = {0.0, 0.0, 0.0, 0.0};

  for (int s = s_begin; s < s_end; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const int prev_t = reverse ? t + 1 : t - 1;
    for (int b0 = 0; b0 < B; b0 += kDwChunk) {
      for (int i = tid; i < kDwChunk * kDwTileG; i += 4 * kDwTileG) {
        const int b = b0 + i / kDwTileG;
        const int g = g0 + i % kDwTileG;
        d_s[i / kDwTileG][i % kDwTileG] =
            (b < B && g < G) ? dx_proj[((size_t)t * B + b) * G + g] : 0.0f;
      }
      for (int i = tid; i < kDwChunk * kDwTileK; i += 4 * kDwTileG) {
        const int b = b0 + i / kDwTileK;
        const int k = k0 + i % kDwTileK;
        h_s[i / kDwTileK][i % kDwTileK] =
            (b < B && k < H) ? ys[((size_t)prev_t * B + b) * H + k] : 0.0f;
      }
      __syncthreads();
      const int n_b = min(kDwChunk, B - b0);
      for (int n = 0; n < n_b; ++n) {
        const double dv = d_s[n][tx];
#pragma unroll
        for (int q = 0; q < kDwTileK / 4; ++q) {
          acc[q] = fma((double)h_s[n][ty + 4 * q], dv, acc[q]);
        }
      }
      __syncthreads();
    }
  }
  const int g = g0 + tx;
  if (g < G) {
    double* out = dw_partial + (size_t)blockIdx.z * h_max * 4 * h_max;
#pragma unroll
    for (int q = 0; q < kDwTileK / 4; ++q) {
      const int k = k0 + ty + 4 * q;
      if (k < H) out[(size_t)k * G + g] = acc[q];
    }
  }
}

// dw_hh_t_d = d's partials summed in split order, rounded once to f32.
__global__ void lstm_multi_dw_sum_kernel(Dirs dirs, const double* __restrict__ dw_partial,
                                         int h_max, int splits) {
  const int d = blockIdx.y;
  const int n = dirs.H[d] * 4 * dirs.H[d];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t stride = (size_t)h_max * 4 * h_max;
  const double* part = dw_partial + (size_t)d * splits * stride;
  double sum = 0.0;
  for (int z = 0; z < splits; ++z) sum += part[(size_t)z * stride + i];
  dirs.dw_hh_t[d][i] = (float)sum;
}

template <bool kWeightsInSmem>
cudaError_t launch_bptt(const Dirs& dirs, int D, int T, int B, int rows, int h_max,
                        size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lstm_multi_bptt_kernel<kWeightsInSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = (rows * h_max + 31) / 32 * 32;
  const dim3 grid((B + rows - 1) / rows, D);
  lstm_multi_bptt_kernel<kWeightsInSmem><<<grid, threads, smem_bytes, stream>>>(
      dirs, T, B, rows, h_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` (BPTT, then the dW partials, which
// read the dx_proj the first one wrote, then their sums) and returns the
// first nonzero cudaError as an int (0 = ok).  x_proj .. dw_hh_t: host
// arrays of D device pointers; H, reverse: host arrays of D ints;
// dw_partial: device f64 scratch of D * splits * max(H) * 4 max(H).
// 1 <= D <= 8, rows * max(H) <= 1024, splits >= 1.
int mmda_lstm_multi_bwd(const float* const* x_proj, const float* const* w_hh_t,
                        const float* const* mask, const float* const* ys,
                        const float* const* cs, const float* const* dys,
                        const float* const* dh_fin, float* const* dx_proj,
                        float* const* dw_hh_t, double* dw_partial, const int* H,
                        const int* reverse, int D, int T, int B, int rows, int splits,
                        void* stream) {
  if (D < 1 || D > kMaxDirs || T < 1 || B < 1 || rows < 1 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Dirs dirs = {};
  int h_max = 0;
  for (int d = 0; d < D; ++d) {
    dirs.x_proj[d] = x_proj[d];
    dirs.w_hh_t[d] = w_hh_t[d];
    dirs.mask[d] = mask[d];
    dirs.ys[d] = ys[d];
    dirs.cs[d] = cs[d];
    dirs.dys[d] = dys[d];
    dirs.dh_fin[d] = dh_fin[d];
    dirs.dx_proj[d] = dx_proj[d];
    dirs.dw_hh_t[d] = dw_hh_t[d];
    dirs.H[d] = H[d];
    dirs.reverse[d] = reverse[d];
    if (H[d] < 1) return (int)cudaErrorInvalidValue;
    h_max = H[d] > h_max ? H[d] : h_max;
  }
  if (rows * h_max > 1024) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int g_max = 4 * h_max;
  const size_t buf_bytes = (size_t)rows * (h_max + g_max) * sizeof(float);
  const size_t w_bytes = (size_t)h_max * (g_max + 1) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bytes + buf_bytes <= (size_t)smem_optin) {
    err = launch_bptt<true>(dirs, D, T, B, rows, h_max, w_bytes + buf_bytes, st);
  } else {
    err = launch_bptt<false>(dirs, D, T, B, rows, h_max, buf_bytes, st);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g_max + kDwTileG - 1) / kDwTileG, (h_max + kDwTileK - 1) / kDwTileK,
                  D * splits);
  lstm_multi_dw_partial_kernel<<<grid, dim3(kDwTileG, 4), 0, st>>>(dirs, dw_partial, T, B,
                                                                    h_max, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 sum_grid((h_max * g_max + 255) / 256, D);
  lstm_multi_dw_sum_kernel<<<sum_grid, 256, 0, st>>>(dirs, dw_partial, h_max, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
