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
// What bounds it on the H100.  At the training shape (T=48, B=64, H=74) the
// inputs and outputs are about 10 MB (3 us at 3.35 TB/s) and the arithmetic
// about 0.4 GFLOP (6 us at 67 TFLOP/s f32).  Neither is the limit: the T
// steps are dependent, each two (rows, H) x (H, 4H)-sized products, the cell
// math and two barriers, so the time is T times one step's latency.
//
// What the design does about it.  The TPU kernels hold (a time chunk of) the
// whole T extent in VMEM and carry dW_hh in a scratch accumulator across a
// grid that runs in order.  On Hopper blocks run in parallel and share
// nothing, so the work is split in two kernels of this file:
//   * lstm_bptt_kernel: batch rows spread over the SMs (the caller picks
//     `rows`, as for the forward), one thread per (row, hidden unit j), one
//     loop over all T steps in the block.  Thread j recomputes unit j's four
//     gates, does unit j's cell backward with dh and dc in registers, writes
//     its four dgates to dx_proj and to shared memory; after a barrier it
//     forms dh_prev[j] from all 4H dgates of its row and row j of w_hh_t.
//     Two barriers per step.
//   * w_hh_t in dynamic shared memory when it fits (H=74: 87.9 KB, opted in
//     with cudaFuncSetAttribute), with a row stride of 4H + 1: the gate
//     products read it by column (neighbouring threads, neighbouring words)
//     and dh_prev by row (stride 4H + 1 is odd, so a warp's 32 rows fall in
//     32 banks).  Larger H (H=300: 1.44 MB) reads it from global memory.
//   * lstm_dw_partial_kernel + lstm_dw_sum_kernel: dW_hh^T = sum over (t, b)
//     of h_prev^T dgates as a tiled (H x T*B) x (T*B x 4H) product over the
//     dx_proj just written and ys shifted by one processed step.  The steps
//     are cut into `splits` runs (the caller picks enough to fill the SMs:
//     H=74 has only 25 output tiles), each block sums its tile over its run,
//     and a second pass adds the runs in order.  All sums in f64 (exact
//     products, so T * B terms do not drift with the order): deterministic,
//     no atomics.
//   * Otherwise plain f32 FMAs, no tensor cores (TF32 would change the
//     numbers the JAX package computes).
// Shorter steps (several rows per thread, warp-split dot products, wgmma),
// and fusing the dW reduction into the BPTT loop, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kDwTileK = 16;   // dW tile: 16 hidden units (rows of dW_hh^T)
constexpr int kDwTileG = 64;   // x 64 gate columns, 256 threads
constexpr int kDwChunk = 32;   // batch rows of one step per shared-memory pass

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kWeightsInSmem>
__global__ void lstm_bptt_kernel(const float* __restrict__ x_proj,  // (T, B, 4H)
                                 const float* __restrict__ w_hh_t,  // (H, 4H)
                                 const float* __restrict__ mask,    // (T, B)
                                 const float* __restrict__ ys,      // (T, B, H)
                                 const float* __restrict__ cs,      // (T, B, H)
                                 const float* __restrict__ dys,     // (T, B, H)
                                 const float* __restrict__ dh_fin,  // (B, H)
                                 const float* __restrict__ dc_fin,  // (B, H) or null
                                 float* __restrict__ dx_proj,       // (T, B, 4H)
                                 int T, int B, int H, int rows, int reverse) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  // w row stride: 4H + 1 in shared memory (bank spread for the row reads)
  const int ws = kWeightsInSmem ? G + 1 : G;
  float* h_s = smem + (kWeightsInSmem ? H * ws : 0);   // (rows, H) h_prev
  float* dg_s = h_s + rows * H;                        // (rows, 4H) dgates
  const float* w = kWeightsInSmem ? smem : w_hh_t;

  if (kWeightsInSmem) {
    for (int i = threadIdx.x; i < H * G; i += blockDim.x) {
      const int k = i / G;
      smem[k * ws + (i - k * G)] = w_hh_t[i];
    }
  }

  const int r = threadIdx.x / H;      // row within the block
  const int j = threadIdx.x - r * H;  // hidden unit
  const int b = blockIdx.x * rows + r;
  const bool active = r < rows && b < B;

  float dh = 0.0f;
  float dc = 0.0f;
  if (active) {
    dh = dh_fin[(size_t)b * H + j];
    if (dc_fin != nullptr) dc = dc_fin[(size_t)b * H + j];
  }
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

// dw_hh_t[k, g] = sum over t, b of h_prev[t, b, k] * dx_proj[t, b, g], where
// h_prev[t] = ys[t - 1] (forward direction) or ys[t + 1] (reverse), 0 at the
// first processed step.  Sums are taken in f64: the product of two f32 values
// is exact in f64, so the result is the f32 rounding of the exact sum whatever
// the order, and the plain version (which also sums in f64) agrees with it to
// within the rounding of its inputs even over T * B = 16384 terms.
//
// lstm_dw_partial_kernel: block (x, y, z) sums the (16 x 64) tile (y, x) of
// dW_hh^T over the z-th of `splits` equal runs of processed steps, one thread
// per 4 outputs, and writes its f64 partial to dw_partial[z].
__global__ void lstm_dw_partial_kernel(const float* __restrict__ ys,      // (T, B, H)
                                       const float* __restrict__ dx_proj, // (T, B, 4H)
                                       double* __restrict__ dw_partial,   // (splits, H, 4H)
                                       int T, int B, int H, int reverse) {
  __shared__ float h_s[kDwChunk][kDwTileK];
  __shared__ float d_s[kDwChunk][kDwTileG];
  const int G = 4 * H;
  const int tx = threadIdx.x;                 // 0..63: gate column in the tile
  const int ty = threadIdx.y;                 // 0..3
  const int tid = ty * kDwTileG + tx;
  const int g0 = blockIdx.x * kDwTileG;
  const int k0 = blockIdx.y * kDwTileK;
  // the first processed step adds 0: steps s = 0 .. T-2 carry an h_prev
  const int per_split = (T - 1 + gridDim.z - 1) / gridDim.z;
  const int s_begin = blockIdx.z * per_split;
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
        const double d = d_s[n][tx];
#pragma unroll
        for (int q = 0; q < kDwTileK / 4; ++q) {
          acc[q] = fma((double)h_s[n][ty + 4 * q], d, acc[q]);
        }
      }
      __syncthreads();
    }
  }
  const int g = g0 + tx;
  if (g < G) {
    double* out = dw_partial + (size_t)blockIdx.z * H * G;
#pragma unroll
    for (int q = 0; q < kDwTileK / 4; ++q) {
      const int k = k0 + ty + 4 * q;
      if (k < H) out[(size_t)k * G + g] = acc[q];
    }
  }
}

// dw_hh_t = the partials summed in split order, rounded once to f32.
__global__ void lstm_dw_sum_kernel(const double* __restrict__ dw_partial,
                                   float* __restrict__ dw_hh_t, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double sum = 0.0;
  for (int z = 0; z < splits; ++z) sum += dw_partial[(size_t)z * n + i];
  dw_hh_t[i] = (float)sum;
}

template <bool kWeightsInSmem>
cudaError_t launch_bptt(const float* x_proj, const float* w_hh_t,
                        const float* mask, const float* ys, const float* cs,
                        const float* dys, const float* dh_fin,
                        const float* dc_fin, float* dx_proj, int T, int B,
                        int H, int rows, int reverse, size_t smem_bytes,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bptt_kernel<kWeightsInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = (rows * H + 31) / 32 * 32;
  const int blocks = (B + rows - 1) / rows;
  lstm_bptt_kernel<kWeightsInSmem><<<blocks, threads, smem_bytes, stream>>>(
      x_proj, w_hh_t, mask, ys, cs, dys, dh_fin, dc_fin, dx_proj, T, B, H,
      rows, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` (BPTT, then the dW partials, which
// read the dx_proj the first one wrote, then their sum) and returns the first
// nonzero cudaError as an int (0 = ok).  The caller allocates dx_proj,
// dw_hh_t and the (splits, H, 4H) f64 scratch dw_partial; dc_fin may be null
// (zeros).  rows * H <= 1024, splits >= 1.
int mmda_lstm_bwd(const float* x_proj, const float* w_hh_t, const float* mask,
                  const float* ys, const float* cs, const float* dys,
                  const float* dh_fin, const float* dc_fin, float* dx_proj,
                  float* dw_hh_t, double* dw_partial, int T, int B, int H,
                  int rows, int reverse, int splits, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int G = 4 * H;
  const size_t buf_bytes = (size_t)rows * (H + G) * sizeof(float);
  const size_t w_bytes = (size_t)H * (G + 1) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bytes + buf_bytes <= (size_t)smem_optin) {
    err = launch_bptt<true>(x_proj, w_hh_t, mask, ys, cs, dys, dh_fin, dc_fin,
                            dx_proj, T, B, H, rows, reverse,
                            w_bytes + buf_bytes, st);
  } else {
    err = launch_bptt<false>(x_proj, w_hh_t, mask, ys, cs, dys, dh_fin, dc_fin,
                             dx_proj, T, B, H, rows, reverse, buf_bytes, st);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + kDwTileG - 1) / kDwTileG, (H + kDwTileK - 1) / kDwTileK,
                  splits);
  lstm_dw_partial_kernel<<<grid, dim3(kDwTileG, 4), 0, st>>>(ys, dx_proj,
                                                              dw_partial, T, B,
                                                              H, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * G;
  lstm_dw_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(dw_partial, dw_hh_t, n,
                                                       splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
