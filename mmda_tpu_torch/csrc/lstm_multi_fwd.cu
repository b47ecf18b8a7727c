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
// one step's latency, as for lstm_fwd.cu; what one launch saves is the
// launches and the tails of three of the four.
//
// What the design does about it.  A 2-D grid: y is the direction, x a block
// of `rows` batch rows (the caller spreads B over the SMs the directions
// share).  Inside a block the loop is lstm_fwd.cu's: one thread per (row,
// hidden unit) computes its four gate dot products and the cell update, h
// double-buffered in shared memory (one barrier per step), c in a register,
// w_hh_t_d in dynamic shared memory sized for the largest H (H=74: 87.6 KB)
// or read from global memory where that does not fit.  The block is sized
// for the largest H; a direction with a smaller H leaves the spare threads
// idle (they still take the barriers).  Plain f32 FMAs, no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDirs = 8;

// One launch's directions, passed by value.
struct Dirs {
  const float* x_proj[kMaxDirs];   // (T, B, 4 H_d)
  const float* w_hh_t[kMaxDirs];   // (H_d, 4 H_d)
  const float* mask[kMaxDirs];     // (T, B)
  float* ys[kMaxDirs];             // (T, B, H_d)
  float* cs[kMaxDirs];             // (T, B, H_d) or null
  float* h_fin[kMaxDirs];          // (B, H_d)
  int H[kMaxDirs];
  int reverse[kMaxDirs];
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kWeightsInSmem>
__global__ void lstm_multi_fwd_kernel(Dirs dirs, int T, int B, int rows, int h_max) {
  extern __shared__ float smem[];
  const int d = blockIdx.y;
  const int H = dirs.H[d];
  const int G = 4 * H;
  const float* __restrict__ x_proj = dirs.x_proj[d];
  const float* __restrict__ mask = dirs.mask[d];
  float* __restrict__ ys = dirs.ys[d];
  float* __restrict__ cs = dirs.cs[d];
  const int reverse = dirs.reverse[d];
  float* h_s = smem + (kWeightsInSmem ? 4 * h_max * h_max : 0);   // (2, rows, H)
  const float* w = kWeightsInSmem ? smem : dirs.w_hh_t[d];

  if (kWeightsInSmem) {
    for (int i = threadIdx.x; i < H * G; i += blockDim.x) smem[i] = dirs.w_hh_t[d][i];
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
  if (active) dirs.h_fin[d][(size_t)b * H + j] = h;
}

template <bool kWeightsInSmem>
cudaError_t launch(const Dirs& dirs, int D, int T, int B, int rows, int h_max,
                   size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lstm_multi_fwd_kernel<kWeightsInSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = (rows * h_max + 31) / 32 * 32;
  const dim3 grid((B + rows - 1) / rows, D);
  lstm_multi_fwd_kernel<kWeightsInSmem><<<grid, threads, smem_bytes, stream>>>(
      dirs, T, B, rows, h_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// x_proj, w_hh_t, mask, ys, cs, h_fin: host arrays of D device pointers (an
// entry of cs may be null: that direction's cs is not written); H, reverse:
// host arrays of D ints.  1 <= D <= 8, rows * max(H) <= 1024.  The caller
// allocates every output.
int mmda_lstm_multi_fwd(const float* const* x_proj, const float* const* w_hh_t,
                        const float* const* mask, float* const* ys, float* const* cs,
                        float* const* h_fin, const int* H, const int* reverse, int D, int T,
                        int B, int rows, void* stream) {
  if (D < 1 || D > kMaxDirs || T < 1 || B < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  Dirs dirs = {};
  int h_max = 0;
  for (int d = 0; d < D; ++d) {
    dirs.x_proj[d] = x_proj[d];
    dirs.w_hh_t[d] = w_hh_t[d];
    dirs.mask[d] = mask[d];
    dirs.ys[d] = ys[d];
    dirs.cs[d] = cs[d];
    dirs.h_fin[d] = h_fin[d];
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
  const size_t h_bytes = 2 * (size_t)rows * h_max * sizeof(float);
  const size_t w_bytes = (size_t)h_max * 4 * h_max * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bytes + h_bytes <= (size_t)smem_optin) {
    return (int)launch<true>(dirs, D, T, B, rows, h_max, w_bytes + h_bytes, st);
  }
  return (int)launch<false>(dirs, D, T, B, rows, h_max, h_bytes, st);
}

}  // extern "C"
