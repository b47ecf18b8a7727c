// Masked GRU backward recurrence (BPTT) for Hopper (sm_90a), plain C entry.
//
// Replaces mmda_tpu/ops/pallas/gru.py::_bwd_kernel (:194, whole-T, launched
// by _whole_bwd_call) and ::_stream_bwd_kernel (:341, its time-chunked twin
// for long T).  Both compute the same function: the gradient of the masked
// forward recurrence of gru_fwd.cu, walking the steps in the reverse of the
// forward's processing order and recomputing the gates from the saved h
// sequence (_cell_bwd, :57):
//
//   h_prev  = ys at the previous processed step (0 at the first)
//   dh      = dh_carry + dys[t]
//   hh      = h_prev @ w_hh_t + b_hh;  r, z, n as in the forward
//   dh_new  = m * dh;  dh_pass = (1 - m) * dh
//   dz      = dh_new * (h_prev - n);   dn = dh_new * (1 - z)
//   dpre_n  = dn * (1 - n^2);  dpre_r = dpre_n * hh_n * r (1 - r)
//   dpre_z  = dz * z (1 - z)
//   dx_proj[t] = dgx = [dpre_r, dpre_z, dpre_n]
//   dgh        = [dpre_r, dpre_z, dpre_n * r]     (the n lane is r-scaled)
//   dh_carry   = dgh @ w_hh_t^T + dh_new * z + dh_pass
//   dw_hh_t    = sum over t, b of h_prev^T dgh;   db_hh = sum over t, b of dgh
//
// All f32; dh_carry starts at dh_fin.  dx_proj is zero at masked steps and
// the dys of padded steps still flow through dh_pass.
//
// What bounds it on the H100.  As for lstm_bwd.cu: about 8 MB of inputs and
// outputs and 0.3 GFLOP at the training shape (T=48, B=64, H=74), a few
// microseconds of either; the T steps are dependent, each two (rows, H) x
// (H, 3H)-sized products, the cell math and two barriers, so the time is T
// times one step's latency.
//
// What the design does about it.  The TPU kernels carry dW_hh and db_hh in
// scratch accumulators across a grid that runs in order.  On Hopper blocks
// run in parallel and share nothing, so the work is split as in lstm_bwd.cu:
//   * gru_bptt_kernel: batch rows spread over the SMs, one thread per (row,
//     hidden unit j), one loop over all T steps.  Thread j recomputes unit
//     j's three gates, does unit j's cell backward with dh in a register,
//     writes dgx to dx_proj, the n lane of dgh to the scratch dhn (dgh's r
//     and z lanes are dx_proj's) and all of dgh to shared memory; after a
//     barrier it forms dh_prev[j] from the 3H dgh of its row and row j of
//     w_hh_t.  Two barriers per step.  w_hh_t in dynamic shared memory when
//     it fits (H=74: 66.0 KB), row stride 3H + 1 so that the row reads of
//     the dh_prev product spread over the banks.
//   * gru_dwb_partial_kernel + gru_dwb_sum_kernel: dW_hh^T and db_hh
//     together as one (H + 1, 3H) result, row k < H the sum of h_prev[k] *
//     dgh and row H the sum of 1 * dgh.  The steps are cut into `splits`
//     runs, each block sums its (16 x 64) tile over its run in f64 (exact
//     products, so the T * B terms do not drift with the order), and a
//     second pass adds the runs in order and rounds once: deterministic, no
//     atomics.  Unlike the LSTM's reduction it cannot read dx_proj alone:
//     the n lane comes from dhn.
// Shorter steps (warp-split dot products, wgmma) and fusing the reduction
// into the BPTT loop are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kDwTileK = 16;   // tile: 16 rows of the (H + 1, 3H) result
constexpr int kDwTileG = 64;   // x 64 gate columns, 256 threads
constexpr int kDwChunk = 32;   // batch rows of one step per shared-memory pass

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool kWeightsInSmem>
__global__ void gru_bptt_kernel(const float* __restrict__ x_proj,  // (T, B, 3H)
                                const float* __restrict__ w_hh_t,  // (H, 3H)
                                const float* __restrict__ b_hh,    // (3H,)
                                const float* __restrict__ mask,    // (T, B)
                                const float* __restrict__ ys,      // (T, B, H)
                                const float* __restrict__ dys,     // (T, B, H)
                                const float* __restrict__ dh_fin,  // (B, H)
                                float* __restrict__ dx_proj,       // (T, B, 3H)
                                float* __restrict__ dhn,           // (T, B, H)
                                int T, int B, int H, int rows, int reverse) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  // w row stride: 3H + 1 in shared memory (bank spread for the row reads)
  const int ws = kWeightsInSmem ? G + 1 : G;
  float* h_s = smem + (kWeightsInSmem ? H * ws : 0);   // (rows, H) h_prev
  float* dg_s = h_s + rows * H;                        // (rows, 3H) dgh
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

  float dh = 0.0f, br = 0.0f, bz = 0.0f, bn = 0.0f;
  if (active) {
    dh = dh_fin[(size_t)b * H + j];
    br = b_hh[j];
    bz = b_hh[H + j];
    bn = b_hh[2 * H + j];
  }
  for (int s = 0; s < T; ++s) {
    // reverse of the forward's processing order
    const int t = reverse ? s : T - 1 - s;
    const bool first = reverse ? (t == T - 1) : (t == 0);
    const int prev_t = reverse ? t + 1 : t - 1;   // read only when !first
    const size_t row = (size_t)t * B + b;
    float h_prev = 0.0f;
    if (active) {
      if (!first) h_prev = ys[((size_t)prev_t * B + b) * H + j];
      h_s[r * H + j] = h_prev;
    }
    __syncthreads();
    if (active) {
      const float* hp = h_s + r * H;
      float ar = 0.0f, az = 0.0f, an = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float hk = hp[k];
        const float* wk = w + (size_t)k * ws + j;
        ar = fmaf(hk, wk[0], ar);
        az = fmaf(hk, wk[H], az);
        an = fmaf(hk, wk[2 * H], an);
      }
      const float* xp = x_proj + row * G + j;
      const float hn = an + bn;
      const float rg = sigmoid_f(xp[0] + (ar + br));
      const float zg = sigmoid_f(xp[H] + (az + bz));
      const float ng = tanhf(xp[2 * H] + rg * hn);

      const float m = mask[row];
      dh += dys[row * H + j];
      const float dh_new = m * dh;
      const float dh_pass = (1.0f - m) * dh;
      const float dz = dh_new * (h_prev - ng);
      const float dn = dh_new * (1.0f - zg);
      const float dpre_n = dn * (1.0f - ng * ng);
      const float dr = dpre_n * hn;
      const float dhn_j = dpre_n * rg;
      const float dpre_r = dr * rg * (1.0f - rg);
      const float dpre_z = dz * zg * (1.0f - zg);

      float* dx = dx_proj + row * G + j;
      dx[0] = dpre_r;
      dx[H] = dpre_z;
      dx[2 * H] = dpre_n;
      dhn[row * H + j] = dhn_j;
      float* dg = dg_s + r * G + j;
      dg[0] = dpre_r;
      dg[H] = dpre_z;
      dg[2 * H] = dhn_j;
      dh = dh_new * zg + dh_pass;   // + dgh @ w_hh_t^T, summed below
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

// out[k, g] = sum over t, b of a[t, b, k] * dgh[t, b, g] for k in 0..H, where
// a[.., k] = h_prev[t, b, k] for k < H (ys at the previous processed step, 0
// at the first) and a[.., H] = 1 (the db_hh row), and dgh[.., g] is
// dx_proj[.., g] for g < 2H and dhn[.., g - 2H] above.  Sums in f64: the
// product of two f32 values is exact in f64, so the result is the f32
// rounding of the exact sum whatever the order, and the plain version (which
// also sums in f64) agrees with it even over T * B = 16384 terms.
//
// gru_dwb_partial_kernel: block (x, y, z) sums the (16 x 64) tile (y, x)
// over the z-th of `splits` equal runs of steps, one thread per 4 outputs,
// and writes its f64 partial to partial[z].
__global__ void gru_dwb_partial_kernel(const float* __restrict__ ys,      // (T, B, H)
                                       const float* __restrict__ dx_proj, // (T, B, 3H)
                                       const float* __restrict__ dhn,     // (T, B, H)
                                       double* __restrict__ partial,      // (splits, H+1, 3H)
                                       int T, int B, int H, int reverse) {
  __shared__ float a_s[kDwChunk][kDwTileK];
  __shared__ float d_s[kDwChunk][kDwTileG];
  const int G = 3 * H;
  const int tx = threadIdx.x;                 // 0..63: gate column in the tile
  const int ty = threadIdx.y;                 // 0..3
  const int tid = ty * kDwTileG + tx;
  const int g0 = blockIdx.x * kDwTileG;
  const int k0 = blockIdx.y * kDwTileK;
  const int per_split = (T + gridDim.z - 1) / gridDim.z;
  const int s_begin = blockIdx.z * per_split;
  const int s_end = min(T, s_begin + per_split);
  double acc[kDwTileK / 4] = {0.0, 0.0, 0.0, 0.0};

  for (int s = s_begin; s < s_end; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const bool first = reverse ? (t == T - 1) : (t == 0);
    const int prev_t = reverse ? t + 1 : t - 1;   // read only when !first
    for (int b0 = 0; b0 < B; b0 += kDwChunk) {
      for (int i = tid; i < kDwChunk * kDwTileG; i += 4 * kDwTileG) {
        const int b = b0 + i / kDwTileG;
        const int g = g0 + i % kDwTileG;
        float d = 0.0f;
        if (b < B && g < G) {
          const size_t row = (size_t)t * B + b;
          d = g < 2 * H ? dx_proj[row * G + g] : dhn[row * H + (g - 2 * H)];
        }
        d_s[i / kDwTileG][i % kDwTileG] = d;
      }
      for (int i = tid; i < kDwChunk * kDwTileK; i += 4 * kDwTileG) {
        const int b = b0 + i / kDwTileK;
        const int k = k0 + i % kDwTileK;
        float a = 0.0f;
        if (b < B && k == H) {
          a = 1.0f;
        } else if (b < B && k < H && !first) {
          a = ys[((size_t)prev_t * B + b) * H + k];
        }
        a_s[i / kDwTileK][i % kDwTileK] = a;
      }
      __syncthreads();
      const int n_b = min(kDwChunk, B - b0);
      for (int n = 0; n < n_b; ++n) {
        const double d = d_s[n][tx];
#pragma unroll
        for (int q = 0; q < kDwTileK / 4; ++q) {
          acc[q] = fma((double)a_s[n][ty + 4 * q], d, acc[q]);
        }
      }
      __syncthreads();
    }
  }
  const int g = g0 + tx;
  if (g < G) {
    double* out = partial + (size_t)blockIdx.z * (H + 1) * G;
#pragma unroll
    for (int q = 0; q < kDwTileK / 4; ++q) {
      const int k = k0 + ty + 4 * q;
      if (k <= H) out[(size_t)k * G + g] = acc[q];
    }
  }
}

// dwb = the partials summed in split order, rounded once to f32.
__global__ void gru_dwb_sum_kernel(const double* __restrict__ partial,
                                   float* __restrict__ dwb, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double sum = 0.0;
  for (int z = 0; z < splits; ++z) sum += partial[(size_t)z * n + i];
  dwb[i] = (float)sum;
}

template <bool kWeightsInSmem>
cudaError_t launch_bptt(const float* x_proj, const float* w_hh_t,
                        const float* b_hh, const float* mask, const float* ys,
                        const float* dys, const float* dh_fin, float* dx_proj,
                        float* dhn, int T, int B, int H, int rows, int reverse,
                        size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gru_bptt_kernel<kWeightsInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = (rows * H + 31) / 32 * 32;
  const int blocks = (B + rows - 1) / rows;
  gru_bptt_kernel<kWeightsInSmem><<<blocks, threads, smem_bytes, stream>>>(
      x_proj, w_hh_t, b_hh, mask, ys, dys, dh_fin, dx_proj, dhn, T, B, H, rows,
      reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` (BPTT, then the partial sums, which
// read the dx_proj and dhn the first one wrote, then their sum) and returns
// the first nonzero cudaError as an int (0 = ok).  The caller allocates
// dx_proj, the (T, B, H) scratch dhn, dwb (H + 1, 3H: rows 0..H-1 are
// dw_hh_t, row H is db_hh) and the (splits, H + 1, 3H) f64 scratch
// dwb_partial.  rows * H <= 1024, 1 <= splits <= T.
int mmda_gru_bwd(const float* x_proj, const float* w_hh_t, const float* b_hh,
                 const float* mask, const float* ys, const float* dys,
                 const float* dh_fin, float* dx_proj, float* dhn, float* dwb,
                 double* dwb_partial, int T, int B, int H, int rows,
                 int reverse, int splits, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int G = 3 * H;
  const size_t buf_bytes = (size_t)rows * (H + G) * sizeof(float);
  const size_t w_bytes = (size_t)H * (G + 1) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bytes + buf_bytes <= (size_t)smem_optin) {
    err = launch_bptt<true>(x_proj, w_hh_t, b_hh, mask, ys, dys, dh_fin,
                            dx_proj, dhn, T, B, H, rows, reverse,
                            w_bytes + buf_bytes, st);
  } else {
    err = launch_bptt<false>(x_proj, w_hh_t, b_hh, mask, ys, dys, dh_fin,
                             dx_proj, dhn, T, B, H, rows, reverse, buf_bytes,
                             st);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + kDwTileG - 1) / kDwTileG,
                  (H + 1 + kDwTileK - 1) / kDwTileK, splits);
  gru_dwb_partial_kernel<<<grid, dim3(kDwTileG, 4), 0, st>>>(
      ys, dx_proj, dhn, dwb_partial, T, B, H, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (H + 1) * G;
  gru_dwb_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(dwb_partial, dwb, n,
                                                       splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
