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
//     shared-memory ring that cp.async fills kRing - 1 steps ahead, and are
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

#include "recurrence.cuh"

namespace {

constexpr int kRing = 8;   // input ring: steps s + 1 .. s + kRing - 1 in flight

// The serial pass (see the file's comment).  NC > 0: one unit per quad, and
// thread (j, q) holds w_hh_t[:, qH + j] as NC float4s in registers; NC == 0:
// `units` units per quad (unit jq + u NQ), the column read from global memory.
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
  constexpr int UM = NC > 0 ? 1 : kMaxUnits;
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int HP = gate_stride(H);
  const int NQ = (H + units - 1) / units;   // quads of a row
  const int NU = NQ * units;                // unit slots of a row
  float* h_s = smem;                             // (2, rows, HP) h, zero past H
  float* xp_s = h_s + 2 * rows * HP;             // (kRing, rows, 4, NU) x_proj
  float* m_s = xp_s + kRing * rows * 4 * NU;     // (kRing, rows) mask

  const int r = threadIdx.x / (4 * NQ);     // row within the block
  const int jq = (threadIdx.x >> 2) - r * NQ;
  const int q = threadIdx.x & 3;            // gate: i, f, g, o
  const int b = blockIdx.x * rows + r;
  const bool row_ok = r < rows && b < B;
  bool valid[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) valid[u] = row_ok && u < units && jq + u * NQ < H;

  for (int i = threadIdx.x; i < 2 * rows * HP; i += blockDim.x) h_s[i] = 0.0f;

  const int nc = (H + 3) / 4;   // float4s of h
  float4 wr[NC > 0 ? NC : 1];
  if constexpr (NC > 0) load_column<NC>(wr, w_hh_t + q * H + jq, G, H, jq < H);

  // Step s's inputs into ring slot s % kRing: thread q of a unit's quad
  // copies x_proj of gate q, the row's first thread the mask.  One group of
  // copies per step, empty past T.
  auto prefetch = [&](int s) {
    if (s < T && row_ok) {
      const int t = reverse ? T - 1 - s : s;
      const size_t row = (size_t)t * B + b;
      float* xs = xp_s + (((s % kRing) * rows + r) * 4 + q) * NU;
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        const int j = jq + u * NQ;
        if (valid[u]) cp_async_4(xs + j, x_proj + row * G + q * H + j, true);
      }
      if (jq == 0 && q == 0) cp_async_4(m_s + (s % kRing) * rows + r, mask + row, true);
    }
    cp_async_commit();
  };
  float xp[UM], m = 0.0f;
  auto read_slot = [&](int s) {
    const float* xs = xp_s + (((s % kRing) * rows + r) * 4 + q) * NU;
#pragma unroll
    for (int u = 0; u < UM; ++u) xp[u] = valid[u] ? xs[jq + u * NQ] : 0.0f;
    if (row_ok) m = m_s[(s % kRing) * rows + r];
  };

  for (int s = 0; s < kRing - 1; ++s) prefetch(s);
  cp_async_wait<kRing - 2>();
  __syncthreads();   // step 0's inputs and the zeroed h, for every thread
  read_slot(0);

  float h[UM], c[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) h[u] = c[u] = 0.0f;
  for (int s = 0; s < T; ++s) {
    // into the slot step s - 1 used, read before barrier s - 1
    prefetch(s + kRing - 1);
    const int t = reverse ? T - 1 - s : s;
    const size_t row = (size_t)t * B + b;
    const float4* hv = reinterpret_cast<const float4*>(h_s + ((s & 1) * rows + r) * HP);
    float* h_nxt = h_s + (((s & 1) ^ 1) * rows + r) * HP;
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      const int j = jq + u * NQ;
      float dot = 0.0f;
      if (valid[u]) {
        if constexpr (NC > 0) {
          dot = dot_regs<NC>(hv, wr, nc);
        } else {
          dot = dot_global(hv, w_hh_t + q * H + j, G, H, nc);
        }
      }
      const float pre = xp[u] + dot;
      const float act = q == 2 ? tanhf(pre) : sigmoid_f(pre);
      const float ig = __shfl_sync(0xffffffffu, act, 0, 4);
      const float fg = __shfl_sync(0xffffffffu, act, 1, 4);
      const float gg = __shfl_sync(0xffffffffu, act, 2, 4);
      const float og = __shfl_sync(0xffffffffu, act, 3, 4);
      if (valid[u]) {
        const float c_new = fg * c[u] + ig * gg;
        const float h_new = og * tanhf(c_new);
        h[u] = m * h_new + (1.0f - m) * h[u];
        c[u] = m * c_new + (1.0f - m) * c[u];
        if (q == 0) {
          h_nxt[j] = h[u];
          ys[row * H + j] = h[u];
        } else if (q == 1 && cs != nullptr) {
          cs[row * H + j] = c[u];
        }
      }
    }
    cp_async_wait<kRing - 2>();   // this thread's copies of step s + 1 landed
    __syncthreads();              // everyone's, and this step's h is in h_nxt
    if (s + 1 < T) read_slot(s + 1);
  }
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    if (!valid[u]) continue;
    const size_t i = (size_t)b * H + jq + u * NQ;
    if (q == 0) h_fin[i] = h[u];
    if (q == 1) c_fin[i] = c[u];
  }
}

template <int NC>
cudaError_t launch(const float* x_proj, const float* w_hh_t, const float* mask, float* ys,
                   float* cs, float* h_fin, float* c_fin, int T, int B, int H, int rows,
                   int units, int reverse, cudaStream_t stream) {
  const int groups = (H + units - 1) / units;
  const int per_row = 4 * groups;
  if (rows < 1 || rows * per_row > bptt_max_threads(NC)) return cudaErrorInvalidValue;
  const size_t smem_bytes = ((size_t)2 * rows * gate_stride(H) +
                             (size_t)kRing * rows * (4 * groups * units + 1)) * sizeof(float);
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
  if (H <= kRegH && gate_stride(H) / 4 <= 11) {
    return (int)launch<11>(x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B, H, rows, 1,
                           reverse, st);
  }
  if (H <= kRegH) {
    return (int)launch<21>(x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B, H, rows, 1,
                           reverse, st);
  }
  return (int)launch<0>(x_proj, w_hh_t, mask, ys, cs, h_fin, c_fin, T, B, H, rows,
                        (H + 255) / 256, reverse, st);
}

}  // extern "C"
