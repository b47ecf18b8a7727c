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
//     fills kRing - 1 steps ahead (none of them depends on the carry), and
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
// Fusing the dW reduction into the BPTT loop is later work.

#include "recurrence.cuh"

namespace {

constexpr int kDwTileK = 32;     // dW tile: 32 hidden units (rows of dW_hh^T)
constexpr int kDwTileG = 64;     // x 64 gate columns
constexpr int kDwThreads = 128;  // of 4 x 4 outputs each
constexpr int kDwChunk = 16;     // (t, b) rows per shared-memory pass
constexpr int kGateTileN = 64;   // gate pass tile: 64 (t, b) rows
constexpr int kGateTileG = 64;   // x 64 gate columns, 256 threads of 4 x 4
constexpr int kGateTileK = 16;   // hidden units per shared-memory pass
constexpr int kRing = 4;         // BPTT input ring: steps s + 1 .. s + kRing - 1 in flight
constexpr int kSlot = 8;         // floats per (step, unit): i f g o, c_prev, dys, mask, pad

// gates[n, g] = act(x_proj[n, g] + sum over k of h_prev[n, k] w_hh_t[k, g]) for
// the rows n = t * B + b, h_prev[n] = ys at the previous processed step (0 at
// the first), act = tanh on the g gate and sigmoid on i, f, o.  Block (x, y):
// rows 64 x .. 64 x + 63, gate columns 64 y ..; each thread a 4 x 4 tile.
__global__ void __launch_bounds__(256)
lstm_gates_kernel(const float* __restrict__ x_proj,  // (T, B, 4H)
                  const float* __restrict__ w_hh_t,  // (H, 4H)
                  const float* __restrict__ ys,      // (T, B, H)
                  float* __restrict__ gates,         // (T, B, 4H)
                  int T, int B, int H, int reverse) {
  __shared__ __align__(16) float a_s[kGateTileK][kGateTileN + 4];   // h_prev, k-major
  __shared__ __align__(16) float b_s[kGateTileK][kGateTileG];       // rows of w_hh_t
  const int G = 4 * H;
  const int N = T * B;
  const int n0 = blockIdx.x * kGateTileN;
  const int g0 = blockIdx.y * kGateTileG;
  const int tx = threadIdx.x & 15;   // columns g0 + 4 tx ..
  const int ty = threadIdx.x >> 4;   // rows n0 + 4 ty ..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < H; k0 += kGateTileK) {
    for (int i = threadIdx.x; i < kGateTileN * kGateTileK; i += 256) {
      const int rr = i / kGateTileK, kk = i - rr * kGateTileK;
      const int n = n0 + rr, k = k0 + kk;
      float hv = 0.0f;
      if (n < N && k < H) {
        const int t = n / B, b = n - t * B;
        if (reverse ? t < T - 1 : t > 0) {
          hv = ys[((size_t)(reverse ? t + 1 : t - 1) * B + b) * H + k];
        }
      }
      a_s[kk][rr] = hv;
    }
    for (int i = threadIdx.x; i < kGateTileK * kGateTileG; i += 256) {
      const int kk = i / kGateTileG, gg = i - kk * kGateTileG;
      const int k = k0 + kk, g = g0 + gg;
      b_s[kk][gg] = k < H && g < G ? w_hh_t[(size_t)k * G + g] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGateTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][4 * ty]);
      const float4 w = *reinterpret_cast<const float4*>(&b_s[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * ty + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + 4 * tx + j;
      if (g >= G) continue;
      const float x = x_proj[(size_t)n * G + g] + acc[i][j];
      gates[(size_t)n * G + g] = g / H == 2 ? tanhf(x) : sigmoid_f(x);
    }
  }
}

// The inputs of one unit at one step, read from its ring slot, with what of
// the cell backward does not depend on the carry.
struct StepIn {
  float ig, fg, gg, og, c_prev, dy, m, tanh_c;
};

__device__ __forceinline__ StepIn read_slot(const float* slot) {
  const float4 act = *reinterpret_cast<const float4*>(slot);
  const float4 in = *reinterpret_cast<const float4*>(slot + 4);
  StepIn x;
  x.ig = act.x;
  x.fg = act.y;
  x.gg = act.z;
  x.og = act.w;
  x.c_prev = in.x;
  x.dy = in.y;
  x.m = in.z;
  x.tanh_c = tanhf(x.fg * x.c_prev + x.ig * x.gg);
  return x;
}

// The serial pass (see the file's comment).  A quad per group of hidden
// units of a row, lane q taking gate q.  NC > 0: one unit per quad, and
// thread (j, q) holds w_hh_t[j, qH .. qH + H - 1] as NC float4s in
// registers; NC == 0: `units` units per quad (unit jq + u NQ), their weights
// read from global memory.  dx_proj holds the activations on entry and the
// dgates on exit.
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
  constexpr int UM = NC > 0 ? 1 : kMaxUnits;
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int HP = gate_stride(H);
  const int NQ = (H + units - 1) / units;   // quads of a row
  const int NU = NQ * units;                // unit slots of a row
  float* ring = smem;                                // (kRing, rows, NU, kSlot)
  float* dg_s = ring + kRing * rows * NU * kSlot;    // (2, rows, 4, HP) dgates

  const int r = threadIdx.x / (4 * NQ);     // row within the block
  const int jq = (threadIdx.x >> 2) - r * NQ;
  const int q = threadIdx.x & 3;            // gate: i, f, g, o
  const int b = blockIdx.x * rows + r;
  const bool row_ok = r < rows && b < B;
  bool valid[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) valid[u] = row_ok && u < units && jq + u * NQ < H;

  // zeros in the dgates' padding columns H .. HP - 1, read by the float4 loads
  for (int i = threadIdx.x; i < 2 * rows * 4 * HP; i += blockDim.x) dg_s[i] = 0.0f;

  const int nc = HP / 4;   // float4s of a gate's dgates
  float4 wr[NC > 0 ? NC : 1];
  if constexpr (NC > 0) {
    const bool unit_ok = jq < H;
    const float* wrow = w_hh_t + (size_t)jq * G + q * H;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = 4 * c;
      wr[c].x = unit_ok && i < H ? wrow[i] : 0.0f;
      wr[c].y = unit_ok && i + 1 < H ? wrow[i + 1] : 0.0f;
      wr[c].z = unit_ok && i + 2 < H ? wrow[i + 2] : 0.0f;
      wr[c].w = unit_ok && i + 3 < H ? wrow[i + 3] : 0.0f;
    }
  }

  float dh[UM], dc[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    const int j = jq + u * NQ;
    dh[u] = valid[u] ? dh_fin[(size_t)b * H + j] : 0.0f;
    dc[u] = valid[u] && dc_fin != nullptr ? dc_fin[(size_t)b * H + j] : 0.0f;
  }

  // Step s's inputs into ring slot s % kRing: thread q of a unit's quad
  // copies activation q, and threads 0, 1, 2 also c_prev (0 at the first
  // processed step), dys and the mask.  One group of copies per step, empty
  // past T.
  auto prefetch = [&](int s) {
    if (s < T) {
      const int t = reverse ? s : T - 1 - s;
      const bool first = reverse ? t == T - 1 : t == 0;
      const size_t row = (size_t)t * B + b;
      const size_t prow = (size_t)(reverse ? t + 1 : t - 1) * B + b;
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        if (!valid[u]) continue;
        const int j = jq + u * NQ;
        float* slot = ring + (((s % kRing) * rows + r) * NU + j) * kSlot;
        cp_async_4(slot + q, dx_proj + row * G + q * H + j, true);
        if (q == 0) cp_async_4(slot + 4, first ? cs : cs + prow * H + j, !first);
        if (q == 1) cp_async_4(slot + 5, dys + row * H + j, true);
        if (q == 2) cp_async_4(slot + 6, mask + row, true);
      }
    }
    cp_async_commit();
  };
  auto slot_of = [&](int s, int u) {
    return ring + (((s % kRing) * rows + r) * NU + jq + u * NQ) * kSlot;
  };

  for (int s = 0; s < kRing - 1; ++s) prefetch(s);
  cp_async_wait<kRing - 2>();
  __syncthreads();   // step 0's inputs and the zeroed padding, for every thread
  StepIn cur[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    if (valid[u]) cur[u] = read_slot(slot_of(0, u));
  }

  for (int s = 0; s < T; ++s) {
    // into the slot step s - 1 used, read before barrier s - 1
    prefetch(s + kRing - 1);
    const int t = reverse ? s : T - 1 - s;
    const size_t row = (size_t)t * B + b;
    float* dg = dg_s + ((s & 1) * rows + r) * 4 * HP;
    float pass[UM];
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      pass[u] = 0.0f;
      if (!valid[u]) continue;
      const StepIn& x = cur[u];
      const float dhv = dh[u] + x.dy;
      const float dh_new = x.m * dhv;
      float dc_new = x.m * dc[u];
      pass[u] = (1.0f - x.m) * dhv;
      const float dc_pass = (1.0f - x.m) * dc[u];
      dc_new = dc_new + dh_new * x.og * (1.0f - x.tanh_c * x.tanh_c);
      dc[u] = dc_new * x.fg + dc_pass;
      // all four, then this thread's: no divergent branches on the chain
      const float d_i = dc_new * x.gg * x.ig * (1.0f - x.ig);
      const float d_f = dc_new * x.c_prev * x.fg * (1.0f - x.fg);
      const float d_g = dc_new * x.ig * (1.0f - x.gg * x.gg);
      const float d_o = dh_new * x.tanh_c * x.og * (1.0f - x.og);
      const float dgate = q == 0 ? d_i : q == 1 ? d_f : q == 2 ? d_g : d_o;
      const int j = jq + u * NQ;
      dx_proj[row * G + q * H + j] = dgate;
      dg[q * HP + j] = dgate;
    }
    cp_async_wait<kRing - 2>();   // this thread's copies of step s + 1 landed
    __syncthreads();              // everyone's, and this step's dgates are in dg

    // step s + 1's inputs and tanh(c_new), off the carry's chain: they
    // overlap the dot products below
    if (s + 1 < T) {
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        if (valid[u]) cur[u] = read_slot(slot_of(s + 1, u));
      }
    }
    const float4* d4 = reinterpret_cast<const float4*>(dg + q * HP);
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      float part = 0.0f;
      if (valid[u]) {
        if constexpr (NC > 0) {
          part = dot_regs<NC>(d4, wr, nc);
        } else {
          part = dot_global(d4, w_hh_t + (size_t)(jq + u * NQ) * G + q * H, 1, H, nc);
        }
      }
      // the gate-q part of dh_prev[j]; the quad's four parts added by all
      // four as (i + f) + (g + o)
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (valid[u]) dh[u] = part + pass[u];
    }
  }
}

// dw_hh_t[k, g] = sum over t, b of h_prev[t, b, k] * dx_proj[t, b, g], where
// h_prev[t] = ys[t - 1] (forward direction) or ys[t + 1] (reverse), 0 at the
// first processed step.  The rows (t, b) that carry an h_prev are one range of
// (T - 1) B rows n of the (T B, .) layout, with h_prev in row n - B (forward)
// or n + B (reverse).  Sums are taken in f64: the product of two f32 values is
// exact in f64, so the result is the f32 rounding of the exact sum whatever
// the order, and the plain version (which also sums in f64) agrees with it to
// within the rounding of its inputs even over T * B = 16384 terms.
//
// lstm_dw_partial_kernel: block (x, y, z) sums the (32 x 64) tile (y, x) of
// dW_hh^T over the z-th of `splits` equal runs of those rows and writes its
// f64 partial to dw_partial[z].  128 threads of 4 x 4 outputs; the rows come
// through shared memory in chunks of 16, widened to f64 once as they are
// stored, the next chunk's loads in flight (registers) while one is summed.
__global__ void __launch_bounds__(kDwThreads)
lstm_dw_partial_kernel(const float* __restrict__ ys,       // (T, B, H)
                       const float* __restrict__ dx_proj,  // (T, B, 4H)
                       double* __restrict__ dw_partial,    // (splits, H, 4H)
                       int T, int B, int H, int reverse) {
  __shared__ __align__(16) double h_s[kDwChunk][kDwTileK];
  __shared__ __align__(16) double d_s[kDwChunk][kDwTileG];
  constexpr int kHLoads = kDwChunk * kDwTileK / kDwThreads;   // 4 per thread
  constexpr int kDLoads = kDwChunk * kDwTileG / kDwThreads;   // 8 per thread
  const int G = 4 * H;
  const int tx = threadIdx.x % (kDwTileG / 4);   // columns g0 + 4 tx ..
  const int ty = threadIdx.x / (kDwTileG / 4);   // rows k0 + 4 ty ..
  const int g0 = blockIdx.x * kDwTileG;
  const int k0 = blockIdx.y * kDwTileK;
  const int rows = (T - 1) * B;
  const int per_split = (rows + gridDim.z - 1) / gridDim.z;
  const int n_begin = blockIdx.z * per_split;
  const int n_end = min(rows, n_begin + per_split);
  const int first = reverse ? 0 : B;           // the run's rows start here ...
  const int shift = reverse ? B : -B;          // ... and read h_prev this far away

  float hv[kHLoads], dv[kDLoads];
  auto load = [&](int c0) {
#pragma unroll
    for (int e = 0; e < kHLoads; ++e) {
      const int i = threadIdx.x + e * kDwThreads;
      const int n = c0 + i / kDwTileK, k = k0 + i % kDwTileK;
      hv[e] = n < n_end && k < H ? ys[(size_t)(first + n + shift) * H + k] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kDLoads; ++e) {
      const int i = threadIdx.x + e * kDwThreads;
      const int n = c0 + i / kDwTileG, g = g0 + i % kDwTileG;
      dv[e] = n < n_end && g < G ? dx_proj[(size_t)(first + n) * G + g] : 0.0f;
    }
  };

  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
  }
  if (n_begin < n_end) load(n_begin);
  for (int c0 = n_begin; c0 < n_end; c0 += kDwChunk) {
#pragma unroll
    for (int e = 0; e < kHLoads; ++e) {
      const int i = threadIdx.x + e * kDwThreads;
      h_s[i / kDwTileK][i % kDwTileK] = (double)hv[e];
    }
#pragma unroll
    for (int e = 0; e < kDLoads; ++e) {
      const int i = threadIdx.x + e * kDwThreads;
      d_s[i / kDwTileG][i % kDwTileG] = (double)dv[e];
    }
    __syncthreads();
    if (c0 + kDwChunk < n_end) load(c0 + kDwChunk);
#pragma unroll 4
    for (int n = 0; n < kDwChunk; ++n) {
      const double2 h01 = *reinterpret_cast<const double2*>(&h_s[n][4 * ty]);
      const double2 h23 = *reinterpret_cast<const double2*>(&h_s[n][4 * ty + 2]);
      const double2 d01 = *reinterpret_cast<const double2*>(&d_s[n][4 * tx]);
      const double2 d23 = *reinterpret_cast<const double2*>(&d_s[n][4 * tx + 2]);
      const double h[4] = {h01.x, h01.y, h23.x, h23.y};
      const double d[4] = {d01.x, d01.y, d23.x, d23.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(h[i], d[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  double* out = dw_partial + (size_t)blockIdx.z * H * G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + 4 * tx + j;
      if (g < G) out[(size_t)k * G + g] = acc[i][j];
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

template <int NC>
cudaError_t launch_bptt(const float* w_hh_t, const float* mask, const float* cs,
                        const float* dys, const float* dh_fin, const float* dc_fin,
                        float* dx_proj, int T, int B, int H, int rows, int units, int reverse,
                        cudaStream_t stream) {
  const int groups = (H + units - 1) / units;
  const int per_row = 4 * groups;
  if (rows < 1 || rows * per_row > bptt_max_threads(NC)) return cudaErrorInvalidValue;
  const size_t ring = (size_t)kRing * rows * groups * units * kSlot;
  const size_t smem_bytes = (ring + 2 * (size_t)rows * 4 * gate_stride(H)) * sizeof(float);
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
  lstm_gates_kernel<<<gate_grid, 256, 0, st>>>(x_proj, w_hh_t, ys, dx_proj, T, B, H, reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (H <= kRegH && gate_stride(H) / 4 <= 11) {
    err = launch_bptt<11>(w_hh_t, mask, cs, dys, dh_fin, dc_fin, dx_proj, T, B, H, rows, 1,
                          reverse, st);
  } else if (H <= kRegH) {
    err = launch_bptt<21>(w_hh_t, mask, cs, dys, dh_fin, dc_fin, dx_proj, T, B, H, rows, 1,
                          reverse, st);
  } else {
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
