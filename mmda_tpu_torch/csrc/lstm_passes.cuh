// The passes of the masked LSTM recurrence, forward and backward, as device
// functions over one direction: lstm_fwd.cu and lstm_bwd.cu run them for one
// direction a launch, lstm_multi_fwd.cu and lstm_multi_bwd.cu for up to 8
// directions of their own H in one launch.  One body each, so the two paths
// compute the same bits.
//
//   lstm_fwd_pass<NC>    the forward's serial pass (lstm_fwd.cu's comment)
//   lstm_gates_tile      the backward's gate pass, one 64 x 64 tile
//   lstm_bptt_pass<NC>   the backward's serial pass (lstm_bwd.cu's comment)
//   lstm_dw_partial_tile one tile of dW_hh^T over one run of (t, b) rows, f64
//   lstm_dw_sum_at       the runs of one dW_hh^T element added, rounded once
//
// A serial pass is given one direction's pointers, H, reverse, the first
// batch row of its thread group, the group's threads (a thread's index in
// it, their count), its shared memory and its barrier: the whole block
// (BlockSync) where the block holds one group, a named barrier of the
// group's warps (NamedSync) where a multi-direction block holds several.

#pragma once

#include "recurrence.cuh"

namespace {

constexpr int kFwdRing = 8;      // forward input ring: steps s + 1 .. s + kFwdRing - 1 in flight
constexpr int kBpttRing = 4;     // BPTT input ring: steps s + 1 .. s + kBpttRing - 1 in flight
constexpr int kSlot = 8;         // BPTT floats per (step, unit): i f g o, c_prev, dys, mask, pad
constexpr int kDwTileK = 32;     // dW tile: 32 hidden units (rows of dW_hh^T)
constexpr int kDwTileG = 64;     // x 64 gate columns
constexpr int kDwThreads = 128;  // of 4 x 4 outputs each
constexpr int kDwChunk = 16;     // (t, b) rows per shared-memory pass
constexpr int kGateTileN = 64;   // gate pass tile: 64 (t, b) rows
constexpr int kGateTileG = 64;   // x 64 gate columns, 256 threads of 4 x 4
constexpr int kGateTileK = 16;   // hidden units per shared-memory pass
constexpr int kGateThreads = 256;

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// bar.sync on barrier `id` (1..15) for `threads` threads, a multiple of 32.
struct NamedSync {
  int id, threads;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
  }
};

// The serial passes' instantiation for H: the float4s of weights a thread
// holds in registers (11 or 21), 0 where it reads them from global memory.
__host__ __device__ __forceinline__ int lstm_nc(int H) {
  return H > kRegH ? 0 : gate_stride(H) / 4 <= 11 ? 11 : 21;
}

// Shared memory of a serial pass over `rows` rows of `groups` quads of
// `units` unit slots, in floats.
__host__ __device__ __forceinline__ int lstm_fwd_smem_floats(int H, int rows, int groups,
                                                             int units) {
  return 2 * rows * gate_stride(H) + kFwdRing * rows * (4 * groups * units + 1);
}

__host__ __device__ __forceinline__ int lstm_bptt_smem_floats(int H, int rows, int groups,
                                                              int units) {
  return kBpttRing * rows * groups * units * kSlot + 2 * rows * 4 * gate_stride(H);
}

// ------------------------------------------------------------------ forward

// The forward's serial pass over rows row0 .. row0 + rows - 1.  NC > 0: one
// unit per quad, and thread (j, q) holds w_hh_t[:, qH + j] as NC float4s in
// registers; NC == 0: `units` units per quad (unit jq + u NQ), the column
// read from global memory.  c_fin and cs may be null.
template <int NC, class Sync>
__device__ __forceinline__ void lstm_fwd_pass(const float* __restrict__ x_proj,  // (T, B, 4H)
                                              const float* __restrict__ w_hh_t,  // (H, 4H)
                                              const float* __restrict__ mask,    // (T, B)
                                              float* __restrict__ ys,            // (T, B, H)
                                              float* __restrict__ cs,            // (T, B, H)
                                              float* __restrict__ h_fin,         // (B, H)
                                              float* __restrict__ c_fin,         // (B, H)
                                              int T, int B, int H, int rows, int units,
                                              int reverse, int row0, int tid, int nthreads,
                                              float* smem, Sync sync) {
  constexpr int UM = NC > 0 ? 1 : kMaxUnits;
  const int G = 4 * H;
  const int HP = gate_stride(H);
  const int NQ = (H + units - 1) / units;   // quads of a row
  const int NU = NQ * units;                // unit slots of a row
  float* h_s = smem;                             // (2, rows, HP) h, zero past H
  float* xp_s = h_s + 2 * rows * HP;             // (kFwdRing, rows, 4, NU) x_proj
  float* m_s = xp_s + kFwdRing * rows * 4 * NU;  // (kFwdRing, rows) mask

  const int r = tid / (4 * NQ);             // row within the group
  const int jq = (tid >> 2) - r * NQ;
  const int q = tid & 3;                    // gate: i, f, g, o
  const int b = row0 + r;
  const bool row_ok = r < rows && b < B;
  bool valid[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) valid[u] = row_ok && u < units && jq + u * NQ < H;

  for (int i = tid; i < 2 * rows * HP; i += nthreads) h_s[i] = 0.0f;

  const int nc = (H + 3) / 4;   // float4s of h
  float4 wr[NC > 0 ? NC : 1];
  if constexpr (NC > 0) load_column<NC>(wr, w_hh_t + q * H + jq, G, H, jq < H);

  // Step s's inputs into ring slot s % kFwdRing: thread q of a unit's quad
  // copies x_proj of gate q, the row's first thread the mask.  One group of
  // copies per step, empty past T.
  auto prefetch = [&](int s) {
    if (s < T && row_ok) {
      const int t = reverse ? T - 1 - s : s;
      const size_t row = (size_t)t * B + b;
      float* xs = xp_s + (((s % kFwdRing) * rows + r) * 4 + q) * NU;
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        const int j = jq + u * NQ;
        if (valid[u]) cp_async_4(xs + j, x_proj + row * G + q * H + j, true);
      }
      if (jq == 0 && q == 0) cp_async_4(m_s + (s % kFwdRing) * rows + r, mask + row, true);
    }
    cp_async_commit();
  };
  float xp[UM], m = 0.0f;
  auto read_slot = [&](int s) {
    const float* xs = xp_s + (((s % kFwdRing) * rows + r) * 4 + q) * NU;
#pragma unroll
    for (int u = 0; u < UM; ++u) xp[u] = valid[u] ? xs[jq + u * NQ] : 0.0f;
    if (row_ok) m = m_s[(s % kFwdRing) * rows + r];
  };

  for (int s = 0; s < kFwdRing - 1; ++s) prefetch(s);
  cp_async_wait<kFwdRing - 2>();
  sync();   // step 0's inputs and the zeroed h, for every thread
  read_slot(0);

  float h[UM], c[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) h[u] = c[u] = 0.0f;
  for (int s = 0; s < T; ++s) {
    // into the slot step s - 1 used, read before barrier s - 1
    prefetch(s + kFwdRing - 1);
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
    cp_async_wait<kFwdRing - 2>();   // this thread's copies of step s + 1 landed
    sync();                          // everyone's, and this step's h is in h_nxt
    if (s + 1 < T) read_slot(s + 1);
  }
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    if (!valid[u]) continue;
    const size_t i = (size_t)b * H + jq + u * NQ;
    if (q == 0) h_fin[i] = h[u];
    if (q == 1 && c_fin != nullptr) c_fin[i] = c[u];
  }
}

// ----------------------------------------------------------------- backward

// gates[n, g] = act(x_proj[n, g] + sum over k of h_prev[n, k] w_hh_t[k, g]) for
// the rows n = t * B + b, h_prev[n] = ys at the previous processed step (0 at
// the first), act = tanh on the g gate and sigmoid on i, f, o; the tile of rows
// 64 tile_n .. 64 tile_n + 63 and gate columns 64 tile_g .., kGateThreads
// threads of a 4 x 4 tile each.
__device__ __forceinline__ void lstm_gates_tile(const float* __restrict__ x_proj,  // (T, B, 4H)
                                                const float* __restrict__ w_hh_t,  // (H, 4H)
                                                const float* __restrict__ ys,      // (T, B, H)
                                                float* __restrict__ gates,         // (T, B, 4H)
                                                int T, int B, int H, int reverse, int tile_n,
                                                int tile_g) {
  __shared__ __align__(16) float a_s[kGateTileK][kGateTileN + 4];   // h_prev, k-major
  __shared__ __align__(16) float b_s[kGateTileK][kGateTileG];       // rows of w_hh_t
  const int G = 4 * H;
  const int N = T * B;
  const int n0 = tile_n * kGateTileN;
  const int g0 = tile_g * kGateTileG;
  const int tx = threadIdx.x & 15;   // columns g0 + 4 tx ..
  const int ty = threadIdx.x >> 4;   // rows n0 + 4 ty ..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < H; k0 += kGateTileK) {
    for (int i = threadIdx.x; i < kGateTileN * kGateTileK; i += kGateThreads) {
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
    for (int i = threadIdx.x; i < kGateTileK * kGateTileG; i += kGateThreads) {
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

__device__ __forceinline__ StepIn read_step(const float* slot) {
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

// The backward's serial pass over rows row0 .. row0 + rows - 1.  A quad per
// group of hidden units of a row, lane q taking gate q.  NC > 0: one unit per
// quad, and thread (j, q) holds w_hh_t[j, qH .. qH + H - 1] as NC float4s in
// registers; NC == 0: `units` units per quad (unit jq + u NQ), their weights
// read from global memory.  dx_proj holds the activations on entry and the
// dgates on exit.  dc_fin may be null (zeros).
template <int NC, class Sync>
__device__ __forceinline__ void lstm_bptt_pass(const float* __restrict__ w_hh_t,  // (H, 4H)
                                               const float* __restrict__ mask,    // (T, B)
                                               const float* __restrict__ cs,      // (T, B, H)
                                               const float* __restrict__ dys,     // (T, B, H)
                                               const float* __restrict__ dh_fin,  // (B, H)
                                               const float* __restrict__ dc_fin,  // (B, H)
                                               float* dx_proj,                    // (T, B, 4H)
                                               int T, int B, int H, int rows, int units,
                                               int reverse, int row0, int tid, int nthreads,
                                               float* smem, Sync sync) {
  constexpr int UM = NC > 0 ? 1 : kMaxUnits;
  const int G = 4 * H;
  const int HP = gate_stride(H);
  const int NQ = (H + units - 1) / units;   // quads of a row
  const int NU = NQ * units;                // unit slots of a row
  float* ring = smem;                                   // (kBpttRing, rows, NU, kSlot)
  float* dg_s = ring + kBpttRing * rows * NU * kSlot;   // (2, rows, 4, HP) dgates

  const int r = tid / (4 * NQ);             // row within the group
  const int jq = (tid >> 2) - r * NQ;
  const int q = tid & 3;                    // gate: i, f, g, o
  const int b = row0 + r;
  const bool row_ok = r < rows && b < B;
  bool valid[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) valid[u] = row_ok && u < units && jq + u * NQ < H;

  // zeros in the dgates' padding columns H .. HP - 1, read by the float4 loads
  for (int i = tid; i < 2 * rows * 4 * HP; i += nthreads) dg_s[i] = 0.0f;

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

  // Step s's inputs into ring slot s % kBpttRing: thread q of a unit's quad
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
        float* slot = ring + (((s % kBpttRing) * rows + r) * NU + j) * kSlot;
        cp_async_4(slot + q, dx_proj + row * G + q * H + j, true);
        if (q == 0) cp_async_4(slot + 4, first ? cs : cs + prow * H + j, !first);
        if (q == 1) cp_async_4(slot + 5, dys + row * H + j, true);
        if (q == 2) cp_async_4(slot + 6, mask + row, true);
      }
    }
    cp_async_commit();
  };
  auto slot_of = [&](int s, int u) {
    return ring + (((s % kBpttRing) * rows + r) * NU + jq + u * NQ) * kSlot;
  };

  for (int s = 0; s < kBpttRing - 1; ++s) prefetch(s);
  cp_async_wait<kBpttRing - 2>();
  sync();   // step 0's inputs and the zeroed padding, for every thread
  StepIn cur[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) {
    if (valid[u]) cur[u] = read_step(slot_of(0, u));
  }

  for (int s = 0; s < T; ++s) {
    // into the slot step s - 1 used, read before barrier s - 1
    prefetch(s + kBpttRing - 1);
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
    cp_async_wait<kBpttRing - 2>();   // this thread's copies of step s + 1 landed
    sync();                           // everyone's, and this step's dgates are in dg

    // step s + 1's inputs and tanh(c_new), off the carry's chain: they
    // overlap the dot products below
    if (s + 1 < T) {
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        if (valid[u]) cur[u] = read_step(slot_of(s + 1, u));
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
// lstm_dw_partial_tile: the (32 x 64) tile (tile_k, tile_g) of dW_hh^T summed
// over run `split` of `splits` equal runs of those rows, written as f64 to
// out (H, 4H).  kDwThreads threads of 4 x 4 outputs; the rows come through
// shared memory in chunks of 16, widened to f64 once as they are stored, the
// next chunk's loads in flight (registers) while one is summed.
__device__ __forceinline__ void lstm_dw_partial_tile(const float* __restrict__ ys,  // (T, B, H)
                                                     const float* __restrict__ dx_proj,
                                                     double* __restrict__ out,      // (H, 4H)
                                                     int T, int B, int H, int reverse,
                                                     int tile_g, int tile_k, int split,
                                                     int splits) {
  __shared__ __align__(16) double h_s[kDwChunk][kDwTileK];
  __shared__ __align__(16) double d_s[kDwChunk][kDwTileG];
  constexpr int kHLoads = kDwChunk * kDwTileK / kDwThreads;   // 4 per thread
  constexpr int kDLoads = kDwChunk * kDwTileG / kDwThreads;   // 8 per thread
  const int G = 4 * H;
  const int tx = threadIdx.x % (kDwTileG / 4);   // columns g0 + 4 tx ..
  const int ty = threadIdx.x / (kDwTileG / 4);   // rows k0 + 4 ty ..
  const int g0 = tile_g * kDwTileG;
  const int k0 = tile_k * kDwTileK;
  const int rows = (T - 1) * B;
  const int per_split = (rows + splits - 1) / splits;
  const int n_begin = split * per_split;
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

// dw_hh_t[i] = the `splits` partials of element i (n apart) summed in split
// order, rounded once to f32.
__device__ __forceinline__ void lstm_dw_sum_at(const double* __restrict__ dw_partial,
                                               float* __restrict__ dw_hh_t, int n, int splits,
                                               int i) {
  double sum = 0.0;
  for (int z = 0; z < splits; ++z) sum += dw_partial[(size_t)z * n + i];
  dw_hh_t[i] = (float)sum;
}

}  // namespace
