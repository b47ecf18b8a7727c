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
// microseconds of either; the T steps are dependent, so the time is T times
// one step's latency.
//
// What the design does about it.  hh, r, z and n at step t depend only on
// the saved ys and x_proj[t], never on the backward carry: the TPU kernel
// recomputes them inside its serial loop only because a TPU core runs one
// program.  Here the work is split as in lstm_bwd.cu, so that the serial
// chain of a step holds only the cell backward and dh_prev:
//   * gru_gates_kernel: r, z, n and hh_n of every (t, b) at once, hh =
//     h_prev @ w_hh_t + b_hh as a tiled (T*B x H) x (H x 3H) product on all
//     SMs (f32 FMAs in ascending k, the order of the serial recompute it
//     replaces), a block's tile holding a unit's three gate columns so that
//     n = tanh(x_n + r hh_n) needs no exchange.  r, z, n go into dx_proj's
//     three lanes and hh_n into the scratch dhn: no new (T, B, .) buffer.
//   * gru_bptt_kernel: batch rows spread over the SMs (the caller picks
//     `rows`), four threads per (row, hidden unit j), a unit's quad in one
//     warp.  Unit j's r, z, n, hh_n, h_prev, dys and the mask come from a
//     shared-memory ring that cp.async fills kRing - 1 steps ahead.  All
//     four threads run the cell backward on the same values (no
//     transcendental left: the gate pass took them); thread q < 3 writes
//     gate q's dgx over the activation in dx_proj (the ring read it steps
//     before), dpre_n r over hh_n in dhn (q = 2) and dgh of gate q to shared
//     memory.  After the step's one barrier, thread (j, q) forms its part of
//     dh_prev[j] = dgh . w_hh_t[j, :]: the row's 3H dgh cut into kParts = 4
//     runs of float4s (faster on the card than one gate a thread), read
//     against row j of w_hh_t held in registers where H <= 80, else read
//     from global memory with several units per quad (H up to 1024); two
//     __shfl_xor_sync add the quad's parts.  The dgh sit in two shared buffers, one per step
//     parity, so one barrier per step orders both their exchange and the ring.
//   * gru_dwb_partial_kernel + gru_dwb_sum_kernel: dW_hh^T and db_hh
//     together as one (H + 1, 3H) result, row k < H the sum of h_prev[k] *
//     dgh and row H the sum of 1 * dgh, over the dx_proj and dhn the serial
//     pass left, as a tiled (H + 1 x T*B) x (T*B x 3H) product, 4 x 4 f64
//     accumulators a thread.  The rows are cut into `splits` runs (the
//     caller picks enough to fill the SMs), each block sums its (32 x 64)
//     tile over its run in f64 (exact products, so the T * B terms do not
//     drift with the order), and a second pass adds the runs in order and
//     rounds once: deterministic, no atomics.
//   * Otherwise plain f32 FMAs, no tensor cores (TF32 would change the
//     numbers the JAX package computes).

#include "recurrence.cuh"

namespace {

constexpr int kDwTileK = 32;     // dW/db tile: 32 rows of the (H + 1, 3H) result
constexpr int kDwTileG = 64;     // x 64 gate columns
constexpr int kDwThreads = 128;  // of 4 x 4 outputs each
constexpr int kDwChunk = 16;     // (t, b) rows per shared-memory pass
constexpr int kGateTileN = 64;   // gate pass tile: 64 (t, b) rows
constexpr int kGateTileU = 32;   // x 32 hidden units (x 3 gates), 256 threads of 4 x 2 x 3
constexpr int kGateTileK = 16;   // hidden units of h_prev per shared-memory pass
constexpr int kRing = 4;         // BPTT input ring: steps s + 1 .. s + kRing - 1 in flight
constexpr int kSlot = 8;         // floats per (step, unit): r z n hh_n, h_prev, dys, mask, pad
constexpr int kParts = 4;        // runs of a row's dgh float4s, one thread each (<= 4)

// For the rows n = t * B + b: hh = h_prev[n] @ w_hh_t + b_hh, h_prev[n] = ys at
// the previous processed step (0 at the first); r = sigmoid(x_r + hh_r), z =
// sigmoid(x_z + hh_z), n = tanh(x_n + r hh_n) into act's three lanes and hh_n
// into hn.  Block (x, y): rows 64 x .. 64 x + 63, units 32 y ..; each thread
// rows 4 ty .. 4 ty + 3 of units 2 tx, 2 tx + 1, all three gates.
__global__ void __launch_bounds__(256)
gru_gates_kernel(const float* __restrict__ x_proj,  // (T, B, 3H)
                 const float* __restrict__ w_hh_t,  // (H, 3H)
                 const float* __restrict__ b_hh,    // (3H,)
                 const float* __restrict__ ys,      // (T, B, H)
                 float* __restrict__ act,           // (T, B, 3H)
                 float* __restrict__ hn,            // (T, B, H)
                 int T, int B, int H, int reverse) {
  __shared__ __align__(16) float a_s[kGateTileK][kGateTileN + 4];   // h_prev, k-major
  __shared__ __align__(16) float w_s[kGateTileK][3][kGateTileU];    // rows of w_hh_t
  const int G = 3 * H;
  const int N = T * B;
  const int n0 = blockIdx.x * kGateTileN;
  const int u0 = blockIdx.y * kGateTileU;
  const int tx = threadIdx.x & 15;   // units u0 + 2 tx ..
  const int ty = threadIdx.x >> 4;   // rows n0 + 4 ty ..
  float acc[4][3][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int g = 0; g < 3; ++g) acc[i][g][0] = acc[i][g][1] = 0.0f;
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
    for (int i = threadIdx.x; i < kGateTileK * 3 * kGateTileU; i += 256) {
      const int kk = i / (3 * kGateTileU), rem = i - kk * 3 * kGateTileU;
      const int g = rem / kGateTileU, uu = rem - g * kGateTileU;
      const int k = k0 + kk, u = u0 + uu;
      w_s[kk][g][uu] = k < H && u < H ? w_hh_t[(size_t)k * G + g * H + u] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGateTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][4 * ty]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float2 w = *reinterpret_cast<const float2*>(&w_s[kk][g][2 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g][0] = fmaf(av[i], w.x, acc[i][g][0]);
          acc[i][g][1] = fmaf(av[i], w.y, acc[i][g][1]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * ty + i;
    if (n >= N) continue;
    const float* xp = x_proj + (size_t)n * G;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = u0 + 2 * tx + e;
      if (u >= H) continue;
      const float hh_n = acc[i][2][e] + b_hh[2 * H + u];
      const float r = sigmoid_f(xp[u] + (acc[i][0][e] + b_hh[u]));
      const float z = sigmoid_f(xp[H + u] + (acc[i][1][e] + b_hh[H + u]));
      float* out = act + (size_t)n * G;
      out[u] = r;
      out[H + u] = z;
      out[2 * H + u] = tanhf(xp[2 * H + u] + r * hh_n);
      hn[(size_t)n * H + u] = hh_n;
    }
  }
}

// The inputs of one unit at one step, read from its ring slot.
struct StepIn {
  float r, z, n, hn, h_prev, dy, m;
};

__device__ __forceinline__ StepIn read_slot(const float* slot) {
  const float4 g = *reinterpret_cast<const float4*>(slot);
  const float4 in = *reinterpret_cast<const float4*>(slot + 4);
  return {g.x, g.y, g.z, g.w, in.x, in.y, in.z};
}

// Thread q's part of dh_prev[j] with row j of w_hh_t from global memory: the
// float4s f0 .. f0 + nf - 1 of the row's dgh (3 gates of HP / 4 float4s,
// zero past H in each), four accumulators as dot_global's.
__device__ __forceinline__ float part_global(const float4* d4, const float* wrow, int H,
                                             int ng, int f0, int nf) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int c = 0; c < nf; ++c) {
    const int f = f0 + c;
    const int g = f / ng;
    const int i = 4 * (f - g * ng);
    const float* w = wrow + g * H;
    const float4 d = d4[f];
    a0 = fmaf(d.x, i < H ? w[i] : 0.0f, a0);
    a1 = fmaf(d.y, i + 1 < H ? w[i + 1] : 0.0f, a1);
    a2 = fmaf(d.z, i + 2 < H ? w[i + 2] : 0.0f, a2);
    a3 = fmaf(d.w, i + 3 < H ? w[i + 3] : 0.0f, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// The serial pass (see the file's comment).  NG > 0: one unit per quad,
// HP / 4 <= NG, and thread (j, q) holds its run of row j of w_hh_t (NC
// float4s, laid out as the dgh: gate by gate, zero past H) in registers;
// NG == 0: `units` units per quad (unit jq + u NQ), the row read from
// global memory.  dx_proj and dhn hold the gate pass's outputs on entry and
// dgx and dpre_n r on exit.
template <int NG>
__global__ void __launch_bounds__(bptt_max_threads((3 * NG + kParts - 1) / kParts))
gru_bptt_kernel(const float* __restrict__ w_hh_t,  // (H, 3H)
                const float* __restrict__ mask,    // (T, B)
                const float* __restrict__ ys,      // (T, B, H)
                const float* __restrict__ dys,     // (T, B, H)
                const float* __restrict__ dh_fin,  // (B, H)
                float* dx_proj,                    // (T, B, 3H)
                float* dhn,                        // (T, B, H)
                int T, int B, int H, int rows, int units, int reverse) {
  constexpr int NC = (3 * NG + kParts - 1) / kParts;
  constexpr int UM = NG > 0 ? 1 : kMaxUnits;
  extern __shared__ __align__(16) float smem[];
  const int G = 3 * H;
  const int HP = gate_stride(H);
  const int NQ = (H + units - 1) / units;   // quads of a row
  const int NU = NQ * units;                // unit slots of a row
  float* ring = smem;                                // (kRing, rows, NU, kSlot)
  float* dg_s = ring + kRing * rows * NU * kSlot;    // (2, rows, 3, HP) dgh

  const int r = threadIdx.x / (4 * NQ);     // row within the block
  const int jq = (threadIdx.x >> 2) - r * NQ;
  const int q = threadIdx.x & 3;
  const int b = blockIdx.x * rows + r;
  const bool row_ok = r < rows && b < B;
  bool valid[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) valid[u] = row_ok && u < units && jq + u * NQ < H;

  // zeros in the dgh's padding columns H .. HP - 1, read by the float4 loads
  for (int i = threadIdx.x; i < 2 * rows * 3 * HP; i += blockDim.x) dg_s[i] = 0.0f;

  const int ng = HP / 4;                     // float4s of one gate's dgh
  const int per = (3 * ng + kParts - 1) / kParts;
  const int f0 = q * per;                    // this thread's run of float4s
  const int nf = q < kParts ? max(0, min(per, 3 * ng - f0)) : 0;
  float4 wr[NC > 0 ? NC : 1];
  if constexpr (NC > 0) {
    const float* wrow = w_hh_t + (size_t)min(jq, H - 1) * G;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = f0 + c;
      const int g = f / ng;
      const int i = 4 * (f - g * ng);
      const bool ok = jq < H && c < nf;
      const float* w = wrow + g * H;
      wr[c].x = ok && i < H ? w[i] : 0.0f;
      wr[c].y = ok && i + 1 < H ? w[i + 1] : 0.0f;
      wr[c].z = ok && i + 2 < H ? w[i + 2] : 0.0f;
      wr[c].w = ok && i + 3 < H ? w[i + 3] : 0.0f;
    }
  }

  float dh[UM];
#pragma unroll
  for (int u = 0; u < UM; ++u) dh[u] = valid[u] ? dh_fin[(size_t)b * H + jq + u * NQ] : 0.0f;

  // Step s's inputs into ring slot s % kRing: thread q of a unit's quad
  // copies two of them (r and h_prev, z and dys, n and hh_n, the mask).  One
  // group of copies per step, empty past T.
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
        if (q < 3) cp_async_4(slot + q, dx_proj + row * G + q * H + j, true);
        if (q == 0) cp_async_4(slot + 4, first ? ys : ys + prow * H + j, !first);
        if (q == 1) cp_async_4(slot + 5, dys + row * H + j, true);
        if (q == 2) cp_async_4(slot + 3, dhn + row * H + j, true);
        if (q == 3) cp_async_4(slot + 6, mask + row, true);
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
    float* dg = dg_s + ((s & 1) * rows + r) * 3 * HP;
    float pass[UM];
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      pass[u] = 0.0f;
      if (!valid[u]) continue;
      const StepIn& x = cur[u];
      const float dhv = dh[u] + x.dy;
      const float dh_new = x.m * dhv;
      const float dh_pass = (1.0f - x.m) * dhv;
      const float dz = dh_new * (x.h_prev - x.n);
      const float dn = dh_new * (1.0f - x.z);
      const float dpre_n = dn * (1.0f - x.n * x.n);
      const float dr = dpre_n * x.hn;
      const float dhn_j = dpre_n * x.r;
      const float dpre_r = dr * x.r * (1.0f - x.r);
      const float dpre_z = dz * x.z * (1.0f - x.z);
      pass[u] = dh_new * x.z + dh_pass;
      // all three, then this thread's: no divergent branches on the chain
      const float dgx = q == 0 ? dpre_r : q == 1 ? dpre_z : dpre_n;
      const int j = jq + u * NQ;
      if (q < 3) {
        dx_proj[row * G + q * H + j] = dgx;
        dg[q * HP + j] = q == 2 ? dhn_j : dgx;
      }
      if (q == 2) dhn[row * H + j] = dhn_j;
    }
    cp_async_wait<kRing - 2>();   // this thread's copies of step s + 1 landed
    __syncthreads();              // everyone's, and this step's dgh are in dg

    // step s + 1's inputs, off the carry's chain: they overlap the products
    if (s + 1 < T) {
#pragma unroll
      for (int u = 0; u < UM; ++u) {
        if (valid[u]) cur[u] = read_slot(slot_of(s + 1, u));
      }
    }
    const float4* d4 = reinterpret_cast<const float4*>(dg);
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      float part = 0.0f;
      if (valid[u]) {
        if constexpr (NC > 0) {
          part = dot_regs<NC>(d4 + f0, wr, nf);
        } else {
          part = part_global(d4, w_hh_t + (size_t)(jq + u * NQ) * G, H, ng, f0, nf);
        }
      }
      // thread q's part of dh_prev[j]; the quad's parts added by all four as
      // (p0 + p1) + (p2 + p3)
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (valid[u]) dh[u] = part + pass[u];
    }
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
// gru_dwb_partial_kernel: block (x, y, z) sums the (32 x 64) tile (y, x) of
// the (H + 1, 3H) result over the z-th of `splits` equal runs of the T * B
// rows n = t * B + b and writes its f64 partial to partial[z].  128 threads
// of 4 x 4 outputs; the rows come through shared memory in chunks of 16,
// widened to f64 once as they are stored, the next chunk's loads in flight
// (registers) while one is summed.
__global__ void __launch_bounds__(kDwThreads)
gru_dwb_partial_kernel(const float* __restrict__ ys,       // (T, B, H)
                       const float* __restrict__ dx_proj,  // (T, B, 3H)
                       const float* __restrict__ dhn,      // (T, B, H)
                       double* __restrict__ partial,       // (splits, H + 1, 3H)
                       int T, int B, int H, int reverse) {
  __shared__ __align__(16) double a_s[kDwChunk][kDwTileK];
  __shared__ __align__(16) double d_s[kDwChunk][kDwTileG];
  constexpr int kALoads = kDwChunk * kDwTileK / kDwThreads;   // 4 per thread
  constexpr int kDLoads = kDwChunk * kDwTileG / kDwThreads;   // 8 per thread
  const int G = 3 * H;
  const int tx = threadIdx.x % (kDwTileG / 4);   // columns g0 + 4 tx ..
  const int ty = threadIdx.x / (kDwTileG / 4);   // rows k0 + 4 ty ..
  const int g0 = blockIdx.x * kDwTileG;
  const int k0 = blockIdx.y * kDwTileK;
  const int N = T * B;
  const int per_split = (N + gridDim.z - 1) / gridDim.z;
  const int n_begin = blockIdx.z * per_split;
  const int n_end = min(N, n_begin + per_split);
  // rows of the first processed step have no h_prev; the others read it
  // this far away
  const int first_lo = reverse ? (T - 1) * B : 0;
  const int shift = reverse ? B : -B;

  float av[kALoads], dv[kDLoads];
  auto load = [&](int c0) {
#pragma unroll
    for (int e = 0; e < kALoads; ++e) {
      const int i = threadIdx.x + e * kDwThreads;
      const int n = c0 + i / kDwTileK, k = k0 + i % kDwTileK;
      const bool first = n >= first_lo && n < first_lo + B;
      av[e] = n >= n_end ? 0.0f
              : k == H ? 1.0f
              : k < H && !first ? ys[(size_t)(n + shift) * H + k] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kDLoads; ++e) {
      const int i = threadIdx.x + e * kDwThreads;
      const int n = c0 + i / kDwTileG, g = g0 + i % kDwTileG;
      dv[e] = n >= n_end || g >= G ? 0.0f
              : g < 2 * H ? dx_proj[(size_t)n * G + g] : dhn[(size_t)n * H + g - 2 * H];
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
    for (int e = 0; e < kALoads; ++e) {
      const int i = threadIdx.x + e * kDwThreads;
      a_s[i / kDwTileK][i % kDwTileK] = (double)av[e];
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
      const double2 a01 = *reinterpret_cast<const double2*>(&a_s[n][4 * ty]);
      const double2 a23 = *reinterpret_cast<const double2*>(&a_s[n][4 * ty + 2]);
      const double2 d01 = *reinterpret_cast<const double2*>(&d_s[n][4 * tx]);
      const double2 d23 = *reinterpret_cast<const double2*>(&d_s[n][4 * tx + 2]);
      const double a[4] = {a01.x, a01.y, a23.x, a23.y};
      const double d[4] = {d01.x, d01.y, d23.x, d23.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], d[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  double* out = partial + (size_t)blockIdx.z * (H + 1) * G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k > H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + 4 * tx + j;
      if (g < G) out[(size_t)k * G + g] = acc[i][j];
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

template <int NG>
cudaError_t launch_bptt(const float* w_hh_t, const float* mask, const float* ys,
                        const float* dys, const float* dh_fin, float* dx_proj, float* dhn,
                        int T, int B, int H, int rows, int units, int reverse,
                        cudaStream_t stream) {
  const int groups = (H + units - 1) / units;
  const int per_row = 4 * groups;
  if (rows < 1 || rows * per_row > bptt_max_threads((3 * NG + kParts - 1) / kParts)) {
    return cudaErrorInvalidValue;
  }
  const size_t ring = (size_t)kRing * rows * groups * units * kSlot;
  const size_t smem_bytes = (ring + 2 * (size_t)rows * 3 * gate_stride(H)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bptt_kernel<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const int threads = (rows * per_row + 31) / 32 * 32;
  const int blocks = (B + rows - 1) / rows;
  gru_bptt_kernel<NG><<<blocks, threads, smem_bytes, stream>>>(
      w_hh_t, mask, ys, dys, dh_fin, dx_proj, dhn, T, B, H, rows, units, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the four kernels on `stream` (the gate pass into dx_proj and dhn,
// the BPTT pass over them, then the partial sums, which read the dx_proj and
// dhn the BPTT pass left, then their sum) and returns the first nonzero
// cudaError as an int (0 = ok).  The caller allocates dx_proj, the (T, B, H)
// scratch dhn, dwb (H + 1, 3H: rows 0..H-1 are dw_hh_t, row H is db_hh) and
// the (splits, H + 1, 3H) f64 scratch dwb_partial.  1 <= H <= 1024,
// splits >= 1, and rows batch rows of 4 ceil(H / units) threads each
// within the block limit of the serial pass (as lstm_bwd.cu's: 640 threads
// where H <= 44, 384 where H <= 80, else 1024; units = 1 up to H = 256, then
// ceil(H / 256)).
int mmda_gru_bwd(const float* x_proj, const float* w_hh_t, const float* b_hh,
                 const float* mask, const float* ys, const float* dys,
                 const float* dh_fin, float* dx_proj, float* dhn, float* dwb,
                 double* dwb_partial, int T, int B, int H, int rows,
                 int reverse, int splits, void* stream) {
  if (T < 1 || B < 1 || H < 1 || H > kMaxUnits * 256 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = 3 * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 gate_grid((T * B + kGateTileN - 1) / kGateTileN,
                       (H + kGateTileU - 1) / kGateTileU);
  gru_gates_kernel<<<gate_grid, 256, 0, st>>>(x_proj, w_hh_t, b_hh, ys, dx_proj, dhn, T, B, H,
                                              reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (H <= kRegH && gate_stride(H) / 4 <= 11) {
    err = launch_bptt<11>(w_hh_t, mask, ys, dys, dh_fin, dx_proj, dhn, T, B, H, rows, 1,
                          reverse, st);
  } else if (H <= kRegH) {
    err = launch_bptt<21>(w_hh_t, mask, ys, dys, dh_fin, dx_proj, dhn, T, B, H, rows, 1,
                          reverse, st);
  } else {
    err = launch_bptt<0>(w_hh_t, mask, ys, dys, dh_fin, dx_proj, dhn, T, B, H, rows,
                         (H + 255) / 256, reverse, st);
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + kDwTileG - 1) / kDwTileG,
                  (H + 1 + kDwTileK - 1) / kDwTileK, splits);
  gru_dwb_partial_kernel<<<grid, kDwThreads, 0, st>>>(
      ys, dx_proj, dhn, dwb_partial, T, B, H, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (H + 1) * G;
  gru_dwb_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(dwb_partial, dwb, n,
                                                       splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
