// What the serial passes of the recurrences share (lstm_fwd.cu, lstm_bwd.cu,
// gru_fwd.cu, gru_bwd.cu): the cell's sigmoid, 4-byte cp.async into a
// shared-memory ring, and the layout of a pass that runs four threads (a
// quad of a warp) per hidden unit with the unit's weights in registers up to
// H = kRegH.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxUnits = 4;     // hidden units per quad without register weights
constexpr int kRegH = 80;        // weights in registers up to this H

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// 4 bytes global -> shared, asynchronously; zero-filled (nothing read) when
// !valid, src a valid address either way.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Floats from one gate's vector to the next in shared memory: H rounded up to
// a multiple of 4 (float4 reads) with an odd count of float4s, so that the
// four gates (or rows) a quarter-warp reads fall on four different 16-byte
// bank groups.
__host__ __device__ __forceinline__ int gate_stride(int H) {
  const int hp = (H + 3) / 4 * 4;
  return (hp / 4) % 2 == 0 ? hp + 4 : hp;
}

// Threads a block of a serial pass may hold: a thread's weight registers
// (NC float4s, NC > 0) must leave the block within the SM's 64K registers.
__host__ __device__ constexpr int bptt_max_threads(int NC) {
  return NC == 0 ? 1024 : NC <= 11 ? 640 : 384;
}

// w[c] = (col[i * stride] for i = 4c .. 4c + 3), 0 where i >= n or !ok: a
// column of a (., stride) matrix from row 0 on, as NC float4s in registers.
template <int NC>
__device__ __forceinline__ void load_column(float4 (&w)[NC], const float* col, size_t stride,
                                            int n, bool ok) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = 4 * c;
    w[c].x = ok && i < n ? col[i * stride] : 0.0f;
    w[c].y = ok && i + 1 < n ? col[(i + 1) * stride] : 0.0f;
    w[c].z = ok && i + 2 < n ? col[(i + 2) * stride] : 0.0f;
    w[c].w = ok && i + 3 < n ? col[(i + 3) * stride] : 0.0f;
  }
}

// sum over i < 4 nc of v[i] w[i] as four accumulators strided over i (i mod
// 4), added as (a0 + a1) + (a2 + a3); v from shared memory (float4s, zero
// past the vector's end), w in registers (NC >= nc float4s).
template <int NC>
__device__ __forceinline__ float dot_regs(const float4* v, const float4 (&w)[NC], int nc) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < nc) {
      const float4 d = v[c];
      a0 = fmaf(d.x, w[c].x, a0);
      a1 = fmaf(d.y, w[c].y, a1);
      a2 = fmaf(d.z, w[c].z, a2);
      a3 = fmaf(d.w, w[c].w, a3);
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// The same sum with w[i] = w_g[i * stride] read from global memory for i < n
// (0 above).
__device__ __forceinline__ float dot_global(const float4* v, const float* w_g, size_t stride,
                                            int n, int nc) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const float4 d = v[c];
    const int i = 4 * c;
    a0 = fmaf(d.x, i < n ? w_g[i * stride] : 0.0f, a0);
    a1 = fmaf(d.y, i + 1 < n ? w_g[(i + 1) * stride] : 0.0f, a1);
    a2 = fmaf(d.z, i + 2 < n ? w_g[(i + 2) * stride] : 0.0f, a2);
    a3 = fmaf(d.w, i + 3 < n ? w_g[(i + 3) * stride] : 0.0f, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

}  // namespace
