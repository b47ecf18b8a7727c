// Shared by ln_dropout_fwd.cu and ln_dropout_bwd.cu: rows of f32 or bf16
// values read and written 1 or 4 at a time (4: one 16-byte or 8-byte access
// per lane, neighbouring lanes on neighbouring addresses), as f32 or as
// loaded (Raw), a warp sum, and the row layout the hash reads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmda {

constexpr int kWarpsPerBlock = 4;   // the forward: one warp per row, 4 rows per block

// Where a launch's rows lie in the (B * s_total, H) rows the mask is drawn
// over: B runs of s_local rows, run b holding rows b * s_total + s0 ..
// b * s_total + s0 + s_local - 1 (sequence parallelism: a rank's S-shard of
// each batch item).  s_local = s_total = N, s0 = 0 is the launch itself.
struct RowLayout {
  int s_local, s_total, s0;
};

// The row the hash takes for row `row` of the launch, in uint32 arithmetic
// (wrapping, as the hash's own).
__device__ __forceinline__ uint32_t hash_row(int row, RowLayout l) {
  return (uint32_t)(row / l.s_local) * (uint32_t)l.s_total + (uint32_t)l.s0 +
         (uint32_t)(row % l.s_local);
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// Rounds each value once, to nearest even, as a cast to bf16 does.
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 4) {
    uint2 t;
    *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// V values of a row as one access loads them (float4 / uint2 for V = 4,
// one value for V = 1), held until they are used: half the registers of
// their f32 values in bf16.
template <typename T, int V> struct RawOf;
template <> struct RawOf<float, 4> { using type = float4; };
template <> struct RawOf<float, 1> { using type = float; };
template <> struct RawOf<__nv_bfloat16, 4> { using type = uint2; };
template <> struct RawOf<__nv_bfloat16, 1> { using type = unsigned short; };
template <typename T, int V>
using Raw = typename RawOf<T, V>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  return *reinterpret_cast<const Raw<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void raw_to_float(const Raw<T, V>& r, float* v) {
  if constexpr (sizeof(T) == 4 && V == 4) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  } else if constexpr (sizeof(T) == 4) {
    v[0] = r;
  } else if constexpr (V == 4) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(__ushort_as_bfloat16(r));
  }
}

// The sum over the warp's 32 lanes, the same value in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace mmda
