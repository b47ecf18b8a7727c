// The positional hash that draws dropout masks inside the kernels.
//
// Replaces mmda_tpu/ops/pallas/layernorm.py::_keep_mask (:40) and the same
// avalanche in short_attention.py and attention.py, with the short attention
// kernels' own position mix (short_attn_base) below.  A pure function of
// (seed, absolute row, column): a backward kernel regenerates the mask
// instead of reading it, and the mask does not depend on how rows are cut
// into blocks.  uint32 arithmetic wraps, as the TPU kernels' does; the plain
// PyTorch version is mmda_tpu_torch/ops/kernels/hash_dropout.py::keep_mask,
// and the two agree bit for bit.

#pragma once

#include <cstdint>

namespace mmda {

// The avalanche every kernel's hash ends in (the attention kernels mix their
// position into x in their own way): 24 bits ...
__device__ __forceinline__ uint32_t hash_bits(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >> 8;
}

// ... as a uniform value in [0, 1), exact in f32.
__device__ __forceinline__ float hash_avalanche(uint32_t x) {
  return (float)hash_bits(x) * (1.0f / 16777216.0f);
}

// hash_avalanche(x) >= rate exactly when hash_bits(x) >= keep_threshold(rate):
// rate * 2^24 is exact in f32 and hash_bits(x) is an integer.
__device__ __forceinline__ uint32_t keep_threshold(float rate) {
  return (uint32_t)ceilf(rate * 16777216.0f);
}

// The LayerNorm kernels' position mix.
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t row,
                                              uint32_t col) {
  return hash_avalanche(row * 2654435761u + col * 0x9E3779B9u + seed * 40503u);
}

// 1 where the element is kept: u >= rate, rate already rounded to f32.
__device__ __forceinline__ bool hash_keep(uint32_t seed, uint32_t row,
                                          uint32_t col, float rate) {
  return hash_uniform(seed, row, col) >= rate;
}

// The short attention kernels' position mix (short_attention.py::
// _dropout_mask, :39): x = r * S + c + seed * 2654435761 + b * 40503
// + h * 51329 with S the call's own length, b the batch item and h the head
// as separate terms.  base holds the last three; pos = r * S + c.
__device__ __forceinline__ uint32_t short_attn_base(uint32_t seed, uint32_t b,
                                                    uint32_t h) {
  return seed * 2654435761u + b * 40503u + h * 51329u;
}

__device__ __forceinline__ bool short_attn_keep(uint32_t base, uint32_t pos,
                                                float rate) {
  return hash_avalanche(pos + base) >= rate;
}

}  // namespace mmda
