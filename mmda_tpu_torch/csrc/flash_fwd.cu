// Blockwise (online-softmax) attention forward for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/attention.py::_flash_kernel (:72, launched by
// _flash_forward :490) and ::_flash_kernel_ragged (:289, launched at :451):
//
//   s   = (q k^T) * scale + bias[key]          f32 accumulation, scale after
//   m, l  running row max and running sum of the RAW probabilities exp(s - m)
//   acc += round(p * keep / (1 - rate)) v      the DROPPED ones, rounded to
//                                              the operand type, f32 sum
//   o = acc / l (f32),  lse = m + log(l)
//
// q, k, v (BH, S, D) f32 or bf16, bias (BH, S) f32 additive on keys, o
// (BH, S, D) f32, lse (BH, S) f32.  The keep mask is the positional hash of
// flash_common.cuh on the absolute (query, key) position, the flattened
// (batch, head) index and a seed read from device memory; the backward
// kernels regenerate it.  rate == 0 skips the mask (seed may be null).
//
// What bounds it on the H100.  4 S^2 D operations per (batch, head) against
// 3 S D operands read and S D written: at (384, 514, 64) bf16 the bound is
// the bytes (38 us at 3.35 TB/s; the operations take 26 us at the 989
// TFLOP/s bf16 dense peak).  The TPU kernel has a gridded and a ragged twin,
// pads q, k, v and the bias to its 128-wide blocks and writes lse broadcast
// over lanes, all for Mosaic's aligned static slices.  Here one kernel serves
// any S: one block per (batch * head, 64-row q tile), a loop over 64-key
// tiles; keys beyond S get probability 0, rows beyond S are not written, lse
// is a plain (BH, S) array.
//
// bf16 (flash_mma.cuh): both products on the tensor cores, mma.sync m16n8k16
// with bf16 operands and f32 accumulators.  4 warps of 16 query rows each;
// a warp reads its q fragments once with ldmatrix and keeps them in registers
// for the whole key loop.  k, v and the bias come through a two-stage
// cp.async ring, one barrier a tile: the next key tile loads while this one
// is multiplied.  A warp's 16 x 64 score block (16 x 32 at D = 128, where the
// o accumulator takes 64 registers) stays in the accumulator fragments: scale
// and bias folded into one fma in log2 units (keys beyond S get a -inf bias),
// the online softmax with two shfl_xor steps per row (a row lives in the 4
// lanes of a quad), exp as ex2.approx, the keep mask drawn on the fragments at
// the absolute (query, key) with the hash's row and column terms hoisted.
// The dropped probabilities are rounded to bf16 (the one rounding site, as
// the plain version's pd.to(q.dtype)) straight into the A operand of
// o += P V, whose B operand (v) comes through ldmatrix.trans.  l sums the raw
// f32 probabilities per lane and is reduced across the quad once, at the end.
// In the accumulator of n8 tile j, lane l holds queries row0 + 16 w + l / 4
// (and + 8) and keys c0 + k0 + 8 j + 2 (l % 4) (and + 1).  The ragged ends
// cost no products: a warp whose rows all lie beyond S only helps load, and
// the key step that holds key S - 1 (its own instantiation, so the full steps
// carry no tests) forms only the n8 tiles and k16 slices that reach below S
// (at S = 514 the last tile holds 2 keys).
//
// f32: the FMA design of flash_common.cuh (f32 tiles, 4 x 4 register tiles;
// the probabilities go through shared memory once per tile; expf and logf),
// as a TF32 tensor-core product cannot meet the f32 tolerance.

#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace mmda::flash;
using mmda::hash_bits;
using mmda::keep_threshold;

// ------------------------------------------------------------------ f32

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, float* __restrict__ o,
                     float* __restrict__ lse, HeadLayout heads, int S, int q_tiles, float scale,
                     float rate, float keep_scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DT = D / 16;
  float* q_s = smem;
  float* k_s = q_s + tile_floats<D>();
  float* v_s = k_s + tile_floats<D>();
  float* p_s = v_s + tile_floats<D>();
  float* bias_s = p_s + kTile * kLdp;

  const int bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t base = (size_t)bh * S * D;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? hash_base(seed_ptr, global_bh(bh, heads)) : 0u;

  load_tile<D>(q_s, q + base, row0, S);

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) acc[i][jj] = 0.0f;
  }

  for (int c0 = 0; c0 < S; c0 += kTile) {
    load_tile<D>(k_s, k + base, c0, S);
    load_tile<D>(v_s, v + base, c0, S);
    load_row_values(bias_s, bias + (size_t)bh * S, c0, S);
    __syncthreads();

    float s[4][4];
    nt_product<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t row = (uint32_t)(row0 + ty * 4 + i);
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = c0 + c < S ? s[i][j] * scale + bias_s[c] : -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float tile_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = expf(s[i][j] - m_new);
        tile_sum += p;
        float pd = p;
        if (drop) {
          pd = attn_keep(hbase, row, (uint32_t)(c0 + c), rate) ? p * keep_scale : 0.0f;
        }
        p_s[(ty * 4 + i) * kLdp + c] = pd;
      }
      l[i] = l[i] * alpha + row_sum(tile_sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DT; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    nn_accumulate<D>(p_s, v_s, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < DT; ++jj) acc[i][jj] = acc[i][jj] / l[i];
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < S) lse[(size_t)bh * S + r] = m[i] + logf(l[i]);
  }
  store_rows<D>(o + base, row0, S, ty, tx, acc);
}

// ----------------------------------------------------------------- bf16

constexpr int kMmaWarps = 4;                // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;    // query rows of a block
constexpr float kLn2 = 0.6931471805599453f;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <int D>
struct FwdGeometry {
  static constexpr int kTileElems = kTile * (D + kRowPad);
  static constexpr int kKeyStep = D > 64 ? 32 : 64;   // keys of a score block
  // q, then two stages of (k, v) tiles; two stages of bias
  static constexpr size_t kSmemBytes = (size_t)kMmaRows * (D + kRowPad) * sizeof(bf16) +
                                       4 * kTileElems * sizeof(bf16) +
                                       2 * kTile * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, float* __restrict__ o,
                     float* __restrict__ lse, HeadLayout heads, int S, int q_tiles, float scale,
                     float rate, float keep_scale) {
  constexpr int TE = FwdGeometry<D>::kTileElems;
  constexpr int L = D + kRowPad;
  constexpr int KS = FwdGeometry<D>::kKeyStep;
  constexpr int N8 = KS / 8;     // n8 tiles of a score block
  constexpr int K16 = KS / 16;   // k16 slices of it as an operand
  constexpr int DN8 = D / 8;     // n8 tiles of o's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + kMmaRows * L;                          // stage s: k, v at 2s, 2s + 1
  float* bias_s = reinterpret_cast<float*>(kv_s + 4 * TE);  // stage s at s * kTile

  const int bh = blockIdx.x / q_tiles;
  const int row0 = (blockIdx.x % q_tiles) * kMmaRows;
  const int lane = threadIdx.x & 31;
  const int q_row = 16 * (threadIdx.x >> 5);       // the warp's rows in the tile
  const int query0 = row0 + q_row + (lane >> 2);   // the lane's rows: query0, query0 + 8
  const int t2 = 2 * (lane & 3);
  const size_t base = (size_t)bh * S * D;
  const size_t vec_base = (size_t)bh * S;
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? hash_base(seed_ptr, global_bh(bh, heads)) : 0u;
  const int k_tiles = (S + kTile - 1) / kTile;

  auto load_stage = [&](int s, int c0) {
    async_tile<kTile, D, kMmaThreads>(kv_s + 2 * s * TE, k + base, c0, S);
    async_tile<kTile, D, kMmaThreads>(kv_s + (2 * s + 1) * TE, v + base, c0, S);
    async_vec<kTile, kMmaThreads>(bias_s + s * kTile, bias + vec_base, c0, S);
  };
  async_tile<kMmaRows, D, kMmaThreads>(q_s, q + base, row0, S);
  load_stage(0, 0);
  cp_async_commit();

  uint32_t hash_q[2];   // the query's share of the hash mix
#pragma unroll
  for (int h = 0; h < 2; ++h) hash_q[h] = (uint32_t)(query0 + 8 * h) * kHashRow + hbase;
  const float scale_l2 = scale * kLog2e;
  const uint32_t keep_min = keep_threshold(rate);
  // per query, in log2 units: the running max, and this lane's share of the
  // running sum of the raw probabilities
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[DN8][4];
#pragma unroll
  for (int j = 0; j < DN8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  uint32_t q_a[D / 16][4];

  // a warp whose 16 rows all lie beyond S (in the last q tile) only helps load
  const bool rows_live = row0 + q_row < S;
  for (int it = 0; it < k_tiles; ++it) {
    // tile it has arrived, and every warp is done with the stage it replaces
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < k_tiles) {
      load_stage((it + 1) & 1, (it + 1) * kTile);
      cp_async_commit();
    }
    if (!rows_live) continue;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldmatrix_x4(q_a[kk], frag_addr_rows(q_s, L, q_row, 16 * kk, lane));
      }
    }
    const int c0 = it * kTile;
    const bf16* k_s = kv_s + 2 * (it & 1) * TE;
    const bf16* v_s = k_s + TE;
    const float* b_s = bias_s + (it & 1) * kTile;

    // one block of KS keys from key c0 + k0; kTail: the last one, which holds
    // key S - 1: its n8 tiles from key S on are not formed, and its keys
    // from S on get a -inf bias
    auto step = [&](int k0, auto tail) {
      constexpr bool kTail = decltype(tail)::value;
      const int live = kTail ? S - (c0 + k0) : KS;
      // [j][e] is query query0 + 8 (e / 2), key c0 + k0 + 8 j + t2 + e % 2
      float s[N8][4];
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      }
      mma_rbt<D, N8>(s, q_a, k_s + k0 * L, lane, live);
      // s * scale + bias in log2 units, and the block's row max
      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        if (8 * j >= live) break;
        const int c = k0 + 8 * j + t2;
        const float2 bias2 = *reinterpret_cast<const float2*>(b_s + c);
        const int k_left = S - (c0 + c);
        const float bias_l2[2] = {kTail && k_left < 1 ? -INFINITY : bias2.x * kLog2e,
                                  kTail && k_left < 2 ? -INFINITY : bias2.y * kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = fmaf(s[j][e], scale_l2, bias_l2[e & 1]);
          m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
        m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
        alpha[h] = exp2_ftz(m[h] - m_new[h]);   // 0 on the first block (m = -inf)
        m[h] = m_new[h];
        l[h] *= alpha[h];
      }
      const uint32_t hash_k = (uint32_t)(c0 + k0 + t2) * kHashCol;
#pragma unroll
      for (int j = 0; j < N8; ++j) {
        if (8 * j >= live) {   // p = 0 for the tiles not formed
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
          continue;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = exp2_ftz(s[j][e] - m[h]);
          l[h] += p;
          float pd = p;
          if (drop) {
            // attn_keep at (query query0 + 8 h, key c0 + k0 + 8 j + t2 + e % 2)
            const bool keep = hash_bits(hash_q[h] + hash_k +
                                        (uint32_t)(8 * j + (e & 1)) * kHashCol) >= keep_min;
            pd = keep ? p * keep_scale : 0.0f;
          }
          s[j][e] = pd;
        }
      }
#pragma unroll
      for (int j = 0; j < DN8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      uint32_t p_a[K16][4];
      a_from_c<K16>(p_a, s);
      mma_pb<D, K16, DN8>(acc, p_a, v_s + k0 * L, 0, lane, live);
    };
    for (int k0 = 0; k0 < kTile && c0 + k0 < S; k0 += KS) {
      if (S - (c0 + k0) >= KS) {
        step(k0, Flag<false>());
      } else {
        step(k0, Flag<true>());
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = query0 + 8 * h;
    if (r >= S) continue;
    const float inv_l = 1.0f / l[h];
    float* row = o + base + (size_t)r * D + t2;
#pragma unroll
    for (int j = 0; j < DN8; ++j) {
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[j][2 * h] * inv_l, acc[j][2 * h + 1] * inv_l);
    }
    if (t2 == 0) lse[vec_base + r] = m[h] * kLn2 + logf(l[h]);
  }
}

template <typename T, int D>
struct Launch {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const float* bias, const int* seed, float* o, float* lse,
                         int BH, HeadLayout heads, int S, float scale, float rate,
                         float keep_scale,
                         cudaStream_t stream) {
    if constexpr (sizeof(T) == 2) {
      constexpr size_t smem_bytes = FwdGeometry<D>::kSmemBytes;
      cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem_bytes);
      if (err != cudaSuccess) return err;
      const int q_tiles = (S + kMmaRows - 1) / kMmaRows;
      flash_fwd_mma_kernel<D><<<BH * q_tiles, kMmaThreads, smem_bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), bias, seed, o, lse, heads, S, q_tiles, scale, rate,
          keep_scale);
    } else {
      const size_t smem_bytes =
          (3 * tile_floats<D>() + kTile * kLdp + kTile) * sizeof(float);
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem_bytes);
      if (err != cudaSuccess) return err;
      const int q_tiles = (S + kTile - 1) / kTile;
      flash_fwd_f32_kernel<D><<<BH * q_tiles, kThreads, smem_bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), bias, seed, o, lse, heads, S, q_tiles, scale, rate,
          keep_scale);
    }
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v: bf16 when is_bf16 else f32, contiguous and 16-byte aligned; D in
// {16, 32, 64, 128}.  rate and keep_scale = 1 / (1 - rate) already rounded to
// f32; seed (device int32) is read only when rate > 0.  The BH axis holds
// heads head0 .. head0 + heads_local - 1 of heads_total per batch item
// (`HeadLayout`); (1, 1, 0) for every head of the batch.
int mmda_flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                   const int* seed, float* o, float* lse, int BH, int S, int D,
                   int is_bf16, int heads_local, int heads_total, int head0,
                   float scale, float rate, float keep_scale,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH < 1 || S < 1 || !valid_heads(BH, heads_local, heads_total, head0)) {
    return (int)cudaErrorInvalidValue;
  }
  const HeadLayout heads{heads_local, heads_total, head0};
  if (is_bf16) {
    return (int)dispatch_head_dim<Launch, __nv_bfloat16>(
        D, q, k, v, bias, seed, o, lse, BH, heads, S, scale, rate, keep_scale, st);
  }
  return (int)dispatch_head_dim<Launch, float>(
      D, q, k, v, bias, seed, o, lse, BH, heads, S, scale, rate, keep_scale, st);
}

}  // extern "C"
