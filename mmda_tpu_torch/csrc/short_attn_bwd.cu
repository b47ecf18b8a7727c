// Short-sequence multi-head attention backward for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/short_attention.py::_bwd_kernel (:82,
// launched by _bwd_call :143).  From the saved q, k, v, bias and seed alone
// (no S x S tensor was kept), per (batch item b, head h), all f32:
//
//   p    = softmax((q * scale) k^T + bias[b])      recomputed, pre-dropout
//   keep = mask * f32(1 / (1 - rate))              the forward's mask, rehashed
//   pd   = p * keep;  dv = pd^T do
//   dp   = (do v^T) * keep
//   ds   = p * (dp - rowsum(dp * p))
//   dq   = (ds k) * scale;  dk = ds^T (q * scale)
//
// each of dq, dk, dv rounded once to the input type; do (the incoming
// gradient of o, in the input type) widened to f32.  Nothing is rounded in
// between, unlike the flash kernels.
//
// What bounds it on the H100.  At (64, 12, 50, 64) bf16 the call reads q, k,
// v, do and writes dq, dk, dv: 34.4 MB (10.3 us at 3.35 TB/s), and does
// 10 B nh S^2 D = 1.23e9 operations (1.2 us at the 989 TFLOP/s bf16 dense
// tensor-core peak): bytes.  In f32 the bytes (20.5 us) exceed the
// operations taken as six bf16 term products each (7.5 us at a sixth of the
// peak); the f32 design on the tensor cores issues 42 term products where
// that counts 30 (s and dp twice), splits every operand three ways, and
// takes an expf and a hash a score in each pass.
//
// The TPU kernel loops over the heads of one batch item in one program and
// writes dk, dv once per head.  Here one block owns all S rows and keys of
// one (b, h), so dq, dk and dv are each written once, with no atomics and no
// second pass.
//
// bf16: the products on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 accumulators; flash_mma.cuh), with S padded to SP, a multiple of 16
// (the kernel's template argument), and D to DP, a multiple of 16; the
// padding is zero-filled.  SP / 16 warps.  q, k, v and do lie in shared
// memory as bf16 (exact: they are the inputs).  The products of two inputs
// go straight in: q k^T (times scale after the product, in f32) and do v^T.
// The products of an f32 intermediate (pd, ds) with an input take the
// intermediate as three bf16 terms, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid), which hold all 24 bits of x: three mma per k-step, so
// each product is the f32 product up to the order of the f32 sums (two terms
// keep 16 bits and miss the one-ulp tolerance near zero).
//   A. Warp w owns queries 16 w .. 16 w + 15: s = q k^T and do v^T into
//      accumulator fragments, the softmax with quad reductions, expf and IEEE
//      division, the keep mask on the fragments (short_attn_keep at i S + j,
//      the true S), ds = p (dp - r) with r = rowsum(dp p), then dq = (ds k)
//      scale with ds split in registers; each query's max, sum and r go to
//      shared memory.
//   B. Warp w owns keys 16 w .. 16 w + 15 and recomputes its transposed
//      blocks, k q^T and v do^T (the same products as in A, operands
//      swapped), from which p (with A's max and sum), the mask, pd and ds
//      follow as in A; then dv = pd^T do and dk = (ds^T q) scale, pd and ds
//      split in registers.
// Recomputing the two score blocks costs 4 S^2 D more operations than
// passing pd and ds through shared memory, which at S = 128 and D = 128
// would not fit beside the four operand tiles (2 x 64 KB in f32).
//
// f32, on the tensor cores (short_attn_bwd_f32_wgmma_kernel<DP, NW>,
// design 0): short_attn_fwd.cu's f32 arithmetic (six bf16 term products on
// wgmma, q * scale and k on each row's grid) in the two passes of the bf16
// kernel above: A, queries as rows (s, dp, the exact softmax, r =
// rowsum(dp p), ds, dq), then B, keys as rows (s^T and dp^T with A and B
// swapped, so the same term products in the same order: the same bits as
// A's and as the forward's; dv, dk).  Each product is one fresh f32 sum over
// all S; dq, dk, dv written once, no atomics.  At D <= 64 the operands'
// bf16 terms are split once into a slot each (96 KB at S <= 64, two blocks
// an SM), at D > 64 two slots take them in turn (the kernel's note below);
// every S, D <= 128 fits (192 KB).
// f32 FMAs (design 1, kept for comparison):
//   1. k and v are staged in shared memory as f32 (row stride D + 1);
//   2. a warp per query row recomputes that row's scores, softmax and keep
//      mask in registers (at most 4 keys per lane, S <= 128), and forms dpd =
//      do v^T for the row the same way, so the row sum of dp * p is a warp
//      reduction; it writes the row of pd and of ds to shared memory (S x S
//      each);
//   3. do replaces v in shared memory: dv = pd^T do and dq = ds k, a thread
//      per output element;
//   4. q * scale replaces do: dk = ds^T (q * scale).
// expf and IEEE division.  Two S x S matrices and two operand tiles fill the
// block's shared memory: S <= 128 at D = 64 (with design 1 the wrapper sends
// a shape that does not fit, S = D = 128, to short_attn_tiled_bwd.cu).  One
// shared load an FMA, as in the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"
#include "hash_dropout.cuh"
#include "short_mma.cuh"
#include "short_tiled.cuh"
#include "wgmma.cuh"

namespace {

using mmda::flash::bf16;
using mmda::flash::frag_addr_nk;
using mmda::flash::frag_addr_rows;
using mmda::flash::kRowPad;
using mmda::flash::ldmatrix_x4;
using mmda::flash::mma_bf16;
using mmda::short_mma::load_operand;
using mmda::short_mma::product_out;
using mmda::short_mma::split_operand;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxS = 128;
constexpr int kMaxD = 128;
constexpr int kKeysPerLane = kMaxS / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ------------------------------------------------------------------ f32

size_t smem_bytes(int S, int D) {
  return (2 * (size_t)S * (D + 1) + 2 * (size_t)S * S + (size_t)kWarps * 2 * D) *
         sizeof(float);
}

// Rows of the (S, D) matrix src into dst (row stride D + 1), each value
// times mul.
__device__ __forceinline__ void stage(float* dst, const float* src, int S, int D, float mul) {
  for (int e = threadIdx.x; e < S * D; e += kThreads) {
    const int r = e / D;
    dst[r * (D + 1) + (e - r * D)] = src[e] * mul;
  }
}

__global__ void __launch_bounds__(kThreads)
short_attn_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const int* __restrict__ seed_ptr, const float* __restrict__ d_out,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dv, int nh, int S, int D, float scale,
                          float rate, float keep_scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;                      // (S, D + 1): k
  float* x_s = k_s + S * ld;              // (S, D + 1): v, then do, then q * scale
  float* pd_s = x_s + S * ld;             // (S, S) dropped probabilities
  float* ds_s = pd_s + S * S;             // (S, S) score gradients
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* q_row = ds_s + S * S + warp * 2 * D;   // this warp's q * scale row ...
  float* do_row = q_row + D;                    // ... and do row

  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  stage(k_s, k + base, S, D, 1.0f);
  stage(x_s, v + base, S, D, 1.0f);
  __syncthreads();

  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;
  const float* bias_b = bias + (size_t)b * S;
  for (int i = warp; i < S; i += kWarps) {
    for (int c = lane; c < D; c += 32) {
      q_row[c] = q[base + (size_t)i * D + c] * scale;
      do_row[c] = d_out[base + (size_t)i * D + c];
    }
    __syncwarp();
    float s[kKeysPerLane], dpd[kKeysPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      dpd[t] = 0.0f;
      if (j < S) {
        const float* kj = k_s + j * ld;
        const float* vj = x_s + j * ld;
        float acc = 0.0f, dacc = 0.0f;
        for (int c = 0; c < D; ++c) {
          acc = fmaf(q_row[c], kj[c], acc);
          dacc = fmaf(do_row[c], vj[c], dacc);
        }
        s[t] = acc + bias_b[j];
        dpd[t] = dacc;
        m = fmaxf(m, s[t]);
      }
    }
    m = warp_max(m);
    float l = 0.0f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      s[t] = lane + 32 * t < S ? expf(s[t] - m) : 0.0f;
      l += s[t];
    }
    l = warp_sum(l);
    float r = 0.0f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = s[t] / l;                    // p
      float pd = s[t];
      if (drop && j < S) {
        const float keep =
            mmda::short_attn_keep(hbase, (uint32_t)(i * S + j), rate) ? keep_scale : 0.0f;
        pd = s[t] * keep;
        dpd[t] = dpd[t] * keep;           // dp
      }
      if (j < S) pd_s[i * S + j] = pd;
      r += dpd[t] * s[t];
    }
    r = warp_sum(r);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < S) ds_s[i * S + j] = s[t] * (dpd[t] - r);
    }
    __syncwarp();   // the next row overwrites q_row and do_row
  }
  __syncthreads();

  stage(x_s, d_out + base, S, D, 1.0f);
  __syncthreads();
  for (int e = threadIdx.x; e < S * D; e += kThreads) {
    const int j = e / D;                  // key row of dv, query row of dq
    const int c = e - j * D;
    float acc_v = 0.0f, acc_q = 0.0f;
    for (int i = 0; i < S; ++i) {
      acc_v = fmaf(pd_s[i * S + j], x_s[i * ld + c], acc_v);
      acc_q = fmaf(ds_s[j * S + i], k_s[i * ld + c], acc_q);
    }
    dv[base + e] = acc_v;
    dq[base + e] = acc_q * scale;
  }
  __syncthreads();

  stage(x_s, q + base, S, D, scale);
  __syncthreads();
  for (int e = threadIdx.x; e < S * D; e += kThreads) {
    const int j = e / D;
    const int c = e - j * D;
    float acc = 0.0f;
    for (int i = 0; i < S; ++i) acc = fmaf(ds_s[i * S + j], x_s[i * ld + c], acc);
    dk[base + e] = acc;
  }
}


// f32 on the tensor cores (design 0): a block of NW = ceil(S / 64)
// warpgroups per (b, h), the products and term tiles of
// short_attn_fwd.cu's f32 kernel (six bf16 term products on wgmma, q * scale
// and k split on each row's grid, one fresh f32 accumulator a product):
//   A. Warpgroup w owns queries 64 w ..: s = (q scale) k^T and dp = do v^T
//      (s the forward's bit for bit); the exact softmax with expf and IEEE
//      division, the keep mask, r = rowsum(dp p), ds = p (dp keep - r); each
//      query's max, sum and r to shared memory; dq = (ds k) scale, ds split
//      in registers.
//   B. Warpgroup w owns keys 64 w ..: s^T = k (q scale)^T and dp^T = v do^T
//      (A and B swapped, so the same term products in the same order: A's
//      s), p = expf(s + bias - m) / l from A's statistics, pd = p keep and
//      ds as in A; then dv = pd^T do and dk = ds^T (q scale).
// At S, D <= 64 dq's products are issued with B's score products, and dv's
// with dk's, so that the tensor cores run them back to back (the same bits).
// At D <= 64 each operand's terms have their own slot of NW 64-row tiles,
// split once (96 KB at S <= 64: two blocks an SM; 192 KB at S > 64).  At D >
// 64 two slots take the operands in turn (q scale and k, do and v, k again
// for dq, q scale for s^T, do and v, q scale for dk; 96 KB at S <= 64), each
// re-split a read from L2 and a three-way split more: four slots would not
// fit at S > 64, and at S <= 64 the second block an SM that two slots leave
// room for gains more than the re-splits cost (PERF.md).
template <int DP>
__host__ __device__ constexpr bool resident() { return DP == 64; }

template <int DP, int NW>
__host__ __device__ constexpr size_t f32_wgmma_smem_bytes() {
  // the term slots; the key bias; each query's (m, l, r)
  return (size_t)(resident<DP>() ? 4 : 2) * 3 * NW * mmda::short_tiled::kTileRows * DP *
             sizeof(bf16) +
         4 * NW * mmda::short_tiled::kTileRows * sizeof(float) + mmda::wgmma::kSmemAlign;
}

// The blocks an SM holds by their shared memory (228 KB an SM, 1 KB of it
// reserved a block), at most 3: the kernel's launch bound.
template <int DP, int NW>
__host__ __device__ constexpr int f32_min_blocks() {
  return 233472 / (f32_wgmma_smem_bytes<DP, NW>() + 1024) < 3
             ? 233472 / (f32_wgmma_smem_bytes<DP, NW>() + 1024)
             : 3;
}

// The 64 x 64 blocks d[t] = A B_t^T (t over the NW 64-row tiles of the slot
// b, A the 64-row term tile a), the scores' way (wgmma::issue_scores: the hi
// hi sums in hh, added by sum_block_scores after the wait); Swap as there.
// Issued, not waited for.
template <int DP, int NW, bool Swap>
__device__ __forceinline__ void issue_block_scores(float (&hh)[NW][8][4], float (&d)[NW][8][4],
                                                   const bf16* a, const bf16* b) {
  constexpr int T = mmda::short_tiled::kTileRows * DP;
#pragma unroll
  for (int t = 0; t < NW; ++t) {
    mmda::wgmma::issue_scores<64, DP, Swap>(hh[t], d[t], a, T, b + t * 3 * T, T);
  }
}

// The same blocks as six term products in one accumulator (issue_terms_abt).
template <int DP, int NW, bool Swap>
__device__ __forceinline__ void issue_block_abt(float (&d)[NW][8][4], const bf16* a,
                                                const bf16* b) {
  constexpr int T = mmda::short_tiled::kTileRows * DP;
#pragma unroll
  for (int t = 0; t < NW; ++t) {
    mmda::wgmma::issue_terms_abt<64, DP, Swap>(d[t], a, T, b + t * 3 * T, T);
  }
}

template <int NW>
__device__ __forceinline__ void fence_block(float (&d)[NW][8][4]) {
#pragma unroll
  for (int t = 0; t < NW; ++t) mmda::wgmma::fence_operand(d[t]);
}

template <int NW>
__device__ __forceinline__ void sum_block_scores(float (&d)[NW][8][4], float (&hh)[NW][8][4]) {
  fence_block<NW>(d);
  fence_block<NW>(hh);
#pragma unroll
  for (int t = 0; t < NW; ++t) mmda::wgmma::sum_scores(d[t], hh[t]);
}

// Rows r0 + g (+ 8) of X B over the NW 64-row tiles of the slot b (read
// MN-major), X given as the three terms a[t] of its 64-column blocks, times
// mul, into the row-major (S, D) f32 dst: 64 columns at a time, each one
// fresh f32 sum over all the tiles.
template <int DP, int NW>
__device__ __forceinline__ void block_product_out(float* dst, const uint32_t (&a)[NW][3][4][4],
                                                  const bf16* b, int r0, int S, int D, float mul,
                                                  int lane) {
  namespace wg = mmda::wgmma;
  constexpr int T = mmda::short_tiled::kTileRows * DP;
#pragma unroll
  for (int hb = 0; hb < DP / 64; ++hb) {
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
    }
    wg::fence_operand(part);
    wg::fence();
#pragma unroll
    for (int t = 0; t < NW; ++t) {
      wg::issue_terms_product<64>(part, a[t], b + t * 3 * T + hb * 64 * wg::kBoxCols, T);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operand(part);
    mmda::short_tiled::store_cols_f32(dst, part, r0, 64 * hb, S, D, mul, lane);
  }
}

template <int DP, int NW>
__global__ void __launch_bounds__(NW * mmda::short_tiled::kTileThreads,
                                  f32_min_blocks<DP, NW>())
short_attn_bwd_f32_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ bias,
                                const int* __restrict__ seed_ptr,
                                const float* __restrict__ d_out, float* __restrict__ dq,
                                float* __restrict__ dk, float* __restrict__ dv, int nh, int S,
                                int D, float scale, float rate, float keep_scale, int vec) {
  namespace wg = mmda::wgmma;
  namespace st = mmda::short_tiled;
  constexpr int R = st::kTileRows, N8 = R / 8;
  constexpr int T = R * DP;                  // elements of one 64-row term tile
  constexpr bool kResident = resident<DP>();
  // One warpgroup holding every row, every operand resident: the
  // independent products of A's end and B's start, and B's two outputs,
  // are issued together, so that the tensor cores run them back to back.
  constexpr bool kMerged = kResident && NW == 1;
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(wg::align_smem(smem_raw));   // NW x 3 x (64, DP) each
  bf16* k_s = q_s + NW * 3 * T;
  bf16* do_s = kResident ? k_s + NW * 3 * T : q_s;                  // else in turns with q
  bf16* v_s = kResident ? do_s + NW * 3 * T : k_s;                  // and with k
  float* bias_s = reinterpret_cast<float*>(q_s + (kResident ? 4 : 2) * NW * 3 * T);
  float* st_s = bias_s + NW * R;                                    // NW 64 x (m, l, r)

  const int w = threadIdx.x / st::kTileThreads;   // the warpgroup: rows 64 w ..
  const int tid = threadIdx.x - w * st::kTileThreads;
  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const int lane = threadIdx.x & 31;
  const int row0 = R * w + 16 * (tid >> 5);       // the warp's queries (A), keys (B)
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const float* q_b = q + base;
  const float* k_b = k + base;
  const float* v_b = v + base;
  const float* do_b = d_out + base;
  const int own = w * 3 * T;                      // this warpgroup's tile in a slot
  const st::KeepMask keep(seed_ptr, b, h, S, rate);

  // A. [t][j][e] is query row0 + g + 8 (e / 2), key 64 t + 8 j + t2 + e % 2
  st::split_rows<DP, R, true>(q_s + own, T, q_b, R * w, S, D, vec, scale, tid);
  st::split_rows<DP, R, true>(k_s + own, T, k_b, R * w, S, D, vec, 1.0f, tid);
  if constexpr (kResident) {
    st::split_rows<DP, R, false>(do_s + own, T, do_b, R * w, S, D, vec, 1.0f, tid);
    st::split_rows<DP, R, false>(v_s + own, T, v_b, R * w, S, D, vec, 1.0f, tid);
  }
  for (int j = threadIdx.x; j < NW * R; j += NW * st::kTileThreads) {
    bias_s[j] = j < S ? bias[(size_t)b * S + j] : -INFINITY;
  }
  wg::fence_proxy_async();
  __syncthreads();
  float s[NW][N8][4], dp[NW][N8][4];
  {
    float hh[NW][N8][4];
    wg::fence();
    issue_block_scores<DP, NW, false>(hh, s, q_s + own, k_s);
    if constexpr (kResident) issue_block_abt<DP, NW, false>(dp, do_s + own, v_s);
    wg::commit();
    wg::wait_all();
    sum_block_scores<NW>(s, hh);
  }
  if constexpr (!kResident) {
    __syncthreads();   // every warpgroup done with q scale's and k's terms
    st::split_rows<DP, R, false>(do_s + own, T, do_b, R * w, S, D, vec, 1.0f, tid);
    st::split_rows<DP, R, false>(v_s + own, T, v_b, R * w, S, D, vec, 1.0f, tid);
    wg::fence_proxy_async();
    __syncthreads();
    wg::fence();
    issue_block_abt<DP, NW, false>(dp, do_s + own, v_s);
    wg::commit();
    wg::wait_all();
  }
  fence_block<NW>(dp);
  {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, r[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < NW; ++t) {
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][j][e] = __fadd_rn(s[t][j][e], bias_s[R * t + 8 * j + t2 + (e & 1)]);
          m[e >> 1] = fmaxf(m[e >> 1], s[t][j][e]);
        }
      }
    }
    m[0] = st::quad_max(m[0]);
    m[1] = st::quad_max(m[1]);
#pragma unroll
    for (int t = 0; t < NW; ++t) {
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][j][e] = expf(s[t][j][e] - m[e >> 1]);
          l[e >> 1] += s[t][j][e];
        }
      }
    }
    l[0] = st::quad_sum(l[0]);
    l[1] = st::quad_sum(l[1]);
#pragma unroll
    for (int t = 0; t < NW; ++t) {
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][j][e] = s[t][j][e] / l[e >> 1];   // p
          if (keep.drop) {
            const int i = row0 + g + 8 * (e >> 1), jk = R * t + 8 * j + t2 + (e & 1);
            dp[t][j][e] *= keep(i, jk) ? keep_scale : 0.0f;
          }
          r[e >> 1] += dp[t][j][e] * s[t][j][e];
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      r[hh] = st::quad_sum(r[hh]);
      if (t2 == 0) {
        float* row = st_s + 3 * (row0 + g + 8 * hh);
        row[0] = m[hh];
        row[1] = l[hh];
        row[2] = r[hh];
      }
    }
#pragma unroll
    for (int t = 0; t < NW; ++t) {
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][j][e] = s[t][j][e] * (dp[t][j][e] - r[e >> 1]);   // ds
      }
    }
  }
  if constexpr (!kResident) {
    __syncthreads();   // every warpgroup done with do's and v's terms
    st::split_rows<DP, R, true>(k_s + own, T, k_b, R * w, S, D, vec, 1.0f, tid);
    wg::fence_proxy_async();
  }
  uint32_t a[NW][3][R / 16][4];
#pragma unroll
  for (int t = 0; t < NW; ++t) mmda::short_mma::split_operand<R / 16>(a[t], s[t]);
  __syncthreads();   // the statistics (and k's terms) are in
  if constexpr (kMerged) {   // dq's products beside B's score products
    float part[8][4], hh[NW][N8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
    }
    wg::fence_operand(part);
    wg::fence();
    wg::issue_terms_product<R>(part, a[0], k_s, T);
    issue_block_scores<DP, NW, true>(hh, s, k_s + own, q_s);
    issue_block_abt<DP, NW, true>(dp, v_s + own, do_s);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(part);
    st::store_cols_f32(dq + base, part, row0, 0, S, D, scale, lane);
    sum_block_scores<NW>(s, hh);
  } else {
    block_product_out<DP, NW>(dq + base, a, k_s, row0, S, D, scale, lane);

    // B. [t][j][e] is key row0 + g + 8 (e / 2), query 64 t + 8 j + t2 + e % 2
    if constexpr (!kResident) {
      st::split_rows<DP, R, true>(q_s + own, T, q_b, R * w, S, D, vec, scale, tid);
      wg::fence_proxy_async();
      __syncthreads();
    }
    {
      float hh[NW][N8][4];
      wg::fence();
      issue_block_scores<DP, NW, true>(hh, s, k_s + own, q_s);
      if constexpr (kResident) issue_block_abt<DP, NW, true>(dp, v_s + own, do_s);
      wg::commit();
      wg::wait_all();
      sum_block_scores<NW>(s, hh);
    }
    if constexpr (!kResident) {
      __syncthreads();   // every warpgroup done with k's and q scale's terms
      st::split_rows<DP, R, false>(do_s + own, T, do_b, R * w, S, D, vec, 1.0f, tid);
      st::split_rows<DP, R, false>(v_s + own, T, v_b, R * w, S, D, vec, 1.0f, tid);
      wg::fence_proxy_async();
      __syncthreads();
      wg::fence();
      issue_block_abt<DP, NW, true>(dp, v_s + own, do_s);
      wg::commit();
      wg::wait_all();
    }
  }
  fence_block<NW>(dp);
  float kb[2];      // the bias of the warp's keys row0 + g (+ 8); -inf beyond S
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) kb[hh] = bias_s[row0 + g + 8 * hh];
#pragma unroll
  for (int t = 0; t < NW; ++t) {
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = R * t + 8 * j + t2 + (e & 1), jk = row0 + g + 8 * (e >> 1);
        const float* row = st_s + 3 * i;
        const float p =
            i < S ? expf(__fadd_rn(s[t][j][e], kb[e >> 1]) - row[0]) / row[1] : 0.0f;
        float d = dp[t][j][e];
        float pd = p;
        if (keep.drop) {
          const float kp = keep(i, jk) ? keep_scale : 0.0f;
          pd = p * kp;
          d *= kp;
        }
        s[t][j][e] = pd;
        dp[t][j][e] = p * (d - row[2]);   // ds
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NW; ++t) mmda::short_mma::split_operand<R / 16>(a[t], s[t]);
  if constexpr (kMerged) {   // dv's products beside dk's
    uint32_t a2[NW][3][R / 16][4];
    mmda::short_mma::split_operand<R / 16>(a2[0], dp[0]);
    float pv[8][4], pk[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = pk[j][e] = 0.0f;
    }
    wg::fence_operand(pv);
    wg::fence_operand(pk);
    wg::fence();
    wg::issue_terms_product<R>(pv, a[0], do_s, T);
    wg::issue_terms_product<R>(pk, a2[0], q_s, T);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(pv);
    wg::fence_operand(pk);
    st::store_cols_f32(dv + base, pv, row0, 0, S, D, 1.0f, lane);
    st::store_cols_f32(dk + base, pk, row0, 0, S, D, 1.0f, lane);
  } else {
    block_product_out<DP, NW>(dv + base, a, do_s, row0, S, D, 1.0f, lane);
    if constexpr (!kResident) {
      __syncthreads();   // every warpgroup done with do's terms
      st::split_rows<DP, R, true>(q_s + own, T, q_b, R * w, S, D, vec, scale, tid);
      wg::fence_proxy_async();
    }
#pragma unroll
    for (int t = 0; t < NW; ++t) mmda::short_mma::split_operand<R / 16>(a[t], dp[t]);
    if constexpr (!kResident) __syncthreads();
    block_product_out<DP, NW>(dk + base, a, q_s, row0, S, D, 1.0f, lane);
  }
}

template <int DP, int NW>
cudaError_t launch_f32_wgmma(const void* q, const void* k, const void* v, const float* bias,
                             const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                             int BH, int nh, int S, int D, float scale, float rate,
                             float keep_scale, cudaStream_t stream) {
  constexpr size_t bytes = f32_wgmma_smem_bytes<DP, NW>();
  cudaError_t err = cudaFuncSetAttribute(short_attn_bwd_f32_wgmma_kernel<DP, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int vec = D % 4 == 0 && mmda::short_tiled::aligned16(q) &&
                  mmda::short_tiled::aligned16(k) && mmda::short_tiled::aligned16(v) &&
                  mmda::short_tiled::aligned16(d_out);
  short_attn_bwd_f32_wgmma_kernel<DP, NW>
      <<<BH, NW * mmda::short_tiled::kTileThreads, bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), bias, seed, static_cast<const float*>(d_out),
          static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), nh, S, D,
          scale, rate, keep_scale, vec);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16

// The two 16 x SP blocks a b^T and a2 b2^T (rows row0 .. of the tiles a_s and
// a2_s, all SP rows of b_s and b2_s; the product runs over DP columns).
template <int N8>
__device__ __forceinline__ void scores(float (&acc)[N8][4], float (&acc2)[N8][4],
                                       const bf16* a_s, const bf16* b_s, const bf16* a2_s,
                                       const bf16* b2_s, int ld, int DP, int row0, int lane) {
#pragma unroll
  for (int j = 0; j < N8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0.0f;
      acc2[j][e] = 0.0f;
    }
  }
  for (int k0 = 0; k0 < DP; k0 += 16) {
    uint32_t a[4], a2[4];
    ldmatrix_x4(a, frag_addr_rows(a_s, ld, row0, k0, lane));
    ldmatrix_x4(a2, frag_addr_rows(a2_s, ld, row0, k0, lane));
#pragma unroll
    for (int j = 0; j < N8; j += 2) {
      uint32_t b[4], b2[4];
      ldmatrix_x4(b, frag_addr_nk(b_s, ld, 8 * j, k0, lane));
      ldmatrix_x4(b2, frag_addr_nk(b2_s, ld, 8 * j, k0, lane));
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
      mma_bf16(acc2[j], a2, b2[0], b2[1]);
      mma_bf16(acc2[j + 1], a2, b2[2], b2[3]);
    }
  }
}

template <int SP>
size_t mma_smem_bytes(int DP) {
  // q, k, v, do; per query: max, sum, r; per key: the bias
  return 4 * (size_t)SP * (DP + kRowPad) * sizeof(bf16) + 4 * SP * sizeof(float);
}

template <int SP>
__global__ void __launch_bounds__(2 * SP)
short_attn_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const int* __restrict__ seed_ptr, const bf16* __restrict__ d_out,
                          bf16* __restrict__ dq, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int nh, int S, int D, int DP, float scale,
                          float rate, float keep_scale) {
  constexpr int NT = 2 * SP;     // SP / 16 warps
  constexpr int N8 = SP / 8;     // n8 tiles of a 16 x SP block
  constexpr int K16 = SP / 16;   // k16 slices of it as an operand
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = DP + kRowPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + SP * ld;
  bf16* v_s = k_s + SP * ld;
  bf16* do_s = v_s + SP * ld;
  float* m_s = reinterpret_cast<float*>(do_s + SP * ld);   // per query: row max,
  float* l_s = m_s + SP;                                   // row sum,
  float* r_s = l_s + SP;                                   // rowsum(dp p)
  float* bias_s = r_s + SP;                                // per key; -inf beyond S

  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  load_operand(q_s, ld, q + base, S, D, SP, DP, NT);
  load_operand(k_s, ld, k + base, S, D, SP, DP, NT);
  load_operand(v_s, ld, v + base, S, D, SP, DP, NT);
  load_operand(do_s, ld, d_out + base, S, D, SP, DP, NT);
  for (int j = threadIdx.x; j < SP; j += NT) bias_s[j] = j < S ? bias[(size_t)b * S + j] : -INFINITY;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);   // the warp's queries (A), keys (B)
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const bool drop = rate > 0.0f;
  const uint32_t hbase = drop ? mmda::short_attn_base((uint32_t)seed_ptr[0], b, h) : 0u;

  // A. [j][e] is query row0 + g + 8 (e / 2), key 8 j + t2 + e % 2
  {
    float s[N8][4], dp[N8][4];
    scores<N8>(s, dp, q_s, k_s, do_s, v_s, ld, DP, row0, lane);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, r[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bias_s[8 * j + t2 + (e & 1)]);
        m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
    }
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + g + 8 * (e >> 1), jk = 8 * j + t2 + (e & 1);
        s[j][e] = s[j][e] / l[e >> 1];   // p
        if (drop) {
          dp[j][e] *= mmda::short_attn_keep(hbase, (uint32_t)(i * S + jk), rate) ? keep_scale
                                                                                  : 0.0f;
        }
        r[e >> 1] += dp[j][e] * s[j][e];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      r[hh] += __shfl_xor_sync(0xffffffffu, r[hh], 1);
      r[hh] += __shfl_xor_sync(0xffffffffu, r[hh], 2);
      if (t2 == 0) {
        m_s[row0 + g + 8 * hh] = m[hh];
        l_s[row0 + g + 8 * hh] = l[hh];
        r_s[row0 + g + 8 * hh] = r[hh];
      }
    }
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] * (dp[j][e] - r[e >> 1]);   // ds
    }
    uint32_t ds_a[3][K16][4];
    split_operand<K16>(ds_a, s);
    product_out<K16>(dq + base, ds_a, k_s, ld, S, D, DP, row0, scale, lane);
  }
  __syncthreads();

  // B. [j][e] is key row0 + g + 8 (e / 2), query 8 j + t2 + e % 2
  float st[N8][4], dpt[N8][4];
  scores<N8>(st, dpt, k_s, q_s, v_s, do_s, ld, DP, row0, lane);
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    const int i = 8 * j + t2;   // the lane's queries i, i + 1
    const float2 m2 = *reinterpret_cast<const float2*>(m_s + i);
    const float2 l2 = *reinterpret_cast<const float2*>(l_s + i);
    const float2 r2 = *reinterpret_cast<const float2*>(r_s + i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = e & 1, jk = row0 + g + 8 * (e >> 1);
      float p = 0.0f;
      if (i + o < S) {
        const float sv = __fadd_rn(__fmul_rn(st[j][e], scale), bias_s[jk]);
        p = expf(sv - (o ? m2.y : m2.x)) / (o ? l2.y : l2.x);
      }
      float keep = 1.0f;
      if (drop) {
        keep = mmda::short_attn_keep(hbase, (uint32_t)((i + o) * S + jk), rate) ? keep_scale
                                                                               : 0.0f;
      }
      st[j][e] = p * keep;                                      // pd
      dpt[j][e] = p * (dpt[j][e] * keep - (o ? r2.y : r2.x));   // ds
    }
  }
  {
    uint32_t pd_a[3][K16][4];
    split_operand<K16>(pd_a, st);
    product_out<K16>(dv + base, pd_a, do_s, ld, S, D, DP, row0, 1.0f, lane);
  }
  uint32_t ds_a[3][K16][4];
  split_operand<K16>(ds_a, dpt);
  product_out<K16>(dk + base, ds_a, q_s, ld, S, D, DP, row0, scale, lane);
}

template <int SP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, const void* d_out, void* dq, void* dk, void* dv, int BH,
                       int nh, int S, int D, float scale, float rate, float keep_scale,
                       cudaStream_t stream) {
  const int DP = (D + 15) / 16 * 16;
  const size_t bytes = mma_smem_bytes<SP>(DP);
  cudaError_t err = cudaFuncSetAttribute(
      short_attn_bwd_mma_kernel<SP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  short_attn_bwd_mma_kernel<SP><<<BH, 2 * SP, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, seed, static_cast<const bf16*>(d_out), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), nh, S, D, DP, scale, rate, keep_scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, const void* d_out, void* dq, void* dk, void* dv, int BH,
                       int nh, int S, int D, float scale, float rate, float keep_scale,
                       cudaStream_t stream) {
  const size_t bytes = smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      short_attn_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  short_attn_bwd_f32_kernel<<<BH, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, seed, static_cast<const float*>(d_out), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), nh, S, D, scale, rate, keep_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// q, k, v, d_out, dq, dk, dv (B, nh, S, D): bf16 when is_bf16 else f32,
// contiguous; 1 <= S <= 128, 1 <= D <= 128 (f32 design 1: the shape's shared
// memory, smem_bytes, within the card's opt-in limit).  impl, scale, rate
// and keep_scale as for mmda_short_attn_fwd; seed (device int32) is read
// only when rate > 0.
int mmda_short_attn_bwd(const void* q, const void* k, const void* v, const float* bias,
                        const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                        int B, int nh, int S, int D, int is_bf16, int impl, float scale,
                        float rate, float keep_scale, void* stream) {
  if (B < 1 || nh < 1 || S < 1 || S > kMaxS || D < 1 || D > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * nh;
  if (!is_bf16) {
    if (impl == 1) {
      return (int)launch_f32(q, k, v, bias, seed, d_out, dq, dk, dv, BH, nh, S, D, scale, rate,
                             keep_scale, st);
    }
#define MMDA_SHORT_BWD_F32(DP, NW)                                                             \
  return (int)launch_f32_wgmma<DP, NW>(q, k, v, bias, seed, d_out, dq, dk, dv, BH, nh, S, D,   \
                                       scale, rate, keep_scale, st)
    if (S <= 64) {
      if (D <= 64) MMDA_SHORT_BWD_F32(64, 1);
      MMDA_SHORT_BWD_F32(128, 1);
    }
    if (D <= 64) MMDA_SHORT_BWD_F32(64, 2);
    MMDA_SHORT_BWD_F32(128, 2);
#undef MMDA_SHORT_BWD_F32
  }
  switch ((S + 15) / 16) {
#define MMDA_SHORT_BWD_CASE(n)                                                              \
  case n:                                                                                   \
    return (int)launch_mma<16 * n>(q, k, v, bias, seed, d_out, dq, dk, dv, BH, nh, S, D,    \
                                   scale, rate, keep_scale, st);
    MMDA_SHORT_BWD_CASE(1)
    MMDA_SHORT_BWD_CASE(2)
    MMDA_SHORT_BWD_CASE(3)
    MMDA_SHORT_BWD_CASE(4)
    MMDA_SHORT_BWD_CASE(5)
    MMDA_SHORT_BWD_CASE(6)
    MMDA_SHORT_BWD_CASE(7)
    MMDA_SHORT_BWD_CASE(8)
#undef MMDA_SHORT_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
