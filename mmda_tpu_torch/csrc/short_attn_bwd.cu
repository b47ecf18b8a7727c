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
// tensor-core peak): bytes.  In f32 the bytes (20.5 us) still just exceed
// the operations at the 67 TFLOP/s f32 peak (18.3 us).
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
// f32: plain f32 FMAs (a TF32 tensor-core product would not meet the f32
// tolerance):
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
// block's shared memory: S <= 128 at D = 64 (the wrapper sends a shape that
// does not fit either kernel to short_attn_tiled_bwd.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_mma.cuh"
#include "hash_dropout.cuh"
#include "short_mma.cuh"

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
// contiguous; 1 <= S <= 128, 1 <= D <= 128, and (f32) the shape's shared
// memory within the card's opt-in limit.  scale, rate and keep_scale as for
// mmda_short_attn_fwd; seed (device int32) is read only when rate > 0.
int mmda_short_attn_bwd(const void* q, const void* k, const void* v, const float* bias,
                        const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                        int B, int nh, int S, int D, int is_bf16, float scale, float rate,
                        float keep_scale, void* stream) {
  if (B < 1 || nh < 1 || S < 1 || S > kMaxS || D < 1 || D > kMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * nh;
  if (!is_bf16) {
    return (int)launch_f32(q, k, v, bias, seed, d_out, dq, dk, dv, BH, nh, S, D, scale, rate,
                           keep_scale, st);
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
