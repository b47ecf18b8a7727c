// Short attention backward over query and key tiles, for Hopper (sm_90a),
// plain C entry point: the sequences that short_attn_bwd.cu's one block per
// (batch item, head) cannot hold (S > 128, or an f32 shape beyond its shared
// memory).
//
// Replaces mmda_tpu/ops/pallas/short_attention.py::_bwd_kernel (:82,
// launched by _bwd_call :143) at any S, with its function: per (batch item
// b, head h), all f32,
//
//   p    = exp(s - m) / l, s = (q * scale) k^T + bias[b]   pre-dropout
//   keep = mask * f32(1 / (1 - rate))                      the forward's mask, rehashed
//   dp   = (do v^T) * keep;  r = rowsum(dp * p)
//   ds   = p * (dp - r)
//   dq   = (ds k) * scale;  dk = ds^T (q * scale);  dv = (p * keep)^T do
//
// each of dq, dk, dv rounded once to the input type; nothing rounded in
// between.  It reads the training forward's row statistics (m, l per query)
// and o32 (o in f32 before its rounding): p = exp(s - m) (1 / l), a multiply
// and no division a score, and r = rowsum(do o32), the algebraic form of
// rowsum(dp p) (r from the bf16 o would miss the one-ulp gate: its 2^-9
// reaches dq wherever ds cancels).
//
// Three kernels, so that no sum needs an atomic (short_tiled.cuh's tiles):
//   1. tiled_r: r per query, a warp a row.
//   2. tiled_dq: a block per query tile, one pass over the key tiles: s and
//      dp, ds = p (dp - r), dq += ds k.
//   3. tiled_dkv: a block per key tile streams the query tiles: the
//      transposed scores k q^T and v do^T, p from the saved m and l, the mask,
//      pd and ds from r; dv += pd^T do, dk += ds^T q.
// Every sum runs in a fixed order: two launches give the same bits.
// bf16, wgmma fed by TMA (wgmma.cuh) where D is a multiple of 8 above 32 and
// the inputs 16-byte aligned: the score products m64nNk16 from shared memory,
// each f32 intermediate (ds, pd) as three m64nDPk16 issues of its bf16 terms
// from registers against the streamed tile read MN-major; the block's own
// rows once, the streamed side through a two-stage TMA ring; in the dk/dv
// kernel ds is split into its terms while dv's products run.  Every other
// head dim: mma.sync m16n8k16 with the same arithmetic, through cp.async.
// Both take short_attn_bwd.cu's arithmetic (q k^T and do v^T straight from
// the inputs, scale after the product; exp(s - m) as ex2.approx of (s - m)
// log2 e).
// f32, on the tensor cores (impl 0, every head dim): q * scale first and
// expf, as the plain version; every f32 operand (q * scale, k, v, do, and
// the intermediates pd and ds) as three bf16 terms and every product as six
// bf16 term products on wgmma (short_attn_tiled_fwd.cu), 18 a key tile in the
// dq kernel (s, dp, ds k) and 24 a query tile in the dk/dv kernel (s^T, dp^T,
// pd^T do, ds^T q): 42 in all.  The block's own 64 rows are split once; the
// streamed side 32 rows a tile, read from global memory into registers and
// split into swizzled term tiles by all threads (no f32 copy in shared
// memory: three blocks share an SM at D <= 64, 73 KB each).  q * scale and
// k are split on each row's grid (short_tiled.cuh), so that the scores' hi
// hi sums are exact and take their own accumulator (wgmma::issue_scores).
// The score products take the forward's term pairs in its order (k q^T and
// v do^T with A and B swapped), so s is the forward's.  Each tile's dq (dk,
// dv) is summed in a fresh accumulator, 64 columns at a time, and added to
// the running one in f32: the tensor cores' sums, in their order and
// rounding, stay within a tile, and dq, dk, dv lie within the f32 gate of
// the plain version, not on its bits (closer to float64 than it: PERF.md).
// D is zero-padded to 64 or 128.  f32
// FMAs (impl 1, kept for comparison): a lane a key (dq) or a query (dk/dv)
// of 32-row tiles, 10 shared-memory loads for 8 FMAs in the score loops.
//
// What bounds it on the H100 at the long step's call (32, 12, 514, 64) bf16:
// 10 S^2 D operations a head as the bound counts them (q k^T, do v^T, ds k,
// pd^T do, ds^T q) take 0.066 ms at the bf16 peak.  The kernels form q k^T and
// do v^T twice (once a kernel) and the three other products three times over
// (a bf16 term each), and an exp and a hash per score in each kernel.  Its
// times beside the mma.sync design's, by part: PERF.md.  In f32 the bound is
// the same 10 S^2 D operations at a sixth of the bf16 peak (the six term
// products): 0.394 ms, above the 0.106 ms of the bytes.  The kernels issue
// 42 term products where the bound counts 30 (s and dp twice), split every
// element they read and every ds and pd three ways, and take an expf and a
// hash a score in each, serialised with the products within each
// warpgroup; three blocks share an SM at D <= 64, one at D <= 128 (145 KB).

#include "short_tiled.cuh"
#include "wgmma.cuh"

namespace {

using mmda::flash::bf16;
using mmda::flash::kRowPad;
using namespace mmda::short_tiled;

// ------------------------------------------------------------------ r

constexpr int kRThreads = 256;   // a warp a query row

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

// r[i] = sum_d do[i, d] o32[i, d] in f32, for the rows i < n of the row-major
// (n, D) do (in the input type) and o32 (f32).
template <typename T>
__global__ void __launch_bounds__(kRThreads)
tiled_r_kernel(const T* __restrict__ d_out, const float* __restrict__ o32,
               float* __restrict__ r, size_t n, int D) {
  const size_t i = (size_t)blockIdx.x * (kRThreads / 32) + (threadIdx.x >> 5);
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  const T* di = d_out + i * D;
  const float* oi = o32 + i * D;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32) acc = fmaf(widen(di[c]), oi[c], acc);
  acc = warp_sum(acc);
  if (lane == 0) r[i] = acc;
}

template <typename T>
cudaError_t launch_r(const void* d_out, const float* o32, float* r, size_t n, int D,
                     cudaStream_t stream) {
  const size_t blocks = (n + kRThreads / 32 - 1) / (kRThreads / 32);
  tiled_r_kernel<T><<<(unsigned)blocks, kRThreads, 0, stream>>>(static_cast<const T*>(d_out),
                                                                 o32, r, n, D);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16

// Whether (batch item, head) bh is an item whose keys are all masked
// (pd_ds_of): query 0's saved row max, which every query of the item shares
// up to its scores.
__device__ __forceinline__ bool masked_item(const float* stats, int bh, int S) {
  return stats[(size_t)bh * S * 2] < kMaskedRowMax;
}

template <bool B>
struct Rounded {
  static constexpr bool value = B;
};

template <int DP>
size_t dq_smem_bytes() {
  constexpr int NB = stream_rows<DP>();
  // q, do; 2 x (k, v); 2 x the key bias
  return ((size_t)2 * kTileRows + 4 * NB) * (DP + kRowPad) * sizeof(bf16) +
         2 * NB * sizeof(float);
}

// The rows' saved m, 1 / l and r (0, 0, 0 beyond S: p = 0 there).
__device__ __forceinline__ void row_stats(const float* stats, const float* r_g, size_t row,
                                          bool valid, float& m, float& il, float& rr) {
  m = il = rr = 0.0f;
  if (valid) {
    const float2 st = *reinterpret_cast<const float2*>(stats + row * 2);
    m = st.x;
    il = 1.0f / st.y;
    rr = r_g[row];
  }
}

// mma.sync m16n8k16; k, v and the key bias through two cp.async buffers.
template <int DP>
__global__ void __launch_bounds__(kTileThreads)
tiled_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ seed_ptr, const bf16* __restrict__ d_out,
                    const float* __restrict__ stats, const float* __restrict__ r_g,
                    bf16* __restrict__ dq, int nh, int S, int D, int q_tiles, float scale,
                    float rate, float keep_scale) {
  constexpr int NB = stream_rows<DP>();
  constexpr int N8 = NB / 8;
  constexpr int L = DP + kRowPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // (64, L)
  bf16* do_s = q_s + kTileRows * L;                // (64, L)
  bf16* k_s = do_s + kTileRows * L;                // 2 x (NB, L)
  bf16* v_s = k_s + 2 * NB * L;                    // 2 x (NB, L)
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * NB * L);   // 2 x NB; -inf beyond S

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* bias_b = bias + (size_t)b * S;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int k_tiles = (S + NB - 1) / NB;
  const KeepMask keep(seed_ptr, b, h, S, rate);

  load_rows<DP>(q_s, q + base, q0, kTileRows, S, D, kTileThreads);
  load_rows<DP>(do_s, d_out + base, q0, kTileRows, S, D, kTileThreads);
  auto stage = [&](int t) {
    const int buf = t & 1;
    load_rows<DP>(k_s + buf * NB * L, k + base, t * NB, NB, S, D, kTileThreads);
    load_rows<DP>(v_s + buf * NB * L, v + base, t * NB, NB, S, D, kTileThreads);
    for (int j = threadIdx.x; j < NB; j += kTileThreads) {
      bias_s[buf * NB + j] = t * NB + j < S ? bias_b[t * NB + j] : -INFINITY;
    }
    mmda::flash::cp_async_commit();
  };
  float m[2], il[2], rr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + row0 + g + 8 * hh;
    row_stats(stats, r_g, (size_t)bh * S + i, i < S, m[hh], il[hh], rr[hh]);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  stage(0);
  for (int t = 0; t < k_tiles; ++t) {
    if (t + 1 < k_tiles) {
      stage(t + 1);
      cp_async_wait_one();
    } else {
      mmda::flash::cp_async_wait_all();
    }
    __syncthreads();
    const int buf = t & 1;
    float s[N8][4], dp[N8][4];
#pragma unroll
    for (int j = 0; j < N8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
    mmda::flash::mma_abt<DP, N8>(s, q_s, row0, k_s + buf * NB * L, lane);
    mmda::flash::mma_abt<DP, N8>(dp, do_s, row0, v_s + buf * NB * L, lane);
    scale_bias<N8>(s, scale, bias_s + buf * NB, t2);
    ds_of<N8>(s, dp, m, il, rr, keep, q0 + row0 + g, t * NB + t2, keep_scale);
    split_product<DP, NB>(acc, s, k_s + buf * NB * L, lane);
    __syncthreads();
  }
  store_rows<DP>(dq + base, acc, q0 + row0, S, D, scale, lane);
}

template <int DP>
size_t dkv_smem_bytes() {
  constexpr int NB = stream_rows<DP>();
  // k, v; 2 x (q, do); 2 x (m, 1 / l, r) per query
  return ((size_t)2 * kTileRows + 4 * NB) * (DP + kRowPad) * sizeof(bf16) +
         2 * 3 * NB * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads)
tiled_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, const bf16* __restrict__ d_out,
                     const float* __restrict__ stats, const float* __restrict__ r_g,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int nh, int S, int D,
                     int k_tiles, float scale, float rate, float keep_scale) {
  constexpr int NB = stream_rows<DP>();
  constexpr int N8 = NB / 8;
  constexpr int L = DP + kRowPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // (64, L)
  bf16* v_s = k_s + kTileRows * L;                 // (64, L)
  bf16* q_s = v_s + kTileRows * L;                 // 2 x (NB, L)
  bf16* do_s = q_s + 2 * NB * L;                   // 2 x (NB, L)
  float* st_s = reinterpret_cast<float*>(do_s + 2 * NB * L);   // 2 x (NB, 3)

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x - bh * k_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int q_tiles = (S + NB - 1) / NB;
  const KeepMask keep(seed_ptr, b, h, S, rate);
  // the key bias of the warp's keys k0 + row0 + g (+ 8) in log2 units: -inf
  // beyond S
  float kbl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int jk = k0 + row0 + g + 8 * hh;
    kbl[hh] = jk < S ? log2e_units(bias[(size_t)b * S + jk]) : -INFINITY;
  }

  load_rows<DP>(k_s, k + base, k0, kTileRows, S, D, kTileThreads);
  load_rows<DP>(v_s, v + base, k0, kTileRows, S, D, kTileThreads);
  auto stage = [&](int t) {
    const int buf = t & 1;
    load_rows<DP>(q_s + buf * NB * L, q + base, t * NB, NB, S, D, kTileThreads);
    load_rows<DP>(do_s + buf * NB * L, d_out + base, t * NB, NB, S, D, kTileThreads);
    for (int e = threadIdx.x; e < NB; e += kTileThreads) {
      const int i = t * NB + e;
      float* st = st_s + buf * 3 * NB + 3 * e;
      row_stats(stats, r_g, (size_t)bh * S + i, i < S, st[0], st[1], st[2]);
      st[0] = log2e_units(st[0]);
    }
    mmda::flash::cp_async_commit();
  };

  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.0f;
  }
  stage(0);
  // the tile loop, once for each form of pd_ds_of (the branch outside it)
  auto tiles = [&](auto rounded) {
    for (int t = 0; t < q_tiles; ++t) {
      if (t + 1 < q_tiles) {
        stage(t + 1);
        cp_async_wait_one();
      } else {
        mmda::flash::cp_async_wait_all();
      }
      __syncthreads();
      const int buf = t & 1;
      const bf16* qt = q_s + buf * NB * L;
      const bf16* dot = do_s + buf * NB * L;
      // [j][e]: key k0 + row0 + g + 8 (e / 2), query t NB + 8 j + t2 + e % 2
      float sT[N8][4], dpT[N8][4];
#pragma unroll
      for (int j = 0; j < N8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.0f;
      }
      mmda::flash::mma_abt<DP, N8>(sT, k_s, row0, qt, lane);
      mmda::flash::mma_abt<DP, N8>(dpT, v_s, row0, dot, lane);
      pd_ds_of<N8, decltype(rounded)::value>(sT, dpT, st_s + buf * 3 * NB, kbl,
                                             log2e_units(scale), scale, bias + (size_t)b * S,
                                             keep, t * NB, t2, k0 + row0 + g, S, keep_scale);
      split_product<DP, NB>(acc_v, sT, dot, lane);
      split_product<DP, NB>(acc_k, dpT, qt, lane);
      __syncthreads();
    }
  };
  if (masked_item(stats, bh, S)) {
    tiles(Rounded<true>{});
  } else {
    tiles(Rounded<false>{});
  }
  store_rows<DP>(dv + base, acc_v, k0 + row0, S, D, 1.0f, lane);
  store_rows<DP>(dk + base, acc_k, k0 + row0, S, D, scale, lane);
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                       const float* stats, const float* r, int BH, int nh, int S, int D,
                       float scale, float rate, float keep_scale, cudaStream_t stream) {
  const size_t dq_bytes = dq_smem_bytes<DP>(), dkv_bytes = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      tiled_dq_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_dkv_mma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  tiled_dq_mma_kernel<DP><<<BH * tiles, kTileThreads, dq_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, seed, static_cast<const bf16*>(d_out), stats, r, static_cast<bf16*>(dq), nh, S, D,
      tiles, scale, rate, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_dkv_mma_kernel<DP><<<BH * tiles, kTileThreads, dkv_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, seed, static_cast<const bf16*>(d_out), stats, r, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), nh, S, D, tiles, scale, rate, keep_scale);
  return cudaGetLastError();
}

// wgmma fed by TMA: the block's own rows once, the streamed side a tile at a
// time through a ring of kStages buffers, one thread issuing; the key bias
// or the queries' (m, 1 / l, r) staged by every thread.
constexpr int kStages = 2;

// The streamed tile's rows: 64, or 32 for the dk/dv kernel at DP = 128 (its
// two accumulators take 128 registers a thread).
template <int DP, bool DKV>
__host__ __device__ constexpr int wg_rows() { return DKV && DP > 64 ? 32 : 64; }

template <int DP, bool DKV>
constexpr size_t wg_smem_bytes() {
  constexpr int NB = wg_rows<DP, DKV>();
  return ((size_t)2 * kTileRows * DP + 2 * kStages * NB * DP) * sizeof(bf16) +
         kStages * 3 * NB * sizeof(float) + (kStages + 1) * sizeof(uint64_t) +
         mmda::wgmma::kSmemAlign;
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads)
tiled_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ bias,
                      const int* __restrict__ seed_ptr, const float* __restrict__ stats,
                      const float* __restrict__ r_g, bf16* __restrict__ dq, int nh, int S, int D,
                      int q_tiles, float scale, float rate, float keep_scale) {
  namespace wg = mmda::wgmma;
  constexpr int NB = wg_rows<DP, false>(), N8 = NB / 8, TILE = NB * DP;
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(wg::align_smem(smem_raw));   // (64, DP)
  bf16* do_s = q_s + kTileRows * DP;               // (64, DP)
  bf16* k_s = do_s + kTileRows * DP;               // kStages x (NB, DP)
  bf16* v_s = k_s + kStages * TILE;                // kStages x (NB, DP)
  float* bias_s = reinterpret_cast<float*>(v_s + kStages * TILE);   // kStages x NB
  uint64_t* bar = reinterpret_cast<uint64_t*>(bias_s + kStages * 3 * NB);   // stages; q, do

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const float* bias_b = bias + (size_t)b * S;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int k_tiles = (S + NB - 1) / NB;
  const KeepMask keep(seed_ptr, b, h, S, rate);

  auto issue = [&](int t) {
    uint64_t* full = bar + t % kStages;
    wg::mbar_expect_tx(full, 2 * TILE * sizeof(bf16));
    wg::tma_tile<DP>(k_s + (t % kStages) * TILE, &tk, full, NB, t * NB, bh);
    wg::tma_tile<DP>(v_s + (t % kStages) * TILE, &tv, full, NB, t * NB, bh);
  };
  auto stage_bias = [&](int t) {
    for (int j = threadIdx.x; j < NB; j += kTileThreads) {
      bias_s[(t % kStages) * NB + j] = t * NB + j < S ? bias_b[t * NB + j] : -INFINITY;
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) wg::mbar_init(bar + i, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_expect_tx(bar + kStages, 2 * kTileRows * DP * sizeof(bf16));
    wg::tma_tile<DP>(q_s, &tq, bar + kStages, kTileRows, q0, bh);
    wg::tma_tile<DP>(do_s, &tdo, bar + kStages, kTileRows, q0, bh);
    issue(0);
  }
  stage_bias(0);
  float m[2], il[2], rr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + row0 + g + 8 * hh;
    row_stats(stats, r_g, (size_t)bh * S + i, i < S, m[hh], il[hh], rr[hh]);
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  wg::mbar_wait(bar + kStages, 0);

  for (int t = 0; t < k_tiles; ++t) {
    const int st = t % kStages;
    __syncthreads();     // tile t - 1's buffers are free; tile t's bias is in
    if (t + 1 < k_tiles) {
      if (threadIdx.x == 0) issue(t + 1);
      stage_bias(t + 1);
    }
    wg::mbar_wait(bar + st, (t / kStages) & 1);
    float s[N8][4], dp[N8][4];
    wg::fence();
    wg::issue_abt<NB, DP>(s, q_s, k_s + st * TILE);
    wg::issue_abt<NB, DP>(dp, do_s, v_s + st * TILE);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(s);
    wg::fence_operand(dp);
    scale_bias<N8>(s, scale, bias_s + st * NB, t2);
    ds_of<N8>(s, dp, m, il, rr, keep, q0 + row0 + g, t * NB + t2, keep_scale);
    uint32_t a[3][NB / 16][4];
    mmda::short_mma::split_operand<NB / 16>(a, s);
    wg::fence_operand(acc);
    wg::fence();
    wg::issue_split_product<DP, NB>(acc, a, k_s + st * TILE);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(acc);
  }
  store_rows<DP>(dq + (size_t)bh * S * D, acc, q0 + row0, S, D, scale, lane);
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads)
tiled_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float* __restrict__ bias,
                       const int* __restrict__ seed_ptr, const float* __restrict__ stats,
                       const float* __restrict__ r_g, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int nh, int S, int D, int k_tiles, float scale,
                       float rate, float keep_scale) {
  namespace wg = mmda::wgmma;
  constexpr int NB = wg_rows<DP, true>(), N8 = NB / 8, TILE = NB * DP;
  extern __shared__ unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(wg::align_smem(smem_raw));   // (64, DP)
  bf16* v_s = k_s + kTileRows * DP;                // (64, DP)
  bf16* q_s = v_s + kTileRows * DP;                // kStages x (NB, DP)
  bf16* do_s = q_s + kStages * TILE;               // kStages x (NB, DP)
  float* st_s = reinterpret_cast<float*>(do_s + kStages * TILE);   // kStages x (NB, 3)
  uint64_t* bar = reinterpret_cast<uint64_t*>(st_s + kStages * 3 * NB);   // stages; k, v

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x - bh * k_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int q_tiles = (S + NB - 1) / NB;
  const KeepMask keep(seed_ptr, b, h, S, rate);
  float kbl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int jk = k0 + row0 + g + 8 * hh;
    kbl[hh] = jk < S ? log2e_units(bias[(size_t)b * S + jk]) : -INFINITY;
  }

  auto issue = [&](int t) {
    uint64_t* full = bar + t % kStages;
    wg::mbar_expect_tx(full, 2 * TILE * sizeof(bf16));
    wg::tma_tile<DP>(q_s + (t % kStages) * TILE, &tq, full, NB, t * NB, bh);
    wg::tma_tile<DP>(do_s + (t % kStages) * TILE, &tdo, full, NB, t * NB, bh);
  };
  auto stage_stats = [&](int t) {
    for (int e = threadIdx.x; e < NB; e += kTileThreads) {
      const int i = t * NB + e;
      float* st = st_s + (t % kStages) * 3 * NB + 3 * e;
      row_stats(stats, r_g, (size_t)bh * S + i, i < S, st[0], st[1], st[2]);
      st[0] = log2e_units(st[0]);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) wg::mbar_init(bar + i, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_expect_tx(bar + kStages, 2 * kTileRows * DP * sizeof(bf16));
    wg::tma_tile<DP>(k_s, &tk, bar + kStages, kTileRows, k0, bh);
    wg::tma_tile<DP>(v_s, &tv, bar + kStages, kTileRows, k0, bh);
    issue(0);
  }
  stage_stats(0);
  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.0f;
  }
  wg::mbar_wait(bar + kStages, 0);

  // the tile loop, once for each form of pd_ds_of (the branch outside it)
  auto tiles = [&](auto rounded) {
    for (int t = 0; t < q_tiles; ++t) {
      const int st = t % kStages;
      __syncthreads();     // tile t - 1's buffers are free; tile t's statistics are in
      if (t + 1 < q_tiles) {
        if (threadIdx.x == 0) issue(t + 1);
        stage_stats(t + 1);
      }
      wg::mbar_wait(bar + st, (t / kStages) & 1);
      const bf16* qt = q_s + st * TILE;
      const bf16* dot = do_s + st * TILE;
      // [j][e]: key k0 + row0 + g + 8 (e / 2), query t NB + 8 j + t2 + e % 2
      float sT[N8][4], dpT[N8][4];
      wg::fence();
      wg::issue_abt<NB, DP>(sT, k_s, qt);
      wg::issue_abt<NB, DP>(dpT, v_s, dot);
      wg::commit();
      wg::wait_all();
      wg::fence_operand(sT);
      wg::fence_operand(dpT);
      pd_ds_of<N8, decltype(rounded)::value>(sT, dpT, st_s + st * 3 * NB, kbl,
                                             log2e_units(scale), scale, bias + (size_t)b * S,
                                             keep, t * NB, t2, k0 + row0 + g, S, keep_scale);
      // dv's products run while ds is split into the operand of dk's
      uint32_t a_v[3][NB / 16][4], a_k[3][NB / 16][4];
      mmda::short_mma::split_operand<NB / 16>(a_v, sT);
      wg::fence_operand(acc_v);
      wg::fence_operand(acc_k);
      wg::fence();
      wg::issue_split_product<DP, NB>(acc_v, a_v, dot);
      mmda::short_mma::split_operand<NB / 16>(a_k, dpT);
      wg::fence();
      wg::issue_split_product<DP, NB>(acc_k, a_k, qt);
      wg::commit();
      wg::wait_all();
      wg::fence_operand(acc_v);
      wg::fence_operand(acc_k);
    }
  };
  if (masked_item(stats, bh, S)) {
    tiles(Rounded<true>{});
  } else {
    tiles(Rounded<false>{});
  }
  const size_t base = (size_t)bh * S * D;
  store_rows<DP>(dv + base, acc_v, k0 + row0, S, D, 1.0f, lane);
  store_rows<DP>(dk + base, acc_k, k0 + row0, S, D, scale, lane);
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* bias,
                         const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                         const float* stats, const float* r, int BH, int nh, int S, int D,
                         float scale, float rate, float keep_scale, cudaStream_t stream) {
  namespace wg = mmda::wgmma;
  constexpr int NBQ = wg_rows<DP, false>(), NBK = wg_rows<DP, true>();
  CUtensorMap tq, tk, tv, tdo, sq, sdo;    // the dq kernel's maps, then the dk/dv kernel's
  if (!wg::head_map(&tq, q, BH, S, D, kTileRows) ||
      !wg::head_map(&tdo, d_out, BH, S, D, kTileRows) || !wg::head_map(&tk, k, BH, S, D, NBQ) ||
      !wg::head_map(&tv, v, BH, S, D, NBQ) || !wg::head_map(&sq, q, BH, S, D, NBK) ||
      !wg::head_map(&sdo, d_out, BH, S, D, NBK)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t dq_bytes = wg_smem_bytes<DP, false>(), dkv_bytes = wg_smem_bytes<DP, true>();
  cudaError_t err = cudaFuncSetAttribute(tiled_dq_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_dkv_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  tiled_dq_wgmma_kernel<DP><<<BH * tiles, kTileThreads, dq_bytes, stream>>>(
      tq, tk, tv, tdo, bias, seed, stats, r, static_cast<bf16*>(dq), nh, S, D, tiles, scale, rate,
      keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dk/dv kernel's own rows are 64-row boxes of k and v: tq's and tdo's
  // box shape, on the other tensors
  CUtensorMap bk, bv;
  if (!wg::head_map(&bk, k, BH, S, D, kTileRows) || !wg::head_map(&bv, v, BH, S, D, kTileRows)) {
    return cudaErrorInvalidValue;
  }
  tiled_dkv_wgmma_kernel<DP><<<BH * tiles, kTileThreads, dkv_bytes, stream>>>(
      sq, bk, bv, sdo, bias, seed, stats, r, static_cast<bf16*>(dk), static_cast<bf16*>(dv), nh,
      S, D, tiles, scale, rate, keep_scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32

size_t dq_f32_smem_bytes(int D) {
  // k and v tiles (stride D + 1); per warp its 4 q * scale rows, 4 do rows
  // and 4 ds rows
  return (2 * (size_t)kF32Rows * (D + 1) +
          (size_t)kF32Warps * kF32RowsPerWarp * (2 * D + kF32Rows)) * sizeof(float);
}

__global__ void __launch_bounds__(kF32Threads)
tiled_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ seed_ptr, const float* __restrict__ d_out,
                    const float* __restrict__ stats, const float* __restrict__ r_g,
                    float* __restrict__ dq, int nh, int S, int D, int q_tiles, float scale,
                    float rate, float keep_scale) {
  constexpr int R = kF32RowsPerWarp;
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* k_s = smem;                                  // (32, D + 1)
  float* v_s = k_s + kF32Rows * ld;                   // (32, D + 1)
  float* q_w = v_s + kF32Rows * ld + warp * R * (2 * D + kF32Rows);   // (R, D) q * scale
  float* do_w = q_w + R * D;                          // (R, D) do
  float* ds_w = do_w + R * D;                         // (R, 32) ds

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kF32Rows + warp * R;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* bias_b = bias + (size_t)b * S;
  const KeepMask keep(seed_ptr, b, h, S, rate);
  const int k_tiles = (S + kF32Rows - 1) / kF32Rows;

  for (int e = lane; e < R * D; e += 32) {
    const int r = e / D;
    const bool ok = q0 + r < S;
    const size_t at = base + (size_t)(q0 + r) * D + (e - r * D);
    q_w[e] = ok ? q[at] * scale : 0.0f;
    do_w[e] = ok ? d_out[at] : 0.0f;
  }
  float m[R], il[R], rr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row_stats(stats, r_g, (size_t)bh * S + q0 + r, q0 + r < S, m[r], il[r], rr[r]);
  }
  __syncwarp();

  float acc[R][kF32Cols] = {};
  for (int t = 0; t < k_tiles; ++t) {
    const int k0 = t * kF32Rows;
    stage_f32(k_s, k + base, k0, kF32Rows, S, D, 1.0f, kF32Threads);
    stage_f32(v_s, v + base, k0, kF32Rows, S, D, 1.0f, kF32Threads);
    __syncthreads();
    // the warp's R rows with key k0 + lane: s (-inf beyond S) and dp
    const int j = k0 + lane;
    const float* kj = k_s + lane * ld;
    const float* vj = v_s + lane * ld;
    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float kc = kj[c], vc = vj[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(q_w[r * D + c], kc, s[r]);
        dp[r] = fmaf(do_w[r * D + c], vc, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ds = 0.0f;
      if (j < S) {
        const float p = expf(s[r] + bias_b[j] - m[r]) * il[r];
        ds = p * (dp[r] * (keep(q0 + r, j) ? keep_scale : 0.0f) - rr[r]);
      }
      ds_w[r * kF32Rows + lane] = ds;
    }
    __syncwarp();
    const int n = min(kF32Rows, S - k0);
    for (int jj = 0; jj < n; ++jj) {
#pragma unroll
      for (int u = 0; u < kF32Cols; ++u) {
        const int c = lane + 32 * u;
        if (c < D) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][u] = fmaf(ds_w[r * kF32Rows + jj], k_s[jj * ld + c], acc[r][u]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (q0 + r >= S) continue;
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      if (c < D) dq[base + (size_t)(q0 + r) * D + c] = acc[r][u] * scale;
    }
  }
}

size_t dkv_f32_smem_bytes(int D) {
  // the block's k and v rows, the streamed q * scale and do tiles (stride
  // D + 1), their (m, 1 / l, r); per warp its 4 keys' pd and ds rows
  return (4 * (size_t)kF32Rows * (D + 1) + 3 * kF32Rows +
          (size_t)kF32Warps * kF32RowsPerWarp * 2 * kF32Rows) * sizeof(float);
}

__global__ void __launch_bounds__(kF32Threads)
tiled_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, const float* __restrict__ d_out,
                     const float* __restrict__ stats, const float* __restrict__ r_g,
                     float* __restrict__ dk, float* __restrict__ dv, int nh, int S, int D,
                     int k_tiles, float scale, float rate, float keep_scale) {
  constexpr int R = kF32RowsPerWarp;
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* k_s = smem;                     // (32, D + 1): the block's keys
  float* v_s = k_s + kF32Rows * ld;
  float* q_s = v_s + kF32Rows * ld;      // (32, D + 1): q * scale of a query tile
  float* do_s = q_s + kF32Rows * ld;
  float* st_s = do_s + kF32Rows * ld;    // (32, 3): m, 1 / l, r
  float* pd_w = st_s + 3 * kF32Rows + warp * R * 2 * kF32Rows;   // (R, 32) pd
  float* ds_w = pd_w + R * kF32Rows;                             // (R, 32) ds

  const int bh = blockIdx.x / k_tiles;
  const int kb0 = (blockIdx.x - bh * k_tiles) * kF32Rows;
  const int k0 = kb0 + warp * R;          // the warp's keys
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const KeepMask keep(seed_ptr, b, h, S, rate);
  const int q_tiles = (S + kF32Rows - 1) / kF32Rows;
  float kb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) kb[r] = k0 + r < S ? bias[(size_t)b * S + k0 + r] : -INFINITY;

  stage_f32(k_s, k + base, kb0, kF32Rows, S, D, 1.0f, kF32Threads);
  stage_f32(v_s, v + base, kb0, kF32Rows, S, D, 1.0f, kF32Threads);
  float acc_k[R][kF32Cols] = {}, acc_v[R][kF32Cols] = {};
  for (int t = 0; t < q_tiles; ++t) {
    const int i0 = t * kF32Rows;
    stage_f32(q_s, q + base, i0, kF32Rows, S, D, scale, kF32Threads);
    stage_f32(do_s, d_out + base, i0, kF32Rows, S, D, 1.0f, kF32Threads);
    for (int e = threadIdx.x; e < kF32Rows; e += kF32Threads) {
      row_stats(stats, r_g, (size_t)bh * S + i0 + e, i0 + e < S, st_s[3 * e], st_s[3 * e + 1],
                st_s[3 * e + 2]);
    }
    __syncthreads();
    // the lane's query i0 + lane against the warp's R keys
    const int i = i0 + lane;
    const float* qi = q_s + lane * ld;
    const float* doi = do_s + lane * ld;
    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float qc = qi[c], dc = doi[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(qc, k_s[(warp * R + r) * ld + c], s[r]);
        dp[r] = fmaf(dc, v_s[(warp * R + r) * ld + c], dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p =
          i < S ? expf(s[r] + kb[r] - st_s[3 * lane]) * st_s[3 * lane + 1] : 0.0f;
      const float kp = keep(i, k0 + r) ? keep_scale : 0.0f;
      pd_w[r * kF32Rows + lane] = p * kp;
      ds_w[r * kF32Rows + lane] = p * (dp[r] * kp - st_s[3 * lane + 2]);
    }
    __syncwarp();
    const int n = min(kF32Rows, S - i0);
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int u = 0; u < kF32Cols; ++u) {
        const int c = lane + 32 * u;
        if (c < D) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc_v[r][u] = fmaf(pd_w[r * kF32Rows + j], do_s[j * ld + c], acc_v[r][u]);
            acc_k[r][u] = fmaf(ds_w[r * kF32Rows + j], q_s[j * ld + c], acc_k[r][u]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (k0 + r >= S) continue;
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      if (c < D) {
        dk[base + (size_t)(k0 + r) * D + c] = acc_k[r][u];
        dv[base + (size_t)(k0 + r) * D + c] = acc_v[r][u];
      }
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias,
                       const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                       const float* stats, const float* r, int BH, int nh, int S, int D,
                       float scale, float rate, float keep_scale, cudaStream_t stream) {
  const size_t dq_bytes = dq_f32_smem_bytes(D), dkv_bytes = dkv_f32_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(tiled_dq_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kF32Rows - 1) / kF32Rows;
  tiled_dq_f32_kernel<<<BH * tiles, kF32Threads, dq_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, seed, static_cast<const float*>(d_out), stats, r, static_cast<float*>(dq), nh, S, D,
      tiles, scale, rate, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_dkv_f32_kernel<<<BH * tiles, kF32Threads, dkv_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, seed, static_cast<const float*>(d_out), stats, r, static_cast<float*>(dk),
      static_cast<float*>(dv), nh, S, D, tiles, scale, rate, keep_scale);
  return cudaGetLastError();
}

// f32 on wgmma: every f32 operand as three bf16 terms, every product six
// term products (wgmma.cuh issue_terms_*).  The block's own rows (q * scale
// and do in the dq kernel, k and v in the dk/dv kernel) are split once; the
// streamed side kF32StreamRows rows a tile, read from global memory into
// registers and split into their term tiles by all threads (no f32 staging
// in shared memory: three blocks share an SM at D <= 64).  Each tile's dq
// (dk, dv) is summed in a fresh accumulator, 64 columns at a time, then
// added to the running one in f32: the tensor cores' sums stay within the
// tile.  The score products take the forward's term pairs in its order (k
// q^T and v do^T with Swap), so s is the forward's s.
template <int DP>
constexpr size_t f32_wgmma_smem_bytes() {
  // the block's two inputs' terms, the streamed two's, the streamed rows'
  // key bias or (m, 1 / l, r)
  return (size_t)3 * 2 * (kTileRows + kF32StreamRows) * DP * sizeof(bf16) +
         3 * kF32StreamRows * sizeof(float) + mmda::wgmma::kSmemAlign;
}

// acc[8 hb + j] += part (the 64 columns of box hb)
template <int DP>
__device__ __forceinline__ void add_part(float (&acc)[DP / 8][4], const float (&part)[8][4],
                                         int hb) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[8 * hb + j][e] += part[j][e];
  }
}

// acc += X B over the K rows of the term tiles b (K x DP, three terms term
// apart), X the three terms a: 64 columns at a time, each in a fresh
// accumulator; waits for the products.
template <int DP, int K>
__device__ __forceinline__ void tile_product(float (&acc)[DP / 8][4],
                                             const uint32_t (&a)[3][K / 16][4], const bf16* b,
                                             int term) {
  namespace wg = mmda::wgmma;
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
    wg::issue_terms_product<K>(part, a, b + hb * K * wg::kBoxCols, term);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(part);
    add_part<DP>(acc, part, hb);
  }
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads, DP == 64 ? 3 : 1)
tiled_dq_f32_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const int* __restrict__ seed_ptr, const float* __restrict__ d_out,
                          const float* __restrict__ stats, const float* __restrict__ r_g,
                          float* __restrict__ dq, int nh, int S, int D, int q_tiles, float scale,
                          float rate, float keep_scale, int vec) {
  namespace wg = mmda::wgmma;
  constexpr int NB = kF32StreamRows, N8 = NB / 8;
  constexpr int QT = kTileRows * DP, KT = NB * DP;   // elements of a term tile
  extern __shared__ unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(wg::align_smem(smem_raw));   // 3 x (64, DP) q * scale
  bf16* do_s = q_s + 3 * QT;                         // 3 x (64, DP)
  bf16* k_s = do_s + 3 * QT;                         // 3 x (NB, DP)
  bf16* v_s = k_s + 3 * KT;                          // 3 x (NB, DP)
  float* bias_s = reinterpret_cast<float*>(v_s + 3 * KT);   // NB; -inf beyond S

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const float* bias_b = bias + (size_t)b * S;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int k_tiles = (S + NB - 1) / NB;
  const KeepMask keep(seed_ptr, b, h, S, rate);

  split_rows<DP, kTileRows, true>(q_s, QT, q + base, q0, S, D, vec, scale);
  split_rows<DP, kTileRows, false>(do_s, QT, d_out + base, q0, S, D, vec, 1.0f);
  float m[2], il[2], rr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + row0 + g + 8 * hh;
    row_stats(stats, r_g, (size_t)bh * S + i, i < S, m[hh], il[hh], rr[hh]);
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }

  for (int t = 0; t < k_tiles; ++t) {
    __syncthreads();   // every warp done with tile t - 1's terms
    split_rows<DP, NB, true>(k_s, KT, k + base, t * NB, S, D, vec, 1.0f);
    split_rows<DP, NB, false>(v_s, KT, v + base, t * NB, S, D, vec, 1.0f);
    for (int j = threadIdx.x; j < NB; j += kTileThreads) {
      bias_s[j] = t * NB + j < S ? bias_b[t * NB + j] : -INFINITY;
    }
    wg::fence_proxy_async();
    __syncthreads();   // the terms are in
    float s[N8][4], s_hh[N8][4], dp[N8][4];
    wg::fence();
    wg::issue_scores<NB, DP>(s_hh, s, q_s, QT, k_s, KT);
    wg::issue_terms_abt<NB, DP>(dp, do_s, QT, v_s, KT);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(s);
    wg::fence_operand(s_hh);
    wg::fence_operand(dp);
    wg::sum_scores(s, s_hh);
    add_bias<N8>(s, bias_s, t2);
    ds_of_f32<N8>(s, dp, m, il, rr, keep, q0 + row0 + g, t * NB + t2, keep_scale);
    uint32_t a[3][NB / 16][4];
    mmda::short_mma::split_operand<NB / 16>(a, s);
    tile_product<DP, NB>(acc, a, k_s, KT);
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= scale;
  }
  store_rows_f32<DP>(dq + base, acc, q0 + row0, S, D, lane);
}

template <int DP>
__global__ void __launch_bounds__(kTileThreads, DP == 64 ? 3 : 1)
tiled_dkv_f32_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           const int* __restrict__ seed_ptr, const float* __restrict__ d_out,
                           const float* __restrict__ stats, const float* __restrict__ r_g,
                           float* __restrict__ dk, float* __restrict__ dv, int nh, int S, int D,
                           int k_tiles, float scale, float rate, float keep_scale, int vec) {
  namespace wg = mmda::wgmma;
  constexpr int NB = kF32StreamRows, N8 = NB / 8;
  constexpr int KT = kTileRows * DP, QT = NB * DP;   // elements of a term tile
  extern __shared__ unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(wg::align_smem(smem_raw));   // 3 x (64, DP)
  bf16* v_s = k_s + 3 * KT;                          // 3 x (64, DP)
  bf16* q_s = v_s + 3 * KT;                          // 3 x (NB, DP) q * scale
  bf16* do_s = q_s + 3 * QT;                         // 3 x (NB, DP)
  float* st_s = reinterpret_cast<float*>(do_s + 3 * QT);   // (NB, 3): m, 1 / l, r

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x - bh * k_tiles) * kTileRows;
  const int b = bh / nh;
  const int h = bh - b * nh;
  const size_t base = (size_t)bh * S * D;
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int q_tiles = (S + NB - 1) / NB;
  const KeepMask keep(seed_ptr, b, h, S, rate);
  float kb[2];      // the bias of the warp's keys k0 + row0 + g (+ 8); -inf beyond S
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int jk = k0 + row0 + g + 8 * hh;
    kb[hh] = jk < S ? bias[(size_t)b * S + jk] : -INFINITY;
  }

  split_rows<DP, kTileRows, true>(k_s, KT, k + base, k0, S, D, vec, 1.0f);
  split_rows<DP, kTileRows, false>(v_s, KT, v + base, k0, S, D, vec, 1.0f);
  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.0f;
  }

  for (int t = 0; t < q_tiles; ++t) {
    __syncthreads();   // every warp done with tile t - 1's terms
    split_rows<DP, NB, true>(q_s, QT, q + base, t * NB, S, D, vec, scale);
    split_rows<DP, NB, false>(do_s, QT, d_out + base, t * NB, S, D, vec, 1.0f);
    for (int e = threadIdx.x; e < NB; e += kTileThreads) {
      const int i = t * NB + e;
      row_stats(stats, r_g, (size_t)bh * S + i, i < S, st_s[3 * e], st_s[3 * e + 1],
                st_s[3 * e + 2]);
    }
    wg::fence_proxy_async();
    __syncthreads();   // the terms are in
    // [j][e]: key k0 + row0 + g + 8 (e / 2), query t NB + 8 j + t2 + e % 2
    float sT[N8][4], s_hh[N8][4], dpT[N8][4];
    wg::fence();
    wg::issue_scores<NB, DP, true>(s_hh, sT, k_s, KT, q_s, QT);
    wg::issue_terms_abt<NB, DP, true>(dpT, v_s, KT, do_s, QT);
    wg::commit();
    wg::wait_all();
    wg::fence_operand(sT);
    wg::fence_operand(s_hh);
    wg::fence_operand(dpT);
    wg::sum_scores(sT, s_hh);
    pd_ds_of_f32<N8>(sT, dpT, st_s, kb, keep, t * NB, t2, k0 + row0 + g, S, keep_scale);
    uint32_t a[3][NB / 16][4];
    mmda::short_mma::split_operand<NB / 16>(a, sT);
    tile_product<DP, NB>(acc_v, a, do_s, QT);
    mmda::short_mma::split_operand<NB / 16>(a, dpT);
    tile_product<DP, NB>(acc_k, a, q_s, QT);
  }
  store_rows_f32<DP>(dv + base, acc_v, k0 + row0, S, D, lane);
  store_rows_f32<DP>(dk + base, acc_k, k0 + row0, S, D, lane);
}

template <int DP>
cudaError_t launch_f32_wgmma(const void* q, const void* k, const void* v, const float* bias,
                             const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                             const float* stats, const float* r, int BH, int nh, int S, int D,
                             float scale, float rate, float keep_scale, cudaStream_t stream) {
  constexpr size_t bytes = f32_wgmma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(tiled_dq_f32_wgmma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_dkv_f32_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  const int vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(d_out);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(d_out);
  tiled_dq_f32_wgmma_kernel<DP><<<BH * tiles, kTileThreads, bytes, stream>>>(
      fq, fk, fv, bias, seed, fdo, stats, r, static_cast<float*>(dq), nh, S, D, tiles, scale,
      rate, keep_scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_dkv_f32_wgmma_kernel<DP><<<BH * tiles, kTileThreads, bytes, stream>>>(
      fq, fk, fv, bias, seed, fdo, stats, r, static_cast<float*>(dk), static_cast<float*>(dv), nh,
      S, D, tiles, scale, rate, keep_scale, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the r kernel, the dq kernel, then the dk/dv kernel, on `stream`;
// returns the first nonzero cudaError as an int (0 = ok).  q, k, v, d_out,
// dq, dk, dv (B, nh, S, D): bf16 when is_bf16 else f32, contiguous; S >= 1,
// 1 <= D <= 128, B nh ceil(S / 32) < 2^31.  stats (B nh S x 2 f32) and o32
// ((B, nh, S, D) f32) as the training forward wrote them; r: (B nh S) f32
// scratch the caller allocates.  impl, scale, rate and keep_scale as for
// mmda_short_attn_tiled_fwd; seed (device int32) is read only when rate > 0.
int mmda_short_attn_tiled_bwd(const void* q, const void* k, const void* v, const float* bias,
                              const int* seed, const void* d_out, void* dq, void* dk, void* dv,
                              const float* stats, const float* o32, float* r, int B, int nh,
                              int S, int D, int is_bf16, int impl, float scale, float rate,
                              float keep_scale, void* stream) {
  if (B < 1 || nh < 1 || S < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * nh;
  const size_t n = (size_t)BH * S;
  cudaError_t err = is_bf16 ? launch_r<bf16>(d_out, o32, r, n, D, st)
                            : launch_r<float>(d_out, o32, r, n, D, st);
  if (err != cudaSuccess) return (int)err;
  if (!is_bf16) {
    if (impl == 1) {
      return (int)launch_f32(q, k, v, bias, seed, d_out, dq, dk, dv, stats, r, BH, nh, S, D,
                             scale, rate, keep_scale, st);
    }
    if (D <= 64) {
      return (int)launch_f32_wgmma<64>(q, k, v, bias, seed, d_out, dq, dk, dv, stats, r, BH, nh,
                                       S, D, scale, rate, keep_scale, st);
    }
    return (int)launch_f32_wgmma<128>(q, k, v, bias, seed, d_out, dq, dk, dv, stats, r, BH, nh,
                                      S, D, scale, rate, keep_scale, st);
  }
  if (impl != 1 && D > 32 && mmda::wgmma::takes(q, D) && mmda::wgmma::takes(k, D) &&
      mmda::wgmma::takes(v, D) && mmda::wgmma::takes(d_out, D)) {
    if (D <= 64) {
      return (int)launch_wgmma<64>(q, k, v, bias, seed, d_out, dq, dk, dv, stats, r, BH, nh, S,
                                   D, scale, rate, keep_scale, st);
    }
    return (int)launch_wgmma<128>(q, k, v, bias, seed, d_out, dq, dk, dv, stats, r, BH, nh, S, D,
                                  scale, rate, keep_scale, st);
  }
#define MMDA_TILED_BWD(DP)                                                                  \
  return (int)launch_mma<DP>(q, k, v, bias, seed, d_out, dq, dk, dv, stats, r, BH, nh, S, D, \
                             scale, rate, keep_scale, st)
  if (D <= 16) MMDA_TILED_BWD(16);
  if (D <= 32) MMDA_TILED_BWD(32);
  if (D <= 64) MMDA_TILED_BWD(64);
  MMDA_TILED_BWD(128);
#undef MMDA_TILED_BWD
}

}  // extern "C"
