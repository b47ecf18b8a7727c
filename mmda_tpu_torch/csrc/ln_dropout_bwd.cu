// Fused residual + dropout + LayerNorm backward for Hopper (sm_90a), plain C
// entry point.
//
// Replaces mmda_tpu/ops/pallas/layernorm.py::_bwd_kernel (:74, launched by
// _bwd_call :152).  Nothing but x, y, g and the seed was saved: per row it
// regenerates the keep mask (hash_dropout.cuh), recomputes z, mu, rstd and
// zhat = (z - mu) * rstd as ln_dropout_fwd.cu does, and then
//
//   dzhat = do * g
//   dz    = rstd * (dzhat - mean(dzhat) - zhat * mean(dzhat * zhat))
//   dx    = dz;   dy = dz * keep * (1 / (1 - rate))
//   dg    = sum over rows of do * zhat;   db = sum over rows of do
//
// x, y, do, dx, dy (N, H) in f32 or bf16, g, dg, db (H,) f32, arithmetic f32.
// The mask's rows are placed by the forward's RowLayout (ln_dropout.cuh).
//
// What bounds it on the H100: bytes.  Five passes over N * H elements (x, y,
// do read, dx, dy written): 24.6 MB in bf16 at N=3200, H=768, 7.3 us at
// 3.35 TB/s.  To stream at that rate an SM must keep some 20-30 KB of loads
// in flight (Little's law at about 1 us of DRAM latency).
//
// What the design does about it.
//   * One warp per row, kWarps rows of a block at once, the block walking
//     over rows (the caller sizes the grid to the blocks the SMs hold at
//     once).  A lane holds its NCH chunks of V columns of the row in
//     registers, as loaded (Raw: 12 registers per tensor at H = 768 in
//     bf16), and the next row's x, y and do are loaded, into a second set of
//     registers, before the current row's first reduction: a warp keeps up
//     to two rows (9.2 KB in bf16) in flight, 16 warps an SM (two blocks of
//     8 in bf16) up to 147 KB.
//   * No pass over shared memory for the row: z, then zhat, and dzhat stay
//     in registers; do is read once; the hash is computed once per element
//     and its keep bits kept in a register for the dy pass.
//   * The row pass issues about as many instructions as the bytes take to
//     stream, so it carries no branch per column: the columns of the last
//     chunks past H are zeros that add nothing (g and the dg, db rows in
//     shared memory are padded to the chunks' width), and only the stores
//     are guarded.
//   * g sits in shared memory once per block.  A lane adds each of its rows'
//     do * zhat and do to its own columns of its warp's dg and db rows in
//     shared memory; at the end the block adds its warps' rows in order and
//     writes one (2, H) f32 partial.  ln_dropout_dgb_sum_kernel then adds the
//     partials per column over 2H / 32 blocks: warp w of a block sums
//     partials w, w + 8, ... of 32 columns, and the block adds its 8 warps'
//     sums in order.  Deterministic, no atomics.
// The TPU kernel instead carries dg and db across a grid that runs in order.
//
// Rows wider than 1024 (the widest a warp's registers hold; the forward takes
// up to 14,528) go to ln_dropout_bwd_wide_kernel: a block of 256 threads per
// row, the block walking over rows.  A thread owns the same V-column chunks
// of every row: it stages the row's z (then zhat) in shared memory and adds
// its columns' do * zhat and do to the block's dg and db rows there; the row
// sums are block reductions (warp sums, then the 8 warps' in order).  Shared
// memory: z, dg and db, 12 H bytes (174 KB at H = 14,528).  The block writes
// its (2, H) partial and ln_dropout_dgb_sum_kernel adds them as above.  The
// same hash; no atomics.

#include "hash_dropout.cuh"
#include "ln_dropout.cuh"

namespace {

constexpr int kWarps = 8;          // rows a block holds at once, one per warp
constexpr int kSumWarps = 8;       // ln_dropout_dgb_sum_kernel: partial runs per column
constexpr int kSumLoads = 36;      // partials a thread of it loads before adding them
constexpr int kWarpMaxH = 1024;    // the widest row ln_dropout_bwd_kernel holds in a warp
constexpr int kWideMaxH = 14528;   // the widest the forward takes (4 rows of f32 in 227 KB)

// Blocks an SM holds at once: two of kWarps warps where a lane's registers
// fit 128 (bf16 with V = 4), else one.
template <typename T, int V>
constexpr int min_blocks() {
  return sizeof(T) == 2 && V == 4 ? 2 : 1;
}

template <typename T, int V, int NCH>
__global__ void __launch_bounds__(32 * kWarps, (min_blocks<T, V>()))
ln_dropout_bwd_kernel(const T* __restrict__ x,      // (N, H)
                      const T* __restrict__ y,      // (N, H)
                      const float* __restrict__ g,  // (H,)
                      const T* __restrict__ dout,   // (N, H)
                      const int* __restrict__ seed_ptr,
                      T* __restrict__ dx,           // (N, H)
                      T* __restrict__ dy,           // (N, H)
                      float* __restrict__ partial,  // (blocks, 2, H)
                      int N, int H, mmda::RowLayout layout, float rate, float scale,
                      float eps) {
  using R = mmda::Raw<T, V>;
  constexpr int HW = NCH * 32 * V;                 // the columns a warp's lanes own
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* g_s = smem;                               // (HW,), then (kWarps, 2, HW):
  float* dg_s = smem + (1 + 2 * warp) * HW;        // this warp's sums
  float* db_s = dg_s + HW;
  const uint32_t seed = rate > 0.0f ? (uint32_t)seed_ptr[0] : 0u;

  // Columns H .. HW - 1 hold zeros (x, y, do, g): they add nothing to a sum
  // and need no branch.  Every column of a warp's rows is owned by one lane:
  // zeroed and added to by it alone, so only g and the block's final sum
  // need a barrier.
  for (int c = threadIdx.x; c < HW; c += blockDim.x) g_s[c] = c < H ? g[c] : 0.0f;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const float zero[V] = {};
    mmda::store_vec<V>(dg_s + (k * 32 + lane) * V, zero);
    mmda::store_vec<V>(db_s + (k * 32 + lane) * V, zero);
  }
  __syncthreads();

  // a row's x, y and do as this lane loads them, zero past H or N
  auto load_row = [&](int row, R (&rx)[NCH], R (&ry)[NCH], R (&rd)[NCH]) {
    const size_t base = (size_t)row * H;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = (k * 32 + lane) * V;
      rx[k] = ry[k] = rd[k] = R{};
      if (row < N && c < H) {
        rx[k] = mmda::load_raw<T, V>(x + base + c);
        ry[k] = mmda::load_raw<T, V>(y + base + c);
        rd[k] = mmda::load_raw<T, V>(dout + base + c);
      }
    }
  };

  // one row: dx, dy, and its terms added to this warp's dg and db
  auto process = [&](int row, const R (&rx)[NCH], const R (&ry)[NCH], const R (&rd)[NCH]) {
    // z = x + dropout(y), the keep bits, the mean
    float z[NCH][V];
    uint32_t keep = 0u;
    float sum = 0.0f;
    const uint32_t hrow = mmda::hash_row(row, layout);
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = (k * 32 + lane) * V;
      float xv[V], yv[V];
      mmda::raw_to_float<T, V>(rx[k], xv);
      mmda::raw_to_float<T, V>(ry[k], yv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const bool kept = mmda::hash_keep(seed, hrow, (uint32_t)(c + i), rate);
        keep |= (uint32_t)kept << (k * V + i);
        z[k][i] = xv[i] + (kept ? yv[i] * scale : 0.0f);   // 0 past H
        sum += z[k][i];
      }
    }
    const float mu = mmda::warp_sum(sum) / (float)H;
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const bool ok = (k * 32 + lane) * V < H;   // V = 4 only where H % 4 == 0
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = z[k][i] - mu;
        sq += ok ? d * d : 0.0f;
      }
    }
    const float rstd = rsqrtf(mmda::warp_sum(sq) / (float)H + eps);

    // zhat over z, dzhat = do * g, the two row sums, this warp's dg and db
    float dzh[NCH][V];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = (k * 32 + lane) * V;
      float dv[V], gv[V], dgv[V], dbv[V];
      mmda::raw_to_float<T, V>(rd[k], dv);
      mmda::load_vec<V>(g_s + c, gv);
      mmda::load_vec<V>(dg_s + c, dgv);
      mmda::load_vec<V>(db_s + c, dbv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float zhat = (z[k][i] - mu) * rstd;
        z[k][i] = zhat;
        dzh[k][i] = dv[i] * gv[i];
        s1 += dzh[k][i];
        s2 += dzh[k][i] * zhat;
        dgv[i] += dv[i] * zhat;
        dbv[i] += dv[i];
      }
      mmda::store_vec<V>(dg_s + c, dgv);
      mmda::store_vec<V>(db_s + c, dbv);
    }
    const float m1 = mmda::warp_sum(s1) / (float)H;
    const float m2 = mmda::warp_sum(s2) / (float)H;

    const size_t base = (size_t)row * H;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = (k * 32 + lane) * V;
      float dxv[V], dyv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float dz = rstd * (dzh[k][i] - m1 - z[k][i] * m2);
        dxv[i] = dz;
        dyv[i] = (keep >> (k * V + i)) & 1u ? dz * scale : 0.0f;
      }
      if (c < H) {
        mmda::store_vec<V>(dx + base + c, dxv);
        mmda::store_vec<V>(dy + base + c, dyv);
      }
    }
  };

  // rows block * kWarps + warp + k * stride, two buffers in turn: the next
  // row's loads are in flight while this one is processed
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  R ax[NCH], ay[NCH], ad[NCH], bx[NCH], by[NCH], bd[NCH];
  load_row(row, ax, ay, ad);
  while (row < N) {
    load_row(row + stride, bx, by, bd);
    process(row, ax, ay, ad);
    row += stride;
    if (row >= N) break;
    load_row(row + stride, ax, ay, ad);
    process(row, bx, by, bd);
    row += stride;
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * 2 * H;
  for (int c = threadIdx.x; c < 2 * H; c += blockDim.x) {
    const int col = c < H ? c : HW + c - H;   // warp w's dg, then its db
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[(1 + 2 * w) * HW + col];
    out[c] = s;
  }
}

constexpr int kWideWarps = 8;      // ln_dropout_bwd_wide_kernel: one row a block at a time

// The sum of v over the block's threads, the same value in each: the warps'
// sums added in order.  red holds kWideWarps floats; the block's threads all
// call it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5;
  v = mmda::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) total += red[w];
  __syncthreads();   // red is reused by the next call
  return total;
}

template <typename T, int V>
__global__ void __launch_bounds__(32 * kWideWarps)
ln_dropout_bwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ y,
                           const float* __restrict__ g, const T* __restrict__ dout,
                           const int* __restrict__ seed_ptr, T* __restrict__ dx,
                           T* __restrict__ dy, float* __restrict__ partial, int N, int H,
                           mmda::RowLayout layout, float rate, float scale, float eps) {
  constexpr int NT = 32 * kWideWarps;
  extern __shared__ __align__(16) float smem[];
  float* z_s = smem;           // (H,) z, then zhat, of the current row
  float* dg_s = z_s + H;       // (H,) the block's sums: column c added to by its owner alone
  float* db_s = dg_s + H;
  __shared__ float red[kWideWarps];
  const uint32_t seed = rate > 0.0f ? (uint32_t)seed_ptr[0] : 0u;
  const float inv_h = 1.0f / (float)H;
  for (int c = threadIdx.x * V; c < H; c += NT * V) {
    const float zero[V] = {};
    mmda::store_vec<V>(dg_s + c, zero);
    mmda::store_vec<V>(db_s + c, zero);
  }
  for (int row = blockIdx.x; row < N; row += gridDim.x) {
    const size_t base = (size_t)row * H;
    const uint32_t hrow = mmda::hash_row(row, layout);
    float sum = 0.0f;
    for (int c = threadIdx.x * V; c < H; c += NT * V) {
      float xv[V], yv[V], zv[V];
      mmda::load_vec<V>(x + base + c, xv);
      mmda::load_vec<V>(y + base + c, yv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const bool kept = mmda::hash_keep(seed, hrow, (uint32_t)(c + i), rate);
        zv[i] = xv[i] + (kept ? yv[i] * scale : 0.0f);
        sum += zv[i];
      }
      mmda::store_vec<V>(z_s + c, zv);
    }
    const float mu = block_sum(sum, red) * inv_h;
    float sq = 0.0f;
    for (int c = threadIdx.x * V; c < H; c += NT * V) {
      float zv[V];
      mmda::load_vec<V>(z_s + c, zv);
#pragma unroll
      for (int i = 0; i < V; ++i) sq += (zv[i] - mu) * (zv[i] - mu);
    }
    const float rstd = rsqrtf(block_sum(sq, red) * inv_h + eps);
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = threadIdx.x * V; c < H; c += NT * V) {
      float zv[V], dv[V], gv[V], dgv[V], dbv[V];
      mmda::load_vec<V>(z_s + c, zv);
      mmda::load_vec<V>(dout + base + c, dv);
      mmda::load_vec<V>(g + c, gv);
      mmda::load_vec<V>(dg_s + c, dgv);
      mmda::load_vec<V>(db_s + c, dbv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        zv[i] = (zv[i] - mu) * rstd;        // zhat
        const float dzh = dv[i] * gv[i];
        s1 += dzh;
        s2 += dzh * zv[i];
        dgv[i] += dv[i] * zv[i];
        dbv[i] += dv[i];
      }
      mmda::store_vec<V>(z_s + c, zv);
      mmda::store_vec<V>(dg_s + c, dgv);
      mmda::store_vec<V>(db_s + c, dbv);
    }
    const float m1 = block_sum(s1, red) * inv_h;
    const float m2 = block_sum(s2, red) * inv_h;
    for (int c = threadIdx.x * V; c < H; c += NT * V) {
      float zv[V], dv[V], gv[V], dxv[V], dyv[V];
      mmda::load_vec<V>(z_s + c, zv);
      mmda::load_vec<V>(dout + base + c, dv);
      mmda::load_vec<V>(g + c, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float dz = rstd * (dv[i] * gv[i] - m1 - zv[i] * m2);
        const bool kept = mmda::hash_keep(seed, hrow, (uint32_t)(c + i), rate);
        dxv[i] = dz;
        dyv[i] = kept ? dz * scale : 0.0f;
      }
      mmda::store_vec<V>(dx + base + c, dxv);
      mmda::store_vec<V>(dy + base + c, dyv);
    }
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * 2 * H;
  for (int c = threadIdx.x; c < H; c += NT) {
    out[c] = dg_s[c];
    out[H + c] = db_s[c];
  }
}

template <typename T, int V>
cudaError_t launch_wide(const void* x, const void* y, const float* g, const void* dout,
                        const int* seed, void* dx, void* dy, float* partial, int N, int H,
                        mmda::RowLayout layout, int blocks, float rate, float scale, float eps,
                        cudaStream_t stream) {
  const size_t smem_bytes = (size_t)3 * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_dropout_bwd_wide_kernel<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return err;
  ln_dropout_bwd_wide_kernel<T, V><<<blocks, 32 * kWideWarps, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), g, static_cast<const T*>(dout),
      seed, static_cast<T*>(dx), static_cast<T*>(dy), partial, N, H, layout, rate, scale,
      eps);
  return cudaGetLastError();
}

// dg, db = the blocks' partials added per column: block x takes columns
// 32 x .. 32 x + 31 of the (2, H) partials, warp w the partials w, w + 8,
// ... in order (all kSumLoads of a round loaded before the first add: one
// round up to 288 blocks), and the block adds its warps' sums in order.
__global__ void __launch_bounds__(32 * kSumWarps)
ln_dropout_dgb_sum_kernel(const float* __restrict__ partial,  // (blocks, 2, H)
                          float* __restrict__ dg, float* __restrict__ db,
                          int blocks, int H) {
  __shared__ float s_s[kSumWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * 32 + lane;   // (which, column)
  float s = 0.0f;
  for (int k0 = warp; k0 < blocks; k0 += kSumWarps * kSumLoads) {
    float v[kSumLoads];
#pragma unroll
    for (int l = 0; l < kSumLoads; ++l) {
      const int k = k0 + l * kSumWarps;
      v[l] = i < 2 * H && k < blocks ? partial[(size_t)k * 2 * H + i] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < kSumLoads; ++l) s += v[l];   // + 0 past the last block
  }
  s_s[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || i >= 2 * H) return;
  float total = s_s[0][lane];
#pragma unroll
  for (int w = 1; w < kSumWarps; ++w) total += s_s[w][lane];
  if (i < H) {
    dg[i] = total;
  } else {
    db[i - H] = total;
  }
}

template <typename T, int V, int NCH>
cudaError_t launch(const void* x, const void* y, const float* g, const void* dout,
                   const int* seed, void* dx, void* dy, float* partial, int N, int H,
                   mmda::RowLayout layout, int blocks, float rate, float scale, float eps,
                   cudaStream_t stream) {
  const size_t smem_bytes = (size_t)(1 + 2 * kWarps) * NCH * 32 * V * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_dropout_bwd_kernel<T, V, NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return err;
  ln_dropout_bwd_kernel<T, V, NCH><<<blocks, 32 * kWarps, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), g, static_cast<const T*>(dout),
      seed, static_cast<T*>(dx), static_cast<T*>(dy), partial, N, H, layout, rate, scale,
      eps);
  return cudaGetLastError();
}

// The rows pass for a row of H values, V at a time: NCH chunks of 32 V
// columns a warp, from the instantiations below (H <= 256, 768, 1024 for
// V = 4; 256, 1024 for V = 1); a block a row above 1024.
template <typename T, int V>
cudaError_t launch_rows(const void* x, const void* y, const float* g, const void* dout,
                        const int* seed, void* dx, void* dy, float* partial, int N, int H,
                        mmda::RowLayout layout, int blocks, float rate, float scale, float eps,
                        cudaStream_t st) {
  if (H > kWarpMaxH) {
    return launch_wide<T, V>(x, y, g, dout, seed, dx, dy, partial, N, H, layout, blocks,
                             rate, scale, eps, st);
  }
  const int need = (H + 32 * V - 1) / (32 * V);
  if constexpr (V == 4) {
    if (need <= 2) return launch<T, 4, 2>(x, y, g, dout, seed, dx, dy, partial, N, H,
                                          layout, blocks, rate, scale, eps, st);
    if (need <= 6) return launch<T, 4, 6>(x, y, g, dout, seed, dx, dy, partial, N, H,
                                          layout, blocks, rate, scale, eps, st);
    if (need <= 8) return launch<T, 4, 8>(x, y, g, dout, seed, dx, dy, partial, N, H,
                                          layout, blocks, rate, scale, eps, st);
  } else {
    if (need <= 8) return launch<T, 1, 8>(x, y, g, dout, seed, dx, dy, partial, N, H,
                                          layout, blocks, rate, scale, eps, st);
    if (need <= 32) return launch<T, 1, 32>(x, y, g, dout, seed, dx, dy, partial, N, H,
                                            layout, blocks, rate, scale, eps, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the two kernels on `stream` (the rows' pass, then the sum of its
// partials) and returns the first nonzero cudaError as an int (0 = ok).
// x, y, dout, dx, dy: bf16 when is_bf16 else f32.  vec is 4 (H % 4 == 0 and
// every pointer 16-byte aligned) or 1; 1 <= H <= 14528.  The caller allocates
// dx, dy, dg, db and the (blocks, 2, H) f32 scratch `partial`; blocks >= 1
// (the grid of the rows pass).  rate and scale = 1 / (1 - rate) already
// rounded to f32; seed (device int32) is read only when rate > 0.  The rows
// hash as the forward's RowLayout {s_local, s_total, s0} places them.
int mmda_ln_dropout_bwd(const void* x, const void* y, const float* g, const void* dout,
                        const int* seed, void* dx, void* dy, float* dg, float* db,
                        float* partial, int N, int H, int s_local, int s_total, int s0,
                        int is_bf16, int vec, int blocks, float rate, float scale, float eps,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((vec != 1 && vec != 4) || blocks < 1 || N < 1 || H < 1 || H > kWideMaxH ||
      s_local < 1 || N % s_local) {
    return (int)cudaErrorInvalidValue;
  }
  const mmda::RowLayout layout{s_local, s_total, s0};
  cudaError_t err;
  if (is_bf16) {
    err = vec == 4
        ? launch_rows<__nv_bfloat16, 4>(x, y, g, dout, seed, dx, dy, partial, N, H, layout,
                                        blocks, rate, scale, eps, st)
        : launch_rows<__nv_bfloat16, 1>(x, y, g, dout, seed, dx, dy, partial, N, H, layout,
                                        blocks, rate, scale, eps, st);
  } else {
    err = vec == 4
        ? launch_rows<float, 4>(x, y, g, dout, seed, dx, dy, partial, N, H, layout, blocks,
                                rate, scale, eps, st)
        : launch_rows<float, 1>(x, y, g, dout, seed, dx, dy, partial, N, H, layout, blocks,
                                rate, scale, eps, st);
  }
  if (err != cudaSuccess) return (int)err;
  ln_dropout_dgb_sum_kernel<<<(2 * H + 31) / 32, 32 * kSumWarps, 0, st>>>(partial, dg, db,
                                                                        blocks, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
