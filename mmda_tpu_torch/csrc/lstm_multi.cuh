// What lstm_multi_fwd.cu and lstm_multi_bwd.cu share: where each direction's
// rows run in a launch of a serial pass, checked on the host and found on
// the device, and the launch's occupancy for the caller's report.
//
// A launch of a serial pass is one grid of blocks of up to kMultiThreads
// threads.  Direction d's rows run as one group of threads in each of the
// blocks block0 .. block0 + blocks - 1 (rows a block, so blocks = ceil(B /
// rows)), threads thread0 .. thread0 + threads - 1 of the block, whole
// warps, with `units` hidden units a quad.  Two directions may share blocks
// where their threads do not overlap: then each group synchronises its own
// warps on barrier 1 + d (NamedSync) and keeps its own shared memory, from
// float smem0 of the block's on.  The caller (lstm_multi.py's `geometry`)
// chooses the plan; the host code here refuses one that does not fit.

#pragma once

#include "lstm_passes.cuh"

namespace {

constexpr int kMaxDirs = 8;
constexpr int kMultiThreads = 480;   // a block's threads at most
// A serial pass is built twice: bounded at kLeanThreads, the registers of
// lstm_fwd.cu's and lstm_bwd.cu's widest instantiation (no spills), for
// launches whose blocks fit; and at kMultiThreads, where the cap of 128
// registers spills a few values, for blocks that hold two directions.
constexpr int kLeanThreads = 384;
constexpr int kPlanInts = 5;         // rows, units, block0, thread0, threads

struct Group {
  int rows, units, block0, blocks, thread0, threads, smem0;
};

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// The groups of D directions from the caller's plan (kPlanInts ints a
// direction), their shared memory offsets (smem_floats(H, rows, groups,
// units): floats of one direction's pass), and the launch's grid, threads and
// dynamic shared memory in bytes.  Returns false where the plan does not fit.
template <class SmemFloats>
bool make_groups(const int* H, const int* plan, int D, int B, SmemFloats smem_floats,
                 Group* groups, int* grid, int* threads, size_t* smem_bytes) {
  if (D < 1 || D > kMaxDirs || B < 1) return false;
  int sizes[kMaxDirs];
  *grid = *threads = 0;
  for (int d = 0; d < D; ++d) {
    Group& g = groups[d];
    g.rows = plan[kPlanInts * d];
    g.units = plan[kPlanInts * d + 1];
    g.block0 = plan[kPlanInts * d + 2];
    g.thread0 = plan[kPlanInts * d + 3];
    g.threads = plan[kPlanInts * d + 4];
    if (H[d] < 1 || g.rows < 1 || g.units < 1 || g.units > kMaxUnits || g.block0 < 0 ||
        g.thread0 < 0 || (lstm_nc(H[d]) > 0 && g.units != 1)) {
      return false;
    }
    const int quads = (H[d] + g.units - 1) / g.units;
    if (g.threads < g.rows * 4 * quads || g.threads % 32 || g.thread0 % 32 ||
        g.thread0 + g.threads > kMultiThreads) {
      return false;
    }
    g.blocks = (B + g.rows - 1) / g.rows;
    sizes[d] = (smem_floats(H[d], g.rows, quads, g.units) + 3) / 4 * 4;   // float4-aligned
    *grid = imax(*grid, g.block0 + g.blocks);
    *threads = imax(*threads, g.thread0 + g.threads);
  }
  // groups that share blocks: threads apart, and shared memory after that of
  // every such group with lower threads
  int block_floats = 0;
  for (int d = 0; d < D; ++d) groups[d].smem0 = -1;
  for (int placed = 0; placed < D; ++placed) {
    int d = -1;   // the unplaced group with the lowest thread0
    for (int e = 0; e < D; ++e) {
      if (groups[e].smem0 < 0 && (d < 0 || groups[e].thread0 < groups[d].thread0)) d = e;
    }
    Group& g = groups[d];
    int at = 0;
    for (int e = 0; e < D; ++e) {
      const Group& o = groups[e];
      if (e == d || o.block0 >= g.block0 + g.blocks || g.block0 >= o.block0 + o.blocks) continue;
      if (o.thread0 < g.thread0 + g.threads && g.thread0 < o.thread0 + o.threads) return false;
      if (o.smem0 >= 0) at = imax(at, o.smem0 + sizes[e]);
    }
    g.smem0 = at;
    block_floats = imax(block_floats, at + sizes[d]);
  }
  *smem_bytes = (size_t)block_floats * sizeof(float);
  return true;
}

// Direction d whose group holds this thread of this block, or -1.
__device__ __forceinline__ int find_group(const Group* groups, int D) {
  for (int d = 0; d < D; ++d) {
    const Group& g = groups[d];
    if ((int)blockIdx.x >= g.block0 && (int)blockIdx.x < g.block0 + g.blocks &&
        (int)threadIdx.x >= g.thread0 && (int)threadIdx.x < g.thread0 + g.threads) {
      return d;
    }
  }
  return -1;
}

// out: registers a thread, local memory bytes a thread (stack and spills),
// blocks, threads a block, dynamic shared memory bytes, resident blocks an SM.
template <class Kernel>
int occupancy(Kernel kernel, int grid, int threads, size_t smem_bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = grid;
  out[3] = threads;
  out[4] = (int)smem_bytes;
  out[5] = resident;
  return 0;
}

}  // namespace
