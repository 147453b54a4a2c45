// Block-level scan helpers shared by the two-phase scan kernels.
//
// A TPU kernel carries its scan state across a SEQUENTIAL grid in SMEM.
// On Hopper blocks run in parallel and in no order, so each scan here is
// two-phase:
//   (a) every block reduces its tile to one summary (tile_sums);
//   (b) one block turns the tile summaries into exclusive prefixes
//       (scan_tiles);
//   (c) every block rescans its tile seeded with its prefix and writes
//       the outputs.
// An "Op" is a monoid object: `T` (a plain struct), `identity()`,
// `combine(left, right)` (left happens first) and a static
// `shfl_up(x, offset)` that moves a whole T across a warp.  The monoids
// used here (uint32 affine maps with wraparound, int32 max/min/add, the
// segmented combine over those) are associative in machine arithmetic,
// so any association order gives the sequential scan's bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mr {

constexpr unsigned kFull = 0xffffffffu;
// threads per tile block and items per thread: a tile is 2048 elements
constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
// threads of the single block that scans the tile summaries
constexpr int kScanThreads = 1024;

template <class Op>
__device__ typename Op::T warp_inclusive(const Op& op, typename Op::T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    typename Op::T y = Op::shfl_up(x, off);
    if (lane >= off) x = op.combine(y, x);
  }
  return x;
}

// Exclusive scan of one value per thread across the block (blockDim.x a
// multiple of 32).  `shared` holds 32 T.  Returns this thread's exclusive
// prefix; when `total` is non-null it receives the block aggregate.
template <class Op>
__device__ typename Op::T block_exclusive(const Op& op, typename Op::T x,
                                          typename Op::T* shared,
                                          typename Op::T* total) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T inc = warp_inclusive(op, x);
  if (lane == 31) shared[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? shared[lane] : op.identity();
    shared[lane] = warp_inclusive(op, w);
  }
  __syncthreads();
  T before = Op::shfl_up(inc, 1);
  if (lane == 0) before = op.identity();
  T excl = warp == 0 ? before : op.combine(shared[warp - 1], before);
  if (total != nullptr) *total = shared[nwarps - 1];
  __syncthreads();  // `shared` may be reused by the caller
  return excl;
}

// Phase (b): exclusive prefixes of `nt` tile summaries, in one block.
// Each thread folds a contiguous run of tiles, the block scans the
// per-thread folds, and each thread walks its run again writing prefixes.
template <class Op>
__device__ void scan_tiles(const Op& op, const typename Op::T* sums,
                           typename Op::T* prefix, int nt) {
  using T = typename Op::T;
  __shared__ T shared[32];
  const int per = (nt + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, nt);
  const int hi = min(lo + per, nt);
  T agg = op.identity();
  for (int t = lo; t < hi; ++t) agg = op.combine(agg, sums[t]);
  T run = block_exclusive(op, agg, shared, static_cast<T*>(nullptr));
  for (int t = lo; t < hi; ++t) {
    prefix[t] = run;
    run = op.combine(run, sums[t]);
  }
}

inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace mr
