// Segmented reduce over sorted key lanes for Hopper (sm_90a).
//
// Replaces: mapreduce_tpu/ops/segscan.py:_segreduce_kernel (the Pallas
// TPU kernel behind sorted_unique_reduce(segment_impl='pallas')).
//
// Input: sorted key lanes k1, k2 [n] (uint32 bit patterns as int32; the
// sentinel pair (0xFFFFFFFF, 0xFFFFFFFF) marks invalid rows, which sort
// last) and D int32 value lanes [n, D].  For every row i it computes
//   reduced[i][d]  the run's inclusive combine under lane d's op (sum,
//                  min or max) from the run's head through row i — or,
//                  in unit mode, the run length so far (one lane);
//   end_csum[i]    the number of run ends at or before row i.
// Row i heads a run iff valid and (i == 0 or its key differs from row
// i-1's); it ends a run iff valid and (i == n-1 or row i+1 is invalid or
// its key differs).  Only reduced[] at run ends and end_csum are the
// result (the caller gathers run ends by searchsorted over end_csum).
//
// The TPU kernel walks a sequential grid and carries the last key, the
// running combine and the running end count across blocks in SMEM.  Here
// the carry is the segmented monoid (head, value) with
// (fl, vl) . (fr, vr) = (fl | fr, fr ? vr : op(vl, vr)) plus an int32 sum
// of run ends, scanned in two phases (scan.cuh); the neighbour keys that
// decide heads and ends are read from device memory directly.
//
// Bound on the card: memory.  Per row it reads 8 + 4*D bytes and writes
// 4*D + 4 (unit mode: 8 in, 8 out); a few integer ops per row and lane.
// Each thread walks 8 consecutive rows, and each tile is read twice
// (phases a and c; the second read mostly hits L2).  Wider loads and a
// one-pass decoupled look-back are left for a later change.
#include <climits>

#include "scan.cuh"

namespace mr_segreduce_kernels {

using mr::kItems;
using mr::kThreads;
using mr::kTile;

enum : int { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ int32_t apply_op(int op, int32_t a, int32_t b) {
  switch (op) {
    case kMin: return min(a, b);
    case kMax: return max(a, b);
    default:  // wraparound add, as int32 addition on the TPU
      return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                  static_cast<uint32_t>(b));
  }
}

__device__ __forceinline__ int32_t identity_of(int op) {
  return op == kMin ? INT_MAX : (op == kMax ? INT_MIN : 0);
}

template <int D>
struct SegOp {
  int ops[D];
  struct T {
    int32_t v[D];
    int32_t head;  // a run head lies in the span
    int32_t ends;  // run ends in the span
  };
  __device__ T identity() const {
    T t;
#pragma unroll
    for (int d = 0; d < D; ++d) t.v[d] = identity_of(ops[d]);
    t.head = 0;
    t.ends = 0;
    return t;
  }
  __device__ T combine(const T& x, const T& y) const {
    T o;
#pragma unroll
    for (int d = 0; d < D; ++d)
      o.v[d] = y.head ? y.v[d] : apply_op(ops[d], x.v[d], y.v[d]);
    o.head = x.head | y.head;
    o.ends = x.ends + y.ends;
    return o;
  }
  static __device__ T shfl_up(const T& x, int off) {
    T y;
#pragma unroll
    for (int d = 0; d < D; ++d)
      y.v[d] = __shfl_up_sync(mr::kFull, x.v[d], off);
    y.head = __shfl_up_sync(mr::kFull, x.head, off);
    y.ends = __shfl_up_sync(mr::kFull, x.ends, off);
    return y;
  }
};

struct Rows {
  const int32_t* k1;
  const int32_t* k2;
  const int32_t* vals;  // [n, D]; unused in unit mode
  int n;
};

__device__ __forceinline__ bool valid_at(const Rows& r, int i) {
  return !(r.k1[i] == -1 && r.k2[i] == -1);
}

// Row i as a one-element span: (head, value, end).
template <int D, bool UNIT>
__device__ __forceinline__ typename SegOp<D>::T row(const Rows& r, int i) {
  typename SegOp<D>::T e;
  const int32_t a1 = r.k1[i], a2 = r.k2[i];
  const bool valid = !(a1 == -1 && a2 == -1);
  const bool head = valid && (i == 0 || a1 != r.k1[i - 1] ||
                              a2 != r.k2[i - 1]);
  const bool end = valid && (i == r.n - 1 || !valid_at(r, i + 1) ||
                             a1 != r.k1[i + 1] || a2 != r.k2[i + 1]);
#pragma unroll
  for (int d = 0; d < D; ++d)
    e.v[d] = UNIT ? 1 : r.vals[static_cast<int64_t>(i) * D + d];
  e.head = head ? 1 : 0;
  e.ends = end ? 1 : 0;
  return e;
}

template <int D, bool UNIT>
__device__ typename SegOp<D>::T thread_fold(const SegOp<D>& op,
                                            const Rows& r, int base) {
  typename SegOp<D>::T agg = op.identity();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + j >= r.n) break;
    agg = op.combine(agg, row<D, UNIT>(r, base + j));
  }
  return agg;
}

// Phase (a): one summary per tile.
template <int D, bool UNIT>
__global__ void __launch_bounds__(kThreads)
    tile_sums(Rows r, SegOp<D> op, typename SegOp<D>::T* sums) {
  using T = typename SegOp<D>::T;
  __shared__ T shared[32];
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  T total;
  mr::block_exclusive(op, thread_fold<D, UNIT>(op, r, base), shared, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Phase (b).
template <int D>
__global__ void __launch_bounds__(mr::kScanThreads)
    scan_tile_sums(SegOp<D> op, const typename SegOp<D>::T* sums,
                   typename SegOp<D>::T* prefix, int nt) {
  mr::scan_tiles(op, sums, prefix, nt);
}

// Phase (c): rescan each tile from its prefix and write the outputs.
template <int D, bool UNIT>
__global__ void __launch_bounds__(kThreads)
    apply(Rows r, SegOp<D> op, const typename SegOp<D>::T* prefix,
          int32_t* reduced, int32_t* end_csum) {
  using T = typename SegOp<D>::T;
  __shared__ T shared[32];
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  const T excl = mr::block_exclusive(op, thread_fold<D, UNIT>(op, r, base),
                                     shared, static_cast<T*>(nullptr));
  T run = op.combine(prefix[blockIdx.x], excl);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i >= r.n) break;
    run = op.combine(run, row<D, UNIT>(r, i));
#pragma unroll
    for (int d = 0; d < D; ++d)
      reduced[static_cast<int64_t>(i) * D + d] = run.v[d];
    end_csum[i] = run.ends;
  }
}

template <int D>
size_t scratch_bytes(int n) {
  return 2 * static_cast<size_t>(mr::num_tiles(n)) *
         sizeof(typename SegOp<D>::T);
}

template <int D, bool UNIT>
int launch(const Rows& r, const int* ops, int32_t* reduced,
           int32_t* end_csum, void* scratch, cudaStream_t stream) {
  using T = typename SegOp<D>::T;
  SegOp<D> op;
  for (int d = 0; d < D; ++d) op.ops[d] = UNIT ? kSum : ops[d];
  const int nt = mr::num_tiles(r.n);
  T* sums = static_cast<T*>(scratch);
  T* prefix = sums + nt;
  tile_sums<D, UNIT><<<nt, kThreads, 0, stream>>>(r, op, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tile_sums<D><<<1, mr::kScanThreads, 0, stream>>>(op, sums, prefix, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  apply<D, UNIT><<<nt, kThreads, 0, stream>>>(r, op, prefix, reduced,
                                              end_csum);
  return cudaGetLastError();
}

}  // namespace mr_segreduce_kernels

using namespace mr_segreduce_kernels;

extern "C" {

// Bytes of device scratch mr_segreduce needs for n rows and d value lanes
// (0 for an unsupported lane count).
long long mr_segreduce_scratch_bytes(int n, int d) {
  switch (d) {
    case 1: return static_cast<long long>(scratch_bytes<1>(n));
    case 2: return static_cast<long long>(scratch_bytes<2>(n));
    case 3: return static_cast<long long>(scratch_bytes<3>(n));
    default: return 0;
  }
}

// Segmented reduce of n > 0 sorted rows.  unit != 0 counts run lengths
// into one lane (d must be 1, vals may be null); otherwise d value lanes
// in vals [n, d] are combined with op0..op2 (0 sum, 1 min, 2 max) per
// lane.  reduced is [n, d] int32, end_csum [n] int32.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for bad
// arguments).
int mr_segreduce(const void* k1, const void* k2, const void* vals, int n,
                 int d, int unit, int op0, int op1, int op2, void* reduced,
                 void* end_csum, void* scratch, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int ops[3] = {op0, op1, op2};
  for (int i = 0; i < d && i < 3; ++i)
    if (ops[i] < kSum || ops[i] > kMax) return cudaErrorInvalidValue;
  Rows r{static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),
         static_cast<const int32_t*>(vals), n};
  auto* red = static_cast<int32_t*>(reduced);
  auto* csum = static_cast<int32_t*>(end_csum);
  auto st = static_cast<cudaStream_t>(stream);
  if (unit) {
    if (d != 1) return cudaErrorInvalidValue;
    return launch<1, true>(r, ops, red, csum, scratch, st);
  }
  switch (d) {
    case 1: return launch<1, false>(r, ops, red, csum, scratch, st);
    case 2: return launch<2, false>(r, ops, red, csum, scratch, st);
    case 3: return launch<3, false>(r, ops, red, csum, scratch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
