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
// of run ends, scanned in one pass with a decoupled look-back (scan.cuh).
//
// Bound on the card: memory.  Per row it reads 8 + 4*D bytes and writes
// 4*D + 4 (unit mode: 8 in, 8 out); a few integer ops per row and lane.
// At the path's sizes (up to 1.6M rows) the data fits in L2 and the
// tiles run in one wave, so launches and each CTA's chain of dependent
// phases, not bytes, set the pace.  The design:
//   - one launch a call (plus the memset of the look-back records inside
//     the C entry, so a CUDA-graph replay starts clean), in place of
//     tile sums, a one-block scan of them and a second read of the tile;
//   - each CTA takes its tile id from an atomic counter and copies its
//     k1, k2 (each with one halo row on each side) and values into
//     shared memory with 16-byte cp.async copies; heads and ends are
//     decided there, so each key is read once, not three times (rows past
//     n and the row before row 0 read as the sentinel: a valid row next
//     to one heads or ends its run);
//   - each thread folds kItems consecutive rows, 4 at a time, the block
//     scans the folds and the tile's carry comes by decoupled look-back
//     (scan.cuh).  The end count is a true sum, so the walk runs to the
//     nearest inclusive prefix; when all tiles start together that takes
//     a few steps of 32 records, one L2 trip each;
//   - reduced and end_csum are staged in shared memory over the tile's
//     inputs and stored with 16-byte stores, neighbouring threads on
//     neighbouring addresses.
// PERF.md (PR 7) has the tile A/B and where the time goes.
#include <climits>

#include "scan.cuh"

#ifndef MR_SEGREDUCE_TILE
#define MR_SEGREDUCE_TILE 2048
#endif

namespace mr_segreduce_kernels {

constexpr int kThreads = 256;
constexpr int kTile = MR_SEGREDUCE_TILE;  // rows a CTA
constexpr int kItems = kTile / kThreads;   // consecutive rows a thread
static_assert(kTile % kThreads == 0 && kItems % 4 == 0 && kItems <= 32,
              "a tile is 1,024 to 8,192 rows");
// words of shared memory before and after each key lane's tile (the row
// on each side of the tile is the nearest one)
constexpr int kHalo = 4;

enum : int { kSum = 0, kMin = 1, kMax = 2 };
// either lane of the sentinel pair, as a uint32
constexpr uint32_t kSentinel = 0xffffffffu;

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
  // the end count is a sum: nothing before a span is ever dropped
  __device__ bool absorbing(const T&) const { return false; }
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

// Dynamic shared memory: k1 and k2 [kHalo + kTile + kHalo] int32 each,
// then (not in unit mode) the values [kTile][D].  The outputs are staged
// over them: end_csum over k1, reduced over the values (unit mode: k2).
template <int D, bool UNIT>
constexpr int stage_bytes() {
  return 4 * (2 * (kHalo + kTile + kHalo) + (UNIT ? 0 : kTile * D));
}

// One tile of kTile rows a CTA, in tile-id order from lb.counter.
template <int D, bool UNIT>
__global__ void __launch_bounds__(kThreads)
    segreduce_kernel(const int32_t* k1, const int32_t* k2,
                     const int32_t* vals, int n, SegOp<D> op,
                     mr::LookBack<typename SegOp<D>::T> lb, bool vec,
                     int32_t* reduced, int32_t* end_csum) {
  using T = typename SegOp<D>::T;
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* k1_s = reinterpret_cast<int32_t*>(smem) + kHalo;
  int32_t* k2_s = k1_s + kTile + 2 * kHalo;
  int32_t* v_s = k2_s + kTile + kHalo;
  __shared__ T scan[32];
  __shared__ T carry;
  __shared__ int tile_id;
  if (threadIdx.x == 0) tile_id = atomicAdd(lb.counter, 1);
  __syncthreads();
  const int tile = tile_id;
  const int base = tile * kTile;
  const int rows = min(n - base, kTile);
  const size_t at = static_cast<size_t>(base);
  // the tile's rows (the sentinel past n) and the row on each side
  mr::load_tile(reinterpret_cast<uint8_t*>(k1_s),
                reinterpret_cast<const uint8_t*>(k1 + at), rows * 4,
                kTile * 4, 0xff, vec);
  mr::load_tile(reinterpret_cast<uint8_t*>(k2_s),
                reinterpret_cast<const uint8_t*>(k2 + at), rows * 4,
                kTile * 4, 0xff, vec);
  if constexpr (!UNIT)
    mr::load_tile(reinterpret_cast<uint8_t*>(v_s),
                  reinterpret_cast<const uint8_t*>(vals + at * D),
                  rows * D * 4, kTile * D * 4, 0, vec);
  if (threadIdx.x == 0) {
    k1_s[-1] = base > 0 ? k1[base - 1] : -1;
    k2_s[-1] = base > 0 ? k2[base - 1] : -1;
  }
  if (threadIdx.x == kThreads - 1) {
    const bool more = kTile < n - base;
    k1_s[kTile] = more ? k1[base + kTile] : -1;
    k2_s[kTile] = more ? k2[base + kTile] : -1;
  }
  mr::load_wait();
  __syncthreads();

  // this thread's kItems rows, 4 at a time: heads and ends from the
  // neighbours' keys (a valid key never equals the sentinel pair, so a
  // differing key also covers an invalid neighbour), then their fold
  const int first = threadIdx.x * kItems;
  uint32_t heads = 0, ends = 0;
  uint32_t p1 = k1_s[first - 1], p2 = k2_s[first - 1];
#pragma unroll
  for (int g = 0; g < kItems; g += 4) {
    uint32_t a1[5], a2[5];
    mr::unstage_words<4>(a1, k1_s + first + g);
    mr::unstage_words<4>(a2, k2_s + first + g);
    a1[4] = k1_s[first + g + 4];
    a2[4] = k2_s[first + g + 4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool valid = !(a1[k] == kSentinel && a2[k] == kSentinel);
      if (valid && (a1[k] != p1 || a2[k] != p2)) heads |= 1u << (g + k);
      if (valid && (a1[k] != a1[k + 1] || a2[k] != a2[k + 1]))
        ends |= 1u << (g + k);
      p1 = a1[k];
      p2 = a2[k];
    }
  }
  // row j of the thread (its values vw, the 4 rows of its group)
  auto row = [&](int j, const uint32_t* vw) {
    T e;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if constexpr (UNIT)
        e.v[d] = 1;
      else
        e.v[d] = static_cast<int32_t>(vw[(j & 3) * D + d]);
    }
    e.head = (heads >> j) & 1u;
    e.ends = (ends >> j) & 1u;
    return e;
  };
  T agg = op.identity();
#pragma unroll
  for (int g = 0; g < kItems; g += 4) {
    uint32_t vw[4 * D];
    if constexpr (!UNIT) mr::unstage_words<4 * D>(vw, v_s + (first + g) * D);
#pragma unroll
    for (int k = 0; k < 4; ++k) agg = op.combine(agg, row(g + k, vw));
  }
  T total;
  const T excl = mr::block_exclusive(op, agg, scan, &total);
  if (threadIdx.x < 32) mr::tile_carry(op, lb, tile, total, &carry);
  __syncthreads();

  // rescan from the carry, 4 rows at a time, and stage the outputs over
  // the inputs: each thread overwrites only its own rows, read just before
  T run = op.combine(carry, excl);
  int32_t* red_s = UNIT ? k2_s : v_s;
#pragma unroll
  for (int g = 0; g < kItems; g += 4) {
    uint32_t vw[4 * D], cw[4];
    if constexpr (!UNIT) mr::unstage_words<4 * D>(vw, v_s + (first + g) * D);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run = op.combine(run, row(g + k, vw));
#pragma unroll
      for (int d = 0; d < D; ++d)
        vw[k * D + d] = static_cast<uint32_t>(run.v[d]);
      cw[k] = static_cast<uint32_t>(run.ends);
    }
    mr::stage_words<4>(k1_s + first + g, cw);
    mr::stage_words<4 * D>(red_s + (first + g) * D, vw);
  }
  __syncthreads();
  mr::store_tile(reinterpret_cast<uint8_t*>(end_csum + at),
                 reinterpret_cast<const uint8_t*>(k1_s), rows * 4, vec);
  mr::store_tile(reinterpret_cast<uint8_t*>(reduced + at * D),
                 reinterpret_cast<const uint8_t*>(red_s), rows * D * 4, vec);
}

inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int D>
size_t scratch_bytes(int n) {
  return mr::lookback_bytes<typename SegOp<D>::T>(num_tiles(n));
}

template <int D, bool UNIT>
int launch(const int32_t* k1, const int32_t* k2, const int32_t* vals, int n,
           const int* ops, int32_t* reduced, int32_t* end_csum,
           void* scratch, cudaStream_t stream) {
  using T = typename SegOp<D>::T;
  SegOp<D> op;
  for (int d = 0; d < D; ++d) op.ops[d] = UNIT ? kSum : ops[d];
  const int tiles = num_tiles(n);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, mr::lookback_bytes<T>(tiles), stream);
  if (err != cudaSuccess) return err;
  constexpr int smem = stage_bytes<D, UNIT>();
  static std::atomic<unsigned long long> smem_set{0};
  err = mr::allow_smem(segreduce_kernel<D, UNIT>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(k1) && aligned16(k2) &&
                   (UNIT || aligned16(vals)) && aligned16(reduced) &&
                   aligned16(end_csum);
  segreduce_kernel<D, UNIT><<<tiles, kThreads, smem, stream>>>(
      k1, k2, vals, n, op, mr::lookback_at<T>(scratch), vec, reduced,
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

// Segmented reduce of 0 < n < 2^30 sorted rows.  unit != 0 counts run
// lengths into one lane (d must be 1, vals may be null); otherwise d
// value lanes in vals [n, d] are combined with op0..op2 (0 sum, 1 min, 2
// max) per lane.  reduced is [n, d] int32, end_csum [n] int32; scratch
// holds mr_segreduce_scratch_bytes(n, d) bytes, and its flags are zeroed
// here.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for bad arguments).
int mr_segreduce(const void* k1, const void* k2, const void* vals, int n,
                 int d, int unit, int op0, int op1, int op2, void* reduced,
                 void* end_csum, void* scratch, void* stream) {
  if (n <= 0 || n >= (1 << 30)) return cudaErrorInvalidValue;
  const int ops[3] = {op0, op1, op2};
  for (int i = 0; i < d && i < 3; ++i)
    if (ops[i] < kSum || ops[i] > kMax) return cudaErrorInvalidValue;
  const auto* a = static_cast<const int32_t*>(k1);
  const auto* b = static_cast<const int32_t*>(k2);
  const auto* v = static_cast<const int32_t*>(vals);
  auto* red = static_cast<int32_t*>(reduced);
  auto* csum = static_cast<int32_t*>(end_csum);
  auto st = static_cast<cudaStream_t>(stream);
  if (unit) {
    if (d != 1) return cudaErrorInvalidValue;
    return launch<1, true>(a, b, v, n, ops, red, csum, scratch, st);
  }
  switch (d) {
    case 1: return launch<1, false>(a, b, v, n, ops, red, csum, scratch, st);
    case 2: return launch<2, false>(a, b, v, n, ops, red, csum, scratch, st);
    case 3: return launch<3, false>(a, b, v, n, ops, red, csum, scratch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
