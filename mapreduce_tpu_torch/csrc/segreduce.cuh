// The segmented-reduce kernel for Hopper (sm_90a), templated on its monoid.
//
// Replaces: mapreduce_tpu/ops/segscan.py:_segreduce_kernel (the Pallas
// TPU kernel behind sorted_unique_reduce(segment_impl='pallas')), which
// takes `op: Callable`, any traceable associative monoid, and traces it
// into its body.  Here the monoid is the kernel's Op class, and its
// value type Op::V is int32_t or float (the lanes' dtype, 4 B a lane):
//   - segreduce.cu instantiates it with SegOp<D, V>: one op code per
//     lane from {sum, min, max}, chosen at run time, with their
//     identities;
//   - a user's callable is lowered by ops/monoid.py into a C++ combine
//     (`MrUserCombine::apply<D>(a, b, o)` over MrUserCombine::T[D]),
//     which a generated source wraps in MonoidOp<F, D> below and builds
//     into a library of its own (ops/kernel_compat.py; entries
//     MR_MONOID_ENTRIES).
//
// Input: sorted key lanes k1, k2 [n] (uint32 bit patterns as int32; the
// sentinel pair (0xFFFFFFFF, 0xFFFFFFFF) marks invalid rows, which sort
// last) and D value lanes [n, D] of type V.  For every row i it computes
//   reduced[i][d]  the run's inclusive combine from the run's head
//                  through row i — or, in unit mode, the run length so
//                  far (one lane);
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
// combine(x, y) has x the earlier rows everywhere (the thread fold, the
// warp and block scans, the look-back), as the JAX ladder applies
// op(left, right): a monoid that does not commute gives its bits.  A
// float sum associates otherwise than the ladder (a fold of kItems rows,
// then a tree), so it rounds within gamma_n * sum|v| of the exact sum;
// float min and max, and every int32 op, give the ladder's bits.
//
// Bound on the card: memory.  Per row it reads 8 + 4*D bytes and writes
// 4*D + 4 (unit mode: 8 in, 8 out); a few integer ops per row and lane.
// The design:
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
// PERF.md §6 (rows 2 and 2b) has the tile A/B and the times.
#pragma once

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
// the most value lanes a monoid kernel takes: its staging at kTile 2,048
// is 82 KB (over the 48 KB a launch takes without asking, see
// mr::allow_smem), its element 11 words
constexpr int kMaxLanes = 8;

// either lane of the sentinel pair, as a uint32
constexpr uint32_t kSentinel = 0xffffffffu;

// A value lane's word in shared memory and back: the staging is bytes.
template <class V>
__device__ __forceinline__ V from_word(uint32_t w);
template <>
__device__ __forceinline__ int32_t from_word<int32_t>(uint32_t w) {
  return static_cast<int32_t>(w);
}
template <>
__device__ __forceinline__ float from_word<float>(uint32_t w) {
  return __uint_as_float(w);
}
__device__ __forceinline__ uint32_t to_word(int32_t v) {
  return static_cast<uint32_t>(v);
}
__device__ __forceinline__ uint32_t to_word(float v) {
  return __float_as_uint(v);
}

// -- the value ops the combines share (the codes and the lowered nodes) ------

// jnp.minimum / jnp.maximum of float32: NaN propagates, -0.0 < +0.0, so
// any association gives the same bits (fminf and fmaxf drop a NaN).
__device__ __forceinline__ float mr_fmin(float a, float b) {
  const bool take_a = a < b || (a == b && (__float_as_uint(a) >> 31)) ||
                      a != a;
  return take_a ? a : b;
}
__device__ __forceinline__ float mr_fmax(float a, float b) {
  const bool take_a = a > b || (a == b && !(__float_as_uint(a) >> 31)) ||
                      a != a;
  return take_a ? a : b;
}
// torch.abs of int32 (INT32_MIN stays INT32_MIN)
__device__ __forceinline__ int32_t mr_iabs(int32_t a) {
  return a < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(a)) : a;
}
// int32 division with XLA's rules, never a trap: lax.div truncates, x / 0
// is -1 and INT32_MIN / -1 wraps; lax.rem has the dividend's sign, x % 0
// is x
__device__ __forceinline__ int32_t mr_tdiv(int32_t a, int32_t b) {
  if (b == 0) return -1;
  if (b == -1) return static_cast<int32_t>(0u - static_cast<uint32_t>(a));
  return a / b;
}
__device__ __forceinline__ int32_t mr_trem(int32_t a, int32_t b) {
  if (b == 0) return a;
  if (b == -1) return 0;
  return a % b;
}
__device__ __forceinline__ int32_t mr_sign(int32_t a) {
  return (a > 0) - (a < 0);
}
// jnp.floor_divide: the quotient less one where the signs differ and
// the division is inexact (x // 0: -1 for 0, else -2)
__device__ __forceinline__ int32_t mr_floordiv(int32_t a, int32_t b) {
  const int32_t q = mr_tdiv(a, b);
  const bool down = mr_sign(a) != mr_sign(b) && mr_trem(a, b) != 0;
  return static_cast<int32_t>(static_cast<uint32_t>(q) - (down ? 1u : 0u));
}
// jnp.remainder: the divisor's sign, x % 0 is 0
__device__ __forceinline__ int32_t mr_mod(int32_t a, int32_t b) {
  if (b == 0) b = 1;
  const int32_t r = mr_trem(a, b);
  return r != 0 && mr_sign(r) != mr_sign(b)
             ? static_cast<int32_t>(static_cast<uint32_t>(r) +
                                    static_cast<uint32_t>(b))
             : r;
}
// jnp.fmod: the dividend's sign, fmod(x, 0) is 0
__device__ __forceinline__ int32_t mr_fmod(int32_t a, int32_t b) {
  return mr_trem(a, b == 0 ? 1 : b);
}

// A user monoid as the kernel's Op.  F::apply<D>(a, b, o) is the user's
// combine over F::T[D]; it declares no identity (min, bitwise_and and
// mul each have another, and a user's may have none: a Welford merge at
// count 0 divides by zero), so the element carries `empty`: identity()
// is empty, and combine returns the other side when one side is empty,
// never applying F to an empty span's zeros.  A zero-initialised T is a
// present row.
template <class F, int D_>
struct MonoidOp {
  static constexpr int D = D_;
  using V = typename F::T;
  static_assert(D >= 1 && D <= kMaxLanes, "1 to 8 value lanes");
  struct T {
    V v[D];
    int32_t empty;  // no row in the span
    int32_t head;   // a run head lies in the span
    int32_t ends;   // run ends in the span
  };
  __device__ T identity() const {
    T t;
#pragma unroll
    for (int d = 0; d < D; ++d) t.v[d] = V{};
    t.empty = 1;
    t.head = 0;
    t.ends = 0;
    return t;
  }
  __device__ T combine(const T& x, const T& y) const {
    V f[D];
    F::template apply<D>(x.v, y.v, f);
    // y's own value when a run starts in y or nothing precedes it; x's
    // when y is empty (then y.head is 0); else op(x, y)
    const bool take_y = y.head | x.empty;
    T o;
#pragma unroll
    for (int d = 0; d < D; ++d)
      o.v[d] = take_y ? y.v[d] : (y.empty ? x.v[d] : f[d]);
    o.empty = x.empty & y.empty;
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
    y.empty = __shfl_up_sync(mr::kFull, x.empty, off);
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

// One tile of kTile rows a CTA, in tile-id order from lb.counter.  Op:
// SegOp<D, V> (segreduce.cu) or MonoidOp<F, D>; its T holds v[Op::D] of
// Op::V, head and ends, and a zero-initialised T with those set is one
// row.
template <class Op, bool UNIT>
__global__ void __launch_bounds__(kThreads)
    segreduce_kernel(const int32_t* k1, const int32_t* k2,
                     const typename Op::V* vals, int n, Op op,
                     mr::LookBack<typename Op::T> lb, bool vec,
                     typename Op::V* reduced, int32_t* end_csum) {
  constexpr int D = Op::D;
  using T = typename Op::T;
  using V = typename Op::V;
  static_assert(sizeof(V) == 4, "a value lane is 4 B");
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
    T e{};
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if constexpr (UNIT)
        e.v[d] = 1;
      else
        e.v[d] = from_word<V>(vw[(j & 3) * D + d]);
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
        vw[k * D + d] = to_word(run.v[d]);
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

template <class Op>
size_t scratch_bytes(int n) {
  return mr::lookback_bytes<typename Op::T>(num_tiles(n));
}

template <class Op, bool UNIT>
int launch(const int32_t* k1, const int32_t* k2, const typename Op::V* vals,
           int n, const Op& op, typename Op::V* reduced, int32_t* end_csum,
           void* scratch, cudaStream_t stream) {
  using T = typename Op::T;
  const int tiles = num_tiles(n);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, mr::lookback_bytes<T>(tiles), stream);
  if (err != cudaSuccess) return err;
  constexpr int smem = stage_bytes<Op::D, UNIT>();
  static std::atomic<unsigned long long> smem_set{0};
  err = mr::allow_smem(segreduce_kernel<Op, UNIT>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(k1) && aligned16(k2) &&
                   (UNIT || aligned16(vals)) && aligned16(reduced) &&
                   aligned16(end_csum);
  segreduce_kernel<Op, UNIT><<<tiles, kThreads, smem, stream>>>(
      k1, k2, vals, n, op, mr::lookback_at<T>(scratch), vec, reduced,
      end_csum);
  return cudaGetLastError();
}

// -- a user monoid's entries --------------------------------------------------

// The lane counts a monoid library is built for: F::kLanes, or every
// count from 1 to kMaxLanes for a lane-wise F (kLanes 0).
template <class F, int D>
constexpr bool monoid_takes() {
  return F::kLanes == 0 ? (D >= 1 && D <= kMaxLanes) : D == F::kLanes;
}

template <class F, int D = 1>
long long monoid_scratch_bytes(int n, int d) {
  if constexpr (D > kMaxLanes) {
    return 0;
  } else {
    if constexpr (monoid_takes<F, D>()) {
      if (d == D)
        return static_cast<long long>(scratch_bytes<MonoidOp<F, D>>(n));
    }
    return monoid_scratch_bytes<F, D + 1>(n, d);
  }
}

template <class F, int D = 1>
int monoid_launch(const int32_t* k1, const int32_t* k2,
                  const typename F::T* vals, int n, int d,
                  typename F::T* reduced, int32_t* end_csum, void* scratch,
                  cudaStream_t stream) {
  if constexpr (D > kMaxLanes) {
    return cudaErrorInvalidValue;
  } else {
    if constexpr (monoid_takes<F, D>()) {
      if (d == D)
        return launch<MonoidOp<F, D>, false>(k1, k2, vals, n, {}, reduced,
                                             end_csum, scratch, stream);
    }
    return monoid_launch<F, D + 1>(k1, k2, vals, n, d, reduced, end_csum,
                                   scratch, stream);
  }
}

}  // namespace mr_segreduce_kernels

// The C entries of a monoid library, for the combine struct F: the same
// interface as segreduce.cu's mr_segreduce (unit must be 0; the op codes
// are unused: the monoid is F; vals and reduced are F::T), for the lane
// counts F takes.  F has
// internal linkage (an anonymous namespace), so the instantiations over
// it, launch's static flag among them, are this library's own.
#define MR_MONOID_ENTRIES(F)                                                 \
  extern "C" long long mr_segreduce_monoid_scratch_bytes(int n, int d) {    \
    return mr_segreduce_kernels::monoid_scratch_bytes<F>(n, d);             \
  }                                                                          \
  extern "C" int mr_segreduce_monoid(                                        \
      const void* k1, const void* k2, const void* vals, int n, int d,        \
      int unit, int, int, int, void* reduced, void* end_csum,               \
      void* scratch, void* stream) {                                         \
    if (n <= 0 || n >= (1 << 30) || unit != 0 || vals == nullptr)            \
      return cudaErrorInvalidValue;                                          \
    return mr_segreduce_kernels::monoid_launch<F>(                           \
        static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),    \
        static_cast<const F::T*>(vals), n, d, static_cast<F::T*>(reduced),   \
        static_cast<int32_t*>(end_csum),                                     \
        scratch, static_cast<cudaStream_t>(stream));                         \
  }
