// Block-level scan helpers and the single-pass decoupled look-back.
//
// A TPU kernel carries its scan state across a SEQUENTIAL grid in SMEM.
// On Hopper blocks run in parallel and in no order, so a scan over tiles
// is one pass with a decoupled look-back (Merrill and Garland, 2016):
//   - a CTA takes its tile id from an atomic counter in start order, so
//     the tiles it waits on are already running;
//   - it folds its tile, scans it in the block (block_exclusive) and
//     publishes the tile's aggregate in a status record;
//   - one warp walks back over the predecessors' records, 32 at a time,
//     folding aggregates until it meets an inclusive prefix;
//   - it publishes its own inclusive prefix, and the block applies the
//     carry to its tile.
// A tile whose aggregate absorbs everything before it (combine(x, a) == a
// for every x) publishes its aggregate as its inclusive prefix at once,
// so a successor's walk stops there; it still walks for its own carry.
//
// An "Op" is a monoid object: `T` (a plain struct), `identity()`,
// `combine(left, right)` (left happens first), `absorbing(t)` (true only
// when combine(x, t) == t for every x) and a static `shfl_up(x, offset)`
// that moves a whole T across a warp.  The monoids used here (uint32
// affine maps with wraparound, int32 max/min/add, the segmented combine
// over those) are associative in machine arithmetic, so any association
// order gives the sequential scan's bits.
//
// Status records: one a tile, each word of the value beside its status
// (LookBack), zeroed before the launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mr {

constexpr unsigned kFull = 0xffffffffu;

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device.  A launch takes up to 48 KB without asking; above that the
// attribute is set once a device (`done`: the caller's bit set of devices
// already set, one per kernel instantiation), not on every call.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem,
                       std::atomic<unsigned long long>& done) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

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

// -- decoupled look-back ------------------------------------------------------

enum : uint32_t { kEmpty = 0, kAggregate = 1, kInclusive = 2 };

// The status records of a launch, carved from one scratch buffer by
// lookback_bytes / lookback_at, all zeroed before each launch: the tile
// counter (its own 128 bytes), then one record a tile.  A record holds
// the words of a T, each in a 64-bit word beside its status (aggregate
// or inclusive prefix) in the high half, so one relaxed 64-bit load reads
// a word and whether it is there: a reader needs no fence and no second
// trip for the value.  The aggregate is written first and the inclusive
// prefix over it; a record whose words disagree is being written.
template <class T>
struct LookBack {
  static constexpr int kWords = sizeof(T) / 4;
  static_assert(sizeof(T) % 4 == 0, "a record is whole 32-bit words");
  int32_t* counter;
  uint64_t* records;  // [tiles][kWords]
};

constexpr size_t kCounterBytes = 128;

template <class T>
size_t lookback_bytes(int tiles) {
  return kCounterBytes + sizeof(uint64_t) * LookBack<T>::kWords * tiles;
}

template <class T>
LookBack<T> lookback_at(void* scratch) {
  auto* b = static_cast<uint8_t*>(scratch);
  return {reinterpret_cast<int32_t*>(b),
          reinterpret_cast<uint64_t*>(b + kCounterBytes)};
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Publish a tile's aggregate or inclusive prefix (one thread).
template <class T>
__device__ __forceinline__ void publish(const LookBack<T>& lb, int tile,
                                        const T& v, uint32_t status) {
  const auto* w = reinterpret_cast<const uint32_t*>(&v);
  uint64_t* r = lb.records + static_cast<size_t>(tile) * LookBack<T>::kWords;
#pragma unroll
  for (int i = 0; i < LookBack<T>::kWords; ++i)
    store_relaxed(r + i, static_cast<uint64_t>(status) << 32 | w[i]);
}

// Read a tile's record: its status (kEmpty while it is unwritten or being
// written) and, when there is one, its value.
template <class T>
__device__ __forceinline__ uint32_t read_record(const LookBack<T>& lb,
                                                int tile, T* v) {
  const uint64_t* r =
      lb.records + static_cast<size_t>(tile) * LookBack<T>::kWords;
  auto* w = reinterpret_cast<uint32_t*>(v);
  uint64_t x[LookBack<T>::kWords];
#pragma unroll
  for (int i = 0; i < LookBack<T>::kWords; ++i) x[i] = load_relaxed(r + i);
  const uint32_t status = static_cast<uint32_t>(x[0] >> 32);
  bool same = true;
#pragma unroll
  for (int i = 0; i < LookBack<T>::kWords; ++i) {
    same = same && static_cast<uint32_t>(x[i] >> 32) == status;
    w[i] = static_cast<uint32_t>(x[i]);
  }
  return same ? status : kEmpty;
}

// The fold of the tiles before `tile` (> 0), by one whole warp: each step
// reads the records of 32 predecessors at once (lane 31 the nearest),
// again until every one of them from the nearest inclusive prefix on is
// published, and folds them in order.  Before tile 0 lies the identity,
// read as an inclusive prefix.  The result is valid in lane 31.
template <class Op>
__device__ __forceinline__ typename Op::T look_back(
    const Op& op, const LookBack<typename Op::T>& lb, int tile) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  T prefix = op.identity();  // the fold of tiles (hi, tile)
  int hi = tile - 1;         // the nearest tile not folded yet
  for (;;) {
    const int j = hi - 31 + lane;
    T v = op.identity();
    const uint32_t status = j >= 0 ? read_record(lb, j, &v) : kInclusive;
    const unsigned incl = __ballot_sync(kFull, status == kInclusive);
    const unsigned empty = __ballot_sync(kFull, status == kEmpty);
    const int from = 31 - __clz(incl);  // the nearest inclusive; -1: none
    if (empty >> (from < 0 ? 0 : from)) continue;  // not all published yet
    if (lane < from) v = op.identity();
    v = warp_inclusive(op, v);  // lane 31: the window's fold, in order
    prefix = op.combine(v, prefix);
    if (incl) return prefix;
    hi -= 32;
  }
}

// The carry of this CTA's tile, by one warp (every lane of it calls):
// publishes the tile's `total`, looks back, publishes the inclusive
// prefix and writes the exclusive one to `carry` (shared; the caller
// syncs before reading it).  A tile whose total is absorbing publishes it
// as its inclusive prefix at once, so its successors need not wait for
// its walk; it still walks for its own carry.
template <class Op>
__device__ __forceinline__ void tile_carry(const Op& op,
                                           const LookBack<typename Op::T>& lb,
                                           int tile,
                                           const typename Op::T& total,
                                           typename Op::T* carry) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) {
      publish(lb, tile, total, kInclusive);
      *carry = op.identity();
    }
    return;
  }
  const bool absorbing = op.absorbing(total);
  if (lane == 0) publish(lb, tile, total, absorbing ? kInclusive : kAggregate);
  const typename Op::T prefix = look_back(op, lb, tile);
  if (lane == 31) {
    if (!absorbing) publish(lb, tile, op.combine(prefix, total), kInclusive);
    *carry = prefix;
  }
}

// -- staged tiles -------------------------------------------------------------

// Copy `bytes` bytes of a tile from global `src` to shared `dst` with
// 16-byte asynchronous copies (cp.async) from consecutive threads, all in
// flight at once, and fill dst[bytes, cap) with `fill`.  The caller
// waits with load_wait() before its barrier.  `vec`: src is 16-byte
// aligned (else byte loads).
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* src,
                                          int bytes, int cap, uint8_t fill,
                                          bool vec) {
  const int nvec = vec ? bytes / 16 : 0;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const auto d =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + 16 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src + 16 * i)
                 : "memory");
  }
  for (int i = nvec * 16 + threadIdx.x; i < cap; i += blockDim.x)
    dst[i] = i < bytes ? src[i] : fill;
}

// Wait for this thread's load_tile copies.
__device__ __forceinline__ void load_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copy `bytes` bytes of a staged tile from shared `src` to global `dst`
// with 16-byte stores from consecutive threads.  `vec`: dst is 16-byte
// aligned (else byte stores).
__device__ __forceinline__ void store_tile(uint8_t* dst, const uint8_t* src,
                                           int bytes, bool vec) {
  const int nvec = vec ? bytes / 16 : 0;
  auto* d4 = reinterpret_cast<uint4*>(dst);
  const auto* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) d4[i] = s4[i];
  for (int i = nvec * 16 + threadIdx.x; i < bytes; i += blockDim.x)
    dst[i] = src[i];
}

// N 32-bit words of one thread to shared `dst` (16-byte aligned) as N / 4
// 16-byte stores.
template <int N>
__device__ __forceinline__ void stage_words(void* dst, const uint32_t* w) {
  static_assert(N % 4 == 0, "whole 16-byte stores");
  auto* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    d4[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

// N 32-bit words from shared `src` (16-byte aligned) as N / 4 16-byte
// loads.
template <int N>
__device__ __forceinline__ void unstage_words(uint32_t* w, const void* src) {
  static_assert(N % 4 == 0, "whole 16-byte loads");
  const auto* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const uint4 v = s4[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

}  // namespace mr
