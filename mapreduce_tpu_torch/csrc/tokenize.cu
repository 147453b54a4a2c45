// Byte-stream tokenizer + polynomial word hasher for Hopper (sm_90a).
//
// Replaces: mapreduce_tpu/ops/tokenize.py:_tokenize_kernel (the Pallas
// TPU kernel behind tokenize_hash(impl='pallas')).
//
// For every byte position p of a chunk it computes
//   is_end[p]   a word's last byte is here (the chunk end counts as space),
//   keys[p][l]  h = a_l*h + (b+1) over the word's bytes so far (uint32
//               wraparound; 0 on whitespace), one lane per multiplier,
//   start[p]    running max of word-start positions (-1 before any),
//   length[p]   p - start[p] + 1.
// Whitespace is ASCII {space, \t, \n, \r, \f, \v}; other bytes, multi-byte
// UTF-8 included, are word bytes.
//
// The TPU kernel walks a sequential grid and carries the hash lanes, the
// previous byte's space-ness and the start max across blocks in SMEM.
// Here the hash recurrence is the affine map h -> m*h + c with
// (m, c) = (a, b+1) on word bytes and (0, 0) on whitespace, and the start
// is a running max; both are monoids, so the kernel is a two-phase scan
// (scan.cuh).  The neighbour bytes that decide is_start/is_end are read
// from device memory directly, so no space-ness carry is needed.
//
// Bound on the card: memory.  Per byte it reads 1 byte and writes
// 4*lanes + 1 + 4 + 4 bytes (17 at two lanes); the scan arithmetic is a
// few integer ops per byte and lane.  Each thread walks 8 consecutive
// bytes and the tile is read twice (phases a and c); the second read
// mostly hits L2.  Vector loads and staging the outputs through shared
// memory for wider stores are left for a later change.
#include <climits>

#include "scan.cuh"

// a named namespace, so profiles tell the two files' kernels apart
namespace mr_tokenize_kernels {

using mr::kItems;
using mr::kThreads;
using mr::kTile;

__device__ __forceinline__ bool is_space(uint8_t b) {
  return b == 32 || b == 9 || b == 10 || b == 13 || b == 12 || b == 11;
}

template <int NL>
struct Mults {
  uint32_t a[NL];
};

// The tokenizer's scan monoid: NL affine hash maps plus the start max.
template <int NL>
struct TokOp {
  struct T {
    uint32_t m[NL];
    uint32_t c[NL];
    int32_t smax;
  };
  __device__ T identity() const {
    T t;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      t.m[l] = 1u;
      t.c[l] = 0u;
    }
    t.smax = INT_MIN;
    return t;
  }
  __device__ T combine(const T& x, const T& y) const {
    T o;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      o.m[l] = x.m[l] * y.m[l];
      o.c[l] = x.c[l] * y.m[l] + y.c[l];
    }
    o.smax = max(x.smax, y.smax);
    return o;
  }
  static __device__ T shfl_up(const T& x, int off) {
    T y;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      y.m[l] = __shfl_up_sync(mr::kFull, x.m[l], off);
      y.c[l] = __shfl_up_sync(mr::kFull, x.c[l], off);
    }
    y.smax = __shfl_up_sync(mr::kFull, x.smax, off);
    return y;
  }
};

// One thread's composed map over its kItems bytes starting at `base`.
template <int NL>
__device__ typename TokOp<NL>::T thread_fold(const TokOp<NL>& op,
                                             const uint8_t* bytes, int n,
                                             int base, const Mults<NL>& a) {
  typename TokOp<NL>::T agg = op.identity();
  bool prev_space = base == 0 ? true : is_space(bytes[base - 1]);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = base + j;
    if (p >= n) break;
    const uint8_t b = bytes[p];
    const bool word = !is_space(b);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const uint32_t m = word ? a.a[l] : 0u;
      const uint32_t c = word ? static_cast<uint32_t>(b) + 1u : 0u;
      agg.m[l] *= m;
      agg.c[l] = agg.c[l] * m + c;
    }
    if (word && prev_space) agg.smax = p;
    prev_space = !word;
  }
  return agg;
}

// Phase (a): one summary per tile.
template <int NL>
__global__ void __launch_bounds__(kThreads)
    tile_sums(const uint8_t* bytes, int n, Mults<NL> a,
              typename TokOp<NL>::T* sums) {
  using T = typename TokOp<NL>::T;
  __shared__ T shared[32];
  const TokOp<NL> op{};
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  T total;
  mr::block_exclusive(op, thread_fold(op, bytes, n, base, a), shared,
                      &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Phase (b).
template <int NL>
__global__ void __launch_bounds__(mr::kScanThreads)
    scan_tile_sums(const typename TokOp<NL>::T* sums,
                   typename TokOp<NL>::T* prefix, int nt) {
  mr::scan_tiles(TokOp<NL>(), sums, prefix, nt);
}

// Phase (c): rescan each tile from its prefix and write the outputs.
template <int NL>
__global__ void __launch_bounds__(kThreads)
    apply(const uint8_t* bytes, int n, Mults<NL> a,
          const typename TokOp<NL>::T* prefix, int32_t* keys,
          uint8_t* is_end, int32_t* start, int32_t* length) {
  using T = typename TokOp<NL>::T;
  __shared__ T shared[32];
  const TokOp<NL> op{};
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  const T excl = mr::block_exclusive(
      op, thread_fold(op, bytes, n, base, a), shared,
      static_cast<T*>(nullptr));
  const T carry = op.combine(prefix[blockIdx.x], excl);
  // the hash before the chunk is 0, so the carried value IS carry.c
  uint32_t h[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) h[l] = carry.c[l];
  int32_t s = max(carry.smax, -1);
  bool prev_space = base == 0 ? true : is_space(bytes[base - 1]);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = base + j;
    if (p >= n) break;
    const uint8_t b = bytes[p];
    const bool word = !is_space(b);
    const bool next_space = p + 1 >= n ? true : is_space(bytes[p + 1]);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      h[l] = word ? h[l] * a.a[l] + static_cast<uint32_t>(b) + 1u : 0u;
      keys[static_cast<int64_t>(p) * NL + l] = static_cast<int32_t>(h[l]);
    }
    if (word && prev_space) s = p;
    is_end[p] = (word && next_space) ? 1 : 0;
    start[p] = s;
    length[p] = p - s + 1;
    prev_space = !word;
  }
}

template <int NL>
size_t scratch_bytes(int n) {
  return 2 * static_cast<size_t>(mr::num_tiles(n)) *
         sizeof(typename TokOp<NL>::T);
}

template <int NL>
int launch(const uint8_t* bytes, int n, const uint32_t* mults,
           int32_t* keys, uint8_t* is_end, int32_t* start, int32_t* length,
           void* scratch, cudaStream_t stream) {
  using T = typename TokOp<NL>::T;
  Mults<NL> a;
  for (int l = 0; l < NL; ++l) a.a[l] = mults[l];
  const int nt = mr::num_tiles(n);
  T* sums = static_cast<T*>(scratch);
  T* prefix = sums + nt;
  tile_sums<NL><<<nt, kThreads, 0, stream>>>(bytes, n, a, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tile_sums<NL><<<1, mr::kScanThreads, 0, stream>>>(sums, prefix, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  apply<NL><<<nt, kThreads, 0, stream>>>(bytes, n, a, prefix, keys, is_end,
                                         start, length);
  return cudaGetLastError();
}

}  // namespace mr_tokenize_kernels

using namespace mr_tokenize_kernels;

extern "C" {

// Bytes of device scratch mr_tokenize needs for n bytes and n_lanes lanes
// (0 for an unsupported lane count).
long long mr_tokenize_scratch_bytes(int n, int n_lanes) {
  switch (n_lanes) {
    case 1: return static_cast<long long>(scratch_bytes<1>(n));
    case 2: return static_cast<long long>(scratch_bytes<2>(n));
    case 3: return static_cast<long long>(scratch_bytes<3>(n));
    default: return 0;
  }
}

// Tokenize n > 0 bytes.  keys is [n, n_lanes] int32 (uint32 bit patterns),
// is_end [n] bytes of 0/1, start and length [n] int32.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an
// unsupported lane count or n <= 0).
int mr_tokenize(const void* bytes, int n, int n_lanes, uint32_t a0,
                uint32_t a1, uint32_t a2, void* keys, void* is_end,
                void* start, void* length, void* scratch, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const uint32_t mults[3] = {a0, a1, a2};
  const auto* b = static_cast<const uint8_t*>(bytes);
  auto* k = static_cast<int32_t*>(keys);
  auto* e = static_cast<uint8_t*>(is_end);
  auto* s = static_cast<int32_t*>(start);
  auto* len = static_cast<int32_t*>(length);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n_lanes) {
    case 1: return launch<1>(b, n, mults, k, e, s, len, scratch, st);
    case 2: return launch<2>(b, n, mults, k, e, s, len, scratch, st);
    case 3: return launch<3>(b, n, mults, k, e, s, len, scratch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
