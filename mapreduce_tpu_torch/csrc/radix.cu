// LSD radix sort passes and the partition plan for Hopper (sm_90a).
//
// Replaces: mapreduce_tpu/ops/radix_sort.py:_hist_kernel (radix_hist),
// _rank_kernel (radix_rank) and _scatter_kernel (radix_scatter), the
// Pallas TPU kernels behind radix_sort_pairs (sort_impl='radix') and
// radix_partition_plan (the exchange's impl='radix').
//
// What they compute.  Rows are cut into tiles of kTile = 4096 in input
// order; a digit is ((uint32)v >> shift) & mask, clamped to nb - 1.
//   radix_hist     hist[b][d][t]: rows of tile t (of batch row b) with
//                  digit d.  Digit-major, so each digit's column over the
//                  tiles is contiguous for the scan below.
//   radix_rank     (plan) prefix[b][d][t] = sum of hist[b][d][t' < t]
//                  and totals[b][d] (the column scan), then for every row
//                  rank = prefix[b][d][t] + its in-tile rank: the row's
//                  stable input-order index within its bucket.
//   radix_scatter  (one sort pass) the same column scan, the digit base
//                  (exclusive scan of totals over digits) in every block,
//                  then (k1, k2, perm) of every row go to position
//                  base[d] + prefix[d][t] + in-tile rank, out of place.
// A stable LSD sort has exactly one output permutation whatever its
// digit width, so 8-bit digits in 8 passes (k2 first, then k1) give
// lax.sort((k1, k2, iota), num_keys=2)'s bits, as the TPU's 4-bit
// digits in 16 passes do.  Keys are uint32 bit patterns in int32
// storage: every shift is a logical shift of a uint32_t, so 0xFFFFFFFF
// (the sentinel) sorts last and 0x7FFFFFFF < 0x80000000.  Rows past n
// in the last tile are masked, not padded.
//
// Where the TPU design does not carry over.  The TPU ranks a tile by a
// one-hot cumsum over 16 digit lanes and scatters into a full-array
// block that every grid step revisits; both come from its sequential
// grid and its VMEM.  Here the in-tile rank must come from input order,
// never from atomic order (an atomicAdd slot still sorts the keys but
// scrambles perm among equal keys, and the payload that
// sorted_unique_reduce keeps is the run's last row).  Each warp owns a
// contiguous span of 512 rows and walks it in 16 rounds of 32 rows;
// __match_any_sync groups the lanes of a round by digit, a lane's rank
// is the warp's running count of its digit (shared memory) plus the
// lower lanes of its group, and the group's highest lane then advances
// the count.  An exclusive scan over the 8 warps per digit finishes the
// tile.  The histogram's counts commute, so it uses warp-aggregated
// shared-memory atomics.
//
// Bound on the card: memory.  One sort pass reads k1, k2 and perm and
// writes them (24 B per row), plus the digit lane again for the
// histogram (4 B); the plan reads dest twice and writes the rank.  The
// scatter's stores are not coalesced (each lands at its digit's cursor),
// and nothing skips a pass whose digit is constant: onesweep with
// decoupled look-back, staged stores and pass skipping are later work.
#include "scan.cuh"

namespace mr_radix_kernels {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                 // rows per lane in a tile
constexpr int kTile = kThreads * kRounds;   // 4096 rows
constexpr int kWarpSpan = 32 * kRounds;     // 512 rows per warp
constexpr int kMaxBuckets = 256;            // 8-bit digits; P + 1 <= 256
static_assert(kThreads == kMaxBuckets, "one thread per digit");

struct AddOp {
  using T = int32_t;
  __device__ T identity() const { return 0; }
  __device__ T combine(T a, T b) const { return a + b; }
  static __device__ T shfl_up(T x, int off) {
    return __shfl_up_sync(mr::kFull, x, off);
  }
};

__device__ __forceinline__ int digit_of(int32_t v, int shift, uint32_t mask,
                                        int nb) {
  const uint32_t d = (static_cast<uint32_t>(v) >> shift) & mask;
  return d < static_cast<uint32_t>(nb) ? static_cast<int>(d) : nb - 1;
}

// Per-tile digit histogram: grid (tiles, batch).
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int32_t* src, long long n, int shift, uint32_t mask,
                int nb, int tiles, int32_t* hist) {
  __shared__ int32_t counts[kMaxBuckets];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < nb) counts[threadIdx.x] = 0;
  __syncthreads();
  const int32_t* s = src + blockIdx.y * n;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    const int d = i < n ? digit_of(s[i], shift, mask, nb) : -1;
    const unsigned peers = __match_any_sync(mr::kFull, d);
    if (d >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&counts[d], __popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < nb)
    hist[(static_cast<long long>(blockIdx.y) * nb + threadIdx.x) * tiles +
         blockIdx.x] = counts[threadIdx.x];
}

// Column scan: grid (nb, batch).  prefix = exclusive scan of one digit's
// column over the tiles, totals = the column's sum.
__global__ void __launch_bounds__(kThreads)
    colscan_kernel(const int32_t* hist, int nb, int tiles, int32_t* prefix,
                   int32_t* totals) {
  __shared__ int32_t shared[32];
  const long long col =
      (static_cast<long long>(blockIdx.y) * nb + blockIdx.x) * tiles;
  const int32_t* h = hist + col;
  int32_t* p = prefix + col;
  const int per = (tiles + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, tiles);
  const int hi = min(lo + per, tiles);
  int32_t agg = 0;
  for (int t = lo; t < hi; ++t) agg += h[t];
  int32_t total;
  int32_t run = mr::block_exclusive(AddOp{}, agg, shared, &total);
  for (int t = lo; t < hi; ++t) {
    p[t] = run;
    run += h[t];
  }
  if (threadIdx.x == 0) totals[blockIdx.y * nb + blockIdx.x] = total;
}

// The stable in-tile rank.  On return dig[r] is the digit of this lane's
// row in round r (-1 past n), local[r] its rank among equal digits in the
// warp's span, and wcount[w][d] the count of digit d in the spans of
// warps before w.
template <class DigitAt>
__device__ __forceinline__ void tile_ranks(DigitAt digit_at, long long n,
                                           long long base, int nb,
                                           int32_t (*wcount)[kMaxBuckets],
                                           int* dig, int* local) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * kMaxBuckets; k += kThreads)
    wcount[k / kMaxBuckets][k % kMaxBuckets] = 0;
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  const long long span = base + static_cast<long long>(warp) * kWarpSpan;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = span + r * 32 + lane;
    const int d = i < n ? digit_at(i) : -1;
    const unsigned peers = __match_any_sync(mr::kFull, d);
    const int seen = d >= 0 ? wcount[warp][d] : 0;
    dig[r] = d;
    local[r] = seen + __popc(peers & below);
    __syncwarp();
    if (d >= 0 && lane == 31 - __clz(peers))
      wcount[warp][d] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x < nb) {
    int32_t run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = wcount[w][threadIdx.x];
      wcount[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
}

// Plan ranks: grid (tiles, batch).
__global__ void __launch_bounds__(kThreads)
    rank_kernel(const int32_t* dest, long long n, int nb, int tiles,
                const int32_t* prefix, int32_t* rank) {
  __shared__ int32_t wcount[kWarps][kMaxBuckets];
  __shared__ int32_t tile_off[kMaxBuckets];
  const int32_t* d_in = dest + blockIdx.y * n;
  int32_t* r_out = rank + blockIdx.y * n;
  if (threadIdx.x < nb)
    tile_off[threadIdx.x] =
        prefix[(static_cast<long long>(blockIdx.y) * nb + threadIdx.x) *
                   tiles + blockIdx.x];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int dig[kRounds], local[kRounds];
  tile_ranks([&](long long i) { return digit_of(d_in[i], 0, 0xffffffffu,
                                                nb); },
             n, base, nb, wcount, dig, local);
  const int warp = threadIdx.x >> 5;
  const long long span = base + static_cast<long long>(warp) * kWarpSpan;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = span + r * 32 + (threadIdx.x & 31);
    if (i < n) {
      const int d = dig[r];
      r_out[i] = tile_off[d] + wcount[warp][d] + local[r];
    }
  }
}

// One LSD pass: grid (tiles).  perm_in null means the identity (pass 0).
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int32_t* a1, const int32_t* a2,
                   const int32_t* perm_in, long long n, int lane_sel,
                   int shift, int tiles, const int32_t* prefix,
                   const int32_t* totals, int32_t* o1, int32_t* o2,
                   int32_t* operm) {
  __shared__ int32_t wcount[kWarps][kMaxBuckets];
  __shared__ int32_t tile_off[kMaxBuckets];
  __shared__ int32_t shared[32];
  // digit base: exclusive scan of the digit totals, one digit per thread
  const int32_t digit_base = mr::block_exclusive(
      AddOp{}, totals[threadIdx.x], shared, static_cast<int32_t*>(nullptr));
  tile_off[threadIdx.x] =
      digit_base +
      prefix[static_cast<long long>(threadIdx.x) * tiles + blockIdx.x];
  const int32_t* src = lane_sel ? a2 : a1;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int dig[kRounds], local[kRounds];
  tile_ranks([&](long long i) { return digit_of(src[i], shift, 0xffu,
                                                kMaxBuckets); },
             n, base, kMaxBuckets, wcount, dig, local);
  const int warp = threadIdx.x >> 5;
  const long long span = base + static_cast<long long>(warp) * kWarpSpan;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = span + r * 32 + (threadIdx.x & 31);
    if (i < n) {
      const int d = dig[r];
      const long long pos = tile_off[d] + wcount[warp][d] + local[r];
      o1[pos] = a1[i];
      o2[pos] = a2[i];
      operm[pos] = perm_in ? perm_in[i] : static_cast<int32_t>(i);
    }
  }
}

inline int num_tiles(long long n) {
  return static_cast<int>((n + kTile - 1) / kTile);
}

}  // namespace mr_radix_kernels

using namespace mr_radix_kernels;

extern "C" {

// Rows per tile (the Python side checks it against its own constant).
int mr_radix_tile() { return kTile; }

// Histogram of batch x n rows src [batch, n] (int32 bit patterns) into
// hist [batch, nb, tiles] int32.  1 <= nb <= 256.
int mr_radix_hist(const void* src, long long n, int batch, int shift,
                  unsigned mask, int nb, void* hist, void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || nb < 1 || nb > kMaxBuckets ||
      shift < 0 || shift > 31 || n >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int tiles = num_tiles(n);
  hist_kernel<<<dim3(tiles, batch), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), n, shift, mask, nb, tiles,
      static_cast<int32_t*>(hist));
  return cudaGetLastError();
}

// Plan ranks of dest [batch, n] (buckets [0, nb)) from its histogram:
// prefix [batch, nb, tiles] and totals [batch, nb] are written on the
// way (totals are the bucket counts), rank [batch, n] int32.
int mr_radix_rank(const void* dest, long long n, int batch, int nb,
                  const void* hist, void* prefix, void* totals, void* rank,
                  void* stream) {
  if (n <= 0 || batch <= 0 || batch > 65535 || nb < 1 || nb > kMaxBuckets ||
      n >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int tiles = num_tiles(n);
  auto st = static_cast<cudaStream_t>(stream);
  auto* pre = static_cast<int32_t*>(prefix);
  colscan_kernel<<<dim3(nb, batch), kThreads, 0, st>>>(
      static_cast<const int32_t*>(hist), nb, tiles, pre,
      static_cast<int32_t*>(totals));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rank_kernel<<<dim3(tiles, batch), kThreads, 0, st>>>(
      static_cast<const int32_t*>(dest), n, nb, tiles, pre,
      static_cast<int32_t*>(rank));
  return cudaGetLastError();
}

// One LSD pass over n rows by the 8-bit digit at `shift` of lane k1
// (lane 0) or k2 (lane 1), from that digit's histogram hist [256, tiles]:
// (k1, k2, perm) -> (o1, o2, operm), out of place.  perm may be null
// (the identity).  prefix [256, tiles] and totals [256] are scratch.
int mr_radix_scatter(const void* k1, const void* k2, const void* perm,
                     long long n, int lane, int shift, const void* hist,
                     void* prefix, void* totals, void* o1, void* o2,
                     void* operm, void* stream) {
  if (n <= 0 || (lane != 0 && lane != 1) || shift < 0 || shift > 24 ||
      n >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int tiles = num_tiles(n);
  auto st = static_cast<cudaStream_t>(stream);
  auto* pre = static_cast<int32_t*>(prefix);
  auto* tot = static_cast<int32_t*>(totals);
  colscan_kernel<<<dim3(kMaxBuckets, 1), kThreads, 0, st>>>(
      static_cast<const int32_t*>(hist), kMaxBuckets, tiles, pre, tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_kernel<<<tiles, kThreads, 0, st>>>(
      static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),
      static_cast<const int32_t*>(perm), n, lane, shift, tiles, pre, tot,
      static_cast<int32_t*>(o1), static_cast<int32_t*>(o2),
      static_cast<int32_t*>(operm));
  return cudaGetLastError();
}

}  // extern "C"
