// The LSD radix sort (onesweep) and the partition plan for Hopper (sm_90a).
//
// Replaces: mapreduce_tpu/ops/radix_sort.py:_hist_kernel (in the sort,
// radix_upfront; in the plan, part of radix_plan), _rank_kernel
// (radix_plan) and _scatter_kernel (radix_onesweep), the Pallas TPU
// kernels behind radix_sort_pairs (sort_impl='radix') and
// radix_partition_plan (the exchange's impl='radix').
//
// What they compute.  A digit is ((uint32)v >> shift) & mask, clamped to
// nb - 1.  The sort's key is (k1 hi, k2 lo); its 8 passes take the 8-bit
// digits of k2 at shifts 0, 8, 16, 24, then those of k1.
//   radix_upfront   (the sort) table[p][d]: rows whose pass-p digit is d,
//                   for all 8 passes at once from one read of (k1, k2).
//                   A permutation keeps every digit's count, so the one
//                   table serves every pass.
//   radix_onesweep  (one sort pass) rows are cut into tiles of kSortTile
//                   in input order; (k1, k2, perm) of every row go to
//                   base[d] + prefix[t][d] + its stable rank among the
//                   tile's rows of digit d, out of place, where base is
//                   the exclusive scan of table[p] over digits and
//                   prefix[t][d] the rows of digit d in tiles before t.
//   radix_plan      (the exchange plan) for each batch row b of dest, cut
//                   into tiles of kPlanTile rows: rank = prefix[b][t][d]
//                   + the row's in-tile rank, its stable input-order
//                   index in its bucket d, and totals[b][d], the rows of
//                   bucket d (the counts before capping).
// A stable LSD sort has exactly one output permutation whatever its
// digit width, so 8-bit digits in 8 passes give lax.sort((k1, k2, iota),
// num_keys=2)'s bits, as the TPU's 4-bit digits in 16 passes do.  Keys
// are uint32 bit patterns in int32 storage: every shift is a logical
// shift of a uint32_t, so 0xFFFFFFFF (the sentinel) sorts last and
// 0x7FFFFFFF < 0x80000000.  Rows past n in the last tile are masked.
//
// Where the TPU design does not carry over.  The TPU ranks a tile by a
// one-hot cumsum over 16 digit lanes and scatters into a full-array block
// that every grid step revisits; its grid is sequential, so the tile
// prefix is a scan over a histogram it wrote first.  Here tiles run in
// parallel.  The sort is onesweep: one upfront histogram of all 8
// digits, then one kernel a pass that ranks its tile, finds its tile's
// prefix by decoupled look-back, and scatters through shared memory.
// The plan is one kernel of the same shape: rank the tile, look back,
// write the ranks (no histogram pass, no column scan).
//   - The tile id comes from an atomic counter, not blockIdx.x: a CTA
//     that waits on its predecessors then knows they are running, and
//     tile ids follow input order, which keeps the pass stable.  The
//     plan's ids run over batch x tiles, row-major, so a tile's
//     predecessors in its batch row hold smaller ids.
//   - The in-tile rank comes from input order, never from atomic order
//     (an atomicAdd slot still sorts the keys but scrambles perm among
//     equal keys, and the payload that sorted_unique_reduce keeps is the
//     run's last row).  Each warp owns a contiguous span of rows and walks
//     it 32 rows a round; __match_any_sync groups a round's lanes by
//     digit, a lane's rank is the warp's running count of its digit plus
//     the lower lanes of its group, and an exclusive scan over the 8
//     warps per digit finishes the tile.
//   - Look-back: thread d publishes its digit's tile count in a word that
//     holds a status beside the count (aggregate, inclusive prefix, or 0
//     = not yet), walks back over the preceding tiles adding aggregates
//     until it meets an inclusive prefix, then publishes its own.  Status
//     and count share one word, so no reader can see a status before its
//     count and the words need no fence.  The sort's words are 32 bits,
//     the status in the top two (hence n < 2^30); the plan's are 64 bits,
//     the status in the high half, so a batch row takes up to 2^31 - 1
//     rows.  When a launch's tiles start together, the walks are serial
//     chains of L2 reads (about sqrt(2 t) of them for tile t), so each
//     step reads kWindow tiles at once.
//   - Staged stores (the sort): the three lanes are written to shared
//     memory in the tile's sorted order (before the look-back, which they
//     overlap), then stored from there in one loop, so consecutive
//     threads write consecutive addresses inside each digit's run (a
//     direct scatter lands each row at its digit's cursor: up to 32
//     sectors a warp).  The staged digits (one byte a row) serve all
//     three lanes.  The plan writes its ranks in input order: a warp's 32
//     stores are already one 128-byte line.
//   - The upfront counts commute: plain shared atomics, one add of 32
//     where a warp's 32 rows hold one key (the sentinel rows, a constant
//     key); a hash key's digits rarely repeat within a warp.
//
// Bound on the card: memory.  The sort reads (k1, k2) once up front (8 B
// a row), then each pass reads and writes (k1, k2, perm): 20 B a row in
// pass 0 (perm is the row index), 24 B after.  Both buffer sets fit the
// 50 MB L2 at the path's sizes, so the HBM figure is a ceiling.  The
// plan reads dest and writes the rank, 8 B a row, plus the totals.
// Nothing skips a pass whose digit is constant: on hash keys every digit
// varies.
#include "scan.cuh"

#ifndef MR_ONESWEEP_TILE
#define MR_ONESWEEP_TILE 4096
#endif
#ifndef MR_PLAN_TILE
#define MR_PLAN_TILE 4096
#endif

namespace mr_radix_kernels {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuckets = 256;            // 8-bit digits; P + 1 <= 256
static_assert(kThreads == kMaxBuckets, "one thread per digit");
// the plan's tiles
constexpr int kPlanTile = MR_PLAN_TILE;
constexpr int kPlanRounds = kPlanTile / kThreads;
static_assert(kPlanTile % kThreads == 0 && kPlanRounds >= 1 &&
              kPlanRounds <= 16, "a plan tile is 256 to 4096 rows");
// CTAs an SM (64 registers a thread): the slice's 512 tiles of 4,096 rows
// in one wave of 132 x 4
constexpr int kPlanCtas = 4;
// the sort's tiles
constexpr int kSortTile = MR_ONESWEEP_TILE;
constexpr int kSortRounds = kSortTile / kThreads;
static_assert(kSortTile % kThreads == 0 && kSortRounds >= 1 &&
              kSortRounds <= 16, "a sort tile is 256 to 4096 rows");
// predecessor tiles a look-back step reads at once
constexpr int kWindow = 4;
constexpr int kPasses = 8;
// the upfront histogram: one CTA per SM, 2 rows a thread per round
constexpr int kUpThreads = 1024;
constexpr int kUpRows = 2;
// look-back statuses (0: not published yet)
constexpr uint32_t kAggregate = 1;
constexpr uint32_t kInclusive = 2;
// scratch words of one pass (and of the plan): its tile counter (padded
// to 128 bytes), then its look-back words
constexpr long long kCounterWords = 32;

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

// A look-back word: a status beside a count.  The sort's are 32 bits
// (the status in the top two, so a pass takes fewer than 2^30 rows), the
// plan's 64 (the status in the high half, the count in the low half).
template <class W>
struct LookWord;

template <>
struct LookWord<uint32_t> {
  static __device__ uint32_t make(uint32_t status, int32_t count) {
    return status << 30 | static_cast<uint32_t>(count);
  }
  static __device__ uint32_t status(uint32_t w) { return w >> 30; }
  static __device__ int32_t count(uint32_t w) {
    return static_cast<int32_t>(w & ((1u << 30) - 1u));
  }
};

template <>
struct LookWord<uint64_t> {
  static __device__ uint64_t make(uint32_t status, int32_t count) {
    return static_cast<uint64_t>(status) << 32 | static_cast<uint32_t>(count);
  }
  static __device__ uint32_t status(uint64_t w) {
    return static_cast<uint32_t>(w >> 32);
  }
  static __device__ int32_t count(uint64_t w) {
    return static_cast<int32_t>(static_cast<uint32_t>(w));
  }
};

// Look-back words at GPU scope, without fences: a word carries its own
// status and count, and nothing else is published through it (the 64-bit
// loads and stores are scan.cuh's).
using mr::load_relaxed;
using mr::store_relaxed;

__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Decoupled look-back for this thread's digit: the rows of the digit in
// the tiles before `tile`, whose words lie `stride` apart below `mine`.
// Each step reads kWindow tiles at once (independent loads, one latency)
// and sums them nearest first until an inclusive prefix; a tile not yet
// published ends the step, and the next one starts there.
template <class W>
__device__ __forceinline__ int32_t look_back(const W* mine, int tile,
                                             int stride) {
  using Word = LookWord<W>;
  int32_t before = 0;
  int next = tile - 1;  // the nearest tile not summed yet
  for (;;) {
    W w[kWindow];
#pragma unroll
    for (int j = 0; j < kWindow; ++j)  // past tile 0: an empty prefix
      w[j] = next - j >= 0
                 ? load_relaxed(mine - static_cast<long long>(tile - next +
                                                              j) *
                                           stride)
                 : Word::make(kInclusive, 0);
    int summed = 0;
    bool stop = false;
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      const uint32_t status = Word::status(w[j]);
      stop = stop || status == 0;
      if (!stop) {
        before += Word::count(w[j]);
        if (status == kInclusive) return before;
        summed = j + 1;
      }
    }
    next -= summed;
  }
}

// The stable in-tile rank of the rows a lane holds: dig[r] is the digit
// of its row in round r (-1 past n); each warp owns 32 * Rounds
// consecutive rows, round r at lane l being row r * 32 + l of the span.
// rank(r, local) takes round r's rank among equal digits in the warp's
// span, once dig[r] is read (it may overwrite dig[r]).  On return
// wcount[w][d] is the count of digit d in the spans of warps before w,
// and the result (threads d < nb) the tile's count of digit d.
template <int Rounds, class Rank>
__device__ __forceinline__ int32_t tile_ranks(const int* dig, int nb,
                                              int32_t (*wcount)[kMaxBuckets],
                                              Rank rank) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * kMaxBuckets; k += kThreads)
    wcount[k / kMaxBuckets][k % kMaxBuckets] = 0;
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < Rounds; ++r) {
    const int d = dig[r];
    const unsigned peers = __match_any_sync(mr::kFull, d);
    const int seen = d >= 0 ? wcount[warp][d] : 0;
    rank(r, seen + __popc(peers & below));
    __syncwarp();
    if (d >= 0 && lane == 31 - __clz(peers))
      wcount[warp][d] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int32_t run = 0;
  if (threadIdx.x < nb) {
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = wcount[w][threadIdx.x];
      wcount[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  return run;
}

// The exchange plan: one tile a CTA, grid (batch * tiles).  tile_counter
// and look [batch][tiles][nb] (zeroed) are the scratch; rank [batch, n]
// and totals [batch, nb] the outputs (totals written by each row's last
// tile).
__global__ void __launch_bounds__(kThreads, kPlanCtas)
    plan_kernel(const int32_t* dest, long long n, int nb, int tiles,
                int32_t* tile_counter, uint64_t* look, int32_t* rank,
                int32_t* totals) {
  __shared__ int32_t wcount[kWarps][kMaxBuckets];
  __shared__ int tile_id;
  if (threadIdx.x == 0) tile_id = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int id = tile_id;
  const int row = id / tiles;
  const int tile = id - row * tiles;
  const int32_t* d_in = dest + row * n;
  int32_t* r_out = rank + row * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long span = static_cast<long long>(tile) * kPlanTile +
                         static_cast<long long>(warp) * 32 * kPlanRounds;
  // a row's digit, then its in-warp rank << 8 | its digit: one register
  // a row fits kPlanCtas CTAs an SM without spills
  int key[kPlanRounds];
#pragma unroll
  for (int r = 0; r < kPlanRounds; ++r) {
    const long long i = span + r * 32 + lane;
    key[r] = i < n ? digit_of(d_in[i], 0, 0xffffffffu, nb) : -1;
  }
  const int32_t count = tile_ranks<kPlanRounds>(
      key, nb, wcount,
      [&](int r, int local) { key[r] = local << 8 | (key[r] & 0xff); });
  if (threadIdx.x < nb) {
    using Word = LookWord<uint64_t>;
    uint64_t* mine = look + static_cast<long long>(id) * nb + threadIdx.x;
    int32_t before = 0;
    if (tile == 0) {
      store_relaxed(mine, Word::make(kInclusive, count));
    } else {
      store_relaxed(mine, Word::make(kAggregate, count));
      before = look_back(mine, tile, nb);
      store_relaxed(mine, Word::make(kInclusive, before + count));
    }
    if (tile == tiles - 1) totals[row * nb + threadIdx.x] = before + count;
    for (int w = 0; w < kWarps; ++w) wcount[w][threadIdx.x] += before;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPlanRounds; ++r) {
    const long long i = span + r * 32 + lane;
    if (i < n) r_out[i] = wcount[warp][key[r] & 0xff] + (key[r] >> 8);
  }
}

// One row's 4 digits of one key lane into counts[4][256] (pass rows
// first4 .. first4 + 3); `uniform` when the warp's 32 rows share the key.
__device__ __forceinline__ void count_lane(int32_t (*counts)[kMaxBuckets],
                                           int first4, uint32_t v, bool ok,
                                           bool uniform) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = (v >> (8 * k)) & 0xff;
    if (uniform) {
      if (lane == 0) atomicAdd(&counts[first4 + k][d], 32);
    } else if (ok) {
      atomicAdd(&counts[first4 + k][d], 1);
    }
  }
}

// The upfront histogram: grid-stride over the rows, all 8 digits of each
// row, then each CTA adds its nonzero bins into table [8][256].
__global__ void __launch_bounds__(kUpThreads)
    upfront_kernel(const int32_t* k1, const int32_t* k2, long long n,
                   int32_t* table) {
  __shared__ int32_t counts[kPasses][kMaxBuckets];
  for (int k = threadIdx.x; k < kPasses * kMaxBuckets; k += kUpThreads)
    counts[k / kMaxBuckets][k % kMaxBuckets] = 0;
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * kUpThreads *
                         kUpRows;
  for (long long b = static_cast<long long>(blockIdx.x) * kUpThreads *
                     kUpRows;
       b < n; b += step) {  // uniform over the CTA: the warps stay whole
    uint32_t w1[kUpRows], w2[kUpRows];
    bool ok[kUpRows];
#pragma unroll
    for (int u = 0; u < kUpRows; ++u) {
      const long long i = b + u * kUpThreads + threadIdx.x;
      ok[u] = i < n;
      w1[u] = ok[u] ? static_cast<uint32_t>(k1[i]) : 0u;
      w2[u] = ok[u] ? static_cast<uint32_t>(k2[i]) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUpRows; ++u) {
      const uint32_t l1 = __shfl_sync(mr::kFull, w1[u], 0);
      const uint32_t l2 = __shfl_sync(mr::kFull, w2[u], 0);
      const bool uniform =
          __all_sync(mr::kFull, ok[u] && w1[u] == l1 && w2[u] == l2);
      count_lane(counts, 0, w2[u], ok[u], uniform);  // passes 0-3: k2
      count_lane(counts, 4, w1[u], ok[u], uniform);  // passes 4-7: k1
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kPasses * kMaxBuckets; k += kUpThreads) {
    const int32_t c = counts[k / kMaxBuckets][k % kMaxBuckets];
    if (c != 0) atomicAdd(&table[k], c);
  }
}

// Dynamic shared memory of a pass: the three staged lanes [3][tile]
// int32, then the staged digits [tile] uint8.
constexpr int kStageBytes = 3 * kSortTile * 4 + kSortTile;

// One onesweep pass by the 8-bit digit at `shift` of k1 (lane 0) or k2
// (lane 1): grid (tiles), one tile a CTA, kStageBytes of dynamic shared
// memory.  counts is the pass's row of the upfront table; tile_counter
// and look (zeroed) are the pass's scratch.  perm_in null means the
// identity (pass 0).
__global__ void __launch_bounds__(kThreads)
    onesweep_kernel(const int32_t* a1, const int32_t* a2,
                    const int32_t* perm_in, long long n, int lane_sel,
                    int shift, const int32_t* counts, int32_t* tile_counter,
                    uint32_t* look, int32_t* o1, int32_t* o2,
                    int32_t* operm) {
  __shared__ int32_t wcount[kWarps][kMaxBuckets];
  __shared__ int32_t digit_off[kMaxBuckets];
  __shared__ int32_t scan[32];
  __shared__ int32_t tile_id;
  extern __shared__ int32_t stage[];  // [3][kSortTile], then the digits
  auto* stage_dig = reinterpret_cast<uint8_t*>(stage + 3 * kSortTile);
  if (threadIdx.x == 0) tile_id = atomicAdd(tile_counter, 1);
  // the digit base, an exclusive scan over the 256 digits (its barriers
  // also publish tile_id)
  const int32_t digit_base = mr::block_exclusive(
      AddOp{}, counts[threadIdx.x], scan, static_cast<int32_t*>(nullptr));
  const int tile = tile_id;
  const long long base = static_cast<long long>(tile) * kSortTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long span = base + static_cast<long long>(warp) * 32 *
                                    kSortRounds;
  // the tile's three lanes, coalesced: 32 consecutive rows a warp load
  int32_t v1[kSortRounds], v2[kSortRounds], vp[kSortRounds];
  int dig[kSortRounds], slot[kSortRounds];
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const long long i = span + r * 32 + lane;
    dig[r] = -1;
    if (i < n) {
      v1[r] = a1[i];
      v2[r] = a2[i];
      vp[r] = perm_in ? perm_in[i] : static_cast<int32_t>(i);
      dig[r] = digit_of(lane_sel ? v2[r] : v1[r], shift, 0xffu, kMaxBuckets);
    }
  }
  const int32_t count = tile_ranks<kSortRounds>(
      dig, kMaxBuckets, wcount, [&](int r, int local) { slot[r] = local; });
  using Word = LookWord<uint32_t>;
  uint32_t* mine = look + static_cast<long long>(tile) * kMaxBuckets +
                   threadIdx.x;
  store_relaxed(mine, Word::make(tile == 0 ? kInclusive : kAggregate,
                                 count));
  // the tile's sorted order: digit d's rows start at tile_start
  const int32_t tile_start = mr::block_exclusive(
      AddOp{}, count, scan, static_cast<int32_t*>(nullptr));
  for (int w = 0; w < kWarps; ++w) wcount[w][threadIdx.x] += tile_start;
  __syncthreads();
  // stage the lanes (and the digits) while the predecessors publish
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    if (dig[r] >= 0) {
      const int at = slot[r] + wcount[warp][dig[r]];
      stage[at] = v1[r];
      stage[kSortTile + at] = v2[r];
      stage[2 * kSortTile + at] = vp[r];
      stage_dig[at] = static_cast<uint8_t>(dig[r]);
    }
  }
  // decoupled look-back over the tiles before this one
  const int32_t before = tile > 0 ? look_back(mine, tile, kMaxBuckets) : 0;
  if (tile > 0) store_relaxed(mine, Word::make(kInclusive, before + count));
  digit_off[threadIdx.x] = digit_base + before - tile_start;
  __syncthreads();
  const int rows = n - base < kSortTile ? static_cast<int>(n - base)
                                        : kSortTile;
  for (int s = threadIdx.x; s < rows; s += kThreads) {
    const int at = digit_off[stage_dig[s]] + s;
    o1[at] = stage[s];
    o2[at] = stage[kSortTile + s];
    operm[at] = stage[2 * kSortTile + s];
  }
}

inline long long plan_tiles(long long n) {
  return (n + kPlanTile - 1) / kPlanTile;
}

// the plan's scratch: the tile counter, then look [batch][tiles][nb] of
// 64-bit words
inline long long plan_words(long long n, int batch, int nb) {
  return kCounterWords + 2 * plan_tiles(n) * batch * nb;
}

inline long long sort_tiles(long long n) {
  return (n + kSortTile - 1) / kSortTile;
}

inline long long pass_words(long long n) {
  return kCounterWords + sort_tiles(n) * kMaxBuckets;
}

inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

inline cudaError_t launch_upfront(const void* k1, const void* k2,
                                  long long n, int32_t* table,
                                  cudaStream_t st) {
  const long long per_cta = static_cast<long long>(kUpThreads) * kUpRows;
  const long long ctas = (n + per_cta - 1) / per_cta;
  const int grid = ctas < num_sms() ? static_cast<int>(ctas) : num_sms();
  upfront_kernel<<<grid, kUpThreads, 0, st>>>(
      static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2), n,
      table);
  return cudaGetLastError();
}

// One pass with its scratch: [tile counter, pad][look [tiles][256]].
inline cudaError_t launch_onesweep(const void* k1, const void* k2,
                                   const void* perm, long long n, int lane,
                                   int shift, const int32_t* counts,
                                   int32_t* pass_scratch, void* o1, void* o2,
                                   void* operm, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      onesweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBytes);
  if (err != cudaSuccess) return err;
  onesweep_kernel<<<static_cast<int>(sort_tiles(n)), kThreads, kStageBytes,
                    st>>>(
      static_cast<const int32_t*>(k1), static_cast<const int32_t*>(k2),
      static_cast<const int32_t*>(perm), n, lane, shift, counts,
      pass_scratch, reinterpret_cast<uint32_t*>(pass_scratch + kCounterWords),
      static_cast<int32_t*>(o1), static_cast<int32_t*>(o2),
      static_cast<int32_t*>(operm));
  return cudaGetLastError();
}

}  // namespace mr_radix_kernels

using namespace mr_radix_kernels;

extern "C" {

// Rows per tile of the plan, and of the sort (the Python side checks
// each against its own constant).
int mr_radix_tile() { return kPlanTile; }
int mr_radix_sort_tile() { return kSortTile; }

// int32 words of scratch for one onesweep pass over n rows, and for the
// whole sort (the [8, 256] table, then 8 passes' scratch).
long long mr_radix_pass_scratch_words(long long n) { return pass_words(n); }
long long mr_radix_sort_scratch_words(long long n) {
  return kPasses * kMaxBuckets + kPasses * pass_words(n);
}

// int32 words of scratch for the plan of dest [batch, n] over nb buckets.
long long mr_radix_plan_scratch_words(long long n, int batch, int nb) {
  return plan_words(n, batch, nb);
}

// The exchange plan of dest [batch, n] (buckets [0, nb); other values
// clamp to nb - 1): rank [batch, n] int32, each row's stable index in
// its bucket, and totals [batch, nb] int32, the rows of each bucket.
// One memset of scratch (mr_radix_plan_scratch_words words), then one
// launch.  1 <= nb <= 256, batch <= 65535, n < 2^31.
int mr_radix_plan(const void* dest, long long n, int batch, int nb,
                  void* scratch, void* rank, void* totals, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || batch <= 0 || batch > 65535 ||
      nb < 1 || nb > kMaxBuckets)
    return cudaErrorInvalidValue;
  const long long tiles = plan_tiles(n);
  if (tiles * batch > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* s = static_cast<int32_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      s, 0, sizeof(int32_t) * plan_words(n, batch, nb), st);
  if (err != cudaSuccess) return err;
  plan_kernel<<<static_cast<int>(tiles * batch), kThreads, 0, st>>>(
      static_cast<const int32_t*>(dest), n, nb, static_cast<int>(tiles), s,
      reinterpret_cast<uint64_t*>(s + kCounterWords),
      static_cast<int32_t*>(rank), static_cast<int32_t*>(totals));
  return cudaGetLastError();
}

// The upfront table [8, 256] int32 of n rows (k1, k2): zeroed, then
// counted.
int mr_radix_upfront(const void* k1, const void* k2, long long n,
                     void* table, void* stream) {
  if (n <= 0 || n >= (1LL << 30)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<int32_t*>(table);
  cudaError_t err =
      cudaMemsetAsync(t, 0, sizeof(int32_t) * kPasses * kMaxBuckets, st);
  if (err != cudaSuccess) return err;
  return launch_upfront(k1, k2, n, t, st);
}

// One onesweep pass over n rows by the 8-bit digit at `shift` of k1
// (lane 0) or k2 (lane 1), whose digit counts are counts [256]: (k1, k2,
// perm) -> (o1, o2, operm), out of place.  perm may be null (the
// identity).  scratch holds mr_radix_pass_scratch_words(n) words and is
// zeroed here.
int mr_radix_onesweep(const void* k1, const void* k2, const void* perm,
                      long long n, int lane, int shift, const void* counts,
                      void* scratch, void* o1, void* o2, void* operm,
                      void* stream) {
  if (n <= 0 || n >= (1LL << 30) || (lane != 0 && lane != 1) || shift < 0 ||
      shift > 24)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* s = static_cast<int32_t*>(scratch);
  cudaError_t err =
      cudaMemsetAsync(s, 0, sizeof(int32_t) * pass_words(n), st);
  if (err != cudaSuccess) return err;
  return launch_onesweep(k1, k2, perm, n, lane, shift,
                         static_cast<const int32_t*>(counts), s, o1, o2,
                         operm, st);
}

// The whole sort of n rows by (k1 hi, k2 lo): one memset of scratch
// (mr_radix_sort_scratch_words(n) words), the upfront histogram, then 8
// onesweep passes alternating (a1, a2, ap) and (b1, b2, bp); the sorted
// (k1, k2, perm) end in the b set.
int mr_radix_sort_pairs(const void* k1, const void* k2, long long n,
                        void* a1, void* a2, void* ap, void* b1, void* b2,
                        void* bp, void* scratch, void* stream) {
  if (n <= 0 || n >= (1LL << 30)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* table = static_cast<int32_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      table, 0, sizeof(int32_t) * mr_radix_sort_scratch_words(n), st);
  if (err != cudaSuccess) return err;
  err = launch_upfront(k1, k2, n, table, st);
  if (err != cudaSuccess) return err;
  const void* in[3] = {k1, k2, nullptr};
  void* sets[2][3] = {{a1, a2, ap}, {b1, b2, bp}};
  int32_t* pass_scratch = table + kPasses * kMaxBuckets;
  for (int p = 0; p < kPasses; ++p) {
    void** out = sets[p % 2];
    // passes 0-3 take k2's digits, 4-7 k1's: LSD over the 64-bit key
    err = launch_onesweep(in[0], in[1], in[2], n, p < 4 ? 1 : 0,
                          8 * (p % 4), table + p * kMaxBuckets,
                          pass_scratch + p * pass_words(n), out[0], out[1],
                          out[2], st);
    if (err != cudaSuccess) return err;
    for (int j = 0; j < 3; ++j) in[j] = out[j];
  }
  return cudaSuccess;
}

}  // extern "C"
