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
// is a running max; together they are one monoid (TokOp), scanned in one
// pass with a decoupled look-back (scan.cuh).
//
// Bound on the card: memory.  Per byte it reads 1 byte and writes
// 4*lanes + 1 + 4 + 4 bytes (17 at two lanes); the scan arithmetic is a
// few integer ops per byte and lane.  The stores are 94% of the bytes, so
// the design is about them and about launches:
//   - one launch a call (plus the memset of the look-back records inside
//     the C entry, so a CUDA-graph replay starts clean), in place of
//     tile sums, a one-block scan of them and a second read of the tile;
//   - each CTA takes its tile id from an atomic counter and copies its
//     bytes into shared memory with 16-byte cp.async copies, with the
//     byte on each side, and classifies them there: each byte is read
//     from device memory once;
//   - each thread folds kItems consecutive bytes and the block scans the
//     folds; the tile's carry comes by decoupled look-back (scan.cuh).  A
//     tile that holds a whitespace byte and a word start is absorbing
//     (every hash lane's m is 0, and its start max exceeds every earlier
//     position), so it publishes its inclusive prefix at once: on text a
//     walk is one step.  A chunk without whitespace, or a whitespace run
//     longer than a tile, walks the ordinary chain;
//   - keys and start are staged in shared memory in position order and
//     stored with 16-byte stores, neighbouring threads on neighbouring
//     addresses (a thread storing its own 8 positions put the 32
//     addresses of a warp store 32-64 bytes apart); length and is_end are
//     made from the staged start and bytes as they are stored, so they
//     take no shared memory and no registers before;
//   - a CTA's fixed latencies (tile id, copy, block scan, look-back) are
//     hidden only by other CTAs, so the kernel is held to 64 registers a
//     thread for 4 CTAs an SM.
// PERF.md (PR 7) has the tile A/B and where the time goes.
#include <climits>

#include "scan.cuh"

#ifndef MR_TOKENIZE_TILE
#define MR_TOKENIZE_TILE 2048
#endif

// a named namespace, so profiles tell the two files' kernels apart
namespace mr_tokenize_kernels {

constexpr int kThreads = 256;
constexpr int kTile = MR_TOKENIZE_TILE;  // bytes a CTA
constexpr int kItems = kTile / kThreads;  // consecutive bytes a thread
static_assert(kTile % kThreads == 0 && kItems % 4 == 0 && kItems <= 32,
              "a tile is 1,024 to 8,192 bytes");
// bytes of shared memory before and after the tile's bytes (the byte on
// each side of the tile is the nearest one)
constexpr int kHalo = 16;
// CTAs an SM must hold (__launch_bounds__: 64 registers a thread)
constexpr int kMinBlocks = 4;

__device__ __forceinline__ bool is_space(uint32_t b) {
  return b == 32u || b - 9u < 5u;  // space, \t \n \v \f \r
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
  // m == 0 in every lane drops what came before; a start in the span
  // exceeds every earlier position
  __device__ bool absorbing(const T& t) const {
    bool zero = true;
#pragma unroll
    for (int l = 0; l < NL; ++l) zero = zero && t.m[l] == 0u;
    return zero && t.smax != INT_MIN;
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

// Dynamic shared memory: the staged keys [kTile][NL] and start [kTile]
// int32, then the bytes [kHalo + kTile + kHalo].  length and is_end are
// made from those while they are stored.
template <int NL>
constexpr int stage_bytes() {
  return kTile * (4 * NL + 4) + kHalo + kTile + kHalo;
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
}

// is_end of 4 bytes packed in `w` (0/1 a byte), `next` the byte after
// them: a word byte followed by whitespace.
__device__ __forceinline__ uint32_t end_flags(uint32_t w, uint32_t next) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t b = (w >> (8 * k)) & 0xffu;
    const uint32_t nb = k < 3 ? (w >> (8 * k + 8)) & 0xffu : next;
    if (!is_space(b) && is_space(nb)) out |= 1u << (8 * k);
  }
  return out;
}

// The tile's start and length (p - start + 1) from the staged start, and
// its is_end from the staged bytes (tile_s[rows] is the byte after the
// last row), with 16-byte stores from consecutive threads.
__device__ __forceinline__ void store_rows(const int32_t* start_s,
                                           const uint8_t* tile_s, int base,
                                           int rows, bool vec,
                                           int32_t* start, int32_t* length,
                                           uint8_t* is_end) {
  const int nvec = vec ? rows / 4 : 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int4 st = reinterpret_cast<const int4*>(start_s)[i];
    const int p = base + 4 * i + 1;
    reinterpret_cast<int4*>(start)[i] = st;
    reinterpret_cast<int4*>(length)[i] =
        make_int4(p - st.x, p + 1 - st.y, p + 2 - st.z, p + 3 - st.w);
  }
  for (int i = 4 * nvec + threadIdx.x; i < rows; i += kThreads) {
    start[i] = start_s[i];
    length[i] = base + i - start_s[i] + 1;
  }
  const int nend = vec ? rows / 16 : 0;
  for (int i = threadIdx.x; i < nend; i += kThreads) {
    const uint4 b = reinterpret_cast<const uint4*>(tile_s)[i];
    reinterpret_cast<uint4*>(is_end)[i] = make_uint4(
        end_flags(b.x, b.y & 0xffu), end_flags(b.y, b.z & 0xffu),
        end_flags(b.z, b.w & 0xffu), end_flags(b.w, tile_s[16 * i + 16]));
  }
  for (int i = 16 * nend + threadIdx.x; i < rows; i += kThreads)
    is_end[i] = !is_space(tile_s[i]) && is_space(tile_s[i + 1]) ? 1 : 0;
}

// One tile of kTile bytes a CTA, in tile-id order from lb.counter.
template <int NL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    tokenize_kernel(const uint8_t* bytes, int n, Mults<NL> a,
                    mr::LookBack<typename TokOp<NL>::T> lb, bool vec,
                    int32_t* keys, uint8_t* is_end, int32_t* start,
                    int32_t* length) {
  using T = typename TokOp<NL>::T;
  extern __shared__ __align__(16) uint8_t smem[];
  auto* keys_s = reinterpret_cast<int32_t*>(smem);
  int32_t* start_s = keys_s + kTile * NL;
  uint8_t* tile_s = reinterpret_cast<uint8_t*>(start_s + kTile) + kHalo;
  __shared__ T scan[32];
  __shared__ T carry;
  __shared__ int tile_id;
  const TokOp<NL> op{};
  if (threadIdx.x == 0) tile_id = atomicAdd(lb.counter, 1);
  __syncthreads();
  const int tile = tile_id;
  const int base = tile * kTile;
  const int rows = min(n - base, kTile);
  // the tile's bytes (whitespace past n) and the byte on each side
  mr::load_tile(tile_s, bytes + base, rows, kTile, ' ', vec);
  if (threadIdx.x == 0) tile_s[-1] = base > 0 ? bytes[base - 1] : ' ';
  if (threadIdx.x == kThreads - 1)
    tile_s[kTile] = kTile < n - base ? bytes[base + kTile] : ' ';
  mr::load_wait();
  __syncthreads();

  // this thread's kItems bytes, classified, and their fold
  const int first = threadIdx.x * kItems;
  uint32_t w[kItems / 4];
#pragma unroll
  for (int k = 0; k < kItems / 4; ++k)
    w[k] = reinterpret_cast<const uint32_t*>(tile_s + first)[k];
  const bool space_before = is_space(tile_s[first - 1]);
  T agg = op.identity();
  bool prev_space = space_before;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t b = byte_of(w, j);
    const bool word = !is_space(b);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const uint32_t m = word ? a.a[l] : 0u;
      agg.m[l] *= m;
      agg.c[l] = agg.c[l] * m + (word ? b + 1u : 0u);
    }
    if (word && prev_space) agg.smax = base + first + j;
    prev_space = !word;
  }
  T total;
  const T excl = mr::block_exclusive(op, agg, scan, &total);
  if (threadIdx.x < 32) mr::tile_carry(op, lb, tile, total, &carry);
  __syncthreads();

  // rescan from the carry (the hash before the chunk is 0, so the
  // carried hash IS the composed map's c) and stage keys and start
  const T run = op.combine(carry, excl);
  uint32_t h[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) h[l] = run.c[l];
  int32_t s = max(run.smax, -1);
  prev_space = space_before;
#pragma unroll
  for (int g = 0; g < kItems; g += 4) {  // 4 bytes, then their stores
    uint32_t kw[4 * NL], sw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = byte_of(w, g + k);
      const bool word = !is_space(b);
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        h[l] = word ? h[l] * a.a[l] + b + 1u : 0u;
        kw[k * NL + l] = h[l];
      }
      if (word && prev_space) s = base + first + g + k;
      sw[k] = static_cast<uint32_t>(s);
      prev_space = !word;
    }
    mr::stage_words<4 * NL>(keys_s + (first + g) * NL, kw);
    mr::stage_words<4>(start_s + first + g, sw);
  }
  __syncthreads();
  const size_t at = static_cast<size_t>(base);
  mr::store_tile(reinterpret_cast<uint8_t*>(keys + at * NL),
                 reinterpret_cast<const uint8_t*>(keys_s), rows * NL * 4,
                 vec);
  store_rows(start_s, tile_s, base, rows, vec, start + at, length + at,
             is_end + at);
}

inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int NL>
size_t scratch_bytes(int n) {
  return mr::lookback_bytes<typename TokOp<NL>::T>(num_tiles(n));
}

template <int NL>
int launch(const uint8_t* bytes, int n, const uint32_t* mults,
           int32_t* keys, uint8_t* is_end, int32_t* start, int32_t* length,
           void* scratch, cudaStream_t stream) {
  using T = typename TokOp<NL>::T;
  Mults<NL> a;
  for (int l = 0; l < NL; ++l) a.a[l] = mults[l];
  const int tiles = num_tiles(n);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, mr::lookback_bytes<T>(tiles), stream);
  if (err != cudaSuccess) return err;
  constexpr int smem = stage_bytes<NL>();
  static std::atomic<unsigned long long> smem_set{0};
  err = mr::allow_smem(tokenize_kernel<NL>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(bytes) && aligned16(keys) &&
                   aligned16(is_end) && aligned16(start) &&
                   aligned16(length);
  tokenize_kernel<NL><<<tiles, kThreads, smem, stream>>>(
      bytes, n, a, mr::lookback_at<T>(scratch), vec, keys, is_end,
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

// Tokenize 0 < n < 2^30 bytes.  keys is [n, n_lanes] int32 (uint32 bit
// patterns), is_end [n] bytes of 0/1, start and length [n] int32; scratch
// holds mr_tokenize_scratch_bytes(n, n_lanes) bytes, and its flags are
// zeroed here.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported lane count or n).
int mr_tokenize(const void* bytes, int n, int n_lanes, uint32_t a0,
                uint32_t a1, uint32_t a2, void* keys, void* is_end,
                void* start, void* length, void* scratch, void* stream) {
  if (n <= 0 || n >= (1 << 30)) return cudaErrorInvalidValue;
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
