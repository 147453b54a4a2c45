// Flash attention for Hopper (sm_90a): the forward pass and the two
// backward passes, bf16 or fp16 operands with f32 accumulation.
//
// Replaces: mapreduce_tpu/ops/flash_attention.py:_fwd_kernel (flash_fwd),
// _dq_kernel (flash_dq) and _dkv_kernel (flash_dkv), the Pallas TPU
// kernels behind flash_attention_lse's custom_vjp.
//
// What they compute, on [B, H, T, D] tensors whose q is already scaled by
// 1/sqrt(D) and rounded back to the input type (q^, done by the caller),
// with s = q^ . k^T masked to -1e30 above the diagonal when causal
// (column > row, in absolute positions, so Tq != Tk is allowed):
//   flash_fwd  out = softmax(s) . v (p rounded to v's type before the
//              product), lse = m + log(max(den, 1e-30)), by online softmax
//              over K/V tiles: (m, den, acc) live in registers.
//   flash_dq   p = exp(s - lse), ds = p * (do . v^T - delta),
//              dq = scale * (ds . k), ds rounded to k's type.
//   flash_dkv  dv = p^T . do, dk = ds^T . q^ (no scale: q^ carries it).
// delta = rowsum(do * out) - dlse comes from the caller (torch).
//
// Bound on the card: the tensor cores, for all three.  At the transformer
// slice's shape (B*H = 32, T = 2048, D = 128, causal) the forward does
// 4 * D FLOPs for each (query, key) pair the mask keeps, 34.4 GFLOP,
// against 4 * B*H * T * D * 2 bytes of q, k, v and out: some 500 FLOP per
// byte, well above the card's ~295 bf16 FLOP per byte of device memory.
// dQ and dK/dV do 1.5x and 2x the forward's FLOPs on 1.25x and 1.5x its
// bytes.
//
// Grid.  The TPU runs its grid in order and carries state across the KV
// (or Q) axis in VMEM scratch.  Here a CTA owns one (b*h, q tile) for
// flash_fwd and flash_dq and loops over the K/V tiles itself, and one CTA
// owns one (b*h, kv tile) for flash_dkv and loops over the Q tiles, so
// every output tile has a single writer and no atomics are needed.
// Causal tiles wholly above the diagonal are never visited (the loop
// bounds), and only tiles that cross the diagonal, or hold the ragged end
// of T, take the mask.  Rows past T are zero-filled in shared memory and
// never stored, so any T >= 1 works.  Every row's first K/V tile holds
// its column 0, so its running max is finite before any masked tile.
//
// All three: warpgroup MMA fed by TMA (hopper.cuh).  A CTA is two
// warpgroups (256 threads), each issuing 64-row wgmmas, so the tensor cores
// see m64n128 / m64n64 products read straight from shared memory.
//   flash_fwd: 128 query rows against K/V tiles of 128 keys.  S = q^ . k^T
//   is an SS wgmma (q^ and k K-major, their natural [row][d] layout); P is
//   rounded to the element type in registers, where the accumulator's
//   layout already is the A fragment's, and O += P . V is an RS wgmma with
//   V read MN-major through the transpose bit.  Grid order: the last Q
//   tiles (the most K/V tiles under the causal mask) start first, so the
//   heavy CTAs do not form the tail, within groups of heads whose K and V
//   fit in L2 together (cta_tile), so the CTAs in flight read K/V from L2.
//   flash_dq: the forward's tiles and grid order.  S = q^ . k^T and dP =
//   dO . v^T are SS wgmmas (one commit group), p and ds are computed in
//   registers and ds rounded there, and dQ += dS . K is an RS wgmma
//   reading the same K tile MN-major; dQ (64 x D a warpgroup) stays in
//   registers, 192 f32 a thread at D = 128 with S and dP.  lse and delta
//   are read once: each thread owns two rows for the whole CTA.  A
//   warpgroup whose rows all lie past Tq skips the products.
//   flash_dkv: 128 keys against Q tiles of 64 rows.  S^T = k . q^T and
//   dP^T = v . dO^T are SS wgmmas, dV += P^T . dO and dK += dS^T . q^ RS
//   wgmmas (dO and q^ MN-major); dK and dV for 64 x D stay in registers
//   per warpgroup (192 f32 a thread at D = 128 with S^T and dP^T).  Grid
//   order: the first key tiles (the most Q tiles under the mask) first,
//   by groups of heads as above.
//   A warpgroup skips a causal Q tile that lies wholly before its keys.
//   Copies: TMA with the 128-byte swizzle the wgmma descriptors read, from
//   3-D maps over [B*H, T, D] (rows past T read as zeros, not as the next
//   head's rows), into a ring of kStages stages under mbarriers.  Thread 0
//   issues the loads of tile j + 1 once every warp has released that
//   stage, while both warpgroups compute on tile j.  No producer warp:
//   with 256 threads a thread may hold 255 registers, which dK/dV needs
//   without setmaxnreg; one more warp would cap every thread at 224.  lse
//   and delta of a dK/dV Q tile come by a 1-D TMA over the flat [B*H, ld]
//   rows.  A TMA box must start on 16 bytes, so ld is T rounded up to a
//   multiple of 4 (the wrapper pads the rows where T is not); entries past
//   a row's T fall on masked columns.  exp is exp2 with a log2(e)
//   pre-scale.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace mr_flash_kernels {

using namespace mr_hopper;

constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;  // as the TPU kernel: exp stays NaN-free
constexpr float kDenFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kRowsFwd = 128;    // query rows of a forward CTA, 64 a warpgroup
constexpr int kKeysFwd = 128;    // keys of a forward K/V tile
constexpr int kRowsDq = 128;     // query rows of a dQ CTA, 64 a warpgroup
constexpr int kKeysDq = 128;     // keys of a dQ K/V tile
constexpr int kKeysDkv = 128;    // keys of a dK/dV CTA, 64 a warpgroup
constexpr int kRowsDkv = 64;     // query rows of a dK/dV Q tile
constexpr int kStages = 2;       // K/V ring (forward, dQ), Q ring (dK/dV)
constexpr int kWgThreads = 256;  // two consumer warpgroups
constexpr int kWgWarps = kWgThreads / 32;
constexpr uint32_t kHalfRow = 128;  // bytes of a row of a 64-column half
// of the card's 50 MB L2, what the CTAs in flight may stream: the K/V (or
// q^ and dO) of a group of heads
constexpr long long kL2Budget = 32ll << 20;
constexpr float kLog2e = 1.4426950408889634f;

struct Bf16 {
  static constexpr bool kFp16 = false;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // (lo, hi) rounded to nearest, lo (the lower column) in the low half
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

struct Fp16 {
  static constexpr bool kFp16 = true;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// The dynamic shared memory, its start rounded up to the 1024 bytes that
// the 128-byte swizzle repeats over (the launch asks for 1 KB more).
__device__ __forceinline__ uint8_t* swizzle_smem() {
  extern __shared__ uint8_t smem_tma[];
  return smem_tma + ((1024u - (smem_addr(smem_tma) & 1023u)) & 1023u);
}

// Descriptor offset (16-byte units) of the k16 step kk of a K-major
// operand whose 64-column halves lie `half` bytes apart.
__device__ __forceinline__ uint64_t kmajor_step(int kk, uint32_t half) {
  return ((kk / 4) * half + (kk % 4) * 32) >> 4;
}

// ... and of an MN-major one: 16 rows of 128 bytes further down.
__device__ __forceinline__ uint64_t mnmajor_step(int kk) {
  return (kk * 16 * kHalfRow) >> 4;
}

// The (b*h, tile rank) this CTA owns.  Heads go in groups of `group`
// (sized so that the group's streamed tensors fit in L2) one group after
// the other; within a group, tile rank 0 (the caller's heaviest tile) of
// every head first, then rank 1, and so on.
__device__ __forceinline__ void cta_tile(int n_bh, int n_tiles, int group,
                                         int* bh, int* rank) {
  const int idx = blockIdx.x;
  const int g0 = idx / (group * n_tiles) * group;
  const int size = min(group, n_bh - g0);
  const int within = idx - g0 * n_tiles;
  *bh = g0 + within % size;
  *rank = within / size;
}

// Rows [row0, row0 + box rows) of head bh, all DM columns, as DM / 64
// boxes of the 3-D map, one per half.
template <int DM>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int bh,
                                          uint32_t half) {
#pragma unroll
  for (int h = 0; h < DM / 64; ++h)
    tma_load_3d(dst + h * half, map, bar, h * 64, row0, bh);
}

// The A operand of the k16 step kk from a [64, 16 * KS] accumulator,
// rounded to E: accumulator columns 16kk..16kk + 15.
template <class E, int KS>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KS][4],
                                         const float (&c)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = E::pack2(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = E::pack2(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = E::pack2(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = E::pack2(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// One row (g, or g + 8 when hr = 1) of a warp's [16, DM] accumulator
// rows, each value through f and rounded to E, to dst (columns below D
// only).
template <class E, int DM, class F>
__device__ __forceinline__ void store_acc_row(uint16_t* dst,
                                              const float (&acc)[DM / 2],
                                              int hr, int D, int t, F f) {
#pragma unroll
  for (int i = 0; i < DM / 8; ++i) {
    if (i * 8 < D)
      *reinterpret_cast<uint32_t*>(dst + i * 8 + 2 * t) = E::pack2(
          f(acc[4 * i + 2 * hr]), f(acc[4 * i + 2 * hr + 1]));
  }
}

// The CTA's barriers: `once` for the tiles it loads once (one arrival,
// with their bytes), and for each stage s of the ring full[s] (the
// stage's tiles landed) and empty[s] (all kWgWarps warps are done with
// them).  Ends in __syncthreads, so every thread sees them initialised.
__device__ __forceinline__ void init_barriers(uint64_t* once, uint64_t* full,
                                              uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Thread 0's part of the K/V ring of the forward and dQ kernels: keys
// [j * kKeys, (j + 1) * kKeys) of head bh, from K and from V, into stage
// j % kStages, once every warp has released that stage (its tile j -
// kStages).
template <int DM, int kKeys>
__device__ __forceinline__ void load_kv(uint8_t* sK, uint8_t* sV,
                                        const CUtensorMap* map_k,
                                        const CUtensorMap* map_v,
                                        uint64_t* full, uint64_t* empty,
                                        int j, int bh) {
  constexpr uint32_t kBytes = kKeys * DM * 2, kHalf = kKeys * kHalfRow;
  const int s = j % kStages;
  if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
  mbar_expect_tx(&full[s], 2 * kBytes);
  load_rows<DM>(sK + s * kBytes, map_k, &full[s], j * kKeys, bh, kHalf);
  load_rows<DM>(sV + s * kBytes, map_v, &full[s], j * kKeys, bh, kHalf);
}

template <int DM>
constexpr size_t fwd_smem() {
  return 1024 + static_cast<size_t>(kRowsFwd + 2 * kStages * kKeysFwd) * DM *
                    2 + (1 + 2 * kStages) * sizeof(uint64_t);
}

template <int DM>
constexpr size_t dq_smem() {
  return 1024 + static_cast<size_t>(2 * kRowsDq + 2 * kStages * kKeysDq) *
                    DM * 2 + (1 + 2 * kStages) * sizeof(uint64_t);
}

template <int DM>
constexpr size_t dkv_smem() {
  return 1024 + static_cast<size_t>(2 * kKeysDkv + 2 * kStages * kRowsDkv) *
                    DM * 2 + 2 * kStages * kRowsDkv * sizeof(float) +
         (1 + 2 * kStages) * sizeof(uint64_t);
}

// -- forward: grid (q tiles x B*H), heaviest causal tiles first ------------

template <class E, int DM>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               uint16_t* __restrict__ out, float* __restrict__ lse, int n_bh,
               int Tq, int Tk, int D, int causal, int group) {
  constexpr uint32_t kQBytes = kRowsFwd * DM * 2, kQHalf = kRowsFwd * kHalfRow;
  constexpr uint32_t kKVBytes = kKeysFwd * DM * 2,
                     kKVHalf = kKeysFwd * kHalfRow;
  uint8_t* sQ = swizzle_smem();
  uint8_t* sK = sQ + kQBytes;  // stage s at sK + s * kKVBytes
  uint8_t* sV = sK + kStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kKVBytes);
  uint64_t* full = q_full + 1;      // [kStages]: the stage's K and V landed
  uint64_t* empty = full + kStages;  // [kStages]: every warp is done with it

  const int n_q = (Tq + kRowsFwd - 1) / kRowsFwd;
  int bh, rank;
  cta_tile(n_bh, n_q, group, &bh, &rank);
  const int q0 = (n_q - 1 - rank) * kRowsFwd;  // the last Q tiles first
  const int n_kv = (Tk + kKeysFwd - 1) / kKeysFwd;
  const int last_row = min(q0 + kRowsFwd, Tq) - 1;
  const int kv_end = causal ? min(n_kv, last_row / kKeysFwd + 1) : n_kv;
  const int tid = threadIdx.x;

  init_barriers(q_full, full, empty);
  if (tid == 0) {
    mbar_expect_tx(q_full, kQBytes);
    load_rows<DM>(sQ, &map_q, q_full, q0, bh, kQHalf);
    load_kv<DM, kKeysFwd>(sK, sV, &map_k, &map_v, full, empty, 0, bh);
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + wg * 64 + warp * 16 + g;  // and row + 8
  const uint64_t dq = desc_sw128(sQ + wg * 64 * kHalfRow, 0, 1024);
  float o[DM / 2], sc[kKeysFwd / 2];
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeysFwd / 2; ++i) sc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int j = 0; j < kv_end; ++j) {
    const int s = j % kStages;
    // thread 0 refills the other stage once every warp has released it
    if (tid == 0 && j + 1 < kv_end)
      load_kv<DM, kKeysFwd>(sK, sV, &map_k, &map_v, full, empty, j + 1, bh);
    __syncwarp();
    mbar_wait(&full[s], (j / kStages) & 1);

    // S = q^ . k^T, this warpgroup's [64, 128] tile
    const uint64_t dk = desc_sw128(sK + s * kKVBytes, 0, 1024);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk)
      wgmma_ss<E::kFp16, kKeysFwd>(sc, dq + kmajor_step(kk, kQHalf),
                                   dk + kmajor_step(kk, kKVHalf), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const int k0 = j * kKeysFwd;
    if ((causal && k0 + kKeysFwd - 1 > q0) || k0 + kKeysFwd > Tk) {
#pragma unroll
      for (int i = 0; i < kKeysFwd / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + 8 * (e >> 1);
          const int c = k0 + i * 8 + 2 * t + (e & 1);
          if (c >= Tk || (causal && c > r)) sc[4 * i + e] = kNegInf;
        }
      }
    }
    // online softmax; exp(x) as exp2(x * log2 e)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kKeysFwd / 8; ++i)
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hr], sc[4 * i + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float corr = exp2f((m[hr] - m_new) * kLog2e);
      const float mb = m_new * kLog2e;
      m[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeysFwd / 8; ++i) {
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = exp2f(fmaf(sc[4 * i + e], kLog2e, -mb));
          sc[4 * i + e] = p;  // masked columns -> 0
          sum += p;
        }
      }
      l[hr] = l[hr] * corr + sum;  // this thread's columns; summed at the end
#pragma unroll
      for (int i = 0; i < DM / 8; ++i) {
        o[4 * i + 2 * hr] *= corr;
        o[4 * i + 2 * hr + 1] *= corr;
      }
    }

    // O += P . V, P rounded to E in registers
    uint32_t a[kKeysFwd / 16][4];
    acc_to_a<E, kKeysFwd / 16>(a, sc);
    const uint64_t dv = desc_sw128(sV + s * kKVBytes, kKVHalf, 1024);
#pragma unroll
    for (int kk = 0; kk < kKeysFwd / 16; ++kk) fence_regs(a[kk]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeysFwd / 16; ++kk)
      wgmma_rs<E::kFp16, DM>(o, a[kk], dv + mnmajor_step(kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float den = l[hr] + __shfl_xor_sync(kFull, l[hr], 1);
    den += __shfl_xor_sync(kFull, den, 2);
    den = fmaxf(den, kDenFloor);
    const int r = row + 8 * hr;
    if (r < Tq) {
      const size_t at = static_cast<size_t>(bh) * Tq + r;
      store_acc_row<E, DM>(out + at * D, o, hr, D, t,
                           [den](float x) { return x / den; });
      if (t == 0) lse[at] = m[hr] + logf(den);
    }
  }
}

// -- backward, dQ: grid (q tiles x B*H), heaviest causal tiles first ---------

template <class E, int DM>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              uint16_t* __restrict__ dq, int n_bh, int Tq, int Tk, int D,
              int causal, float scale, int group) {
  constexpr uint32_t kQBytes = kRowsDq * DM * 2, kQHalf = kRowsDq * kHalfRow;
  constexpr uint32_t kKVBytes = kKeysDq * DM * 2,
                     kKVHalf = kKeysDq * kHalfRow;
  uint8_t* sQ = swizzle_smem();
  uint8_t* sO = sQ + kQBytes;  // dO
  uint8_t* sK = sO + kQBytes;  // stage s at sK + s * kKVBytes
  uint8_t* sV = sK + kStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int n_q = (Tq + kRowsDq - 1) / kRowsDq;
  int bh, rank;
  cta_tile(n_bh, n_q, group, &bh, &rank);
  const int q0 = (n_q - 1 - rank) * kRowsDq;  // the last Q tiles first
  const int n_kv = (Tk + kKeysDq - 1) / kKeysDq;
  const int last_row = min(q0 + kRowsDq, Tq) - 1;
  const int kv_end = causal ? min(n_kv, last_row / kKeysDq + 1) : n_kv;
  const int tid = threadIdx.x;

  init_barriers(q_full, full, empty);
  if (tid == 0) {
    mbar_expect_tx(q_full, 2 * kQBytes);
    load_rows<DM>(sQ, &map_q, q_full, q0, bh, kQHalf);
    load_rows<DM>(sO, &map_do, q_full, q0, bh, kQHalf);
    load_kv<DM, kKeysDq>(sK, sV, &map_k, &map_v, full, empty, 0, bh);
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + wg * 64 + warp * 16 + g;  // and row + 8
  // a warpgroup whose rows all lie past Tq computes nothing; under the
  // mask both warpgroups end on the CTA's last tile, as a key tile is as
  // wide as the CTA's rows
  static_assert(kKeysDq == kRowsDq, "dq: one causal end per CTA");
  const bool active = q0 + wg * 64 < Tq;
  float lr[2], dr[2];  // lse and delta of rows row and row + 8
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    const size_t at = static_cast<size_t>(bh) * Tq + r;
    lr[hr] = r < Tq ? lse[at] : 0.f;
    dr[hr] = r < Tq ? delta[at] : 0.f;
  }
  const uint64_t aq = desc_sw128(sQ + wg * 64 * kHalfRow, 0, 1024);
  const uint64_t ao = desc_sw128(sO + wg * 64 * kHalfRow, 0, 1024);
  float acc[DM / 2], sc[kKeysDq / 2], dp[kKeysDq / 2];
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeysDq / 2; ++i) sc[i] = dp[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int j = 0; j < kv_end; ++j) {
    const int s = j % kStages;
    // thread 0 refills the other stage once every warp has released it
    if (tid == 0 && j + 1 < kv_end)
      load_kv<DM, kKeysDq>(sK, sV, &map_k, &map_v, full, empty, j + 1, bh);
    __syncwarp();
    mbar_wait(&full[s], (j / kStages) & 1);
    if (active) {
      uint8_t* kt = sK + s * kKVBytes;
      // S = q^ . k^T and dP = dO . v^T, this warpgroup's [64, 128] tiles
      const uint64_t bk = desc_sw128(kt, 0, 1024);
      const uint64_t bv = desc_sw128(sV + s * kKVBytes, 0, 1024);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)
        wgmma_ss<E::kFp16, kKeysDq>(sc, aq + kmajor_step(kk, kQHalf),
                                    bk + kmajor_step(kk, kKVHalf), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)
        wgmma_ss<E::kFp16, kKeysDq>(dp, ao + kmajor_step(kk, kQHalf),
                                    bv + kmajor_step(kk, kKVHalf), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // p = exp(s - lse) on the masked scores, ds = p * (dp - delta), f32
      const int k0 = j * kKeysDq;
      const bool masked =
          (causal && k0 + kKeysDq - 1 > q0) || k0 + kKeysDq > Tk;
#pragma unroll
      for (int i = 0; i < kKeysDq / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int c = k0 + i * 8 + 2 * t + (e & 1);
          float x = sc[4 * i + e];
          if (masked && (c >= Tk || (causal && c > row + 8 * hr)))
            x = kNegInf;
          const float p = exp2f((x - lr[hr]) * kLog2e);
          sc[4 * i + e] = p * (dp[4 * i + e] - dr[hr]);
        }
      }

      // dQ += dS . K, dS rounded to E, K read MN-major
      uint32_t a[kKeysDq / 16][4];
      acc_to_a<E, kKeysDq / 16>(a, sc);
      const uint64_t bk_t = desc_sw128(kt, kKVHalf, 1024);
#pragma unroll
      for (int kk = 0; kk < kKeysDq / 16; ++kk) fence_regs(a[kk]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeysDq / 16; ++kk)
        wgmma_rs<E::kFp16, DM>(acc, a[kk], bk_t + mnmajor_step(kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // dq = scale * acc, rounded once (the TPU kernel's (dq * scale).astype)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r < Tq)
      store_acc_row<E, DM>(dq + (static_cast<size_t>(bh) * Tq + r) * D, acc,
                           hr, D, t, [scale](float x) { return x * scale; });
  }
}

// -- backward, dK and dV: grid (kv tiles x B*H), low key tiles first --------

template <class E, int DM>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ CUtensorMap map_lse,
               const __grid_constant__ CUtensorMap map_delta,
               uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int n_bh,
               int Tq, int Tk, int D, int causal, int ld, int group) {
  constexpr uint32_t kKBytes = kKeysDkv * DM * 2, kKHalf = kKeysDkv * kHalfRow;
  constexpr uint32_t kQBytes = kRowsDkv * DM * 2, kQHalf = kRowsDkv * kHalfRow;
  constexpr uint32_t kStageTx = 2 * kQBytes + 2 * kRowsDkv * sizeof(float);
  uint8_t* sK = swizzle_smem();
  uint8_t* sV = sK + kKBytes;
  uint8_t* sQ = sV + kKBytes;           // stage s at sQ + s * kQBytes
  uint8_t* sO = sQ + kStages * kQBytes;  // dO, likewise
  float* sL = reinterpret_cast<float*>(sO + kStages * kQBytes);  // lse rows
  float* sD = sL + kStages * kRowsDkv;                            // delta rows
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sD + kStages * kRowsDkv);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  int bh, rank;
  cta_tile(n_bh, (Tk + kKeysDkv - 1) / kKeysDkv, group, &bh, &rank);
  const int k0 = rank * kKeysDkv;  // the first key tiles first
  const int n_qt = (Tq + kRowsDkv - 1) / kRowsDkv;
  // causal: Q tiles wholly before this key tile see none of it
  const int i0 = causal ? k0 / kRowsDkv : 0;
  const int tid = threadIdx.x;

  init_barriers(kv_full, full, empty);
  // Q tile i into stage s: q^, dO, and their lse and delta rows
  const CUtensorMap *mq = &map_q, *mo = &map_do;
  const CUtensorMap *ml = &map_lse, *md = &map_delta;
  auto load_q = [=](int i, int s) {
    mbar_expect_tx(&full[s], kStageTx);
    load_rows<DM>(sQ + s * kQBytes, mq, &full[s], i * kRowsDkv, bh, kQHalf);
    load_rows<DM>(sO + s * kQBytes, mo, &full[s], i * kRowsDkv, bh, kQHalf);
    tma_load_1d(sL + s * kRowsDkv, ml, &full[s], bh * ld + i * kRowsDkv);
    tma_load_1d(sD + s * kRowsDkv, md, &full[s], bh * ld + i * kRowsDkv);
  };
  if (tid == 0) {
    mbar_expect_tx(kv_full, 2 * kKBytes);
    load_rows<DM>(sK, &map_k, kv_full, k0, bh, kKHalf);
    load_rows<DM>(sV, &map_v, kv_full, k0, bh, kKHalf);
    if (i0 < n_qt) load_q(i0, 0);
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + wg * 64;             // this warpgroup's first key
  const int key = kw0 + warp * 16 + g;      // and key + 8
  const uint64_t da_k = desc_sw128(sK + wg * 64 * kHalfRow, 0, 1024);
  const uint64_t da_v = desc_sw128(sV + wg * 64 * kHalfRow, 0, 1024);
  float ak[DM / 2], av[DM / 2], st[kRowsDkv / 2], dpt[kRowsDkv / 2];
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) ak[i] = av[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsDkv / 2; ++i) st[i] = dpt[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int i = i0; i < n_qt; ++i) {
    const int j = i - i0, s = j % kStages;
    if (tid == 0 && i + 1 < n_qt) {
      const int s1 = (j + 1) % kStages;
      if (j + 1 >= kStages)
        mbar_wait(&empty[s1], ((j + 1) / kStages - 1) & 1);
      load_q(i + 1, s1);
    }
    __syncwarp();
    mbar_wait(&full[s], (j / kStages) & 1);
    const int q0 = i * kRowsDkv;
    // causal: skip a tile whose every query precedes this warpgroup's keys
    if (!causal || q0 + kRowsDkv - 1 >= kw0) {
      // S^T = k . q^T and dP^T = v . dO^T, [64 keys, 64 queries] each
      const uint64_t bq = desc_sw128(sQ + s * kQBytes, 0, 1024);
      const uint64_t bo = desc_sw128(sO + s * kQBytes, 0, 1024);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)
        wgmma_ss<E::kFp16, kRowsDkv>(st, da_k + kmajor_step(kk, kKHalf),
                                     bq + kmajor_step(kk, kQHalf), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk)
        wgmma_ss<E::kFp16, kRowsDkv>(dpt, da_v + kmajor_step(kk, kKHalf),
                                     bo + kmajor_step(kk, kQHalf), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // p = exp(s - lse), ds = p * (dp - delta), both transposed
      const float* lrow = sL + s * kRowsDkv;
      const float* drow = sD + s * kRowsDkv;
      const bool masked = (causal && kw0 + 63 > q0) || q0 + kRowsDkv > Tq;
#pragma unroll
      for (int n = 0; n < kRowsDkv / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);  // query, in the tile
          const int kr = key + 8 * (e >> 1);
          float x = st[4 * n + e];
          if (masked && (q0 + c >= Tq || (causal && kr > q0 + c)))
            x = kNegInf;
          const float p = exp2f((x - lrow[c]) * kLog2e);
          st[4 * n + e] = p;
          dpt[4 * n + e] = p * (dpt[4 * n + e] - drow[c]);
        }
      }

      // dV += P^T . dO and dK += dS^T . q^, P^T and dS^T rounded to E
      uint32_t ap[kRowsDkv / 16][4], as[kRowsDkv / 16][4];
      acc_to_a<E, kRowsDkv / 16>(ap, st);
      acc_to_a<E, kRowsDkv / 16>(as, dpt);
      const uint64_t bo_t = desc_sw128(sO + s * kQBytes, kQHalf, 1024);
      const uint64_t bq_t = desc_sw128(sQ + s * kQBytes, kQHalf, 1024);
#pragma unroll
      for (int kk = 0; kk < kRowsDkv / 16; ++kk) {
        fence_regs(ap[kk]);
        fence_regs(as[kk]);
      }
      fence_regs(av);
      fence_regs(ak);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRowsDkv / 16; ++kk)
        wgmma_rs<E::kFp16, DM>(av, ap[kk], bo_t + mnmajor_step(kk), 1);
#pragma unroll
      for (int kk = 0; kk < kRowsDkv / 16; ++kk)
        wgmma_rs<E::kFp16, DM>(ak, as[kk], bq_t + mnmajor_step(kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(av);
      fence_regs(ak);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = key + 8 * hr;
    if (r < Tk) {
      const size_t at = (static_cast<size_t>(bh) * Tk + r) * D;
      const auto same = [](float x) { return x; };
      store_acc_row<E, DM>(dk + at, ak, hr, D, t, same);
      store_acc_row<E, DM>(dv + at, av, hr, D, t, same);
    }
  }
}

// -- launches --------------------------------------------------------------------

// Opt a kernel in to its largest dynamic shared memory once.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

// Heads a group of CTAs walks together: as many as keep the two [T, d]
// tensors each CTA streams (k and v, or q^ and dO) within kL2Budget.
inline int head_group(int bh, int t, int d) {
  const long long per_head = 2ll * t * d * 2;
  return static_cast<int>(
      std::max(1ll, std::min<long long>(bh, kL2Budget / per_head)));
}

template <class E, int DM>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, int bh, int tq, int tk, int d, int causal,
                       cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!encode_rows(&mq, E::kTma, q, bh, tq, d, kRowsFwd) ||
      !encode_rows(&mk, E::kTma, k, bh, tk, d, kKeysFwd) ||
      !encode_rows(&mv, E::kTma, v, bh, tk, d, kKeysFwd))
    return cudaErrorInvalidValue;
  static bool attr = false;
  cudaError_t err = allow_smem(fwd_kernel<E, DM>, fwd_smem<DM>(), &attr);
  if (err != cudaSuccess) return err;
  const int n_q = (tq + kRowsFwd - 1) / kRowsFwd;
  fwd_kernel<E, DM><<<n_q * bh, kWgThreads, fwd_smem<DM>(), st>>>(
      mq, mk, mv, static_cast<uint16_t*>(out), static_cast<float*>(lse), bh,
      tq, tk, d, causal, head_group(bh, tk, d));
  return cudaGetLastError();
}

template <class E, int DM>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int tq, int tk, int d, int causal,
                      float scale, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mo;
  if (!encode_rows(&mq, E::kTma, q, bh, tq, d, kRowsDq) ||
      !encode_rows(&mk, E::kTma, k, bh, tk, d, kKeysDq) ||
      !encode_rows(&mv, E::kTma, v, bh, tk, d, kKeysDq) ||
      !encode_rows(&mo, E::kTma, dout, bh, tq, d, kRowsDq))
    return cudaErrorInvalidValue;
  static bool attr = false;
  cudaError_t err = allow_smem(dq_kernel<E, DM>, dq_smem<DM>(), &attr);
  if (err != cudaSuccess) return err;
  const int n_q = (tq + kRowsDq - 1) / kRowsDq;
  dq_kernel<E, DM><<<n_q * bh, kWgThreads, dq_smem<DM>(), st>>>(
      mq, mk, mv, mo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<uint16_t*>(dq), bh, tq,
      tk, d, causal, scale, head_group(bh, tk, d));
  return cudaGetLastError();
}

template <class E, int DM>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int tq, int tk, int d,
                       int causal, int ld, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mo, ml, md;
  if (!encode_rows(&mq, E::kTma, q, bh, tq, d, kRowsDkv) ||
      !encode_rows(&mk, E::kTma, k, bh, tk, d, kKeysDkv) ||
      !encode_rows(&mv, E::kTma, v, bh, tk, d, kKeysDkv) ||
      !encode_rows(&mo, E::kTma, dout, bh, tq, d, kRowsDkv) ||
      !encode_f32_vector(&ml, lse, static_cast<long long>(bh) * ld,
                         kRowsDkv) ||
      !encode_f32_vector(&md, delta, static_cast<long long>(bh) * ld,
                         kRowsDkv))
    return cudaErrorInvalidValue;
  static bool attr = false;
  cudaError_t err = allow_smem(dkv_kernel<E, DM>, dkv_smem<DM>(), &attr);
  if (err != cudaSuccess) return err;
  const int n_k = (tk + kKeysDkv - 1) / kKeysDkv;
  dkv_kernel<E, DM><<<n_k * bh, kWgThreads, dkv_smem<DM>(), st>>>(
      mq, mk, mv, mo, ml, md, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), bh, tq, tk, d, causal, ld,
      head_group(bh, tq, d));
  return cudaGetLastError();
}

// B*H*T stays below 2^31: TMA coordinates and the flat lse rows are int32.
inline bool bad_args(int bh, int tq, int tk, int d, int dtype) {
  return bh < 1 || bh > 65535 || tq < 1 || tk < 1 || d < 16 ||
         d > kMaxHeadDim || d % 16 != 0 || (dtype != 0 && dtype != 1) ||
         static_cast<long long>(bh) * tq >= (1ll << 31) ||
         static_cast<long long>(bh) * tk >= (1ll << 31);
}

// The instantiation for (dtype, head dim): 0 = bf16, 1 = fp16; head dims
// up to 64 take the 64-wide accumulators, the rest the 128-wide ones.
#define MR_FLASH_DISPATCH(launch, ...)                                \
  return dtype == 0 ? (d <= 64 ? launch<Bf16, 64>(__VA_ARGS__)        \
                               : launch<Bf16, kMaxHeadDim>(__VA_ARGS__)) \
                    : (d <= 64 ? launch<Fp16, 64>(__VA_ARGS__)        \
                               : launch<Fp16, kMaxHeadDim>(__VA_ARGS__))

}  // namespace mr_flash_kernels

using namespace mr_flash_kernels;

extern "C" {

// The tiles the kernels are built with (the Python side checks them
// against its own constants): forward (query rows, keys), dQ (query rows,
// keys), dK/dV (keys, query rows).  Returns how many it wrote.
int mr_flash_tiles(int* tiles) {
  const int t[6] = {kRowsFwd, kKeysFwd, kRowsDq, kKeysDq, kKeysDkv, kRowsDkv};
  for (int i = 0; i < 6; ++i) tiles[i] = t[i];
  return 6;
}

// out [bh, tq, d] and lse [bh, tq] f32 from q^ [bh, tq, d], k, v [bh, tk, d].
int mr_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, int bh, int tq, int tk, int d, int causal,
                 int dtype, void* stream) {
  if (bad_args(bh, tq, tk, d, dtype)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  MR_FLASH_DISPATCH(launch_fwd, q, k, v, out, lse, bh, tq, tk, d, causal, st);
}

// dq [bh, tq, d] = scale * (ds . k), from q^, k, v, dO, lse and delta
// ([bh, tq] f32 each).
int mr_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int bh, int tq,
                int tk, int d, int causal, float scale, int dtype,
                void* stream) {
  if (bad_args(bh, tq, tk, d, dtype)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  MR_FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                    causal, scale, st);
}

// dk, dv [bh, tk, d] from the same inputs, lse and delta here as [bh, ld]
// rows (ld >= tq, a multiple of 4: each row starts on 16 bytes).
int mr_flash_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int bh, int tq, int tk, int d,
                 int causal, int ld, int dtype, void* stream) {
  if (bad_args(bh, ld, tk, d, dtype) || ld < tq || ld % 4 != 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  MR_FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                    d, causal, ld, st);
}

}  // extern "C"
