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
// Grid.  The TPU runs its grid in order and carries state across the KV
// (or Q) axis in VMEM scratch.  Here one CTA owns one (b*h, q tile) for
// flash_fwd and flash_dq and loops over the K/V tiles itself, and one
// CTA owns one (b*h, kv tile) for flash_dkv and loops over the Q tiles,
// so every output tile has a single writer and no atomics are needed.
// Tiles are 64 x 64 (kBlock), fixed at compile time; four warps each own
// 16 rows of the CTA's tile.  Causal tiles wholly above the diagonal are
// never visited (the loop bounds), and only tiles that cross the
// diagonal, or hold the ragged end of T, take the mask.  Rows past T are
// zero-filled in shared memory and never stored, so any T >= 1 works.
//
// Products: mma.sync m16n8k16 (bf16 or fp16 in, f32 accumulate).  The
// operand tiles are staged in shared memory with rows padded by 8
// elements, which makes the fragment loads conflict-free; the softmax
// tile p (and ds) goes from the accumulator fragments straight into the
// A operand of the next product, never through memory.
//
// Bound on the card: the tensor cores.  At T = 2048, D = 128 the causal
// forward does 2*B*H*T^2*D FLOPs against 4*B*H*T*D*2 bytes of q, k, v,
// out (some 500 FLOP per byte), well above the card's ~295 bf16 FLOP per
// byte of device memory.  This first version uses mma.sync from scalar
// shared-memory loads with no copy/compute overlap; wgmma, TMA and
// pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mr_flash_kernels {

constexpr int kBlock = 64;             // rows of a Q tile and of a K/V tile
constexpr int kWarps = 4;              // each warp owns 16 rows of the tile
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;                // shared-memory row padding, elements
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;      // as the TPU kernel: exp stays NaN-free
constexpr float kDenFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

struct Bf16 {
  static __device__ __forceinline__ uint32_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  // c += a . b, one 16 x 8 x 16 step
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

struct Fp16 {
  static __device__ __forceinline__ uint32_t bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Two floats rounded to the element type, the lower column in the low half.
template <class E>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return E::bits(lo) | (E::bits(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16 x 16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16 x 8:  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16 x 8:  c0, c1 (g, 2t and 2t+1), c2, c3 (g+8, 2t and 2t+1)

// A from a row-major tile s[row * ld + col]: rows r0.., columns c0..
__device__ __forceinline__ void load_a(uint32_t* a, const uint16_t* s, int ld,
                                       int r0, int c0, int g, int t) {
  const uint16_t* p = s + (r0 + g) * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B from a tile stored [n][k] (B^T row-major): n0.., k0..
__device__ __forceinline__ void load_b_nk(uint32_t* b, const uint16_t* s,
                                          int ld, int n0, int k0, int g,
                                          int t) {
  const uint16_t* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B from a tile stored [k][n] (row-major): k0.., n0..
__device__ __forceinline__ void load_b_kn(uint32_t* b, const uint16_t* s,
                                          int ld, int k0, int n0, int g,
                                          int t) {
  const uint16_t* p = s + (k0 + 2 * t) * ld + n0 + g;
  b[0] = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[ld]) << 16);
  b[1] = static_cast<uint32_t>(p[8 * ld]) |
         (static_cast<uint32_t>(p[9 * ld]) << 16);
}

// The A operand of a k16 step from two C fragments (columns 16kk..16kk+15)
template <class E>
__device__ __forceinline__ void frag_to_a(uint32_t* a, const float* c0,
                                          const float* c1) {
  a[0] = pack<E>(c0[0], c0[1]);
  a[1] = pack<E>(c0[2], c0[3]);
  a[2] = pack<E>(c1[0], c1[1]);
  a[3] = pack<E>(c1[2], c1[3]);
}

// Rows [row0, row0 + kBlock) of a [T, D] matrix into shared memory (row
// stride ld), 16 bytes a thread at a time; rows at or past T are zeros.
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          int row0, int T, int D, int ld) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < kBlock * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// s = A[rows r0..r0+15 of sa] . B^T over the head dim, B = 8*NB rows of sb
// from n0; s is the warp's [16, 8*NB] f32 tile as C fragments.
template <class E, int NB, int DM>
__device__ __forceinline__ void qk_tile(float (*s)[4], const uint16_t* sa,
                                        const uint16_t* sb, int ld, int r0,
                                        int n0, int D, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) {
    if (kk * 16 < D) {
      uint32_t a[4];
      load_a(a, sa, ld, r0, kk * 16, g, t);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t b[2];
        load_b_nk(b, sb, ld, n0 + nb * 8, kk * 16, g, t);
        E::mma(s[nb], a, b);
      }
    }
  }
}

// acc[16, D] += p[16, 16*KS] (C fragments, rounded to E) . sv[k0.., :D]
template <class E, int KS, int DM>
__device__ __forceinline__ void pv_tile(float (*acc)[4], float (*p)[4],
                                        const uint16_t* sv, int ld, int k0,
                                        int D, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    frag_to_a<E>(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int i = 0; i < DM / 8; ++i) {
      if (i * 8 < D) {
        uint32_t b[2];
        load_b_kn(b, sv, ld, k0 + kk * 16, i * 8, g, t);
        E::mma(acc[i], a, b);
      }
    }
  }
}

// Mask of a [16, 64] score tile whose rows are query positions (rows g
// and g + 8 of the warp's block from qrow) and columns key positions
// from kcol0: keys at or past Tk, and (causal) keys after the query.
__device__ __forceinline__ void mask_qk(float (*s)[4], int qrow, int kcol0,
                                        int Tk, int causal, int t) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qrow + 8 * (e >> 1);
      const int col = kcol0 + nb * 8 + 2 * t + (e & 1);
      if (col >= Tk || (causal && col > row)) s[nb][e] = kNegInf;
    }
  }
}

// One row (g, or g + 8 when hr = 1) of a warp's [16, D] accumulator,
// times mul, rounded to E.
template <class E, int DM>
__device__ __forceinline__ void store_row(uint16_t* dst, float (*acc)[4],
                                          int hr, float mul, int D, int t) {
#pragma unroll
  for (int i = 0; i < DM / 8; ++i) {
    if (i * 8 < D)
      *reinterpret_cast<uint32_t*>(dst + i * 8 + 2 * t) =
          pack<E>(acc[i][2 * hr] * mul, acc[i][2 * hr + 1] * mul);
  }
}

// -- forward: grid (q tiles, B*H) ---------------------------------------------

template <class E, int DM>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
               float* __restrict__ lse, int Tq, int Tk, int D, int causal) {
  extern __shared__ uint4 smem_raw[];
  const int ld = D + kPad;
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sK = sQ + kBlock * ld;
  uint16_t* sV = sK + kBlock * ld;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const uint16_t* kb = k + bh * Tk * D;
  const uint16_t* vb = v + bh * Tk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  load_tile(sQ, q + bh * Tq * D, q0, Tq, D, ld);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DM / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  const int n_kv = (Tk + kBlock - 1) / kBlock;
  const int kv_end = causal ? min(n_kv, (q0 + kBlock - 1) / kBlock + 1) : n_kv;
  for (int j = 0; j < kv_end; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();  // the previous tile's readers are done
    load_tile(sK, kb, k0, Tk, D, ld);
    load_tile(sV, vb, k0, Tk, D, ld);
    __syncthreads();
    float s[8][4];
    qk_tile<E, 8, DM>(s, sQ, sK, ld, r0, 0, D, g, t);
    if ((causal && k0 + kBlock - 1 > q0) || k0 + kBlock > Tk)
      mask_qk(s, q0 + r0 + g, k0, Tk, causal, t);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * hr], s[nb][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float corr = expf(m[hr] - m_new);
      m[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = expf(s[nb][e] - m_new);  // masked columns -> 0
          s[nb][e] = p;
          sum += p;
        }
      }
      l[hr] = l[hr] * corr + sum;  // this thread's columns; summed at the end
#pragma unroll
      for (int i = 0; i < DM / 8; ++i) {
        o[i][2 * hr] *= corr;
        o[i][2 * hr + 1] *= corr;
      }
    }
    pv_tile<E, 4, DM>(o, s, sV, ld, 0, D, g, t);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float den = l[hr] + __shfl_xor_sync(kFull, l[hr], 1);
    den += __shfl_xor_sync(kFull, den, 2);
    den = fmaxf(den, kDenFloor);
    const int row = q0 + r0 + g + 8 * hr;
    if (row < Tq) {
      uint16_t* orow = out + (bh * Tq + row) * D;
#pragma unroll
      for (int i = 0; i < DM / 8; ++i) {
        if (i * 8 < D)
          *reinterpret_cast<uint32_t*>(orow + i * 8 + 2 * t) = pack<E>(
              o[i][2 * hr] / den, o[i][2 * hr + 1] / den);
      }
      if (t == 0) lse[bh * Tq + row] = m[hr] + logf(den);
    }
  }
}

// -- backward, dQ: grid (q tiles, B*H) ----------------------------------------

template <class E, int DM>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              uint16_t* __restrict__ dq, int Tq, int Tk, int D, int causal,
              float scale) {
  extern __shared__ uint4 smem_raw[];
  const int ld = D + kPad;
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sO = sQ + kBlock * ld;  // dO
  uint16_t* sK = sO + kBlock * ld;
  uint16_t* sV = sK + kBlock * ld;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const uint16_t* kb = k + bh * Tk * D;
  const uint16_t* vb = v + bh * Tk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  load_tile(sQ, q + bh * Tq * D, q0, Tq, D, ld);
  load_tile(sO, dout + bh * Tq * D, q0, Tq, D, ld);
  float lr[2], dr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + g + 8 * hr;
    lr[hr] = row < Tq ? lse[bh * Tq + row] : 0.f;
    dr[hr] = row < Tq ? delta[bh * Tq + row] : 0.f;
  }
  float acc[DM / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_kv = (Tk + kBlock - 1) / kBlock;
  const int kv_end = causal ? min(n_kv, (q0 + kBlock - 1) / kBlock + 1) : n_kv;
  for (int j = 0; j < kv_end; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();
    load_tile(sK, kb, k0, Tk, D, ld);
    load_tile(sV, vb, k0, Tk, D, ld);
    __syncthreads();
    float s[8][4], dp[8][4];
    qk_tile<E, 8, DM>(s, sQ, sK, ld, r0, 0, D, g, t);
    if ((causal && k0 + kBlock - 1 > q0) || k0 + kBlock > Tk)
      mask_qk(s, q0 + r0 + g, k0, Tk, causal, t);
    qk_tile<E, 8, DM>(dp, sO, sV, ld, r0, 0, D, g, t);  // dO . V^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nb][e] - lr[e >> 1]);  // recomputed softmax
        s[nb][e] = p * (dp[nb][e] - dr[e >> 1]);      // ds
      }
    }
    pv_tile<E, 4, DM>(acc, s, sK, ld, 0, D, g, t);  // dq^ += ds . K
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + g + 8 * hr;
    if (row < Tq)
      store_row<E, DM>(dq + (bh * Tq + row) * D, acc, hr, scale, D, t);
  }
}

// -- backward, dK and dV: grid (kv tiles, B*H) ---------------------------------

template <class E, int DM>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v,
               const uint16_t* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int Tq,
               int Tk, int D, int causal) {
  extern __shared__ uint4 smem_raw[];
  const int ld = D + kPad;
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sV = sK + kBlock * ld;
  uint16_t* sQ = sV + kBlock * ld;
  uint16_t* sO = sQ + kBlock * ld;  // dO
  float* sL = reinterpret_cast<float*>(sO + kBlock * ld);
  float* sD = sL + kBlock;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const uint16_t* qb = q + bh * Tq * D;
  const uint16_t* ob = dout + bh * Tq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;

  load_tile(sK, k + bh * Tk * D, k0, Tk, D, ld);
  load_tile(sV, v + bh * Tk * D, k0, Tk, D, ld);
  float ak[DM / 8][4], av[DM / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i) {
    ak[i][0] = ak[i][1] = ak[i][2] = ak[i][3] = 0.f;
    av[i][0] = av[i][1] = av[i][2] = av[i][3] = 0.f;
  }

  const int n_q = (Tq + kBlock - 1) / kBlock;
  // causal: Q tiles wholly before this K/V tile see none of it
  for (int i = causal ? k0 / kBlock : 0; i < n_q; ++i) {
    const int q0 = i * kBlock;
    __syncthreads();
    load_tile(sQ, qb, q0, Tq, D, ld);
    load_tile(sO, ob, q0, Tq, D, ld);
    if (threadIdx.x < kBlock) {
      const int row = q0 + threadIdx.x;
      sL[threadIdx.x] = row < Tq ? lse[bh * Tq + row] : 0.f;
      sD[threadIdx.x] = row < Tq ? delta[bh * Tq + row] : 0.f;
    }
    __syncthreads();
    const bool masked = (causal && k0 + kBlock - 1 > q0) || q0 + kBlock > Tq;
    // the warp's [16 keys, 64 queries] tile, 32 query columns at a time
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;
      float s[4][4], dp[4][4];
      qk_tile<E, 4, DM>(s, sK, sQ, ld, r0, c0, D, g, t);  // (q^ . k^T)^T
      qk_tile<E, 4, DM>(dp, sV, sO, ld, r0, c0, D, g, t);  // (dO . V^T)^T
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = c0 + nb * 8 + 2 * t + (e & 1);  // query, in tile
          const int key = k0 + r0 + g + 8 * (e >> 1);
          const int qpos = q0 + cl;
          float x = s[nb][e];
          if (masked && (qpos >= Tq || (causal && key > qpos))) x = kNegInf;
          const float p = expf(x - sL[cl]);
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - sD[cl]);  // ds
        }
      }
      pv_tile<E, 2, DM>(av, s, sO, ld, c0, D, g, t);   // dV += P^T . dO
      pv_tile<E, 2, DM>(ak, dp, sQ, ld, c0, D, g, t);  // dK += dS^T . q^
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = k0 + r0 + g + 8 * hr;
    if (row < Tk) {
      store_row<E, DM>(dk + (bh * Tk + row) * D, ak, hr, 1.f, D, t);
      store_row<E, DM>(dv + (bh * Tk + row) * D, av, hr, 1.f, D, t);
    }
  }
}

// -- launches --------------------------------------------------------------------

inline size_t tile_bytes(int D) {
  return static_cast<size_t>(kBlock) * (D + kPad) * sizeof(uint16_t);
}

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

template <class E, int DM>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, int bh, int tq, int tk, int d, int causal,
                       cudaStream_t st) {
  static bool attr = false;
  cudaError_t err = allow_smem(fwd_kernel<E, DM>, 3 * tile_bytes(DM), &attr);
  if (err != cudaSuccess) return err;
  fwd_kernel<E, DM><<<dim3((tq + kBlock - 1) / kBlock, bh), kThreads,
                      3 * tile_bytes(d), st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out),
      static_cast<float*>(lse), tq, tk, d, causal);
  return cudaGetLastError();
}

template <class E, int DM>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int tq, int tk, int d, int causal,
                      float scale, cudaStream_t st) {
  static bool attr = false;
  cudaError_t err = allow_smem(dq_kernel<E, DM>, 4 * tile_bytes(DM), &attr);
  if (err != cudaSuccess) return err;
  dq_kernel<E, DM><<<dim3((tq + kBlock - 1) / kBlock, bh), kThreads,
                     4 * tile_bytes(d), st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint16_t*>(dq), tq, tk, d, causal, scale);
  return cudaGetLastError();
}

template <class E, int DM>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int tq, int tk, int d,
                       int causal, cudaStream_t st) {
  static bool attr = false;
  const size_t rows = 2 * kBlock * sizeof(float);
  cudaError_t err =
      allow_smem(dkv_kernel<E, DM>, 4 * tile_bytes(DM) + rows, &attr);
  if (err != cudaSuccess) return err;
  dkv_kernel<E, DM><<<dim3((tk + kBlock - 1) / kBlock, bh), kThreads,
                      4 * tile_bytes(d) + rows, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), tq, tk, d,
      causal);
  return cudaGetLastError();
}

inline bool bad_args(int bh, int tq, int tk, int d, int dtype) {
  return bh < 1 || bh > 65535 || tq < 1 || tk < 1 || d < 16 ||
         d > kMaxHeadDim || d % 16 != 0 || (dtype != 0 && dtype != 1);
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

// Rows of a tile (the Python side checks it against its own constant).
int mr_flash_block() { return kBlock; }

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

// dk, dv [bh, tk, d] from the same inputs.
int mr_flash_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int bh, int tq, int tk, int d,
                 int causal, int dtype, void* stream) {
  if (bad_args(bh, tq, tk, d, dtype)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  MR_FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                    d, causal, st);
}

}  // extern "C"
