// Hopper (sm_90a) building blocks: mbarriers, TMA tile loads, warpgroup MMA
// (wgmma) and its shared-memory descriptors, and the host-side encoding of
// TMA tensor maps.  Thin PTX wrappers, no policy: the kernels that use them
// decide tiles, stages and roles.
//
// Conventions shared by every user of this header:
// - A tile in shared memory is stored in 64-column "halves": a [rows, 64 *
//   H] tile of 16-bit elements is H consecutive [rows, 64] blocks, each row
//   128 bytes, each block 1024-byte aligned and written by TMA with the
//   128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B).  The wgmma descriptors
//   below read that same swizzle (layout type 1), so TMA and the tensor
//   cores agree on where every element lives.
// - K-major operand (the reduction dimension contiguous, e.g. q or k rows
//   [row][d] read as A or B of q . k^T): 8-row groups 1024 bytes apart
//   (SBO); the k16 step kk starts 32 bytes further into the row, in half
//   kk / 4.
// - MN-major operand (the output dimension contiguous, e.g. v rows
//   [key][d] read as B = [k = key][n = d] of p . v): 8-row groups of k
//   1024 bytes apart (SBO), 64-column halves of n one half apart (LBO); the
//   k16 step kk starts 16 rows (2048 bytes) further down.  wgmma takes it
//   with the transpose bit, which 16-bit types allow.
// - wgmma accumulator of m64nN (f32), per warp w of the warpgroup and lane
//   (g = lane / 4, t = lane % 4): d[4i + 0, 1] are row 16w + g, columns
//   8i + 2t and 8i + 2t + 1; d[4i + 2, 3] the same columns of row
//   16w + g + 8.  The A fragment of a register-sourced m64nNk16 (4 x b32,
//   two 16-bit values each) has the layout of mma.m16n8k16's A, so the
//   accumulator columns 16kk..16kk + 15, rounded and packed in pairs,
//   are the A operand of the k16 step kk: P never leaves registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver call goes through
                   // cudaGetDriverEntryPoint, so nothing links libcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace mr_hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the barrier has completed the phase of parity `parity`
// (0 for its first completion, 1 for its second, and so on).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// -- TMA --------------------------------------------------------------------------

// Box (c0, c1, c2) of a 3-D tensor map into shared memory; completes
// `bytes` (the whole box, zero fill included) on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// -- wgmma ------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at `p` (1024-byte aligned
// group start; see the conventions above for lbo and sbo).  Adding
// (bytes >> 4) moves its start address.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the fence, commit and wait around them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define MR_WGMMA_D32                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                  \
  "%8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "           \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

#define MR_WGMMA_D64                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                  \
  "%8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "           \
  "%24, %25, %26, %27, %28, %29, %30, %31, "           \
  "%32, %33, %34, %35, %36, %37, %38, %39, "           \
  "%40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, "           \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

#define MR_WGMMA_OUT8(d, i)                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define MR_WGMMA_OUT32(d)                                              \
  MR_WGMMA_OUT8(d, 0), MR_WGMMA_OUT8(d, 8), MR_WGMMA_OUT8(d, 16),      \
      MR_WGMMA_OUT8(d, 24)
#define MR_WGMMA_OUT64(d)                                              \
  MR_WGMMA_OUT32(d), MR_WGMMA_OUT8(d, 32), MR_WGMMA_OUT8(d, 40),       \
      MR_WGMMA_OUT8(d, 48), MR_WGMMA_OUT8(d, 56)

// d[64, N] (+)= A[64, 16] . B[16, N], A and B K-major in shared memory;
// scale_d = 0 overwrites d.  kFp16 picks f16 operands, else bf16.
template <bool kFp16, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64 && kFp16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " MR_WGMMA_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : MR_WGMMA_OUT32(d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MR_WGMMA_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : MR_WGMMA_OUT32(d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (kFp16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " MR_WGMMA_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : MR_WGMMA_OUT64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MR_WGMMA_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : MR_WGMMA_OUT64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d[64, N] (+)= A[64, 16] . B[16, N], A from registers (the fragment
// layout above), B MN-major in shared memory (transpose bit set).
template <bool kFp16, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64 && kFp16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " MR_WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : MR_WGMMA_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MR_WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : MR_WGMMA_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (kFp16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " MR_WGMMA_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : MR_WGMMA_OUT64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MR_WGMMA_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : MR_WGMMA_OUT64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

// -- host: tensor maps ----------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime;
// nullptr if the driver has none.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Map of a contiguous [n, rows, cols] tensor of 16-bit elements read in
// boxes of [1, box_rows, 64] with the 128-byte swizzle; reads past rows or
// cols fill zeros.  Needs cols * 2 and rows * cols * 2 to be multiples of
// 16 bytes and a 16-byte aligned base.
inline bool encode_rows(CUtensorMap* map, CUtensorMapDataType type,
                        const void* base, int n, int rows, int cols,
                        int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Map of a flat f32 vector of n values read in boxes of `box` values;
// reads past n fill zeros.
inline bool encode_f32_vector(CUtensorMap* map, const void* base, long long n,
                              int box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};  // rank 1: no strides are read
  const cuuint32_t boxd[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t step[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base),
            dims, strides, boxd, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace mr_hopper
