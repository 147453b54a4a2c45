// Segmented reduce over sorted key lanes for Hopper (sm_90a): the op-code
// instantiation of the kernel in segreduce.cuh.
//
// Replaces: mapreduce_tpu/ops/segscan.py:_segreduce_kernel (the Pallas
// TPU kernel behind sorted_unique_reduce(segment_impl='pallas')) for the
// built-in ops: one op per value lane from {sum, min, max}, chosen at run
// time, over int32 lanes (mr_segreduce: sum wraps) or float32 lanes
// (mr_segreduce_f32: jnp.add / jnp.minimum / jnp.maximum, identities
// -0.0, +inf and -inf), or run lengths (unit mode, int32).  A user's
// callable monoid runs on the same kernel template with its combine
// fixed at compile time (segreduce.cuh's MonoidOp, a library of its own).
//
// segreduce.cuh has the kernel, its inputs and outputs and its design.
#include "segreduce.cuh"

namespace mr_segreduce_kernels {

enum : int { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ int32_t apply_op(int op, int32_t a, int32_t b) {
  switch (op) {
    case kMin: return min(a, b);
    case kMax: return max(a, b);
    default:  // wraparound add, as int32 addition on the TPU
      return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                  static_cast<uint32_t>(b));
  }
}

// float32: jnp's ops (segreduce.cuh's mr_fmin and mr_fmax propagate
// NaN and order -0.0 below +0.0); the sum is correctly rounded, never
// contracted.  Written as overwrites: a switch, or a select of the three
// results, made ptxas spill in the 3-lane kernel (8-16 B at tiles 2,048
// and 4,096, sm_90a)
__device__ __forceinline__ float apply_op(int op, float a, float b) {
  float r = __fadd_rn(a, b);
  if (op == kMin) r = mr_fmin(a, b);
  if (op == kMax) r = mr_fmax(a, b);
  return r;
}

template <class V>
__device__ __forceinline__ V identity_of(int op);
template <>
__device__ __forceinline__ int32_t identity_of<int32_t>(int op) {
  return op == kMin ? INT_MAX : (op == kMax ? INT_MIN : 0);
}
// -0.0 for sum: -0.0 + x is x for every x, -0.0 included (+0.0 + -0.0 is
// +0.0)
template <>
__device__ __forceinline__ float identity_of<float>(int op) {
  return op == kMin ? __uint_as_float(0x7f800000u)
                    : (op == kMax ? __uint_as_float(0xff800000u) : -0.0f);
}

template <int D_, class V_ = int32_t>
struct SegOp {
  static constexpr int D = D_;
  using V = V_;
  int ops[D];
  struct T {
    V v[D];
    int32_t head;  // a run head lies in the span
    int32_t ends;  // run ends in the span
  };
  __device__ T identity() const {
    T t;
#pragma unroll
    for (int d = 0; d < D; ++d) t.v[d] = identity_of<V>(ops[d]);
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

template <int D, bool UNIT, class V = int32_t>
int launch_codes(const int32_t* k1, const int32_t* k2, const V* vals,
                 int n, const int* ops, V* reduced, int32_t* end_csum,
                 void* scratch, cudaStream_t stream) {
  SegOp<D, V> op;
  for (int d = 0; d < D; ++d) op.ops[d] = UNIT ? kSum : ops[d];
  return launch<SegOp<D, V>, UNIT>(k1, k2, vals, n, op, reduced, end_csum,
                                   scratch, stream);
}

// the same element size for both value types: one scratch size
static_assert(sizeof(SegOp<3, int32_t>::T) == sizeof(SegOp<3, float>::T),
              "int32 and float32 elements differ in size");

}  // namespace mr_segreduce_kernels

using namespace mr_segreduce_kernels;

extern "C" {

// Bytes of device scratch mr_segreduce (and mr_segreduce_f32) needs for n
// rows and d value lanes (0 for an unsupported lane count).
long long mr_segreduce_scratch_bytes(int n, int d) {
  switch (d) {
    case 1: return static_cast<long long>(scratch_bytes<SegOp<1>>(n));
    case 2: return static_cast<long long>(scratch_bytes<SegOp<2>>(n));
    case 3: return static_cast<long long>(scratch_bytes<SegOp<3>>(n));
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
    return launch_codes<1, true>(a, b, v, n, ops, red, csum, scratch, st);
  }
  switch (d) {
    case 1:
      return launch_codes<1, false>(a, b, v, n, ops, red, csum, scratch,
                                      st);
    case 2:
      return launch_codes<2, false>(a, b, v, n, ops, red, csum, scratch,
                                      st);
    case 3:
      return launch_codes<3, false>(a, b, v, n, ops, red, csum, scratch,
                                      st);
    default: return cudaErrorInvalidValue;
  }
}

// The float32 lanes' segmented reduce: mr_segreduce's interface with vals
// and reduced float32 [n, d], 1 <= d <= 3, op0..op2 (0 sum, 1 min, 2 max)
// per lane; unit must be 0 (run lengths are int32: mr_segreduce).
int mr_segreduce_f32(const void* k1, const void* k2, const void* vals,
                     int n, int d, int unit, int op0, int op1, int op2,
                     void* reduced, void* end_csum, void* scratch,
                     void* stream) {
  if (n <= 0 || n >= (1 << 30) || unit != 0 || vals == nullptr)
    return cudaErrorInvalidValue;
  const int ops[3] = {op0, op1, op2};
  for (int i = 0; i < d && i < 3; ++i)
    if (ops[i] < kSum || ops[i] > kMax) return cudaErrorInvalidValue;
  const auto* a = static_cast<const int32_t*>(k1);
  const auto* b = static_cast<const int32_t*>(k2);
  const auto* v = static_cast<const float*>(vals);
  auto* red = static_cast<float*>(reduced);
  auto* csum = static_cast<int32_t*>(end_csum);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1:
      return launch_codes<1, false, float>(a, b, v, n, ops, red, csum,
                                           scratch, st);
    case 2:
      return launch_codes<2, false, float>(a, b, v, n, ops, red, csum,
                                           scratch, st);
    case 3:
      return launch_codes<3, false, float>(a, b, v, n, ops, red, csum,
                                           scratch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
