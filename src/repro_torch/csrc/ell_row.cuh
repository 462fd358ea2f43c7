// Device helpers shared by the ELL row kernels of repair.cu and
// csr_relax.cu: the wrapping int32 add of the relax kernels, the load of
// one row's K slots, and the gather of a slot's property.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap_add(int a, int b) {
  // int32 addition that wraps like JAX's and torch's, without C++ UB
  return (int)((unsigned)a + (unsigned)b);
}

// vals[i] of a length-L vector as a JAX gather reads it: ids in [-L, 0)
// count from the end, the rest clamp into [0, L).  A pack holds ids
// outside [0, L) only when its session admits batches unchecked
// (admission="off": a negative source id in the diff pool).
template <typename T>
__device__ __forceinline__ T gather(const T* __restrict__ vals, int i, int L) {
  i = min(max(i, -L), L - 1);
  return __ldg(vals + (i < 0 ? i + L : i));
}

// The K slots of row r into x[0..K): two 16-byte loads through the
// read-only path when VEC8 (K == 8, rows 16-byte aligned), else K scalar
// loads.
template <bool VEC8>
__device__ __forceinline__ void load_row(const int* __restrict__ p,
                                         long long r, int K, int* x) {
  if (VEC8) {
    const int4* q = reinterpret_cast<const int4*>(p + r * 8);
    const int4 a = __ldg(q), b = __ldg(q + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    for (int k = 0; k < K; ++k) x[k] = __ldg(p + r * K + k);
  }
}

}  // namespace
