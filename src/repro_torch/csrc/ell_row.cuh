// Device helpers shared by the ELL row kernels of repair.cu and
// csr_relax.cu: the wrapping int32 add of the relax kernels and the load
// of one row's K slots.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap_add(int a, int b) {
  // int32 addition that wraps like JAX's and torch's, without C++ UB
  return (int)((unsigned)a + (unsigned)b);
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
