// Device helpers shared by the ELL row kernels of repair.cu and
// csr_relax.cu: the wrapping int32 add of the relax kernels, the loads of
// one row's K slots (by the thread, or for K = 8 by the whole warp), the
// gather of a slot's property, and the launch's carveout hint.
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

// The 8 slots of row r into x[0..8), loaded by the whole warp, whose 32
// rows must all exist.  The warp's rows are 64 consecutive int4, row m
// being int4 2m and 2m + 1; lane l loads int4 l into a and int4
// 32 + (l ^ 1) into b, two fully used 512-byte requests.  Row m < 16 then
// sits in a of lanes 2m and 2m + 1, row m >= 16 in b of lanes 2m - 31 and
// 2m - 32: for a row's first half even lanes offer a and odd lanes b,
// for its second half the reverse, so each of the 8 shuffles reads every
// lane once.
__device__ __forceinline__ void warp_load_row8(const int* __restrict__ p,
                                               long long r, int* x) {
  const int lane = threadIdx.x & 31;
  const int4* q = reinterpret_cast<const int4*>(p + (r - lane) * 8);
  const int4 a = __ldg(q + lane);
  const int4 b = __ldg(q + 32 + (lane ^ 1));
  const bool odd = lane & 1;
  const int4 s0 = odd ? b : a, s1 = odd ? a : b;
  const int j0 = ((2 * lane) & 31) | (lane >> 4), j1 = j0 ^ 1;
  x[0] = __shfl_sync(0xffffffffu, s0.x, j0);
  x[1] = __shfl_sync(0xffffffffu, s0.y, j0);
  x[2] = __shfl_sync(0xffffffffu, s0.z, j0);
  x[3] = __shfl_sync(0xffffffffu, s0.w, j0);
  x[4] = __shfl_sync(0xffffffffu, s1.x, j1);
  x[5] = __shfl_sync(0xffffffffu, s1.y, j1);
  x[6] = __shfl_sync(0xffffffffu, s1.z, j1);
  x[7] = __shfl_sync(0xffffffffu, s1.w, j1);
}

// Ask for as little shared memory as the blocks need (a hint): the rest of
// the SM's 256 KB is L1, where the row kernels' gathers of vals hit.  An
// error shows in the entry point's cudaGetLastError().
template <typename Kernel>
void prefer_l1(Kernel* kernel) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       0);
}

}  // namespace
