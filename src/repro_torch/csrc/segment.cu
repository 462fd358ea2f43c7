// Deterministic float32 segment sums on Hopper (sm_90a).  Bound to
// PyTorch through a plain C interface (ctypes) by
// src/repro_torch/kernels/segment.py, which also holds the plain PyTorch
// version.  The entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
//
// segment_sum_sorted
//   Replaces no TPU kernel: it is the port's jax.ops.segment_sum for
//   floats (src/repro_torch/tensors.py:segment_sum), which the reference
//   left to XLA.  XLA on the CPU adds a segment's lanes in lane order;
//   index_add_ on the card adds them with atomics in whatever order they
//   land, so its bits change from run to run.  Here segment s adds
//   vals[order[i]] (vals[i] when order is null) for i in
//   [offsets[s], offsets[s+1]) in that order, from 0.0f, with
//   round-to-nearest adds that are never reassociated or contracted.
//   Design: one thread per segment; the loads of eight lanes are issued
//   before their eight dependent adds.  A segment of L lanes costs L
//   dependent adds, so on a skewed graph the hubs (in-degrees in the
//   tens of thousands) bound the kernel, not the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segment_sum_sorted_kernel(const float* __restrict__ vals,
                                          const int* __restrict__ order,
                                          const int* __restrict__ offsets,
                                          float* __restrict__ out,
                                          int num) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= num) return;
  const int lo = __ldg(offsets + s), hi = __ldg(offsets + s + 1);
  float acc = 0.0f;
  int i = lo;
  for (; i + 8 <= hi; i += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = __ldg(vals + (order ? __ldg(order + i + j) : i + j));
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, x[j]);
  }
  for (; i < hi; ++i)
    acc = __fadd_rn(acc, __ldg(vals + (order ? __ldg(order + i) : i)));
  out[s] = acc;
}

}  // namespace

extern "C" int repro_segment_sum_sorted(const void* vals, const void* order,
                                        const void* offsets, void* out,
                                        int num, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int block = 256;
  const int grid = (num + block - 1) / block;
  if (grid > 0) {
    segment_sum_sorted_kernel<<<grid, block, 0, st>>>(
        (const float*)vals, (const int*)order, (const int*)offsets,
        (float*)out, num);
  }
  return (int)cudaGetLastError();
}
