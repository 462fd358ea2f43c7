// Hand-written Hopper (sm_90a) kernels for the chained regime of the
// hand-kernel engine (cuda_chained): one ELL row of K slots per output
// element, no compaction.  Bound to PyTorch through a plain C interface
// (ctypes) by src/repro_torch/kernels/csr_relax.py, which also holds each
// kernel's plain PyTorch version.  Every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// They replace the three Pallas kernels of src/repro/kernels/csr_relax.py:
//   relax_rowmin     out[r] = min_k vals[src]+w                (int32)
//   spmv_rowsum      out[r] = vals[src_0] + ... + vals[src_{K-1}]
//                    (float32, added left to right, no reassociation)
//   relax_rowargmin  out[r] = min_k {src : vals[src]+w == row_targets[r]},
//                    n where no slot reaches the target
// vals is (n+1,) with the reduction identity at slot n, so empty slots
// (src == n) gather the identity; L is its length, and a source id outside
// [0, L) is gathered as a JAX gather takes it (ell_row.cuh: gather).
//
// Bound: device-memory bytes.  A row streams K·4 bytes of sources (and
// K·4 of weights for the two relax kernels), reads 4 bytes of target
// (argmin) and writes 4; the K gathers of vals (16 MB at n = 4M) mostly
// hit the 50 MB L2.  What sets the pace is the gathers: each reads a
// 32-byte sector for 4 bytes, and they hit L1 often enough that L1's size
// counts.  The TPU kernels keep vals resident in VMEM and walk 128-row
// tiles in order; here one thread takes one row, so a warp reads 32
// consecutive rows, and gathers vals through the read-only path (__ldg).
// All three load a K = 8 row, when the warp's 32 rows all exist and are
// 16-byte aligned, with the whole warp (ell_row.cuh: warp_load_row8:
// fully used 512-byte requests, 8 shuffles, where a thread's own two
// int4 a row would touch each sector twice, at different times, while
// the gathers compete for L1), and ask for the smallest shared-memory
// carveout (prefer_l1), so L1 is left to the gathers (these blocks use no
// shared memory, and at the main path's shape the CUDA driver's own
// choice timed the same).  Other K, ragged R and misaligned views load
// slot by slot.  ell_row.cuh's load_row<true> (a thread's row as two
// int4, the loads before the warp loads) is called by no kernel here: it
// stays for tools/row_variants.py, whose "earlier kernel" copies put it
// back in the warp loads' place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace {

// WARP8: K == 8, R % 32 == 0 and 16-byte aligned slots, loaded by
// warp_load_row8.  A warp's rows then all exist or none does, so the
// early return leaves whole warps to the shuffles.
template <bool WARP8>
__global__ void relax_rowmin_kernel(const int* __restrict__ ell_src,
                                    const int* __restrict__ ell_w,
                                    const int* __restrict__ vals,
                                    int* __restrict__ out, int R, int K,
                                    int L) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int kk = WARP8 ? 8 : K;
  int s[32], w[32];
  if (WARP8) {
    warp_load_row8(ell_src, r, s);
    warp_load_row8(ell_w, r, w);
  } else {
    load_row<false>(ell_src, r, kk, s);
    load_row<false>(ell_w, r, kk, w);
  }
  int m = wrap_add(gather(vals, s[0], L), w[0]);
#pragma unroll 8
  for (int k = 1; k < kk; ++k)
    m = min(m, wrap_add(gather(vals, s[k], L), w[k]));
  out[r] = m;
}

// WARP8: as relax_rowmin_kernel's.
template <bool WARP8>
__global__ void spmv_rowsum_kernel(const int* __restrict__ ell_src,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, int R, int K,
                                   int L) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int kk = WARP8 ? 8 : K;
  int s[32];
  if (WARP8) warp_load_row8(ell_src, r, s);
  else load_row<false>(ell_src, r, kk, s);
  float acc = gather(vals, s[0], L);
#pragma unroll 8
  for (int k = 1; k < kk; ++k) acc = __fadd_rn(acc, gather(vals, s[k], L));
  out[r] = acc;
}

// WARP8: as spmv_rowsum_kernel's, for ell_src and ell_w.
template <bool WARP8>
__global__ void relax_rowargmin_kernel(const int* __restrict__ ell_src,
                                       const int* __restrict__ ell_w,
                                       const int* __restrict__ vals,
                                       const int* __restrict__ row_targets,
                                       int* __restrict__ out, int R, int K,
                                       int n, int L) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int kk = WARP8 ? 8 : K;
  int s[32], w[32];
  if (WARP8) {
    warp_load_row8(ell_src, r, s);
    warp_load_row8(ell_w, r, w);
  } else {
    load_row<false>(ell_src, r, kk, s);
    load_row<false>(ell_w, r, kk, w);
  }
  const int t = __ldg(row_targets + r);
  // min(where(cand == t, src, n)): n joins only when some slot misses
  int a = 0x7fffffff;
  bool miss = false;
#pragma unroll 8
  for (int k = 0; k < kk; ++k) {
    if (wrap_add(gather(vals, s[k], L), w[k]) == t) a = min(a, s[k]);
    else miss = true;
  }
  out[r] = miss ? min(a, n) : a;
}

constexpr int kBlock = 256;

// The warp-loaded path: K == 8, 16-byte aligned slots and whole warps of
// rows (blocks of kBlock rows are whole warps, so R % 32 == 0 makes every
// warp's rows all exist or all not).  kernels/csr_relax.py: warp_loads
// repeats this test.
bool warp8(int K, int R, const void* a, const void* b) {
  return K == 8 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
         R % 32 == 0;
}

}  // namespace

// K above 32 is refused (cudaErrorInvalidValue): the row lives in
// registers.
extern "C" int repro_relax_rowmin(const void* ell_src, const void* ell_w,
                                  const void* vals, void* out, int R, int K,
                                  int L, void* stream) {
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (R + kBlock - 1) / kBlock;
  if (grid > 0) {
    if (warp8(K, R, ell_src, ell_w)) {
      prefer_l1(relax_rowmin_kernel<true>);
      relax_rowmin_kernel<true><<<grid, kBlock, 0, st>>>(
          (const int*)ell_src, (const int*)ell_w, (const int*)vals,
          (int*)out, R, K, L);
    } else {
      prefer_l1(relax_rowmin_kernel<false>);
      relax_rowmin_kernel<false><<<grid, kBlock, 0, st>>>(
          (const int*)ell_src, (const int*)ell_w, (const int*)vals,
          (int*)out, R, K, L);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_spmv_rowsum(const void* ell_src, const void* vals,
                                 void* out, int R, int K, int L,
                                 void* stream) {
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (R + kBlock - 1) / kBlock;
  if (grid > 0) {
    if (warp8(K, R, ell_src, ell_src)) {
      prefer_l1(spmv_rowsum_kernel<true>);
      spmv_rowsum_kernel<true><<<grid, kBlock, 0, st>>>(
          (const int*)ell_src, (const float*)vals, (float*)out, R, K, L);
    } else {
      prefer_l1(spmv_rowsum_kernel<false>);
      spmv_rowsum_kernel<false><<<grid, kBlock, 0, st>>>(
          (const int*)ell_src, (const float*)vals, (float*)out, R, K, L);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_relax_rowargmin(const void* ell_src, const void* ell_w,
                                     const void* vals,
                                     const void* row_targets, void* out,
                                     int R, int K, int n, int L,
                                     void* stream) {
  if (K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (R + kBlock - 1) / kBlock;
  if (grid > 0) {
    if (warp8(K, R, ell_src, ell_w)) {
      prefer_l1(relax_rowargmin_kernel<true>);
      relax_rowargmin_kernel<true><<<grid, kBlock, 0, st>>>(
          (const int*)ell_src, (const int*)ell_w, (const int*)vals,
          (const int*)row_targets, (int*)out, R, K, n, L);
    } else {
      prefer_l1(relax_rowargmin_kernel<false>);
      relax_rowargmin_kernel<false><<<grid, kBlock, 0, st>>>(
          (const int*)ell_src, (const int*)ell_w, (const int*)vals,
          (const int*)row_targets, (int*)out, R, K, n, L);
    }
  }
  return (int)cudaGetLastError();
}
