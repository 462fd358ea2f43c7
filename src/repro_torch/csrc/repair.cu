// Hand-written Hopper (sm_90a) kernels for the fused repair path of
// dynamic SSSP and PageRank.
// Bound to PyTorch through a plain C interface (ctypes) by
// src/repro_torch/kernels/repair.py, which also holds each kernel's plain
// PyTorch version.  Every entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().
//
// fused_relax_rows
//   Replaces: src/repro/kernels/pallas_repair.py fused_relax_rows
//   (_fused_relax_kernel).  Per ELL row r of K slots:
//     row_min[r] = min_k vals[src]+w
//     row_arg[r] = smallest src among the slots reaching row_min
//     hit        = row_min < vals[n]            (vals[n] = identity)
//   and the hit row ids compacted to the front of each block's slice of
//   `rows` (sentinel R after the block's count), counts[block] = count.
//   Bound: device-memory bytes.  Each row streams 2·K·4 bytes of slots
//   and writes 12 bytes; the K gathers of vals[src] (16 MB at n = 4M)
//   mostly hit the 50 MB L2.  The gathers set the pace: one 32-byte
//   sector and one L1 lookup for each 4 bytes, and they hit L1 often
//   enough that L1's size counts.  Design: one thread per row, so a warp
//   owns 32 consecutive rows, gathering through the read-only path
//   (__ldg).  For K = 8 with 16-byte aligned slots the warp loads its
//   rows' 1 KB of src (and of w) as 64 consecutive 16-byte loads, every
//   sector used whole, and 8 shuffles hand each thread its row
//   (ell_row.cuh: warp_load_row8); other K and misaligned views load
//   slot by slot.  The launch asks for the smallest shared-memory
//   carveout (prefer_l1), so L1 is as large as the blocks allow.  The
//   TPU kernel's in-tile cumsum becomes a block-wide exclusive scan of
//   the hit flags from warp ballots and popc, so the compaction costs no
//   extra pass over memory.
//
// fused_spmv_rows
//   Replaces: src/repro/kernels/pallas_repair.py fused_spmv_rows
//   (_fused_spmv_kernel).  Per ELL row r of K slots:
//     row_sum[r] = vals[src_0] + vals[src_1] + ... + vals[src_{K-1}]
//                  (float32, added left to right: no reassociation, no
//                  fast-math, so it equals the plain version bit for bit)
//     hit        = row2dst[r] < n       (the row belongs to a vertex)
//   and the hit row ids compacted per block as in fused_relax_rows.
//   Bound: device-memory bytes (K·4 bytes of slots and 4 of row2dst in,
//   8 out per row; the gathers mostly hit L2).  Design: the relax
//   kernel's — one thread per row, the warp's slots loaded whole and
//   shuffled to their rows for K = 8, __ldg gathers, the smallest
//   carveout, the same ballot/popc block scan.
//
// merge_pool_sorted
//   Replaces: src/repro/kernels/pallas_repair.py merge_pool_sorted
//   (_merge_kernel).  Merges the diff pool (D rows, sorted by (src, dst),
//   vacant rows src == n at the end) with the admitted batch (B rows,
//   sorted likewise); the pool wins ties; slots past both lists are
//   filled (n, 0, 0, dead).
//   Bound: device-memory bytes (13 bytes a row in, 13 out) and, at a few
//   MB, launch latency.  Design: one thread per output slot j < D runs the
//   merge-path binary search on its diagonal (log2(B) dependent loads of
//   the small batch, which stay in L1/L2) and writes its slot; no tile
//   padding, the thread guards j < D.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace {

// One slot of a row's relax: the row min so far, the least source reaching
// it, and how many slots reach it.  A row where some slot misses the min
// also offers the sentinel n to the argmin, as the reference's
// min(where(cand == rmin, src, n)) does (it matters only for a source id
// past n, which an unchecked graph can hold).
__device__ __forceinline__ void relax_slot(int s, int w,
                                           const int* __restrict__ vals,
                                           int L, int& rmin, int& rarg,
                                           int& reach) {
  const int c = wrap_add(gather(vals, s, L), w);
  if (c < rmin) {
    rmin = c;
    rarg = s;
    reach = 1;
  } else if (c == rmin) {
    rarg = min(rarg, s);
    ++reach;
  }
}

// Block-wide compaction shared by the fused kernels: the ids of this
// block's hit rows packed to the front of its slice of `rows` (sentinel R
// after the count), counts[block] = count.  An exclusive scan of the hit
// flags from warp ballots and popc, then an inclusive scan of the warp
// totals by warp 0.  Every thread of the block must call it.
__device__ __forceinline__ void compact_block(bool hit, long long r,
                                              long long base, int R,
                                              int* warp_tot,
                                              int* __restrict__ rows,
                                              int* __restrict__ counts) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int c = lane < nwarps ? warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, c, off);
      if (lane >= off) c += t;
    }
    if (lane < nwarps) warp_tot[lane] = c;
  }
  __syncthreads();
  const int total = warp_tot[nwarps - 1];
  const int pos = (warp ? warp_tot[warp - 1] : 0) +
                  __popc(ballot & ((1u << lane) - 1u));
  if (hit) rows[base + pos] = (int)r;
  if (tid >= total && r < R) rows[r] = R;
  if (tid == 0) counts[blockIdx.x] = total;
}

// VEC8: K == 8 with 16-byte aligned rows and whole warps of rows, loaded
// by warp_load_row8.
template <bool VEC8>
__global__ void fused_relax_rows_kernel(const int* __restrict__ ell_src,
                                        const int* __restrict__ ell_w,
                                        const int* __restrict__ vals,
                                        int* __restrict__ row_min,
                                        int* __restrict__ row_arg,
                                        int* __restrict__ rows,
                                        int* __restrict__ counts,
                                        int R, int K, int n) {
  extern __shared__ int warp_tot[];  // one inclusive count per warp
  const long long base = (long long)blockIdx.x * blockDim.x;
  const long long r = base + threadIdx.x;
  bool hit = false;
  if (r < R) {
    int rmin, rarg, reach = 1;
    if (VEC8) {
      int s[8], w[8];
      warp_load_row8(ell_src, r, s);
      warp_load_row8(ell_w, r, w);
      rmin = wrap_add(gather(vals, s[0], n + 1), w[0]);
      rarg = s[0];
#pragma unroll
      for (int k = 1; k < 8; ++k)
        relax_slot(s[k], w[k], vals, n + 1, rmin, rarg, reach);
    } else {
      const int* s = ell_src + r * K;
      const int* w = ell_w + r * K;
      rarg = __ldg(s);
      rmin = wrap_add(gather(vals, rarg, n + 1), __ldg(w));
      for (int k = 1; k < K; ++k) relax_slot(__ldg(s + k), __ldg(w + k),
                                             vals, n + 1, rmin, rarg, reach);
    }
    if (reach < (VEC8 ? 8 : K)) rarg = min(rarg, n);
    row_min[r] = rmin;
    row_arg[r] = rarg;
    hit = rmin < __ldg(vals + n);
  }

  compact_block(hit, r, base, R, warp_tot, rows, counts);
}

// VEC8: as fused_relax_rows_kernel's.
template <bool VEC8>
__global__ void fused_spmv_rows_kernel(const int* __restrict__ ell_src,
                                       const int* __restrict__ row2dst,
                                       const float* __restrict__ vals,
                                       float* __restrict__ row_sum,
                                       int* __restrict__ rows,
                                       int* __restrict__ counts,
                                       int R, int K, int n) {
  extern __shared__ int warp_tot[];  // one inclusive count per warp
  const long long base = (long long)blockIdx.x * blockDim.x;
  const long long r = base + threadIdx.x;
  bool hit = false;
  if (r < R) {
    float acc;
    if (VEC8) {
      int s[8];
      warp_load_row8(ell_src, r, s);
      acc = gather(vals, s[0], n + 1);
#pragma unroll
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, gather(vals, s[k], n + 1));
    } else {
      const int* s = ell_src + r * K;
      acc = gather(vals, __ldg(s), n + 1);
      for (int k = 1; k < K; ++k)
        acc = __fadd_rn(acc, gather(vals, __ldg(s + k), n + 1));
    }
    row_sum[r] = acc;
    hit = __ldg(row2dst + r) < n;
  }
  compact_block(hit, r, base, R, warp_tot, rows, counts);
}

__global__ void merge_pool_sorted_kernel(
    const int* __restrict__ ps, const int* __restrict__ pd,
    const int* __restrict__ pw, const uint8_t* __restrict__ pa,
    const int* __restrict__ fs, const int* __restrict__ fd,
    const int* __restrict__ fw, const uint8_t* __restrict__ fa,
    int* __restrict__ os, int* __restrict__ od, int* __restrict__ ow,
    uint8_t* __restrict__ oa, int D, int B, int n, int iters) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  // merge-path diagonal split: a = #fresh rows among the first j merged.
  // P(a) = fresh[a] < pool[j-1-a] (strict: the pool wins ties) is
  // monotone in a; find the first a where it fails.
  int lo = max(j - D, 0);
  int hi = min(j, B);
  for (int it = 0; it < iters && lo < hi; ++it) {
    const int mid = (lo + hi) >> 1;
    const int mi = min(max(mid, 0), B - 1);
    const int pi = min(max(j - 1 - mid, 0), D - 1);
    const int ms = fs[mi], md = fd[mi];
    const int qs = ps[pi], qd = pd[pi];
    if ((ms < qs) || (ms == qs && md < qd)) lo = mid + 1;
    else hi = mid;
  }
  const int a = lo;
  const int ip = j - a;
  const bool a_ok = a < B;
  const bool p_ok = ip < D;
  const int as = min(max(a, 0), B - 1);
  const int qi = min(max(ip, 0), D - 1);
  const int f_s = fs[as], f_d = fd[as];
  const int q_s = ps[qi], q_d = pd[qi];
  const bool fresh_less = (f_s < q_s) || (f_s == q_s && f_d < q_d);
  const bool take_f = a_ok && (!p_ok || fresh_less);
  os[j] = take_f ? f_s : (p_ok ? q_s : n);
  od[j] = take_f ? f_d : (p_ok ? q_d : 0);
  ow[j] = take_f ? fw[as] : (p_ok ? pw[qi] : 0);
  oa[j] = take_f ? fa[as] : (p_ok ? pa[qi] : (uint8_t)0);
}

}  // namespace

extern "C" int repro_fused_relax_rows(const void* ell_src, const void* ell_w,
                                      const void* vals, void* row_min,
                                      void* row_arg, void* rows,
                                      void* counts, int R, int K, int n,
                                      int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (R + block - 1) / block;
  const size_t smem = (size_t)(block / 32) * sizeof(int);
  const bool vec8 = K == 8 && R % 32 == 0 && block % 32 == 0 &&
                    ((uintptr_t)ell_src % 16 == 0) &&
                    ((uintptr_t)ell_w % 16 == 0);
  if (grid > 0) {
    if (vec8) {
      prefer_l1(fused_relax_rows_kernel<true>);
      fused_relax_rows_kernel<true><<<grid, block, smem, s>>>(
          (const int*)ell_src, (const int*)ell_w, (const int*)vals,
          (int*)row_min, (int*)row_arg, (int*)rows, (int*)counts, R, K, n);
    } else {
      prefer_l1(fused_relax_rows_kernel<false>);
      fused_relax_rows_kernel<false><<<grid, block, smem, s>>>(
          (const int*)ell_src, (const int*)ell_w, (const int*)vals,
          (int*)row_min, (int*)row_arg, (int*)rows, (int*)counts, R, K, n);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_fused_spmv_rows(const void* ell_src,
                                     const void* row2dst, const void* vals,
                                     void* row_sum, void* rows, void* counts,
                                     int R, int K, int n, int block,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (R + block - 1) / block;
  const size_t smem = (size_t)(block / 32) * sizeof(int);
  const bool vec8 = K == 8 && R % 32 == 0 && block % 32 == 0 &&
                    ((uintptr_t)ell_src % 16 == 0);
  if (grid > 0) {
    if (vec8) {
      prefer_l1(fused_spmv_rows_kernel<true>);
      fused_spmv_rows_kernel<true><<<grid, block, smem, s>>>(
          (const int*)ell_src, (const int*)row2dst, (const float*)vals,
          (float*)row_sum, (int*)rows, (int*)counts, R, K, n);
    } else {
      prefer_l1(fused_spmv_rows_kernel<false>);
      fused_spmv_rows_kernel<false><<<grid, block, smem, s>>>(
          (const int*)ell_src, (const int*)row2dst, (const float*)vals,
          (float*)row_sum, (int*)rows, (int*)counts, R, K, n);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_merge_pool_sorted(
    const void* ps, const void* pd, const void* pw, const void* pa,
    const void* fs, const void* fd, const void* fw, const void* fa,
    void* os, void* od, void* ow, void* oa, int D, int B, int n, int iters,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block = 256;
  const int grid = (D + block - 1) / block;
  if (grid > 0) {
    merge_pool_sorted_kernel<<<grid, block, 0, s>>>(
        (const int*)ps, (const int*)pd, (const int*)pw, (const uint8_t*)pa,
        (const int*)fs, (const int*)fd, (const int*)fw, (const uint8_t*)fa,
        (int*)os, (int*)od, (int*)ow, (uint8_t*)oa, D, B, n, iters);
  }
  return (int)cudaGetLastError();
}
