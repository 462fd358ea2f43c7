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
//   (_merge_kernel).  Merges the diff pool (D rows, sorted by (src, dst)
//   as signed int32 pairs, vacant rows src == n at the end) with the
//   admitted batch (B rows, sorted likewise); the pool wins ties.  Output
//   slot j < D takes the j-th merged row (j < D always leaves a pool row
//   unmerged, so no slot lies past both lists and n is not needed).
//   Bound: device-memory bytes, 13 a row in and 13 out (17.8 MB at the
//   smoke's D = 652,422, B = 65,536: 0.0053 ms), and at that size launch
//   and latency.  A merge-path search per output slot (the earlier
//   kernel: 18 rounds of four dependent scattered loads each, 47 M L2
//   requests) is paced by latency and request count, not by bytes.
//   Design: a block owns a tile of kMergeTile consecutive output slots.
//   Two warps find the merge-path splits of its first and last diagonal
//   at once, each cooperatively: 32 lanes probe 32 evenly spaced
//   candidates and a ballot narrows the range 32-fold a round (4 rounds
//   at B = 65,536; the whole block probing 256 candidates a round timed
//   slower, as did tiles of 512 and 2,048).  The block then copies the
//   pool and batch rows of its tile into shared memory with coalesced
//   4-byte loads (the ranges start anywhere, so neither 16-byte vectors
//   nor 1-D TMA bulk copies, which need 16-byte aligned starts and sizes,
//   apply; plain loads, all of a thread's issued before any is stored,
//   keep as many in flight as cp.async would, with less code).  Each
//   thread finds its own split inside the tile in shared memory (10
//   probes) and merges its kMergePer slots serially; the merged rows go
//   back through shared memory and out with neighbouring threads on
//   neighbouring addresses.  Shared arrays skip one word every 32, so a
//   thread's kMergePer consecutive slots fall in distinct banks across
//   the warp.  No atomics, one launch.  The lists must be sorted: on an
//   unsorted tail (an unchecked session's rows with src > n) any merge
//   path may order that tail differently.
//
// merge_pool_sorted_batched
//   The counterpart of vmap(pallas_call(_merge_kernel)), the reference
//   serving pool's mega-call (src/repro/serve/batch.py): S independent
//   merges of S sessions' pools (S, D) and batches (S, B), stacked
//   along a leading session axis, in ONE launch of the same kernel over
//   a grid of (ceil(D / kMergeTile), S).  blockIdx.y picks the session
//   and offsets every array by s·D or s·B; nothing inside a tile
//   changes.  Bound: S times merge_pool_sorted's bytes.  It is the only
//   entry point of the merge: a single merge is its S = 1 launch.

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

constexpr int kMergeTile = 1024;    // output slots a block
constexpr int kMergeThreads = 256;
constexpr int kMergePer = kMergeTile / kMergeThreads;  // slots a thread
constexpr int kMergePad = kMergeTile + kMergeTile / 32;

// Shared-memory slot of tile row i: one word skipped every 32.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Whether the batch row (fs, fd) goes before the pool row (ps, pd): only
// when strictly less, so the pool wins ties.
__device__ __forceinline__ bool fresh_first(int fs, int fd, int ps, int pd) {
  return fs < ps || (fs == ps && fd < pd);
}

// The merge-path split of diagonal j (how many batch rows are among the
// first j merged rows): the first a in [max(j - D, 0), min(j, B)] where
// fresh_first(batch[a], pool[j - 1 - a]) fails.  The warp searches
// together: 32 lanes probe 32 evenly spaced candidates, and since the
// probes that hold form a prefix, their count narrows the range to one
// gap; a range of at most 32 is probed whole.  Every lane returns it.
__device__ __forceinline__ int warp_split(const int* __restrict__ ps,
                                          const int* __restrict__ pd,
                                          const int* __restrict__ fs,
                                          const int* __restrict__ fd,
                                          int D, int B, int j) {
  const int lane = threadIdx.x & 31;
  int lo = max(j - D, 0), hi = min(j, B);
  while (lo < hi) {
    const int span = hi - lo;
    const bool whole = span <= 32;
    const int c = whole ? lo + lane : lo + (int)((long long)lane * span >> 5);
    bool p = false;
    if (c < hi)
      p = fresh_first(__ldg(fs + c), __ldg(fd + c), __ldg(ps + j - 1 - c),
                      __ldg(pd + j - 1 - c));
    const int k = __popc(__ballot_sync(0xffffffffu, p));
    if (whole) return lo + k;
    if (k == 0) return lo;
    if (k < 32) hi = lo + (int)((long long)k * span >> 5);
    lo += (int)((long long)(k - 1) * span >> 5) + 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kMergeThreads) merge_pool_sorted_kernel(
    const int* __restrict__ ps, const int* __restrict__ pd,
    const int* __restrict__ pw, const uint8_t* __restrict__ pa,
    const int* __restrict__ fs, const int* __restrict__ fd,
    const int* __restrict__ fw, const uint8_t* __restrict__ fa,
    int* __restrict__ os, int* __restrict__ od, int* __restrict__ ow,
    uint8_t* __restrict__ oa, int D, int B) {
  // the tile's rows: pool rows at [0, np), batch rows at [np, np + nf);
  // after the merge, the merged rows in output order
  __shared__ int s_src[kMergePad], s_dst[kMergePad], s_w[kMergePad],
      s_al[kMergePad];
  __shared__ int split[2];
  // the session of a batched launch (0 for a single merge)
  const size_t sp = (size_t)blockIdx.y * D, sf = (size_t)blockIdx.y * B;
  ps += sp; pd += sp; pw += sp; pa += sp;
  fs += sf; fd += sf; fw += sf; fa += sf;
  os += sp; od += sp; ow += sp; oa += sp;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int j0 = blockIdx.x * kMergeTile;
  const int j1 = min(j0 + kMergeTile, D);
  if (warp < 2) {
    const int a = warp_split(ps, pd, fs, fd, D, B, warp ? j1 : j0);
    if ((tid & 31) == 0) split[warp] = a;
  }
  __syncthreads();
  const int a0 = split[0];
  // sorted lists give a0 <= a1 <= a0 + (j1 - j0); the clamp keeps an
  // unsorted list's tile inside its shared arrays
  const int a1 = min(max(split[1], a0), a0 + (j1 - j0));
  const int p0 = j0 - a0;
  const int nf = a1 - a0;
  const int cnt = j1 - j0;
  const int np = cnt - nf;

  int r_src[kMergePer], r_dst[kMergePer], r_w[kMergePer], r_al[kMergePer];
#pragma unroll
  for (int u = 0; u < kMergePer; ++u) {
    const int i = tid + u * kMergeThreads;
    if (i < cnt) {
      const bool pool = i < np;
      const int g = pool ? p0 + i : a0 + (i - np);
      r_src[u] = __ldg((pool ? ps : fs) + g);
      r_dst[u] = __ldg((pool ? pd : fd) + g);
      r_w[u] = __ldg((pool ? pw : fw) + g);
      r_al[u] = __ldg((pool ? pa : fa) + g);
    }
  }
#pragma unroll
  for (int u = 0; u < kMergePer; ++u) {
    const int i = tid + u * kMergeThreads;
    if (i < cnt) {
      s_src[pad(i)] = r_src[u];
      s_dst[pad(i)] = r_dst[u];
      s_w[pad(i)] = r_w[u];
      s_al[pad(i)] = r_al[u];
    }
  }
  __syncthreads();

  // this thread's slots [d0, d1) of the tile: its split on diagonal d0,
  // then a serial merge
  const int d0 = min(tid * kMergePer, cnt);
  const int d1 = min(d0 + kMergePer, cnt);
  int lo = max(d0 - np, 0), hi = min(d0, nf);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int f = pad(np + mid), q = pad(d0 - 1 - mid);
    if (fresh_first(s_src[f], s_dst[f], s_src[q], s_dst[q])) lo = mid + 1;
    else hi = mid;
  }
  int fi = lo, pi = d0 - lo;
#pragma unroll
  for (int u = 0; u < kMergePer; ++u) {
    if (d0 + u < d1) {
      const int f = pad(np + fi), q = pad(pi);
      const bool take_f =
          fi < nf && (pi >= np || fresh_first(s_src[f], s_dst[f], s_src[q],
                                              s_dst[q]));
      const int x = take_f ? f : q;
      r_src[u] = s_src[x];
      r_dst[u] = s_dst[x];
      r_w[u] = s_w[x];
      r_al[u] = s_al[x];
      fi += take_f;
      pi += !take_f;
    }
  }
  __syncthreads();  // every thread has read the rows it merges
#pragma unroll
  for (int u = 0; u < kMergePer; ++u) {
    if (d0 + u < d1) {
      const int x = pad(d0 + u);
      s_src[x] = r_src[u];
      s_dst[x] = r_dst[u];
      s_w[x] = r_w[u];
      s_al[x] = r_al[u];
    }
  }
  __syncthreads();
  for (int i = tid; i < cnt; i += kMergeThreads) {
    const int x = pad(i);
    os[j0 + i] = s_src[x];
    od[j0 + i] = s_dst[x];
    ow[j0 + i] = s_w[x];
    oa[j0 + i] = (uint8_t)s_al[x];
  }
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

extern "C" int repro_merge_pool_sorted_batched(
    const void* ps, const void* pd, const void* pw, const void* pa,
    const void* fs, const void* fd, const void* fw, const void* fa,
    void* os, void* od, void* ow, void* oa, int D, int B, int S,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // x: the tiles of one merge, y: the session (a single merge is S = 1)
  const dim3 tiles((D + kMergeTile - 1) / kMergeTile, S);
  if (tiles.x > 0 && S > 0) {
    merge_pool_sorted_kernel<<<tiles, kMergeThreads, 0, s>>>(
        (const int*)ps, (const int*)pd, (const int*)pw, (const uint8_t*)pa,
        (const int*)fs, (const int*)fd, (const int*)fw, (const uint8_t*)fa,
        (int*)os, (int*)od, (int*)ow, (uint8_t*)oa, D, B);
  }
  return (int)cudaGetLastError();
}
