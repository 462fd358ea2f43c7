#!/usr/bin/env python3
"""Copies of the graph kernels of ``src/repro_torch/csrc`` (the row
kernels ``fused_relax_rows`` and ``fused_spmv_rows`` in ``repair.cu``,
``relax_rowmin``, ``spmv_rowsum`` and ``relax_rowargmin`` in
``csr_relax.cu``, all loading their slots through ``ell_row.cuh``; and
``merge_pool_sorted`` in ``repair.cu``) with one change each, built and
run beside the real ones on an NVIDIA Hopper card.

    python3 tools/row_variants.py faults      # planted faults
    python3 tools/row_variants.py ablations   # other designs, timed

Each variant is a list of text substitutions over the sources
(``SOURCES``: the two ``.cu`` files and the header they share; every
substitution must match as often as it says across them, once by
default).  Each copy's ``.cu`` files are built with ``nvcc`` in parallel
with their own flags, against the copy's header, and its entry points
are put in the wrappers' place in turn.

``faults``: an unchanged control copy must pass ``chip_smoke.check_rows``
for every row kernel (each bit for bit against its plain version on
``chip_smoke.ROW_CASES``, its RMAT pack at ``--scale``) and
``chip_smoke.check_merge`` (``chip_smoke.MERGE_CASES``), and every
planted fault must fail the check of each kernel that the fault names.
Each copy is checked in a process of its own, so a fault that writes out
of bounds ends only its own CUDA context (a copy whose check crashes
counts as failing it).  Exits non-zero unless every verdict is as
expected.

``ablations``: at the main path's shapes (the ELL pack of
``chip_smoke.py``'s RMAT graph at ``--scale``, default 22, with its
stream's diff pool; vals from a static SSSP and a static PageRank on the
card, and relax_rowargmin's targets their vertex minima; for the merge,
the diff pool after the SSSP stream and a batch drawn as the smoke draws
it), each kernel and each copy that concerns it are timed by CUDA events
with a cold L2 (median of 20 launches), in the order kernel, copy, copy,
kernel.  A copy that keeps the kernels' contract must also equal the
plain versions bit for bit, launched into outputs filled with junk; the
copies marked "timing only" change what is computed (no gathers, or the
same slots over and over) to show which part sets the pace.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "csrc"
# each built source and the entry points it holds, and the header both
# include
LIBS = {"repair.cu": ("repro_fused_relax_rows", "repro_fused_spmv_rows",
                      "repro_merge_pool_sorted_batched"),
        "csr_relax.cu": ("repro_relax_rowmin", "repro_spmv_rowsum",
                         "repro_relax_rowargmin")}
SOURCES = (*LIBS, "ell_row.cuh")
FUSED = ("fused_relax_rows", "fused_spmv_rows")
CHAINED = ("relax_rowmin", "spmv_rowsum", "relax_rowargmin")
WARP_LOADED = FUSED + CHAINED
MERGE = ("merge_pool_sorted",)
TIMED = WARP_LOADED + MERGE

# Loads put in front of the kernels by some copies: a slot load under L1
# no-allocate and an L2 evict-first policy, and a gather (ell_row.cuh's
# id clamp and wrap) through @GATHER@, one of the GATHERS.
HELPERS = r"""
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  int4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "
      "{%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ int from_bits(unsigned v, const int*) {
  return (int)v;
}
__device__ __forceinline__ float from_bits(unsigned v, const float*) {
  return __uint_as_float(v);
}
template <typename T>
__device__ __forceinline__ T gather_q(const T* __restrict__ vals, int i,
                                      int L) {
  i = min(max(i, -L), L - 1);
  const T* p = vals + (i < 0 ? i + L : i);
  unsigned v;
  @GATHER@
  return from_bits(v, vals);
}
"""
GATHERS = {
    "evict-last": (
        'unsigned long long pol;\n'
        '  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" '
        ': "=l"(pol));\n'
        '  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" '
        ': "=r"(v) : "l"(p), "l"(pol));'),
    "no L1": 'asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" '
             ': "=r"(v) : "l"(p));',
}
LOAD_ROW = "// The K slots of row r into x[0..K)"


def helpers(gather: str) -> list:
    """Substitutions that put HELPERS into ell_row.cuh, with the gather
    ``gather``, and send every gather of the row kernels through it."""
    return [(LOAD_ROW,
             HELPERS.replace("@GATHER@", GATHERS[gather]) + LOAD_ROW),
            ("gather(vals, ", "gather_q(vals, ", 12)]


THREAD_LOADS = [("warp_load_row8(ell_src, r, s);",
                 "load_row<true>(ell_src, r, 8, s);", 5),
                ("warp_load_row8(ell_w, r, w);",
                 "load_row<true>(ell_w, r, 8, w);", 3)]
NO_CARVEOUT = [("      prefer_l1(", "      (void)(", 10)]

# relax_rowmin's warp-loaded launch with a persistent grid (as many blocks
# as fit at once, each walking row tiles) whose blocks stage vals[0, @H@)
# in shared memory once and serve the gathers of those ids from there (in
# an RMAT graph the low ids are the hubs)
HUB_KERNEL = r"""
template <int H>
__global__ void __launch_bounds__(256) relax_rowmin_hub_kernel(
    const int* __restrict__ ell_src, const int* __restrict__ ell_w,
    const int* __restrict__ vals, int* __restrict__ out, int R, int L) {
  __shared__ int hub[H];
  const int h = min(H, L);
  for (int i = threadIdx.x; i < h; i += blockDim.x) hub[i] = __ldg(vals + i);
  __syncthreads();
  for (long long base = (long long)blockIdx.x * blockDim.x; base < R;
       base += (long long)gridDim.x * blockDim.x) {
    const long long r = base + threadIdx.x;
    if (r >= R) break;  // whole warps: R % 32 == 0
    int s[8], w[8];
    warp_load_row8(ell_src, r, s);
    warp_load_row8(ell_w, r, w);
    int m = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int v = (unsigned)s[k] < (unsigned)h ? hub[s[k]]
                                                 : gather(vals, s[k], L);
      m = k ? min(m, wrap_add(v, w[k])) : wrap_add(v, w[k]);
    }
    out[r] = m;
  }
}

constexpr int kBlock = 256;"""
HUB_LAUNCH = ("""      relax_rowmin_kernel<true><<<grid, kBlock, 0, st>>>(
          (const int*)ell_src, (const int*)ell_w, (const int*)vals,
          (int*)out, R, K, L);""", """      int dev = 0, sms = 0, per = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, relax_rowmin_hub_kernel<@H@>, kBlock, 0);
      relax_rowmin_hub_kernel<@H@><<<min(grid, sms * per), kBlock, 0, st>>>(
          (const int*)ell_src, (const int*)ell_w, (const int*)vals,
          (int*)out, R, L);""")
HUBS = (4096, 1024)


def hub_cache(H: int) -> list:
    return [("constexpr int kBlock = 256;",
             HUB_KERNEL.replace("@H@", str(H))),
            tuple(x.replace("@H@", str(H)) for x in HUB_LAUNCH)]


# merge_pool_sorted as it was before its tiles: one thread a slot, each
# running the merge-path binary search on its own diagonal (n is written
# only where no pool row is left, which a slot j < D never reaches)
EARLIER_MERGE = r"""__global__ void earlier_merge_kernel(
    const int* __restrict__ ps, const int* __restrict__ pd,
    const int* __restrict__ pw, const uint8_t* __restrict__ pa,
    const int* __restrict__ fs, const int* __restrict__ fd,
    const int* __restrict__ fw, const uint8_t* __restrict__ fa,
    int* __restrict__ os, int* __restrict__ od, int* __restrict__ ow,
    uint8_t* __restrict__ oa, int D, int B, int n, int iters) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
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

constexpr int kMergeTile = 1024;"""
MERGE_TILE = "constexpr int kMergeTile = 1024;"
# both splits of a tile found by the whole block at once: each of the 256
# threads probes one of 256 evenly spaced candidates on each diagonal, and
# the warps' ballot counts, summed in shared memory, narrow each range
# 256-fold a round
BLOCK_SPLIT = ("""  if (warp < 2) {
    const int a = warp_split(ps, pd, fs, fd, D, B, warp ? j1 : j0);
    if ((tid & 31) == 0) split[warp] = a;
  }
  __syncthreads();
""", """  __shared__ int votes[2][kMergeThreads / 32];
  int lo2[2], hi2[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int j = g ? j1 : j0;
    lo2[g] = max(j - D, 0);
    hi2[g] = min(j, B);
  }
  while (lo2[0] < hi2[0] || lo2[1] < hi2[1]) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int j = g ? j1 : j0;
      const int span = hi2[g] - lo2[g];
      const int c = span <= kMergeThreads
                        ? lo2[g] + tid
                        : lo2[g] + (int)((long long)tid * span / kMergeThreads);
      const bool p = span > 0 && c < hi2[g] &&
                     fresh_first(__ldg(fs + c), __ldg(fd + c),
                                 __ldg(ps + j - 1 - c), __ldg(pd + j - 1 - c));
      const int k = __popc(__ballot_sync(0xffffffffu, p));
      if ((tid & 31) == 0) votes[g][warp] = k;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int span = hi2[g] - lo2[g];
      if (span <= 0) continue;
      int k = 0;
      for (int w = 0; w < kMergeThreads / 32; ++w) k += votes[g][w];
      if (span <= kMergeThreads) {
        lo2[g] += k;
        hi2[g] = lo2[g];
      } else if (k == 0) {
        hi2[g] = lo2[g];
      } else {
        if (k < kMergeThreads)
          hi2[g] = lo2[g] + (int)((long long)k * span / kMergeThreads);
        lo2[g] += (int)((long long)(k - 1) * span / kMergeThreads) + 1;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    split[0] = lo2[0];
    split[1] = lo2[1];
  }
  __syncthreads();
""")
# the merge's one launch (a single merge is its S = 1 launch; the tool
# calls the single merge, so the earlier kernel's copy, which reads no
# session index, stands for it)
MERGE_LAUNCH = "    merge_pool_sorted_kernel<<<tiles, kMergeThreads, 0, s>>>("
BASE = "const long long base = (long long)blockIdx.x * blockDim.x;"
ROW = "const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;"
# name: (substitutions, the kernels timed against the copy)
ABLATIONS = {
    "earlier kernel (each thread its row as two int4 by __ldg, carveout "
    "left to the CUDA driver)": (THREAD_LOADS + NO_CARVEOUT, WARP_LOADED),
    "each thread its row as two int4 by __ldg": (THREAD_LOADS, WARP_LOADED),
    "shared-memory carveout left to the CUDA driver": (NO_CARVEOUT,
                                                       WARP_LOADED),
    "slots under L1 no-allocate and L2 evict-first, gathers under L2 "
    "evict-last": (helpers("evict-last") + [
        ("__ldg(q + lane)", "ld_stream(q + lane)"),
        ("__ldg(q + 32 + (lane ^ 1))", "ld_stream(q + 32 + (lane ^ 1))")],
        FUSED),
    "gathers not allocated in L1": (helpers("no L1"), FUSED),
    "8,448 bytes of idle shared memory a block, carveout left to the "
    "CUDA driver (L1 given up)": (NO_CARVEOUT + [
        ("  const size_t smem = (size_t)(block / 32) * sizeof(int);\n",
         "  const size_t smem = (size_t)(block / 32) * sizeof(int) + 8448;\n",
         2)], FUSED),
    "stream only (timing only: every slot gathers vals[n])": ([
        ("gather(vals, s[0], n + 1)",
         "gather(vals, s[0] == 123456789 ? 0 : n, n + 1)", 2),
        ("gather(vals, s[k], n + 1)",
         "gather(vals, s[k] == 123456789 ? 0 : n, n + 1)"),
        ("gather(vals, s, L)", "gather(vals, s == 123456789 ? 0 : L - 1, L)"),
        ("gather(vals, s[0], L)",
         "gather(vals, s[0] == 123456789 ? 0 : L - 1, L)", 2),
        ("gather(vals, s[k], L)",
         "gather(vals, s[k] == 123456789 ? 0 : L - 1, L)", 3)],
        WARP_LOADED),
    "gathers only (timing only: the slots of 262,144 rows spread over the "
    "pack, 2,048 tiles of 128 or 1,024 blocks of 256, over and over, kept "
    "in L2)": ([
        (BASE, "const long long base = (long long)(blockIdx.x % 2048 * "
               "(gridDim.x / 2048)) * blockDim.x;", 2),
        (ROW, "const long long r = (long long)(blockIdx.x % 1024 * "
              "(gridDim.x / 1024)) * blockDim.x + threadIdx.x;", 3)],
        WARP_LOADED),
    "blocks of 128 rows": ([("constexpr int kBlock = 256;",
                             "constexpr int kBlock = 128;")], CHAINED),
    "row_targets loaded before the slots": ([
        ("  const int kk = WARP8 ? 8 : K;\n  int s[32], w[32];\n"
         "  if (WARP8) {\n    warp_load_row8(ell_src, r, s);\n"
         "    warp_load_row8(ell_w, r, w);\n  } else {\n"
         "    load_row<false>(ell_src, r, kk, s);\n"
         "    load_row<false>(ell_w, r, kk, w);\n  }\n"
         "  const int t = __ldg(row_targets + r);\n",
         "  const int kk = WARP8 ? 8 : K;\n"
         "  const int t = __ldg(row_targets + r);\n  int s[32], w[32];\n"
         "  if (WARP8) {\n    warp_load_row8(ell_src, r, s);\n"
         "    warp_load_row8(ell_w, r, w);\n  } else {\n"
         "    load_row<false>(ell_src, r, kk, s);\n"
         "    load_row<false>(ell_w, r, kk, w);\n  }\n")],
        ("relax_rowargmin",)),
    **{f"hub cache: vals[0, {H:,}) staged in shared memory by every block "
       f"of a persistent grid": (hub_cache(H), ("relax_rowmin",))
       for H in HUBS},
    "earlier merge kernel (one thread a slot, a binary search of "
    "log2(B) + 2 rounds each)": ([
        (MERGE_TILE, EARLIER_MERGE),
        (MERGE_LAUNCH,
         "    int iters = 1;\n    while ((1 << iters) < B + 1) ++iters;\n"
         "    earlier_merge_kernel<<<(D + 255) / 256, 256, 0, s>>>("),
        ("(uint8_t*)oa, D, B);", "(uint8_t*)oa, D, B, 0, iters + 1);")],
        MERGE),
    **{f"merge tiles of {T:,} slots ({T // 256} a thread)": ([
        (MERGE_TILE, f"constexpr int kMergeTile = {T};")], MERGE)
       for T in (2048, 512)},
    "merge tiles of 1,024 slots on 128 threads (8 a thread)": ([
        ("constexpr int kMergeThreads = 256;",
         "constexpr int kMergeThreads = 128;")], MERGE),
    "merge: both splits by all 256 threads, 256 probes a round (2 rounds "
    "at B = 65,536)": ([BLOCK_SPLIT], MERGE),
    **{f"merge: both splits by all 256 threads, tiles of {T:,} slots": ([
        BLOCK_SPLIT, (MERGE_TILE, f"constexpr int kMergeTile = {T};")],
        MERGE) for T in (2048, 512)},
    "merge: splits only (timing only: a block returns after its two "
    "splits)": ([
        ("  const int a0 = split[0];\n",
         "  if (B > 0) {  // keeps the splits from being optimised away\n"
         "    if (tid == 0 && split[0] == -12345) os[0] = split[1];\n"
         "    return;\n  }\n  const int a0 = split[0];\n")], MERGE),
    "merge: no split searches (timing only: the splits of B / (D + B) of "
    "each diagonal, no loads)": ([
        ("const int a = warp_split(ps, pd, fs, fd, D, B, warp ? j1 : j0);",
         "const int a = (int)((long long)(warp ? j1 : j0) * B / "
         "((long long)D + B));")], MERGE),
    "merge: shared arrays not padded (a thread's slots share banks)": ([
        ("int pad(int i) { return i + (i >> 5); }",
         "int pad(int i) { return i; }")], MERGE),
    "merge: splits by a binary search on every lane (log2(B) dependent "
    "probes) for the warp's 32-way search": ([
        ("  int lo = max(j - D, 0), hi = min(j, B);\n  while (lo < hi) {\n"
         "    const int span",
         "  int lo = max(j - D, 0), hi = min(j, B);\n  while (lo < hi) {\n"
         "    const int mid = (lo + hi) >> 1;\n"
         "    if (fresh_first(__ldg(fs + mid), __ldg(fd + mid),\n"
         "                    __ldg(ps + j - 1 - mid), __ldg(pd + j - 1 - mid)))"
         "\n      lo = mid + 1;\n    else\n      hi = mid;\n  }\n"
         "  while (lo < hi) {\n    const int span")], MERGE),
}

# name: (substitutions, the kernels whose check it must fail); the
# control must pass every row kernel's
FAULTS = {
    "control (no fault)": ([], ()),
    "compaction offset shifted (tile t compacted into tile t - 1)": ([
        ("if (hit) rows[base + pos] = (int)r;",
         "if (hit) rows[(base ? base - blockDim.x : 0) + pos] = (int)r;")],
        FUSED),
    "last row of each tile never a hit": ([
        ("  compact_block(hit, r, base, R, warp_tot, rows, counts);\n",
         "  hit = hit && threadIdx.x + 1 < blockDim.x;\n"
         "  compact_block(hit, r, base, R, warp_tot, rows, counts);\n", 2)],
        FUSED),
    "fused kernels: padding slots skipped instead of gathering vals[n]": ([
        ("        relax_slot(s[k], w[k], vals, n + 1, rmin, rarg, reach);",
         "        if (s[k] != n) relax_slot(s[k], w[k], vals, n + 1, rmin, "
         "rarg, reach);"),
        ("        acc = __fadd_rn(acc, gather(vals, s[k], n + 1));",
         "        if (s[k] != n) acc = __fadd_rn(acc, gather(vals, s[k], "
         "n + 1));")], FUSED),
    "sentinel R not written after a tile's count": ([
        ("  if (tid >= total && r < R) rows[r] = R;\n", "")], FUSED),
    # rows 16-31 then take their halves in the other order, which only
    # the float sums' order can show: a min is the same in any order
    "warp load: second int4 not swapped between lane pairs (rows 16-31 "
    "take their halves swapped)": ([
        ("__ldg(q + 32 + (lane ^ 1))", "__ldg(q + 32 + lane)")],
        ("fused_spmv_rows", "spmv_rowsum")),
    "warp load: a row's second half from its first half's lane": ([
        ("j1 = j0 ^ 1;", "j1 = j0;")], WARP_LOADED),
    "warp load: rows 16-31 shuffled from the lanes of rows 0-15": ([
        ("const int j0 = ((2 * lane) & 31) | (lane >> 4), j1 = j0 ^ 1;",
         "const int j0 = (2 * lane) & 31, j1 = j0 ^ 1;")], WARP_LOADED),
    "spmv_rowsum: padding slots skipped instead of gathering vals[n]": ([
        ("acc = __fadd_rn(acc, gather(vals, s[k], L));",
         "if (s[k] != L - 1) acc = __fadd_rn(acc, gather(vals, s[k], L));")],
        ("spmv_rowsum",)),
    "relax_rowargmin: padding slots skipped instead of gathering "
    "vals[n]": ([
        ("    if (wrap_add(gather(vals, s[k], L), w[k]) == t)",
         "    if (s[k] == n) continue;\n"
         "    if (wrap_add(gather(vals, s[k], L), w[k]) == t)")],
        ("relax_rowargmin",)),
    "relax_rowmin: padding slots skipped instead of gathering vals[n]": ([
        ("    m = min(m, wrap_add(gather(vals, s[k], L), w[k]));",
         "    if (s[k] != L - 1) m = min(m, wrap_add(gather(vals, s[k], L), "
         "w[k]));")], ("relax_rowmin",)),
    "merge: ties to the batch": ([
        ("return fs < ps || (fs == ps && fd < pd);",
         "return fs < ps || (fs == ps && fd <= pd);")], MERGE),
    "merge: a tile's end split taken one diagonal early": ([
        ("warp_split(ps, pd, fs, fd, D, B, warp ? j1 : j0);",
         "warp_split(ps, pd, fs, fd, D, B, warp ? j1 - 1 : j0);")], MERGE),
    "merge: the last partial tile unwritten": ([
        ("  for (int i = tid; i < cnt; i += kMergeThreads) {",
         "  for (int i = tid; i < (cnt == kMergeTile ? cnt : 0);"
         " i += kMergeThreads) {")], MERGE),
    "merge: w and alive taken from the other list": ([
        ("      r_w[u] = s_w[x];\n      r_al[u] = s_al[x];",
         "      const int y = min(take_f ? q : f, pad(cnt - 1));\n"
         "      r_w[u] = s_w[y];\n      r_al[u] = s_al[y];")], MERGE),
}


def sources() -> dict:
    """{file name: text} of SOURCES as they stand."""
    return {name: (CSRC / name).read_text() for name in SOURCES}


def planted(texts: dict, subs) -> dict:
    """Each (old, new) or (old, new, count) of ``subs`` in every text of
    ``texts``; old must occur exactly once across them, or ``count``
    times."""
    texts = dict(texts)
    for old, new, *count in subs:
        want = count[0] if count else 1
        have = sum(t.count(old) for t in texts.values())
        if have != want:
            raise ValueError(f"{old!r} occurs {have} times, not {want}")
        texts = {k: t.replace(old, new) for k, t in texts.items()}
    return texts


def build(variants: dict, out_dir: pathlib.Path) -> dict:
    """{name: directory of the copy's libraries}, every ``.cu`` of every
    copy built at once."""
    from repro_torch.kernels import _build
    base = sources()
    procs = []
    dirs = {}
    for i, (name, subs) in enumerate(variants.items()):
        d = out_dir / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in planted(base, subs).items():
            (d / fname).write_text(text)
        dirs[name] = d
        for src in LIBS:
            so = d / f"lib{pathlib.Path(src).stem}.so"
            procs.append((name, subprocess.Popen(
                [_build._nvcc(), *_build.flags(CSRC / src), "-I", str(d),
                 "-o", str(so), str(d / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name!r}:\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return dirs


def entry_points(lib_dir) -> dict:
    from repro_torch.kernels import _build
    fns = {}
    for src, names in LIBS.items():
        lib = ctypes.CDLL(str(pathlib.Path(lib_dir) /
                              f"lib{pathlib.Path(src).stem}.so"))
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def use(fns: dict) -> None:
    """Put a copy's entry points in the wrappers' place (the wrappers
    reach them through ``_build.load()``)."""
    from repro_torch.kernels import _build
    lib = _build.load()
    _build._LIB = types.SimpleNamespace(**{**vars(lib), **fns})


def check_one(lib_dir, scale: int, kernels) -> int:
    """One copy (or, with no ``lib_dir``, the real kernels) through
    chip_smoke.check_rows for the row kernels among ``kernels`` and
    chip_smoke.check_merge for the merge: prints a verdict line a kernel
    and returns 0 if all pass, 1 if any fails (anything else is a
    crash)."""
    import torch
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import csr_relax as CK
    from repro_torch.kernels import repair as FK
    if lib_dir is not None:
        use(entry_points(lib_dir))
    failed = {}
    rows = [k for k in kernels if k in chip_smoke.ROW_KERNELS]
    checks = [lambda: chip_smoke.check_rows(torch, repro_torch, FK, CK,
                                            scale, rows)] if rows else []
    if "merge_pool_sorted" in kernels:
        checks.append(lambda: chip_smoke.check_merge(torch, FK))
    for check in checks:
        try:
            for line in check():
                print(f"[check] {line}", flush=True)
            torch.cuda.synchronize()
        except chip_smoke.RowMismatch as exc:
            failed.update(exc.failed)
    for k in kernels:
        print(f"[verdict] {k}: "
              f"{'fails: ' + failed[k][:240] if k in failed else 'passes'}",
              flush=True)
    return 1 if failed else 0


def faults(dirs: dict, scale: int) -> bool:
    import chip_smoke
    ok = True
    for name, lib_dir in dirs.items():
        must_fail = FAULTS[name][1]
        kernels = must_fail or chip_smoke.GRAPH_KERNELS
        proc = subprocess.run(
            [sys.executable, __file__, "check", str(lib_dir), "--scale",
             str(scale), "--kernels", ",".join(kernels)],
            capture_output=True, text=True, timeout=600)
        verdicts = dict(line[len("[verdict] "):].split(": ", 1)
                        for line in proc.stdout.splitlines()
                        if line.startswith("[verdict] "))
        crashed = proc.returncode not in (0, 1)
        if must_fail:
            expected = crashed or all(
                verdicts.get(k, "").startswith("fails") for k in kernels)
        else:
            expected = proc.returncode == 0
        ok &= expected
        print(f"[fault] {name}: {'crashes' if crashed else 'checked'}, "
              f"exit {proc.returncode}{'' if expected else ' -- WRONG'}",
              flush=True)
        for k in kernels:
            print(f"[fault]   {k}: {verdicts.get(k, 'no verdict')[:300]}",
                  flush=True)
        if crashed:
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
            for line in tail:
                print(f"[fault]   {line[:300]}", flush=True)
    return ok


def main_path_inputs(torch, scale: int, merge: bool):
    """The ELL pack of chip_smoke.py's graph and stream at ``scale``, the
    vals of a static SSSP and a static PageRank on it, and the rows'
    targets for relax_rowargmin (their vertices' min-plus); with
    ``merge``, also the diff pool after the SSSP stream and a batch drawn
    as chip_smoke.py draws it (else None)."""
    import numpy as np
    import chip_smoke
    import repro_torch
    from repro_torch.algos import pagerank, sssp
    from repro_torch.graph.csr import INF_W
    from repro_torch.kernels import ops as kops
    n, edges, w = repro_torch.rmat_graph(scale, chip_smoke.DEGREE, seed=0)
    csr = repro_torch.build_csr(n, edges, w, device="cuda")
    stream = repro_torch.random_updates(csr, percent=chip_smoke.PERCENT,
                                        seed=1)
    sess = repro_torch.bind_graph(csr, backend="cuda",
                                  capacity=2 * stream.num_adds)
    ell = sess.handle.ell
    block = sess.engine._config(sess.handle.g).row_block
    dist = sess.call(sssp.static_sssp, 0)["dist"]
    vals = torch.cat([torch.where(dist < INF_W, dist, INF_W).int(),
                      dist.new_full((1,), INF_W)])
    pr = sess.call(pagerank.static_pr, *chip_smoke.PR_KNOBS)
    fvals = torch.cat([pr["pr"] * pr["inv_outdeg"], pr["pr"].new_zeros(1)])
    vmin = kops.vertex_min_plus(ell, vals)
    tgt = torch.cat([vmin, vmin.new_full((1,), INF_W)])[
        ell.row2dst.clamp(max=ell.n)]
    lists = None
    if merge:
        s2 = repro_torch.bind_graph(csr, backend="cuda",
                                    capacity=2 * stream.num_adds)
        s2.run_stream(stream, chip_smoke.BATCH, sssp.stream_step,
                      s2.call(sssp.static_sssp, 0))
        g = s2.handle.g
        lists = ((g.d_src, g.d_dst, g.d_w, g.d_alive),
                 tuple(chip_smoke.merge_batch(torch, np, g, n)))
    return ell, block, vals, fvals, tgt, lists


def ablations(dirs: dict, scale: int) -> bool:
    import torch
    import chip_smoke
    from repro_torch.kernels import csr_relax as CK
    from repro_torch.kernels import repair as FK
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    wanted = {k for v in dirs.values() for k in v[1]}
    ell, block, vals, fvals, tgt, lists = main_path_inputs(
        torch, scale, "merge_pool_sorted" in wanted)
    R, K, n = ell.R, ell.K, ell.n
    src, w = ell.ell_src, ell.ell_w
    print(f"[ablation] R={R} K={K} n={n} tile {block}", flush=True)
    live = src != n
    for H in HUBS:
        hub = (src >= 0) & (src < H)
        print(f"[ablation] slots with a source id below {H:,}: "
              f"{float(hub.double().mean()):.4f} of all {src.numel():,}, "
              f"{float(hub[live].double().mean()):.4f} of the "
              f"{int(live.sum()):,} that are not padding", flush=True)
    del live, hub
    kernels = {
        "fused_relax_rows": (
            (src, w, vals),
            lambda: FK.fused_relax_rows(src, w, vals, block=block),
            lambda: FK.fused_relax_rows_plain(src, w, vals, block)),
        "fused_spmv_rows": (
            (src, ell.row2dst, fvals),
            lambda: FK.fused_spmv_rows(src, ell.row2dst, fvals, block=block),
            lambda: FK.fused_spmv_rows_plain(src, ell.row2dst, fvals,
                                             block)),
        "spmv_rowsum": (
            (src, fvals), lambda: CK.spmv_rowsum(src, fvals),
            lambda: CK.spmv_rowsum_plain(src, fvals)),
        "relax_rowargmin": (
            (src, w, vals, tgt),
            lambda: CK.relax_rowargmin(src, w, vals, tgt, n=n),
            lambda: CK.relax_rowargmin_plain(src, w, vals, tgt, n)),
        "relax_rowmin": (
            (src, w, vals), lambda: CK.relax_rowmin(src, w, vals),
            lambda: CK.relax_rowmin_plain(src, w, vals)),
    }
    if lists is not None:
        pool, fresh = lists
        print(f"[ablation] merge: D={pool[0].shape[0]} B={fresh[0].shape[0]}"
              f" ({int((pool[0] < n).sum())} pool rows used)", flush=True)
        kernels["merge_pool_sorted"] = (
            (*pool, *fresh), lambda: FK.merge_pool_sorted(*pool, *fresh, n=n),
            lambda: FK.merge_pool_sorted_plain(*pool, *fresh, n))
    real = entry_points(dirs.pop("kernel")[0])
    copies = {name: entry_points(d) for name, (d, _) in dirs.items()}
    ok = True
    def launch(fn):
        with chip_smoke.junk_outputs(torch):
            got = chip_smoke.outputs(fn())
        torch.cuda.synchronize()
        return got

    for kname, (inputs, fn, plain) in kernels.items():
        if kname not in wanted:
            continue
        use(real)
        want = chip_smoke.outputs(plain())
        got = launch(fn)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        ok &= exact
        b_ms = chip_smoke.bound(chip_smoke.nbytes(*inputs, *got), 0)[0]
        del got
        print(f"[ablation] {kname}: the kernel is "
              f"{'bit-exact' if exact else 'NOT bit-exact'}, bound "
              f"{b_ms:.4f} ms by bytes", flush=True)
        for name, fns in copies.items():
            if kname not in ABLATIONS[name][1]:
                continue
            use(fns)
            got = launch(fn)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            del got
            if "timing only" not in name:
                ok &= same
            ms = {}
            for which in ("kernel", "copy", "copy", "kernel"):
                use(real if which == "kernel" else fns)
                ms.setdefault(which, []).append(
                    chip_smoke.median_ms(torch, fn, 20, flush))
            print(f"[ablation] {kname}, {name}: copy "
                  f"{ms['copy'][0]:.4f} / {ms['copy'][1]:.4f} ms, kernel "
                  f"{ms['kernel'][0]:.4f} / {ms['kernel'][1]:.4f} ms "
                  f"({'bit-exact' if same else 'differs'})", flush=True)
    use(real)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("faults", "ablations", "check"))
    ap.add_argument("lib", nargs="?",
                    help="check: the directory of the copy's libraries "
                         "(default: the kernels in csrc/)")
    ap.add_argument("--scale", type=int, default=None,
                    help="RMAT scale (faults: 18, ablations: 22)")
    ap.add_argument("--kernels", default=None,
                    help="check: the graph kernels to check, "
                         "comma-separated (default: all)")
    ap.add_argument("--out", default=str(ROOT / "build" / "row_variants"))
    ap.add_argument("--only", default=None,
                    help="ablations: only the copies whose name holds "
                         "this text")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("row_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    if args.what == "check":
        kernels = (args.kernels.split(",") if args.kernels
                   else chip_smoke.GRAPH_KERNELS)
        return check_one(args.lib, args.scale or 18, kernels)
    print(chip_smoke.nvidia_smi(), flush=True)
    if args.what == "faults":
        dirs = build({k: v[0] for k, v in FAULTS.items()},
                     pathlib.Path(args.out) / "faults")
        ok = faults(dirs, args.scale or 18)
    else:
        keep = {k: v[0] for k, v in ABLATIONS.items()
                if args.only is None or args.only in k}
        dirs = build({"kernel": [], **keep},
                     pathlib.Path(args.out) / "ablations")
        ok = ablations({k: (d, ABLATIONS[k][1] if k in ABLATIONS else ())
                        for k, d in dirs.items()}, args.scale or 22)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
