// Flash-attention forward on Hopper (sm_90a).  Bound to PyTorch through a
// plain C interface (ctypes) by src/repro_torch/kernels/flash_attention.py,
// which also holds the plain PyTorch version.  The entry point launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// flash_attention
//   Replaces: src/repro/kernels/flash_attention.py flash_attention
//   (_flash_kernel), the Pallas TPU forward.  q, k, v, o: (BH, S, dh),
//   float32 or bf16, kv heads already repeated.  Per row i of each bh:
//     q_i   = q[i] * dh^-0.5, rounded to q's type
//     s_ij  = q_i . k_j in float32; tanh(s/cap)*cap with a softcap;
//             -1e30 where j > i (causal), i - j >= W (a window W, causal
//             only: the reference model's local attention) or j >= S
//     o[i]  = sum_j p_ij v_j / max(sum_j p_ij, 1e-20), cast to q's type
//   with p_ij the online softmax over KV tiles: running max m and
//   denominator l in float32 (l sums the unrounded p), p = exp(s - m) cast
//   to v's type before the P.V product (the reference's cast point), the
//   accumulator in float32.  The TPU grid's sequential KV axis and its
//   VMEM scratch become a loop over KV tiles inside one block, whose state
//   stays in registers; one block handles one (bh, q tile).  Causal blocks
//   stop at their diagonal tile (the tiles past it are fully masked and
//   change no output), and the heaviest q tiles are issued first.  With a
//   window a block starts at the KV tile that holds its first row's
//   lowest key in reach (the tiles below it change no output either), and
//   the tiles at the window's lower edge take the masked softmax.  A
//   window can leave a row's whole first tile masked (causal attention
//   alone never does: key 0 is in every row's reach).  The reference then
//   gives those scores p = 1, and the row's next tile, the first with a
//   real max, multiplies l and acc by exactly 0; the kernels keep that
//   result exactly (see softmax_tile and the CUDA-core loop).  A
//   ragged S is masked at the edge (the TPU grid's S // bq leaves the tail
//   unwritten; this kernel writes every row).  Given an ``lse`` pointer
//   (the training forward), each row's float32 log-sum-exp m + log(l')
//   (l' = max(l, 1e-20), the divisor) goes to lse[bh * S + row], what
//   the backward (flash_attention_bwd.cu) recomputes P from; with a null
//   pointer nothing else changes.
//   Bound on this card, at the LM prefill of starcoder2-7b (BH = 4 * 36,
//   S = 2048, dh = 128, bf16, causal): operations — the causal half of
//   4 * S^2 * dh * BH = 1.55e11 FLOP at 989 TFLOP/s bf16 is 0.156 ms,
//   against 302 MB of q, k, v and o at 3.35 TB/s, 0.090 ms.  So the
//   tensor cores have to be kept busy: only wgmma reaches their full rate,
//   and the tile loads and the softmax must not leave them idle.
//   Two designs, one contract:
//   * bf16 with dh 64 or 128 (flash_wgmma_kernel): 384 threads in three
//     warpgroups, one block of 128 q rows.  A producer warpgroup (its
//     registers given up with setmaxnreg) has one thread load Q once and
//     K and V tile by tile with TMA into a ring of 128-key stages (2 at
//     dh 128, 3 at dh 64), each with full and empty mbarriers, so the
//     next tiles are in flight while the current one is computed.  Two
//     consumer warpgroups of 64 q rows each (240 registers) compute
//     S = Q.K^T with wgmma m64n128k16 from shared memory (Q scaled and
//     rounded in place once) and O += P.V with wgmma, P from registers in
//     the layout the S accumulator already has and V read in its natural
//     (key, dh) layout through the operand's transpose bit (no transpose
//     pass).  Each tile's Q.K^T is issued with the previous tile's P.V,
//     so the softmax (exp2 of an fma: one MUFU a score) runs while the
//     tensor cores finish P.V.  TMA writes 128-byte swizzled boxes of 64
//     columns that the wgmma descriptors read as they are.  The tensor
//     maps are 3-D over (dh, S, BH), so a tile at a ragged edge reads
//     zeros and never the next head's rows, and the output, staged in
//     shared memory, goes out by TMA without the rows past S.  A head's
//     q tiles are neighbours in the grid, so K and V come from L2 after
//     the first block of a head reads them (with the heads side by side,
//     the blocks on the card at once stream more K and V than L2 holds).
//   * everything else (float32, where the tensor cores' TF32 would miss
//     the reference's 1e-5; bf16 of other widths): CUDA cores.  4 warps,
//     4 q rows each; per 32-key tile lane j scores key j against the row,
//     the warp reduces max and sum by shuffles, and each lane accumulates
//     dh/32 output columns.  Explicit fmaf.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: the reference's casts (q * scale, p.astype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// the window is INT_MAX where there is none, so row - key never reaches it
__device__ __forceinline__ bool masked(int key, int row, int S, int causal,
                                       int window) {
  return key >= S || (causal && key > row) || row - key >= window;
}

__device__ __forceinline__ float softcap_mask(float s, float softcap, int key,
                                              int row, int S, int causal,
                                              int window) {
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  return masked(key, row, S, causal, window) ? NEG : s;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16, dh 64 / 128: TMA ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;               // q rows per block: 2 consumers x 64
constexpr int WG_BK = 128;               // keys per ring stage
constexpr int BOX_BYTES = 128 * 128;     // one TMA box: 128 rows x 64 bf16
constexpr int SWIZZLE_ROWS_BYTES = 1024; // one swizzle atom: 8 rows x 128 B
constexpr int CONSUMER_REGS = 240;       // 128 x 24 + 256 x 240 <= 65,536
constexpr int PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also tells the barrier to wait for ``bytes`` of copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one (64 columns, 128 rows, 1 head) box of a (dh, S, BH) tensor map into
// shared memory, 128-byte swizzled; rows past S arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int bh,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bh),
      "r"(bar)
      : "memory");
}

// one (64 columns, 64 rows, 1 head) box from shared memory (128-byte
// swizzled) into a (dh, S, BH) tensor map; rows past S are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// a shared-memory operand of wgmma in the 128-byte swizzle that TMA wrote:
// start address, leading and stride byte offsets in 16-byte units, and the
// layout type (1: 128-byte swizzle).  Stride = one swizzle atom (8 rows)
// along the rows of the tile; leading = the next 64-column box, which only
// an MN-major operand wider than 64 reads.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t leading) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(leading >> 4) << 16) |
         ((uint64_t)(SWIZZLE_ROWS_BYTES >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// returns once at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins a wgmma accumulator in program order: nothing that reads or writes
// it moves across this point (wgmma writes it asynchronously)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, float32) (+)= A (64 x 16) . B (16 x 128), A and B in shared
// memory, both K-major (their 16-deep rows contiguous)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers, the m16n8k16
// A-fragment layout per warp) . B (16 x 128) in shared memory, MN-major
// (its 128-wide rows contiguous: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers, the m16n8k16
// A-fragment layout per warp) . B (16 x 64) in shared memory, MN-major
// (its 64-wide rows contiguous: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q.K^T for a consumer's 64 rows and a stage's 128 keys, DH / 16
// steps of 16 columns (column 64 starts the next 128-byte box); committed
template <int DH>
__device__ __forceinline__ void qk_tile(float (&s)[64], uint32_t q,
                                        uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t col = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
    wgmma_ss_n128(s, sw128_desc(q + col, 16), sw128_desc(k + col, 16),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P.V over a stage's 128 keys, 8 steps of 16 keys (16 rows of 128
// bytes in each box); V is MN-major, its second box of 64 columns one
// BOX_BYTES on; committed
template <int DH>
__device__ __forceinline__ void pv_tile(float (&acc)[DH / 2],
                                        const uint32_t (&p)[8][4],
                                        uint32_t v) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint64_t db = sw128_desc(v + c * 16 * 128, BOX_BYTES);
    if constexpr (DH == 128)
      wgmma_rs_n128(acc, p[c], db);
    else
      wgmma_rs_n64(acc, p[c], db);
  }
  wgmma_commit();
}

// one arrival per warp on an empty barrier, once the warp is done
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The online softmax of one S tile of a consumer (64 rows x 128 keys, in
// the accumulator layout: element i is key k0 + 8 (i / 4) + 2t + (i & 1)
// of row (i & 2) ? r0 + 8 : r0): softcap, mask (``edge``: the diagonal
// tile, one past S or one at the window's lower edge), the running max m
// and denominator l (over the unrounded p), alpha = exp(m_old - m_new),
// and s = exp(s - m_new), each exp taken as exp2 of an fma with log2 e
// (one fma and one MUFU.EX2 a score, where the accurate expf spends
// several more).  A row whose scores are all masked so far (max -1e30:
// only a window's first tile gives one) takes 0 for the max's product
// with log2 e: the fma would otherwise read the rounding of -1e30 * log2
// e (~1e23) and give inf, then NaN.  Its p and alpha are then exactly 0
// where the reference has p = 1 and alpha = 1; both leave l and acc
// exactly 0 once the row's first real max multiplies them by 0.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int r0, int t, int S,
                                             int causal, int window, bool edge,
                                             float softcap) {
  if (softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = tanhf(s[i] / softcap) * softcap;
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const int row = (i & 2) ? r0 + 8 : r0;
      if (masked(key, row, S, causal, window)) s[i] = NEG;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
  }
  // exp(x) as exp2(x log2 e), the max folded into one fma per score
  const float mxl[2] = {mx[0] == NEG ? 0.f : mx[0] * LOG2E,
                        mx[1] == NEG ? 0.f : mx[1] * LOG2E};
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = exp2f(fmaf(s[i], LOG2E, -mxl[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(FULL, rs[h], 1);
    rs[h] += __shfl_xor_sync(FULL, rs[h], 2);
    alpha[h] = exp2f(fmaf(m[h], LOG2E, -mxl[h]));
    l[h] = l[h] * alpha[h] + rs[h];
    m[h] = mx[h];
  }
}

// a / b rounded to nearest, from rb = 1 / b rounded to nearest: the
// quotient a * rb corrected once by its exact fma residual (Markstein),
// as the compiler's own division does after refining its reciprocal;
// one division a row in place of one an output
__device__ __forceinline__ float quotient(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-q, b, a), rb, q);
}

// P in bf16 as the A operand of P.V: keys 16c..16c+15 of a softmax tile
// are its 8-key groups 2c and 2c + 1
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&p)[8][4]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    p[c][0] = pack2(s[8 * c + 0], s[8 * c + 1]);
    p[c][1] = pack2(s[8 * c + 2], s[8 * c + 3]);
    p[c][2] = pack2(s[8 * c + 4], s[8 * c + 5]);
    p[c][3] = pack2(s[8 * c + 6], s[8 * c + 7]);
  }
}

template <int DH, int NS>
constexpr size_t wgmma_smem() {
  // Q, NS stages of K and of V, the barriers, and room to align to 1 KB
  return (size_t)(DH / 64) * BOX_BYTES * (1 + 2 * NS) + 8 * (1 + 4 * NS) +
         1024;
}

// One block owns one (bh, 128-row q tile).  Warpgroup 0 is the producer:
// one thread loads Q once and then K and V tile by tile into a ring of NS
// stages with TMA.  Warpgroups 1 and 2 consume 64 q rows each: S = Q.K^T
// by wgmma (both operands in shared memory), the online softmax in
// registers, then O += P.V by wgmma with P from registers and V read
// MN-major.  Barriers: qbar (Q landed), full_k / full_v (a stage's K / V
// landed) and empty_k / empty_v (all 8 consumer warps are done with a
// stage's K / V: its S read, its P.V retired).
template <int DH, int NS>
__global__ void __launch_bounds__(384, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       float* __restrict__ lse, int S, int causal, int window,
                       float scale, float softcap) {
  constexpr int NB = DH / 64;            // 64-column boxes in a tile row
  constexpr int TILE = NB * BOX_BYTES;   // one 128-row tile of Q, K or V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  uint8_t* const qs = smem_raw + (base - raw);
  const uint32_t sq = base, sk = base + TILE, sv = base + TILE * (1 + NS);
  const uint32_t qbar = base + TILE * (1 + 2 * NS);
  const uint32_t full_k = qbar + 8, full_v = full_k + 8 * NS,
                 empty_k = full_v + 8 * NS, empty_v = empty_k + 8 * NS;

  // one head's q tiles are neighbours in the grid, heaviest first, so the
  // blocks on the card at once share few heads and find K and V in L2
  const int nqt = (S + WG_BQ - 1) / WG_BQ;
  const int bh = blockIdx.x / nqt;
  const int qt = nqt - 1 - blockIdx.x % nqt;
  const int q0 = qt * WG_BQ;
  // a window: key tiles from jlo, the tile of the first row's lowest key
  // in reach (those below change no output); causal: up to qt (those past
  // the diagonal change no output either); the producer and the consumers
  // walk the same tiles, so the ring's stages and phases agree
  const int jlo = q0 - window + 1 > 0 ? (q0 - window + 1) / WG_BK : 0;
  const int jend = causal ? qt + 1 : (S + WG_BK - 1) / WG_BK;
  // the tiles with a key below the window of the tile's last row
  const int lower_edge = q0 + WG_BQ - window;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);
      mbar_init(empty_v + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, TILE);
      for (int b = 0; b < NB; ++b)
        tma_load(sq + b * BOX_BYTES, &tq, b * 64, q0, bh, qbar);
      int stage = 0, phase = 0;
      for (int j = jlo; j < jend; ++j) {
        const uint32_t kdst = sk + stage * TILE, vdst = sv + stage * TILE;
        mbar_wait(empty_k + 8 * stage, phase ^ 1);   // round 0 passes
        mbar_expect_tx(full_k + 8 * stage, TILE);
        for (int b = 0; b < NB; ++b)
          tma_load(kdst + b * BOX_BYTES, &tk, b * 64, j * WG_BK, bh,
                   full_k + 8 * stage);
        mbar_wait(empty_v + 8 * stage, phase ^ 1);
        mbar_expect_tx(full_v + 8 * stage, TILE);
        for (int b = 0; b < NB; ++b)
          tma_load(vdst + b * BOX_BYTES, &tv, b * 64, j * WG_BK, bh,
                   full_v + 8 * stage);
        if (++stage == NS) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;   // consumer 0 or 1
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // this thread's rows of the accumulators: r0 (elements 0, 1 of each
    // 8-column group) and r0 + 8 (elements 2, 3)
    const int r0 = q0 + cw * 64 + warp * 16 + g;

    // q * scale rounded to bf16, once, in place: the consumer's 64 rows of
    // each box (elementwise, so the swizzle does not matter); then make the
    // generic-proxy writes visible to wgmma and wait for the warpgroup
    mbar_wait(qbar, 0);
    for (int i = tid; i < NB * 64 * 8; i += 128) {
      uint4* p = reinterpret_cast<uint4*>(qs + (i >> 9) * BOX_BYTES +
                                          cw * 64 * 128 + (i & 511) * 16);
      uint4 x = *p;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = __bfloat1622float2(e[h]);
        e[h] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *p = x;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float s[64];
    uint32_t p[8][4];

    // Tile j's S = Q.K^T and tile j - 1's O += P.V are issued together;
    // the softmax of tile j runs while the tensor cores finish P.V, and
    // O is rescaled by tile j's alpha once P.V has retired:
    //   O_j = (O_{j-1} + P_{j-1} V_{j-1}) * exp(m_{j-1} - m_j)
    // K of a stage is released once its S is read, V once its P.V is.
    // Tile 0 is peeled off, so that no branch sits between a wgmma and
    // the wait that retires it.
    mbar_wait(full_k, 0);
    wgmma_fence();
    qk_tile<DH>(s, sq + cw * 64 * 128, sk);
    wgmma_wait<0>();
    fence_regs(s);
    release(empty_k, lane);
    softmax_tile(s, m, l, alpha, jlo * WG_BK, r0, t, S, causal, window,
                 (causal && jlo == qt) || (jlo + 1) * WG_BK > S ||
                     jlo * WG_BK < lower_edge,
                 softcap);
    pack_p(s, p);

    int stage = 0, phase = 0;   // tile j - 1's
    for (int j = jlo + 1; j < jend; ++j) {
      const int k0 = j * WG_BK;
      const int next = stage + 1 == NS ? 0 : stage + 1;
      const int next_phase = next == 0 ? phase ^ 1 : phase;
      mbar_wait(full_k + 8 * next, next_phase);
      mbar_wait(full_v + 8 * stage, phase);
      fence_regs(acc);
      wgmma_fence();
      qk_tile<DH>(s, sq + cw * 64 * 128, sk + next * TILE);
      pv_tile<DH>(acc, p, sv + stage * TILE);
      wgmma_wait<1>();   // S is ready, P.V may still run
      fence_regs(s);
      release(empty_k + 8 * next, lane);
      softmax_tile(s, m, l, alpha, k0, r0, t, S, causal, window,
                   (causal && j == qt) || k0 + WG_BK > S || k0 < lower_edge,
                   softcap);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_v + 8 * stage, lane);
      pack_p(s, p);   // only now: the last P.V read the previous P
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      stage = next;
      phase = next_phase;
    }
    // the last tile's P.V
    mbar_wait(full_v + 8 * stage, phase);
    fence_regs(acc);
    wgmma_fence();
    pv_tile<DH>(acc, p, sv + stage * TILE);
    wgmma_wait<0>();
    fence_regs(acc);

    // O / max(l, 1e-20) in bf16, staged in this consumer's rows of the Q
    // tile (its last S has been read) in the swizzle TMA expects: the
    // 16-byte chunk n % 8 of row r sits at chunk (n % 8) ^ (r % 8), and
    // r % 8 = g for both of this thread's rows; then one thread stores
    // the consumer's 64 rows with TMA, which drops the rows past S
    const float den[2] = {fmaxf(l[0], 1e-20f), fmaxf(l[1], 1e-20f)};
    const float rd[2] = {1.f / den[0], 1.f / den[1]};
    if (lse != nullptr && t == 0) {   // the quad's four threads share m, l
      if (r0 < S) lse[(size_t)bh * S + r0] = m[0] + logf(den[0]);
      if (r0 + 8 < S) lse[(size_t)bh * S + r0 + 8] = m[1] + logf(den[1]);
    }
    uint8_t* const os = qs + cw * 64 * 128 + (warp * 16 + g) * 128 + 4 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      uint8_t* const at = os + (n >> 3) * BOX_BYTES + (((n & 7) ^ g) << 4);
      *reinterpret_cast<uint32_t*>(at) =
          pack2(quotient(acc[4 * n], den[0], rd[0]),
                quotient(acc[4 * n + 1], den[0], rd[0]));
      *reinterpret_cast<uint32_t*>(at + 8 * 128) =
          pack2(quotient(acc[4 * n + 2], den[1], rd[1]),
                quotient(acc[4 * n + 3], den[1], rd[1]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (tid == 0 && q0 + cw * 64 < S) {
      for (int b = 0; b < NB; ++b)
        tma_store(&to, sq + b * BOX_BYTES + cw * 64 * 128, b * 64,
                  q0 + cw * 64, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime, so
// that nothing links -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D map over (dh, S, BH): boxes of 64 columns x ``rows`` rows of one
// head, so a box never reaches into the next head (rows past S read as
// zeros and are not written)
bool head_map(CUtensorMap* map, const void* x, int BH, int S, int dh,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)S * dh * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int NS>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int BH, int S, int causal, int window,
                 float scale, float softcap, cudaStream_t st) {
  CUtensorMap tq, tk, tv, to;
  if (!head_map(&tq, q, BH, S, DH, WG_BQ) ||
      !head_map(&tk, k, BH, S, DH, WG_BK) ||
      !head_map(&tv, v, BH, S, DH, WG_BK) ||
      !head_map(&to, o, BH, S, DH, WG_BQ / 2))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wgmma_smem<DH, NS>();
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<DH, NS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const unsigned grid = (unsigned)BH * ((S + WG_BQ - 1) / WG_BQ);
  flash_wgmma_kernel<DH, NS><<<grid, 384, smem, st>>>(
      tq, tk, tv, to, lse, S, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// any type and dh <= 256: CUDA cores
// ---------------------------------------------------------------------------

constexpr int SIMT_BQ = 16;   // q rows per block: 4 warps x 4
constexpr int SIMT_BK = 32;   // keys per tile: one a lane
constexpr int SIMT_RPW = SIMT_BQ / 4;

size_t simt_smem(int dh) {
  return sizeof(float) *
         ((size_t)SIMT_BQ * dh + (size_t)SIMT_BK * (dh + 1) +
          (size_t)SIMT_BK * dh);
}

// DPL: output columns a lane owns (lane, lane + 32, ...), DPL * 32 >= dh
template <typename T, int DPL>
__global__ void __launch_bounds__(128)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int S, int dh, int causal,
                      int window, float scale, float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [BQ][dh], scaled and rounded
  float* ks = qs + SIMT_BQ * dh;           // [BK][dh + 1], padded
  float* vs = ks + SIMT_BK * (dh + 1);     // [BK][dh]
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * SIMT_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)bh * S * dh;

  for (int i = threadIdx.x; i < SIMT_BQ * dh; i += blockDim.x) {
    const int r = i / dh;
    qs[i] = q0 + r < S
                ? round_to<T>(to_float(q[base + (size_t)q0 * dh + i]) * scale)
                : 0.f;
  }
  float m[SIMT_RPW], l[SIMT_RPW], acc[SIMT_RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < SIMT_RPW; ++rr) {
    m[rr] = NEG;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  // the tiles past the diagonal and, with a window, those below the first
  // row's lowest key in reach change no output.  A row whose first tile is
  // all masked takes p = exp(-1e30 - -1e30) = 1 and alpha = 1 there, as
  // the reference does, and its next tile's alpha = 0 clears them exactly.
  const int kend = causal ? min(S, q0 + SIMT_BQ) : S;
  const int kstart =
      q0 - window + 1 > 0 ? (q0 - window + 1) / SIMT_BK * SIMT_BK : 0;
  for (int k0 = kstart; k0 < kend; k0 += SIMT_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < SIMT_BK * dh; i += blockDim.x) {
      const int r = i / dh, d = i % dh;
      const bool ok = k0 + r < S;
      const size_t at = base + (size_t)k0 * dh + i;
      ks[r * (dh + 1) + d] = ok ? to_float(k[at]) : 0.f;
      vs[i] = ok ? to_float(v[at]) : 0.f;
    }
    __syncthreads();
    const float* kr = ks + lane * (dh + 1);
#pragma unroll
    for (int rr = 0; rr < SIMT_RPW; ++rr) {
      const int r = warp * SIMT_RPW + rr;
      const float* qr = qs + r * dh;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
      s = softcap_mask(s, softcap, k0 + lane, q0 + r, S, causal, window);
      float mx = fmaxf(m[rr], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float p = expf(s - mx);
      const float alpha = expf(m[rr] - mx);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(FULL, ps, off);
      l[rr] = l[rr] * alpha + ps;
      m[rr] = mx;
      const float pv = round_to<T>(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
      for (int j = 0; j < SIMT_BK; ++j) {
        const float pj = __shfl_sync(FULL, pv, j);
        const float* vr = vs + j * dh;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < dh) acc[rr][i] = fmaf(pj, vr[d], acc[rr][i]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < SIMT_RPW; ++rr) {
    const int row = q0 + warp * SIMT_RPW + rr;
    if (row >= S) continue;
    const float den = fmaxf(l[rr], 1e-20f);
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * S + row] = m[rr] + logf(den);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) o[base + (size_t)row * dh + d] = from_float<T>(acc[rr][i] / den);
    }
  }
}

template <typename T, int DPL>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int BH, int S, int dh, int causal, int window,
                float scale, float softcap, cudaStream_t st) {
  const size_t smem = simt_smem(dh);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_simt_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(BH, (S + SIMT_BQ - 1) / SIMT_BQ);
  flash_simt_kernel<T, DPL><<<grid, 128, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, dh, causal,
      window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* o,
                  float* lse, int BH, int S, int dh, int causal, int window,
                  float scale, float softcap, cudaStream_t st) {
  if (dh <= 32)
    return launch_simt<T, 1>(q, k, v, o, lse, BH, S, dh, causal, window,
                             scale, softcap, st);
  if (dh <= 64)
    return launch_simt<T, 2>(q, k, v, o, lse, BH, S, dh, causal, window,
                             scale, softcap, st);
  if (dh <= 128)
    return launch_simt<T, 4>(q, k, v, o, lse, BH, S, dh, causal, window,
                             scale, softcap, st);
  return launch_simt<T, 8>(q, k, v, o, lse, BH, S, dh, causal, window, scale,
                           softcap, st);
}

}  // namespace

// q, k, v, o: (BH, S, dh) contiguous, 16-byte aligned; lse: float32
// (BH, S), or null for none; is_bf16 selects bf16 over float32; window > 0
// masks keys window or more behind the row (causal only), 0 means none;
// scale is dh^-0.5 already rounded to q's type (the reference multiplies q
// by a weakly typed scalar); softcap <= 0 means none.  dh <= 256,
// S <= 65535 * 16.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int BH, int S, int dh, int is_bf16,
                                     int causal, int window, float scale,
                                     float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0) return 0;
  if (dh <= 0 || dh > 256 || window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  const int win = window > 0 ? window : INT_MAX;
  if (is_bf16 && dh == 128)
    return launch_wgmma<128, 2>(q, k, v, o, lse, BH, S, causal, win, scale,
                                softcap, st);
  if (is_bf16 && dh == 64)
    return launch_wgmma<64, 3>(q, k, v, o, lse, BH, S, causal, win, scale,
                               softcap, st);
  if (is_bf16)
    return dispatch_simt<bf16>(q, k, v, o, lse, BH, S, dh, causal, win,
                               scale, softcap, st);
  return dispatch_simt<float>(q, k, v, o, lse, BH, S, dh, causal, win, scale,
                              softcap, st);
}
