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
//   * bf16 with dh 64, 128 or 256 (flash_wgmma_kernel<DH, NS, BK>): 384
//     threads in three warpgroups, one block of 128 q rows.  A producer
//     warpgroup (its registers given up with setmaxnreg) has one thread
//     load Q once and K and V tile by tile with TMA into a ring of NS
//     stages of BK keys, each with full and empty mbarriers, so the next
//     tiles are in flight while the current one is computed.  Two consumer
//     warpgroups of 64 q rows each (240 registers) compute S = Q.K^T with
//     wgmma from shared memory (Q scaled and rounded in place once) and
//     O += P.V with wgmma, P from registers in the layout the S
//     accumulator already has and V read in its natural (key, dh) layout
//     through the operand's transpose bit (no transpose pass).  Each
//     tile's Q.K^T is issued with the previous tile's P.V, so the softmax
//     (exp2 of an fma: one MUFU a score) runs while the tensor cores
//     finish P.V.  TMA writes 128-byte swizzled boxes of 64 columns that
//     the wgmma descriptors read as they are.  The tensor maps are 3-D
//     over (dh, S, BH), so a tile at a ragged edge reads zeros and never
//     the next head's rows, and the output, staged in shared memory, goes
//     out by TMA without the rows past S.  A head's q tiles are
//     neighbours in the grid, so K and V come from L2 after the first
//     block of a head reads them (with the heads side by side, the blocks
//     on the card at once stream more K and V than L2 holds).
//     The budget per width (a consumer thread holds O: DH / 2 floats, S:
//     BK / 2, P packed: BK / 4; shared memory Q 128 x DH and NS stages of
//     K and V, BK x DH each, in bf16):
//       dh  64: BK 128, NS 3; registers 32 + 64 + 32; 16 + 96 KB
//       dh 128: BK 128, NS 2; registers 64 + 64 + 32; 32 + 128 KB
//       dh 256: BK 64, NS 2; registers 128 + 32 + 16 (176 of 240 before
//               addresses, m and l; a 128-key stage would need 224);
//               64 + 128 KB = 193 KB with the barriers and the 1 KB
//               alignment, of the 227 KB a block may have.  O += P.V is
//               two m64n128k16 products a 16-key step (columns 0-127 and
//               128-255), S = Q.K^T 16 steps of m64n64k16 over 4 boxes.
//     gemma2-9b's global prefill (BH 32, S 7,168, dh 256, causal, softcap
//     50) is bound by operations: 4 * dh * BH * S (S + 1) / 2 = 842 GFLOP
//     at 989 TFLOP/s, 0.851 ms, against 470 MB at 3.35 TB/s, 0.140 ms;
//     the softcap adds one MUFU.EX2 and one MUFU.RCP a score to the
//     softmax's one, where the products do 4 dh = 1,024 FLOP a score.
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

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16, dh 64 / 128 / 256: TMA ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;                      // q rows a block: 2 x 64
constexpr int Q_BOX = WG_BQ * BOX_ROW_BYTES;    // one TMA box of Q: 16 KB
constexpr int CONSUMER_REGS = 240;       // 128 x 24 + 256 x 240 <= 65,536
constexpr int PRODUCER_REGS = 24;

// The online softmax of one S tile of a consumer (64 rows x 2N keys, in
// the accumulator layout: element i is key k0 + 8 (i / 4) + 2t + (i & 1)
// of row (i & 2) ? r0 + 8 : r0): softcap, mask (``edge``: a tile on the
// diagonal, past S or at the window's lower edge), the running max m and
// denominator l (over the unrounded p), alpha = exp(m_old - m_new), and
// s = exp(s - m_new), each exp taken as exp2 of an fma with log2 e (one
// fma and one MUFU.EX2 a score, where the accurate expf spends several
// more).  With EX2_CAP (dh 256) the softcap tanh(s / cap) cap is cap -
// 2 cap / (exp(2 s / cap) + 1): one MUFU.EX2 and one approximate division
// (MUFU.RCP) a score, where tanhf spends a polynomial and a branch
// (absolute error ~cap 2^-22, far below bf16's rounding of P); at dh 64
// and 128, which no arch softcaps, tanhf stays: the other form's code
// made the dh 64 kernel 15% slower without a softcap, the dh 128 one
// 0.7% (tools/flash_variants.py ablations; PERF.md §6).
// A row whose scores are all
// masked so far (max -1e30: only a window's first tile gives one) takes 0
// for the max's product with log2 e: the fma would otherwise read the
// rounding of -1e30 * log2 e (~1e23) and give inf, then NaN.  Its p and
// alpha are then exactly 0 where the reference has p = 1 and alpha = 1;
// both leave l and acc exactly 0 once the row's first real max multiplies
// them by 0.
template <bool EX2_CAP, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int r0, int t, int S,
                                             int causal, int window, bool edge,
                                             float softcap) {
  if (softcap > 0.f) {
    if constexpr (EX2_CAP) {
      const float k2 = 2.f * LOG2E / softcap, c2 = 2.f * softcap;
#pragma unroll
      for (int i = 0; i < N; ++i)
        s[i] = softcap - __fdividef(c2, exp2f(s[i] * k2) + 1.f);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = tanhf(s[i] / softcap) * softcap;
    }
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const int row = (i & 2) ? r0 + 8 : r0;
      if (masked(key, row, S, causal, window)) s[i] = NEG;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i)
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
  for (int i = 0; i < N; ++i) {
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

// Q, NS stages of K and of V (BK rows each), the barriers, and room to
// align to 1 KB
template <int DH, int NS, int BK>
constexpr size_t wgmma_smem() {
  return (size_t)(DH / 64) * BOX_ROW_BYTES * (WG_BQ + 2 * NS * BK) +
         8 * (1 + 4 * NS) + 1024;
}

// One block owns one (bh, 128-row q tile).  Warpgroup 0 is the producer:
// one thread loads Q once and then K and V tile by tile (BK keys) into a
// ring of NS stages with TMA.  Warpgroups 1 and 2 consume 64 q rows each:
// S = Q.K^T by wgmma (both operands in shared memory), the online softmax
// in registers, then O += P.V by wgmma with P from registers and V read
// MN-major.  Barriers: qbar (Q landed), full_k / full_v (a stage's K / V
// landed) and empty_k / empty_v (all 8 consumer warps are done with a
// stage's K / V: its S read, its P.V retired).
template <int DH, int NS, int BK>
__global__ void __launch_bounds__(384, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       float* __restrict__ lse, int S, int causal, int window,
                       float scale, float softcap) {
  constexpr int NB = DH / 64;                   // 64-column boxes a row
  constexpr int KV_BOX = BK * BOX_ROW_BYTES;    // one box of a K or V tile
  constexpr int Q_TILE = NB * Q_BOX, KV_TILE = NB * KV_BOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  uint8_t* const qs = smem_raw + (base - raw);
  const uint32_t sq = base, sk = base + Q_TILE, sv = sk + NS * KV_TILE;
  const uint32_t qbar = sv + NS * KV_TILE;
  const uint32_t full_k = qbar + 8, full_v = full_k + 8 * NS,
                 empty_k = full_v + 8 * NS, empty_v = empty_k + 8 * NS;

  // one head's q tiles are neighbours in the grid, heaviest first, so the
  // blocks on the card at once share few heads and find K and V in L2
  const int nqt = (S + WG_BQ - 1) / WG_BQ;
  const int bh = blockIdx.x / nqt;
  const int qt = nqt - 1 - blockIdx.x % nqt;
  const int q0 = qt * WG_BQ;
  // a window: key tiles from jlo, the tile of the first row's lowest key
  // in reach (those below change no output); causal: up to the tile of
  // the block's last row (those past it change no output either); the
  // producer and the consumers walk the same tiles, so the ring's stages
  // and phases agree
  const int nkt = (S + BK - 1) / BK;
  const int jlo = q0 - window + 1 > 0 ? (q0 - window + 1) / BK : 0;
  const int jend = causal ? min((q0 + WG_BQ + BK - 1) / BK, nkt) : nkt;
  // causal: the tiles from jdiag on hold a key past the block's first row
  const int jdiag = (q0 + 1) / BK;
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
      mbar_expect_tx(qbar, Q_TILE);
      for (int b = 0; b < NB; ++b)
        tma_load(sq + b * Q_BOX, &tq, b * 64, q0, bh, qbar);
      int stage = 0, phase = 0;
      for (int j = jlo; j < jend; ++j) {
        const uint32_t kdst = sk + stage * KV_TILE, vdst = sv + stage * KV_TILE;
        mbar_wait(empty_k + 8 * stage, phase ^ 1);   // round 0 passes
        mbar_expect_tx(full_k + 8 * stage, KV_TILE);
        for (int b = 0; b < NB; ++b)
          tma_load(kdst + b * KV_BOX, &tk, b * 64, j * BK, bh,
                   full_k + 8 * stage);
        mbar_wait(empty_v + 8 * stage, phase ^ 1);
        mbar_expect_tx(full_v + 8 * stage, KV_TILE);
        for (int b = 0; b < NB; ++b)
          tma_load(vdst + b * KV_BOX, &tv, b * 64, j * BK, bh,
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
    const uint32_t my_q = sq + cw * 64 * BOX_ROW_BYTES;

    // q * scale rounded to bf16, once, in place: the consumer's 64 rows of
    // each box (elementwise, so the swizzle does not matter); then make the
    // generic-proxy writes visible to wgmma and wait for the warpgroup
    mbar_wait(qbar, 0);
    for (int i = tid; i < NB * 64 * 8; i += 128) {
      uint4* p = reinterpret_cast<uint4*>(qs + (i >> 9) * Q_BOX +
                                          cw * 64 * BOX_ROW_BYTES +
                                          (i & 511) * 16);
      uint4 x = *p;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = __bfloat1622float2(e[h]);
        e[h] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *p = x;
    }
    fence_async_smem();
    warpgroup_sync(1 + cw);

    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float s[BK / 2];
    uint32_t p[BK / 16][4];

    // Tile j's S = Q.K^T and tile j - 1's O += P.V are issued together;
    // the softmax of tile j runs while the tensor cores finish P.V, and
    // O is rescaled by tile j's alpha once P.V has retired:
    //   O_j = (O_{j-1} + P_{j-1} V_{j-1}) * exp(m_{j-1} - m_j)
    // K of a stage is released once its S is read, V once its P.V is.
    // Tile jlo is peeled off, so that no branch sits between a wgmma and
    // the wait that retires it.
    mbar_wait(full_k, 0);
    wgmma_fence();
    wgmma_rows_dot<DH, BK>(s, my_q, Q_BOX, sk, KV_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release(empty_k, lane);
    softmax_tile<DH == 256>(s, m, l, alpha, jlo * BK, r0, t, S, causal,
                            window,
                            (causal && jlo >= jdiag) || (jlo + 1) * BK > S ||
                                jlo * BK < lower_edge,
                            softcap);
    pack_a(s, p);

    int stage = 0, phase = 0;   // tile j - 1's
    for (int j = jlo + 1; j < jend; ++j) {
      const int k0 = j * BK;
      const int next = stage + 1 == NS ? 0 : stage + 1;
      const int next_phase = next == 0 ? phase ^ 1 : phase;
      mbar_wait(full_k + 8 * next, next_phase);
      mbar_wait(full_v + 8 * stage, phase);
      fence_regs(acc);
      wgmma_fence();
      wgmma_rows_dot<DH, BK>(s, my_q, Q_BOX, sk + next * KV_TILE, KV_BOX);
      wgmma_commit();
      wgmma_acc_rows<DH, BK>(acc, p, sv + stage * KV_TILE, KV_BOX);
      wgmma_commit();
      wgmma_wait<1>();   // S is ready, P.V may still run
      fence_regs(s);
      release(empty_k + 8 * next, lane);
      softmax_tile<DH == 256>(s, m, l, alpha, k0, r0, t, S, causal, window,
                              (causal && j >= jdiag) || k0 + BK > S ||
                                  k0 < lower_edge,
                              softcap);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty_v + 8 * stage, lane);
      pack_a(s, p);   // only now: the last P.V read the previous P
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      stage = next;
      phase = next_phase;
    }
    // the last tile's P.V
    mbar_wait(full_v + 8 * stage, phase);
    fence_regs(acc);
    wgmma_fence();
    wgmma_acc_rows<DH, BK>(acc, p, sv + stage * KV_TILE, KV_BOX);
    wgmma_commit();
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
    uint8_t* const os = qs + cw * 64 * BOX_ROW_BYTES +
                        (warp * 16 + g) * BOX_ROW_BYTES + 4 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      uint8_t* const at = os + (n >> 3) * Q_BOX + (((n & 7) ^ g) << 4);
      *reinterpret_cast<uint32_t*>(at) =
          pack2(quotient(acc[4 * n], den[0], rd[0]),
                quotient(acc[4 * n + 1], den[0], rd[0]));
      *reinterpret_cast<uint32_t*>(at + 8 * BOX_ROW_BYTES) =
          pack2(quotient(acc[4 * n + 2], den[1], rd[1]),
                quotient(acc[4 * n + 3], den[1], rd[1]));
    }
    fence_async_smem();
    warpgroup_sync(1 + cw);
    if (tid == 0 && q0 + cw * 64 < S) {
      for (int b = 0; b < NB; ++b)
        tma_store(&to, my_q + b * Q_BOX, b * 64, q0 + cw * 64, bh);
      tma_store_drain();
    }
  }
}

template <int DH, int NS, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int BH, int S, int causal, int window,
                 float scale, float softcap, cudaStream_t st) {
  CUtensorMap tq, tk, tv, to;
  if (!head_map(&tq, q, BH, S, DH, WG_BQ) ||
      !head_map(&tk, k, BH, S, DH, BK) || !head_map(&tv, v, BH, S, DH, BK) ||
      !head_map(&to, o, BH, S, DH, WG_BQ / 2))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wgmma_smem<DH, NS, BK>();
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = allow_smem(flash_wgmma_kernel<DH, NS, BK>, smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const unsigned grid = (unsigned)BH * ((S + WG_BQ - 1) / WG_BQ);
  flash_wgmma_kernel<DH, NS, BK><<<grid, 384, smem, st>>>(
      tq, tk, tv, to, lse, S, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32, and bf16 of other widths (dh <= 256): CUDA cores
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
  const cudaError_t err = allow_smem(flash_simt_kernel<T, DPL>, smem);
  if (err != cudaSuccess) return (int)err;
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

// 1 where a launch at (dh, is_bf16) runs on the tensor cores
// (flash_wgmma_kernel: bf16 with dh 64, 128 or 256), 0 where it runs on
// the CUDA cores (flash_simt_kernel); repro_flash_attention dispatches by it
extern "C" int repro_flash_route(int dh, int is_bf16) {
  return is_bf16 && (dh == 64 || dh == 128 || dh == 256) ? 1 : 0;
}

// q, k, v, o: (BH, S, dh) contiguous, 16-byte aligned; lse: float32
// (BH, S), or null for none; is_bf16 selects bf16 over float32; window > 0
// masks keys window or more behind the row (causal only), 0 means none;
// scale is dh^-0.5 already rounded to q's type (the reference multiplies q
// by a weakly typed scalar); softcap <= 0 means none.  dh <= 256,
// S <= 65535 * 16.  The tensor-core path has no fallback: an error of its
// launch (shared memory refused, a tensor map not encoded) is returned.
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
  if (repro_flash_route(dh, is_bf16)) {
    if (dh == 256)
      return launch_wgmma<256, 2, 64>(q, k, v, o, lse, BH, S, causal, win,
                                      scale, softcap, st);
    if (dh == 128)
      return launch_wgmma<128, 2, 128>(q, k, v, o, lse, BH, S, causal, win,
                                       scale, softcap, st);
    return launch_wgmma<64, 3, 128>(q, k, v, o, lse, BH, S, causal, win,
                                    scale, softcap, st);
  }
  if (is_bf16)
    return dispatch_simt<bf16>(q, k, v, o, lse, BH, S, dh, causal, win,
                               scale, softcap, st);
  return dispatch_simt<float>(q, k, v, o, lse, BH, S, dh, causal, win, scale,
                              softcap, st);
}
