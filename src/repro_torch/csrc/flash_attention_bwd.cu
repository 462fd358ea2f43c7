// Flash-attention backward on Hopper (sm_90a).  Bound to PyTorch through a
// plain C interface (ctypes) by src/repro_torch/kernels/flash_attention.py,
// which also holds the plain PyTorch version and the autograd Function.
// The entry point launches on the caller's stream, allocates nothing (the
// wrapper hands it the float32 scratch ``delta`` and, for the tensor-core
// path, the scratch ``qs``), and returns cudaGetLastError().
//
// flash_attention_backward
//   Replaces no Pallas kernel: the reference has only the forward
//   (src/repro/kernels/flash_attention.py), and its model's training step
//   differentiates the chunked attention of src/repro/models/layers.py
//   (flash_attention) with XLA.  This is the gradient of what the forward
//   kernel (flash_attention.cu) computes.  q, k, v, o, do, dq, dk, dv:
//   (BH, S, dh), float32 or bf16; lse, delta: float32 (BH, S).  Per row i
//   and key j, in float32:
//     qs_i  = q_i * scale rounded to q's type (the forward's)
//     s_ij  = qs_i . k_j; c_ij = tanh(s_ij / cap) * cap with a softcap
//     P_ij  = exp(c_ij - lse_i), 0 where the forward masked (j > i when
//             causal, i - j >= W with a window, j >= S)
//     D_i   = sum_d do_id o_id                           (delta)
//     dV_j  = sum_i bf(P_ij) do_i
//     dS_ij = P_ij (do_i . v_j - D_i) (1 - tanh^2(s_ij / cap))
//     dK_j  = sum_i bf(dS_ij) qs_i
//     dQ_i  = scale * sum_j bf(dS_ij) k_j
//   bf() rounds to the inputs' type (P to v's type, as the forward rounds
//   it before P.V; a no-op in float32).
//   No float atomics, so two calls on the same inputs agree bit for bit:
//   rowdot_kernel (D, one warp a row), then a dK/dV kernel whose block
//   owns a tile of keys and walks the q rows that reach them, then a dQ
//   kernel whose block owns a tile of q rows and walks the keys they
//   reach (two grids that both recompute P and dS: 7 products of S x S x
//   dh in place of 5).  Causal walks skip the tiles wholly in the future,
//   window walks those wholly behind the window; the heaviest blocks are
//   issued first.
//   Bound on this card, at starcoder2-7b's training shape (BH = 4 * 36,
//   S = 2048, dh = 128, bf16, causal): operations — 5 products of the
//   causal half, 5 * 2 * dh * BH * S (S + 1) / 2 = 386.7 GFLOP at 989
//   TFLOP/s is 0.391 ms, against 5 * 75.5 MB read (q, k, v, o, do) and
//   3 * 75.5 MB written at 3.35 TB/s, 0.181 ms.  So the tensor cores have
//   to carry the products, and only wgmma reaches their full rate:
//   * bf16 with dh 64 or 128: the forward's building blocks (hopper.cuh).
//     scale_q_kernel writes qs = q * scale in bf16 once (75.5 MB each way
//     at this shape, ~0.05 ms), so both grids bring Qs by TMA as it is.
//     Each grid is 384 threads a block in three warpgroups: a producer
//     (24 registers after setmaxnreg) whose one thread keeps TMA loads in
//     flight into a ring of stages with full and empty mbarriers, and two
//     consumers of 64 keys (dK/dV) or 64 q rows (dQ) each, 240 registers.
//     - dkdv_wgmma_kernel<DH, NS>: 128 keys a block; K and V resident,
//       Qs, dO (64 rows) and the rows' lse and D (written by the producer
//       warp) a stage.  Per stage S^T = K.Qs^T and dP^T = V.dO^T
//       (m64n64k16 from shared memory), P^T and dS^T in the accumulators,
//       dV += P^T.dO and dK += dS^T.Qs with the A operand from registers
//       and dO, Qs read MN-major (the transpose bit).  Registers a
//       consumer thread: dK and dV DH / 2 each (64 + 64 at dh 128), S^T
//       and dP^T 32 + 32, P^T and dS^T packed 16 + 16.
//     - dq_wgmma_kernel<DH, NS>: 128 q rows a block; Qs and dO resident,
//       K and V (64 keys) a stage.  S = Qs.K^T, dP = dO.V^T, dS, then
//       dQ += dS.K (K read MN-major).  Registers: dQ DH / 2, S and dP
//       32 + 32, dS packed 16.
//     Stages: dK/dV 3 at dh 128 (163 KB), 4 at dh 64; dQ 4 at both (193
//     / 97 KB); 2 to 4 stages time the same (tools/flash_variants.py
//     ablations-bwd).  dK, dV and dQ are staged in the consumer's rows of the
//     resident tiles and stored by TMA (3-D maps over (dh, S, BH): the
//     rows past S read as zeros and are not written).
//   * everything else (float32, where the tensor cores' TF32 would miss
//     the reference's 1e-5, and bf16 of other widths up to 256): CUDA
//     cores, 128 threads on 16 x 16 tiles of scores in shared memory,
//     explicit fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr unsigned FULL = 0xffffffffu;

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
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// what the forward masked (-1e30, so P = 0), and the rows past S; the
// window is INT_MAX where there is none
__device__ __forceinline__ bool masked(int key, int row, int S, int causal,
                                       int window) {
  return key >= S || row >= S || (causal && key > row) || row - key >= window;
}

// P and dS of one score: s = qs . k, dp = do . v, the row's lse and D
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float d,
                                     float softcap, bool off, float& p,
                                     float& ds) {
  if (off) {
    p = 0.f;
    ds = 0.f;
    return;
  }
  float c = s, th = 0.f;
  if (softcap > 0.f) {
    th = tanhf(s / softcap);
    c = th * softcap;
  }
  p = expf(c - lse);
  ds = p * (dp - d);
  if (softcap > 0.f) ds *= 1.f - th * th;
}

// the first and one past the last q row that reaches a key tile [k0, k0 +
// n), and the first and one past the last key a q tile [q0, q0 + n)
// reaches (window: INT_MAX where there is none)
__device__ __forceinline__ int rows_end(int k0, int n, int S, int window) {
  return window == INT_MAX ? S : min(S, k0 + n - 1 + window);
}
__device__ __forceinline__ int keys_begin(int q0, int window, int tile) {
  return window == INT_MAX || q0 - window + 1 <= 0
             ? 0
             : (q0 - window + 1) / tile * tile;
}

// ---------------------------------------------------------------------------
// D = rowsum(do * o): one warp a row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(128)
    rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ delta, long rows, int dh) {
  const long row = (long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = o + row * dh;
  const T* b = dout + row * dh;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32) s = fmaf(to_float(a[d]), to_float(b[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// bf16, dh 64 / 128: TMA rings + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int WG_BLOCK = 128;   // keys a dK/dV block, q rows a dQ block
constexpr int WG_STEP = 64;     // q rows a dK/dV stage, keys a dQ stage
constexpr int BLOCK_BOX = WG_BLOCK * BOX_ROW_BYTES;   // 16 KB
constexpr int STEP_BOX = WG_STEP * BOX_ROW_BYTES;     // 8 KB
constexpr int CONSUMER_REGS = 240;       // 128 x 24 + 256 x 240 <= 65,536
constexpr int PRODUCER_REGS = 24;

// qs = q * scale rounded to bf16 (the forward's rounding), 8 values a
// thread a step: both products with qs read it from this copy by TMA
__global__ void __launch_bounds__(256)
    scale_q_kernel(const uint4* __restrict__ q, uint4* __restrict__ qs,
                   long n8, float scale) {
  for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < n8;
       i += (long)gridDim.x * 256) {
    uint4 x = q[i];
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = __bfloat1622float2(e[h]);
      e[h] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    qs[i] = x;
  }
}

// P and dS of one score on the tensor-core path: P = exp(c - lse) as
// exp2((c - lse) log2 e) (one MUFU.EX2; the rounding of c - lse is all
// that is added to expf's), dS = P (dp - D), times 1 - tanh^2 with a
// softcap
__device__ __forceinline__ void p_ds_tc(float s, float dp, float lse, float d,
                                        float softcap, float& p, float& ds) {
  float c = s, th = 0.f;
  if (softcap > 0.f) {
    th = tanhf(s / softcap);
    c = th * softcap;
  }
  p = exp2f((c - lse) * LOG2E);
  ds = p * (dp - d);
  ds *= softcap > 0.f ? 1.f - th * th : 1.f;
}

// the shared memory of dkdv_wgmma_kernel<DH, NS>: K and V of the block's
// 128 keys, NS stages of Qs and dO (64 rows each) and of lse and D (64
// floats each), the barriers, and room to align to 1 KB
template <int DH, int NS>
constexpr size_t dkdv_smem() {
  return (size_t)(DH / 64) * (2 * BLOCK_BOX + 2 * NS * STEP_BOX) +
         NS * 2 * WG_STEP * 4 + 8 * (1 + 2 * NS) + 1024;
}

// One block owns 128 keys of one head, 64 for each consumer warpgroup,
// and walks the q rows that reach them, 64 a stage.  Warpgroup 0 is the
// producer: one thread loads K and V once, then stage by stage Qs and dO
// with TMA into a ring of NS stages; its warp writes each stage's lse
// and D rows into shared memory before the thread arms the stage's full
// barrier.  Per stage a consumer computes S^T = K.Qs^T and dP^T = V.dO^T
// (its 64 keys x the stage's 64 rows, m64n64k16 from shared memory), P^T
// and dS^T in the accumulators, then dV += P^T.dO and dK += dS^T.Qs with
// P^T and dS^T from registers (the layout their accumulators have) and dO
// and Qs read MN-major.  dK and dV are staged in the consumer's rows of K
// and V and stored by TMA, without the keys past S.
template <int DH, int NS>
__global__ void __launch_bounds__(384, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tqs,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdk,
                      const __grid_constant__ CUtensorMap tdv,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int S, int causal,
                      int window, float softcap) {
  constexpr int NB = DH / 64;
  constexpr int KV_TILE = NB * BLOCK_BOX, ST_TILE = NB * STEP_BOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gen = smem_raw + (base - raw);   // base, generic address
  const uint32_t sk = base, sv = sk + KV_TILE, sq = sv + KV_TILE,
                 sdo = sq + NS * ST_TILE, srow = sdo + NS * ST_TILE;
  float* const rows_lse = reinterpret_cast<float*>(gen + (srow - base));
  float* const rows_d = rows_lse + NS * WG_STEP;
  const uint32_t kvbar = srow + NS * 2 * WG_STEP * 4;
  const uint32_t full = kvbar + 8, empty = full + 8 * NS;

  // one head's key tiles are neighbours in the grid; causal: the lowest
  // keys (the longest walks) first
  const int nkt = (S + WG_BLOCK - 1) / WG_BLOCK;
  const int bh = blockIdx.x / nkt;
  const int k0 = (blockIdx.x % nkt) * WG_BLOCK;
  // the rows that reach a key of the block: causal from k0, a window up
  // to the last key's W - 1 rows on; producer and consumers walk the same
  const int i_begin = causal ? k0 : 0;
  const int i_end = rows_end(k0, WG_BLOCK, S, window);

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: warp 0 ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * KV_TILE);
        for (int b = 0; b < NB; ++b) {
          tma_load(sk + b * BLOCK_BOX, &tk, b * 64, k0, bh, kvbar);
          tma_load(sv + b * BLOCK_BOX, &tv, b * 64, k0, bh, kvbar);
        }
      }
      int stage = 0, phase = 0;
      for (int i0 = i_begin; i0 < i_end; i0 += WG_STEP) {
        mbar_wait(empty + 8 * stage, phase ^ 1);   // round 0 passes
        for (int r = lane; r < WG_STEP; r += 32) {
          const int row = i0 + r;
          rows_lse[stage * WG_STEP + r] =
              row < S ? lse[(size_t)bh * S + row] : 0.f;
          rows_d[stage * WG_STEP + r] =
              row < S ? delta[(size_t)bh * S + row] : 0.f;
        }
        __syncwarp();   // the warp's rows before the arrival below
        if (lane == 0) {
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, 2 * ST_TILE);
          for (int b = 0; b < NB; ++b) {
            tma_load(sq + stage * ST_TILE + b * STEP_BOX, &tqs, b * 64, i0,
                     bh, bar);
            tma_load(sdo + stage * ST_TILE + b * STEP_BOX, &tdo, b * 64, i0,
                     bh, bar);
          }
        }
        if (++stage == NS) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // this thread's keys (rows of S^T): key and key + 8
    const int key = k0 + cw * 64 + warp * 16 + g;
    const uint32_t my_k = sk + cw * 64 * BOX_ROW_BYTES,
                   my_v = sv + cw * 64 * BOX_ROW_BYTES;

    float dk[DH / 2], dv[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[WG_STEP / 2], dpt[WG_STEP / 2];
    uint32_t pa[WG_STEP / 16][4], da[WG_STEP / 16][4];

    mbar_wait(kvbar, 0);
    int stage = 0, phase = 0;
    for (int i0 = i_begin; i0 < i_end; i0 += WG_STEP) {
      const uint32_t q_at = sq + stage * ST_TILE, do_at = sdo + stage * ST_TILE;
      mbar_wait(full + 8 * stage, phase);
      wgmma_fence();
      wgmma_rows_dot<DH, WG_STEP>(st, my_k, BLOCK_BOX, q_at, STEP_BOX);
      wgmma_rows_dot<DH, WG_STEP>(dpt, my_v, BLOCK_BOX, do_at, STEP_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      // a stage needs the mask where a key may pass a row, a row may be
      // W or more past a key, or a key or a row lies past S
      const bool edge = (causal && i0 < k0 + WG_BLOCK - 1) ||
                        i0 + WG_STEP > S || k0 + WG_BLOCK > S ||
                        i0 + WG_STEP - 1 - k0 >= window;
      const float* const ls = rows_lse + stage * WG_STEP;
      const float* const dl = rows_d + stage * WG_STEP;
      // element i: key key + 8 ((i >> 1) & 1), stage row 8 (i / 4) + 2t +
      // (i & 1)
#pragma unroll
      for (int n = 0; n < WG_STEP / 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          float p, ds;
          p_ds_tc(st[i], dpt[i], (e & 1) ? l2.y : l2.x, (e & 1) ? d2.y : d2.x,
                  softcap, p, ds);
          if (edge && masked(key + 8 * ((e >> 1) & 1), i0 + 8 * n + 2 * t +
                             (e & 1), S, causal, window))
            p = ds = 0.f;
          st[i] = p;
          dpt[i] = ds;
        }
      }
      pack_a(st, pa);
      pack_a(dpt, da);
      wgmma_fence();
      wgmma_acc_rows<DH, WG_STEP>(dv, pa, do_at, STEP_BOX);
      wgmma_acc_rows<DH, WG_STEP>(dk, da, q_at, STEP_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      release(empty + 8 * stage, lane);
      if (++stage == NS) {
        stage = 0;
        phase ^= 1;
      }
    }

    // dK and dV in bf16 into this consumer's rows of K and V (all its
    // products have retired; the other consumer reads none of them), then
    // one thread stores them by TMA, which drops the keys past S
    const float one[2] = {1.f, 1.f};
    uint8_t* const row0 = gen + cw * 64 * BOX_ROW_BYTES +
                          (warp * 16 + g) * BOX_ROW_BYTES + 4 * t;
    stage_rows(row0, dk, one, g, BLOCK_BOX);
    stage_rows(row0 + KV_TILE, dv, one, g, BLOCK_BOX);
    fence_async_smem();
    warpgroup_sync(1 + cw);
    if (tid == 0 && k0 + cw * 64 < S) {
      for (int b = 0; b < NB; ++b) {
        tma_store(&tdk, my_k + b * BLOCK_BOX, b * 64, k0 + cw * 64, bh);
        tma_store(&tdv, my_v + b * BLOCK_BOX, b * 64, k0 + cw * 64, bh);
      }
      tma_store_drain();
    }
  }
}

// the shared memory of dq_wgmma_kernel<DH, NS>: Qs and dO of the block's
// 128 rows, NS stages of K and of V (64 keys each), the barriers, and room
// to align to 1 KB
template <int DH, int NS>
constexpr size_t dq_smem() {
  return (size_t)(DH / 64) * (2 * BLOCK_BOX + 2 * NS * STEP_BOX) +
         8 * (1 + 4 * NS) + 1024;
}

// One block owns 128 q rows of one head, 64 for each consumer warpgroup,
// and walks the keys they reach, 64 a stage: the forward's skeleton.  The
// producer loads Qs and dO once, then K and V stage by stage into a ring
// of NS stages.  Per stage a consumer computes S = Qs.K^T and dP = dO.V^T
// (m64n64k16 from shared memory), dS in the accumulator, then dQ += dS.K
// with dS from registers and K read MN-major.  V is released once dP is
// read, K once dS.K has retired.  dQ * scale is staged in the consumer's
// rows of Qs and stored by TMA, without the rows past S.
template <int DH, int NS>
__global__ void __launch_bounds__(384, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tqs,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdq,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int S, int causal,
                    int window, float scale, float softcap) {
  constexpr int NB = DH / 64;
  constexpr int Q_TILE = NB * BLOCK_BOX, KV_TILE = NB * STEP_BOX;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gen = smem_raw + (base - raw);
  const uint32_t sq = base, sdo = sq + Q_TILE, sk = sdo + Q_TILE,
                 sv = sk + NS * KV_TILE;
  const uint32_t qbar = sv + NS * KV_TILE;
  const uint32_t full_k = qbar + 8, full_v = full_k + 8 * NS,
                 empty_k = full_v + 8 * NS, empty_v = empty_k + 8 * NS;

  // one head's q tiles are neighbours in the grid, heaviest first
  const int nqt = (S + WG_BLOCK - 1) / WG_BLOCK;
  const int bh = blockIdx.x / nqt;
  const int q0 = (nqt - 1 - blockIdx.x % nqt) * WG_BLOCK;
  // the keys the block's rows reach: a window from the first row's lowest
  // key in reach, causal up to its last row
  const int j_begin = keys_begin(q0, window, WG_STEP);
  const int j_end = causal ? min(S, q0 + WG_BLOCK) : S;

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
      mbar_expect_tx(qbar, 2 * Q_TILE);
      for (int b = 0; b < NB; ++b) {
        tma_load(sq + b * BLOCK_BOX, &tqs, b * 64, q0, bh, qbar);
        tma_load(sdo + b * BLOCK_BOX, &tdo, b * 64, q0, bh, qbar);
      }
      int stage = 0, phase = 0;
      for (int j0 = j_begin; j0 < j_end; j0 += WG_STEP) {
        mbar_wait(empty_k + 8 * stage, phase ^ 1);   // round 0 passes
        mbar_expect_tx(full_k + 8 * stage, KV_TILE);
        for (int b = 0; b < NB; ++b)
          tma_load(sk + stage * KV_TILE + b * STEP_BOX, &tk, b * 64, j0, bh,
                   full_k + 8 * stage);
        mbar_wait(empty_v + 8 * stage, phase ^ 1);
        mbar_expect_tx(full_v + 8 * stage, KV_TILE);
        for (int b = 0; b < NB; ++b)
          tma_load(sv + stage * KV_TILE + b * STEP_BOX, &tv, b * 64, j0, bh,
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
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // this thread's rows: r0 (elements 0, 1 of each 8-column group) and
    // r0 + 8 (elements 2, 3)
    const int r0 = q0 + cw * 64 + warp * 16 + g;
    const uint32_t my_q = sq + cw * 64 * BOX_ROW_BYTES,
                   my_do = sdo + cw * 64 * BOX_ROW_BYTES;
    float lr[2], dr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      lr[h] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      dr[h] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    float dq[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
    float s[WG_STEP / 2], dp[WG_STEP / 2];
    uint32_t da[WG_STEP / 16][4];

    mbar_wait(qbar, 0);
    int stage = 0, phase = 0;
    for (int j0 = j_begin; j0 < j_end; j0 += WG_STEP) {
      const uint32_t k_at = sk + stage * KV_TILE, v_at = sv + stage * KV_TILE;
      mbar_wait(full_k + 8 * stage, phase);
      mbar_wait(full_v + 8 * stage, phase);
      wgmma_fence();
      wgmma_rows_dot<DH, WG_STEP>(s, my_q, BLOCK_BOX, k_at, STEP_BOX);
      wgmma_rows_dot<DH, WG_STEP>(dp, my_do, BLOCK_BOX, v_at, STEP_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      release(empty_v + 8 * stage, lane);
      const bool edge = (causal && j0 + WG_STEP - 1 > q0) ||
                        j0 + WG_STEP > S || q0 + WG_BLOCK > S ||
                        q0 + WG_BLOCK - 1 - j0 >= window;
      // element i: row r0 + 8 ((i >> 1) & 1), key j0 + 8 (i / 4) + 2t +
      // (i & 1)
#pragma unroll
      for (int i = 0; i < WG_STEP / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p, ds;
        p_ds_tc(s[i], dp[i], lr[h], dr[h], softcap, p, ds);
        if (edge && masked(j0 + 8 * (i >> 2) + 2 * t + (i & 1), r0 + 8 * h,
                           S, causal, window))
          ds = 0.f;
        s[i] = ds;
      }
      pack_a(s, da);
      wgmma_fence();
      wgmma_acc_rows<DH, WG_STEP>(dq, da, k_at, STEP_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      release(empty_k + 8 * stage, lane);
      if (++stage == NS) {
        stage = 0;
        phase ^= 1;
      }
    }

    // dQ * scale in bf16 into this consumer's rows of Qs (its last S has
    // been read), then one thread stores them by TMA without the rows past
    // S
    const float mul[2] = {scale, scale};
    stage_rows(gen + cw * 64 * BOX_ROW_BYTES + (warp * 16 + g) * BOX_ROW_BYTES +
                   4 * t,
               dq, mul, g, BLOCK_BOX);
    fence_async_smem();
    warpgroup_sync(1 + cw);
    if (tid == 0 && q0 + cw * 64 < S) {
      for (int b = 0; b < NB; ++b)
        tma_store(&tdq, my_q + b * BLOCK_BOX, b * 64, q0 + cw * 64, bh);
      tma_store_drain();
    }
  }
}

// qs, then the dK/dV grid, then the dQ grid, on one stream
template <int DH, int NS_KV, int NS_Q>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* qs, void* dq, void* dk, void* dv, int BH, int S,
                 int causal, int window, float scale, float softcap,
                 cudaStream_t st) {
  const long n8 = (long)BH * S * DH / 8;
  const long blocks8 = (n8 + 255) / 256;
  scale_q_kernel<<<(unsigned)(blocks8 < 132 * 16 ? blocks8 : 132 * 16), 256,
                   0, st>>>((const uint4*)q, (uint4*)qs, n8, scale);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  CUtensorMap tq64, tdo64, tk128, tv128, tdk, tdv, tq128, tdo128, tk64, tv64,
      tdq;
  if (!head_map(&tq64, qs, BH, S, DH, WG_STEP) ||
      !head_map(&tdo64, dout, BH, S, DH, WG_STEP) ||
      !head_map(&tk128, k, BH, S, DH, WG_BLOCK) ||
      !head_map(&tv128, v, BH, S, DH, WG_BLOCK) ||
      !head_map(&tdk, dk, BH, S, DH, WG_STEP) ||
      !head_map(&tdv, dv, BH, S, DH, WG_STEP) ||
      !head_map(&tq128, qs, BH, S, DH, WG_BLOCK) ||
      !head_map(&tdo128, dout, BH, S, DH, WG_BLOCK) ||
      !head_map(&tk64, k, BH, S, DH, WG_STEP) ||
      !head_map(&tv64, v, BH, S, DH, WG_STEP) ||
      !head_map(&tdq, dq, BH, S, DH, WG_STEP))
    return (int)cudaErrorInvalidValue;
  constexpr size_t s1 = dkdv_smem<DH, NS_KV>(), s2 = dq_smem<DH, NS_Q>();
  static bool sized = false;
  if (!sized) {
    err = (int)allow_smem(dkdv_wgmma_kernel<DH, NS_KV>, s1);
    if (err == 0) err = (int)allow_smem(dq_wgmma_kernel<DH, NS_Q>, s2);
    if (err != 0) return err;
    sized = true;
  }
  const unsigned blocks = (unsigned)BH * ((S + WG_BLOCK - 1) / WG_BLOCK);
  dkdv_wgmma_kernel<DH, NS_KV><<<blocks, 384, s1, st>>>(
      tq64, tdo64, tk128, tv128, tdk, tdv, lse, delta, S, causal, window,
      softcap);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_wgmma_kernel<DH, NS_Q><<<blocks, 384, s2, st>>>(
      tq128, tdo128, tk64, tv64, tdq, lse, delta, S, causal, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// any type and dh <= 256: CUDA cores
// ---------------------------------------------------------------------------

constexpr int SB = 16;   // keys and rows of a score tile

size_t simt_smem(int dh) {
  // four (SB, dh + 1) tiles, P and dS (SB, SB + 1), lse and D
  return sizeof(float) *
         (4 * (size_t)SB * (dh + 1) + 2 * SB * (SB + 1) + 2 * SB);
}

// The 16 x 16 scores of q rows [i0, i0 + SB) and keys [j0, j0 + SB) from
// the tiles in shared memory (qs scaled and rounded, dos, ks, vs; rows of
// dh + 1 floats), into pt (P rounded to T) and dst (dS rounded to T),
// [row][key] with rows of SB + 1.  128 threads, two scores each.
template <typename T>
__device__ __forceinline__ void simt_scores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* ls, const float* dl, float* pt, float* dst, int i0, int j0,
    int S, int dh, int causal, int window, float softcap) {
  const int ld = dh + 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (threadIdx.x >> 4) + 8 * h, j = threadIdx.x & 15;
    const float* qr = qs + r * ld;
    const float* dr = dos + r * ld;
    const float* kr = ks + j * ld;
    const float* vr = vs + j * ld;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < dh; ++d) {
      s = fmaf(qr[d], kr[d], s);
      dp = fmaf(dr[d], vr[d], dp);
    }
    float p, ds;
    p_ds(s, dp, ls[r], dl[r], softcap,
         masked(j0 + j, i0 + r, S, causal, window), p, ds);
    pt[r * (SB + 1) + j] = round_to<T>(p);
    dst[r * (SB + 1) + j] = round_to<T>(ds);
  }
}

// rows [row0, row0 + SB) of a (S, dh) head into a float tile of rows
// dh + 1, zeros past S, times ``scale`` rounded to T where it is not 0
template <typename T>
__device__ __forceinline__ void simt_load(float* dst, const T* src, int row0,
                                          int S, int dh, float scale) {
  for (int i = threadIdx.x; i < SB * dh; i += blockDim.x) {
    const int r = i / dh, d = i % dh;
    float x = 0.f;
    if (row0 + r < S) {
      x = to_float(src[(size_t)(row0 + r) * dh + d]);
      if (scale != 0.f) x = round_to<T>(x * scale);
    }
    dst[r * (dh + 1) + d] = x;
  }
}

__device__ __forceinline__ void simt_rows(float* ls, float* dl,
                                          const float* lse,
                                          const float* delta, size_t at,
                                          int row0, int S) {
  if (threadIdx.x < SB) {
    const int row = row0 + threadIdx.x;
    ls[threadIdx.x] = row < S ? lse[at + row] : 0.f;
    dl[threadIdx.x] = row < S ? delta[at + row] : 0.f;
  }
}

// NC: output columns a thread owns (c0, c0 + 8, ...), NC * 8 >= dh
template <typename T, int NC>
__global__ void __launch_bounds__(128)
    dkdv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int dh, int causal,
                     int window, float scale, float softcap) {
  extern __shared__ float sm[];
  const int ld = dh + 1;
  float *ks = sm, *vs = ks + SB * ld, *qs = vs + SB * ld, *dos = qs + SB * ld;
  float *pt = dos + SB * ld, *dst = pt + SB * (SB + 1);
  float *ls = dst + SB * (SB + 1), *dl = ls + SB;
  const int bh = blockIdx.x, k0 = blockIdx.y * SB;
  const size_t base = (size_t)bh * S * dh;
  simt_load<T>(ks, k + base, k0, S, dh, 0.f);
  simt_load<T>(vs, v + base, k0, S, dh, 0.f);
  const int j = threadIdx.x >> 3, c0 = threadIdx.x & 7;
  float dka[NC], dva[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dka[c] = dva[c] = 0.f;
  const int i_end = rows_end(k0, SB, S, window);
  for (int i0 = causal ? k0 : 0; i0 < i_end; i0 += SB) {
    __syncthreads();
    simt_load<T>(qs, q + base, i0, S, dh, scale);
    simt_load<T>(dos, dout + base, i0, S, dh, 0.f);
    simt_rows(ls, dl, lse, delta, (size_t)bh * S, i0, S);
    __syncthreads();
    simt_scores<T>(qs, dos, ks, vs, ls, dl, pt, dst, i0, k0, S, dh, causal,
                   window, softcap);
    __syncthreads();
    for (int r = 0; r < SB; ++r) {
      const float pr = pt[r * (SB + 1) + j], dr = dst[r * (SB + 1) + j];
      const float* dor = dos + r * ld;
      const float* qr = qs + r * ld;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = c0 + 8 * c;
        if (d < dh) {
          dva[c] = fmaf(pr, dor[d], dva[c]);
          dka[c] = fmaf(dr, qr[d], dka[c]);
        }
      }
    }
  }
  if (k0 + j < S) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c0 + 8 * c;
      if (d < dh) {
        dk[base + (size_t)(k0 + j) * dh + d] = from_float<T>(dka[c]);
        dv[base + (size_t)(k0 + j) * dh + d] = from_float<T>(dva[c]);
      }
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(128)
    dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int S,
                   int dh, int causal, int window, float scale,
                   float softcap) {
  extern __shared__ float sm[];
  const int ld = dh + 1;
  float *ks = sm, *vs = ks + SB * ld, *qs = vs + SB * ld, *dos = qs + SB * ld;
  float *pt = dos + SB * ld, *dst = pt + SB * (SB + 1);
  float *ls = dst + SB * (SB + 1), *dl = ls + SB;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * SB;
  const size_t base = (size_t)bh * S * dh;
  simt_load<T>(qs, q + base, q0, S, dh, scale);
  simt_load<T>(dos, dout + base, q0, S, dh, 0.f);
  simt_rows(ls, dl, lse, delta, (size_t)bh * S, q0, S);
  const int i = threadIdx.x >> 3, c0 = threadIdx.x & 7;
  float dqa[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dqa[c] = 0.f;
  const int j_end = causal ? min(S, q0 + SB) : S;
  for (int j0 = keys_begin(q0, window, SB); j0 < j_end; j0 += SB) {
    __syncthreads();
    simt_load<T>(ks, k + base, j0, S, dh, 0.f);
    simt_load<T>(vs, v + base, j0, S, dh, 0.f);
    __syncthreads();
    simt_scores<T>(qs, dos, ks, vs, ls, dl, pt, dst, q0, j0, S, dh, causal,
                   window, softcap);
    __syncthreads();
    for (int j = 0; j < SB; ++j) {
      const float dr = dst[i * (SB + 1) + j];
      const float* kr = ks + j * ld;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = c0 + 8 * c;
        if (d < dh) dqa[c] = fmaf(dr, kr[d], dqa[c]);
      }
    }
  }
  if (q0 + i < S) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c0 + 8 * c;
      if (d < dh)
        dq[base + (size_t)(q0 + i) * dh + d] = from_float<T>(dqa[c] * scale);
    }
  }
}

template <typename T, int NC>
int launch_simt(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, void* dk,
                void* dv, int BH, int S, int dh, int causal, int window,
                float scale, float softcap, cudaStream_t st) {
  const size_t smem = simt_smem(dh);
  int err = (int)allow_smem(dkdv_simt_kernel<T, NC>, smem);
  if (err == 0) err = (int)allow_smem(dq_simt_kernel<T, NC>, smem);
  if (err != 0) return err;
  const dim3 grid(BH, (S + SB - 1) / SB);
  dkdv_simt_kernel<T, NC><<<grid, 128, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, dh, causal, window, scale, softcap);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_simt_kernel<T, NC><<<grid, 128, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, dh, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, void* dq, void* dk, void* dv,
             float* delta, void* qs, int BH, int S, int dh, int causal,
             int window, float scale, float softcap, cudaStream_t st) {
  const long rows = (long)BH * S;
  rowdot_kernel<T><<<(unsigned)((rows + 3) / 4), 128, 0, st>>>(
      (const T*)o, (const T*)dout, delta, rows, dh);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if constexpr (sizeof(T) == 2) {
    if (dh == 128)
      return launch_wgmma<128, 3, 4>(q, k, v, dout, lse, delta, qs, dq, dk,
                                     dv, BH, S, causal, window, scale,
                                     softcap, st);
    if (dh == 64)
      return launch_wgmma<64, 4, 4>(q, k, v, dout, lse, delta, qs, dq, dk, dv,
                                    BH, S, causal, window, scale, softcap,
                                    st);
  }
  if (dh <= 32)
    return launch_simt<T, 4>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S, dh,
                             causal, window, scale, softcap, st);
  if (dh <= 64)
    return launch_simt<T, 8>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S, dh,
                             causal, window, scale, softcap, st);
  if (dh <= 128)
    return launch_simt<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S,
                              dh, causal, window, scale, softcap, st);
  return launch_simt<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S, dh,
                            causal, window, scale, softcap, st);
}

}  // namespace

// 1 where a call at (dh, is_bf16) runs the tensor-core kernels
// (dkdv_wgmma_kernel, dq_wgmma_kernel: bf16 with dh 64 or 128; they read
// q * scale from the ``qs`` scratch), 0 where it runs on the CUDA cores;
// repro_flash_attention_bwd dispatches by it
extern "C" int repro_flash_bwd_route(int dh, int is_bf16) {
  return is_bf16 && (dh == 64 || dh == 128) ? 1 : 0;
}

// q, k, v, o, dout, dq, dk, dv: (BH, S, dh) contiguous, 16-byte aligned,
// float32 or (is_bf16) bf16; lse: the forward's float32 (BH, S); delta:
// float32 (BH, S) scratch; qs: (BH, S, dh) scratch of q's type where
// repro_flash_bwd_route says the tensor cores, else unused (may be null);
// window > 0 masks keys window or more behind the row (causal only), 0
// means none; scale: dh^-0.5 rounded to q's type, as the forward takes it;
// softcap <= 0 means none.  dh <= 256, S <= 65535 * 16.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const float* lse, const void* dout,
                                         void* dq, void* dk, void* dv,
                                         float* delta, void* qs, int BH,
                                         int S, int dh, int is_bf16,
                                         int causal, int window, float scale,
                                         float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0) return 0;
  if (dh <= 0 || dh > 256 || window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (repro_flash_bwd_route(dh, is_bf16) && qs == nullptr)
    return (int)cudaErrorInvalidValue;
  const int win = window > 0 ? window : INT_MAX;
  if (is_bf16)
    return backward<bf16>(q, k, v, o, lse, dout, dq, dk, dv, delta, qs, BH, S,
                          dh, causal, win, scale, softcap, st);
  return backward<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, qs, BH, S,
                         dh, causal, win, scale, softcap, st);
}
