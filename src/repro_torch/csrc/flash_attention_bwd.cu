// Flash-attention backward on Hopper (sm_90a).  Bound to PyTorch through a
// plain C interface (ctypes) by src/repro_torch/kernels/flash_attention.py,
// which also holds the plain PyTorch version and the autograd Function.
// The entry point launches on the caller's stream, allocates nothing (the
// wrapper hands it the float32 scratch ``delta``), and returns
// cudaGetLastError().
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
//   Three kernels, no float atomics, so two calls on the same inputs agree
//   bit for bit: rowdot_kernel (D, one warp a row), then a dK/dV kernel
//   whose block owns a tile of keys and walks the q tiles that reach it,
//   then a dQ kernel whose block owns a tile of q rows and walks the KV
//   tiles it reaches.  Causal walks skip the tiles wholly in the future,
//   window walks those wholly behind the window; the heaviest blocks are
//   issued first.  P and dS are recomputed in both the dK/dV and the dQ
//   kernel (7 products of S x S x dh in place of 5).
//   Bound on this card, at starcoder2-7b's training shape (BH = 4 * 36,
//   S = 2048, dh = 128, bf16, causal): operations — 5 products of the
//   causal half, 5 * 2 * dh * BH * S (S + 1) / 2 = 386.7 GFLOP at 989
//   TFLOP/s is 0.391 ms, against 5 * 75.5 MB read (q, k, v, o, do) and
//   3 * 75.5 MB written at 3.35 TB/s, 0.181 ms.  So the tensor cores have
//   to carry the products:
//   * bf16 with dh 64 or 128: mma.sync m16n8k16 (bf16 in, float32
//     accumulators), 4 warps a block, each warp 16 keys (dK/dV) or 16 q
//     rows (dQ); operands through ldmatrix from shared-memory tiles padded
//     by 16 bytes a row (no bank conflicts); P and dS go from the
//     accumulator layout straight into the A operand of the next product.
//     Tiles are loaded with 16-byte loads and a block barrier, no
//     pipeline: a simple first kernel (wgmma and TMA are later work).
//   * everything else (float32, where the tensor cores' TF32 would miss
//     the reference's 1e-5, and bf16 of other widths up to 256): CUDA
//     cores, 128 threads on 16 x 16 tiles of scores in shared memory,
//     explicit fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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
// bf16, dh 64 / 128: mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8 x 8 bf16 matrices from shared memory, lanes 8i..8i+7 giving the
// row addresses of matrix i; .trans hands each lane a column pair instead
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// C (16 x 8, float32) += A (16 x 16, bf16, row-major fragment) . B (16 x 8)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared tiles are bf16 [rows][DH + 8]: a row of 16 * (DH / 8 + 1) bytes,
// so the 8 row addresses of an ldmatrix fall on 8 different 16-byte bank
// groups.  Operand addresses (lane = 0..31), for a 16 x 16 block at (r0,
// c0) of a tile:
//   A, row-major from X[m][k]:           row r0 + (lane & 15),
//                                        col c0 + (lane >> 4) * 8
//   B of two n-blocks from X[n][k]:      row r0 + (lane & 7) + (lane >> 4) * 8,
//     (K^T, Q^T, V^T, dO^T)              col c0 + ((lane >> 3) & 1) * 8
//   B of two n-blocks from X[k][n], .trans:
//     (dO, Qs, K as k x n)               row r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
//                                        col c0 + (lane >> 4) * 8
// the last two give {b0, b1} of n-block 0 in r[0], r[1] and of n-block 1 in
// r[2], r[3].
template <int DH>
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int c0,
                                           int lane) {
  return tile + ((r0 + (lane & 15)) * (DH + 8) + c0 + (lane >> 4) * 8) * 2;
}
template <int DH>
__device__ __forceinline__ uint32_t bn_addr(uint32_t tile, int r0, int c0,
                                            int lane) {
  return tile + ((r0 + (lane & 7) + (lane >> 4) * 8) * (DH + 8) + c0 +
                 ((lane >> 3) & 1) * 8) *
                    2;
}
template <int DH>
__device__ __forceinline__ uint32_t bt_addr(uint32_t tile, int r0, int c0,
                                            int lane) {
  return tile + ((r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * (DH + 8) + c0 +
                 (lane >> 4) * 8) *
                    2;
}

// rows [row0, row0 + n) of a (S, DH) head into a padded tile, zeros past S;
// with ``scale`` != 0 each value is multiplied by it and rounded to bf16
// (q * scale, as the forward rounds it)
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int n, int S,
                                          float scale) {
  constexpr int CH = DH / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < S) {
      x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * DH +
                                          c * 8);
      if (scale != 0.f) {
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 f = __bfloat1622float2(e[h]);
          e[h] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c * 8) = x;
  }
}

constexpr int MMA_BC = 64;   // keys a dK/dV block owns: 4 warps x 16
constexpr int MMA_BQ = 64;   // q rows a dQ block owns: 4 warps x 16

template <int DH, int BR>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * MMA_BC + 2 * BR) * (DH + 8) * 2 + 2 * BR * 4;
}
template <int DH, int BC>
constexpr size_t dq_smem() {
  return (size_t)(2 * MMA_BQ + 2 * BC) * (DH + 8) * 2;
}

// One block owns MMA_BC keys of one head (warp w: keys 16w..16w+15) and
// walks the q tiles of BR rows that reach them.  Per q tile: S^T = K.Qs^T
// and dP^T = V.dO^T (M = the warp's keys, N = the tile's rows, K = dh),
// then P^T and dS^T elementwise in the accumulators, then dV += P^T.dO and
// dK += dS^T.Qs (M = keys, K = rows, N = dh) with P^T and dS^T repacked
// as A operands in registers.
template <int DH, int BR>
__global__ void __launch_bounds__(128)
    dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int causal, int window,
                    float scale, float softcap) {
  constexpr int LDS = DH + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* const ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* const vs = ks + MMA_BC * LDS;
  bf16* const qs = vs + MMA_BC * LDS;
  bf16* const dos = qs + BR * LDS;
  float* const ls = reinterpret_cast<float*>(dos + BR * LDS);
  float* const dl = ls + BR;
  const uint32_t ks_u = smem_u32(ks), vs_u = smem_u32(vs),
                 qs_u = smem_u32(qs), dos_u = smem_u32(dos);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * MMA_BC;   // the heaviest causal tiles first
  const size_t base = (size_t)bh * S * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile<DH>(ks, k + base, k0, MMA_BC, S, 0.f);
  load_tile<DH>(vs, v + base, k0, MMA_BC, S, 0.f);

  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int i_begin = causal ? k0 : 0;   // BR divides MMA_BC
  const int i_end = rows_end(k0, MMA_BC, S, window);
  for (int i0 = i_begin; i0 < i_end; i0 += BR) {
    __syncthreads();   // the previous tile's reads are done
    load_tile<DH>(qs, q + base, i0, BR, S, scale);
    load_tile<DH>(dos, dout + base, i0, BR, S, 0.f);
    if (threadIdx.x < BR) {
      const int row = i0 + threadIdx.x;
      ls[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      dl[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();

    float st[BR / 8][4], dpt[BR / 8][4];
#pragma unroll
    for (int n = 0; n < BR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, a_addr<DH>(ks_u, warp * 16, kk * 16, lane));
      ldsm_x4(av, a_addr<DH>(vs_u, warp * 16, kk * 16, lane));
#pragma unroll
      for (int nb = 0; nb < BR / 16; ++nb) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, bn_addr<DH>(qs_u, nb * 16, kk * 16, lane));
        ldsm_x4(bo, bn_addr<DH>(dos_u, nb * 16, kk * 16, lane));
        mma(st[2 * nb], ak, bq[0], bq[1]);
        mma(st[2 * nb + 1], ak, bq[2], bq[3]);
        mma(dpt[2 * nb], av, bo[0], bo[1]);
        mma(dpt[2 * nb + 1], av, bo[2], bo[3]);
      }
    }
    // element e of n-block nb: key 16 warp + g (+8 for e >= 2), row
    // 8 nb + 2t + (e & 1) of the tile
#pragma unroll
    for (int nb = 0; nb < BR / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + warp * 16 + g + ((e >> 1) << 3);
        const int rl = nb * 8 + 2 * t + (e & 1);
        float p, ds;
        p_ds(st[nb][e], dpt[nb][e], ls[rl], dl[rl], softcap,
             masked(key, i0 + rl, S, causal, window), p, ds);
        st[nb][e] = p;
        dpt[nb][e] = ds;
      }
#pragma unroll
    for (int kb = 0; kb < BR / 16; ++kb) {
      const uint32_t ap[4] = {pack2(st[2 * kb][0], st[2 * kb][1]),
                              pack2(st[2 * kb][2], st[2 * kb][3]),
                              pack2(st[2 * kb + 1][0], st[2 * kb + 1][1]),
                              pack2(st[2 * kb + 1][2], st[2 * kb + 1][3])};
      const uint32_t ad[4] = {pack2(dpt[2 * kb][0], dpt[2 * kb][1]),
                              pack2(dpt[2 * kb][2], dpt[2 * kb][3]),
                              pack2(dpt[2 * kb + 1][0], dpt[2 * kb + 1][1]),
                              pack2(dpt[2 * kb + 1][2], dpt[2 * kb + 1][3])};
#pragma unroll
      for (int nb = 0; nb < DH / 16; ++nb) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, bt_addr<DH>(dos_u, kb * 16, nb * 16, lane));
        ldsm_x4_t(bq, bt_addr<DH>(qs_u, kb * 16, nb * 16, lane));
        mma(dva[2 * nb], ap, bo[0], bo[1]);
        mma(dva[2 * nb + 1], ap, bo[2], bo[3]);
        mma(dka[2 * nb], ad, bq[0], bq[1]);
        mma(dka[2 * nb + 1], ad, bq[2], bq[3]);
      }
    }
  }

  // element e of n-block n: key 16 warp + g (+8 for e >= 2), column
  // 8n + 2t + (e & 1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + 8 * h;
    if (key >= S) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const size_t at = base + (size_t)key * DH + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack2(dka[n][2 * h], dka[n][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack2(dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

// One block owns MMA_BQ q rows of one head (warp w: rows 16w..16w+15) and
// walks the KV tiles of BC keys they reach.  Per KV tile: S = Qs.K^T and
// dP = dO.V^T (M = rows, N = keys, K = dh), dS elementwise, then dQ +=
// dS.K (M = rows, K = keys, N = dh) with dS repacked as the A operand.
template <int DH, int BC>
__global__ void __launch_bounds__(128)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int S, int causal, int window, float scale, float softcap) {
  constexpr int LDS = DH + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* const dos = qs + MMA_BQ * LDS;
  bf16* const ks = dos + MMA_BQ * LDS;
  bf16* const vs = ks + BC * LDS;
  const uint32_t ks_u = smem_u32(ks), vs_u = smem_u32(vs),
                 qs_u = smem_u32(qs), dos_u = smem_u32(dos);

  const int bh = blockIdx.x;
  // the heaviest causal tiles (the last rows) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;
  const size_t base = (size_t)bh * S * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = warp * 16 + g;   // this thread's rows: rl0 and rl0 + 8

  load_tile<DH>(qs, q + base, q0, MMA_BQ, S, scale);
  load_tile<DH>(dos, dout + base, q0, MMA_BQ, S, 0.f);
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rl0 + 8 * h;
    lr[h] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    dr[h] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float dqa[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const int j_begin = keys_begin(q0, window, BC);
  const int j_end = causal ? min(S, q0 + MMA_BQ) : S;
  for (int j0 = j_begin; j0 < j_end; j0 += BC) {
    __syncthreads();
    load_tile<DH>(ks, k + base, j0, BC, S, 0.f);
    load_tile<DH>(vs, v + base, j0, BC, S, 0.f);
    __syncthreads();

    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, a_addr<DH>(qs_u, warp * 16, kk * 16, lane));
      ldsm_x4(ao, a_addr<DH>(dos_u, warp * 16, kk * 16, lane));
#pragma unroll
      for (int nb = 0; nb < BC / 16; ++nb) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, bn_addr<DH>(ks_u, nb * 16, kk * 16, lane));
        ldsm_x4(bv, bn_addr<DH>(vs_u, nb * 16, kk * 16, lane));
        mma(s[2 * nb], aq, bk[0], bk[1]);
        mma(s[2 * nb + 1], aq, bk[2], bk[3]);
        mma(dp[2 * nb], ao, bv[0], bv[1]);
        mma(dp[2 * nb + 1], ao, bv[2], bv[3]);
      }
    }
    // element e of n-block nb: row rl0 (+8 for e >= 2), key
    // j0 + 8 nb + 2t + (e & 1)
#pragma unroll
    for (int nb = 0; nb < BC / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = j0 + nb * 8 + 2 * t + (e & 1);
        float p, ds;
        p_ds(s[nb][e], dp[nb][e], lr[h], dr[h], softcap,
             masked(key, q0 + rl0 + 8 * h, S, causal, window), p, ds);
        s[nb][e] = ds;
      }
#pragma unroll
    for (int kb = 0; kb < BC / 16; ++kb) {
      const uint32_t ad[4] = {pack2(s[2 * kb][0], s[2 * kb][1]),
                              pack2(s[2 * kb][2], s[2 * kb][3]),
                              pack2(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                              pack2(s[2 * kb + 1][2], s[2 * kb + 1][3])};
#pragma unroll
      for (int nb = 0; nb < DH / 16; ++nb) {
        uint32_t bk[4];
        ldsm_x4_t(bk, bt_addr<DH>(ks_u, kb * 16, nb * 16, lane));
        mma(dqa[2 * nb], ad, bk[0], bk[1]);
        mma(dqa[2 * nb + 1], ad, bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rl0 + 8 * h;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)row * DH + n * 8 +
                                   2 * t) =
          pack2(dqa[n][2 * h] * scale, dqa[n][2 * h + 1] * scale);
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DH, int BR, int BC>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int BH, int S, int causal, int window, float scale,
               float softcap, cudaStream_t st) {
  constexpr size_t s1 = dkdv_smem<DH, BR>(), s2 = dq_smem<DH, BC>();
  int err = allow_smem(dkdv_mma_kernel<DH, BR>, s1);
  if (err == 0) err = allow_smem(dq_mma_kernel<DH, BC>, s2);
  if (err != 0) return err;
  const dim3 g1(BH, (S + MMA_BC - 1) / MMA_BC), g2(BH, (S + MMA_BQ - 1) / MMA_BQ);
  dkdv_mma_kernel<DH, BR><<<g1, 128, s1, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dk, (bf16*)dv, S, causal, window, scale, softcap);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_mma_kernel<DH, BC><<<g2, 128, s2, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dq, S, causal, window, scale, softcap);
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
  int err = allow_smem(dkdv_simt_kernel<T, NC>, smem);
  if (err == 0) err = allow_smem(dq_simt_kernel<T, NC>, smem);
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
             float* delta, int BH, int S, int dh, int causal, int window,
             float scale, float softcap, cudaStream_t st) {
  const long rows = (long)BH * S;
  rowdot_kernel<T><<<(unsigned)((rows + 3) / 4), 128, 0, st>>>(
      (const T*)o, (const T*)dout, delta, rows, dh);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if constexpr (sizeof(T) == 2) {
    if (dh == 128)
      return launch_mma<128, 32, 64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     BH, S, causal, window, scale, softcap,
                                     st);
    if (dh == 64)
      return launch_mma<64, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, BH,
                                    S, causal, window, scale, softcap, st);
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

// q, k, v, o, dout, dq, dk, dv: (BH, S, dh) contiguous, 16-byte aligned,
// float32 or (is_bf16) bf16; lse: the forward's float32 (BH, S); delta:
// float32 (BH, S) scratch; window > 0 masks keys window or more behind
// the row (causal only), 0 means none; scale: dh^-0.5 rounded to q's
// type, as the forward takes it; softcap <= 0 means none.  dh <= 256,
// S <= 65535 * 16.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const float* lse, const void* dout,
                                         void* dq, void* dk, void* dv,
                                         float* delta, int BH, int S, int dh,
                                         int is_bf16, int causal, int window,
                                         float scale, float softcap,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0) return 0;
  if (dh <= 0 || dh > 256 || window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  const int win = window > 0 ? window : INT_MAX;
  if (is_bf16)
    return backward<bf16>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, S, dh,
                          causal, win, scale, softcap, st);
  return backward<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, S, dh,
                         causal, win, scale, softcap, st);
}
