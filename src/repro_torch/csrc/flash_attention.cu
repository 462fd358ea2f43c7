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
//             -1e30 where j > i (causal) or j >= S
//     o[i]  = sum_j p_ij v_j / max(sum_j p_ij, 1e-20), cast to q's type
//   with p_ij the online softmax over KV tiles: running max m and
//   denominator l in float32, p = exp(s - m) cast to v's type before the
//   P.V product (the reference's cast point), the accumulator in float32.
//   The TPU grid's sequential KV axis and its VMEM scratch become a loop
//   over KV tiles inside one block, whose state stays in registers; one
//   block handles one (bh, q tile).  Causal blocks stop at their diagonal
//   tile (the tiles past it are fully masked and change no output), and
//   the heaviest q tiles are issued first.  A ragged S is masked at the
//   edge (the TPU grid's S // bq leaves the tail unwritten; this kernel
//   writes every row).
//   Bound on this card, at the LM prefill of starcoder2-7b (BH = 4 * 36,
//   S = 2048, dh = 128, bf16, causal): operations — the causal half of
//   4 * S^2 * dh * BH = 1.55e11 FLOP at 989 TFLOP/s bf16 is 0.156 ms,
//   against 302 MB of q, k, v and o at 3.35 TB/s, 0.090 ms.
//   Two designs, one contract:
//   * bf16 with dh 64 or 128: tensor cores through mma.sync m16n8k16
//     (bf16 in, float32 accumulate).  4 warps, 16 q rows each (a 64-row q
//     tile); the q fragments stay in registers for the whole KV loop; each
//     64-key tile of K (row-major) and V (transposed on the way in) sits in
//     shared memory, rows padded by 16 bytes so the fragment reads hit 32
//     distinct banks.  The S accumulator's layout is the A-fragment layout
//     of P, so P never leaves registers.  No cp.async or TMA pipeline yet:
//     the tile loads and the products do not overlap (wgmma/TMA is later
//     work).
//   * everything else (float32, where the tensor cores' TF32 would miss
//     the reference's 1e-5; bf16 of other widths): CUDA cores.  4 warps,
//     4 q rows each; per 32-key tile lane j scores key j against the row,
//     the warp reduces max and sum by shuffles, and each lane accumulates
//     dh/32 output columns.  Explicit fmaf (the build passes
//     --fmad=false for the graph kernels' bit-exact sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

__device__ __forceinline__ float softcap_mask(float s, float softcap, int key,
                                              int row, int S, int causal) {
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  return (key >= S || (causal && key > row)) ? NEG : s;
}

// ---------------------------------------------------------------------------
// bf16, dh 64 / 128: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;   // q rows per block: 4 warps x 16
constexpr int MMA_BK = 64;   // keys per tile

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q[row][col], q[row][col + 1] scaled and rounded to bf16, packed; 0 past S
__device__ __forceinline__ uint32_t q_pair(const bf16* qb, int row, int col,
                                           int S, int dh, float scale) {
  if (row >= S) return 0u;
  __nv_bfloat162 x =
      *reinterpret_cast<const __nv_bfloat162*>(qb + (size_t)row * dh + col);
  return pack2(__bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
}

template <int DH>
__global__ void __launch_bounds__(128)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                     int causal, float scale, float softcap) {
  constexpr int KS = DH + 8;       // K tile row stride (elements)
  constexpr int VS = MMA_BK + 8;   // V^T tile row stride
  constexpr int NC = DH / 16;      // k-chunks of the q.k product
  constexpr int NJ = MMA_BK / 8;   // 8-key column tiles of S
  constexpr int ND = DH / 8;       // 8-column tiles of the output
  constexpr int CH = DH / 8;       // 16-byte chunks of a row
  __shared__ __align__(16) bf16 ks[MMA_BK * KS];
  __shared__ __align__(16) bf16 vts[DH * VS];

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * S * DH;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qf[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    qf[c][0] = q_pair(qb, r0, c * 16 + 2 * t, S, DH, scale);
    qf[c][1] = q_pair(qb, r1, c * 16 + 2 * t, S, DH, scale);
    qf[c][2] = q_pair(qb, r0, c * 16 + 2 * t + 8, S, DH, scale);
    qf[c][3] = q_pair(qb, r1, c * 16 + 2 * t + 8, S, DH, scale);
  }
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int kend = causal ? min(S, q0 + MMA_BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += MMA_BK) {
    __syncthreads();   // the previous tile's reads are done
    // K rows as 16-byte chunks, neighbouring threads on neighbouring chunks
    for (int i = threadIdx.x; i < MMA_BK * CH; i += blockDim.x) {
      const int r = i / CH, c8 = (i % CH) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S)
        x = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * DH + c8);
      *reinterpret_cast<uint4*>(ks + r * KS + c8) = x;
    }
    // V transposed: neighbouring threads on neighbouring keys, so the
    // scalar stores into a V^T row fall on distinct banks
    for (int i = threadIdx.x; i < MMA_BK * CH; i += blockDim.x) {
      const int r = i % MMA_BK, c8 = (i / MMA_BK) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S)
        x = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * DH + c8);
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[(c8 + j) * VS + r] = e[j];
    }
    __syncthreads();

    // S = q . K^T for this warp's 16 rows x 64 keys
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const bf16* kr = ks + (j * 8 + g) * KS + c * 16 + 2 * t;
        mma16816(s[j], qf[c], ld32(kr), ld32(kr + 8));
      }
    }
    // softcap and mask; this thread holds rows r0 (e = 0, 1) and r1 (2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = softcap_mask(s[j][e], softcap, key, e < 2 ? r0 : r1, S,
                               causal);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
    }
    const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(FULL, rs[h], 1);
      rs[h] += __shfl_xor_sync(FULL, rs[h], 2);
      l[h] = l[h] * alpha[h] + rs[h];
      m[h] = mx[h];
    }
    // P in bf16 as A fragments: keys 16c..16c+15 are S tiles 2c and 2c+1
    uint32_t pf[MMA_BK / 16][4];
#pragma unroll
    for (int c = 0; c < MMA_BK / 16; ++c) {
      pf[c][0] = pack2(s[2 * c][0], s[2 * c][1]);
      pf[c][1] = pack2(s[2 * c][2], s[2 * c][3]);
      pf[c][2] = pack2(s[2 * c + 1][0], s[2 * c + 1][1]);
      pf[c][3] = pack2(s[2 * c + 1][2], s[2 * c + 1][3]);
    }
    // acc = acc * alpha + P . V
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
#pragma unroll
      for (int c = 0; c < MMA_BK / 16; ++c) {
        const bf16* vr = vts + (d * 8 + g) * VS + c * 16 + 2 * t;
        mma16816(acc[d], pf[c], ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float den0 = fmaxf(l[0], 1e-20f), den1 = fmaxf(l[1], 1e-20f);
  bf16* ob = o + base;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * DH + col) =
          pack2(acc[d][0] / den0, acc[d][1] / den0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * DH + col) =
          pack2(acc[d][2] / den1, acc[d][3] / den1);
  }
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
                      const T* __restrict__ v, T* __restrict__ o, int S,
                      int dh, int causal, float scale, float softcap) {
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

  const int kend = causal ? min(S, q0 + SIMT_BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += SIMT_BK) {
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
      s = softcap_mask(s, softcap, k0 + lane, q0 + r, S, causal);
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
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) o[base + (size_t)row * dh + d] = from_float<T>(acc[rr][i] / den);
    }
  }
}

template <typename T, int DPL>
int launch_simt(const void* q, const void* k, const void* v, void* o, int BH,
                int S, int dh, int causal, float scale, float softcap,
                cudaStream_t st) {
  const size_t smem = simt_smem(dh);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_simt_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(BH, (S + SIMT_BQ - 1) / SIMT_BQ);
  flash_simt_kernel<T, DPL><<<grid, 128, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, dh, causal, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* o,
                  int BH, int S, int dh, int causal, float scale,
                  float softcap, cudaStream_t st) {
  if (dh <= 32)
    return launch_simt<T, 1>(q, k, v, o, BH, S, dh, causal, scale, softcap, st);
  if (dh <= 64)
    return launch_simt<T, 2>(q, k, v, o, BH, S, dh, causal, scale, softcap, st);
  if (dh <= 128)
    return launch_simt<T, 4>(q, k, v, o, BH, S, dh, causal, scale, softcap, st);
  return launch_simt<T, 8>(q, k, v, o, BH, S, dh, causal, scale, softcap, st);
}

}  // namespace

// q, k, v, o: (BH, S, dh) contiguous, 16-byte aligned; is_bf16 selects
// bf16 over float32; scale is dh^-0.5 already rounded to q's type (the
// reference multiplies q by a weakly typed scalar); softcap <= 0 means
// none.  dh <= 256, S <= 65535 * 16.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int BH, int S,
                                     int dh, int is_bf16, int causal,
                                     float scale, float softcap,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0) return 0;
  if (dh <= 0 || dh > 256) return (int)cudaErrorInvalidValue;
  if (is_bf16 && (dh == 64 || dh == 128)) {
    const dim3 grid(BH, (S + MMA_BQ - 1) / MMA_BQ);
    if (dh == 64)
      flash_mma_kernel<64><<<grid, 128, 0, st>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S,
          causal, scale, softcap);
    else
      flash_mma_kernel<128><<<grid, 128, 0, st>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S,
          causal, scale, softcap);
    return (int)cudaGetLastError();
  }
  if (is_bf16)
    return dispatch_simt<bf16>(q, k, v, o, BH, S, dh, causal, scale, softcap,
                               st);
  return dispatch_simt<float>(q, k, v, o, BH, S, dh, causal, scale, softcap,
                              st);
}
