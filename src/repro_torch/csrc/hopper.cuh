// Hopper (sm_90a) building blocks shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu): mbarriers,
// TMA loads and stores through 3-D tensor maps over (dh, S, BH), wgmma
// descriptors of the 128-byte swizzle TMA writes, the wgmma products the
// two kernels issue, and the host-side tensor-map encoder.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SWIZZLE_ROWS_BYTES = 1024;   // one swizzle atom: 8 rows x 128 B
constexpr int BOX_ROW_BYTES = 128;         // a box row: 64 bf16 columns
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// one (64 columns, the map's rows, 1 head) box of a (dh, S, BH) tensor map
// into shared memory, 128-byte swizzled; rows past S arrive as zeros
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

// one (64 columns, the map's rows, 1 head) box from shared memory (128-byte
// swizzled) into a (dh, S, BH) tensor map; rows past S are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// the issuing thread's bulk stores committed and their shared-memory reads
// done (the block may exit)
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over one warpgroup (128 threads), named ``id`` (1..15)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
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

// D (64 x 64, float32) (+)= A (64 x 16) . B (16 x 64), A and B in shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers, the m16n8k16
// A-fragment layout per warp) . B (16 x 128) in shared memory, MN-major
// (its 128-wide rows contiguous: the transpose bit); D is the 64 floats of
// ``d`` from AT on (a 256-wide accumulator's columns 128..255 have the
// register layout of columns 0..127, 64 floats on)
template <int AT = 0, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  static_assert(AT + 64 <= N, "the accumulator holds 64 floats from AT");
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
      "+f"(d[AT + 0]), "+f"(d[AT + 1]), "+f"(d[AT + 2]), "+f"(d[AT + 3]),
      "+f"(d[AT + 4]), "+f"(d[AT + 5]), "+f"(d[AT + 6]), "+f"(d[AT + 7]),
      "+f"(d[AT + 8]), "+f"(d[AT + 9]), "+f"(d[AT + 10]), "+f"(d[AT + 11]),
      "+f"(d[AT + 12]), "+f"(d[AT + 13]), "+f"(d[AT + 14]), "+f"(d[AT + 15]),
      "+f"(d[AT + 16]), "+f"(d[AT + 17]), "+f"(d[AT + 18]), "+f"(d[AT + 19]),
      "+f"(d[AT + 20]), "+f"(d[AT + 21]), "+f"(d[AT + 22]), "+f"(d[AT + 23]),
      "+f"(d[AT + 24]), "+f"(d[AT + 25]), "+f"(d[AT + 26]), "+f"(d[AT + 27]),
      "+f"(d[AT + 28]), "+f"(d[AT + 29]), "+f"(d[AT + 30]), "+f"(d[AT + 31]),
      "+f"(d[AT + 32]), "+f"(d[AT + 33]), "+f"(d[AT + 34]), "+f"(d[AT + 35]),
      "+f"(d[AT + 36]), "+f"(d[AT + 37]), "+f"(d[AT + 38]), "+f"(d[AT + 39]),
      "+f"(d[AT + 40]), "+f"(d[AT + 41]), "+f"(d[AT + 42]), "+f"(d[AT + 43]),
      "+f"(d[AT + 44]), "+f"(d[AT + 45]), "+f"(d[AT + 46]), "+f"(d[AT + 47]),
      "+f"(d[AT + 48]), "+f"(d[AT + 49]), "+f"(d[AT + 50]), "+f"(d[AT + 51]),
      "+f"(d[AT + 52]), "+f"(d[AT + 53]), "+f"(d[AT + 54]), "+f"(d[AT + 55]),
      "+f"(d[AT + 56]), "+f"(d[AT + 57]), "+f"(d[AT + 58]), "+f"(d[AT + 59]),
      "+f"(d[AT + 60]), "+f"(d[AT + 61]), "+f"(d[AT + 62]), "+f"(d[AT + 63])
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

// S (64 rows x N, float32) = A (64 x DH) . B^T (N x DH), both K-major tiles
// of 64-column boxes in shared memory: A's boxes ``a_box`` bytes apart, B's
// ``b_box`` (column 64 starts the next box); DH / 16 steps of 16 columns,
// not committed
template <int DH, int N>
__device__ __forceinline__ void wgmma_rows_dot(float (&s)[N / 2], uint32_t a,
                                               uint32_t a_box, uint32_t b,
                                               uint32_t b_box) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    const uint64_t da = sw128_desc(a + (kk >> 2) * a_box + col, 16);
    const uint64_t db = sw128_desc(b + (kk >> 2) * b_box + col, 16);
    if constexpr (N == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
}

// D (64 x DH, float32) += A (64 x K, bf16 in registers: K / 16 fragments)
// . B (K x DH), B an MN-major tile in shared memory (rows of 64-column
// boxes ``box`` bytes apart, 16 rows of 128 bytes a step); DH 256 as two
// n128 halves, the second two boxes on.  Not committed.
template <int DH, int K>
__device__ __forceinline__ void wgmma_acc_rows(float (&d)[DH / 2],
                                               const uint32_t (&a)[K / 16][4],
                                               uint32_t b, uint32_t box) {
#pragma unroll
  for (int c = 0; c < K / 16; ++c) {
    const uint32_t at = b + c * 16 * BOX_ROW_BYTES;
    if constexpr (DH == 256) {
      wgmma_rs_n128<0>(d, a[c], sw128_desc(at, box));
      wgmma_rs_n128<64>(d, a[c], sw128_desc(at + 2 * box, box));
    } else if constexpr (DH == 128) {
      wgmma_rs_n128(d, a[c], sw128_desc(at, box));
    } else {
      wgmma_rs_n64(d, a[c], sw128_desc(at, box));
    }
  }
}

// an accumulator of 16-key groups (element i: column 8 (i / 4) + 2t +
// (i & 1) of row (i & 2) ? r0 + 8 : r0) in bf16 as the A operand of a
// product over those columns: columns 16c..16c+15 are its 8-column groups
// 2c and 2c + 1
template <int N>
__device__ __forceinline__ void pack_a(const float (&s)[N],
                                       uint32_t (&p)[N / 8][4]) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    p[c][0] = pack2(s[8 * c + 0], s[8 * c + 1]);
    p[c][1] = pack2(s[8 * c + 2], s[8 * c + 3]);
    p[c][2] = pack2(s[8 * c + 4], s[8 * c + 5]);
    p[c][3] = pack2(s[8 * c + 6], s[8 * c + 7]);
  }
}

// Rows r0 and r0 + 8 of a (64 x N) accumulator, each value times
// ``mul[0]`` / ``mul[1]``, in bf16 into a 128-byte swizzled tile of
// 64-column boxes ``box`` bytes apart, the layout TMA stores from: the
// 16-byte chunk n % 8 of row r sits at chunk (n % 8) ^ (r % 8), and
// r % 8 = g for both rows.  ``row0``: the tile's byte address of row r0
// (its chunk 0) plus 4t.
template <int N>
__device__ __forceinline__ void stage_rows(uint8_t* row0, const float (&d)[N],
                                           const float (&mul)[2], int g,
                                           uint32_t box) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    uint8_t* const at = row0 + (n >> 3) * box + (((n & 7) ^ g) << 4);
    *reinterpret_cast<uint32_t*>(at) =
        pack2(d[4 * n] * mul[0], d[4 * n + 1] * mul[0]);
    *reinterpret_cast<uint32_t*>(at + 8 * BOX_ROW_BYTES) =
        pack2(d[4 * n + 2] * mul[1], d[4 * n + 3] * mul[1]);
  }
}

// one arrival per warp on an empty barrier, once the warp is done
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
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

// a 3-D bf16 map over (dh, S, BH): boxes of 64 columns x ``rows`` rows of
// one head, so a box never reaches into the next head (rows past S read as
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

// the dynamic shared memory a kernel asks for, set once per kernel
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
