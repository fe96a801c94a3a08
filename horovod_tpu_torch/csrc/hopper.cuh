// Hopper (sm_90a) building blocks of the tensor-core flash kernels:
// mbarriers, TMA tile loads, wgmma and its shared-memory descriptors, and
// the host-side encoding of the TMA tensor maps.
//
// Tile layout. A 64-row tile of a [B, T, H, D] bf16 tensor is loaded by TMA
// as D / 64 boxes of 64 rows x 64 columns (128 bytes a row), each box 8 KB
// and 128-byte swizzled (CU_TENSOR_MAP_SWIZZLE_128B): within every group of
// 8 rows (1024 bytes) the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
// Every tile starts on a 1024-byte boundary, so TMA and wgmma agree on the
// swizzle (descriptor base offset 0). The tensor map is 4-D over
// (D, H, T, B) with box (64, 1, 64, 1): rows past T come back as zeros, and
// never as the next batch's rows.
//
// wgmma operands, in the PTX ISA's terms (cute's canonical GMMA layouts):
// - K-major (the contiguous 64 columns are the reduction axis), e.g. Q and
//   K in S = Q K^T: rows 128 bytes apart, 8-row groups 1024 bytes apart
//   (SBO), and the k16 slice kk of a box starts 32 * kk bytes in.
// - MN-major (the contiguous columns are the output axis N; rows are the
//   reduction axis), e.g. V in O = P V, with trans-b: the k16 slice kk
//   starts 16 rows (2048 bytes) in, 8-row groups 1024 bytes apart (SBO),
//   and the 64-column boxes 8 KB apart (LBO) when N = 128.
// Accumulator (D fragment) of m64nN, thread t of the warpgroup (warp
// w = t / 32, lane l = t % 32): element i holds row 16w + l/4 + 8((i%4)/2),
// column 8(i/4) + 2(l%4) + i%2. The bf16 A fragment of a k16 slice kk,
// {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], d[8kk+3]), pack(d[8kk+4],
// d[8kk+5]), pack(d[8kk+6], d[8kk+7])}, is that same layout, so a product
// computed into registers feeds the next product with no shuffle.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace hvdflash {

constexpr int kWgThreads = 128;      // one warpgroup
constexpr int kBoxBytes = 64 * 128;  // one 64 x 64 bf16 box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA traffic on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

// Box at coordinates (c0, c1, c2, c3) of a 4-D map into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(smem_u32(bar))
      : "memory");
}

// A 64-row tile (D / 64 boxes) of a [B, T, H, D] map: rows t0 .. t0 + 63 of
// head h of batch b.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int h, int t0,
                                              int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(dst + c * kBoxBytes, map, bar, 64 * c, h, t0, b);
}

// -- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of an accumulator above the wait
// that makes it valid (the asm statements stay in order).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// k16 slice kk of a K-major tile whose reduction axis is D / 64 boxes wide.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_b128(tile + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
}

// k16 slice kk (rows 16kk .. 16kk + 15) of an MN-major tile.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_b128(tile + kk * 2048, kBoxBytes, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 A fragments of the four k16 slices of a 64 x 64 accumulator.
__device__ __forceinline__ void to_a_frags(const float (&d)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, both
// K-major; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (the bf16 fragment
// of a k16 slice), B from shared memory MN-major (trans-b).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (the bf16 fragment
// of a k16 slice), B from shared memory MN-major (trans-b).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O (+)= A B for an accumulator of D / 2 floats (N = D), A from registers.
template <int D>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  wgmma_rs_n64_tb(d, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  wgmma_rs_n128_tb(d, a, desc_b);
}

// -- host: tensor maps -------------------------------------------------------

// 4-D map over a contiguous [B, T, H, D] bf16 tensor, box (64, 1, 64, 1),
// 128-byte swizzle; out-of-bounds rows read as zero.
inline int encode_bthd_map(CUtensorMap* map, const void* base, int B, int T,
                           int H, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult rc = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kCuResultBase + (int)rc;
}

// 1-D map over n float32 values, box 64, no swizzle (lse and delta rows).
inline int encode_f32_map(CUtensorMap* map, const void* base, long long n) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // unused at rank 1
  const cuuint32_t box[1] = {64};
  const cuuint32_t elem[1] = {1};
  CUresult rc = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kCuResultBase + (int)rc;
}

// TMA needs 16-byte-aligned bases (the wrapper checks too).
inline bool tma_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace hvdflash
