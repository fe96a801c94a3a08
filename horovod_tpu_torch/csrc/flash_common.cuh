// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu).
//
// Layout: q, k, v, o, dO and the gradients are [B, T, H, D], contiguous,
// the layout of horovod_tpu_torch.ops.flash_attention; lse and delta are
// [B*H, Tq] float32. A thread block owns one (batch*head, 64-row tile) and
// loops over the other sequence axis; that loop takes the place of the
// sequential ("arbitrary") grid axis of the Pallas kernels.
//
// The CUDA-core kernels (float32, or a bf16 head dim the tensor-core
// variant does not take) compute every product in float32 on the CUDA
// cores, from tiles staged in shared memory as float32 (bf16 inputs are
// widened on load), as the Pallas kernels widen every block with
// astype(float32): P is never rounded to bf16 before a product. The
// tensor-core variants of K1-K3 (bf16, head dim 64 or 128) build on
// hopper.cuh and say in their own notes where they round.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace hvdflash {

constexpr int kBlockM = 64;    // q rows per tile
constexpr int kBlockN = 64;    // k rows per tile (equal to kBlockM: one loader)
constexpr int kThreads = 256;  // CUDA-core kernels: a 16 x 16 thread grid
constexpr int kLdS = kBlockN + 1;  // odd row stride of score tiles in smem
// float32 finfo.min: the masked-score sentinel of the Pallas kernels
// (_NEG_INF), kept bit-identical so masked rows behave the same.
constexpr float kNegInf = -3.402823466e+38f;

enum DType { kF32 = 0, kBF16 = 1 };
// Which kernel of a library a call asks for (flash_attention.py decides).
enum Variant { kCudaCore = 0, kTensorCore = 1 };
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// A CUresult of cuTensorMapEncodeTiled (hopper.cuh) comes back as
// kCuResultBase + CUresult, apart from the cudaError_t codes.
constexpr int kCuResultBase = 100000;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as Tensor.to does
}

// Row stride of a [rows][D] float32 tile in shared memory. D + 1 is odd, so
// the 16 threads of a half-warp that read 16 different rows at one column
// hit 16 different banks.
template <int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 1;
}

// Stage rows [row0, row0 + 64) of one (batch, head) slice into
// tile[r * ld + d] as float32, times `mul`. `base` points at element
// (b, 0, h, 0); consecutive rows are `row_stride` elements apart. Rows at or
// past `len` are zero. Neighbouring threads read neighbouring d: coalesced.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* base, int row0,
                                          int len, size_t row_stride,
                                          float mul) {
  constexpr int ld = tile_ld<D>();
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = row0 + r;
    tile[r * ld + d] =
        t < len ? to_f32(base[(size_t)t * row_stride + d]) * mul : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Launch one instantiation with `threads` threads a block and `smem` bytes
// of dynamic shared memory, and report the launch's own error: a launch
// refused for its resources never runs, and a later synchronize would not
// say so.
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// grid.y carries the tile index; keep it inside CUDA's 65535 limit.
inline bool tiles_fit(int len) {
  return len > 0 && (len + kBlockM - 1) / kBlockM <= 65535;
}

}  // namespace hvdflash

// Every library exports its own copy, so the wrapper can name an error.
extern "C" const char* hvd_flash_error_string(int code) {
  if (code >= hvdflash::kCuResultBase)
    return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)code);
}
