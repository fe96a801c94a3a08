// K2: flash-attention backward for Q,
// dQ = sum over k tiles of (P o (dO V^T - delta)) K * scale, with
// P = exp(Q K^T * scale - lse) recomputed from the forward's logsumexp.
//
// Replaces: horovod_tpu/ops/pallas_attention.py:_bwd_dq_kernel (launched by
// _bwd_impl through pl.pallas_call; P as in _recompute_p).
//
// Two variants; flash_attention.py picks one from (dtype, head_dim) and
// asks for it by number, and this file never falls back from one to the
// other.
//
// Tensor-core variant (flash_bwd_dq_wgmma_kernel; bf16, head dim 64 or
// 128). What bounds it on an H100: the products, narrowly. At the LM's
// shape ([8, 1024, 12, 64] bf16, causal) it needs 19.3 GFLOP (three
// products per tile pair; 19.6 us at 989 TFLOP/s) against 63.7 MB of
// traffic (19.0 us at 3.35 TB/s). What the design does about it: all three
// products run as wgmma on the tensor cores, fed by TMA; it is K1's
// tensor-core kernel plus one product. One warpgroup owns 64 q rows, so it
// owns its rows of dQ outright. Its Q and dO tiles are loaded once; K and V
// tiles of successive k tiles stream through a two-stage ring of
// 128-byte-swizzled shared memory, each stage completing on an mbarrier,
// so the next tile's loads overlap this tile's products. S = Q K^T and
// dP = dO V^T (all operands K-major) go out in one commit group; P and
// dS = P o (dP - delta) * scale stay in registers, and dS is the register
// A operand of dQ += dS K, with the same K tile read MN-major (trans-b), as
// V is in K1's O += P V. lse and delta of this thread's two rows are read
// once per block. Masking touches only the tiles that cross the causal
// diagonal or the ragged end of Tk; causal blocks stop at the last visible
// k tile, and the grid runs the heaviest q tiles (the last) first.
// Rounding: dS (from the float32 P) is rounded to bf16 (round to nearest
// even) before dS K, the only place this variant rounds besides dQ's
// store.
//
// CUDA-core variant (flash_bwd_dq_kernel; float32, and bf16 at head dims
// 16 and 32): one block per (batch*head, 64-row q tile). Q (times scale),
// dO, lse and delta of the tile stay in shared memory as float32; K/V tiles
// stream through it. S and dP of a tile are computed in one pass over the
// head dimension on the CUDA cores, dS goes to shared memory, and dQ
// accumulates in float32 registers. The [T, T] matrices never reach device
// memory in either variant.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace hvdflash {

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Tq, int Tk, int causal, int q_offset,
                        float scale) {
  constexpr int ld = tile_ld<D>();
  constexpr int CJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                   // [64][ld]  Q * scale
  float* dOs = Qs + kBlockM * ld;     // [64][ld]
  float* Ks = dOs + kBlockM * ld;     // [64][ld]
  float* Vs = Ks + kBlockN * ld;      // [64][ld]
  float* dSs = Vs + kBlockN * ld;     // [64][kLdS]
  float* lse_s = dSs + kBlockM * kLdS;
  float* dl_s = lse_s + kBlockM;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBlockM;
  const size_t row_stride = (size_t)H * D;
  const size_t q_base = ((size_t)b * Tq * H + h) * D;
  const size_t k_base = ((size_t)b * Tk * H + h) * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<D>(Qs, q + q_base, q0, Tq, row_stride, scale);
  load_tile<D>(dOs, dout + q_base, q0, Tq, row_stride, 1.f);
  for (int r = tid; r < kBlockM; r += kThreads) {
    const bool in = q0 + r < Tq;
    // rows past the sequence take the masked-row sentinel: P = 0 there
    lse_s[r] = in ? lse[(size_t)bh * Tq + q0 + r] : kNegInf;
    dl_s[r] = in ? delta[(size_t)bh * Tq + q0 + r] : 0.f;
  }
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  int end = (Tk + kBlockN - 1) / kBlockN;
  if (causal) end = min(end, (q_offset + q0 + kBlockM - 1) / kBlockN + 1);

  for (int kt = 0; kt < end; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();
    load_tile<D>(Ks, k + k_base, k0, Tk, row_stride, 1.f);
    load_tile<D>(Vs, v + k_base, k0, Tk, row_stride, 1.f);
    __syncthreads();

    // S = (Q * scale) K^T and dP = dO V^T: rows ty + 16i, columns tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * ld + d];
        g[i] = dOs[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Ks[(tx + 16 * j) * ld + d];
        bv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float lse_r = lse_s[r], dl_r = dl_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        float p = 0.f;
        if (kpos < Tk && lse_r > kNegInf * 0.5f) {
          const float sv =
              causal && q_offset + q0 + r < kpos ? kNegInf : s[i][j];
          p = expf(sv - lse_r);
        }
        dSs[r * kLdS + c] = p * (dp[i][j] - dl_r) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      float ds[4], bk[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * kLdS + n];
#pragma unroll
      for (int j = 0; j < CJ; ++j) bk[j] = Ks[n * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(ds[i], bk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      dq[q_base + (size_t)t * row_stride + tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

template <int D, typename T>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Tq, int Tk, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int ld = tile_ld<D>();
  const size_t smem =
      sizeof(float) * (4 * kBlockM * ld + kBlockM * kLdS + 2 * kBlockM);
  dim3 grid(B * H, (Tq + kBlockM - 1) / kBlockM);
  return launch(flash_bwd_dq_kernel<D, T>, grid, kThreads, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dq), H, Tq, Tk, causal, q_offset,
                scale);
}

template <typename T>
int dispatch_dq(int D, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, int B, int H, int Tq, int Tk, int causal,
                int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return run_dq<16, T>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk,
                           causal, q_offset, scale, stream);
    case 32:
      return run_dq<32, T>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk,
                           causal, q_offset, scale, stream);
    case 64:
      return run_dq<64, T>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk,
                           causal, q_offset, scale, stream);
    case 128:
      return run_dq<128, T>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk,
                            causal, q_offset, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// -- tensor-core variant -----------------------------------------------------

constexpr int kDqStages = 2;  // K/V ring

template <int D>
constexpr size_t dq_tc_smem() {
  // 1024 bytes of slack to align the tiles, Q, dO, the K/V ring, 3 barriers
  return 1024 + (size_t)(2 + 2 * kDqStages) * 64 * D * 2 + 64;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int H, int Tq,
                              int Tk, int causal, int q_offset, float scale) {
  constexpr int kTile = 64 * D * 2;  // bytes of one 64-row tile
  constexpr int kAcc = D / 2;        // dQ accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* dOs = Qs + kTile;
  uint8_t* Ks = dOs + kTile;             // [kDqStages] tiles
  uint8_t* Vs = Ks + kDqStages * kTile;  // [kDqStages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kDqStages * kTile);
  uint64_t* q_bar = bars;       // Q and dO, once
  uint64_t* kv_bar = bars + 1;  // [kDqStages]: K and V of one k tile

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // the last q tiles see the most k tiles under causal masking: run first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);        // columns 8j + col0 + {0, 1}

  int n_k = (Tk + 63) / 64;
  if (causal) n_k = min(n_k, (q_offset + q0 + 63) / 64 + 1);

  auto load_kv = [&](int stage, int kt) {
    mbar_expect_tx(&kv_bar[stage], 2 * kTile);
    tma_load_tile<D>(Ks + stage * kTile, &k_map, &kv_bar[stage], h, kt * 64,
                     b);
    tma_load_tile<D>(Vs + stage * kTile, &v_map, &kv_bar[stage], h, kt * 64,
                     b);
  };
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kDqStages; ++s) mbar_init(&kv_bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, 2 * kTile);
    tma_load_tile<D>(Qs, &q_map, q_bar, h, q0, b);
    tma_load_tile<D>(dOs, &do_map, q_bar, h, q0, b);
    for (int s = 0; s < kDqStages && s < n_k; ++s) load_kv(s, s);
  }

  // lse and delta of this thread's two rows; rows past Tq (zero-filled by
  // TMA) take the masked-row sentinel, so their P is 0
  float lse_log2[2], dl_r[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row0 + 8 * r;
    const float l = t < Tq ? lse[(size_t)bh * Tq + t] : kNegInf;
    live[r] = l > kNegInf * 0.5f;
    lse_log2[r] = live[r] ? l * kLog2e : 0.f;
    dl_r[r] = t < Tq ? delta[(size_t)bh * Tq + t] : 0.f;
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_tile = smem_u32(Qs), do_tile = smem_u32(dOs);
  mbar_wait(q_bar, 0);

  for (int kt = 0; kt < n_k; ++kt) {
    const int stage = kt % kDqStages, k0 = kt * 64;
    mbar_wait(&kv_bar[stage], (kt / kDqStages) & 1);
    const uint32_t k_tile = smem_u32(Ks + stage * kTile);
    const uint32_t v_tile = smem_u32(Vs + stage * kTile);

    // S = Q K^T and dP = dO V^T (64 x 64 each), float32 accumulate
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(q_tile, kk), desc_kmajor(k_tile, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(do_tile, kk), desc_kmajor(v_tile, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S * scale - lse) and dS = P o (dP - delta) * scale, in place
    // in dp; P is 0 where lse <= finfo.min / 2, in the causal future (the
    // sentinel's exp) and past Tk (-inf's), edge tiles only for the last two
    const bool edge = k0 + 64 > Tk || (causal && k0 + 63 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i % 4) / 2;
      float p = live[r] ? exp2f(s[i] * scale_log2 - lse_log2[r]) : 0.f;
      if (edge) {
        const int c = k0 + 8 * (i / 4) + col0 + (i % 2);
        if (c >= Tk || (causal && q_offset + q0 + row0 + 8 * r < c)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dl_r[r]) * scale;
    }

    // dQ += dS K: dS rounded to bf16 as the register A operand, K MN-major
    uint32_t dsa[4][4];
    to_a_frags(dp, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<D>(acc, dsa[kk], desc_mnmajor(k_tile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && kt + kDqStages < n_k) load_kv(stage, kt + kDqStages);
  }

  // rows past the sequence were computed from zero rows and are dropped
  const size_t row_stride = (size_t)H * D;
  __nv_bfloat16* dq_base = dq + ((size_t)b * Tq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row0 + 8 * r;
    if (t >= Tq) continue;
    __nv_bfloat16* row = dq_base + (size_t)t * row_stride + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int D>
int run_dq_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Tq, int Tk, int causal, int q_offset, float scale,
              cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  int rc = encode_bthd_map(&q_map, q, B, Tq, H, D);
  if (rc == 0) rc = encode_bthd_map(&k_map, k, B, Tk, H, D);
  if (rc == 0) rc = encode_bthd_map(&v_map, v, B, Tk, H, D);
  if (rc == 0) rc = encode_bthd_map(&do_map, dout, B, Tq, H, D);
  if (rc != 0) return rc;
  dim3 grid(B * H, (Tq + 63) / 64);
  return launch(flash_bwd_dq_wgmma_kernel<D>, grid, kWgThreads,
                dq_tc_smem<D>(), stream, q_map, k_map, v_map, do_map, lse,
                delta, static_cast<__nv_bfloat16*>(dq), H, Tq, Tk, causal,
                q_offset, scale);
}

}  // namespace hvdflash

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Tq, int Tk, int D, int dtype, int causal,
                                int q_offset, float scale, int variant,
                                void* stream) {
  using namespace hvdflash;
  if (B < 1 || H < 1 || !tiles_fit(Tq) || Tk < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (variant == kTensorCore) {
    // the wrapper asks for this variant only where it applies; anything
    // else is an error, never a silent switch to the other kernel
    if (dtype != kBF16 || !tma_aligned(q) || !tma_aligned(k) ||
        !tma_aligned(v) || !tma_aligned(dout))
      return (int)cudaErrorInvalidValue;
    if (D == 64)
      return run_dq_tc<64>(q, k, v, dout, lse_f, delta_f, dq, B, H, Tq, Tk,
                           causal, q_offset, scale, s);
    if (D == 128)
      return run_dq_tc<128>(q, k, v, dout, lse_f, delta_f, dq, B, H, Tq, Tk,
                            causal, q_offset, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != kCudaCore) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return dispatch_dq<float>(D, q, k, v, dout, lse_f, delta_f, dq, B, H, Tq,
                              Tk, causal, q_offset, scale, s);
  if (dtype == kBF16)
    return dispatch_dq<__nv_bfloat16>(D, q, k, v, dout, lse_f, delta_f, dq,
                                      B, H, Tq, Tk, causal, q_offset, scale,
                                      s);
  return (int)cudaErrorInvalidValue;
}
