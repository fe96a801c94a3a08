// K2: flash-attention backward for Q,
// dQ = sum over k tiles of (P o (dO V^T - delta)) K * scale, with
// P = exp(Q K^T * scale - lse) recomputed from the forward's logsumexp.
//
// Replaces: horovod_tpu/ops/pallas_attention.py:_bwd_dq_kernel (launched by
// _bwd_impl through pl.pallas_call; P as in _recompute_p).
//
// What bounds it on an H100: the products. At the LM's shape ([8, 1024, 12,
// 64] bf16, causal) it needs 19.3 GFLOP (three products per tile pair)
// against 64 MB of traffic. This first version computes them in float32 on
// the CUDA cores, far from the tensor-core bound; the wgmma redesign is
// queued in ROADMAP.md.
//
// Design: one block per (batch*head, 64-row q tile). Q (times scale), dO,
// lse and delta of the tile stay in shared memory; K/V tiles stream through
// it. S and dP of a tile are computed in one pass over the head dimension,
// dS = P o (dP - delta) * scale goes to shared memory, and dQ accumulates
// in float32 registers. The [T, T] matrices never reach device memory.
// Causal blocks stop at the last k tile their rows can see.
#include "flash_common.cuh"

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

}  // namespace hvdflash

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Tq, int Tk, int D, int dtype, int causal,
                                int q_offset, float scale, void* stream) {
  using namespace hvdflash;
  if (B < 1 || H < 1 || !tiles_fit(Tq) || Tk < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (dtype == kF32)
    return dispatch_dq<float>(D, q, k, v, dout, lse_f, delta_f, dq, B, H, Tq,
                              Tk, causal, q_offset, scale, s);
  if (dtype == kBF16)
    return dispatch_dq<__nv_bfloat16>(D, q, k, v, dout, lse_f, delta_f, dq,
                                      B, H, Tq, Tk, causal, q_offset, scale,
                                      s);
  return (int)cudaErrorInvalidValue;
}
