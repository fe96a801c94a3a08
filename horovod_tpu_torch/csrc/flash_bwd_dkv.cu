// K3: flash-attention backward for K and V,
// dV = sum over q tiles of P^T dO and dK = sum over q tiles of
// (P o (dP - delta))^T Q * scale, with P recomputed from the logsumexp.
//
// Replaces: horovod_tpu/ops/pallas_attention.py:_bwd_dkv_kernel (launched
// by _bwd_impl through pl.pallas_call; P as in _recompute_p).
//
// What bounds it on an H100: the products. At the LM's shape ([8, 1024, 12,
// 64] bf16, causal) it needs 25.8 GFLOP (four products per tile pair)
// against 76 MB of traffic. This first version computes them in float32 on
// the CUDA cores, far from the tensor-core bound; the wgmma redesign is
// queued in ROADMAP.md.
//
// Design: one block per (batch*head, 64-row k tile), so each block owns
// its rows of dK and dV outright: no atomics and no second pass. K and V of
// the tile stay in shared memory; Q, dO, lse and delta tiles stream through
// it. P and dS of a tile pair go to shared memory and both accumulators
// stay in float32 registers. Causal blocks skip the q tiles that lie wholly
// before their k tile (P == 0 there).
#include "flash_common.cuh"

namespace hvdflash {

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H,
                         int Tq, int Tk, int causal, int q_offset,
                         float scale) {
  constexpr int ld = tile_ld<D>();
  constexpr int CJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                   // [64][ld]
  float* Vs = Ks + kBlockN * ld;      // [64][ld]
  float* Qs = Vs + kBlockN * ld;      // [64][ld]  Q, unscaled
  float* dOs = Qs + kBlockM * ld;     // [64][ld]
  float* Ps = dOs + kBlockM * ld;     // [64 q][kLdS]
  float* dSs = Ps + kBlockM * kLdS;   // [64 q][kLdS]
  float* lse_s = dSs + kBlockM * kLdS;
  float* dl_s = lse_s + kBlockM;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBlockN;
  const size_t row_stride = (size_t)H * D;
  const size_t q_base = ((size_t)b * Tq * H + h) * D;
  const size_t k_base = ((size_t)b * Tk * H + h) * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<D>(Ks, k + k_base, k0, Tk, row_stride, 1.f);
  load_tile<D>(Vs, v + k_base, k0, Tk, row_stride, 1.f);
  // dK and dV rows k0 + ty + 16i, columns tx + 16j
  float acc_k[4][CJ], acc_v[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_q_tiles = (Tq + kBlockM - 1) / kBlockM;
  for (int qt = 0; qt < n_q_tiles; ++qt) {
    const int q0 = qt * kBlockM;
    // block-uniform: every row of this q tile lies before every k column
    if (causal && q_offset + min(q0 + kBlockM, Tq) - 1 < k0) continue;
    __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
    load_tile<D>(Qs, q + q_base, q0, Tq, row_stride, 1.f);
    load_tile<D>(dOs, dout + q_base, q0, Tq, row_stride, 1.f);
    for (int r = tid; r < kBlockM; r += kThreads) {
      const bool in = q0 + r < Tq;
      lse_s[r] = in ? lse[(size_t)bh * Tq + q0 + r] : kNegInf;
      dl_s[r] = in ? delta[(size_t)bh * Tq + q0 + r] : 0.f;
    }
    __syncthreads();

    // S = (Q * scale) K^T and dP = dO V^T: q rows ty + 16i, k columns tx + 16j
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
        a[i] = Qs[(ty + 16 * i) * ld + d] * scale;
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
        const int c = tx + 16 * j;
        float p = 0.f;
        if (lse_r > kNegInf * 0.5f) {
          const float sv =
              causal && q_offset + q0 + r < k0 + c ? kNegInf : s[i][j];
          p = expf(sv - lse_r);
        }
        Ps[r * kLdS + c] = p;
        dSs[r * kLdS + c] = p * (dp[i][j] - dl_r) * scale;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q, summed over the tile's q rows n
#pragma unroll 2
    for (int n = 0; n < kBlockM; ++n) {
      float p[4], ds[4], g[CJ], a[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[n * kLdS + ty + 16 * i];
        ds[i] = dSs[n * kLdS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        g[j] = dOs[n * ld + tx + 16 * j];
        a[j] = Qs[n * ld + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          acc_v[i][j] = fmaf(p[i], g[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(ds[i], a[j], acc_k[i][j]);
        }
    }
  }

  // k rows past the sequence were computed from zero tiles and are dropped
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= Tk) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const size_t at = k_base + (size_t)t * row_stride + tx + 16 * j;
      dk[at] = from_f32<T>(acc_k[i][j]);
      dv[at] = from_f32<T>(acc_v[i][j]);
    }
  }
}

template <int D, typename T>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv, int B,
            int H, int Tq, int Tk, int causal, int q_offset, float scale,
            cudaStream_t stream) {
  constexpr int ld = tile_ld<D>();
  const size_t smem =
      sizeof(float) * (4 * kBlockM * ld + 2 * kBlockM * kLdS + 2 * kBlockM);
  dim3 grid(B * H, (Tk + kBlockN - 1) / kBlockN);
  return launch(flash_bwd_dkv_kernel<D, T>, grid, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk,
                causal, q_offset, scale);
}

template <typename T>
int dispatch_dkv(int D, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int B, int H, int Tq, int Tk, int causal,
                 int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return run_dkv<16, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk,
                            causal, q_offset, scale, stream);
    case 32:
      return run_dkv<32, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk,
                            causal, q_offset, scale, stream);
    case 64:
      return run_dkv<64, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk,
                            causal, q_offset, scale, stream);
    case 128:
      return run_dkv<128, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk,
                             causal, q_offset, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace hvdflash

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int Tq, int Tk, int D, int dtype,
                                 int causal, int q_offset, float scale,
                                 void* stream) {
  using namespace hvdflash;
  if (B < 1 || H < 1 || !tiles_fit(Tk) || Tq < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (dtype == kF32)
    return dispatch_dkv<float>(D, q, k, v, dout, lse_f, delta_f, dk, dv, B,
                               H, Tq, Tk, causal, q_offset, scale, s);
  if (dtype == kBF16)
    return dispatch_dkv<__nv_bfloat16>(D, q, k, v, dout, lse_f, delta_f, dk,
                                       dv, B, H, Tq, Tk, causal, q_offset,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}
