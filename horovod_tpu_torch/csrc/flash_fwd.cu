// K1: flash-attention forward, O = softmax(Q K^T * scale) V plus the per-row
// logsumexp that the backward kernels recompute P from.
//
// Replaces: horovod_tpu/ops/pallas_attention.py:_fwd_kernel (launched by
// _fwd_impl through pl.pallas_call).
//
// What bounds it on an H100: the products. At the LM's shape ([8, 1024, 12,
// 64] bf16, causal) the kernel needs 12.9 GFLOP against 50 MB of traffic,
// so even at the bf16 tensor-core rate it is bound by operations. This
// first version computes every product in float32 on the CUDA cores (67
// TFLOP/s peak), so it is far from that bound; the tensor-core (wgmma)
// redesign is queued in ROADMAP.md.
//
// Design: one block per (batch*head, 64-row q tile). The block stages its
// Q tile (times scale) once, then streams 64-row K/V tiles through shared
// memory, keeping a running row max m, denominator l and a float32 output
// accumulator in registers: the [T, T] score matrix never reaches device
// memory, and K/V are read once per q tile. Causal blocks stop at the last
// k tile that any of their rows can see, halving causal work.
#include "flash_common.cuh"

namespace hvdflash {

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int Tk,
                     int causal, int q_offset, float scale) {
  constexpr int ld = tile_ld<D>();
  constexpr int CJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [64][ld]  Q * scale
  float* Ks = Qs + kBlockM * ld;     // [64][ld]
  float* Vs = Ks + kBlockN * ld;     // [64][ld]
  float* Ss = Vs + kBlockN * ld;     // [64][kLdS] scores, then probabilities
  float* m_s = Ss + kBlockM * kLdS;  // running row max
  float* l_s = m_s + kBlockM;        // running row denominator
  float* c_s = l_s + kBlockM;        // this tile's rescale factor per row

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBlockM;
  const size_t row_stride = (size_t)H * D;
  const size_t q_base = ((size_t)b * Tq * H + h) * D;
  const size_t k_base = ((size_t)b * Tk * H + h) * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  load_tile<D>(Qs, q + q_base, q0, Tq, row_stride, scale);
  for (int r = tid; r < kBlockM; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
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
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<D>(Ks, k + k_base, k0, Tk, row_stride, 1.f);
    load_tile<D>(Vs, v + k_base, k0, Tk, row_stride, 1.f);
    __syncthreads();

    // S = (Q * scale) K^T: rows ty + 16i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        float val = s[i][j];
        if (kpos >= Tk)
          val = -INFINITY;  // past the sequence: no column at all
        else if (causal && q_offset + q0 + r < kpos)
          val = kNegInf;  // the future, masked as _causal_mask does
        Ss[r * kLdS + c] = val;
      }
    }
    __syncthreads();

    // online softmax; warp w owns rows 8w .. 8w + 7, two columns per lane
    for (int rr = 0; rr < kBlockM / 8; ++rr) {
      const int r = warp * (kBlockM / 8) + rr;
      const float x0 = Ss[r * kLdS + lane], x1 = Ss[r * kLdS + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float corr = m_old == kNegInf ? 0.f : expf(m_old - m_new);
      float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      if (causal && m_new == kNegInf) p0 = p1 = 0.f;
      Ss[r * kLdS + lane] = p0;
      Ss[r * kLdS + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: rows ty + 16i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      float p[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * kLdS + n];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = Vs[n * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // the last tile's m and l are final

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t >= Tq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      o[q_base + (size_t)t * row_stride + tx + 16 * j] =
          from_f32<T>(acc[i][j] / l);
  }
  // fully masked rows keep the sentinel: m + log(1e-30) saturates at it
  for (int r = tid; r < kBlockM; r += kThreads)
    if (q0 + r < Tq)
      lse[(size_t)bh * Tq + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

template <int D, typename T>
int run_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int H, int Tq, int Tk, int causal, int q_offset,
            float scale, cudaStream_t stream) {
  constexpr int ld = tile_ld<D>();
  const size_t smem =
      sizeof(float) * (3 * kBlockM * ld + kBlockM * kLdS + 3 * kBlockM);
  dim3 grid(B * H, (Tq + kBlockM - 1) / kBlockM);
  return launch(flash_fwd_kernel<D, T>, grid, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), lse, H, Tq, Tk,
                causal, q_offset, scale);
}

template <typename T>
int dispatch_fwd(int D, const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int Tq, int Tk, int causal,
                 int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return run_fwd<16, T>(q, k, v, o, lse, B, H, Tq, Tk, causal, q_offset,
                            scale, stream);
    case 32:
      return run_fwd<32, T>(q, k, v, o, lse, B, H, Tq, Tk, causal, q_offset,
                            scale, stream);
    case 64:
      return run_fwd<64, T>(q, k, v, o, lse, B, H, Tq, Tk, causal, q_offset,
                            scale, stream);
    case 128:
      return run_fwd<128, T>(q, k, v, o, lse, B, H, Tq, Tk, causal, q_offset,
                             scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace hvdflash

extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Tq, int Tk,
                             int D, int dtype, int causal, int q_offset,
                             float scale, void* stream) {
  using namespace hvdflash;
  if (B < 1 || H < 1 || !tiles_fit(Tq) || Tk < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == kF32)
    return dispatch_fwd<float>(D, q, k, v, o, lse_f, B, H, Tq, Tk, causal,
                               q_offset, scale, s);
  if (dtype == kBF16)
    return dispatch_fwd<__nv_bfloat16>(D, q, k, v, o, lse_f, B, H, Tq, Tk,
                                       causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
