// K1: flash-attention forward, O = softmax(Q K^T * scale) V plus the per-row
// logsumexp that the backward kernels recompute P from.
//
// Replaces: horovod_tpu/ops/pallas_attention.py:_fwd_kernel (launched by
// _fwd_impl through pl.pallas_call).
//
// Two variants; flash_attention.py picks one from (dtype, head_dim) and
// asks for it by number, and this file never falls back from one to the
// other.
//
// Tensor-core variant (flash_fwd_wgmma_kernel; bf16, head dim 64 or 128).
// What bounds it on an H100: at the LM's shape ([8, 1024, 12, 64] bf16,
// causal) it needs 12.9 GFLOP of bf16 products (13.0 us at 989 TFLOP/s)
// and 50.7 MB of traffic (15.1 us at 3.35 TB/s), so the bound is bytes,
// narrowly, and both limits matter. What the design does about it: the
// products run as wgmma on the tensor cores (m64n64k16 for S, m64nDk16 for
// P V), fed by TMA. One warpgroup owns 64 q rows; its Q tile is loaded
// once, and K/V tiles stream through a two-stage ring of 128-byte-swizzled
// shared memory, each stage completing on an mbarrier, so the next tile's
// load overlaps this tile's products. Q, K and V are each read once per q
// tile and O and lse written once; S and P never leave registers (the FA3
// layout: S = Q K^T with Q and K K-major; O += P V with P as the register
// A operand and V MN-major with trans-b). The online softmax runs in the
// log2 domain (exp2f of S * scale * log2(e)); masking touches only the
// tiles that cross the causal diagonal or the ragged end of Tk. Causal
// blocks stop at the last visible k tile, and the grid runs the heaviest q
// tiles (the last) first.
// Rounding: P is rounded to bf16 (round to nearest even) before P V, the
// only place this variant rounds besides O's store. The row sum l is taken
// from the float32 P, so lse keeps float32 accuracy.
//
// CUDA-core variant (flash_fwd_kernel; float32, and bf16 at head dims 16 and
// 32): every product in float32 on the CUDA cores (67 TFLOP/s peak), from
// tiles staged in padded float32 shared memory. One block per (batch*head,
// 64-row q tile) stages its Q tile (times scale) once, then streams K/V
// tiles, keeping the running max m, denominator l and a float32 output
// accumulator in registers.
#include "flash_common.cuh"
#include "hopper.cuh"

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
  return launch(flash_fwd_kernel<D, T>, grid, kThreads, smem, stream,
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


// -- tensor-core variant -----------------------------------------------------

constexpr int kFwdStages = 2;  // K/V ring

template <int D>
constexpr size_t fwd_tc_smem() {
  // 1024 bytes of slack to align the tiles, Q, the K/V ring, 3 barriers
  return 1024 + (size_t)(1 + 2 * kFwdStages) * 64 * D * 2 + 64;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int Tq, int Tk,
                           int causal, int q_offset, float scale_log2) {
  constexpr int kTile = 64 * D * 2;  // bytes of one 64-row tile
  constexpr int kAcc = D / 2;        // O accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + kTile;               // [kFwdStages] tiles
  uint8_t* Vs = Ks + kFwdStages * kTile;  // [kFwdStages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kFwdStages * kTile);
  uint64_t* q_bar = bars;       // Q, once
  uint64_t* kv_bar = bars + 1;  // [kFwdStages]: K and V of one k tile

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
    for (int s = 0; s < kFwdStages; ++s) mbar_init(&kv_bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, kTile);
    tma_load_tile<D>(Qs, &q_map, q_bar, h, q0, b);
    for (int s = 0; s < kFwdStages && s < n_k; ++s) load_kv(s, s);
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // running max, log2 domain
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
  const uint32_t q_tile = smem_u32(Qs);
  mbar_wait(q_bar, 0);

  for (int kt = 0; kt < n_k; ++kt) {
    const int stage = kt % kFwdStages, k0 = kt * 64;
    mbar_wait(&kv_bar[stage], (kt / kFwdStages) & 1);
    const uint32_t k_tile = smem_u32(Ks + stage * kTile);
    const uint32_t v_tile = smem_u32(Vs + stage * kTile);

    // S = Q K^T (64 x 64), float32 accumulate
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(q_tile, kk), desc_kmajor(k_tile, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale into the log2 domain; mask only the edge tiles: columns past
    // Tk are no column at all (-inf), the causal future takes the Pallas
    // kernels' finfo.min sentinel
    const bool edge = k0 + 64 > Tk || (causal && k0 + 63 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int r = row0 + 8 * ((i % 4) / 2);
        const int c = k0 + 8 * (i / 4) + col0 + (i % 2);
        if (c >= Tk)
          x = -INFINITY;
        else if (causal && q_offset + q0 + r < c)
          x = kNegInf;
      }
      s[i] = x;
    }

    // online softmax; a row's four values per 8 columns sit in 4 lanes
    float m_new[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      m_new[(i % 4) / 2] = fmaxf(m_new[(i % 4) / 2], s[i]);
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      corr[r] = m_r[r] == kNegInf ? 0.f : exp2f(m_r[r] - m_new[r]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i % 4) / 2;
      float p = exp2f(s[i] - m_new[r]);
      if (causal && m_new[r] == kNegInf) p = 0.f;
      s[i] = p;
      psum[r] += p;  // l from the float32 P
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] = l_r[r] * corr[r] + psum[r];
      m_r[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= corr[(i % 4) / 2];

    // O += P V: P rounded to bf16 as the register A operand, V MN-major
    uint32_t pa[4][4];
    to_a_frags(s, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<D>(acc, pa[kk], desc_mnmajor(v_tile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && kt + kFwdStages < n_k) load_kv(stage, kt + kFwdStages);
  }

  const size_t row_stride = (size_t)H * D;
  __nv_bfloat16* o_base = o + ((size_t)b * Tq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    const int t = q0 + row0 + 8 * r;
    if (t >= Tq) continue;
    __nv_bfloat16* row = o_base + (size_t)t * row_stride + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / l_safe, acc[4 * j + 2 * r + 1] / l_safe);
    // a row that saw only the sentinel keeps it, as m + log(1e-30) does
    if (lane % 4 == 0)
      lse[(size_t)bh * Tq + t] =
          (m_r[r] == kNegInf ? kNegInf : m_r[r] * kLn2) + logf(l_safe);
  }
}

template <int D>
int run_fwd_tc(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Tq, int Tk, int causal,
               int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int rc = encode_bthd_map(&q_map, q, B, Tq, H, D);
  if (rc == 0) rc = encode_bthd_map(&k_map, k, B, Tk, H, D);
  if (rc == 0) rc = encode_bthd_map(&v_map, v, B, Tk, H, D);
  if (rc != 0) return rc;
  dim3 grid(B * H, (Tq + 63) / 64);
  return launch(flash_fwd_wgmma_kernel<D>, grid, kWgThreads, fwd_tc_smem<D>(),
                stream, q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o),
                lse, H, Tq, Tk, causal, q_offset, scale * kLog2e);
}

}  // namespace hvdflash

extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Tq, int Tk,
                             int D, int dtype, int causal, int q_offset,
                             float scale, int variant, void* stream) {
  using namespace hvdflash;
  if (B < 1 || H < 1 || !tiles_fit(Tq) || Tk < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (variant == kTensorCore) {
    // the wrapper asks for this variant only where it applies; anything
    // else is an error, never a silent switch to the other kernel
    if (dtype != kBF16 || !tma_aligned(q) || !tma_aligned(k) ||
        !tma_aligned(v))
      return (int)cudaErrorInvalidValue;
    if (D == 64)
      return run_fwd_tc<64>(q, k, v, o, lse_f, B, H, Tq, Tk, causal,
                            q_offset, scale, s);
    if (D == 128)
      return run_fwd_tc<128>(q, k, v, o, lse_f, B, H, Tq, Tk, causal,
                             q_offset, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != kCudaCore) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return dispatch_fwd<float>(D, q, k, v, o, lse_f, B, H, Tq, Tk, causal,
                               q_offset, scale, s);
  if (dtype == kBF16)
    return dispatch_fwd<__nv_bfloat16>(D, q, k, v, o, lse_f, B, H, Tq, Tk,
                                       causal, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
