// K3: flash-attention backward for K and V,
// dV = sum over q tiles of P^T dO and dK = sum over q tiles of
// (P o (dP - delta))^T Q * scale, with P recomputed from the logsumexp.
//
// Replaces: horovod_tpu/ops/pallas_attention.py:_bwd_dkv_kernel (launched
// by _bwd_impl through pl.pallas_call; P as in _recompute_p).
//
// Two variants; flash_attention.py picks one from (dtype, head_dim) and
// asks for it by number, and this file never falls back from one to the
// other.
//
// Tensor-core variant (flash_bwd_dkv_wgmma_kernel; bf16, head dim 64 or
// 128). What bounds it on an H100: the products. At the LM's shape ([8,
// 1024, 12, 64] bf16, causal) it needs 25.8 GFLOP (four products per tile
// pair; 26.1 us at 989 TFLOP/s) against 76 MB of traffic (22.8 us at 3.35
// TB/s). What the design does about it: all four products run as wgmma on
// the tensor cores, fed by TMA. One warpgroup owns 64 k rows, so it owns
// its rows of dK and dV outright (no atomics, no second pass). Its K and V
// tiles are loaded once; Q, dO, lse and delta tiles of successive q tiles
// stream through a two-stage ring of 128-byte-swizzled shared memory, each
// stage completing on an mbarrier, so the next q tile's loads overlap this
// one's products. Everything is computed transposed, with the k rows as
// the M dimension (the FA3 layout): S^T = K Q^T and dP^T = V dO^T with all
// operands K-major, so P^T and dS^T come out in registers already laid out
// as A operands of dV += P^T dO and dK += dS^T Q (dO and Q MN-major,
// trans-b). P and dS never touch shared memory. lse and delta are indexed
// by column (q) and staged in shared memory, 64 values of each per q tile.
// Masking touches only q tiles that cross the causal diagonal or the
// ragged end of Tq; causal blocks skip the q tiles that lie wholly before
// their k tile (P == 0 there).
// Rounding: P and dS (= P o (dP - delta) * scale, from the float32 P) are
// rounded to bf16 (round to nearest even) before P^T dO and dS^T Q, the
// only places this variant rounds besides the dK and dV stores.
//
// CUDA-core variant (flash_bwd_dkv_kernel; float32, and bf16 at head dims
// 16 and 32): every product in float32 on the CUDA cores, from tiles
// staged in padded float32 shared memory, with P and dS of a tile pair in
// shared memory and both accumulators in float32 registers.
#include "flash_common.cuh"
#include "hopper.cuh"

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
  return launch(flash_bwd_dkv_kernel<D, T>, grid, kThreads, smem, stream,
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


// -- tensor-core variant -----------------------------------------------------

constexpr int kDkvStages = 2;  // Q / dO / lse / delta ring

template <int D>
constexpr size_t dkv_tc_smem() {
  // slack to align the tiles; K, V; the ring of Q, dO tiles; the ring of
  // lse, delta rows (64 floats each); 3 barriers
  return 1024 + (size_t)(2 + 2 * kDkvStages) * 64 * D * 2 +
         kDkvStages * 2 * 64 * 4 + 64;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ CUtensorMap lse_map,
                               const __grid_constant__ CUtensorMap delta_map,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int Tq,
                               int Tk, int causal, int q_offset, float scale) {
  constexpr int kTile = 64 * D * 2;  // bytes of one 64-row tile
  constexpr int kAcc = D / 2;        // dK (and dV) floats per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + kTile;
  uint8_t* Qs = Vs + kTile;                 // [kDkvStages] tiles
  uint8_t* dOs = Qs + kDkvStages * kTile;   // [kDkvStages] tiles
  float* lse_s = reinterpret_cast<float*>(dOs + kDkvStages * kTile);
  float* dl_s = lse_s + kDkvStages * 64;    // [kDkvStages][64] each
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl_s + kDkvStages * 64);
  uint64_t* kv_bar = bars;     // K and V, once
  uint64_t* q_bar = bars + 1;  // [kDkvStages]: Q, dO, lse, delta of a q tile

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * 64;  // the first k tiles see the most q tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // k rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);        // q columns 8j + col0 + {0, 1}

  // visibility is monotone in the q tile: the visible ones are a suffix
  const int n_q = (Tq + 63) / 64;
  int qt_begin = 0;
  if (causal) {
    qt_begin = k0 > q_offset ? min(n_q, (k0 - q_offset) / 64) : 0;
    if (q_offset + Tq - 1 < k0) qt_begin = n_q;
  }

  auto load_q = [&](int stage, int qt) {
    uint64_t* bar = &q_bar[stage];
    mbar_expect_tx(bar, 2 * kTile + 2 * 64 * 4);
    tma_load_tile<D>(Qs + stage * kTile, &q_map, bar, h, qt * 64, b);
    tma_load_tile<D>(dOs + stage * kTile, &do_map, bar, h, qt * 64, b);
    // rows of [B*H, Tq]; a ragged tile reads the next row's head, which
    // the column mask below ignores (and zeros past the end)
    tma_load_1d(lse_s + stage * 64, &lse_map, bar, bh * Tq + qt * 64);
    tma_load_1d(dl_s + stage * 64, &delta_map, bar, bh * Tq + qt * 64);
  };
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kDkvStages; ++s) mbar_init(&q_bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * kTile);
    tma_load_tile<D>(Ks, &k_map, kv_bar, h, k0, b);
    tma_load_tile<D>(Vs, &v_map, kv_bar, h, k0, b);
    for (int s = 0; s < kDkvStages && qt_begin + s < n_q; ++s)
      load_q(s, qt_begin + s);
  }

  float acc_dk[kAcc], acc_dv[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_tile = smem_u32(Ks), v_tile = smem_u32(Vs);
  mbar_wait(kv_bar, 0);

  for (int qt = qt_begin, it = 0; qt < n_q; ++qt, ++it) {
    const int stage = it % kDkvStages, q0 = qt * 64;
    mbar_wait(&q_bar[stage], (it / kDkvStages) & 1);
    const uint32_t q_tile = smem_u32(Qs + stage * kTile);
    const uint32_t do_tile = smem_u32(dOs + stage * kTile);

    // S^T = K Q^T and dP^T = V dO^T (64 k rows x 64 q columns)
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, desc_kmajor(k_tile, kk), desc_kmajor(q_tile, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, desc_kmajor(v_tile, kk), desc_kmajor(do_tile, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(S^T * scale - lse) and dS^T = P^T o (dP^T - delta) * scale,
    // in place; P is 0 where lse <= finfo.min / 2, in the causal future and
    // past Tq (edge tiles only)
    const float* lse_t = lse_s + stage * 64;
    const float* dl_t = dl_s + stage * 64;
    const bool edge = q0 + 64 > Tq || (causal && q_offset + q0 < k0 + 63);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + col0);
      const float2 dl2 = *reinterpret_cast<const float2*>(dl_t + 8 * j + col0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lse_c = e ? lse2.y : lse2.x, dl_c = e ? dl2.y : dl2.x;
        const bool live = lse_c > kNegInf * 0.5f;
        const float lse_log2 = live ? lse_c * kLog2e : 0.f;
        const int qc = q0 + 8 * j + col0 + e;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr + e;
          float p = live ? exp2f(st[i] * scale_log2 - lse_log2) : 0.f;
          if (edge && (qc >= Tq ||
                       (causal && q_offset + qc < k0 + row0 + 8 * rr)))
            p = 0.f;
          dpt[i] = p * (dpt[i] - dl_c) * scale;
          st[i] = p;
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 as the
    // register A operands, dO and Q MN-major
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(st, pa);
    to_a_frags(dpt, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<D>(acc_dv, pa[kk], desc_mnmajor(do_tile, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb<D>(acc_dk, dsa[kk], desc_mnmajor(q_tile, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dv);
    fence_regs(acc_dk);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && qt + kDkvStages < n_q) load_q(stage, qt + kDkvStages);
  }

  // k rows past the sequence were computed from zero rows and are dropped
  const size_t row_stride = (size_t)H * D;
  const size_t k_base = ((size_t)b * Tk * H + h) * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = k0 + row0 + 8 * rr;
    if (t >= Tk) continue;
    const size_t at = k_base + (size_t)t * row_stride + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(acc_dk[4 * j + 2 * rr],
                                acc_dk[4 * j + 2 * rr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(acc_dv[4 * j + 2 * rr],
                                acc_dv[4 * j + 2 * rr + 1]);
    }
  }
}

template <int D>
int run_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Tq, int Tk, int causal, int q_offset,
               float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map, lse_map, delta_map;
  const long long rows = (long long)B * H * Tq;
  int rc = encode_bthd_map(&q_map, q, B, Tq, H, D);
  if (rc == 0) rc = encode_bthd_map(&k_map, k, B, Tk, H, D);
  if (rc == 0) rc = encode_bthd_map(&v_map, v, B, Tk, H, D);
  if (rc == 0) rc = encode_bthd_map(&do_map, dout, B, Tq, H, D);
  if (rc == 0) rc = encode_f32_map(&lse_map, lse, rows);
  if (rc == 0) rc = encode_f32_map(&delta_map, delta, rows);
  if (rc != 0) return rc;
  dim3 grid(B * H, (Tk + 63) / 64);
  return launch(flash_bwd_dkv_wgmma_kernel<D>, grid, kWgThreads,
                dkv_tc_smem<D>(), stream, q_map, k_map, v_map, do_map,
                lse_map, delta_map, static_cast<__nv_bfloat16*>(dk),
                static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, causal, q_offset,
                scale);
}

}  // namespace hvdflash

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int Tq, int Tk, int D, int dtype,
                                 int causal, int q_offset, float scale,
                                 int variant, void* stream) {
  using namespace hvdflash;
  if (B < 1 || H < 1 || !tiles_fit(Tk) || Tq < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (variant == kTensorCore) {
    // the wrapper asks for this variant only where it applies; anything
    // else is an error, never a silent switch to the other kernel
    if (dtype != kBF16 || !tma_aligned(q) || !tma_aligned(k) ||
        !tma_aligned(v) || !tma_aligned(dout) || !tma_aligned(lse) ||
        !tma_aligned(delta))
      return (int)cudaErrorInvalidValue;
    if (D == 64)
      return run_dkv_tc<64>(q, k, v, dout, lse_f, delta_f, dk, dv, B, H, Tq,
                            Tk, causal, q_offset, scale, s);
    if (D == 128)
      return run_dkv_tc<128>(q, k, v, dout, lse_f, delta_f, dk, dv, B, H,
                             Tq, Tk, causal, q_offset, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != kCudaCore) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return dispatch_dkv<float>(D, q, k, v, dout, lse_f, delta_f, dk, dv, B,
                               H, Tq, Tk, causal, q_offset, scale, s);
  if (dtype == kBF16)
    return dispatch_dkv<__nv_bfloat16>(D, q, k, v, dout, lse_f, delta_f, dk,
                                       dv, B, H, Tq, Tk, causal, q_offset,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}
