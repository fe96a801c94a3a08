"""Flash attention (forward + FlashAttention-2 backward) for the port.

Port of ``horovod_tpu/ops/pallas_attention.py``. The public function keeps
the JAX package's signature, layout ``[batch, seq, heads, head_dim]`` and
checks: default scale ``1/sqrt(D)``, blocks shrink to the sequence,
sequence lengths must be multiples of the blocks, and ``q_offset`` is a
non-negative multiple of ``block_q``. It has no ``interpret`` argument:
the device of the tensors picks kernel or plain version. The forward
returns O in the input dtype and the per-row logsumexp in float32,
``[B*H, Tq]``, as ``_fwd_impl`` does.

Three kernels, each hand-written CUDA C++ for ``sm_90a`` under ``csrc/``:

====  =================  ==========================================
K1    ``flash_fwd``      ``pallas_attention.py:_fwd_kernel``
K2    ``flash_bwd_dq``   ``pallas_attention.py:_bwd_dq_kernel``
K3    ``flash_bwd_dkv``  ``pallas_attention.py:_bwd_dkv_kernel``
====  =================  ==========================================

Each kernel has two variants, and ``kernel_variant(name, dtype,
head_dim)`` alone picks one:

- ``"tensor-core wgmma+tma"`` for bfloat16 at head_dim 64 or 128
  (``flash_fwd_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``,
  ``flash_bwd_dkv_wgmma_kernel``): wgmma products fed by TMA through an
  mbarrier ring. P (K1, K3) and dS (K2, K3) are rounded to bf16 before the
  products that take them, so the outputs' tolerance against the plain
  versions is wider (``TC_TOL``);
- ``"cuda-core f32"`` for everything else (float32 at any head_dim, bf16
  at 16 and 32): every product in float32 on the CUDA cores, P never
  rounded, as in the first port.

The wrapper asks its library for the chosen variant by number. If that
kernel cannot build or launch, the wrapper raises; it never retries on
the other variant. The tensor-core variant also needs 16-byte-aligned
tensors for TMA, and the wrapper raises on any that are not.

Each wrapper launches its kernel for CUDA tensors (or raises) and counts
the launch in its ``launches`` attribute, and its tensor-core launches in
``tc_launches`` too. For CPU tensors it runs the kernel's plain PyTorch
version instead: a blockwise loop with the Pallas kernel's own tiling
(``block_q``/``block_k``), masking and sentinels, which the CPU tests
hold against the JAX kernel in interpret mode. The CUDA
kernels tile by 64 rows whatever the blocks are; tiles that differ only in
how a sum is split agree to float32 rounding. delta = rowsum(dO * O) is a
torch op outside the kernels, as the JAX package computes it outside its
kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_NEG_INF = float(torch.finfo(torch.float32).min)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)

CUDA_CORE = "cuda-core f32"
TENSOR_CORE = "tensor-core wgmma+tma"
_VARIANT_CODES = {CUDA_CORE: 0, TENSOR_CORE: 1}  # csrc/flash_common.cuh
_TC_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_TC_HEAD_DIMS = (64, 128)  # one or two 128-byte swizzle atoms a row
# bf16 outputs of the tensor-core variant against the plain versions
# (rtol, atol). rtol: two bf16 ulps, as for the CUDA-core kernels (both
# sides round their float32 sums to bf16 once). atol: P (and dS) round to
# bf16 before their product, a relative error of at most 2**-9 per term,
# so an output moves by at most 2**-9 * sum |terms|. With unit-scale
# inputs and T <= 1024 that sum stays below 8: for O a P-weighted mean of
# |V| (at most max |V|, about 5), for dV and dK a column sum of P (about
# ln T + 1) times a unit |dO| or |Q| * scale; hence 2**-9 * 8 = 2**-6.
# K2 rounds only dS before dS K, and takes the same tolerance. Its sum,
# sum_k |dS_ik| |K_kd|, weights |K_kd| by |dS_ik|, and sum_k |dS_ik| =
# scale * sum_k P_ik |dP_ik - delta_i| is the P-weighted mean absolute
# deviation of dO_i . V_k * scale (delta_i = sum_k P_ik dP_ik up to O's
# rounding): a projection of unit-scale inputs with a standard deviation
# of about 1, below 1.5 in every row. Times max |K| (below 6) that caps
# the sum at 9, but the two maxima do not meet: the weight spreads over
# many k, and the sum stays below 3, well inside 8
# (test_torch_kernels.py::test_dq_rounding_sum_stays_below_tc_tol_bound,
# T = 1024, head_dim 64 and 128). The largest errors measured against
# TC_TOL are in PERF.md.
TC_TOL = (2 ** -6, 2 ** -6)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {  # the last int of each is the variant
    "flash_fwd": ("hvd_flash_fwd",
                  [_P, _P, _P, _P, _P] + [_I] * 8 + [_F, _I, _P]),
    "flash_bwd_dq": ("hvd_flash_bwd_dq",
                     [_P] * 7 + [_I] * 8 + [_F, _I, _P]),
    "flash_bwd_dkv": ("hvd_flash_bwd_dkv",
                      [_P] * 8 + [_I] * 8 + [_F, _I, _P]),
}


def kernel_variant(name: str, dtype: torch.dtype, head_dim: int) -> str:
    """The variant kernel ``name`` launches for CUDA tensors of ``dtype``
    and ``head_dim``: tensor cores at bf16 and head_dim 64 or 128, the
    CUDA-core float32 kernel otherwise."""
    if (name in _TC_KERNELS and dtype == torch.bfloat16
            and head_dim in _TC_HEAD_DIMS):
        return TENSOR_CORE
    return CUDA_CORE


# -- layout helpers (the JAX package's _to_bh / _from_bh) ---------------------

def _to_bh(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B*H, T, D]."""
    batch, seq, heads, head_dim = x.shape
    return x.permute(0, 2, 1, 3).reshape(batch * heads, seq, head_dim)


def _from_bh(x: torch.Tensor, batch: int, heads: int) -> torch.Tensor:
    _, seq, head_dim = x.shape
    return x.reshape(batch, heads, seq, head_dim).permute(0, 2, 1, 3)


# -- plain versions: the Pallas kernels' arithmetic in PyTorch ---------------

def _causal_mask(s, q_pos0, k_pos0):
    block_q, block_k = s.shape[-2], s.shape[-1]
    q_pos = q_pos0 + torch.arange(block_q, device=s.device)[:, None]
    k_pos = k_pos0 + torch.arange(block_k, device=s.device)[None, :]
    return torch.where(q_pos >= k_pos, s, _NEG_INF)


def _recompute_p(q_blk, k_blk, lse_col, scale, causal, q_pos0, k_pos0):
    s = (q_blk * scale) @ k_blk.transpose(-1, -2)
    if causal:
        s = _causal_mask(s, q_pos0, k_pos0)
    p = torch.exp(s - lse_col)
    return torch.where(lse_col <= _NEG_INF / 2, 0.0, p)


def _block_visible(causal, q_pos0, block_q, k_pos0):
    """False when a causal q block lies wholly before the k block."""
    return not causal or q_pos0 + block_q - 1 >= k_pos0


def flash_fwd_plain(q, k, v, causal, scale, block_q, block_k, q_offset):
    """K1's plain version: ``_fwd_kernel`` over the ``_fwd_impl`` grid."""
    batch, seq_q, heads, _ = q.shape
    seq_k = k.shape[1]
    qb, kb, vb = (_to_bh(x).float() for x in (q, k, v))
    o = torch.empty_like(qb)
    lse = torch.empty(qb.shape[:2], dtype=torch.float32, device=q.device)
    for i in range(seq_q // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        q_pos0 = q_offset + i * block_q
        q_blk = qb[:, rows] * scale
        m = torch.full((qb.shape[0], block_q, 1), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(q_blk)
        for kk in range(seq_k // block_k):
            if not _block_visible(causal, q_pos0, block_q, kk * block_k):
                continue
            cols = slice(kk * block_k, (kk + 1) * block_k)
            s = q_blk @ kb[:, cols].transpose(-1, -2)
            if causal:
                s = _causal_mask(s, q_pos0, kk * block_k)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.where(m == _NEG_INF, 0.0, torch.exp(m - m_new))
            p = torch.exp(s - m_new)
            if causal:
                p = torch.where(m_new == _NEG_INF, 0.0, p)
            l = l * corr + p.sum(-1, keepdim=True)
            m = m_new
            acc = acc * corr + p @ vb[:, cols]
        l_safe = torch.clamp(l, min=1e-30)
        o[:, rows] = acc / l_safe
        lse[:, rows] = (m + torch.log(l_safe))[..., 0]
    return _from_bh(o, batch, heads).to(q.dtype), lse


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale, block_q,
                       block_k, q_offset):
    """K2's plain version: ``_bwd_dq_kernel`` over its grid."""
    batch, seq_q, heads, _ = q.shape
    seq_k = k.shape[1]
    qb, kb, vb, dob = (_to_bh(x).float() for x in (q, k, v, do))
    dq = torch.zeros_like(qb)
    for i in range(seq_q // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        q_pos0 = q_offset + i * block_q
        lse_col = lse[:, rows, None]
        delta_col = delta[:, rows, None]
        for kk in range(seq_k // block_k):
            if not _block_visible(causal, q_pos0, block_q, kk * block_k):
                continue
            cols = slice(kk * block_k, (kk + 1) * block_k)
            k_blk = kb[:, cols]
            p = _recompute_p(qb[:, rows], k_blk, lse_col, scale, causal,
                             q_pos0, kk * block_k)
            dp = dob[:, rows] @ vb[:, cols].transpose(-1, -2)
            ds = p * (dp - delta_col) * scale
            dq[:, rows] += ds @ k_blk
    return _from_bh(dq, batch, heads).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale, block_q,
                        block_k, q_offset):
    """K3's plain version: ``_bwd_dkv_kernel`` over its grid."""
    batch, seq_q, heads, _ = q.shape
    seq_k = k.shape[1]
    qb, kb, vb, dob = (_to_bh(x).float() for x in (q, k, v, do))
    dk = torch.zeros_like(kb)
    dv = torch.zeros_like(vb)
    for kk in range(seq_k // block_k):
        cols = slice(kk * block_k, (kk + 1) * block_k)
        for i in range(seq_q // block_q):
            q_pos0 = q_offset + i * block_q
            if not _block_visible(causal, q_pos0, block_q, kk * block_k):
                continue
            rows = slice(i * block_q, (i + 1) * block_q)
            q_blk, do_blk = qb[:, rows], dob[:, rows]
            p = _recompute_p(q_blk, kb[:, cols], lse[:, rows, None], scale,
                             causal, q_pos0, kk * block_k)
            dv[:, cols] += p.transpose(-1, -2) @ do_blk
            dp = do_blk @ vb[:, cols].transpose(-1, -2)
            ds = p * (dp - delta[:, rows, None]) * scale
            dk[:, cols] += ds.transpose(-1, -2) @ q_blk
    return (_from_bh(dk, batch, heads).to(k.dtype),
            _from_bh(dv, batch, heads).to(v.dtype))


# -- kernel wrappers ---------------------------------------------------------

def _kernel_fn(name: str):
    lib = _build.load(name)
    symbol, argtypes = _ARGTYPES[name]
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _check_kernel_inputs(name, q, k, v, do=None):
    """Raise on anything the CUDA kernels do not take; return the dtype
    code and the contiguous tensors."""
    tensors = (q, k, v) if do is None else (q, k, v, do)
    if any(t.dim() != 4 for t in tensors):
        raise ValueError(f"{name}: tensors must be [batch, seq, heads, "
                         "head_dim]")
    batch, _, heads, head_dim = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (
            batch, heads, head_dim) or (do is not None
                                        and do.shape != q.shape):
        raise ValueError(f"{name}: shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}"
                         + ("" if do is None else f", dO {tuple(do.shape)}"))
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if head_dim not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {head_dim}")
    if any(t.dtype != q.dtype or t.device != q.device for t in tensors):
        raise TypeError(f"{name}: q, k, v (and dO) must share one dtype and "
                        "device")
    return _KERNEL_DTYPES[q.dtype], [t.contiguous() for t in tensors]


def _check_tma_alignment(name, *tensors):
    """TMA reads from 16-byte-aligned addresses only; a contiguous view at
    an odd offset into its storage is refused, not copied."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the tensor-core kernel needs "
                             "16-byte-aligned tensors (TMA), got one at "
                             f"address {t.data_ptr():#x}")


def _rows(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """lse or delta: float32 [B*H, Tq] on q's device."""
    want = (q.shape[0] * q.shape[2], q.shape[1])
    if x.shape != want or x.dtype != torch.float32 or x.device != q.device:
        raise ValueError(f"per-row statistics must be float32 {list(want)} "
                         f"on {q.device}, got {x.dtype} {list(x.shape)} on "
                         f"{x.device}")
    return x.contiguous()


def _launch(name, device, *args):
    """Launch kernel ``name`` on ``device``'s current stream; raise with
    the CUDA error if the launch is refused."""
    lib, fn = _kernel_fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.hvd_flash_error_string(rc).decode()}")


def flash_fwd(q, k, v, causal, scale, block_q, block_k, q_offset):
    """K1: (O, lse). CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal, scale, block_q, block_k,
                               q_offset)
    variant = kernel_variant("flash_fwd", q.dtype, q.shape[-1])
    out = run_flash_fwd(q, k, v, causal, scale, q_offset, variant)
    flash_fwd.launches += 1
    flash_fwd.tc_launches += variant == TENSOR_CORE
    return out


def run_flash_fwd(q, k, v, causal, scale, q_offset, variant):
    """Launch K1's ``variant`` on CUDA tensors, uncounted (the wrapper
    counts); chip_smoke.py times the CUDA-core variant through it."""
    code, (q, k, v) = _check_kernel_inputs("flash_fwd", q, k, v)
    batch, seq_q, heads, head_dim = q.shape
    if variant == TENSOR_CORE:
        _check_tma_alignment("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((batch * heads, seq_q), dtype=torch.float32,
                      device=q.device)
    _launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), batch, heads, seq_q, k.shape[1],
            head_dim, code, int(causal), q_offset, scale,
            _VARIANT_CODES[variant])
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, block_q, block_k,
                 q_offset):
    """K2: dQ. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                  block_q, block_k, q_offset)
    variant = kernel_variant("flash_bwd_dq", q.dtype, q.shape[-1])
    dq = run_flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, q_offset,
                          variant)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.tc_launches += variant == TENSOR_CORE
    return dq


def run_flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, q_offset,
                     variant):
    """Launch K2's ``variant`` on CUDA tensors, uncounted (the wrapper
    counts)."""
    code, (q, k, v, do) = _check_kernel_inputs("flash_bwd_dq", q, k, v, do)
    batch, seq_q, heads, head_dim = q.shape
    lse, delta = _rows(lse, q), _rows(delta, q)
    if variant == TENSOR_CORE:
        _check_tma_alignment("flash_bwd_dq", q, k, v, do)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), batch, heads, seq_q, k.shape[1], head_dim, code,
            int(causal), q_offset, scale, _VARIANT_CODES[variant])
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, block_q, block_k,
                  q_offset):
    """K3: (dK, dV). CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale,
                                   block_q, block_k, q_offset)
    variant = kernel_variant("flash_bwd_dkv", q.dtype, q.shape[-1])
    out = run_flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, q_offset,
                            variant)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.tc_launches += variant == TENSOR_CORE
    return out


def run_flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, q_offset,
                      variant):
    """Launch K3's ``variant`` on CUDA tensors, uncounted (the wrapper
    counts)."""
    code, (q, k, v, do) = _check_kernel_inputs("flash_bwd_dkv", q, k, v,
                                               do)
    batch, seq_q, heads, head_dim = q.shape
    lse, delta = _rows(lse, q), _rows(delta, q)
    if variant == TENSOR_CORE:
        _check_tma_alignment("flash_bwd_dkv", q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), batch, heads, seq_q, k.shape[1],
            head_dim, code, int(causal), q_offset, scale,
            _VARIANT_CODES[variant])
    return dk, dv


KERNEL_WRAPPERS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


def reset_launch_counts() -> None:
    for wrapper in KERNEL_WRAPPERS:
        wrapper.launches = wrapper.tc_launches = 0


reset_launch_counts()


def launch_counts() -> dict:
    return {wrapper.__name__: wrapper.launches for wrapper in KERNEL_WRAPPERS}


def tc_launch_counts() -> dict:
    """Launches of the tensor-core variant, by kernel."""
    return {wrapper.__name__: wrapper.tc_launches
            for wrapper in KERNEL_WRAPPERS}


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta_i = sum_d dO_id O_id in float32, [B*H, Tq] (``_bwd_impl``)."""
    return _to_bh((do.float() * o.float()).sum(-1, keepdim=True))[..., 0]


def flash_bwd(q, k, v, o, lse, do, causal, scale, block_q, block_k,
              q_offset):
    """``_bwd_impl``: delta, then K2 and K3."""
    delta = row_delta(o, do).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, block_q,
                      block_k, q_offset)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, block_q,
                           block_k, q_offset)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of ``_flash``: the forward saves (q, k, v, o, lse),
    the backward recomputes P blockwise in K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k, q_offset):
        o, lse = flash_fwd(q, k, v, causal, scale, block_q, block_k,
                           q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.params = (causal, scale, block_q, block_k, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), *ctx.params)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """Fused attention, shapes [batch, seq, heads, head_dim].
    Differentiable (FlashAttention-2 recomputation kernels).

    ``q_offset`` shifts the global position of q (in elements) for causal
    masking. Sequence lengths must be multiples of the block sizes (pad
    upstream; blocks shrink to the sequence length when shorter)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention takes [batch, seq, heads, "
                         "head_dim] tensors")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    seq_q, seq_k = q.shape[1], k.shape[1]
    block_q = min(block_q, seq_q)
    block_k = min(block_k, seq_k)
    if seq_q % block_q or seq_k % block_k:
        raise ValueError(
            f"sequence lengths ({seq_q}, {seq_k}) must be multiples of the "
            f"block sizes ({block_q}, {block_k}); pad inputs first.")
    if q_offset < 0 or q_offset % block_q:
        raise ValueError(
            "q_offset must be a non-negative multiple of block_q")
    return _FlashAttention.apply(q, k, v, causal, float(scale), block_q,
                                 block_k, q_offset)
