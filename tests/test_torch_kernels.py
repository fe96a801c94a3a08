"""The port's CUDA flash kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on a CUDA machine without one
(``python -m pytest --noconftest tests/test_torch_kernels.py``). The kernel
cases need a card and skip without one; the CPU cases check what surrounds
the kernels: the wrappers' dispatch and the plain versions against the
port's dense attention.

Tolerances: float32 outputs within 2e-5 (sums of the same float32 products
in another order); bf16 outputs of the CUDA-core kernels round once from
float32 sums, so within two bf16 ulps (2**-6 relative) plus 2e-3 absolute
for values near 0; the float32 lse within 2e-5. The tensor-core variants
(bf16 at head_dim 64 and 128) also round P (K1, K3) and dS (K2, K3) to
bf16 before the products that take them, so their O, dQ, dK and dV get
the wider ``pa.TC_TOL`` (its derivation is beside it); lse keeps 2e-5,
since the row sums are taken from the float32 P.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as pa
from horovod_tpu_torch.parallel import dense_attention

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernels need a card")
KERNEL_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -6, 2e-3)}


def _inputs(shape, seed, n=4, device="cpu", dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, dtype) for _ in range(n)]


def _tol(name, q):
    """(rtol, atol) of kernel ``name``'s outputs for inputs like ``q``."""
    if pa.kernel_variant(name, q.dtype, q.shape[-1]) == pa.TENSOR_CORE:
        return pa.TC_TOL
    return KERNEL_TOL[q.dtype]


def _check_all(q, k, v, do, causal, block, q_offset):
    """Every kernel against its plain version on the same inputs."""
    args = (causal, q.shape[-1] ** -0.5, block, block, q_offset)
    o, lse = pa.flash_fwd(q, k, v, *args)
    o_ref, lse_ref = pa.flash_fwd_plain(q, k, v, *args)
    rtol, atol = _tol("flash_fwd", q)
    torch.testing.assert_close(o, o_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, lse_ref, rtol=2e-5, atol=2e-5)
    delta = pa.row_delta(o_ref, do)
    rtol, atol = _tol("flash_bwd_dq", q)
    torch.testing.assert_close(
        pa.flash_bwd_dq(q, k, v, do, lse_ref, delta, *args),
        pa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, *args),
        rtol=rtol, atol=atol)
    rtol, atol = _tol("flash_bwd_dkv", q)
    for got, want in zip(
            pa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, *args),
            pa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, *args)):
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 0),
                                             (True, 64)])
def test_kernels_match_plain_versions(dtype, head_dim, causal, q_offset):
    seq_q = 64 if q_offset else 128
    (q,) = _inputs((2, seq_q, 3, head_dim), 20, n=1, device="cuda",
                   dtype=dtype)
    k, v = _inputs((2, 128, 3, head_dim), 21, n=2, device="cuda",
                   dtype=dtype)
    (do,) = _inputs((2, seq_q, 3, head_dim), 22, n=1, device="cuda",
                    dtype=dtype)
    _check_all(q, k, v, do, causal, 64, q_offset)


@needs_cuda
@pytest.mark.parametrize("causal", [False, True])
def test_kernels_handle_ragged_tiles(causal):
    """Sequences that are not multiples of the kernels' 64-row tiles."""
    q, k, v, do = _inputs((2, 80, 2, 32), 23, device="cuda")
    _check_all(q, k, v, do, causal, 16, 0)


@needs_cuda
@pytest.mark.parametrize("shape,causal,block,q_offset", [
    ((2, 1024, 2, 64), True, 512, 0),     # the LM's sequence and width
    ((2, 200, 3, 64), True, 40, 0),       # ragged T: TMA zero fill, masks
    ((2, 200, 3, 64), False, 40, 0),
    ((2, 128, 3, 64), True, 64, 128),     # q_offset, seq_k 256 below
    ((2, 256, 3, 64), False, 64, 0),
    ((1, 192, 2, 128), False, 64, 0),     # two swizzle atoms a row
    ((2, 200, 2, 128), True, 40, 0),
])
def test_tensor_core_variant_matches_plain_versions(shape, causal, block,
                                                    q_offset):
    """bf16 K1-K3 take the tensor-core variant, and only it."""
    batch, seq_q, heads, head_dim = shape
    seq_k = 256 if q_offset else seq_q
    q, do = _inputs(shape, 25, n=2, device="cuda", dtype=torch.bfloat16)
    k, v = _inputs((batch, seq_k, heads, head_dim), 26, n=2, device="cuda",
                   dtype=torch.bfloat16)
    pa.reset_launch_counts()
    _check_all(q, k, v, do, causal, block, q_offset)
    assert pa.tc_launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                     "flash_bwd_dkv": 1}
    assert pa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                  "flash_bwd_dkv": 1}


@needs_cuda
def test_tensor_core_variant_refuses_misaligned_tensors():
    """TMA needs 16-byte-aligned bases: the wrapper raises, it does not
    switch to the other variant."""
    flat = torch.zeros(2 * 64 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    q = flat[1:].view(2, 64, 1, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    rows = torch.zeros((2, 64), device="cuda")
    pa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        pa.flash_fwd(q, q, q, True, 0.125, 64, 64, 0)
    with pytest.raises(ValueError, match="16-byte"):
        pa.flash_bwd_dq(q, q, q, q, rows, rows, True, 0.125, 64, 64, 0)
    assert pa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0}


@needs_cuda
def test_autograd_launches_each_kernel_once():
    q, k, v, do = _inputs((1, 128, 2, 64), 24, device="cuda")
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    pa.reset_launch_counts()
    pa.flash_attention(q, k, v, causal=True).backward(do)
    torch.cuda.synchronize()
    assert pa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                  "flash_bwd_dkv": 1}
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    dense_attention(*ref, causal=True).backward(do)
    for got, want in zip((q.grad, k.grad, v.grad), ref):
        torch.testing.assert_close(got, want.grad, rtol=5e-4, atol=5e-4)


@needs_cuda
def test_kernel_rejects_unsupported_inputs():
    q = torch.ones((1, 64, 1, 48), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        pa.flash_attention(q, q, q)
    q = torch.ones((1, 64, 1, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        pa.flash_attention(q, q, q)
    q = torch.ones((1, 64, 1, 64), device="cuda")
    with pytest.raises(ValueError, match="per-row"):
        pa.flash_bwd_dq(q, q, q, q, torch.zeros(1, 64), torch.zeros(1, 64),
                        True, 0.125, 64, 64, 0)  # lse on the CPU


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_and_grads_match_dense_attention(causal):
    q, k, v, do = _inputs((2, 64, 2, 32), 30)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = pa.flash_attention(q, k, v, causal=causal, block_q=16, block_k=32)
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = dense_attention(*ref, causal=causal)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    out.backward(do)
    want.backward(do)
    for got, r in zip((q.grad, k.grad, v.grad), ref):
        torch.testing.assert_close(got, r.grad, rtol=5e-4, atol=5e-4)


def test_plain_bf16_keeps_dtypes():
    """O and the gradients come back in the input dtype, lse in float32."""
    q, k, v, do = _inputs((1, 32, 2, 16), 31, dtype=torch.bfloat16)
    o, lse = pa.flash_fwd(q, k, v, True, 0.25, 32, 32, 0)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    dq, dk, dv = pa.flash_bwd(q, k, v, o, lse, do, True, 0.25, 32, 32, 0)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}


@pytest.mark.parametrize("k_shape,dtype,error,match", [
    ((2, 32, 3, 32), torch.float32, ValueError, "shapes"),
    ((2, 32, 2, 64), torch.float32, ValueError, "shapes"),
    ((2, 48, 3, 64), torch.float16, TypeError, "bfloat16"),
])
def test_kernel_input_checks(k_shape, dtype, error, match):
    """What the wrappers check before handing pointers to a kernel (the
    checks need no card)."""
    q = torch.zeros((2, 64, 3, 64), dtype=dtype)
    k = torch.zeros(k_shape, dtype=dtype)
    with pytest.raises(error, match=match):
        pa._check_kernel_inputs("flash_fwd", q, k, k)
    code, tensors = pa._check_kernel_inputs(
        "flash_bwd_dq", q.float(), q.float()[:, :32], q.float()[:, :32],
        q.float())
    assert code == 0 and all(t.is_contiguous() for t in tensors)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_kernel_variant_rule(dtype, head_dim):
    """The variant is a pure function of (dtype, head_dim): tensor cores for
    K1-K3 at bf16 and head_dim 64 or 128, the CUDA-core float32 kernel for
    everything else."""
    tensor_core = dtype == torch.bfloat16 and head_dim in (64, 128)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert pa.kernel_variant(name, dtype, head_dim) == (
            pa.TENSOR_CORE if tensor_core else pa.CUDA_CORE)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"])
def test_entry_points_take_the_variant_before_the_stream(name):
    """Each C entry point's last two arguments are the variant (an int) and
    the stream (a pointer), so the wrapper asks for a variant by number."""
    _, argtypes = pa._ARGTYPES[name]
    assert argtypes[-2:] == [pa._I, pa._P]


@pytest.mark.parametrize("head_dim", [64, 128])
def test_dq_rounding_sum_stays_below_tc_tol_bound(head_dim):
    """TC_TOL's derivation for K2: rounding dS to bf16 moves dQ_id by at
    most 2**-9 * sum_k |dS_ik| |K_kd|, and that sum stays below 8 for
    unit-scale inputs at T = 1024, so 2**-9 * 8 = TC_TOL's atol covers it."""
    seq = 1024
    q, k, v, do = _inputs((1, seq, 2, head_dim), 33, dtype=torch.bfloat16)
    scale = head_dim ** -0.5
    o, lse = pa.flash_fwd_plain(q, k, v, True, scale, 512, 512, 0)
    delta = pa.row_delta(o, do)
    qb, kb, vb, dob = (pa._to_bh(t).float() for t in (q, k, v, do))
    s = (qb * scale) @ kb.transpose(-1, -2)
    s = s.masked_fill(torch.ones(seq, seq, dtype=torch.bool).triu(1),
                      float("-inf"))
    p = torch.exp(s - lse[..., None])
    ds = p * (dob @ vb.transpose(-1, -2) - delta[..., None]) * scale
    assert float((ds.abs() @ kb.abs()).max()) < 8
    assert 2 ** -9 * 8 <= pa.TC_TOL[1]


def test_tma_alignment_check():
    """A contiguous view at an odd offset into its storage is refused for
    the tensor-core variant; tensors from the allocator pass."""
    flat = torch.zeros(2 * 64 * 64 + 8, dtype=torch.bfloat16)
    aligned = torch.zeros((2, 64, 1, 64), dtype=torch.bfloat16)
    pa._check_tma_alignment("flash_fwd", aligned, aligned)
    for offset in (1, 4):  # 2 and 8 bytes in
        view = flat[offset:offset + 2 * 64 * 64].view(2, 64, 1, 64)
        assert view.is_contiguous()
        with pytest.raises(ValueError, match="16-byte-aligned"):
            pa._check_tma_alignment("flash_fwd", aligned, view)
    pa._check_tma_alignment("flash_fwd",
                            flat[8:8 + 2 * 64 * 64].view(2, 64, 1, 64))


@pytest.mark.parametrize("kernel,group", [
    ("_ZN8hvdflash16flash_fwd_kernelILi64E13__nv_bfloat16EEvPKT0_",
     "K1 flash_fwd"),
    ("_ZN8hvdflash22flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_st",
     "K1 flash_fwd"),
    ("_ZN8hvdflash19flash_bwd_dq_kernelILi64E13__nv_bfloat16EEv",
     "K2 flash_bwd_dq"),
    ("_ZN8hvdflash25flash_bwd_dq_wgmma_kernelILi64EEEv14CUtensorMap_st",
     "K2 flash_bwd_dq"),
    ("_ZN8hvdflash20flash_bwd_dkv_kernelILi64EfEEvPKT0_", "K3 flash_bwd_dkv"),
    ("_ZN8hvdflash26flash_bwd_dkv_wgmma_kernelILi64EEEv14CUtensorMap_st",
     "K3 flash_bwd_dkv"),
    ("void at::native::vectorized_elementwise_kernel<4>", "other"),
])
def test_profile_groups_name_both_variants(kernel, group):
    """lm_bench --profile-steps reports K1-K3 as their own groups
    whichever variant ran."""
    from horovod_tpu_torch.benchmarks.lm_bench import kernel_group
    assert kernel_group(kernel) == group


def test_cpu_tensors_never_load_a_kernel(monkeypatch):
    """The wrappers pick the plain version only because the tensor lies on
    the CPU; the kernel library is not even loaded."""
    def refuse(name):
        raise AssertionError(f"kernel {name} loaded for CPU tensors")

    monkeypatch.setattr(pa._build, "load", refuse)
    q, k, v, do = _inputs((1, 32, 1, 16), 32)
    q.requires_grad_()
    pa.flash_attention(q, k, v, causal=True).backward(do)
    assert q.grad is not None


def test_profile_summary_counts_launches_per_step():
    """lm_bench's profile reports device time by group and the device
    kernels launched per step, copies and fills included."""
    from horovod_tpu_torch.benchmarks.lm_bench import summarize_profile
    kernels = [
        ("_ZN8hvdflash25flash_bwd_dq_wgmma_kernelILi64EEEv14CUtensorMap_st",
         3.0, 36),
        ("ampere_bf16_s16816gemm_bf16_128x128", 6.0, 90),
        ("Memcpy HtoD (Pageable -> Device)", 0.3, 6),
    ]
    out = summarize_profile(kernels, steps=3, wall_ms=15.0)
    assert out["launches_per_step"] == 44
    assert out["device_ms_per_step"] == pytest.approx(3.1)
    assert out["device_busy_share"] == pytest.approx(3.1 / 5.0)
    assert out["groups_ms_per_step"] == pytest.approx(
        {"matmul": 2.0, "K2 flash_bwd_dq": 1.0, "other": 0.1})
