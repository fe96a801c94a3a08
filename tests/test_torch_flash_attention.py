"""Port flash attention (horovod_tpu_torch) against the JAX package's Pallas
kernels, which run here in interpret mode as tests/test_pallas_attention.py
runs them.

On the CPU the port's wrappers take their plain versions, so these tests
hold the plain versions (the arithmetic the CUDA kernels implement) against
the TPU kernels. Tolerances are the JAX package's own for these shapes:
2e-5 forward and 5e-4 for gradients, at float32. The CUDA kernels are held
against the plain versions by tests/test_torch_kernels.py (on a card) and
by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_attention as jax_pa
from horovod_tpu.parallel.ring_attention import dense_attention as jax_dense
from horovod_tpu_torch.ops import flash_attention as pa
from horovod_tpu_torch.parallel import dense_attention

B, T, H, D = 2, 64, 2, 16
BLOCK = 16
FWD_TOL = 2e-5
GRAD_TOL = 5e-4


def _arrays(seed, shape=(B, T, H, D), n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax_kernel(causal):
    q, k, v = _arrays(0)
    want = jax_pa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=BLOCK, block_k=BLOCK)
    got = pa.flash_attention(*_torch(q, k, v), causal=causal,
                             block_q=BLOCK, block_k=BLOCK)
    _close(got, want, FWD_TOL)
    _close(got, dense_attention(*_torch(q, k, v), causal=causal), FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_lse_matches_jax_fwd_impl(causal):
    """The residual the backward reads: lse, float32 [B*H, T]."""
    q, k, v = _arrays(1)
    scale = 1.0 / np.sqrt(D)
    o_want, lse_want = jax_pa._fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        BLOCK, BLOCK, True, 0)
    o, lse = pa.flash_fwd(*_torch(q, k, v), causal, scale, BLOCK, BLOCK, 0)
    assert lse.dtype == torch.float32 and lse.shape == (B * H, T)
    _close(o, o_want, FWD_TOL, "o")
    _close(lse, lse_want, FWD_TOL, "lse")


def test_q_offset_matches_jax_kernel():
    q, k, v = _arrays(2)
    args = (q[:, :16], k[:, :32], v[:, :32])
    want = jax_pa.flash_attention(*map(jnp.asarray, args), causal=True,
                                  block_q=BLOCK, block_k=BLOCK, q_offset=16)
    got = pa.flash_attention(*_torch(*args), causal=True, block_q=BLOCK,
                             block_k=BLOCK, q_offset=16)
    _close(got, want, FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_kernel(causal):
    q, k, v = _arrays(3)
    (cot,) = _arrays(7, n=1)

    def jax_loss(q, k, v):
        return jnp.vdot(jax_pa.flash_attention(
            q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK), cot)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _torch(q, k, v, grad=True)
    out = pa.flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK,
                             block_k=BLOCK)
    (out * torch.from_numpy(cot)).sum().backward()
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        _close(g, w, GRAD_TOL, f"d{name}")


def test_grads_q_offset_match_jax_kernel():
    q, k, v = _arrays(5)
    q_half = q[:, T // 2:]
    (cot,) = _arrays(8, shape=q_half.shape, n=1)

    def jax_loss(q, k, v):
        return jnp.vdot(jax_pa.flash_attention(
            q, k, v, causal=True, block_q=BLOCK, block_k=BLOCK,
            q_offset=T // 2), cot)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q_half), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _torch(q_half, k, v, grad=True)
    out = pa.flash_attention(tq, tk, tv, causal=True, block_q=BLOCK,
                             block_k=BLOCK, q_offset=T // 2)
    (out * torch.from_numpy(cot)).sum().backward()
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        _close(g, w, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_versions_match_jax_bwd_impl(causal):
    """K2's and K3's plain versions, each on its own, against the two
    backward kernels of ``_bwd_impl`` fed the same residuals."""
    q, k, v, do = _arrays(9, n=4)
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jax_pa._fwd_impl(jq, jk, jv, causal, scale, BLOCK, BLOCK, True,
                              0)
    want = jax_pa._bwd_impl(jq, jk, jv, o, lse, jdo, causal, scale, BLOCK,
                            BLOCK, True, 0)
    tq, tk, tv, tdo = _torch(q, k, v, do)
    to, tlse = _torch(np.asarray(o), np.asarray(lse))
    delta = pa.row_delta(to, tdo)
    dq = pa.flash_bwd_dq_plain(tq, tk, tv, tdo, tlse, delta, causal, scale,
                               BLOCK, BLOCK, 0)
    dk, dv = pa.flash_bwd_dkv_plain(tq, tk, tv, tdo, tlse, delta, causal,
                                    scale, BLOCK, BLOCK, 0)
    for g, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        _close(g, w, GRAD_TOL, name)


def test_grads_match_jax_dense_attention():
    q, k, v = _arrays(11)
    want = jax.grad(lambda q, k, v: (jax_dense(q, k, v, causal=True) ** 2
                                     ).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _torch(q, k, v, grad=True)
    (pa.flash_attention(tq, tk, tv, causal=True, block_q=32, block_k=16)
     ** 2).sum().backward()
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        _close(g, w, GRAD_TOL, f"d{name}")


def test_rejects_ragged_seq():
    q = torch.ones((1, 48, 1, 8))
    with pytest.raises(ValueError, match="multiples"):
        pa.flash_attention(q, q, q, block_q=32, block_k=32)


@pytest.mark.parametrize("offset", [-16, 8])
def test_rejects_bad_q_offset(offset):
    q = torch.ones((1, 32, 1, 8))
    with pytest.raises(ValueError, match="q_offset"):
        pa.flash_attention(q, q, q, block_q=16, block_k=16, q_offset=offset)


def test_blocks_shrink_to_sequence_and_default_scale():
    """Blocks larger than the sequence shrink to it; the default scale is
    1/sqrt(D), the same as passing it explicitly."""
    q, k, v = _torch(*_arrays(12, shape=(1, 32, 2, 16)))
    got = pa.flash_attention(q, k, v, causal=True)  # blocks 512 -> 32
    want = pa.flash_attention(q, k, v, causal=True, scale=0.25, block_q=32,
                              block_k=32)
    assert torch.equal(got, want)


def test_plain_path_counts_no_launch():
    """CPU tensors take the plain versions: no kernel is launched."""
    pa.reset_launch_counts()
    q, k, v = _torch(*_arrays(13, shape=(1, 32, 1, 16)), grad=True)
    pa.flash_attention(q, k, v, causal=True).sum().backward()
    assert pa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0}
