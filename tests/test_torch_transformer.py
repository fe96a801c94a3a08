"""Port TransformerLM (horovod_tpu_torch) against the JAX package's Flax
model, with the same weights carried across by models/convert.py.

A small model (2 layers, d_model 64, 4 heads, d_ff 256, vocab 128, T 32)
with attention="flash" on both sides: the JAX side runs its Pallas kernels
in interpret mode, the port its kernels' plain versions (CPU tensors).
Tokens come from a numpy seed; the Flax init gives the weights.

Tolerances, each with its reason:

* float32: logits within 2e-5 (five float32 ulps of the largest logit, about
  4; the two sides sum the same products in another order), the loss
  within 1e-5 relative, every gradient within 1e-6 absolute + 1e-4
  relative (the largest gradients are about 0.1; the key biases, whose true
  gradient is 0, are noise of about 1e-9 on both sides).
* bfloat16: every op rounds to bf16 (8 bits of mantissa) on both sides, at
  different places (torch widens inside an op, XLA may not), and the
  differences grow through two layers: logits within 0.06 (two bf16 ulps
  at |logit| <= 8), the loss within 5e-3, gradients within 5e-3 absolute
  (under 4% of the largest gradient).
* AdamW, three steps at lr 3e-4: every tensor within 2e-6 absolute (under
  1% of lr; about 5e-7 is seen). The exception is the key biases: a key
  bias adds the same q.b to every score of a row, which softmax ignores, so
  their true gradient is 0 and both sides hold float noise of about 1e-9
  there. Adam divides by sqrt(v) and steps such a tensor by about lr per
  step in the noise's sign, so for them the check is Adam's own bound:
  each side within steps x lr (+ the decay) of the start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import TransformerLM as FlaxLM
from horovod_tpu.models import lm_loss as flax_lm_loss
from horovod_tpu_torch.models import TransformerLM, from_flax_params, lm_loss

CFG = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=64, d_ff=256,
           max_seq_len=32)
BATCH, SEQ = 2, 32
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(logits=2e-5, loss=1e-5, grad_atol=1e-6, grad_rtol=1e-4),
       "bf16": dict(logits=6e-2, loss=5e-3, grad_atol=5e-3, grad_rtol=0.0)}
ADAM_STEPS = 3
ADAM_TOL = 2e-6
ADAM_LR = 3e-4


def _tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _flax(dtype_name):
    model = FlaxLM(**CFG, dtype=DTYPES[dtype_name][0], attention="flash")
    tokens = jnp.asarray(_tokens())
    params = model.clone(attention="dense").init(
        jax.random.PRNGKey(0), tokens)["params"]

    @jax.jit
    def value_and_grad(p):
        def f(p):
            logits = model.apply({"params": p}, tokens)
            return flax_lm_loss(logits, tokens), logits

        return jax.value_and_grad(f, has_aux=True)(p)

    return params, value_and_grad


def _port(params, dtype_name):
    model = TransformerLM(**CFG, dtype=DTYPES[dtype_name][1],
                          attention="flash")
    model.load_state_dict(from_flax_params(_to_numpy(params)))
    return model


@pytest.fixture(scope="module", params=sorted(DTYPES))
def forward_backward(request):
    """Both sides' logits, loss and gradients, once per dtype."""
    name = request.param
    params, value_and_grad = _flax(name)
    (loss, logits), grads = value_and_grad(params)
    model = _port(params, name)
    tokens = torch.from_numpy(_tokens().astype(np.int64))
    t_logits = model(tokens)
    t_loss = lm_loss(t_logits, tokens)
    t_loss.backward()
    return dict(name=name, logits=(t_logits.detach(), np.asarray(logits)),
                loss=(float(t_loss.detach()), float(loss)),
                grads=({n: p.grad for n, p in model.named_parameters()},
                       from_flax_params(_to_numpy(grads))))


def test_converted_state_dict_fills_every_parameter():
    params, _ = _flax("f32")
    state = from_flax_params(_to_numpy(params))
    model = TransformerLM(**CFG, dtype=torch.float32)
    assert set(state) == set(model.state_dict())
    missing, unexpected = model.load_state_dict(state, strict=True)
    assert not missing and not unexpected
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in model.parameters())


def test_logits_match_flax(forward_backward):
    got, want = forward_backward["logits"]
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ, 128)
    tol = TOL[forward_backward["name"]]["logits"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_loss_matches_flax(forward_backward):
    got, want = forward_backward["loss"]
    tol = TOL[forward_backward["name"]]["loss"]
    if forward_backward["name"] == "f32":
        assert got == pytest.approx(want, rel=tol)
    else:
        assert got == pytest.approx(want, abs=tol)


def test_every_gradient_matches_flax(forward_backward):
    got, want = forward_backward["grads"]
    tol = TOL[forward_backward["name"]]
    assert set(got) == set(want)
    for name, grad in got.items():
        np.testing.assert_allclose(
            grad.numpy(), want[name].numpy(), rtol=tol["grad_rtol"],
            atol=tol["grad_atol"], err_msg=name)


@pytest.fixture()
def world_of_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_adamw_steps_through_distributed_optimizer_match_optax(world_of_one):
    """Three steps of the port's DistributedOptimizer(AdamW(3e-4, wd 0.01))
    at world 1 against optax.adamw(3e-4, weight_decay=0.01) applied to the
    JAX gradients."""
    params, value_and_grad = _flax("f32")
    opt = optax.adamw(ADAM_LR, weight_decay=0.01)
    opt_state = opt.init(params)
    for _ in range(ADAM_STEPS):
        _, grads = value_and_grad(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    start, _ = _flax("f32")
    model = _port(start, "f32")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    t_opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=ADAM_LR, weight_decay=0.01),
        named_parameters=model.named_parameters())
    tokens = torch.from_numpy(_tokens().astype(np.int64))
    for _ in range(ADAM_STEPS):
        t_opt.zero_grad()
        lm_loss(model(tokens), tokens).backward()
        t_opt.step()

    want = from_flax_params(_to_numpy(params))
    before = from_flax_params(_to_numpy(start))
    noise_bound = ADAM_STEPS * ADAM_LR * 1.01
    for name, p in model.named_parameters():
        got = p.detach()
        assert not torch.equal(got, before[name]), name
        if name.endswith("attn.key.bias"):
            for side in (got, want[name]):
                assert float((side - before[name]).abs().max()) \
                    <= noise_bound, name
            continue
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0,
                                   atol=ADAM_TOL, err_msg=name)


def test_dense_and_flash_backends_agree():
    """The port's two attention backends, same weights, float32."""
    params, _ = _flax("f32")
    tokens = torch.from_numpy(_tokens().astype(np.int64))
    logits = []
    for attention in ("dense", "flash"):
        model = TransformerLM(**CFG, dtype=torch.float32, attention=attention)
        model.load_state_dict(from_flax_params(_to_numpy(params)))
        logits.append(model(tokens).detach())
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=2e-5)


@pytest.mark.parametrize("kwargs", [dict(attention="ring"),
                                    dict(attention="ulysses"),
                                    dict(remat=True)])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="M19"):
        TransformerLM(**CFG, **kwargs)
