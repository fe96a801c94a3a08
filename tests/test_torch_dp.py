"""Port data-parallel plane (horovod_tpu_torch): process basics, eager
collectives, DistributedOptimizer and state broadcast.

Multi-rank behaviour runs in a real 2-process gloo world on the CPU (NCCL
cannot put two ranks on one card): this file re-runs itself as the worker
(``python tests/test_torch_dp.py <out_dir>``) with the launcher env, and
the workers save what they saw; the test holds it against values computed
by hand with numpy. Averages are bit-exact: gloo sums two float32 values
exactly rounded, and the mean is that sum divided by 2, as numpy does.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import TransformerLM, lm_loss
from horovod_tpu_torch.optimizers import plan_buckets

WORLD = 2
THIS = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(THIS))


# -- the worker ---------------------------------------------------------------

def _local_grads(model, x):
    model.zero_grad()
    model(x).square().sum().backward()
    return [p.grad.clone() for p in model.parameters()]


def _model(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                               torch.nn.Linear(5, 3))


LM_CFG = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
              d_ff=64, max_seq_len=16, dtype=torch.float32,
              attention="flash")
LM_SHARD = 2  # sequences per rank
LM_STEPS = 3
LM_OPTIMIZERS = {
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=3e-4, weight_decay=0.01),
    "sgd": lambda ps: torch.optim.SGD(ps, lr=0.1),
}


def _lm_tokens():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, LM_CFG["vocab_size"],
                                         (LM_SHARD * WORLD, 16)))


def _lm(seed):
    return TransformerLM(**LM_CFG,
                         generator=torch.Generator().manual_seed(seed))


def _train_lm(model, opt, tokens):
    for _ in range(LM_STEPS):
        opt.zero_grad()
        lm_loss(model(tokens), tokens).backward()
        opt.step()


def _worker(out_dir):
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    assert size == WORLD
    rng = np.random.default_rng(100 + rank)
    saved = {}

    # eager collectives, sync and async
    x = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    saved["x"] = x.numpy()
    saved["allreduce_avg"] = hvd.allreduce(x).numpy()
    saved["allreduce_sum"] = hvd.allreduce(x, average=False).numpy()
    handle = hvd.allreduce_async(x.to(torch.bfloat16))
    bf16 = hvd.synchronize(handle)
    assert bf16.dtype == torch.bfloat16
    saved["allreduce_bf16"] = bf16.float().numpy()
    ragged = torch.full((rank + 1, 2), float(rank))
    saved["allgather"] = hvd.allgather(ragged).numpy()
    saved["broadcast"] = hvd.broadcast(x, root_rank=1).numpy()
    y = x.clone()
    hvd.broadcast_(y, root_rank=0)
    saved["broadcast_inplace"] = y.numpy()

    # DistributedOptimizer: the 200-byte fusion threshold splits the four
    # tensors into two buckets
    data = [torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
            for _ in range(2)]
    model = _model(seed=0)
    local = _local_grads(model, data[0])
    for i, g in enumerate(local):
        saved[f"local_grad_{i}"] = g.numpy()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.0),
        named_parameters=model.named_parameters())
    assert [len(b) for b in opt._buckets] == [3, 1]
    opt.zero_grad()
    model(data[0]).square().sum().backward()
    opt.synchronize()
    for i, p in enumerate(model.parameters()):
        saved[f"avg_grad_{i}"] = p.grad.numpy().copy()

    # backward_passes_per_step=2: two local passes, then one average
    model2 = _model(seed=0)
    acc = [a + b for a, b in zip(_local_grads(model2, data[0]),
                                 _local_grads(model2, data[1]))]
    for i, g in enumerate(acc):
        saved[f"acc_grad_{i}"] = g.numpy()
    opt2 = hvd.DistributedOptimizer(
        torch.optim.SGD(model2.parameters(), lr=0.0),
        named_parameters=model2.named_parameters(),
        backward_passes_per_step=2)
    opt2.zero_grad()
    for batch in data:
        model2(batch).square().sum().backward()
    opt2.step()
    for i, p in enumerate(model2.parameters()):
        saved[f"acc_avg_grad_{i}"] = p.grad.numpy().copy()

    # state broadcast: rank-specific weights and optimizer state
    model3 = _model(seed=10 + rank)
    inner = torch.optim.AdamW(model3.parameters(), lr=1e-2)
    if rank == 0:  # root has state, the other rank starts empty
        model3(data[0]).sum().backward()
        inner.step()
        inner.param_groups[0]["lr"] = 0.5
    hvd.broadcast_parameters(model3.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(inner, root_rank=0)
    for name, value in model3.state_dict().items():
        saved[f"param_{name}"] = value.numpy()
    saved["lr"] = np.float64(inner.param_groups[0]["lr"])
    for pid, state in inner.state_dict()["state"].items():
        for key, value in state.items():
            saved[f"opt_{pid}_{key}"] = np.asarray(value)
    saved["object"] = np.asarray(hvd.broadcast_object(
        {"rank": rank}, root_rank=1)["rank"])

    # the slice: a small flash TransformerLM trained data-parallel, each
    # rank on its half of the global batch, from rank-specific weights that
    # broadcast_parameters makes rank 0's
    shard = _lm_tokens()[LM_SHARD * rank:LM_SHARD * (rank + 1)]
    for opt_name in LM_OPTIMIZERS:
        lm = _lm(seed=5 + rank)
        hvd.broadcast_parameters(lm.state_dict(), root_rank=0)
        lm_opt = hvd.DistributedOptimizer(
            LM_OPTIMIZERS[opt_name](lm.parameters()),
            named_parameters=lm.named_parameters())
        _train_lm(lm, lm_opt, shard)
        for name, value in lm.state_dict().items():
            saved[f"lm_{opt_name}_{name}"] = value.numpy()

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    hvd.shutdown()


# -- the tests ----------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dp")
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, HOROVOD_RANK=str(rank),
                   HOROVOD_SIZE=str(WORLD), HOROVOD_LOCAL_RANK=str(rank),
                   HOROVOD_LOCAL_SIZE=str(WORLD),
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=str(port),
                   HOROVOD_FUSION_THRESHOLD="200",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, THIS, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=120)[0])
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _mean(a, b):
    return (np.float32(a) + np.float32(b)) / np.float32(2)


def test_allreduce_average_and_sum_bit_exact(world):
    r0, r1 = world
    for saved in world:
        np.testing.assert_array_equal(saved["allreduce_avg"],
                                      _mean(r0["x"], r1["x"]))
        np.testing.assert_array_equal(saved["allreduce_sum"],
                                      r0["x"] + r1["x"])
        want = _mean(*(torch.from_numpy(s["x"]).to(torch.bfloat16).float()
                       .numpy() for s in world))
        np.testing.assert_array_equal(
            saved["allreduce_bf16"],
            torch.from_numpy(want).to(torch.bfloat16).float().numpy())


def test_allgather_ragged_and_broadcast(world):
    r0, r1 = world
    want = np.array([[0, 0], [1, 1], [1, 1]], np.float32)
    for saved in world:
        np.testing.assert_array_equal(saved["allgather"], want)
        np.testing.assert_array_equal(saved["broadcast"], r1["x"])
        np.testing.assert_array_equal(saved["broadcast_inplace"], r0["x"])
        assert int(saved["object"]) == 1


def test_distributed_optimizer_averages_gradients_bit_exact(world):
    r0, r1 = world
    for i in range(4):
        want = _mean(r0[f"local_grad_{i}"], r1[f"local_grad_{i}"])
        for saved in world:
            np.testing.assert_array_equal(saved[f"avg_grad_{i}"], want)


def test_backward_passes_per_step_accumulates_then_averages(world):
    r0, r1 = world
    for i in range(4):
        want = _mean(r0[f"acc_grad_{i}"], r1[f"acc_grad_{i}"])
        for saved in world:
            np.testing.assert_array_equal(saved[f"acc_avg_grad_{i}"], want)


def test_broadcast_parameters_and_optimizer_state_from_root(world):
    r0, r1 = world
    keys = [k for k in r0 if k.startswith(("param_", "opt_"))]
    assert any(k.startswith("opt_") and k.endswith("exp_avg") for k in keys)
    assert set(keys) == {k for k in r1 if k.startswith(("param_", "opt_"))}
    for key in keys:
        np.testing.assert_array_equal(r1[key], r0[key], err_msg=key)
    assert float(r1["lr"]) == 0.5


def test_slice_trains_in_lockstep_and_matches_the_full_batch(world):
    """The slice's data-parallel path at world 2: both ranks end with
    bit-identical weights (AdamW and SGD), and with SGD the result equals
    one process training on the whole batch (the mean of the two shard
    gradients is the full batch's gradient) within 1e-5, the float32
    rounding of three steps."""
    r0, r1 = world
    for opt_name in LM_OPTIMIZERS:
        keys = [k for k in r0 if k.startswith(f"lm_{opt_name}_")]
        assert len(keys) == len(_lm(seed=0).state_dict())
        for key in keys:
            np.testing.assert_array_equal(r1[key], r0[key], err_msg=key)
    model = _lm(seed=5)
    _train_lm(model, LM_OPTIMIZERS["sgd"](model.parameters()), _lm_tokens())
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(r0[f"lm_sgd_{name}"], value.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


# -- one process --------------------------------------------------------------

def test_init_without_cuda_or_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()


def test_shutdown_then_init_again():
    for _ in range(2):
        hvd.init(device="cpu")
        assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (0, 0 + 1, 0)
        assert hvd.device() == torch.device("cpu")
        hvd.shutdown()
        assert not hvd.is_initialized()
    with pytest.raises(ValueError, match="not been initialized"):
        hvd.rank()


def test_world_of_one_collectives_and_handles():
    hvd.init(device="cpu")
    try:
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        handle = hvd.allreduce_async(x)
        out = hvd.synchronize(handle)
        torch.testing.assert_close(out, x, rtol=0, atol=0)
        handle = hvd.allgather_async(x)
        while not hvd.poll(handle):
            pass
        assert torch.equal(hvd.synchronize(handle), x)
        with pytest.raises(ValueError, match="handle"):
            hvd.synchronize(handle)
    finally:
        hvd.shutdown()


def test_double_wrapping_is_refused():
    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(2, 2)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        assert isinstance(opt, torch.optim.SGD)
        with pytest.raises(ValueError, match="already"):
            hvd.DistributedOptimizer(opt)
        with pytest.raises(ValueError, match="unique"):
            hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=[("w", model.weight), ("w", model.bias)])
    finally:
        hvd.shutdown()


def test_plan_buckets_respects_threshold_dtype_and_order():
    a, b, c = torch.zeros(10), torch.zeros(10), torch.zeros(30)
    d = torch.zeros(5, dtype=torch.float64)
    buckets = plan_buckets([a, b, c, d], threshold_bytes=80)
    assert [[id(t) for t in bk] for bk in buckets] == \
        [[id(a), id(b)], [id(c)], [id(d)]]
    assert [len(bk) for bk in plan_buckets([a, b], 0)] == [1, 1]


if __name__ == "__main__":
    _worker(sys.argv[1])
