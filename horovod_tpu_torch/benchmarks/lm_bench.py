#!/usr/bin/env python
"""Transformer-LM synthetic training benchmark: tokens/s per device.

Port of ``benchmarks/lm_bench.py``: the same model and protocol arguments
and defaults (GPT-2-small-shaped: 12 layers, 12 heads, d_model 768, d_ff
3072, vocab 32768, seq 1024, batch 8 per device, flash attention; the JAX
bench's host-init cache flags have no counterpart, since the weights are
drawn from a seeded generator at start) and the same protocol (synthetic tokens, warmup batches, then ``--num-iters`` x
``--num-batches-per-iter`` timed batches, mean +- 1.96 sigma). The step is
the port's product path: ``DistributedOptimizer(AdamW(3e-4, weight_decay
0.01))`` after ``broadcast_parameters`` from rank 0, with the hand-written
CUDA flash kernels inside the model.

Runs on this rank's card; ``--device cpu`` runs on the CPU on request.
Prints ONE JSON line, metric ``transformer_lm_tokens_per_sec_per_device``.

    python -m horovod_tpu_torch.benchmarks.lm_bench
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import TransformerLM, lm_loss

# NVIDIA H100 SXM dense bf16 tensor-core peak (data sheet), for MFU
H100_BF16_PEAK_FLOPS = 989e12


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--num-layers", type=int, default=12)
    parser.add_argument("--num-heads", type=int, default=12)
    parser.add_argument("--d-model", type=int, default=768)
    parser.add_argument("--d-ff", type=int, default=3072)
    parser.add_argument("--vocab-size", type=int, default=32768)
    parser.add_argument("--seq-len", type=int, default=1024)
    parser.add_argument("--batch-size", type=int, default=8,
                        help="sequences per device")
    parser.add_argument("--attention", default="flash",
                        choices=["dense", "flash"])
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize each block (not ported yet)")
    parser.add_argument("--num-warmup-batches", type=int, default=10)
    parser.add_argument("--num-batches-per-iter", type=int, default=10)
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU; default: this "
                             "rank's CUDA device")
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="after timing, trace this many steps with "
                             "torch.profiler and report device time by "
                             "kernel group")
    return parser.parse_args(argv)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def model_flops_per_step(args, batch: int) -> float:
    """Model FLOPs of one training step on one device, from the shapes:
    6 x matmul parameters x tokens, plus causal attention (QK^T and PV
    forward, four products backward) over the T(T+1)/2 visible pairs.
    Recomputation inside the backward kernels is not counted."""
    d, ff, layers = args.d_model, args.d_ff, args.num_layers
    matmul_params = layers * (4 * d * d + 2 * d * ff) + d * args.vocab_size
    tokens = batch * args.seq_len
    pairs = args.seq_len * (args.seq_len + 1) / 2
    return 6.0 * matmul_params * tokens + 12.0 * layers * batch * d * pairs


# kernel-name substrings -> the group a kernel's device time is reported in
# (K1-K3 by either variant: CUDA-core or tensor-core)
_KERNEL_GROUPS = (
    ("flash_fwd_kernel", "K1 flash_fwd"),
    ("flash_fwd_wgmma_kernel", "K1 flash_fwd"),
    ("flash_bwd_dq_kernel", "K2 flash_bwd_dq"),
    ("flash_bwd_dq_wgmma_kernel", "K2 flash_bwd_dq"),
    ("flash_bwd_dkv_kernel", "K3 flash_bwd_dkv"),
    ("flash_bwd_dkv_wgmma_kernel", "K3 flash_bwd_dkv"),
    ("nccl", "nccl"),
    ("multi_tensor_apply", "optimizer"),
    ("gemm", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
    ("xmma", "matmul"),
)


def kernel_group(name: str) -> str:
    """The profile group of a device kernel, by its (mangled) name."""
    return next((g for sub, g in _KERNEL_GROUPS if sub in name), "other")


def profile_steps(run_batch, wait, steps: int) -> dict:
    """Trace ``steps`` training steps with torch.profiler and summarise
    the device's side of them (``summarize_profile``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wait()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_batch()
        wait()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side kernels only: a user annotation (Optimizer.step, ...)
    # spans kernels already counted
    kernels = [(evt.key, evt.self_device_time_total / 1e3, evt.count)
               for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False)
               and evt.self_device_time_total > 0]
    return summarize_profile(kernels, steps, wall_ms)


def summarize_profile(kernels, steps: int, wall_ms: float) -> dict:
    """Per step, from ``kernels`` = (name, total device ms, launches) of
    each device kernel over ``steps`` traced steps taking ``wall_ms``:
    device time by kernel group, the ten costliest kernels, the launches
    (every device kernel, copies and fills included: each is one call the
    host makes), and the device's busy share of the traced wall time (the
    profiler's own overhead lengthens that wall time, so the share is a
    lower bound)."""
    groups: dict = {}
    for name, ms, _ in kernels:
        group = kernel_group(name)
        groups[group] = groups.get(group, 0.0) + ms / steps
    busy_ms = sum(ms for _, ms, _ in kernels) / steps
    top = sorted(kernels, key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms,
            "device_busy_share": busy_ms / (wall_ms / steps),
            "launches_per_step": sum(n for _, _, n in kernels) / steps,
            "groups_ms_per_step": dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels_ms_per_step": [(n[:120], ms / steps)
                                        for n, ms, _ in top]}


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parse_args(argv)
    hvd.init(device=args.device)
    dev = hvd.device()
    if args.profile_steps and dev.type != "cuda":
        raise ValueError("--profile-steps reads device time: it needs a "
                         "CUDA device")
    n_dev = hvd.size()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    _log(f"TransformerLM: {args.num_layers}L/{args.num_heads}H/"
         f"d{args.d_model}/ff{args.d_ff}, vocab {args.vocab_size}, "
         f"seq {args.seq_len}, batch {args.batch_size}/device, "
         f"attention={args.attention}, devices: {n_dev} ({kind})")

    # every rank draws the global batch from seed 0 and keeps its shard;
    # the weights come from seed 1 (the JAX bench's PRNGKey(0) / (1))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, args.vocab_size,
                           (args.batch_size * n_dev, args.seq_len),
                           generator=gen)
    rows = slice(hvd.rank() * args.batch_size,
                 (hvd.rank() + 1) * args.batch_size)
    tokens = tokens[rows].to(dev)
    model = TransformerLM(
        vocab_size=args.vocab_size, num_layers=args.num_layers,
        num_heads=args.num_heads, d_model=args.d_model, d_ff=args.d_ff,
        max_seq_len=args.seq_len, attention=args.attention,
        remat=args.remat,
        generator=torch.Generator().manual_seed(1)).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    _log("model initialized")

    losses = []

    def run_batch() -> None:
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    def wait() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    _log(f"Running {args.num_warmup_batches} warmup batches...")
    for _ in range(args.num_warmup_batches):
        run_batch()
    wait()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    tok_secs = []
    tokens_per_batch = args.batch_size * args.seq_len
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            run_batch()
        wait()
        dt = time.perf_counter() - t0
        rate = tokens_per_batch * args.num_batches_per_iter / dt
        tok_secs.append(rate)
        _log(f"Iter #{i}: {rate:.1f} tokens/sec on this device")

    loss_values = torch.stack(losses).float().cpu().tolist()
    final_loss = float(hvd.allreduce(losses[-1].reshape(1)).item())
    mean = float(np.mean(tok_secs))
    conf = float(1.96 * np.std(tok_secs))
    step_ms = 1e3 * tokens_per_batch / mean
    _log(f"Tokens/sec/device: {mean:.1f} +- {conf:.1f} "
         f"(step {step_ms:.2f} ms, loss {final_loss:.4f})")
    flops = model_flops_per_step(args, args.batch_size)
    result = {
        "metric": "transformer_lm_tokens_per_sec_per_device",
        "value": mean,
        "unit": "tokens/s",
        "conf_1.96sigma": conf,
        "vs_baseline": None,  # the reference publishes no LM figure
        "live": True,
        "attention": args.attention,
        "seq_len": args.seq_len,
        "batch_size": args.batch_size,
        "n_devices": n_dev,
        "device": kind,
        "step_ms": step_ms,
        "model_tflop_per_step": flops / 1e12,
        "loss": final_loss,
        "captured_at": time.time(),
    }
    if dev.type == "cuda":
        result["mfu_vs_h100_bf16_peak"] = \
            flops / (step_ms / 1e3) / H100_BF16_PEAK_FLOPS
        result["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if args.profile_steps > 0:
        result["profile"] = profile_steps(run_batch, wait,
                                          args.profile_steps)
    print(json.dumps(result), flush=True)
    result["losses"] = loss_values
    hvd.shutdown()
    return result


if __name__ == "__main__":
    main()
