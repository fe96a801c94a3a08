#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (horovod_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the last line is printed only when all pass):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. the build of the three flash-attention kernels from csrc/, in parallel;
3. each kernel against its plain PyTorch version on the same inputs, at
   the LM's shape [8, 1024, 12, 64] bf16 causal (timed, beside its bound,
   torch's scaled_dot_product_attention as a yardstick the port never
   calls, and each kernel's CUDA-core variant as "ms_before"; with every
   output's max abs error against a float64 dense attention on the same
   inputs, for kernel and plain version), at small bf16 shapes that reach
   the tensor-core variant's edges (ragged T, q_offset, non-causal, head
   dim 128), and at small float32 shapes (causal, non-causal, q_offset,
   ragged); then the kernels inside a small TransformerLM against the dense
   backend;
4. the main path: the LM benchmark's own entry point
   (horovod_tpu_torch.benchmarks.lm_bench) at its full default width on this
   card, NCCL world of one, launch counters set to 0 just before and read
   just after: every step must launch each kernel once per layer, every
   launch must take the tensor-core variant, and the loss must start
   near ln(vocab), stay finite and fall;
5. a "kernels" JSON line, then {"ok": true, "device": {...}} as the last
   line.

TF32 is off for the whole run (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32), so float32 comparisons test the kernels,
not TF32. Exits non-zero without a CUDA device or without the package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

# H100 SXM data sheet: dense tensor-core bf16, CUDA-core float32, HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
SLICE_SHAPE = (8, 1024, 12, 64)  # lm_bench defaults: batch, seq, heads, d/h
# the main path: 3 warmup steps, then 2 timed iterations of 5 steps
WARMUP, PER_ITER, ITERS = 3, 5, 2
# bf16 outputs round once from float32 sums taken in another order: two
# bf16 ulps (2**-6 relative) plus an absolute floor; float32 as the JAX
# package's own kernel tests. The tensor-core variants also round P or dS
# to bf16 before a product: flash_attention.TC_TOL.
TOL = {"torch.bfloat16": (2 ** -6, 2e-3), "torch.float32": (2e-5, 2e-5)}
GRAD_TOL_F32 = (5e-4, 5e-4)
KERNELS = [
    ("flash_fwd", "horovod_tpu_torch/csrc/flash_fwd.cu",
     "horovod_tpu/ops/pallas_attention.py:51"),
    ("flash_bwd_dq", "horovod_tpu_torch/csrc/flash_bwd_dq.cu",
     "horovod_tpu/ops/pallas_attention.py:123"),
    ("flash_bwd_dkv", "horovod_tpu_torch/csrc/flash_bwd_dkv.cu",
     "horovod_tpu/ops/pallas_attention.py:169"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the host's cost of each launch (Python, ctypes, the
    TMA maps) stays out of the time, where back-to-back launches of a
    kernel shorter than that cost would measure the host instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(seq_q, seq_k, causal, q_offset) -> int:
    """(q, k) pairs the kernels must compute: all, or the causal ones."""
    if not causal:
        return seq_q * seq_k
    rows = np.minimum(seq_k, q_offset + np.arange(seq_q) + 1)
    return int(np.maximum(rows, 0).sum())


def bound(kernel, shape, dtype, causal, q_offset=0):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and FLOPs / peak
    for the inputs' type. Bytes: each input read once, each output written
    once. FLOPs: 2 x head_dim per visible pair and product (two products in
    K1, three in K2, four in K3)."""
    batch, seq, heads, head_dim = shape
    elem = 2 if dtype == "torch.bfloat16" else 4
    n = batch * seq * heads * head_dim
    rows = batch * heads * seq * 4  # one float32 per row (lse, delta)
    nbytes, products = {
        "flash_fwd": (3 * n * elem + n * elem + rows, 2),
        "flash_bwd_dq": (4 * n * elem + 2 * rows + n * elem, 3),
        "flash_bwd_dkv": (4 * n * elem + 2 * rows + 2 * n * elem, 4),
    }[kernel]
    flops = (2 * head_dim * products * batch * heads
             * visible_pairs(seq, seq, causal, q_offset))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def assert_close(torch, got, want, tol, what):
    rtol, atol = tol
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    check(bool((err <= limit).all()) and bool(torch.isfinite(got).all()),
          f"{what}: max abs err {float(err.max()):.3e} over rtol {rtol} "
          f"atol {atol}")
    return float(err.max())


def kernel_tol(pa, name, q):
    """The stated tolerance of kernel ``name``'s outputs for inputs like
    ``q``: TC_TOL where the tensor-core variant runs."""
    if pa.kernel_variant(name, q.dtype, q.shape[-1]) == pa.TENSOR_CORE:
        return pa.TC_TOL
    return TOL[str(q.dtype)]


def f64_reference(torch, q, k, v, do, causal, q_offset=0):
    """O, dQ, dK, dV of dense attention in float64 from the same inputs."""
    q64, k64, v64, do64 = (t.double().transpose(1, 2).contiguous()
                           for t in (q, k, v, do))
    for t in (q64, k64, v64):
        t.requires_grad_()
    s = (q64 @ k64.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        rows = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, float("-inf"))
    o64 = torch.softmax(s, -1) @ v64
    o64.backward(do64)
    return [t.transpose(1, 2)
            for t in (o64.detach(), q64.grad, k64.grad, v64.grad)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_slice_kernels(torch, pa, card):
    """K1-K3 at the LM's shape against their plain versions, timed."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(SLICE_SHAPE, generator=gen)
                   .to("cuda", torch.bfloat16) for _ in range(4))
    dtype = str(q.dtype)
    scale = SLICE_SHAPE[-1] ** -0.5
    args = (True, scale, 512, 512, 0)
    tol = {name: kernel_tol(pa, name, q) for name, _, _ in KERNELS}
    res = {}

    o_ref, lse_ref = pa.flash_fwd_plain(q, k, v, *args)
    o, lse = pa.flash_fwd(q, k, v, *args)
    err = assert_close(torch, o, o_ref, tol["flash_fwd"], "K1 O (bf16 slice)")
    assert_close(torch, lse, lse_ref, TOL["torch.float32"],
                 "K1 lse (bf16 slice)")
    res["flash_fwd"] = dict(
        max_abs_err=err,
        ms=graph_ms(torch, lambda: pa.flash_fwd(q, k, v, *args)),
        plain_ms=cuda_ms(torch, lambda: pa.flash_fwd_plain(q, k, v, *args),
                         iters=5),
        ms_before=graph_ms(torch, lambda: pa.run_flash_fwd(
            q, k, v, True, scale, 0, pa.CUDA_CORE)))

    delta = pa.row_delta(o_ref, do)
    dq_ref = pa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, *args)
    dq = pa.flash_bwd_dq(q, k, v, do, lse_ref, delta, *args)
    res["flash_bwd_dq"] = dict(
        max_abs_err=assert_close(torch, dq, dq_ref, tol["flash_bwd_dq"],
                                 "K2 dQ (bf16 slice)"),
        ms=graph_ms(torch, lambda: pa.flash_bwd_dq(q, k, v, do, lse_ref,
                                                   delta, *args)),
        plain_ms=cuda_ms(torch, lambda: pa.flash_bwd_dq_plain(
            q, k, v, do, lse_ref, delta, *args), iters=5),
        ms_before=graph_ms(torch, lambda: pa.run_flash_bwd_dq(
            q, k, v, do, lse_ref, delta, True, scale, 0, pa.CUDA_CORE)))

    dk_ref, dv_ref = pa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta,
                                            *args)
    dk, dv = pa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, *args)
    res["flash_bwd_dkv"] = dict(
        max_abs_err=max(
            assert_close(torch, dk, dk_ref, tol["flash_bwd_dkv"],
                         "K3 dK (bf16 slice)"),
            assert_close(torch, dv, dv_ref, tol["flash_bwd_dkv"],
                         "K3 dV (bf16 slice)")),
        ms=graph_ms(torch, lambda: pa.flash_bwd_dkv(q, k, v, do, lse_ref,
                                                    delta, *args)),
        plain_ms=cuda_ms(torch, lambda: pa.flash_bwd_dkv_plain(
            q, k, v, do, lse_ref, delta, *args), iters=5),
        ms_before=graph_ms(torch, lambda: pa.run_flash_bwd_dkv(
            q, k, v, do, lse_ref, delta, True, scale, 0, pa.CUDA_CORE)))

    # what each rounding costs: kernel and plain version against float64
    for name, got, want, exact in zip(
            ("O", "dQ", "dK", "dV"), (o, dq, dk, dv),
            (o_ref, dq_ref, dk_ref, dv_ref),
            f64_reference(torch, q, k, v, do, causal=True)):
        log(f"[kernel] {name} {list(SLICE_SHAPE)} bf16 causal vs float64 "
            f"dense: kernel max abs err "
            f"{float((got.double() - exact).abs().max()):.4e}, plain "
            f"{float((want.double() - exact).abs().max()):.4e}")

    # the three kernels through autograd, against the plain versions'
    # grads from the kernel's own forward (delta comes from K1's O)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    pa.flash_attention(*leaves, causal=True).backward(do)
    delta_k = pa.row_delta(o, do)
    wants = (pa.flash_bwd_dq_plain(q, k, v, do, lse, delta_k, *args),
             *pa.flash_bwd_dkv_plain(q, k, v, do, lse, delta_k, *args))
    for leaf, want, name, kernel in zip(
            leaves, wants, ("dQ", "dK", "dV"),
            ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv")):
        assert_close(torch, leaf.grad, want, tol[kernel], f"autograd {name}")

    # yardstick: torch's SDPA on the same inputs ([B, H, T, D] views)
    sq, sk, sv, sdo = (t.transpose(1, 2) for t in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = graph_ms(torch, lambda: sdpa(sq, sk, sv, is_causal=True))
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (sq, sk, sv))
    out = sdpa(lq, lk, lv, is_causal=True)
    # (autograd's backward is timed with events: it does not capture into
    # a graph here; at 0.25 ms and more the device, not the host, sets the
    # pace)
    sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (lq, lk, lv), sdo, retain_graph=True))

    def sdpa_step():
        o_ = sdpa(lq, lk, lv, is_causal=True)
        torch.autograd.grad(o_, (lq, lk, lv), sdo)

    def flash_step():
        o_ = pa.flash_attention(*leaves, causal=True)
        torch.autograd.grad(o_, leaves, do)

    sdpa_both = cuda_ms(torch, sdpa_step)
    flash_both = cuda_ms(torch, flash_step)
    res["flash_fwd"]["library_ms"] = sdpa_fwd
    # K2 and K3 together compute what SDPA's backward computes (dq, dk, dv)
    res["flash_bwd_dq"]["library_ms"] = sdpa_bwd
    res["flash_bwd_dkv"]["library_ms"] = sdpa_bwd
    for name, _, _ in KERNELS:
        res[name]["bound_ms"], res[name]["bound_by"] = bound(
            name, SLICE_SHAPE, dtype, causal=True)
        r = res[name]
        r["design"] = pa.kernel_variant(name, q.dtype, q.shape[-1])
        log(f"[kernel] {name} {list(SLICE_SHAPE)} bf16 causal, {r['design']}:"
            f" max abs err {r['max_abs_err']:.3e} (tol rtol "
            f"{tol[name][0]:.3e} atol {tol[name][1]:.3e}) | kernel "
            f"{r['ms']:.4f} ms (cuda-core {r['ms_before']:.4f} ms) | plain "
            f"{r['plain_ms']:.4f} ms | library {r['library_ms']:.4f} ms | "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | {card}")
    log(f"[kernel] fwd+bwd {list(SLICE_SHAPE)} bf16 causal: flash kernels "
        f"{flash_both:.4f} ms | SDPA {sdpa_both:.4f} ms | SDPA fwd "
        f"{sdpa_fwd:.4f} ms, bwd {sdpa_bwd:.4f} ms | {card}")
    return res


def phase_small_bf16(torch, pa):
    """The kernels at small bf16 shapes that reach the tensor-core
    variant's edges: ragged T (TMA's zero fill, the column masks),
    q_offset, non-causal, head dim 128 (two swizzle atoms a row); every
    launch must take the tensor-core variant."""
    cases = [  # (batch, seq_q, seq_k, heads, head_dim, causal, block, q_off)
        (2, 200, 200, 3, 64, True, 40, 0),
        (2, 200, 200, 3, 64, False, 40, 0),
        (2, 128, 256, 3, 64, True, 64, 128),
        (2, 256, 256, 3, 64, False, 64, 0),
        (1, 192, 192, 2, 128, False, 64, 0),
        (2, 200, 200, 2, 128, True, 40, 0),
    ]
    gen = torch.Generator().manual_seed(4)
    for batch, seq_q, seq_k, heads, hd, causal, block, q_off in cases:
        q, do = (torch.randn((batch, seq_q, heads, hd), generator=gen)
                 .to("cuda", torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((batch, seq_k, heads, hd), generator=gen)
                .to("cuda", torch.bfloat16) for _ in range(2))
        args = (causal, hd ** -0.5, block, block, q_off)
        what = (f"bf16 [{batch},{seq_q}/{seq_k},{heads},{hd}] "
                f"causal={causal} q_offset={q_off}")
        pa.reset_launch_counts()
        o_ref, lse_ref = pa.flash_fwd_plain(q, k, v, *args)
        o, lse = pa.flash_fwd(q, k, v, *args)
        errs = [assert_close(torch, o, o_ref,
                             kernel_tol(pa, "flash_fwd", q), f"K1 O {what}")]
        assert_close(torch, lse, lse_ref, TOL["torch.float32"],
                     f"K1 lse {what}")
        delta = pa.row_delta(o_ref, do)
        errs.append(assert_close(
            torch, pa.flash_bwd_dq(q, k, v, do, lse_ref, delta, *args),
            pa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, *args),
            kernel_tol(pa, "flash_bwd_dq", q), f"K2 dQ {what}"))
        for got, want, name in zip(
                pa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, *args),
                pa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, *args),
                ("dK", "dV")):
            errs.append(assert_close(torch, got, want,
                                     kernel_tol(pa, "flash_bwd_dkv", q),
                                     f"K3 {name} {what}"))
        tc = pa.tc_launch_counts()
        check(tc == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1},
              f"{what}: tensor-core launches {tc}, want one each")
        log(f"[kernel] {what}: max abs err {max(errs):.3e} (K1-K3 "
            f"tensor-core, tol rtol {pa.TC_TOL[0]:.3e} atol "
            f"{pa.TC_TOL[1]:.3e}; lse 2e-5)")


def phase_small_f32(torch, pa):
    """The kernels at small float32 shapes: causal, non-causal, q_offset,
    ragged tiles, every supported head dim."""
    cases = [  # (batch, seq_q, seq_k, heads, head_dim, causal, block, q_off)
        (2, 256, 256, 4, 64, True, 64, 0),
        (2, 256, 256, 4, 64, False, 64, 0),
        (2, 128, 256, 3, 32, True, 64, 128),
        (2, 80, 80, 2, 16, True, 16, 0),
        (1, 192, 192, 2, 128, False, 64, 0),
    ]
    gen = torch.Generator().manual_seed(1)
    for batch, seq_q, seq_k, heads, hd, causal, block, q_off in cases:
        q, do = (torch.randn((batch, seq_q, heads, hd), generator=gen)
                 .cuda() for _ in range(2))
        k, v = (torch.randn((batch, seq_k, heads, hd), generator=gen)
                .cuda() for _ in range(2))
        args = (causal, hd ** -0.5, block, block, q_off)
        o_ref, lse_ref = pa.flash_fwd_plain(q, k, v, *args)
        o, lse = pa.flash_fwd(q, k, v, *args)
        what = (f"f32 [{batch},{seq_q}/{seq_k},{heads},{hd}] causal={causal}"
                f" q_offset={q_off}")
        errs = [assert_close(torch, o, o_ref, TOL["torch.float32"],
                             f"K1 O {what}"),
                assert_close(torch, lse, lse_ref, TOL["torch.float32"],
                             f"K1 lse {what}")]
        delta = pa.row_delta(o_ref, do)
        errs.append(assert_close(
            torch, pa.flash_bwd_dq(q, k, v, do, lse_ref, delta, *args),
            pa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, *args),
            GRAD_TOL_F32, f"K2 dQ {what}"))
        for got, want, name in zip(
                pa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, *args),
                pa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, *args),
                ("dK", "dV")):
            errs.append(assert_close(torch, got, want, GRAD_TOL_F32,
                                     f"K3 {name} {what}"))
        log(f"[kernel] {what}: max abs err {max(errs):.3e} "
            f"(tol fwd 2e-5, grads 5e-4)")


def phase_model_f32(torch, hvd_models):
    """A small float32 TransformerLM on the card: flash kernels against the
    dense backend, same weights, logits and every gradient."""
    cfg = dict(vocab_size=512, num_layers=2, num_heads=2, d_model=128,
               d_ff=512, max_seq_len=256, dtype=torch.float32)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 512, (2, 256), generator=gen).cuda()
    outs = []
    for attention in ("dense", "flash"):
        model = hvd_models.TransformerLM(
            **cfg, attention=attention,
            generator=torch.Generator().manual_seed(3)).cuda()
        logits = model(tokens)
        hvd_models.lm_loss(logits, tokens).backward()
        outs.append((logits.detach(),
                     {n: p.grad for n, p in model.named_parameters()}))
    (ld, gd), (lf, gf) = outs
    err = assert_close(torch, lf, ld, (1e-4, 1e-4), "model logits")
    for name in gd:
        err = max(err, assert_close(torch, gf[name], gd[name], (1e-3, 1e-5),
                                    f"model grad {name}"))
    log(f"[model] f32 TransformerLM flash kernels vs dense: max abs err "
        f"{err:.3e} (tol logits 1e-4, grads rtol 1e-3 atol 1e-5)")


def phase_main_path(torch, pa, lm_bench, card):
    """The LM benchmark's own entry point at full width, counters from 0."""
    steps = WARMUP + PER_ITER * ITERS
    defaults = lm_bench._parse_args([])
    layers = defaults.num_layers
    pa.reset_launch_counts()
    result = lm_bench.main(["--num-warmup-batches", str(WARMUP),
                            "--num-batches-per-iter", str(PER_ITER),
                            "--num-iters", str(ITERS)])
    counts = pa.launch_counts()
    tc = pa.tc_launch_counts()
    log(f"[slice] launches {counts} over {steps} steps of {layers} layers; "
        f"tensor-core {tc}")
    for name, count in counts.items():
        check(count == layers * steps,
              f"{name} launched {count} times, want {layers} x {steps}")
    for name, count in tc.items():
        check(count == counts[name],
              f"{name}: {count} of {counts[name]} launches took the "
              "tensor-core variant, want all")
    losses = result["losses"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"losses not finite: {losses}")
    check(abs(losses[0] - math.log(defaults.vocab_size)) < 1.0,
          f"first loss {losses[0]:.4f} is not near ln(vocab)")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    d = defaults
    log(f"[slice] TransformerLM {d.num_layers}L/{d.num_heads}H/d{d.d_model}/"
        f"ff{d.d_ff} vocab {d.vocab_size} seq {d.seq_len} batch "
        f"{d.batch_size}, {d.attention}, DistributedOptimizer(AdamW), NCCL "
        f"world 1: "
        f"{result['value']:.1f} tokens/s, step {result['step_ms']:.3f} ms, "
        f"peak {result['peak_mem_gib']:.3f} GiB, MFU "
        f"{result['mfu_vs_h100_bf16_peak']:.4f}, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} | {card}")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one",
              file=sys.stderr)
        return 1
    try:
        import horovod_tpu_torch.models as hvd_models
        from horovod_tpu_torch.benchmarks import lm_bench
        from horovod_tpu_torch.ops import _build
        from horovod_tpu_torch.ops import flash_attention as pa
    except ImportError as exc:
        print(f"chip_smoke: the horovod_tpu_torch package is missing "
              f"({exc}); run from the repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {len(_build.KERNELS)} kernels built in {built:.1f} s "
        f"(one nvcc each, in parallel; 0 when already built)")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    res = phase_slice_kernels(torch, pa, card)
    phase_small_bf16(torch, pa)
    phase_small_f32(torch, pa)
    phase_model_f32(torch, hvd_models)
    counts = phase_main_path(torch, pa, lm_bench, card)

    kernels = [dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=counts[name], **res[name], card=card)
               for name, source, replaces in KERNELS]
    log(f"[done] {time.perf_counter() - t0:.1f} s | {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
