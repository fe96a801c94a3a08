"""``DistributedOptimizer``: world-averaged gradients for a torch optimizer.

Port of ``horovod_tpu/torch/__init__.py:_DistributedOptimizer`` (the
reference's ``horovod/torch/__init__.py:60-198``), with the fusion of
``horovod_tpu/optimizers.py:allreduce_gradients`` (bucket-fused eager
allreduce) done here, since the port has no engine yet:

* the wrapper is a dynamic subclass of the user's optimizer class, so
  ``isinstance`` and ``state_dict`` behave as the inner optimizer's;
* gradients are fused into buckets of at most ``HOROVOD_FUSION_THRESHOLD``
  bytes, planned once from the parameters in reverse order (the order
  backward produces them); a per-parameter hook counts each gradient in,
  and a bucket whose gradients are all in is packed and its one async
  allreduce fires during backward. Buckets fire strictly in plan order, so
  every rank issues the same collectives in the same order;
* ``backward_passes_per_step`` accumulates that many backward passes
  locally before a gradient counts in (``torch/__init__.py:114-130``);
* ``synchronize()`` fires what is left (a parameter with no gradient
  contributes zeros, as ``test_force_allreduce`` requires), waits, and
  installs the averages; ``step()`` is ``synchronize()`` + the inner step.

The hooks run at every world size, a world of one included, so the path
is the same on one card as on many.
"""

from __future__ import annotations

import weakref
from typing import Dict, List

import torch

from . import basics, ops


def plan_buckets(params: List[torch.Tensor],
                 threshold_bytes: int) -> List[List[torch.Tensor]]:
    """Group ``params`` in order into buckets of one dtype and device and
    at most ``threshold_bytes`` (a larger tensor gets a bucket of its own;
    a threshold of 0 gives every tensor its own bucket)."""
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for p in params:
        nbytes = p.numel() * p.element_size()
        last = buckets[-1] if buckets else None
        if (last is None or size + nbytes > threshold_bytes
                or last[0].dtype != p.dtype or last[0].device != p.device):
            buckets.append([p])
            size = nbytes
        else:
            last.append(p)
            size += nbytes
    return buckets


class _DistributedOptimizer(torch.optim.Optimizer):
    _hvd_distributed = True

    def __init__(self, params, named_parameters,
                 backward_passes_per_step) -> None:
        # transplanted into a subclass of the user's optimizer class (see
        # DistributedOptimizer), so the two-argument super() is needed
        super(self.__class__, self).__init__(params)
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                (f"allreduce.noname.{i}", v)
                for group in self.param_groups
                for i, v in enumerate(group["params"])]
        names = [name for name, _ in named_parameters]
        dups = sorted({n for n in names if names.count(n) > 1})
        if dups:
            raise ValueError(
                f"Parameter names in named_parameters must be unique; "
                f"found duplicates: {dups}")
        self.backward_passes_per_step = backward_passes_per_step
        trainable = [p for group in self.param_groups
                     for p in group["params"] if p.requires_grad]
        self._buckets = plan_buckets(
            trainable[::-1], basics.config().fusion_threshold_bytes)
        self._bucket_of: Dict[torch.Tensor, int] = {
            p: i for i, bucket in enumerate(self._buckets) for p in bucket}
        self._delay = {p: backward_passes_per_step for p in trainable}
        self._ready = [0] * len(self._buckets)
        self._next_bucket = 0
        self._in_flight: List[tuple] = []  # (handle, flat, bucket)
        # the hooks hold the optimizer weakly: once it is dropped, a later
        # optimizer over the same parameters is not disturbed by them
        method = weakref.WeakMethod(self._hook)

        def hook(p: torch.Tensor) -> None:
            bound = method()
            if bound is not None:
                bound(p)

        for p in trainable:
            p.register_post_accumulate_grad_hook(hook)

    def _hook(self, p: torch.Tensor) -> None:
        if self._delay[p] <= 0:
            raise AssertionError(
                "Gradients were computed more than backward_passes_per_step "
                "times before call to step(). Increase "
                "backward_passes_per_step to accumulate gradients locally.")
        self._delay[p] -= 1
        if self._delay[p] == 0:
            self._ready[self._bucket_of[p]] += 1
            self._fire_ready_buckets()

    def _fire_ready_buckets(self) -> None:
        while (self._next_bucket < len(self._buckets)
               and self._ready[self._next_bucket]
               == len(self._buckets[self._next_bucket])):
            bucket = self._buckets[self._next_bucket]
            flat = torch.cat([p.grad.detach().reshape(-1) for p in bucket])
            self._in_flight.append(
                (ops.allreduce_async_(flat, average=True), flat, bucket))
            self._next_bucket += 1

    def synchronize(self) -> None:
        """Fire the buckets still pending, wait for every allreduce and
        install the averaged gradients."""
        for i in range(self._next_bucket, len(self._buckets)):
            for p in self._buckets[i]:
                if self._delay[p] > 0:
                    # no gradient arrived this step: a rank must not skip a
                    # collective the other ranks will wait on
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    self._delay[p] = 0
                    self._ready[i] += 1
        self._fire_ready_buckets()
        for handle, flat, bucket in self._in_flight:
            ops.synchronize(handle)
            offset = 0
            for p in bucket:
                n = p.numel()
                p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
                offset += n
        self._in_flight.clear()
        self._ready = [0] * len(self._buckets)
        self._next_bucket = 0
        for p in self._delay:
            self._delay[p] = self.backward_passes_per_step

    def step(self, closure=None):
        self.synchronize()
        return super(self.__class__, self).step(closure)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         backward_passes_per_step: int = 1):
    """Wrap ``optimizer`` so ``step()`` applies world-averaged gradients.
    Needs ``init()``. Wrapping a wrapped optimizer is refused."""
    if getattr(optimizer, "_hvd_distributed", False):
        raise ValueError("optimizer is already a DistributedOptimizer; wrap "
                         "the inner optimizer once")
    donor = {k: v for k, v in _DistributedOptimizer.__dict__.items()
             if k not in ("__dict__", "__weakref__")}
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,), donor)
    return cls(optimizer.param_groups, named_parameters,
               backward_passes_per_step)
