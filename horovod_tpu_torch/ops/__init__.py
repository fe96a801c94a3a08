"""Collective ops: allreduce / allgather / broadcast, sync and async.

Port of the eager surface of ``horovod_tpu/ops/__init__.py`` (the
reference's ``horovod/torch/mpi_ops.py:73-438``): each ``*_async`` returns
an integer handle, ``poll`` says whether it finished and ``synchronize``
waits and returns the result; ``average=True`` divides the sum by the
world size. The collectives run on the process group of ``basics.init()``
(NCCL on the card, gloo on the CPU). There is no negotiation engine yet
(ROADMAP Queue 1, M3-M4), so tensors are not matched by name: every rank
must issue the same collectives in the same order.

A tensor on another device than the group's is copied there and the
result copied back; gloo reduces bfloat16/float16 in float32.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from .. import basics

_handle_ids = itertools.count()
_lock = threading.Lock()
# handle -> (the collective's work, a function returning the result)
_pending: Dict[int, Tuple[dist.Work, Callable[[], torch.Tensor]]] = {}


def _register(work: dist.Work, finish: Callable[[], torch.Tensor]) -> int:
    with _lock:
        handle = next(_handle_ids)
        _pending[handle] = (work, finish)
    return handle


def _wire(tensor: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``tensor`` on the group's device, in a dtype
    the backend reduces."""
    dev = basics.device()
    dtype = tensor.dtype
    if dev.type == "cpu" and dtype in (torch.bfloat16, torch.float16):
        dtype = torch.float32
    return tensor.detach().to(device=dev, dtype=dtype, copy=True,
                              memory_format=torch.contiguous_format)


def _check_in_place(tensor: torch.Tensor) -> bool:
    """True when the collective may run on ``tensor`` itself."""
    return (tensor.device == basics.device() and tensor.is_contiguous()
            and not (tensor.device.type == "cpu"
                     and tensor.dtype in (torch.bfloat16, torch.float16)))


def allreduce_async_(tensor: torch.Tensor, average: bool = True) -> int:
    """In-place: the result is written into ``tensor`` by ``synchronize``."""
    in_place = _check_in_place(tensor)
    buf = tensor.detach() if in_place else _wire(tensor)
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, async_op=True)

    def finish() -> torch.Tensor:
        if average:
            buf.div_(basics.size())
        if not in_place:
            with torch.no_grad():
                tensor.copy_(buf)
        return tensor

    return _register(work, finish)


def allreduce_async(tensor: torch.Tensor, average: bool = True) -> int:
    buf = _wire(tensor)
    work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, async_op=True)

    def finish() -> torch.Tensor:
        if average:
            buf.div_(basics.size())
        return buf.to(device=tensor.device, dtype=tensor.dtype)

    return _register(work, finish)


def allgather_async(tensor: torch.Tensor) -> int:
    """Concatenate every rank's tensor along dim 0; first dims may differ."""
    if tensor.dim() == 0:
        raise ValueError("allgather needs a tensor with a first dimension")
    buf = _wire(tensor)
    size = basics.size()
    dims = torch.tensor([buf.shape[0]], dtype=torch.int64, device=buf.device)
    all_dims = [torch.empty_like(dims) for _ in range(size)]
    dist.all_gather(all_dims, dims)
    counts = [int(d.item()) for d in all_dims]
    padded = buf.new_zeros((max(counts),) + tuple(buf.shape[1:]))
    padded[:buf.shape[0]] = buf
    outs = [torch.empty_like(padded) for _ in range(size)]
    work = dist.all_gather(outs, padded, async_op=True)

    def finish() -> torch.Tensor:
        out = torch.cat([o[:n] for o, n in zip(outs, counts)])
        return out.to(device=tensor.device, dtype=tensor.dtype)

    return _register(work, finish)


def broadcast_async_(tensor: torch.Tensor, root_rank: int) -> int:
    """In-place: root's value is written into ``tensor`` by
    ``synchronize``."""
    in_place = _check_in_place(tensor)
    buf = tensor.detach() if in_place else _wire(tensor)
    work = dist.broadcast(buf, src=root_rank, async_op=True)

    def finish() -> torch.Tensor:
        if not in_place:
            with torch.no_grad():
                tensor.copy_(buf)
        return tensor

    return _register(work, finish)


def broadcast_async(tensor: torch.Tensor, root_rank: int) -> int:
    buf = _wire(tensor)
    work = dist.broadcast(buf, src=root_rank, async_op=True)
    return _register(work, lambda: buf.to(device=tensor.device,
                                          dtype=tensor.dtype))


def poll(handle: int) -> bool:
    """True once the collective behind ``handle`` has finished."""
    with _lock:
        entry = _pending.get(handle)
    if entry is None:
        raise ValueError(f"unknown or already synchronized handle {handle}")
    return entry[0].is_completed()


def synchronize(handle: int) -> torch.Tensor:
    """Wait for ``handle`` and return its result."""
    with _lock:
        entry = _pending.pop(handle, None)
    if entry is None:
        raise ValueError(f"unknown or already synchronized handle {handle}")
    work, finish = entry
    work.wait()
    return finish()


def allreduce(tensor: torch.Tensor, average: bool = True) -> torch.Tensor:
    return synchronize(allreduce_async(tensor, average))


def allreduce_(tensor: torch.Tensor, average: bool = True) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, average))


def allgather(tensor: torch.Tensor) -> torch.Tensor:
    return synchronize(allgather_async(tensor))


def broadcast(tensor: torch.Tensor, root_rank: int) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank))


def broadcast_(tensor: torch.Tensor, root_rank: int) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank))


__all__ = [
    "allreduce", "allreduce_async", "allreduce_", "allreduce_async_",
    "allgather", "allgather_async",
    "broadcast", "broadcast_async", "broadcast_", "broadcast_async_",
    "poll", "synchronize",
]
