"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The JAX package ``horovod_tpu`` is the reference; this package redoes it
in PyTorch for NVIDIA Hopper, slice by slice (ROADMAP.md), and imports
neither JAX nor ``horovod_tpu``. This slice: the process basics over a
``torch.distributed`` group, eager collectives, ``DistributedOptimizer``,
state broadcast, and the flash-attention Transformer LM whose three
attention kernels are hand-written CUDA (``csrc/``).

    import horovod_tpu_torch as hvd
    hvd.init()                      # cuda:{local_rank}; device="cpu" on request
    model = hvd.models.TransformerLM(...).to(hvd.device())
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()),
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
"""

from . import models, parallel
from .basics import (config, cross_rank, cross_size, device, init,
                     is_initialized, local_rank, local_size, rank, shutdown,
                     size)
from .ops import (allgather, allgather_async, allreduce, allreduce_,
                  allreduce_async, allreduce_async_, broadcast, broadcast_,
                  broadcast_async, broadcast_async_, poll, synchronize)
from .ops.flash_attention import flash_attention
from .optimizers import DistributedOptimizer
from .state_bcast import (broadcast_object, broadcast_optimizer_state,
                          broadcast_parameters)

__all__ = [
    "init", "shutdown", "is_initialized", "config", "device",
    "rank", "size", "local_rank", "local_size", "cross_rank", "cross_size",
    "allreduce", "allreduce_async", "allreduce_", "allreduce_async_",
    "allgather", "allgather_async",
    "broadcast", "broadcast_async", "broadcast_", "broadcast_async_",
    "poll", "synchronize",
    "DistributedOptimizer",
    "broadcast_parameters", "broadcast_optimizer_state", "broadcast_object",
    "flash_attention", "models", "parallel",
]
