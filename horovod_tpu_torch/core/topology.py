"""World topology: rank, size, local and cross ranks.

The reference derives these from MPI communicators
(``horovod/common/operations.cc:1728-1797``). The JAX package reads the
launcher env and falls back to the JAX runtime. The port reads the
launcher env only (``HOROVOD_RANK``/``HOROVOD_SIZE``/...), and a process
with no launcher env is rank 0 of a world of size 1. One rank is one
process driving one card, as in the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import config as _config


@dataclass(frozen=True)
class Topology:
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def discover() -> Topology:
    env = os.environ
    if _config.HOROVOD_RANK not in env or _config.HOROVOD_SIZE not in env:
        return Topology(rank=0, size=1, local_rank=0, local_size=1,
                        cross_rank=0, cross_size=1)
    rank = int(env[_config.HOROVOD_RANK])
    size = int(env[_config.HOROVOD_SIZE])
    if size < 1 or not 0 <= rank < size:
        raise ValueError(
            f"{_config.HOROVOD_RANK}={rank} is not a rank of a world of "
            f"{_config.HOROVOD_SIZE}={size}")
    local_rank = int(env.get(_config.HOROVOD_LOCAL_RANK, 0))
    local_size = int(env.get(_config.HOROVOD_LOCAL_SIZE, 1))
    return Topology(
        rank=rank,
        size=size,
        local_rank=local_rank,
        local_size=local_size,
        cross_rank=int(env.get(_config.HOROVOD_CROSS_RANK,
                               rank // max(local_size, 1))),
        cross_size=int(env.get(_config.HOROVOD_CROSS_SIZE,
                               size // max(local_size, 1))),
    )
