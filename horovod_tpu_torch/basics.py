"""Process-level basics: init / shutdown / rank / size / local ranks.

Port of the JAX package's ``basics.py`` (the reference's ``HorovodBasics``,
``horovod/common/__init__.py:51-154``). ``init()`` reads the world from the
launcher env and sets up one ``torch.distributed`` process group: NCCL on
the card, gloo on the CPU. That group carries every collective of
``horovod_tpu_torch.ops``; there is no negotiation engine in this port yet
(ROADMAP Queue 1, M3-M4).

A world of one needs no rendezvous and uses an in-process ``HashStore``.
A larger world meets at ``HOROVOD_CONTROLLER_ADDR:HOROVOD_CONTROLLER_PORT``,
where rank 0 hosts a ``TCPStore``.
"""

from __future__ import annotations

import atexit
import threading
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

from .core import (LOG, Config, NotInitializedError, Topology, discover,
                   resolve_device)
from .core import config as _config

_RENDEZVOUS_TIMEOUT = timedelta(seconds=120)


class _GlobalState:
    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.initialized = False
        self.topology: Optional[Topology] = None
        self.config: Optional[Config] = None
        self.device: Optional[torch.device] = None


_global = _GlobalState()


def _store(cfg: Config, topo: Topology) -> dist.Store:
    if topo.size == 1:
        return dist.HashStore()
    if cfg.controller_port <= 0:
        raise ValueError(
            f"a world of {topo.size} processes needs "
            f"{_config.HOROVOD_CONTROLLER_PORT} (and "
            f"{_config.HOROVOD_CONTROLLER_ADDR}) to meet at")
    return dist.TCPStore(cfg.controller_addr, cfg.controller_port,
                         world_size=topo.size, is_master=topo.rank == 0,
                         timeout=_RENDEZVOUS_TIMEOUT)


def init(device: Optional[Union[str, torch.device]] = None) -> None:
    """Initialize the world. Idempotent while initialized; allowed again
    after ``shutdown()``.

    ``device=None`` drives this rank's card (``cuda:{local_rank}``) and
    raises when there is none; ``device="cpu"`` runs the world on the CPU
    over gloo."""
    with _global.lock:
        if _global.initialized:
            return
        cfg = Config.from_env()
        topo = discover()
        dev = resolve_device(device, topo.local_rank)
        if dist.is_initialized():
            raise RuntimeError(
                "a torch.distributed default process group already exists; "
                "horovod_tpu_torch.init() sets up its own")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=_store(cfg, topo),
                                rank=topo.rank, world_size=topo.size,
                                timeout=_RENDEZVOUS_TIMEOUT)
        _global.config, _global.topology, _global.device = cfg, topo, dev
        _global.initialized = True
        LOG.debug("horovod_tpu_torch initialized: rank=%d size=%d "
                  "local_rank=%d device=%s backend=%s", topo.rank, topo.size,
                  topo.local_rank, dev, backend)


def shutdown() -> None:
    """Destroy the process group; ``init()`` may run again afterwards."""
    with _global.lock:
        if not _global.initialized:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        _global.initialized = False
        _global.topology = None
        _global.config = None
        _global.device = None


atexit.register(shutdown)


def is_initialized() -> bool:
    return _global.initialized


def _topology() -> Topology:
    topo = _global.topology
    if topo is None:
        raise NotInitializedError()
    return topo


def config() -> Config:
    cfg = _global.config
    if cfg is None:
        raise NotInitializedError()
    return cfg


def device() -> torch.device:
    """The device this rank's collectives and models run on."""
    dev = _global.device
    if dev is None:
        raise NotInitializedError()
    return dev


def rank() -> int:
    return _topology().rank


def size() -> int:
    return _topology().size


def local_rank() -> int:
    return _topology().local_rank


def local_size() -> int:
    return _topology().local_size


def cross_rank() -> int:
    return _topology().cross_rank


def cross_size() -> int:
    return _topology().cross_size
