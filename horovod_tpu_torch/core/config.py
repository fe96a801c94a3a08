"""Runtime configuration knobs, all environment variables.

Horovod reads every runtime knob from the environment
(``horovod/common/operations.cc:1825-1909``). The port keeps the same
``HOROVOD_*`` names and defaults as the JAX package's ``core/config.py``,
and carries only the knobs that the ported code reads. Further knobs come
with the modules that read them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_LOG_HIDE_TIME = "HOROVOD_LOG_HIDE_TIME"

# Launcher -> rank plumbing (the role of mpirun's env in the reference).
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
# Rendezvous of a multi-process world: rank 0 hosts the process group's
# TCP store here, every other rank dials it.
HOROVOD_CONTROLLER_ADDR = "HOROVOD_CONTROLLER_ADDR"
HOROVOD_CONTROLLER_PORT = "HOROVOD_CONTROLLER_PORT"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024  # operations.cc:1838
DEFAULT_CONTROLLER_ADDR = "127.0.0.1"


def _env_bool(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


@dataclass(frozen=True)
class Config:
    """Snapshot of the knobs, taken once at ``init()``."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    controller_addr: str = DEFAULT_CONTROLLER_ADDR
    controller_port: int = 0

    @staticmethod
    def from_env() -> "Config":
        return Config(
            fusion_threshold_bytes=_env_int(
                HOROVOD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES),
            controller_addr=os.environ.get(
                HOROVOD_CONTROLLER_ADDR, DEFAULT_CONTROLLER_ADDR),
            controller_port=_env_int(HOROVOD_CONTROLLER_PORT, 0),
        )
