"""Leveled logging selected by ``HOROVOD_LOG_LEVEL``.

The reference logger (``horovod/common/logging.{h,cc}``) on the stdlib
``logging`` module: levels TRACE..FATAL, default WARNING, timestamps
hidden by ``HOROVOD_LOG_HIDE_TIME``. Same format as the JAX package's
logger, under its own logger name.
"""

from __future__ import annotations

import logging as _pylogging
import os
import sys

from .config import HOROVOD_LOG_HIDE_TIME, HOROVOD_LOG_LEVEL, _env_bool

TRACE = 5
_pylogging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": _pylogging.DEBUG,
    "info": _pylogging.INFO,
    "warning": _pylogging.WARNING,
    "error": _pylogging.ERROR,
    "fatal": _pylogging.CRITICAL,
}


def min_log_level_from_env() -> int:
    raw = os.environ.get(HOROVOD_LOG_LEVEL, "warning").strip().lower()
    return _LEVELS.get(raw, _pylogging.WARNING)


def _build_logger() -> _pylogging.Logger:
    logger = _pylogging.getLogger("horovod_tpu_torch")
    logger.setLevel(min_log_level_from_env())
    if not logger.handlers:
        handler = _pylogging.StreamHandler(sys.stderr)
        if _env_bool(HOROVOD_LOG_HIDE_TIME):
            fmt = "[%(levelname)s] %(message)s"
        else:
            fmt = "%(asctime)s [%(levelname)s] %(message)s"
        handler.setFormatter(_pylogging.Formatter(fmt))
        logger.addHandler(handler)
    logger.propagate = False
    return logger


LOG = _build_logger()
