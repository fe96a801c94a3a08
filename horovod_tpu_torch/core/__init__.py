"""Runtime core of the port: knobs, logging, topology, device choice."""

from .config import Config
from .logging import LOG
from .platform import resolve_device
from .topology import Topology, discover


class NotInitializedError(ValueError):
    """Raised when the world is queried before ``init()``, with the
    reference's wording (``common/__init__.py``)."""

    def __init__(self) -> None:
        super().__init__(
            "Horovod has not been initialized; use hvd.init().")


__all__ = ["Config", "LOG", "NotInitializedError", "Topology", "discover",
           "resolve_device"]
