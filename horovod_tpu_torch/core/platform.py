"""Device choice: the card by default, the CPU only on request.

The JAX package pins a JAX platform; the port picks a ``torch.device``.
A rank drives ``cuda:{local_rank}``. The CPU is used only when the caller
asks for it (the tests do); without a card and without that request the
entry points raise rather than run quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]],
                   local_rank: int = 0) -> torch.device:
    """``None`` means this rank's card; ``"cpu"``/``"cuda[:i]"`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
