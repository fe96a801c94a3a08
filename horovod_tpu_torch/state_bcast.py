"""Parameter / optimizer-state broadcast: every rank starts from root's state.

Port of ``horovod_tpu/state_bcast.py`` and of the torch front-end's
``broadcast_parameters``/``broadcast_optimizer_state``
(``horovod_tpu/torch/__init__.py:374-460``; the reference's
``horovod/torch/__init__.py:200-348``). Tensors are overwritten in place.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from . import basics, ops


def broadcast_object(obj: Any, root_rank: int = 0) -> Any:
    """Return root's ``obj`` (any picklable object) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank, device=basics.device())
    return box[0]


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Overwrite a ``state_dict`` or an iterable of ``(name, tensor)`` with
    root's values, in place. A dict goes in sorted key order, so every rank
    issues the same broadcasts."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else list(params)
    handles = [ops.broadcast_async_(p, root_rank)
               for _, p in items if isinstance(p, torch.Tensor)]
    for handle in handles:
        ops.synchronize(handle)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Give every rank root's optimizer hyperparameters and state.

    Root's state structure goes first (``broadcast_object``) and every rank
    conforms to it before any tensor broadcast: a rank with empty state
    (a fresh optimizer) gets zeros of root's shapes, entries root lacks are
    dropped, so all ranks issue the same broadcasts in the same order."""
    state_dict = optimizer.state_dict()
    meta = None
    if basics.rank() == root_rank:
        meta = {"param_groups": state_dict["param_groups"], "state": {}}
        for pid, pstate in state_dict["state"].items():
            meta["state"][pid] = {
                key: ("tensor", tuple(value.shape), value.dtype,
                      value.device.type)
                if isinstance(value, torch.Tensor) else ("scalar", value)
                for key, value in pstate.items()}
    meta = broadcast_object(meta, root_rank)

    new_state: dict = {}
    for pid, specs in meta["state"].items():
        entry: dict = {}
        for key, spec in specs.items():
            if spec[0] == "scalar":
                entry[key] = spec[1]
                continue
            _, shape, dtype, device_type = spec
            local = state_dict["state"].get(pid, {}).get(key)
            if isinstance(local, torch.Tensor) and \
                    tuple(local.shape) == shape and local.dtype == dtype:
                entry[key] = local
            else:
                # root's device kind: a CPU step counter stays on the CPU,
                # moments go to this rank's device
                device = "cpu" if device_type == "cpu" else basics.device()
                entry[key] = torch.zeros(shape, dtype=dtype, device=device)
        new_state[pid] = entry

    handles = [
        ops.broadcast_async_(new_state[pid][key], root_rank)
        for pid in sorted(new_state)
        for key in sorted(k for k, s in meta["state"][pid].items()
                          if s[0] == "tensor")]
    for handle in handles:
        ops.synchronize(handle)

    state_dict["state"] = new_state
    for group, group_meta in zip(state_dict["param_groups"],
                                 meta["param_groups"]):
        for key, value in group_meta.items():
            if key != "params":
                group[key] = value
    optimizer.load_state_dict(state_dict)
