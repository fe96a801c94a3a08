"""Attention over whole sequences: the dense reference.

Port of ``horovod_tpu/parallel/ring_attention.py:dense_attention``, the
model's ``attention="dense"`` backend and the oracle of the flash kernels.
Ring and Ulysses sequence-parallel attention are not ported yet (ROADMAP
Queue 1, M19); their entry points raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_M19 = ("{} is not ported yet: sequence-parallel attention waits for "
        "ROADMAP Queue 1, M19 (ring/Ulysses attention)")


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention in float32, [batch, seq, heads, head_dim]; the result
    in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        t, u = q.shape[1], k.shape[1]
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(u, device=q.device)[None, :])
        s = torch.where(mask, s, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, v.float())
    return out.to(q.dtype)


def ring_attention(*args, **kwargs):
    raise NotImplementedError(_M19.format("ring_attention"))


def ulysses_attention(*args, **kwargs):
    raise NotImplementedError(_M19.format("ulysses_attention"))
