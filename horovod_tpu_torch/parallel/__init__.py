"""Attention backends of the port (sequence parallelism comes with M19)."""

from .ring_attention import dense_attention, ring_attention, ulysses_attention

__all__ = ["dense_attention", "ring_attention", "ulysses_attention"]
