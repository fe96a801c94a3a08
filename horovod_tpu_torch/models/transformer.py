"""Decoder-only Transformer LM with the dense and flash attention backends.

Port of ``horovod_tpu/models/transformer.py`` as ``nn.Module``s. The
numerics follow the Flax modules, with explicit casts (no autocast):

* parameters are float32; ``Dense``/``Embed``/``LayerNorm`` compute and
  return ``dtype`` (bf16 at the benchmark width), as Flax's
  ``DenseGeneral``/``Dense``/``Embed`` with ``dtype=`` do;
* ``LayerNorm`` is Flax's: epsilon 1e-6, statistics in float32 with the
  fast variance E[x^2] - E[x]^2 clipped at 0;
* the MLP's GELU is the tanh approximation (``flax.linen.gelu``);
* the attention output is cast to ``dtype`` before ``out``; ``lm_head``
  computes in float32 and the logits are float32.

Weights are laid out the torch way (``weight`` is [out, in]);
``models/convert.py`` maps the Flax parameter tree onto them. The
embedding gathers float32 rows and then casts, which gives the values of
Flax's cast-then-gather; its gradient sums repeated tokens in float32.

Sequence-parallel backends (``ring``, ``ulysses``) and per-block
rematerialization are not ported yet (ROADMAP Queue 1, M19).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import (dense_attention, ring_attention,
                                       ulysses_attention)

ATTENTION_BACKENDS = ("dense", "flash", "ring", "ulysses")
# jax.nn.initializers.truncated_normal's stddev correction for a [-2, 2]
# truncation: lecun_normal draws std / this from the truncated normal
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """A linear layer (``weight`` [out, in], ``bias`` [out]) computing in
    ``dtype`` from float32 parameters."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        # lecun_normal (flax's default kernel init) and zero bias
        std = 1.0 / math.sqrt(self.in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        # flax's default_embed_init: variance_scaling(1, fan_in, normal)
        # with fan_in = num_embeddings
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[0]),
                                generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` (epsilon 1e-6, float32 statistics, fast
    variance), returning ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.compute_dtype = dtype
        self.eps = eps

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.compute_dtype)


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention over [B, T, d_model]."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 attention: str) -> None:
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.attention = attention
        self.dtype = dtype
        self.query = Dense(d_model, d_model, dtype)
        self.key = Dense(d_model, d_model, dtype)
        self.value = Dense(d_model, d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, d_model = x.shape
        heads = (self.num_heads, d_model // self.num_heads)
        q = self.query(x).view(batch, seq, *heads)
        k = self.key(x).view(batch, seq, *heads)
        v = self.value(x).view(batch, seq, *heads)  # each [B, T, H, Dh]
        if self.attention == "flash":
            out = flash_attention(q, k, v, causal=True)
        else:
            out = dense_attention(q, k, v, causal=True)
        return self.out(out.to(self.dtype).reshape(batch, seq, d_model))


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dtype: torch.dtype, attention: str) -> None:
        super().__init__()
        self.ln_attn = LayerNorm(d_model, dtype)
        self.attn = CausalSelfAttention(d_model, num_heads, dtype, attention)
        self.ln_mlp = LayerNorm(d_model, dtype)
        self.mlp_in = Dense(d_model, d_ff, dtype)
        self.mlp_out = Dense(d_ff, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x))
        h = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """GPT-style LM: token + learned position embeddings, N pre-LN blocks,
    untied output head. Returns float32 logits [B, T, vocab].

    Parameters are created on the CPU and drawn from ``generator`` (a
    seeded ``torch.Generator``; the default seed is 0), so a seed gives the
    same weights on every device; move the model with ``.to(device)``."""

    def __init__(self, vocab_size: int, num_layers: int = 4,
                 num_heads: int = 8, d_model: int = 256, d_ff: int = 1024,
                 max_seq_len: int = 2048, dtype: torch.dtype = torch.bfloat16,
                 attention: str = "dense", remat: bool = False,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if attention not in ATTENTION_BACKENDS:
            raise ValueError(f"attention must be one of {ATTENTION_BACKENDS}, "
                             f"got {attention!r}")
        if attention == "ring":
            ring_attention()
        if attention == "ulysses":
            ulysses_attention()
        if remat:
            raise NotImplementedError(
                "remat is not ported yet: per-block rematerialization waits "
                "for ROADMAP Queue 1, M19")
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_seq_len, d_model, dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, num_heads, d_ff, dtype, attention)
            for _ in range(num_layers))
        self.ln_final = LayerNorm(d_model, dtype)
        self.lm_head = Dense(d_model, vocab_size, torch.float32)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        x = self.tok_embed(tokens) + self.pos_embed(positions)
        for block in self.blocks:
            x = block(x)
        return self.lm_head(self.ln_final(x)).float()


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (shift-by-one), mean over B and T-1."""
    vocab = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, vocab).float(),
                           tokens[:, 1:].reshape(-1))
