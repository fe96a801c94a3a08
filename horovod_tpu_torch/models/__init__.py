"""Models of the port: the Transformer LM and its Flax weight converter."""

from .convert import from_flax_params
from .transformer import ATTENTION_BACKENDS, TransformerLM, lm_loss

__all__ = ["ATTENTION_BACKENDS", "TransformerLM", "from_flax_params",
           "lm_loss"]
