"""Carry Flax ``TransformerLM`` parameters over to the port's modules.

The Flax tree (``horovod_tpu.models.TransformerLM``) and the port's
``state_dict`` name and lay out the same weights differently:

=========================================  ====================================
Flax                                       port
=========================================  ====================================
``tok_embed/embedding`` [V, d]             ``tok_embed.weight`` [V, d]
``pos_embed/embedding`` [S, d]             ``pos_embed.weight`` [S, d]
``block_i/attn/{query,key,value}/kernel``  ``blocks.i.attn.{...}.weight``
[d, H, Dh]                                 [H*Dh, d] (reshaped, transposed)
``block_i/attn/{query,key,value}/bias``    ``blocks.i.attn.{...}.bias`` [H*Dh]
[H, Dh]
``block_i/attn/out/kernel`` [H, Dh, d]     ``blocks.i.attn.out.weight``
                                           [d, H*Dh]
``.../kernel`` of a ``Dense`` [in, out]    ``.../weight`` [out, in]
``ln_*/scale``, ``ln_*/bias``              ``ln_*.weight``, ``ln_*.bias``
=========================================  ====================================

Input arrays are anything ``numpy.asarray`` takes; the result holds
float32 CPU tensors for ``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(prefix: str, tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
    kernel = np.asarray(tree["kernel"], dtype=np.float32)
    if kernel.ndim == 3 and prefix.endswith(".out"):
        kernel = kernel.reshape(-1, kernel.shape[-1])   # [H, Dh, d]
    else:
        kernel = kernel.reshape(kernel.shape[0], -1)    # [d, H, Dh] / [in, out]
    out[f"{prefix}.weight"] = _t(kernel.T)
    out[f"{prefix}.bias"] = _t(np.asarray(tree["bias"]).reshape(-1))


def _norm(prefix: str, tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def from_flax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a Flax ``TransformerLM`` parameter tree (or its variables dict
    with a ``"params"`` key) onto the port's ``state_dict`` names."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {
        "tok_embed.weight": _t(params["tok_embed"]["embedding"]),
        "pos_embed.weight": _t(params["pos_embed"]["embedding"]),
    }
    layers = sorted(int(name.split("_", 1)[1]) for name in params
                    if name.startswith("block_"))
    if layers != list(range(len(layers))):
        raise ValueError(f"block names are not block_0..block_N: {layers}")
    for i in layers:
        block = params[f"block_{i}"]
        pre = f"blocks.{i}"
        for name in ("query", "key", "value", "out"):
            _dense(f"{pre}.attn.{name}", block["attn"][name], out)
        _norm(f"{pre}.ln_attn", block["ln_attn"], out)
        _norm(f"{pre}.ln_mlp", block["ln_mlp"], out)
        _dense(f"{pre}.mlp_in", block["mlp_in"], out)
        _dense(f"{pre}.mlp_out", block["mlp_out"], out)
    _norm("ln_final", params["ln_final"], out)
    _dense("lm_head", params["lm_head"], out)
    return out
