"""Weight bridge from the JAX package's flax param tree to this package's
``MHLAForCausalLM`` state dict.

The flax tree (as nested dicts of numpy arrays) names every parameter as
this package does, so the bridge is a rename plus transposes: a flax
``Dense`` kernel is [in, out] and ``nn.Linear.weight`` is [out, in].
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .gla_lm import MHLALMConfig

_ATTN_DENSE = ("q_proj", "k_proj", "v_proj", "g_proj", "o_proj")
_MLP_DENSE = ("gate_proj", "up_proj", "down_proj")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def params_from_jax(params: Mapping[str, Any], cfg: MHLALMConfig) -> Dict[str, torch.Tensor]:
    """flax params (``{"params": {"model": ...}}`` or the inner tree) ->
    float32 state dict for ``MHLAForCausalLM(cfg)``."""
    tree = params.get("params", params)
    model = tree["model"]
    sd: Dict[str, torch.Tensor] = {
        "model.embeddings.weight": _t(model["embeddings"]["embedding"]),
        "model.norm.weight": _t(model["norm"]["weight"]),
    }
    for i in range(cfg.num_hidden_layers):
        src = model[f"layers_{i}"]
        dst = f"model.layers.{i}."
        attn = src["attn"]
        for name in _ATTN_DENSE:
            if name in attn:
                sd[f"{dst}attn.{name}.weight"] = _t(attn[name]["kernel"]).T.contiguous()
        n = cfg.num_slots
        sd[f"{dst}attn.mixing_matrix"] = _t(attn["mixing_matrix"]).reshape(n, n)
        for norm in ("g_norm_swish_gate", "g_norm"):
            if norm in attn:
                sd[f"{dst}attn.{norm}.weight"] = _t(attn[norm]["weight"])
        for name in _MLP_DENSE:
            sd[f"{dst}mlp.{name}.weight"] = _t(src["mlp"][name]["kernel"]).T.contiguous()
        sd[f"{dst}attn_norm.weight"] = _t(src["attn_norm"]["weight"])
        sd[f"{dst}mlp_norm.weight"] = _t(src["mlp_norm"]["weight"])
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = _t(tree["lm_head"]["kernel"]).T.contiguous()
    return sd
