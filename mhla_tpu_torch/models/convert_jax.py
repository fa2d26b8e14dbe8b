"""Weight bridges from the JAX package's flax param trees to this package's
state dicts: ``MHLAForCausalLM`` and ``WanModel``.

The flax trees (as nested dicts of numpy arrays) name every parameter as
this package does, so a bridge is a rename plus transposes: a flax
``Dense`` kernel is [in, out] and ``nn.Linear.weight`` is [out, in]; a
flax 3-D ``Conv`` kernel is [kd, kh, kw, in, out] and ``nn.Conv3d.weight``
is [out, in, kd, kh, kw].
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


def wan_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params of the JAX ``WanModel`` (``{"params": ...}`` or the inner
    tree) -> float32 state dict for this package's ``WanModel`` of the same
    config. ``blocks_<i>`` becomes ``blocks.<i>``; every ``kernel`` becomes
    a transposed ``weight``; biases, norm weights, ``modulation``,
    ``head_modulation`` and a trainable ``block_attn`` keep their names. The
    softmax layers need nothing of their own: ``self_attn.{q,k,v,o}`` and
    ``norm_q``/``norm_k`` are named alike in both packages."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, value in tree.items():
            name = key.replace("blocks_", "blocks.") if key.startswith("blocks_") else key
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
            elif key == "kernel":
                w = _t(value)
                sd[f"{prefix}weight"] = (
                    w.permute(4, 3, 0, 1, 2) if w.ndim == 5 else w.T
                ).contiguous()
            else:
                sd[f"{prefix}{name}"] = _t(value)

    walk(params.get("params", params), "")
    return sd
