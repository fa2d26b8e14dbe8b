"""Weight bridges from the JAX package's flax param trees to this package's
state dicts: ``MHLAForCausalLM``, ``WanModel``, ``MHLAViT``, ``DiT``,
``T5Encoder`` and ``WanVAE``.

The flax trees (as nested dicts of numpy arrays) name every parameter as
this package does, so a bridge is a rename plus transposes: a flax
``Dense`` kernel is [in, out] and ``nn.Linear.weight`` is [out, in]; a
flax ``Conv`` kernel is [k..., in, out] and a torch convolution's weight
is [out, in, k...] (a depthwise kernel [k..., 1, C] becomes [C, 1, k...]);
a flax ``Embed``'s ``embedding`` is ``nn.Embedding.weight`` as it is.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .gla_lm import MHLALMConfig

_ATTN_DENSE = ("q_proj", "k_proj", "v_proj", "g_proj", "o_proj", "a_proj", "b_proj",
               "gk_proj", "gk_proj_low", "gk_proj_up", "in_proj", "out_proj", "x_proj",
               "dt_proj")
_ATTN_CONV = ("q_conv1d", "k_conv1d", "v_conv1d", "conv1d")
_MLP_DENSE = ("gate_proj", "up_proj", "down_proj")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def params_from_jax(params: Mapping[str, Any], cfg: MHLALMConfig) -> Dict[str, torch.Tensor]:
    """flax params (``{"params": {"model": ...}}`` or the inner tree) ->
    float32 state dict for ``MHLAForCausalLM(cfg)``, MHLA, softmax
    (``SelfAttention``: q/k/v/o projections, their biases, q/k norms),
    Gated DeltaNet (its a/b projections, ``A_log``, ``dt_bias`` and
    ``o_norm``), GLA (the gate projections ``gk_proj`` or ``gk_proj_low`` /
    ``gk_proj_up`` with its bias, and ``g_norm_swish_gate`` or ``g_norm``),
    Mamba2 (``in_proj``, ``conv1d``, ``A_log``, ``dt_bias``, ``D``,
    ``norm``, ``out_proj``), Mamba (``in_proj``, ``conv1d`` with its bias,
    ``x_proj``, ``dt_proj`` with its bias, ``A_log`` [Dm, N], ``D``,
    ``out_proj``) and linear-attention layers (q/k/v/o projections) alike.
    Short-convolution kernels ([kernel_size, features], in both packages)
    are copied as they are."""
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
                if "bias" in attn[name]:  # a softmax layer's qkv bias, GLA's gk_proj_up
                    sd[f"{dst}attn.{name}.bias"] = _t(attn[name]["bias"])
        if "mixing_matrix" in attn:  # an MHLA layer
            n = cfg.num_slots
            sd[f"{dst}attn.mixing_matrix"] = _t(attn["mixing_matrix"]).reshape(n, n)
        for conv in _ATTN_CONV:
            if conv in attn:
                sd[f"{dst}attn.{conv}.weight"] = _t(attn[conv]["kernel"])
                if "bias" in attn[conv]:
                    sd[f"{dst}attn.{conv}.bias"] = _t(attn[conv]["bias"])
        for name in ("A_log", "dt_bias", "D"):  # Gated DeltaNet, Mamba2, Mamba
            if name in attn:
                sd[f"{dst}attn.{name}"] = _t(attn[name])
        for norm in ("g_norm_swish_gate", "g_norm", "q_norm", "k_norm", "o_norm", "norm"):
            if norm in attn:
                sd[f"{dst}attn.{norm}.weight"] = _t(attn[norm]["weight"])
        for name in _MLP_DENSE:
            sd[f"{dst}mlp.{name}.weight"] = _t(src["mlp"][name]["kernel"]).T.contiguous()
        sd[f"{dst}attn_norm.weight"] = _t(src["attn_norm"]["weight"])
        sd[f"{dst}mlp_norm.weight"] = _t(src["mlp_norm"]["weight"])
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = _t(tree["lm_head"]["kernel"]).T.contiguous()
    return sd


_NUMBERED = re.compile(r"^(blocks|downsamples|upsamples|middle)_(\d+)$")


def _state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params (``{"params": ...}`` or the inner tree) -> float32 state
    dict for this package's model of the same config. A numbered module
    (``blocks_<i>``, the VAE's ``downsamples_<i>``, ``upsamples_<i>`` and
    ``middle_<i>``) becomes an entry of a list (``blocks.<i>``); every
    ``kernel`` becomes a transposed ``weight``: Dense
    [in, out] -> [out, in], Conv [k..., in, out] -> [out, in, k...] (the
    patch convolutions [p, p, Cin, D] -> [D, Cin, p, p], the LePE kernels
    [k..., 1, C] -> [C, 1, k...]); every ``embedding`` becomes a ``weight``
    (DiT's label table); other leaves keep their names (biases, norm weights,
    ``pos_embed``, Wan's ``modulation`` and ``head_modulation``, a trainable
    mixing matrix). Fixed mixing matrices are in neither tree, and the Wan
    softmax layers' ``self_attn.{q,k,v,o}`` and ``norm_q``/``norm_k`` are
    named alike in both packages."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, value in tree.items():
            name = _NUMBERED.sub(r"\1.\2", key)
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
            elif key == "kernel":
                w = _t(value)
                # [in, out] -> [out, in]; [k..., in, out] -> [out, in, k...]
                order = (1, 0) if w.ndim == 2 else (w.ndim - 1, w.ndim - 2, *range(w.ndim - 2))
                sd[f"{prefix}weight"] = w.permute(*order).contiguous()
            elif key == "embedding":
                sd[f"{prefix}weight"] = _t(value)
            else:
                sd[f"{prefix}{name}"] = _t(value)

    walk(params.get("params", params), "")
    return sd


# the JAX WanModel, MHLAViT, DiT, T5Encoder and WanVAE -> this package's models
# of the same names
wan_params_from_jax = vit_params_from_jax = dit_params_from_jax = _state_dict_from_flax
t5_params_from_jax = vae_params_from_jax = _state_dict_from_flax
