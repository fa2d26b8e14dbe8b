"""Wan2.1 checkpoint conversion: a reference torch state dict -> the numpy
param tree of the JAX package's ``WanModel`` (counterpart of
``mhla_tpu/models/convert_wan.py``), which ``wan_params_from_jax`` turns into
this package's state dict.

Softmax layers load fully. MHLA layers inherit the q/k/v/o projections and
the q/k norms of the original attention; their gate projection and
per-head output norm come from the checkpoint where it holds them (one
saved from the MHLA model) and else from a seeded init
(:func:`mhla_init_params`), as the reference's ``load_model_ckpt`` starts
them fresh.

Reference naming: ``patch_embedding``, ``text_embedding.{0,2}``,
``time_embedding.{0,2}``, ``time_projection.1``,
``blocks.{i}.{self_attn,cross_attn}.{q,k,v,o,norm_q,norm_k}``,
``blocks.{i}.norm3``, ``blocks.{i}.ffn.{0,2}``, ``blocks.{i}.modulation``,
``head.head``, ``head.modulation``; image-to-video adds
``blocks.{i}.cross_attn.{k_img,v_img,norm_k_img}`` and the image embedding
``img_emb.proj.{0,1,3,4}`` (LayerNorm, Linear, GELU, Linear, LayerNorm).

Not ported, raising ``NotImplementedError``: the MLLA layers' convolutions
(``mllalinear``, ``mllalepe``), whose models this package does not have.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..utils.safetensors_io import load_safetensors
from .wan import WanConfig, WanModel


def rope_feature_permutation(dim: int, num_heads: int) -> np.ndarray:
    """Per-head evens-then-odds feature permutation. The port applies 3-D
    RoPE in rotate-half form, the reference in the interleaved complex-pair
    form; the two agree once each head's q/k features (and their norms'
    weights) are reordered so that pair (2i, 2i+1) lands on (i, i + d/2)."""
    d = dim // num_heads
    per_head = np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])
    return np.concatenate([h * d + per_head for h in range(num_heads)])


def _lin(state, key, perm=None):
    """A torch Linear -> a flax Dense ([out, in] -> [in, out]); ``perm``
    reorders its output features."""
    kernel = np.asarray(state[key + ".weight"]).T
    out = {"kernel": kernel if perm is None else kernel[:, perm]}
    if key + ".bias" in state:
        bias = np.asarray(state[key + ".bias"])
        out["bias"] = bias if perm is None else bias[perm]
    return out


def _norm_w(state, key):
    return {"weight": np.asarray(state[key + ".weight"])}


def _layernorm(state, key):
    return {name: np.asarray(state[f"{key}.{name}"]) for name in ("weight", "bias")
            if f"{key}.{name}" in state}


def convert_wan_checkpoint(
    state: Dict[str, np.ndarray],
    cfg: WanConfig,
    init_params: Optional[Dict] = None,
) -> Dict:
    """A Wan2.1 torch state dict -> ``{"params": tree}`` in the JAX
    package's layout. ``init_params`` (``{"params": ...}``, e.g.
    :func:`mhla_init_params`) supplies the parameters the checkpoint lacks
    (the MHLA layers' gate and g_norm); without it a missing gate raises
    and a missing g_norm is ones."""
    fresh = (init_params or {}).get("params", {})
    params: Dict[str, Any] = {
        # Conv3d [out, in, kt, kh, kw] -> [kt, kh, kw, in, out]
        "patch_embedding": {
            "kernel": np.asarray(state["patch_embedding.weight"]).transpose(2, 3, 4, 1, 0),
            "bias": np.asarray(state["patch_embedding.bias"]),
        },
        "text_fc1": _lin(state, "text_embedding.0"),
        "text_fc2": _lin(state, "text_embedding.2"),
        "time_fc1": _lin(state, "time_embedding.0"),
        "time_fc2": _lin(state, "time_embedding.2"),
        "time_projection": _lin(state, "time_projection.1"),
        "head": _lin(state, "head.head"),
        "head_modulation": np.asarray(state["head.modulation"]),
    }

    perm = rope_feature_permutation(cfg.dim, cfg.num_heads)
    for i in range(cfg.num_layers):
        p = f"blocks.{i}."
        attn_type = cfg.layer_attn_type(i)
        if attn_type in ("mllalinear", "mllalepe"):
            raise NotImplementedError(f"layer {i}: attn_type {attn_type!r} is not ported")
        # q/k features reordered for the rotate-half RoPE; the q/k RMSNorm
        # runs over the full dim before the head split, so its weight follows
        self_attn: Dict[str, Any] = {
            "q": _lin(state, p + "self_attn.q", perm),
            "k": _lin(state, p + "self_attn.k", perm),
            "v": _lin(state, p + "self_attn.v"),
            "o": _lin(state, p + "self_attn.o"),
        }
        if cfg.qk_norm:
            for name in ("norm_q", "norm_k"):
                self_attn[name] = {
                    "weight": np.asarray(state[f"{p}self_attn.{name}.weight"])[perm]
                }
        if attn_type == "mhla_uni":
            fresh_attn = fresh.get(f"blocks_{i}", {}).get("self_attn", {})
            if p + "self_attn.g.weight" in state:
                self_attn["g"] = _lin(state, p + "self_attn.g")
            if p + "self_attn.g_norm.weight" in state:
                self_attn["g_norm"] = _norm_w(state, p + "self_attn.g_norm")
            for name in ("g", "g_norm"):
                if name in self_attn:
                    continue
                if name in fresh_attn:
                    self_attn[name] = fresh_attn[name]
                elif name == "g" and cfg.is_gated:
                    raise KeyError(f"blocks_{i}.self_attn.{name} missing: pass init_params")
                elif name == "g_norm":
                    self_attn[name] = {"weight": np.ones(cfg.dim // cfg.num_heads, np.float32)}

        blk: Dict[str, Any] = {
            "self_attn": self_attn,
            "modulation": np.asarray(state[p + "modulation"]),
            "cross_attn": {name: _lin(state, f"{p}cross_attn.{name}")
                           for name in ("q", "k", "v", "o")},
            "ffn_fc1": _lin(state, p + "ffn.0"),
            "ffn_fc2": _lin(state, p + "ffn.2"),
        }
        if cfg.qk_norm:
            blk["cross_attn"]["norm_q"] = _norm_w(state, p + "cross_attn.norm_q")
            blk["cross_attn"]["norm_k"] = _norm_w(state, p + "cross_attn.norm_k")
        if cfg.model_type == "i2v":
            blk["cross_attn"]["k_img"] = _lin(state, p + "cross_attn.k_img")
            blk["cross_attn"]["v_img"] = _lin(state, p + "cross_attn.v_img")
            blk["cross_attn"]["norm_k_img"] = _norm_w(state, p + "cross_attn.norm_k_img")
        if cfg.cross_attn_norm:
            blk["norm3"] = _layernorm(state, p + "norm3")
        params[f"blocks_{i}"] = blk

    if cfg.model_type == "i2v":
        for ours, ref in _IMG_EMB.items():
            params[ours] = (_layernorm if "norm" in ours else _lin)(state, ref)
    return {"params": params}


def mhla_init_params(model: WanModel) -> Dict:
    """The MHLA layers' gate projection and g_norm of ``model`` (e.g. from
    ``init_wan_params``) as ``init_params`` for :func:`convert_wan_checkpoint`."""
    params: Dict[str, Any] = {}
    for i, block in enumerate(model.blocks):
        if model.cfg.layer_attn_type(i) != "mhla_uni":
            continue
        attn, fresh = block.self_attn, {}
        if getattr(attn, "g", None) is not None:
            fresh["g"] = {"kernel": attn.g.weight.detach().cpu().numpy().T,
                          "bias": attn.g.bias.detach().cpu().numpy()}
        fresh["g_norm"] = {"weight": attn.g_norm.weight.detach().cpu().numpy()}
        params[f"blocks_{i}"] = {"self_attn": fresh}
    return {"params": params}


# a .safetensors checkpoint as numpy arrays
load_wan_safetensors = load_safetensors


# the i2v image embedding: this package's modules -> the reference's
_IMG_EMB = {"img_norm_in": "img_emb.proj.0", "img_fc1": "img_emb.proj.1",
            "img_fc2": "img_emb.proj.3", "img_norm_out": "img_emb.proj.4"}

# this package's module (or leaf) names -> the reference's; the rest are the same
_TO_REFERENCE = {**_IMG_EMB, "text_fc1": "text_embedding.0", "text_fc2": "text_embedding.2",
                 "time_fc1": "time_embedding.0", "time_fc2": "time_embedding.2",
                 "time_projection": "time_projection.1", "head": "head.head",
                 "head_modulation": "head.modulation", "ffn_fc1": "ffn.0", "ffn_fc2": "ffn.2"}


def reference_names(model: WanModel, with_mhla: bool = False) -> Dict[str, str]:
    """This package's parameter names of ``model`` -> the names of the
    reference checkpoint that holds them (what :func:`convert_wan_checkpoint`
    reads): without the MHLA layers' gate and g_norm, as a published Wan2.1
    checkpoint, unless ``with_mhla`` (one saved from the MHLA model)."""
    out: Dict[str, str] = {}
    for name in model.state_dict():
        *mods, leaf = name.split(".")
        if not with_mhla and mods[2:3] == ["self_attn"] and mods[3:] in (["g"], ["g_norm"]):
            continue
        if name in _TO_REFERENCE:
            out[name] = _TO_REFERENCE[name]
            continue
        if mods and mods[-1] in _TO_REFERENCE:
            mods[-1] = _TO_REFERENCE[mods[-1]]
        out[name] = ".".join(mods + [leaf])
    return out


def reference_state_shapes(model: WanModel, with_mhla: bool = False) -> Dict[str, tuple]:
    """The reference checkpoint's tensor names and shapes for ``model`` (a
    model on the ``meta`` device will do), as :func:`reference_names` maps
    them: what a reference-named checkpoint of this configuration holds."""
    state = model.state_dict()
    return {ref: tuple(state[name].shape)
            for name, ref in reference_names(model, with_mhla).items()}
