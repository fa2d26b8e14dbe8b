"""Standard-DiT -> MHLA-DiT fine-tuning checkpoint conversion (counterpart of
``mhla_tpu/models/convert_dit.py``).

A stock (softmax-attention) DiT state dict in the facebook layout becomes
this package's ``DiT`` state dict: ``attn.qkv`` -> ``attn.to_qkv``,
``attn.proj`` -> ``attn.to_out`` (``to_out.0`` is taken as well), the
embedders and the final layer renamed; the MHLA-only parameters (the input
norm, q/k norms, the LePE convolution, the mixing matrix) have no source in
such a checkpoint and come from the fresh model's state dict. Both sides are
torch layouts, so nothing is transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .dit import DiTConfig

# MHLA-only parameters inside each attention module: kept from the fresh
# model (trained from scratch during the fine-tuning)
FRESH_ATTN = ("norm", "q_norm", "k_norm", "lepe", "piece_attn")


def _lin(state: Mapping[str, np.ndarray], src: str, dst: str) -> Dict[str, torch.Tensor]:
    out = {f"{dst}.weight": torch.as_tensor(np.asarray(state[src + ".weight"]))}
    if src + ".bias" in state:
        out[f"{dst}.bias"] = torch.as_tensor(np.asarray(state[src + ".bias"]))
    return out


def convert_dit_checkpoint(
    state: Mapping[str, np.ndarray],
    cfg: DiTConfig,
    init_state: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A torch DiT state dict (arrays or tensors) -> the state dict of
    ``DiT(cfg)``; ``init_state`` is a fresh ``DiT(cfg).state_dict()`` that
    supplies the MHLA-specific parameters. Keys of ``state`` that this model
    has no place for (``pos_embed``, which the model computes) are
    ignored."""
    sd: Dict[str, torch.Tensor] = {
        "x_embedder.weight": torch.as_tensor(np.asarray(state["x_embedder.proj.weight"])),
        "x_embedder.bias": torch.as_tensor(np.asarray(state["x_embedder.proj.bias"])),
        "y_embedder.table.weight": torch.as_tensor(
            np.asarray(state["y_embedder.embedding_table.weight"])),
        **_lin(state, "t_embedder.mlp.0", "t_embedder.fc1"),
        **_lin(state, "t_embedder.mlp.2", "t_embedder.fc2"),
        **_lin(state, "final_layer.adaLN_modulation.1", "final_adaLN"),
        **_lin(state, "final_layer.linear", "final_linear"),
    }
    for i in range(cfg.depth):
        tp = f"blocks.{i}."
        qkv = tp + ("attn.to_qkv" if tp + "attn.to_qkv.weight" in state else "attn.qkv")
        out = tp + ("attn.to_out.0" if tp + "attn.to_out.0.weight" in state else "attn.proj")
        sd.update(_lin(state, qkv, tp + "attn.to_qkv"))
        sd.update(_lin(state, out, tp + "attn.to_out"))
        sd.update(_lin(state, tp + "adaLN_modulation.1", tp + "adaLN_modulation"))
        sd.update(_lin(state, tp + "mlp.fc1", tp + "mlp.fc1"))
        sd.update(_lin(state, tp + "mlp.fc2", tp + "mlp.fc2"))
        fresh = {k: v for k, v in init_state.items()
                 if k.startswith(tp + "attn.") and k.split(".")[3] in FRESH_ATTN}
        if not fresh:
            raise KeyError(f"blocks.{i}.attn fresh parameters missing: pass the fresh "
                           "model's state dict (the MHLA mixing, LePE and norms are trained "
                           "from scratch)")
        sd.update({k: v.detach().clone() for k, v in fresh.items()})
    return {k: v.float() for k, v in sd.items()}
