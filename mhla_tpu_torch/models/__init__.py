"""The causal MHLA LM with its generation loop, the Wan video diffusion
transformer, the MHLA ViT, the MHLA DiT, and the weight bridges."""

from .convert_dit import convert_dit_checkpoint
from .convert_jax import (
    dit_params_from_jax,
    params_from_jax,
    vit_params_from_jax,
    wan_params_from_jax,
)
from .dit import DiT, DiTConfig, DiT_models, build_dit, init_dit_params
from .generation import generate
from .gla_lm import (
    MHLABlock,
    MHLAForCausalLM,
    MHLALMConfig,
    MHLAModel,
    cross_entropy_loss,
    init_lm_params,
)
from .vit import MHLAViT, ViTConfig, build_vit, init_vit_params
from .wan import WanConfig, WanModel, build_wan_config, init_wan_params

__all__ = [
    "DiT",
    "DiTConfig",
    "DiT_models",
    "MHLABlock",
    "MHLAForCausalLM",
    "MHLALMConfig",
    "MHLAModel",
    "MHLAViT",
    "ViTConfig",
    "WanConfig",
    "WanModel",
    "build_dit",
    "build_vit",
    "build_wan_config",
    "convert_dit_checkpoint",
    "cross_entropy_loss",
    "dit_params_from_jax",
    "generate",
    "init_dit_params",
    "init_lm_params",
    "init_vit_params",
    "init_wan_params",
    "params_from_jax",
    "vit_params_from_jax",
    "wan_params_from_jax",
]
