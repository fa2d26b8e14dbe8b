"""The causal MHLA LM with its generation loop, the Wan video diffusion
transformer with its umT5 text encoder and its VAE, the MHLA ViT, the MHLA
DiT, the checkpoint converters and the weight bridges."""

from .convert_dit import convert_dit_checkpoint
from .convert_jax import (
    dit_params_from_jax,
    params_from_jax,
    t5_params_from_jax,
    vae_params_from_jax,
    vit_params_from_jax,
    wan_params_from_jax,
)
from .convert_wan import convert_wan_checkpoint, load_wan_safetensors
from .dit import DiT, DiTConfig, DiT_models, build_dit, init_dit_params
from .generation import generate
from .gla_lm import (
    MHLABlock,
    MHLAForCausalLM,
    MHLALMConfig,
    MHLAModel,
    cross_entropy_loss,
    fused_lm_loss,
    init_lm_params,
    unembedding_weight,
)
from .t5 import T5Config, T5Encoder, T5TextEncoder, convert_hf_umt5, convert_t5_checkpoint
from .vae import VAEConfig, WanVAE, convert_vae_checkpoint
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
    "T5Config",
    "T5Encoder",
    "T5TextEncoder",
    "VAEConfig",
    "ViTConfig",
    "WanConfig",
    "WanModel",
    "WanVAE",
    "build_dit",
    "build_vit",
    "build_wan_config",
    "convert_dit_checkpoint",
    "convert_hf_umt5",
    "convert_t5_checkpoint",
    "convert_vae_checkpoint",
    "convert_wan_checkpoint",
    "cross_entropy_loss",
    "dit_params_from_jax",
    "fused_lm_loss",
    "generate",
    "init_dit_params",
    "init_lm_params",
    "init_vit_params",
    "init_wan_params",
    "load_wan_safetensors",
    "params_from_jax",
    "t5_params_from_jax",
    "unembedding_weight",
    "vae_params_from_jax",
    "vit_params_from_jax",
    "wan_params_from_jax",
]
