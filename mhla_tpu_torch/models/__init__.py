"""The causal MHLA LM with its generation loop, the Wan video diffusion
transformer, and the weight bridges."""

from .convert_jax import params_from_jax, wan_params_from_jax
from .generation import generate
from .gla_lm import (
    MHLABlock,
    MHLAForCausalLM,
    MHLALMConfig,
    MHLAModel,
    cross_entropy_loss,
    init_lm_params,
)
from .wan import WanConfig, WanModel, build_wan_config, init_wan_params

__all__ = [
    "MHLABlock",
    "MHLAForCausalLM",
    "MHLALMConfig",
    "MHLAModel",
    "WanConfig",
    "WanModel",
    "build_wan_config",
    "cross_entropy_loss",
    "generate",
    "init_lm_params",
    "init_wan_params",
    "params_from_jax",
    "wan_params_from_jax",
]
