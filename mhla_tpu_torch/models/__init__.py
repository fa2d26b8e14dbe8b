"""The causal MHLA LM, its generation loop and the weight bridge."""

from .convert_jax import params_from_jax
from .generation import generate
from .gla_lm import (
    MHLABlock,
    MHLAForCausalLM,
    MHLALMConfig,
    MHLAModel,
    cross_entropy_loss,
    init_lm_params,
)

__all__ = [
    "MHLABlock",
    "MHLAForCausalLM",
    "MHLALMConfig",
    "MHLAModel",
    "cross_entropy_loss",
    "generate",
    "init_lm_params",
    "params_from_jax",
]
