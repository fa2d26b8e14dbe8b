"""``nn.Module`` layers of the causal MHLA LM and the video model."""

from .attention import sdpa
from .fused_dense import dense, fused_projections
from .gated_deltanet import DeltaNetState, GatedDeltaNet
from .gla import GatedLinearAttention, GLAState
from .mhla_causal import MHLACausal, MHLACausalState
from .mhla_vision import MHLA3D, BlockMixing
from .mlp import GatedMLP, default_intermediate_size, swiglu
from .norms import (
    GatedRMSNorm,
    GatedRMSNormHeadsFlat,
    LayerNorm,
    RMSNorm,
    RMSNormHeadsFlat,
    rms_norm,
)
from .short_conv import ShortConvolution

__all__ = [
    "BlockMixing",
    "DeltaNetState",
    "GatedDeltaNet",
    "GatedLinearAttention",
    "GatedMLP",
    "GatedRMSNorm",
    "GatedRMSNormHeadsFlat",
    "GLAState",
    "LayerNorm",
    "MHLA3D",
    "MHLACausal",
    "MHLACausalState",
    "RMSNorm",
    "RMSNormHeadsFlat",
    "ShortConvolution",
    "default_intermediate_size",
    "dense",
    "fused_projections",
    "rms_norm",
    "sdpa",
    "swiglu",
]
