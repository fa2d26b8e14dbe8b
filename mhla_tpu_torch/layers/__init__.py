"""``nn.Module`` layers of the causal MHLA LM, the video model and the image
models."""

from .attention import sdpa
from .fused_dense import dense, fused_projections
from .gated_deltanet import DeltaNetState, GatedDeltaNet
from .gla import GatedLinearAttention, GLAState
from .mhla_causal import MHLACausal, MHLACausalState
from .linear_attn import (
    CausalLinearAttention,
    LinearAttention2D,
    LinearAttnState,
    causal_linear_attention,
    linear_attention,
)
from .mamba import Mamba, MambaState
from .mamba2 import Mamba2, Mamba2State
from .mhla_vision import MHLA2D, MHLA3D, BlockMixing, depthwise_conv
from .mlp import MLP, GatedMLP, default_intermediate_size, swiglu
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
    "CausalLinearAttention",
    "DeltaNetState",
    "GatedDeltaNet",
    "GatedLinearAttention",
    "GatedMLP",
    "GatedRMSNorm",
    "GatedRMSNormHeadsFlat",
    "GLAState",
    "LayerNorm",
    "LinearAttention2D",
    "LinearAttnState",
    "MHLA2D",
    "MHLA3D",
    "MHLACausal",
    "MHLACausalState",
    "MLP",
    "Mamba",
    "Mamba2",
    "Mamba2State",
    "MambaState",
    "RMSNorm",
    "RMSNormHeadsFlat",
    "ShortConvolution",
    "causal_linear_attention",
    "default_intermediate_size",
    "dense",
    "depthwise_conv",
    "fused_projections",
    "linear_attention",
    "rms_norm",
    "sdpa",
    "swiglu",
]
