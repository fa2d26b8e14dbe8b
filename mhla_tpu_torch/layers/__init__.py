"""``nn.Module`` layers of the causal MHLA LM and the video model."""

from .attention import sdpa
from .fused_dense import dense, fused_projections
from .mhla_causal import MHLACausal, MHLACausalState
from .mhla_vision import MHLA3D, BlockMixing
from .mlp import GatedMLP, default_intermediate_size, swiglu
from .norms import GatedRMSNormHeadsFlat, LayerNorm, RMSNorm, RMSNormHeadsFlat, rms_norm

__all__ = [
    "BlockMixing",
    "GatedMLP",
    "GatedRMSNormHeadsFlat",
    "LayerNorm",
    "MHLA3D",
    "MHLACausal",
    "MHLACausalState",
    "RMSNorm",
    "RMSNormHeadsFlat",
    "default_intermediate_size",
    "dense",
    "fused_projections",
    "rms_norm",
    "sdpa",
    "swiglu",
]
