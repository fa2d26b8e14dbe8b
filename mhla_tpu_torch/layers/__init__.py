"""``nn.Module`` layers of the causal MHLA LM."""

from .fused_dense import dense, fused_projections
from .mhla_causal import MHLACausal, MHLACausalState
from .mlp import GatedMLP, default_intermediate_size, swiglu
from .norms import GatedRMSNormHeadsFlat, RMSNorm, RMSNormHeadsFlat, rms_norm

__all__ = [
    "GatedMLP",
    "GatedRMSNormHeadsFlat",
    "MHLACausal",
    "MHLACausalState",
    "RMSNorm",
    "RMSNormHeadsFlat",
    "default_intermediate_size",
    "dense",
    "fused_projections",
    "rms_norm",
    "swiglu",
]
