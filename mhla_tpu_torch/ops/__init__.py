"""Functional MHLA operators in plain PyTorch: the definitions that the
kernels in ``mhla_tpu_torch.kernels`` are held to."""

from .feature_maps import FEATURE_MAPS, get_feature_map
from .mhla_chunk import (
    DEFAULT_CHUNK_SIZE,
    clamp_causal_mixing_matrix,
    init_causal_mixing_matrix,
    mhla_chunk,
    prepare_mixing_matrix,
)
from .mhla_recurrent import MHLAState, init_mhla_state, mhla_recurrent, state_from_chunk
from .rotary import (
    apply_rotary,
    apply_rotary_flat,
    rotary_cos_sin,
    rotary_freqs,
    rotary_xpos_tables,
)

__all__ = [
    "DEFAULT_CHUNK_SIZE",
    "FEATURE_MAPS",
    "MHLAState",
    "apply_rotary",
    "apply_rotary_flat",
    "clamp_causal_mixing_matrix",
    "get_feature_map",
    "init_causal_mixing_matrix",
    "init_mhla_state",
    "mhla_chunk",
    "mhla_recurrent",
    "prepare_mixing_matrix",
    "rotary_cos_sin",
    "rotary_freqs",
    "rotary_xpos_tables",
    "state_from_chunk",
]
