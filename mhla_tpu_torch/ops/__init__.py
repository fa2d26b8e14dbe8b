"""Functional MHLA operators in plain PyTorch: the definitions that the
kernels in ``mhla_tpu_torch.kernels`` are held to."""

from .block_mix import block_mixing_matrix
from .feature_maps import FEATURE_MAPS, get_feature_map
from .mhla_blockwise import mhla_blockwise_mh
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
    apply_rotary_3d_halves,
    apply_rotary_flat,
    rope_angles_3d,
    rope_tables_flat,
    rotary_cos_sin,
    rotary_freqs,
    rotary_xpos_tables,
)

__all__ = [
    "DEFAULT_CHUNK_SIZE",
    "FEATURE_MAPS",
    "MHLAState",
    "apply_rotary",
    "apply_rotary_3d_halves",
    "apply_rotary_flat",
    "block_mixing_matrix",
    "clamp_causal_mixing_matrix",
    "get_feature_map",
    "init_causal_mixing_matrix",
    "init_mhla_state",
    "mhla_blockwise_mh",
    "mhla_chunk",
    "mhla_recurrent",
    "prepare_mixing_matrix",
    "rope_angles_3d",
    "rope_tables_flat",
    "rotary_cos_sin",
    "rotary_freqs",
    "rotary_xpos_tables",
    "state_from_chunk",
]
