"""Functional MHLA operators in plain PyTorch: the definitions that the
kernels in ``mhla_tpu_torch.kernels`` are held to."""

from .block_mix import block_mixing_matrix
from .delta_rule import gated_delta_chunk, gated_delta_recurrent, l2norm
from .feature_maps import FEATURE_MAPS, get_feature_map
from .gla_chunk import gla_chunk, gla_recurrent
from .losses import (
    cross_entropy,
    fused_kl_div_loss,
    fused_linear_cross_entropy,
    grpo_loss,
    l2_warp,
)
from .mhla_blockwise import mhla_blockwise_mh
from .mhla_chunk import (
    DEFAULT_CHUNK_SIZE,
    build_segment_mixing,
    chunk_segments,
    clamp_causal_mixing_matrix,
    init_causal_mixing_matrix,
    mhla_chunk,
    mhla_chunk_ref,
    prepare_mixing_matrix,
    segment_positions,
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
from .selective_scan import selective_scan_chunk, selective_scan_recurrent

__all__ = [
    "DEFAULT_CHUNK_SIZE",
    "FEATURE_MAPS",
    "MHLAState",
    "apply_rotary",
    "apply_rotary_3d_halves",
    "apply_rotary_flat",
    "block_mixing_matrix",
    "build_segment_mixing",
    "chunk_segments",
    "clamp_causal_mixing_matrix",
    "cross_entropy",
    "fused_kl_div_loss",
    "fused_linear_cross_entropy",
    "gated_delta_chunk",
    "gated_delta_recurrent",
    "get_feature_map",
    "gla_chunk",
    "gla_recurrent",
    "grpo_loss",
    "init_causal_mixing_matrix",
    "init_mhla_state",
    "l2_warp",
    "l2norm",
    "mhla_blockwise_mh",
    "mhla_chunk",
    "mhla_chunk_ref",
    "mhla_recurrent",
    "prepare_mixing_matrix",
    "rope_angles_3d",
    "rope_tables_flat",
    "rotary_cos_sin",
    "rotary_freqs",
    "rotary_xpos_tables",
    "segment_positions",
    "selective_scan_chunk",
    "selective_scan_recurrent",
    "state_from_chunk",
]
