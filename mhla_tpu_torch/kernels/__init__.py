"""Hand-written Hopper kernels of the serving, training and video sampling
paths and their wrappers.

Causal LM: K1 ``fused_fmap_rope_flat`` and its gradient K1b
``fmap_rope_bwd`` (Triton); K2 ``chunk_states``, K3 ``mix_states`` and K4
``chunk_output`` (CUDA C++, ``csrc/mhla_chunk.cu``) and their gradients K4b
``chunk_output_bwd``, K3b ``mix_states_bwd`` and K2b ``chunk_states_bwd``
(``csrc/mhla_chunk_bwd.cu``) behind ``mhla_chunk_fused_flat``.

Video: K5 ``blockify_island`` and K8 ``unblockify_island`` (Triton), K6
``mix_states_dense`` and K7 ``block_readout`` (CUDA C++,
``csrc/mhla_block.cu``) behind ``mhla_blockwise_fused``; K9
``flash_attention.flash_attention`` (CUDA C++, ``csrc/flash_fwd.cu``; the
module keeps its name here, as in the JAX package); K10
``sparse_attention.radial_flash_attention`` (CUDA C++,
``csrc/radial_fwd.cu``) behind ``sparse_flash_attention``.

Every wrapper runs its plain PyTorch version for a CPU tensor, launches its
kernel for a CUDA tensor or raises, and counts its launches in its module's
``launches``.
"""

from . import flash_attention, fmap_rope, mhla_block, mhla_chunk, sparse_attention
from .fmap_rope import fmap_rope_bwd, fused_fmap_rope_flat
from .mhla_block import (
    block_readout,
    blockify_island,
    mhla_blockwise_fused,
    mix_states_dense,
    rms_norm_heads_flat,
    unblockify_island,
)
from .mhla_chunk import (
    chunk_output,
    chunk_output_bwd,
    chunk_states,
    chunk_states_bwd,
    mhla_chunk_fused_flat,
    mix_states,
    mix_states_bwd,
)
from .sparse_attention import radial_flash_attention, sparse_flash_attention

_COUNTERS = (fmap_rope.launches, mhla_chunk.launches, mhla_block.launches,
             flash_attention.launches, sparse_attention.launches)


def launch_counts() -> dict:
    """Launches of every kernel since the last :func:`reset_launch_counts`."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


__all__ = [
    "block_readout",
    "blockify_island",
    "chunk_output",
    "chunk_output_bwd",
    "chunk_states",
    "chunk_states_bwd",
    "flash_attention",
    "fmap_rope_bwd",
    "fused_fmap_rope_flat",
    "launch_counts",
    "mhla_blockwise_fused",
    "mhla_chunk_fused_flat",
    "mix_states",
    "mix_states_bwd",
    "mix_states_dense",
    "radial_flash_attention",
    "reset_launch_counts",
    "rms_norm_heads_flat",
    "sparse_attention",
    "sparse_flash_attention",
    "unblockify_island",
]
