"""Hand-written Hopper kernels of the serving, training and video sampling
paths and their wrappers.

Causal LM: K1 ``fused_fmap_rope_flat`` and its gradient K1b
``fmap_rope_bwd`` (Triton); K2 ``chunk_states``, K3 ``mix_states`` and K4
``chunk_output`` (CUDA C++, ``csrc/mhla_chunk.cu``; K3
``csrc/mhla_mix_wide.cu``) and their gradients K4b ``chunk_output_bwd`` and
K2b ``chunk_states_bwd`` (``csrc/mhla_chunk_bwd.cu``) and K3b
``mix_states_bwd`` (``csrc/mhla_mix_wide.cu``) behind ``mhla_chunk_fused_flat``.

Video: K5 ``blockify_island`` and K8 ``unblockify_island`` (Triton), K6
``mix_states_dense`` and K7 ``block_readout`` (CUDA C++,
``csrc/mhla_block.cu``) behind ``mhla_blockwise_fused``, and their gradients
K5b ``unblockify`` and K8b ``blockify`` (Triton) and K7b
``block_readout_bwd`` (``csrc/mhla_block_bwd.cu``); K9
``flash_attention.flash_attention`` (CUDA C++, ``csrc/flash_fwd.cu``; the
module keeps its name here, as in the JAX package) and its gradient K9b
``flash_attention.flash_attention_bwd`` (``csrc/flash_bwd.cu``); K10
``sparse_attention.radial_flash_attention`` (the radial form of
``csrc/flash_fwd.cu``: 128-query blocks over 128-key tiles of their own
lists) and its gradient K10b ``sparse_attention.radial_flash_attention_bwd``
(the radial form of ``csrc/flash_bwd.cu``) behind
``sparse_flash_attention``.

Gated DeltaNet LM: K11 ``delta_chunk.delta_chunk_fwd`` (CUDA C++,
``csrc/delta_chunk.cu``) and its gradient K11b
``delta_chunk.delta_chunk_bwd`` (``csrc/delta_chunk_bwd.cu``) behind
``gated_delta_chunk_fused``.

GLA LM: K12 ``gla_chunk.gla_chunk_fwd`` (CUDA C++, ``csrc/gla_chunk.cu``)
and its gradient K12b ``gla_chunk.gla_chunk_bwd`` (``csrc/gla_chunk_bwd.cu``)
behind ``gla_chunk_fused``, and their scalar-decay form for one log-decay per
head (the Mamba2 and simple GLA LMs), ``gla_chunk.gla_chunk_fwd_scalar`` and
``gla_chunk.gla_chunk_bwd_scalar``.

Every wrapper runs its plain PyTorch version for a CPU tensor, launches its
kernel for a CUDA tensor or raises, and counts its launches in its module's
``launches``.
"""

from . import (
    delta_chunk,
    flash_attention,
    fmap_rope,
    gla_chunk,
    mhla_block,
    mhla_chunk,
    sparse_attention,
)
from .delta_chunk import delta_chunk_bwd, delta_chunk_fwd, gated_delta_chunk_fused
from .fmap_rope import fmap_rope_bwd, fused_fmap_rope_flat
from .gla_chunk import gla_chunk_bwd, gla_chunk_fused, gla_chunk_fwd
from .mhla_block import (
    block_readout,
    block_readout_bwd,
    blockify,
    blockify_island,
    mhla_blockwise_fused,
    mix_states_dense,
    rms_norm_heads_flat,
    unblockify,
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
from .sparse_attention import (
    radial_flash_attention,
    radial_flash_attention_bwd,
    sparse_flash_attention,
)

_COUNTERS = (fmap_rope.launches, mhla_chunk.launches, mhla_block.launches,
             flash_attention.launches, sparse_attention.launches, delta_chunk.launches,
             gla_chunk.launches)


def launch_counts() -> dict:
    """Launches of every kernel since the last :func:`reset_launch_counts`."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


__all__ = [
    "block_readout",
    "block_readout_bwd",
    "blockify",
    "blockify_island",
    "chunk_output",
    "chunk_output_bwd",
    "chunk_states",
    "chunk_states_bwd",
    "delta_chunk_bwd",
    "delta_chunk_fwd",
    "flash_attention",
    "fmap_rope_bwd",
    "fused_fmap_rope_flat",
    "gla_chunk_bwd",
    "gla_chunk_fused",
    "gla_chunk_fwd",
    "gated_delta_chunk_fused",
    "launch_counts",
    "mhla_blockwise_fused",
    "mhla_chunk_fused_flat",
    "mix_states",
    "mix_states_bwd",
    "mix_states_dense",
    "radial_flash_attention",
    "radial_flash_attention_bwd",
    "reset_launch_counts",
    "rms_norm_heads_flat",
    "sparse_attention",
    "sparse_flash_attention",
    "unblockify",
    "unblockify_island",
]
