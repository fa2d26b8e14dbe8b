"""Hand-written Hopper kernels of the serving and training paths and their
wrappers.

K1 ``fused_fmap_rope_flat`` and its gradient K1b ``fmap_rope_bwd``
(Triton); K2 ``chunk_states``, K3 ``mix_states`` and K4 ``chunk_output``
(CUDA C++, ``csrc/mhla_chunk.cu``) and their gradients K4b
``chunk_output_bwd``, K3b ``mix_states_bwd`` and K2b ``chunk_states_bwd``
(``csrc/mhla_chunk_bwd.cu``) behind ``mhla_chunk_fused_flat``. Every
wrapper runs its plain PyTorch version for a CPU tensor, launches its
kernel for a CUDA tensor or raises, and counts its launches in its
module's ``launches``.
"""

from . import fmap_rope, mhla_chunk
from .fmap_rope import fmap_rope_bwd, fused_fmap_rope_flat
from .mhla_chunk import (
    chunk_output,
    chunk_output_bwd,
    chunk_states,
    chunk_states_bwd,
    mhla_chunk_fused_flat,
    mix_states,
    mix_states_bwd,
)


def launch_counts() -> dict:
    """Launches of every kernel since the last :func:`reset_launch_counts`."""
    return {**fmap_rope.launches, **mhla_chunk.launches}


def reset_launch_counts() -> None:
    for counts in (fmap_rope.launches, mhla_chunk.launches):
        for name in counts:
            counts[name] = 0


__all__ = [
    "chunk_output",
    "chunk_output_bwd",
    "chunk_states",
    "chunk_states_bwd",
    "fmap_rope_bwd",
    "fused_fmap_rope_flat",
    "launch_counts",
    "mhla_chunk_fused_flat",
    "mix_states",
    "mix_states_bwd",
    "reset_launch_counts",
]
