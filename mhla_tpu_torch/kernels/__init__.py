"""Hand-written Hopper kernels of the serving path and their wrappers.

K1 ``fused_fmap_rope_flat`` (Triton), and K2 ``chunk_states``, K3
``mix_states`` and K4 ``chunk_output`` (CUDA C++, ``csrc/mhla_chunk.cu``)
behind ``mhla_chunk_fused_flat``. Every wrapper runs its plain PyTorch
version for a CPU tensor, launches its kernel for a CUDA tensor or raises,
and counts its launches in its module's ``launches``.
"""

from . import fmap_rope, mhla_chunk
from .fmap_rope import fused_fmap_rope_flat
from .mhla_chunk import chunk_output, chunk_states, mhla_chunk_fused_flat, mix_states


def launch_counts() -> dict:
    """Launches of every kernel since the last :func:`reset_launch_counts`."""
    return {**fmap_rope.launches, **mhla_chunk.launches}


def reset_launch_counts() -> None:
    for counts in (fmap_rope.launches, mhla_chunk.launches):
        for name in counts:
            counts[name] = 0


__all__ = [
    "chunk_output",
    "chunk_states",
    "fused_fmap_rope_flat",
    "launch_counts",
    "mhla_chunk_fused_flat",
    "mix_states",
    "reset_launch_counts",
]
