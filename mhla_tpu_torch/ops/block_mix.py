"""Block-mixing matrices from spatial block-center distances, 2-D and 3-D
(own numpy copy of ``mhla_tpu/ops/block_mix.py``; the two must stay equal,
which ``tests/test_torch_mhla_block.py`` checks).

The non-causal MHLA variants mix per-block KV states with an [N, N] matrix
derived from Euclidean distances between block centers on a 2-D (images) or
3-D (video: frames x height x width) grid, passed through one of several
transforms and column-normalized: every transform except ``gaussian``
divides by the column sums, so each column sums to 1; ``gaussian`` is
returned unnormalized.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

VALID_TRANSFORMS = ("linear", "cos", "exp", "gaussian", "local")


def block_centers(blocks_layout: Sequence[int]) -> np.ndarray:
    """Centers of a dense grid of blocks, e.g. (4, 4) or (3, 5, 10)."""
    grids = np.meshgrid(
        *[np.arange(n, dtype=np.float64) + 0.5 for n in blocks_layout],
        indexing="ij",
    )
    return np.stack([g.ravel() for g in grids], axis=-1)  # [prod(layout), ndim]


def block_distance_matrix(blocks_layout: Sequence[int]) -> np.ndarray:
    c = block_centers(blocks_layout)
    diff = c[:, None, :] - c[None, :, :]
    return np.sqrt(np.sum(diff * diff, axis=-1))


def apply_distance_transform(
    dist: np.ndarray,
    transform: str = "linear",
    local_thres: float = 1.5,
    exp_sigma: float = 3.0,
) -> np.ndarray:
    """Distance matrix -> mixing weights. See module docstring for norms."""
    # single-block (or degenerate) grids have an all-zero distance matrix;
    # normalize by 1 so the transforms yield uniform weights instead of NaN
    max_dist = dist.max() if dist.max() > 0 else 1.0
    if transform == "linear":
        mat = 1.0 - dist / max_dist
        return mat / mat.sum(axis=0, keepdims=True)
    if transform == "cos":
        mat = np.cos(dist / max_dist * math.pi / 4)
        return mat / mat.sum(axis=0, keepdims=True)
    if transform == "exp":
        mat = np.exp(-dist / exp_sigma)
        return mat / mat.sum(axis=0, keepdims=True)
    if transform == "gaussian":
        sigma = max_dist / 3
        return np.exp(-(dist**2) / (2 * sigma**2))
    if transform == "local":
        mat = (dist <= local_thres).astype(np.float64)
        return mat / mat.sum(axis=0, keepdims=True)
    raise ValueError(f"Unknown transform: {transform!r} (valid: {VALID_TRANSFORMS})")


def block_mixing_matrix(
    blocks_layout: Sequence[int],
    transform: str = "linear",
    local_thres: float = 1.5,
    exp_sigma: float = 3.0,
    dtype=np.float32,
) -> np.ndarray:
    """[N, N] mixing matrix for a 2D or 3D block grid (N = prod(layout))."""
    dist = block_distance_matrix(blocks_layout)
    return apply_distance_transform(dist, transform, local_thres, exp_sigma).astype(dtype)
