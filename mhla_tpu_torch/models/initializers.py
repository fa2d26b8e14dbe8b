"""In-place draws of flax's initializers from a ``torch.Generator``, shared
by the models' seeded inits."""

from __future__ import annotations

import math

import torch

_STD_FIX = 0.87962566103423978  # std of a unit normal truncated at +-2


def trunc_normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """In place: ``std`` times a unit normal truncated to [-2, 2] (flax
    ``truncated_normal(std)``), by the inverse CDF of a uniform draw."""
    lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2.0, 2.0))
    w.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    return w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init, in place: a normal of variance 1 / fan_in
    truncated at two standard deviations and rescaled to that variance (the
    fan_in of a torch weight [out, in, k...] is in * prod(k))."""
    return trunc_normal_(w, math.sqrt(1.0 / w[0].numel()) / _STD_FIX, generator)
