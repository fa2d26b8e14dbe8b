"""Rectified flow matching for the video model's training (counterpart of
``flow_q_sample``, ``flow_training_loss`` and ``logit_normal_timesteps`` in
``mhla_tpu/diffusion/gaussian_diffusion.py``; the FlowEuler sampler of that
module lives in ``dpm_solver.py``).

Where the JAX functions draw from a key, these take a ``torch.Generator``
(on the device of what they draw) or the ready-made numbers, so a caller can
hand both packages the same draws.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def flow_q_sample(x0: torch.Tensor, t01: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Linear-flow interpolation x_t = (1 - t) x0 + t noise for t [B] in [0, 1]."""
    t = t01.reshape(t01.shape + (1,) * (x0.ndim - 1))
    return (1 - t) * x0 + t * noise


def flow_training_loss(
    model: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    t01: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    model_kwargs: Optional[dict] = None,
) -> Dict[str, torch.Tensor]:
    """Flow-velocity MSE per sample, float32: ``model(x_t, t01)`` against the
    target ``noise - x0``. ``noise`` is drawn from ``generator`` (standard
    normal, x0's shape, dtype and device) unless given."""
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
    v = model(flow_q_sample(x0, t01, noise), t01, **(model_kwargs or {}))
    target = noise - x0
    mse = torch.mean(torch.square(v.float() - target.float()), dim=tuple(range(1, x0.ndim)))
    return {"loss": mse, "mse": mse}


def logit_normal_timesteps(
    batch: int,
    mean: float = 0.0,
    std: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Logit-normal t [batch] in (0, 1): the sigmoid of a normal(mean, std)
    draw from ``generator`` on ``device``, float32."""
    u = torch.randn(batch, generator=generator, dtype=torch.float32, device=device)
    return torch.sigmoid(u * std + mean)
