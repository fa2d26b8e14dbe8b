"""DPM-Solver++ (multistep, order 1 or 2) and the FlowEuler sampler for
flow-matching models (counterpart of ``mhla_tpu/diffusion/dpm_solver.py``
and of ``flow_euler_sample_loop`` in
``mhla_tpu/diffusion/gaussian_diffusion.py``).

Data-prediction DPM-Solver++(2M) on the half-logSNR grid of the linear
rectified flow (alpha_t = 1 - t, sigma_t = t; velocity = noise - x_start,
so x0 = x_t - t * v), with classifier-free guidance folded into the model
call (cond and uncond batched). The JAX samplers are one ``lax.scan``
program; here they are plain Python loops whose schedule scalars are
computed on the host in float32, as the JAX package computes them, so no
step waits for the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

Model = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _flow_grid(num_steps: int, shift: float = 1.0, t_start=1.0, t_end=1e-3) -> np.ndarray:
    t = np.linspace(t_start, t_end, num_steps + 1)
    if shift != 1.0:  # timestep shift
        t = shift * t / (1 + (shift - 1) * t)
    return t


def dpm_solver_pp(
    model_x0: Model, x: torch.Tensor, num_steps: int = 20, order: int = 2, shift: float = 1.0
) -> torch.Tensor:
    """Multistep DPM-Solver++ in data-prediction form over the flow
    schedule, from the noise ``x``. ``model_x0(x_t, t)`` returns the data
    (x0) prediction at continuous time t in (0, 1], t of shape [B]; wrap a
    velocity model with :func:`flow_velocity_to_x0`."""
    f32 = np.float32
    ts = _flow_grid(num_steps, shift).astype(f32)
    alphas, sigmas = f32(1.0) - ts, ts
    lambdas = np.log(np.clip(alphas, f32(1e-6), None)) - np.log(np.clip(sigmas, f32(1e-6), None))
    x = x.float()
    x0_prev = None
    for i in range(num_steps):
        t_cur = torch.full((x.shape[0],), float(ts[i]), dtype=torch.float32, device=x.device)
        x0 = model_x0(x, t_cur).float()
        h = lambdas[i + 1] - lambdas[i]
        d = x0
        if order >= 2 and x0_prev is not None:  # second-order multistep correction
            r = (lambdas[i] - lambdas[i - 1]) / max(h, f32(1e-8))
            c = f32(1.0) / (f32(2.0) * max(r, f32(1e-8)))
            d = float(1 + c) * x0 - float(c) * x0_prev
        x = float(sigmas[i + 1] / max(sigmas[i], f32(1e-8))) * x - float(
            alphas[i + 1] * np.expm1(-h)
        ) * d
        x0_prev = x0
    return x


def flow_velocity_to_x0(velocity_model: Model) -> Model:
    """Wrap a flow-velocity model into a data-prediction model:
    x0 = x_t - t * v(x_t, t)."""

    def x0_model(x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        v = velocity_model(x_t, t)
        tt = t.reshape(t.shape + (1,) * (x_t.ndim - 1))
        return x_t.float() - tt * v.float()

    return x0_model


def with_cfg(
    model: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    cond: torch.Tensor,
    uncond: torch.Tensor,
    cfg_scale: float,
) -> Model:
    """Fold classifier-free guidance into ``model(x, t, condition)``: the
    cond and uncond passes run as one batch of twice the size."""

    def with_guidance(x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        out = model(torch.cat([x_t, x_t]), torch.cat([t, t]), torch.cat([cond, uncond]))
        out_c, out_u = out.chunk(2, dim=0)
        return out_u + cfg_scale * (out_c - out_u)

    return with_guidance


def flow_euler_sample_loop(
    model: Callable[..., torch.Tensor],
    x: torch.Tensor,
    num_steps: int = 50,
    model_kwargs: Optional[dict] = None,
    shift: float = 1.0,
) -> torch.Tensor:
    """FlowEuler sampler: integrate dx/dt = -v from t = 1 (the noise ``x``)
    to t = 0, with the optional timestep shift
    t' = shift * t / (1 + (shift - 1) * t). The caller draws the noise (the
    JAX function draws it from its key)."""
    model_kwargs = model_kwargs or {}
    ts = np.linspace(1.0, 0.0, num_steps + 1)
    if shift != 1.0:
        ts = shift * ts / (1 + (shift - 1) * ts)
    ts = ts.astype(np.float32)
    x = x.float()
    for i in range(num_steps):
        t_b = torch.full((x.shape[0],), float(ts[i]), dtype=torch.float32, device=x.device)
        x = x + float(ts[i + 1] - ts[i]) * model(x, t_b, **model_kwargs).float()
    return x
