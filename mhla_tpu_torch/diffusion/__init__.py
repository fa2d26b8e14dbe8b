"""Samplers and training losses: Gaussian diffusion (DiT) and flow matching
(the video model)."""

from .dpm_solver import (
    dpm_solver_pp,
    flow_euler_sample_loop,
    flow_velocity_to_x0,
    with_cfg,
)
from .gaussian_diffusion import (
    GaussianDiffusion,
    create_diffusion,
    flow_q_sample,
    flow_training_loss,
    logit_normal_timesteps,
    make_beta_schedule,
    space_timesteps,
)

__all__ = [
    "GaussianDiffusion",
    "create_diffusion",
    "dpm_solver_pp",
    "flow_euler_sample_loop",
    "flow_q_sample",
    "flow_training_loss",
    "flow_velocity_to_x0",
    "logit_normal_timesteps",
    "make_beta_schedule",
    "space_timesteps",
    "with_cfg",
]
