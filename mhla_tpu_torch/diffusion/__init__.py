"""Samplers and the training loss of the flow-matching video model."""

from .dpm_solver import (
    dpm_solver_pp,
    flow_euler_sample_loop,
    flow_velocity_to_x0,
    with_cfg,
)
from .gaussian_diffusion import flow_q_sample, flow_training_loss, logit_normal_timesteps

__all__ = [
    "dpm_solver_pp",
    "flow_euler_sample_loop",
    "flow_q_sample",
    "flow_training_loss",
    "flow_velocity_to_x0",
    "logit_normal_timesteps",
    "with_cfg",
]
