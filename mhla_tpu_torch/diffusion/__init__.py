"""Samplers and training losses: Gaussian diffusion (DiT) and flow matching
(the video model: DPM-Solver++, FlowEuler, UniPC, SA-Solver)."""

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
from .sa_solver import sa_solver_sample
from .unipc import unipc_sample

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
    "sa_solver_sample",
    "space_timesteps",
    "unipc_sample",
    "with_cfg",
]
