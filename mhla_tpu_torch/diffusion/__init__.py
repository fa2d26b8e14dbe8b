"""Samplers of the flow-matching video model."""

from .dpm_solver import (
    dpm_solver_pp,
    flow_euler_sample_loop,
    flow_velocity_to_x0,
    with_cfg,
)

__all__ = ["dpm_solver_pp", "flow_euler_sample_loop", "flow_velocity_to_x0", "with_cfg"]
