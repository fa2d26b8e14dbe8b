"""Video inference: DPM-Solver++ or FlowEuler sampling of latents under
classifier-free guidance (counterpart of
``mhla_tpu/eval/video_inference.py``). The text encoder and the VAE decode
are not ported: the caller brings text embeddings and gets latents."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..diffusion.dpm_solver import (
    dpm_solver_pp,
    flow_euler_sample_loop,
    flow_velocity_to_x0,
    with_cfg,
)
from ..models.wan import WanModel


@torch.no_grad()
def sample_video_latents(
    model: WanModel,
    text_emb: torch.Tensor,  # [B, text_len, text_dim]
    null_emb: Optional[torch.Tensor] = None,
    latent_shape: Tuple[int, int, int, int] = (21, 60, 100, 16),
    cfg_scale: float = 5.0,
    num_steps: int = 20,
    solver: str = "dpm-solver",  # dpm-solver | flow_euler
    flow_shift: float = 3.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sampled latents [B, F, H, W, C], float32, on the model's device.
    ``generator`` (on that device) draws the starting noise; seed 0 when
    None."""
    cfg = model.cfg
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    text_emb = text_emb.to(device)
    null_emb = torch.zeros_like(text_emb) if null_emb is None else null_emb.to(device)

    def velocity(x_t, t, ctx):
        return model(x_t.to(cfg.dtype), t * 1000.0, ctx.to(cfg.dtype)).float()

    cfg_velocity = with_cfg(velocity, text_emb, null_emb, cfg_scale)
    shape = (text_emb.shape[0], *latent_shape)
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    if solver == "dpm-solver":
        return dpm_solver_pp(
            flow_velocity_to_x0(cfg_velocity), x, num_steps=num_steps, order=2, shift=flow_shift
        )
    if solver == "flow_euler":
        return flow_euler_sample_loop(cfg_velocity, x, num_steps=num_steps, shift=flow_shift)
    if solver in ("unipc", "sa-solver"):
        raise NotImplementedError(f"solver {solver!r} is not ported yet")
    raise ValueError(f"unknown solver {solver}")
