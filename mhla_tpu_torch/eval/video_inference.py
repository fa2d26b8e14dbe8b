"""Video inference: sampling of latents under classifier-free guidance with
DPM-Solver++, FlowEuler, UniPC or SA-Solver (counterpart of
``mhla_tpu/eval/video_inference.py``). The caller brings text embeddings
(``models.t5``), for an image-to-video model the CLIP features of the
conditioning frame (``models.clip.encode_i2v_features``), and decodes the
latents (``models.vae``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..diffusion.dpm_solver import (
    dpm_solver_pp,
    flow_euler_sample_loop,
    flow_velocity_to_x0,
    with_cfg,
)
from ..diffusion.sa_solver import sa_solver_sample
from ..diffusion.unipc import unipc_sample
from ..models.wan import WanModel


@torch.no_grad()
def sample_video_latents(
    model: WanModel,
    text_emb: torch.Tensor,  # [B, text_len, text_dim]
    null_emb: Optional[torch.Tensor] = None,
    latent_shape: Tuple[int, int, int, int] = (21, 60, 100, 16),
    cfg_scale: float = 5.0,
    num_steps: int = 20,
    solver: str = "dpm-solver",  # dpm-solver | flow_euler | unipc | sa-solver
    flow_shift: float = 3.0,
    generator: Optional[torch.Generator] = None,
    clip_fea: Optional[torch.Tensor] = None,  # [B, 257, image_dim] (i2v)
) -> torch.Tensor:
    """Sampled latents [B, F, H, W, C], float32, on the model's device.
    ``generator`` (on that device) draws the starting noise and then
    SA-Solver's noise; seed 0 when None. An i2v model needs ``clip_fea``,
    which is tiled to the batch of each model call (CFG doubles it)."""
    cfg = model.cfg
    device = next(model.parameters()).device
    if cfg.model_type == "i2v" and clip_fea is None:
        raise ValueError("i2v sampling requires clip_fea (models.clip.encode_i2v_features on "
                         "the conditioning frame)")
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    text_emb = text_emb.to(device)
    null_emb = torch.zeros_like(text_emb) if null_emb is None else null_emb.to(device)
    fea = None if clip_fea is None else clip_fea.to(device, cfg.dtype)

    def velocity(x_t, t, ctx):
        kwargs = {}
        if fea is not None:
            kwargs["clip_fea"] = fea.repeat(x_t.shape[0] // fea.shape[0], 1, 1)
        return model(x_t.to(cfg.dtype), t * 1000.0, ctx.to(cfg.dtype), **kwargs).float()

    cfg_velocity = with_cfg(velocity, text_emb, null_emb, cfg_scale)
    shape = (text_emb.shape[0], *latent_shape)
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    if solver == "dpm-solver":
        return dpm_solver_pp(
            flow_velocity_to_x0(cfg_velocity), x, num_steps=num_steps, order=2, shift=flow_shift
        )
    if solver == "flow_euler":
        return flow_euler_sample_loop(cfg_velocity, x, num_steps=num_steps, shift=flow_shift)
    if solver == "unipc":
        return unipc_sample(
            flow_velocity_to_x0(cfg_velocity), x, num_steps=num_steps, order=2, shift=flow_shift
        )
    if solver == "sa-solver":
        return sa_solver_sample(
            flow_velocity_to_x0(cfg_velocity), x, num_steps=num_steps, shift=flow_shift,
            generator=generator,
        )
    raise ValueError(f"unknown solver {solver}")
