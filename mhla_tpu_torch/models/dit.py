"""DiT with MHLA attention, the class-conditional latent diffusion backbone
(counterpart of ``mhla_tpu/models/dit.py``).

adaLN-Zero blocks whose attention is :class:`~mhla_tpu_torch.layers.MHLA2D`
with trainable mixing (clamped to [0, 1] where it is read), qkv bias and a
3x3 LePE; the patch tokens go block-major after the patch embedding and
back before the unpatchify; frozen 2-D sin-cos position embeddings; CFG
guides only the first ``in_channels`` output channels. Latents are NHWC.

``cfg.dtype`` is the compute dtype over float32 parameters (flax
``Dense(dtype)``): the patch convolution, every projection and the label
table are cast to it. :func:`init_dit_params` draws the JAX model's
initializers: xavier-uniform patch convolution, normal(0.02) timestep MLP and
label table, zeroed adaLN modulations and final layer, lecun-normal
elsewhere, and the identity LePE of ``_identity_depthwise_init``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import MHLA2D, MLP, LayerNorm, dense
from .initializers import lecun_normal_


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding [B] -> [B, dim] float32, cos first (the
    GLIDE convention)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def sincos_pos_embed_2d(dim: int, grid: int) -> np.ndarray:
    """The standard 2-D sin-cos position embedding [grid * grid, dim],
    float32: the x half, then the y half, each sin then cos."""

    def one_dim(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2))
        out = np.einsum("m,d->md", pos.ravel(), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gy, gx = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    return np.concatenate([one_dim(dim // 2, gx), one_dim(dim // 2, gy)], axis=1).astype(
        np.float32)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, freq_size: int = 256, device=None):
        super().__init__()
        self.freq_size = freq_size
        self.fc1 = nn.Linear(freq_size, hidden_size, device=device)
        self.fc2 = nn.Linear(hidden_size, hidden_size, device=device)

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = timestep_embedding(t, self.freq_size).to(dtype)
        return dense(F.silu(dense(h, self.fc1)), self.fc2)


class LabelEmbedder(nn.Module):
    """Class-label embedding; with ``dropout_prob`` > 0 the table has one more
    row, the null class, that CFG dropout and ``force_drop`` select."""

    def __init__(self, num_classes: int, hidden_size: int, dropout_prob: float = 0.1,
                 device=None):
        super().__init__()
        self.num_classes, self.dropout_prob = num_classes, dropout_prob
        self.table = nn.Embedding(num_classes + int(dropout_prob > 0), hidden_size,
                                  device=device)

    def forward(self, labels: torch.Tensor, dtype: torch.dtype, train: bool = False,
                force_drop: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``force_drop`` [B] bool sends those labels to the null class;
        otherwise, with ``train``, each label drops with ``dropout_prob`` by a
        uniform draw from ``generator`` (on the labels' device)."""
        if force_drop is not None:
            labels = torch.where(force_drop, self.num_classes, labels)
        elif train and self.dropout_prob > 0:
            u = torch.rand(labels.shape, generator=generator, device=labels.device)
            labels = torch.where(u < self.dropout_prob, self.num_classes, labels)
        return F.embedding(labels, self.table.weight).to(dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None]) + shift[:, None]


@torch.no_grad()
def identity_depthwise_(conv: nn.Module) -> nn.Module:
    """In place: a depthwise (LePE) convolution that starts as the identity,
    zero but a one at the kernel's center, zero bias (the JAX model's
    ``_identity_depthwise_init``, the reference's ``_basic_init``)."""
    conv.weight.zero_()
    conv.weight[(slice(None), 0, *(k // 2 for k in conv.weight.shape[2:]))] = 1.0
    if conv.bias is not None:
        conv.bias.zero_()
    return conv


class DiTBlockMHLA(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, blocks_per_side: int, block_len: int,
                 mlp_ratio: float = 4.0, transform: str = "linear", device=None):
        super().__init__()
        d = hidden_size
        self.adaLN_modulation = nn.Linear(d, 6 * d, device=device)
        self.norm1 = LayerNorm(d, use_bias=False, use_scale=False)
        self.attn = MHLA2D(d, num_heads, blocks_per_side, block_len, transform,
                           trainable_mixing=True, qkv_bias=True, lepe_kernel=3,
                           use_input_norm=True, device=device)
        self.norm2 = LayerNorm(d, use_bias=False, use_scale=False)
        self.mlp = MLP(d, int(d * mlp_ratio), activation="gelu", device=device)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x: [B, N_blocks, C_block, D] block-major; c: [B, D]."""
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = (
            m[:, None, None] for m in dense(F.silu(c), self.adaLN_modulation).chunk(6, dim=-1))
        h = (self.norm1(x) * (1 + sc_msa) + s_msa).to(x.dtype)
        x = x + g_msa * self.attn(h)
        h = (self.norm2(x) * (1 + sc_mlp) + s_mlp).to(x.dtype)
        return x + g_mlp * self.mlp(h)


@dataclasses.dataclass
class DiTConfig:
    input_size: int = 32
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    class_dropout_prob: float = 0.1
    num_classes: int = 1000
    learn_sigma: bool = True
    block_size: int = 16  # tokens per block (piece_size ** 2)
    transform: str = "linear"
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.input_size // self.patch_size

    @property
    def piece_size(self) -> int:
        return int(math.isqrt(self.block_size))

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels


class DiT(nn.Module):
    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, g, ps = cfg.hidden_size, cfg.grid, cfg.piece_size
        self.x_embedder = nn.Conv2d(cfg.in_channels, d, cfg.patch_size, stride=cfg.patch_size,
                                    device=device)
        self.register_buffer("pos_embed", torch.from_numpy(sincos_pos_embed_2d(d, g))[None].to(
            device), persistent=False)
        self.t_embedder = TimestepEmbedder(d, device=device)
        self.y_embedder = LabelEmbedder(cfg.num_classes, d, cfg.class_dropout_prob, device)
        self.blocks = nn.ModuleList(
            DiTBlockMHLA(d, cfg.num_heads, g // ps, ps, cfg.mlp_ratio, cfg.transform, device)
            for _ in range(cfg.depth)
        )
        self.final_adaLN = nn.Linear(d, 2 * d, device=device)
        self.norm_final = LayerNorm(d, use_bias=False, use_scale=False)
        self.final_linear = nn.Linear(d, cfg.patch_size ** 2 * cfg.out_channels, device=device)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor, train: bool = False,
                force_drop: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, H, W, C] latents (NHWC), t [B] timesteps, y [B] int labels ->
        [B, H, W, out_channels] in the compute dtype. ``train``, ``force_drop``
        and ``generator``: the label dropout (:class:`LabelEmbedder`)."""
        cfg = self.cfg
        b, dt = x.shape[0], cfg.dtype
        g, p, ps, d = cfg.grid, cfg.patch_size, cfg.piece_size, cfg.hidden_size
        nb = g // ps
        conv = self.x_embedder
        h = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt),
                     stride=conv.stride)
        h = h.permute(0, 2, 3, 1).reshape(b, g * g, d) + self.pos_embed.to(dt)
        # block-major piecewise order, kept as [B, N, C, D] through the blocks
        h = h.reshape(b, nb, ps, nb, ps, d).transpose(2, 3).reshape(b, nb * nb, ps * ps, d)
        c = self.t_embedder(t, dt) + self.y_embedder(y, dt, train, force_drop, generator)
        for block in self.blocks:
            h = block(h, c)
        shift, scale = dense(F.silu(c), self.final_adaLN).chunk(2, dim=-1)
        h = self.norm_final(h) * (1 + scale[:, None, None]) + shift[:, None, None]
        h = dense(h, self.final_linear)
        # invert the piecewise order, then unpatchify to NHWC
        h = h.reshape(b, nb, nb, ps, ps, -1).transpose(2, 3).reshape(b, g, g, p, p, -1)
        return h.transpose(2, 3).reshape(b, g * p, g * p, cfg.out_channels)

    def forward_with_cfg(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                         cfg_scale: float) -> torch.Tensor:
        """Classifier-free guidance on the first ``in_channels`` (eps) only.
        x is the doubled batch [cond; uncond copy]; y its labels, the null
        class in the second half."""
        half = x[: x.shape[0] // 2]
        out = self(torch.cat([half, half]), t, y)
        c = self.cfg.in_channels
        cond, uncond = out[..., :c].chunk(2)
        guided = uncond + cfg_scale * (cond - uncond)
        return torch.cat([torch.cat([guided, guided]), out[..., c:]], dim=-1)


_DIT_SIZES = {
    "XL": dict(depth=28, hidden_size=1152, num_heads=16),
    "L": dict(depth=24, hidden_size=1024, num_heads=16),
    "L-half": dict(depth=12, hidden_size=1024, num_heads=16),
    "L-half-small-head": dict(depth=12, hidden_size=1024, num_heads=8),
    "B": dict(depth=12, hidden_size=768, num_heads=12),
    "S": dict(depth=12, hidden_size=384, num_heads=6),
}


def build_dit(name: str, device=None, **overrides) -> Tuple[DiT, DiTConfig]:
    """``DiT-S/2``-style names (the reference's ``DiT_models``); explicit
    overrides beat the size preset."""
    size, patch = name[len("DiT-"):].rsplit("/", 1)
    cfg = DiTConfig(**{"patch_size": int(patch), **_DIT_SIZES[size], **overrides})
    return DiT(cfg, device=device), cfg


DiT_models = [f"DiT-{s}/{p}" for s in _DIT_SIZES for p in (2, 4, 8)]


@torch.no_grad()
def init_dit_params(model: DiT, generator: torch.Generator) -> DiT:
    """Draw the parameters in place (see the module docstring); the mixing
    matrices keep their distance-transform start. ``generator`` lives on the
    parameters' device."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            lecun_normal_(module.weight, generator)
            module.bias.zero_()
    w = model.x_embedder.weight  # flax fans of the kernel [p, p, C_in, D]
    fan_in, fan_out = w[0].numel(), w.shape[0] * w[0, 0].numel()
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-limit, limit, generator=generator)
    model.x_embedder.bias.zero_()
    for lin in (model.t_embedder.fc1, model.t_embedder.fc2):
        lin.weight.normal_(0.0, 0.02, generator=generator)
    model.y_embedder.table.weight.normal_(0.0, 0.02, generator=generator)
    for block in model.blocks:
        identity_depthwise_(block.attn.lepe)
        block.adaLN_modulation.weight.zero_()
        block.adaLN_modulation.bias.zero_()
    for lin in (model.final_adaLN, model.final_linear):
        lin.weight.zero_()
        lin.bias.zero_()
    return model
