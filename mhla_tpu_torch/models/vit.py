"""MHLA Vision Transformer, the DeiT-style image classifier (counterpart of
``mhla_tpu/models/vit.py``).

NHWC images are padded to ``img_size``, embedded by a strided patch
convolution, given learned position embeddings (no class token) and
rearranged block-major into ``piece_size x piece_size`` blocks of patches;
pre-norm blocks run MHLA (``MHLA2D``), global linear attention
(``LinearAttention2D``) or softmax attention (``sdpa``, which routes as the
JAX package does: 256 tokens stay on the plain product); mean pooling over
the tokens and a float32 classifier head close it.

``cfg.dtype`` is the compute dtype: parameters stay float32 and every
projection and convolution casts its weight to the activation's dtype, as
flax ``Dense(dtype)`` / ``Conv(dtype)`` do; the head computes in float32.
Registry names: ``deit_{tiny,small,base}_{mhla,linear,softmax}``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import MHLA2D, MLP, LayerNorm, LinearAttention2D, RMSNorm, dense, sdpa
from .initializers import lecun_normal_, trunc_normal_


@dataclasses.dataclass
class ViTConfig:
    img_size: int = 256
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    piece_size: int = 4  # blocks of piece_size x piece_size patches
    attn_type: str = "mhla"  # mhla | linear | softmax
    transform: str = "linear"
    exp_sigma: float = 3.0
    local_thres: float = 1.5
    qk_norm: bool = True
    qkv_bias: bool = True
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size  # patches per side

    @property
    def blocks_per_side(self) -> int:
        return self.grid // self.piece_size


class SoftmaxAttention(nn.Module):
    """Softmax self-attention of the ``softmax`` ViT: one qkv projection,
    optional per-head RMSNorm on q and k, ``sdpa``, the output projection."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, qk_norm: bool, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = RMSNorm(dim // num_heads, device=device)
            self.k_norm = RMSNorm(dim // num_heads, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, dim = x.shape
        q, k, v = (y.reshape(b, t, self.num_heads, -1) for y in dense(x, self.qkv).chunk(3, -1))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        return dense(sdpa(q, k, v).reshape(b, t, dim), self.proj)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.attn_type = cfg.attn_type
        self.norm1 = LayerNorm(d, device=device)
        if cfg.attn_type == "mhla":
            self.attn = MHLA2D(
                d, cfg.num_heads, cfg.blocks_per_side, cfg.piece_size, cfg.transform,
                cfg.local_thres, cfg.exp_sigma, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                lepe_kernel=5, device=device,
            )
        elif cfg.attn_type == "linear":
            self.attn = LinearAttention2D(d, cfg.num_heads, device=device)
        elif cfg.attn_type == "softmax":
            self.attn = SoftmaxAttention(d, cfg.num_heads, cfg.qkv_bias, cfg.qk_norm, device)
        else:
            raise ValueError(f"unknown attn_type {cfg.attn_type!r}")
        self.norm2 = LayerNorm(d, device=device)
        self.mlp = MLP(d, int(d * cfg.mlp_ratio), activation="gelu", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, N_blocks, C_block, D] block-major tokens."""
        h = self.norm1(x)
        if self.attn_type == "mhla":
            h = self.attn(h)
        else:  # the global attentions see the blocks as one flat sequence
            h = self.attn(h.flatten(1, 2)).reshape(x.shape)
        x = x + h
        return x + self.mlp(self.norm2(x))


class MHLAViT(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        g, d = cfg.grid, cfg.embed_dim
        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, g * g, d, device=device))
        self.blocks = nn.ModuleList(ViTBlock(cfg, device) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, device=device)
        self.head = nn.Linear(d, cfg.num_classes, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] (NHWC), zero-padded to ``img_size`` when
        smaller, the odd pixel after -> logits [B, num_classes] float32."""
        cfg = self.cfg
        b, dt = images.shape[0], cfg.dtype
        ph, pw = cfg.img_size - images.shape[1], cfg.img_size - images.shape[2]
        x = images.to(dt).permute(0, 3, 1, 2)
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        conv = self.patch_embed
        x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride)
        g, p, nb, d = cfg.grid, cfg.piece_size, cfg.blocks_per_side, cfg.embed_dim
        x = x.permute(0, 2, 3, 1).reshape(b, g * g, d) + self.pos_embed.to(dt)
        # block-major rearrange: (nb p) (nb p) -> (nb nb) (p p)
        x = x.reshape(b, nb, p, nb, p, d).transpose(2, 3).reshape(b, nb * nb, p * p, d)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x).reshape(b, -1, d).mean(dim=1)
        return F.linear(x.float(), self.head.weight.float(), self.head.bias.float())


VIT_SIZES = {
    "tiny": dict(embed_dim=192, num_heads=3),
    "small": dict(embed_dim=384, num_heads=6),
    "base": dict(embed_dim=768, num_heads=12),
}


def build_vit(name: str, device=None, **overrides) -> Tuple[MHLAViT, ViTConfig]:
    """``deit_{tiny,small,base}_{mhla,linear,softmax}`` factory."""
    parts = name.split("_")
    if parts[0] != "deit" or len(parts) < 3:
        raise ValueError(f"not a deit_<size>_<attn> name: {name!r}")
    cfg = ViTConfig(attn_type=parts[2], **{**VIT_SIZES[parts[1]], **overrides})
    return MHLAViT(cfg, device=device), cfg


@torch.no_grad()
def init_vit_params(model: MHLAViT, generator: torch.Generator) -> MHLAViT:
    """Draw the parameters in place as the JAX model's flax initializers do:
    every projection and convolution lecun-normal with zero bias,
    ``pos_embed`` truncated normal(0.02); norm weights stay one. The
    ``generator`` lives on the parameters' device."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            lecun_normal_(module.weight, generator)
            if module.bias is not None:
                module.bias.zero_()
    trunc_normal_(model.pos_embed, 0.02, generator)
    return model
