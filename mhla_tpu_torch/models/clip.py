"""The CLIP ViT-H/14 image tower of image-to-video (counterpart of the vision
half of ``mhla_tpu/models/clip.py``).

Wan2.1's i2v pipeline feeds the conditioning frame through the vision tower
of an open-clip XLM-RoBERTa ViT-H/14 with ``use_31_block``: the hidden states
after the penultimate block, [B, 257, 1280] (the class token and 16 x 16
patches of 14 pixels), which ``WanModel``'s image embedding projects into its
cross-attention context.

- :func:`preprocess_frames`: [-1, 1] NHWC frames -> CLIP-normalized 224 x 224,
  resized with Keys' cubic kernel (a = -0.5) and, when shrinking, the kernel
  widened by the scale (antialiasing), as ``jax.image.resize(..., "cubic")``
  does; ``F.interpolate(mode="bicubic")`` (a = -0.75, no antialiasing) is not
  that resize
- :class:`CLIPVisionTransformer`: the patch embedding, class token, learned
  positions (bicubically interpolated to another grid on request), the
  pre-norm and the pre-norm blocks (fused-qkv attention through ``sdpa``,
  which keeps head dim 80 on the plain path, and an exact-GELU MLP)
- converters from the reference's ``visual.*`` naming and from HuggingFace's
  ``CLIPVisionModel`` naming to the JAX package's param tree, and
  :func:`clip_params_from_jax` from that tree to this module's state dict

Not ported: the XLM-RoBERTa text tower and the contrastive head, which no
image-to-video path runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers.attention import sdpa
from ..layers.fused_dense import dense
from ..layers.norms import LayerNorm
from .convert_jax import _state_dict_from_flax

# CLIP's preprocessing constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: float = 4.0
    out_dim: int = 1024
    num_heads: int = 16
    num_layers: int = 32
    pool_type: str = "token"  # token | token_fc | none
    pre_norm: bool = True
    post_norm: bool = False
    activation: str = "gelu"  # gelu | quick_gelu
    eps: float = 1e-5
    dtype: torch.dtype = torch.float32  # compute dtype; parameters stay float32


# Wan2.1's i2v conditioning encoder: open-clip xlm-roberta-large ViT-H/14
CLIP_VIT_H_14 = CLIPVisionConfig()


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return F.gelu  # exact, not tanh


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 at |offset| ``x``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """The [in_size, out_size] float32 matrix of ``jax.image.resize``'s cubic
    resize along one axis: half-pixel centres, the kernel widened by
    in / out when shrinking, each output's weights normalised to sum 1, and
    outputs whose sample point lies outside the input given none."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = _keys_cubic(torch.abs(sample[None, :] - src[:, None]) / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, height, width, C] as ``jax.image.resize(x, ...,
    "cubic")`` (antialiased when shrinking), in float32."""
    x = x.float()
    if x.shape[1] != height:
        x = torch.einsum("bhwc,hy->bywc", x, cubic_weights(x.shape[1], height, x.device))
    if x.shape[2] != width:
        x = torch.einsum("bhwc,wx->bhxc", x, cubic_weights(x.shape[2], width, x.device))
    return x


def pos_interpolate(pos: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Bicubic grid interpolation of learned positions: ``pos`` [1, n + g*g,
    dim] -> [1, n + s*s, dim] with s*s + n = ``seq_len``; the n prefix (class)
    entries pass through."""
    if pos.shape[1] == seq_len:
        return pos
    src = int(math.sqrt(pos.shape[1]))
    tar = int(math.sqrt(seq_len))
    n = pos.shape[1] - src * src
    grid = resize_cubic(pos[:, n:].reshape(1, src, src, -1), tar, tar)
    return torch.cat([pos[:, :n].float(), grid.reshape(1, tar * tar, -1)], dim=1)


class CLIPAttention(nn.Module):
    """Fused-qkv multi-head attention."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.to_qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape
        q, k, v = dense(x, self.to_qkv).reshape(b, s, 3, self.num_heads, -1).unbind(dim=2)
        return dense(sdpa(q, k, v).reshape(b, s, dim), self.proj)


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.post_norm = cfg.post_norm
        self.norm1 = LayerNorm(cfg.dim, cfg.eps, device=device)
        self.norm2 = LayerNorm(cfg.dim, cfg.eps, device=device)
        self.attn = CLIPAttention(cfg.dim, cfg.num_heads, device=device)
        mid = int(cfg.dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.dim, mid, device=device)
        self.fc2 = nn.Linear(mid, cfg.dim, device=device)
        self.act = _act(cfg.activation)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.act(dense(x, self.fc1)), self.fc2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.post_norm:
            x = x + self.norm1(self.attn(x))
            return x + self.norm2(self.mlp(x))
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class CLIPVisionTransformer(nn.Module):
    """The i2v image tower. Input NHWC in CLIP-normalized space; output the
    hidden states [B, 1 + patches, dim] after the last block, or with
    ``use_31_block`` after the penultimate one (the post-norm and the head
    feed only the contrastive path, which i2v never runs)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIP_VIT_H_14, device=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.has_cls = cfg.pool_type in ("token", "token_fc")
        self.patch_embedding = nn.Conv2d(3, cfg.dim, p, p, bias=not cfg.pre_norm, device=device)
        if self.has_cls:
            self.cls_embedding = nn.Parameter(torch.zeros(1, 1, cfg.dim, device=device))
        n_patches = (cfg.image_size // p) ** 2
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, n_patches + int(self.has_cls), cfg.dim, device=device))
        self.pre_norm = LayerNorm(cfg.dim, cfg.eps, device=device) if cfg.pre_norm else None
        self.blocks = nn.ModuleList(CLIPBlock(cfg, device) for _ in range(cfg.num_layers))

    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        """The strided patch convolution ('SAME' zero padding of ragged
        edges) as one matmul over flattened patches: [B, H, W, 3] -> [B,
        patches, dim]."""
        p = self.cfg.patch_size
        pad = []
        for size in reversed(x.shape[1:3]):
            total = (-size) % p
            pad += [total // 2, total - total // 2]
        if any(pad):
            x = F.pad(x, [0, 0, *pad])
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        conv = self.patch_embedding
        weight = conv.weight.permute(0, 2, 3, 1).reshape(conv.out_channels, -1).to(x.dtype)
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        return F.linear(x, weight, bias)

    def forward(self, x: torch.Tensor, use_31_block: bool = False,
                interpolation: bool = False) -> torch.Tensor:
        cfg = self.cfg
        h = self._patchify(x.to(cfg.dtype))
        if self.has_cls:
            cls = self.cls_embedding.to(h.dtype).expand(h.shape[0], 1, cfg.dim)
            h = torch.cat([cls, h], dim=1)
        pos = self.pos_embedding
        if interpolation:
            pos = pos_interpolate(pos, h.shape[1])
        h = h + pos.to(h.dtype)
        if self.pre_norm is not None:
            h = self.pre_norm(h)
        n = cfg.num_layers - 1 if use_31_block else cfg.num_layers
        for block in self.blocks[:n]:
            h = block(h)
        return h


def preprocess_frames(frames: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[-1, 1] NHWC frames -> CLIP-normalized [B, image_size, image_size, C]
    float32: the cubic resize of ``jax.image.resize``, then [0, 1], then
    CLIP's mean and std."""
    x = resize_cubic(frames, image_size, image_size)
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x * 0.5 + 0.5 - mean) / std


@torch.no_grad()
def encode_i2v_features(model: CLIPVisionTransformer, frames: torch.Tensor) -> torch.Tensor:
    """The first-frame conditioning features of the Wan i2v branch:
    preprocess, then the hidden states after the penultimate block, [B, 257,
    1280] for ViT-H/14."""
    x = preprocess_frames(frames.to(next(model.parameters()).device), model.cfg.image_size)
    return model(x, use_31_block=True)


@torch.no_grad()
def init_clip_params(model: CLIPVisionTransformer, generator: torch.Generator
                     ) -> CLIPVisionTransformer:
    """Draw the parameters in place as the JAX module's flax initializers do:
    every projection and the patch convolution from a normal of std
    sqrt(1 / fan_in) truncated at two standard deviations (rescaled to unit
    variance), their biases zero, the class token and the positions from
    normal(dim**-0.5); norm weights stay one. ``generator`` lives on the
    parameters' device."""
    from .initializers import lecun_normal_

    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            lecun_normal_(module.weight, generator)
            if module.bias is not None:
                module.bias.zero_()
    gain = model.cfg.dim ** -0.5
    for name in ("cls_embedding", "pos_embedding"):
        if hasattr(model, name):
            getattr(model, name).normal_(0.0, gain, generator=generator)
    return model


# ---------------------------------------------------------------------------
# Checkpoint converters: torch state dicts -> the JAX package's param tree
# ---------------------------------------------------------------------------


def _ln(state, prefix):
    return {"scale": np.asarray(state[prefix + ".weight"]),
            "bias": np.asarray(state[prefix + ".bias"])}


def _dense(state, prefix, bias=True):
    out = {"kernel": np.asarray(state[prefix + ".weight"]).T}
    if bias:
        out["bias"] = np.asarray(state[prefix + ".bias"])
    return out


def convert_clip_vision(state: Mapping[str, Any], cfg: CLIPVisionConfig = CLIP_VIT_H_14,
                        prefix: str = "visual.") -> Dict:
    """The reference's ``VisionTransformer`` naming -> ``{"params": tree}``
    in the JAX package's layout; ``patch_embedding.weight`` [D, 3, p, p]
    becomes the HWIO kernel [p, p, 3, D]."""
    g = lambda k: np.asarray(state[prefix + k])  # noqa: E731
    params: Dict[str, Any] = {
        "patch_embedding": {"kernel": g("patch_embedding.weight").transpose(2, 3, 1, 0)},
        "pos_embedding": g("pos_embedding"),
    }
    if not cfg.pre_norm:
        params["patch_embedding"]["bias"] = g("patch_embedding.bias")
    else:
        params["pre_norm"] = _ln(state, prefix + "pre_norm")
    if cfg.pool_type in ("token", "token_fc"):
        params["cls_embedding"] = g("cls_embedding")
    for i in range(cfg.num_layers):
        p = f"{prefix}transformer.{i}."
        params[f"blocks_{i}"] = {
            "norm1": _ln(state, p + "norm1"),
            "norm2": _ln(state, p + "norm2"),
            "attn": {"to_qkv": _dense(state, p + "attn.to_qkv"),
                     "proj": _dense(state, p + "attn.proj")},
            "fc1": _dense(state, p + "mlp.0"),
            "fc2": _dense(state, p + "mlp.2"),
        }
    return {"params": params}


def convert_clip_checkpoint(state: Mapping[str, Any],
                            vision: CLIPVisionConfig = CLIP_VIT_H_14) -> Dict:
    """The image tower of a full reference ``XLMRobertaCLIP`` state dict (the
    Wan2.1 i2v conditioning checkpoint): ``{"params": {"visual": tree}}``,
    the ``visual`` part of the JAX package's tree. The text tower
    (``textual.*``) and ``log_scale`` are left unread."""
    return {"params": {"visual": convert_clip_vision(state, vision, "visual.")["params"]}}


def convert_hf_clip_vision(state: Mapping[str, Any], cfg: CLIPVisionConfig) -> Dict:
    """A HuggingFace ``CLIPVisionModel`` state dict -> ``{"params": tree}``;
    HF's separate q / k / v projections are fused into ``to_qkv``."""
    pre = "vision_model."
    params: Dict[str, Any] = {
        "patch_embedding": {"kernel": np.asarray(
            state[pre + "embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)},
        "cls_embedding": np.asarray(state[pre + "embeddings.class_embedding"]).reshape(1, 1, -1),
        "pos_embedding": np.asarray(state[pre + "embeddings.position_embedding.weight"])[None],
        "pre_norm": _ln(state, pre + "pre_layrnorm"),
    }
    for i in range(cfg.num_layers):
        p = f"{pre}encoder.layers.{i}."
        qkv_w = np.concatenate([np.asarray(state[p + f"self_attn.{n}_proj.weight"]) for n in "qkv"])
        qkv_b = np.concatenate([np.asarray(state[p + f"self_attn.{n}_proj.bias"]) for n in "qkv"])
        params[f"blocks_{i}"] = {
            "norm1": _ln(state, p + "layer_norm1"),
            "norm2": _ln(state, p + "layer_norm2"),
            "attn": {"to_qkv": {"kernel": qkv_w.T, "bias": qkv_b},
                     "proj": _dense(state, p + "self_attn.out_proj")},
            "fc1": _dense(state, p + "mlp.fc1"),
            "fc2": _dense(state, p + "mlp.fc2"),
        }
    return {"params": params}


def clip_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``CLIPVisionTransformer``'s param tree (``{"params": ...}`` or
    the inner tree, numpy leaves) -> float32 state dict of
    :class:`CLIPVisionTransformer`: flax LayerNorm's ``scale`` is ``weight``,
    the rest as ``convert_jax`` bridges every model."""
    return {(k[: -len("scale")] + "weight" if k.endswith(".scale") else k): v
            for k, v in _state_dict_from_flax(params).items()}
