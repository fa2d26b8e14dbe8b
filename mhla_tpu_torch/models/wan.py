"""Wan video diffusion transformer with MHLA attention (counterpart of
``mhla_tpu/models/wan.py``), forward and, through the kernels' gradients,
backward.

- patch embedding over (F, H, W) latents, patch (1, 2, 2)
- float32 sinusoidal time embedding -> 6-way adaLN modulation (a learned
  per-block ``modulation`` added to the shared projection)
- every layer listed in ``linear_attn_idx`` runs :class:`MHLA3D`; the
  others run :class:`WanSelfAttention` (softmax with 3-D RoPE): dense
  (``sdpa``), or radial-sparse for the layers in ``sparse_attn_idx``, which
  fall back to dense while the denoising timestep is at or above
  ``sparse_dense_from_t``
- text cross-attention in every block (``sdpa``: the flash kernel at video
  lengths); image-to-video (``model_type='i2v'``) projects CLIP ViT-H/14
  features [B, 257, 1280] (``models.clip.encode_i2v_features``) through
  ``img_norm_in`` / ``img_fc1`` / ``img_fc2`` / ``img_norm_out``, puts them
  before the text tokens of the context, and every cross-attention runs a
  second attention over them (``k_img``, ``norm_k_img``, ``v_img``) whose
  output is added before ``o``. As in the JAX model, i2v is conditioned on
  the CLIP features alone: there is no first-frame latent input
- ``capture``: the forward also returns each block's self-attention output
  and block output (``{"attn_out": [...], "block_out": [...]}``), for
  teacher distillation; it works under remat
- ``grid_adjust``: each grid axis is cropped to a multiple of the block
  layout, e.g. (30, 52) -> (30, 50)
- ``remat``: where autograd records, each block is recomputed in the backward
  (``torch.utils.checkpoint``, as the JAX model wraps ``WanBlock`` in
  ``nn.remat``), so a training step keeps one block's activations and every
  block's input; a call without gradients (sampling) is not affected

Parameters may stay float32 while ``cfg.dtype`` is bf16: every projection
casts its weight to the activation's dtype, as flax ``Dense(dtype)`` does;
the time embedding and the adaLN arithmetic are float32 whatever the dtype.

Not ported yet, raising ``NotImplementedError``: the linear baselines
(``attn_type`` other than ``mhla_uni``), the only layers that read
``rope_after``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..layers.attention import sdpa
from ..layers.fused_dense import dense
from ..layers.mhla_vision import MHLA3D
from ..layers.norms import LayerNorm, RMSNorm
from ..kernels.sparse_attention import sparse_flash_attention
from ..ops.rotary import apply_rotary_3d_halves, rope_angles_3d_on, rope_tables_flat
from .initializers import lecun_normal_


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """float32 sinusoid of [B] positions -> [B, dim], cos first."""
    half = dim // 2
    freqs = torch.pow(
        10000.0, -torch.arange(half, dtype=torch.float32, device=position.device) / half
    )
    args = (position.float()[:, None] * freqs[None]).double()  # cos and sin rounded once
    return torch.cat([torch.cos(args), torch.sin(args)], dim=1).float()


@dataclasses.dataclass
class WanConfig:
    model_type: str = "t2v"  # t2v | i2v
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    image_dim: int = 1280
    img_tokens: int = 257  # CLIP ViT-H/14 patch tokens + cls (i2v)
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 12
    num_layers: int = 30
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    linear_attn_idx: Optional[Tuple[int, ...]] = None  # the layers that run attn_type
    attn_type: str = "mhla_uni"
    # layers that run radial-sparse softmax attention; they run dense attention
    # instead while max(t) >= sparse_dense_from_t (None: no guard, as the video
    # trainer builds the model)
    sparse_attn_idx: Optional[Tuple[int, ...]] = None
    sparse_dense_from_t: Optional[float] = 850.0
    rope_after: bool = True  # read by the linear baselines alone (not ported)
    without_rope: bool = False
    normalize_out: bool = False
    is_gated: bool = True
    is_lepe: bool = False
    block_layout: Tuple[int, int, int] = (3, 5, 10)
    grid_adjust: bool = True
    remat: bool = False
    dtype: torch.dtype = torch.float32  # activation (compute) dtype
    attn_compute_dtype: Optional[torch.dtype] = None  # MHLA island; None = float32

    def layer_attn_type(self, i: int) -> str:
        if self.linear_attn_idx is not None and i in self.linear_attn_idx:
            return self.attn_type
        if self.sparse_attn_idx is not None and i in self.sparse_attn_idx:
            return "sparse"
        return "flash"


WAN_1300M = dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30)
WAN_14B = dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)


def build_wan_config(model_name: str = "Wan_T2V_1300M", **overrides) -> WanConfig:
    """The named model's sizes with ``overrides`` on top."""
    if "1300M" in model_name or "1.3B" in model_name:
        base = WAN_1300M
    elif "14B" in model_name:
        base = WAN_14B
    else:
        raise ValueError(f"Model {model_name} not found")
    kwargs: dict[str, Any] = dict(base)
    if "i2v" in model_name.lower():
        kwargs["model_type"] = "i2v"
    kwargs.update(overrides)
    return WanConfig(**kwargs)


class WanSelfAttention(nn.Module):
    """Softmax self-attention with 3-D RoPE: full-dim RMSNorm on q and k,
    rotate-half rotary per head, then dense attention (``sdpa``) or, with
    ``sparse``, radial-sparse attention over the grid's frames unless the
    caller asks for dense (``use_dense``)."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = True, eps: float = 1e-6,
                 sparse: bool = False, device=None):
        super().__init__()
        self.num_heads, self.sparse = num_heads, sparse
        for name in ("q", "k", "v", "o"):
            setattr(self, name, nn.Linear(dim, dim, bias=True, device=device))
        self.norm_q = RMSNorm(dim, eps=eps, device=device) if qk_norm else None
        self.norm_k = RMSNorm(dim, eps=eps, device=device) if qk_norm else None

    def forward(self, x: torch.Tensor, grid: Tuple[int, int, int],
                use_dense: bool = False) -> torch.Tensor:
        b, t, dim = x.shape
        h = self.num_heads
        q, k, v = dense(x, self.q), dense(x, self.k), dense(x, self.v)
        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)
        angles = rope_angles_3d_on(grid, dim // h, device=x.device)
        q = apply_rotary_3d_halves(q.reshape(b, t, h, -1), angles)
        k = apply_rotary_3d_halves(k.reshape(b, t, h, -1), angles)
        v = v.reshape(b, t, h, -1)
        if self.sparse and not use_dense:
            o = sparse_flash_attention(q, k, v, num_frames=grid[0])
        else:
            o = sdpa(q, k, v)
        return dense(o.reshape(b, t, dim), self.o)


class WanCrossAttention(nn.Module):
    """Text (t2v) or text + image (i2v) cross-attention: full-dim RMSNorm
    on q and k, softmax attention over the text tokens; with ``i2v`` the
    first ``img_tokens`` context rows are the image, attended through their
    own keys and values (``k_img`` with ``norm_k_img``, ``v_img``), and the
    two outputs are added before ``o``."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = True, eps: float = 1e-6,
                 i2v: bool = False, img_tokens: int = 257, device=None):
        super().__init__()
        self.num_heads, self.img_tokens = num_heads, img_tokens
        for name in ("q", "k", "v", "o") + (("k_img", "v_img") if i2v else ()):
            setattr(self, name, nn.Linear(dim, dim, bias=True, device=device))
        self.norm_q = RMSNorm(dim, eps=eps, device=device) if qk_norm else None
        self.norm_k = RMSNorm(dim, eps=eps, device=device) if qk_norm else None
        self.norm_k_img = RMSNorm(dim, eps=eps, device=device) if i2v else None

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, t, dim = x.shape
        h = self.num_heads
        heads = lambda y: y.reshape(b, -1, h, dim // h)  # noqa: E731
        if self.norm_k_img is not None:
            ctx_img, context = context[:, : self.img_tokens], context[:, self.img_tokens:]
        q, k = dense(x, self.q), dense(context, self.k)
        if self.norm_q is not None:
            q, k = self.norm_q(q), self.norm_k(k)
        q = heads(q)
        o = sdpa(q, heads(k), heads(dense(context, self.v))).reshape(b, t, dim)
        if self.norm_k_img is not None:
            k_img = self.norm_k_img(dense(ctx_img, self.k_img))
            o = o + sdpa(q, heads(k_img), heads(dense(ctx_img, self.v_img))).reshape(b, t, dim)
        return dense(o, self.o)


def _modulate(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """adaLN in float32 around a stream in the model dtype."""
    return (h.float() * (1 + scale[:, None]) + shift[:, None]).to(h.dtype)


def _gated_residual(x: torch.Tensor, h: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return (x.float() + h.float() * gate[:, None]).to(x.dtype)


class WanBlock(nn.Module):
    def __init__(self, cfg: WanConfig, layer_idx: int, device=None):
        super().__init__()
        self.attn_type = cfg.layer_attn_type(layer_idx)
        self.modulation = nn.Parameter(torch.zeros(1, 6, cfg.dim, device=device))
        self.norm1 = LayerNorm(cfg.dim, cfg.eps, use_bias=False, use_scale=False)
        if self.attn_type == "mhla_uni":
            self.self_attn = MHLA3D(
                dim=cfg.dim, num_heads=cfg.num_heads, blocks_layout=cfg.block_layout,
                qk_norm=cfg.qk_norm, is_gated=cfg.is_gated, is_lepe=cfg.is_lepe,
                without_rope=cfg.without_rope, normalize_out=cfg.normalize_out, eps=cfg.eps,
                attn_compute_dtype=cfg.attn_compute_dtype, device=device,
            )
        elif self.attn_type in ("flash", "sparse"):
            self.self_attn = WanSelfAttention(
                cfg.dim, cfg.num_heads, cfg.qk_norm, cfg.eps,
                sparse=self.attn_type == "sparse", device=device,
            )
        else:
            raise NotImplementedError(
                f"layer {layer_idx}: self-attention {self.attn_type!r} is not ported yet "
                "(mhla_uni, flash and sparse are)"
            )
        self.norm3 = LayerNorm(cfg.dim, cfg.eps, device=device) if cfg.cross_attn_norm else None
        self.cross_attn = WanCrossAttention(cfg.dim, cfg.num_heads, cfg.qk_norm, cfg.eps,
                                            i2v=cfg.model_type == "i2v",
                                            img_tokens=cfg.img_tokens, device=device)
        self.norm2 = LayerNorm(cfg.dim, cfg.eps, use_bias=False, use_scale=False)
        self.ffn_fc1 = nn.Linear(cfg.dim, cfg.ffn_dim, device=device)
        self.ffn_fc2 = nn.Linear(cfg.ffn_dim, cfg.dim, device=device)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, dim]
        e0: torch.Tensor,  # [B, 6, dim] float32 shared modulation
        context: torch.Tensor,  # [B, L_ctx, dim]
        grid: Tuple[int, int, int],
        rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        use_dense: bool = False,  # the sparse layers' early-step guard
        capture: bool = False,  # also return (attention output, block output)
    ):
        e = (self.modulation.float() + e0.float()).unbind(dim=1)
        h = _modulate(self.norm1(x), e[1], e[0])
        if self.attn_type == "mhla_uni":
            h = self.self_attn(h, grid, rope_tables)
        else:
            h = self.self_attn(h, grid, use_dense)
        attn_out = h
        x = _gated_residual(x, h, e[2])
        x = x + self.cross_attn(self.norm3(x) if self.norm3 is not None else x, context)
        h = dense(_modulate(self.norm2(x), e[4], e[3]), self.ffn_fc1)
        h = dense(F.gelu(h, approximate="tanh"), self.ffn_fc2)
        x = _gated_residual(x, h, e[5])
        return (x, (attn_out, x)) if capture else x


class WanModel(nn.Module):
    """The full video DiT. Latents in and velocity out are [B, F, H, W, C]."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        if cfg.model_type not in ("t2v", "i2v"):
            raise ValueError(f"model_type {cfg.model_type!r}: t2v or i2v")
        self.cfg = cfg
        self.patch_embedding = nn.Conv3d(cfg.in_dim, cfg.dim, cfg.patch_size, cfg.patch_size,
                                         device=device)
        self.time_fc1 = nn.Linear(cfg.freq_dim, cfg.dim, device=device)
        self.time_fc2 = nn.Linear(cfg.dim, cfg.dim, device=device)
        self.time_projection = nn.Linear(cfg.dim, cfg.dim * 6, device=device)
        self.text_fc1 = nn.Linear(cfg.text_dim, cfg.dim, device=device)
        self.text_fc2 = nn.Linear(cfg.dim, cfg.dim, device=device)
        if cfg.model_type == "i2v":
            self.img_norm_in = LayerNorm(cfg.image_dim, device=device)
            self.img_fc1 = nn.Linear(cfg.image_dim, cfg.image_dim, device=device)
            self.img_fc2 = nn.Linear(cfg.image_dim, cfg.dim, device=device)
            self.img_norm_out = LayerNorm(cfg.dim, device=device)
        self.blocks = nn.ModuleList(WanBlock(cfg, i, device) for i in range(cfg.num_layers))
        self.head_modulation = nn.Parameter(torch.zeros(1, 2, cfg.dim, device=device))
        self.head_norm = LayerNorm(cfg.dim, cfg.eps, use_bias=False, use_scale=False)
        self.head = nn.Linear(cfg.dim, math.prod(cfg.patch_size) * cfg.out_dim, device=device)

    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        """The strided patch convolution ('SAME' zero padding of ragged
        edges) as one matmul over flattened patches: [B, F, H, W, C] ->
        [B, f, gh, gw, dim]."""
        patch = self.cfg.patch_size
        pad = []
        for size, p in zip(reversed(x.shape[1:4]), reversed(patch)):
            total = (-size) % p
            pad += [total // 2, total - total // 2]
        if any(pad):
            x = F.pad(x, [0, 0, *pad])
        b, c = x.shape[0], x.shape[-1]
        f, gh, gw = (s // p for s, p in zip(x.shape[1:4], patch))
        x = x.reshape(b, f, patch[0], gh, patch[1], gw, patch[2], c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, f, gh, gw, -1)
        conv = self.patch_embedding
        w = conv.weight.permute(0, 2, 3, 4, 1).reshape(conv.out_channels, -1)
        return F.linear(x, w.to(x.dtype), conv.bias.to(x.dtype))

    def forward(
        self,
        x: torch.Tensor,  # [B, F, H, W, C_in]
        t: torch.Tensor,  # [B] timesteps (flow: t * 1000)
        context: torch.Tensor,  # [B, text_len, text_dim]
        clip_fea: Optional[torch.Tensor] = None,  # [B, img_tokens, image_dim] (i2v)
        capture: bool = False,  # also return the per-block intermediates
    ):
        """The velocity [B, F, H, W, out_dim]; with ``capture``, ``(velocity,
        {"attn_out": [...], "block_out": [...]})``, one entry per block.
        ``clip_fea`` is read by an i2v model alone, which needs it."""
        cfg = self.cfg
        if clip_fea is not None and cfg.model_type != "i2v":
            raise ValueError("clip_fea is read by an i2v model alone; this model is "
                             f"{cfg.model_type!r}")
        b = x.shape[0]
        pf, ph, pw = cfg.patch_size
        h = self._patchify(x.to(cfg.dtype))

        # crop each grid axis to a multiple of the block layout
        grid = tuple(h.shape[1:4])
        if cfg.grid_adjust and cfg.linear_attn_idx:
            grid = tuple((g // lay) * lay for g, lay in zip(grid, cfg.block_layout))
            h = h[:, : grid[0], : grid[1], : grid[2]]
        f, gh, gw = grid
        if f * gh * gw == 0:
            raise ValueError(f"latents {tuple(x.shape[1:4])} leave no token on a grid cropped "
                             f"to multiples of the block layout {tuple(cfg.block_layout)}")
        h = h.reshape(b, f * gh * gw, cfg.dim)

        # time embedding: a float32 island
        e = sinusoidal_embedding_1d(cfg.freq_dim, t)
        e = dense(F.silu(dense(e, self.time_fc1)), self.time_fc2)
        e0 = dense(F.silu(e), self.time_projection).reshape(b, 6, cfg.dim)

        ctx = dense(context.to(cfg.dtype), self.text_fc1)
        ctx = dense(F.gelu(ctx, approximate="tanh"), self.text_fc2)
        if cfg.model_type == "i2v":
            if clip_fea is None:
                raise ValueError("an i2v model needs clip_fea (models.clip.encode_i2v_features "
                                 "of the conditioning frame)")
            img = dense(self.img_norm_in(clip_fea).to(cfg.dtype), self.img_fc1)
            img = dense(F.gelu(img, approximate="tanh"), self.img_fc2)
            ctx = torch.cat([self.img_norm_out(img), ctx], dim=1)

        # the MHLA3D rope tables are the same in every layer
        rope_tables = None
        dh = cfg.dim // cfg.num_heads
        if cfg.linear_attn_idx and not cfg.without_rope and dh % 128 == 0:
            rope_tables = rope_tables_flat(grid, dh, device=h.device)

        # the sparse layers run dense attention while the denoising timestep
        # is still >= sparse_dense_from_t. The JAX model selects the branch on
        # the device (lax.cond); here the host selects it, which waits once
        # per forward for ``t`` where ``t`` lies on the device.
        use_dense = False
        if cfg.sparse_attn_idx and cfg.sparse_dense_from_t is not None:
            use_dense = bool(t.max() >= cfg.sparse_dense_from_t)

        # the model holds no dropout, so a recomputation needs no RNG state;
        # use_dense is a plain bool, so it takes the branch of the first pass
        remat = cfg.remat and torch.is_grad_enabled()
        caps = []
        for block in self.blocks:
            if remat:
                h = checkpoint(block, h, e0, ctx, grid, rope_tables, use_dense, capture,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = block(h, e0, ctx, grid, rope_tables, use_dense, capture)
            if capture:
                h, cap = h
                caps.append(cap)

        em = self.head_modulation.float() + e[:, None]
        out = dense(_modulate(self.head_norm(h), em[:, 1], em[:, 0]), self.head)

        # unpatchify back to [B, F*pf, H*ph, W*pw, out_dim]
        out = out.reshape(b, f, gh, gw, pf, ph, pw, cfg.out_dim)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7)
        out = out.reshape(b, f * pf, gh * ph, gw * pw, cfg.out_dim)
        if capture:
            return out, {"attn_out": [a for a, _ in caps], "block_out": [x_ for _, x_ in caps]}
        return out


@torch.no_grad()
def init_wan_params(model: WanModel, generator: torch.Generator) -> WanModel:
    """Draw the parameters in place as the flax initializers of the JAX model
    do: every projection and the patch convolution from a normal of std
    sqrt(1 / fan_in) truncated at two standard deviations (rescaled to unit
    variance), their biases zero, ``modulation`` and ``head_modulation``
    from normal(dim**-0.5); norm weights stay one. ``generator`` lives on
    the parameters' device."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv3d)):
            lecun_normal_(module.weight, generator)
            module.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("modulation"):
            p.normal_(0.0, model.cfg.dim**-0.5, generator=generator)
    return model
