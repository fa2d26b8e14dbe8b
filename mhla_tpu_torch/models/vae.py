"""Wan2.1 3-D causal video VAE, frozen encode and decode for the video
pipeline (counterpart of ``mhla_tpu/models/vae.py``).

Causal 3-D convolutions (time padded on the left by 2), channel-L2 RMS
norms, spatial down- and upsampling with temporal stride-2 convolutions at
the 3-D stages, per-frame single-head attention at the bottleneck, and the
published per-channel latent mean and std.

Temporal semantics are the JAX package's single-shot equivalent of the
reference's chunked streaming (1 + 4k frame chunks with a 2-frame cache):

- a causal conv is the full-sequence conv after a left pad of 2 frames;
- ``downsample3d``'s time path: frame 0 passes, then a VALID stride-2 conv
  over the whole sequence (windows at 0, 2, 4, ...): 1 + 4k -> 1 + 2k frames;
- ``upsample3d``'s time path: frame 0 passes, then a zero-left-padded causal
  conv over frames 1.. doubles the channels, interleaved into time:
  T -> 1 + 2 (T - 1).

The same equivalence lets this module bound its memory: a causal conv reads
only the two frames before each output frame, and the norms, the
attention and the spatial resamples act frame by frame, so each of them
runs over slices of at most ``slice_bytes`` of activations (a conv's slice
with its two-frame halo) and writes its output slice by slice. The result
equals the single-shot computation.

The public layout is [B, T, H, W, C] as in the JAX package; inside, the
activations are channels-first and contiguous ([B, C, T, H, W]), the layout
cuDNN's 3-D convolutions run fastest on. ``convert_vae_checkpoint`` loads
the reference's torch weights (``Wan2.1_VAE.pth``) into the JAX package's
param tree, which ``vae_params_from_jax`` turns into this module's state
dict.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

WAN_LATENT_MEAN = [
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
]
WAN_LATENT_STD = [
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
]

# activation bytes a slice of a frame-by-frame op may span
SLICE_BYTES = 1 << 30


def _frames_per_slice(x: torch.Tensor, slice_bytes: int, channels: int) -> int:
    """Frames of ``x`` [B, C, T, H, W] a slice takes so that ``channels``
    channels of its frames (its tensors' at x's resolution) span at most
    ``slice_bytes``."""
    b, _, _, h, w = x.shape
    return max(1, slice_bytes // max(b * h * w * channels * x.element_size(), 1))


def _by_slices(x: torch.Tensor, fn: Callable[[torch.Tensor, int, int], torch.Tensor],
               frames: int, t_out: int) -> torch.Tensor:
    """Stack ``fn(x, t0, t1)`` (output frames [t0, t1)) over slices of
    ``frames`` output frames into one [B, C', t_out, H', W'] tensor."""
    if frames >= t_out:
        return fn(x, 0, t_out)
    out = None
    for t0 in range(0, t_out, frames):
        t1 = min(t_out, t0 + frames)
        y = fn(x, t0, t1)
        if out is None:
            out = y.new_empty(y.shape[0], y.shape[1], t_out, *y.shape[3:])
        out[:, :, t0:t1] = y
        del y
    return out


class ChannelRMSNorm(nn.Module):
    """L2-normalize the channel vector, scale by sqrt(dim) * gamma (the
    reference's ``RMS_norm``); channels on axis 1."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dim = x.shape[1]
        xf = x.float()
        n = xf * torch.rsqrt(xf.square().sum(1, keepdim=True) + 1e-12)
        g = self.gamma.view(dim, *([1] * (x.ndim - 2)))
        return (n * dim**0.5 * g).to(x.dtype)


class CausalConv3d(nn.Module):
    """3-D conv with a causal (left) time pad and 'same' spatial padding."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int] = (3, 3, 3),
                 device=None):
        super().__init__()
        kt, kh, kw = kernel
        self.time_pad = 2 * (kt // 2)
        self.conv = nn.Conv3d(cin, cout, kernel, padding=(0, kh // 2, kw // 2), device=device)

    def forward(self, x: torch.Tensor, slice_bytes: int = SLICE_BYTES,
                pre: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``conv(pad(pre(x)))`` (+ ``residual``), slice by slice: each
        output slice reads its frames and the ``time_pad`` before them
        (zeros before frame 0), ``pre`` being a frame-by-frame op."""
        tp = self.time_pad

        def run(x, t0, t1):
            lo = t0 - tp
            s = x[:, :, max(lo, 0):t1]
            if pre is not None:
                s = pre(s)
            if lo < 0:
                s = F.pad(s, (0, 0, 0, 0, -lo, 0))
            y = self.conv(s)
            return y if residual is None else y.add_(residual[:, :, t0:t1])

        # pre's output and its padded copy, the conv's output
        channels = 2 * self.conv.in_channels + self.conv.out_channels
        return _by_slices(x, run, _frames_per_slice(x, slice_bytes, channels), x.shape[2])


def _norm_silu(norm: ChannelRMSNorm) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda s: F.silu(norm(s))


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.shortcut = CausalConv3d(cin, cout, (1, 1, 1), device) if cin != cout else None
        self.norm1 = ChannelRMSNorm(cin, device)
        self.conv1 = CausalConv3d(cin, cout, device=device)
        self.norm2 = ChannelRMSNorm(cout, device)
        self.conv2 = CausalConv3d(cout, cout, device=device)

    def forward(self, x: torch.Tensor, slice_bytes: int = SLICE_BYTES) -> torch.Tensor:
        h = x if self.shortcut is None else self.shortcut(x, slice_bytes)
        y = self.conv1(x, slice_bytes, pre=_norm_silu(self.norm1))
        return self.conv2(y, slice_bytes, pre=_norm_silu(self.norm2), residual=h)


class AttentionBlock(nn.Module):
    """Per-frame single-head spatial attention, float32 softmax."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = ChannelRMSNorm(dim, device)
        self.to_qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, slice_bytes: int = SLICE_BYTES) -> torch.Tensor:
        b, c, t, h, w = x.shape

        def run(x, t0, t1):
            s = x[:, :, t0:t1]
            y = self.norm(s).permute(0, 2, 3, 4, 1).reshape(b * (t1 - t0), h * w, c)
            q, k, v = F.linear(y, self.to_qkv.weight, self.to_qkv.bias).chunk(3, dim=-1)
            attn = torch.softmax(torch.einsum("bic,bjc->bij", q, k).float() * c**-0.5, -1)
            y = torch.einsum("bij,bjc->bic", attn.to(v.dtype), v)
            y = F.linear(y, self.proj.weight, self.proj.bias)
            return s + y.reshape(b, t1 - t0, h, w, c).permute(0, 4, 1, 2, 3)

        per_frame = b * (h * w) ** 2 * 4 + 5 * x[:, :, :1].numel() * x.element_size()
        return _by_slices(x, run, max(1, slice_bytes // per_frame), t)


class Resample(nn.Module):
    """``upsample2d`` / ``upsample3d`` (nearest 2x, then a 3 x 3 conv to
    ``dim // 2`` channels; the 3-D form doubles time first) and
    ``downsample2d`` / ``downsample3d`` (a stride-2 3 x 3 conv after a pad of
    one at the bottom and right; the 3-D form then halves time)."""

    def __init__(self, dim: int, mode: str, device=None):
        super().__init__()
        self.mode = mode
        if mode.startswith("upsample"):
            self.conv = nn.Conv2d(dim, dim // 2, 3, device=device)
            if mode == "upsample3d":
                self.time_conv = nn.Conv3d(dim, 2 * dim, (3, 1, 1), device=device)
        else:
            self.conv = nn.Conv2d(dim, dim, 3, stride=2, device=device)
            if mode == "downsample3d":
                self.time_conv = nn.Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), device=device)

    def _conv_frames(self, s: torch.Tensor, padding) -> torch.Tensor:
        """The 2-D conv on every frame of [B, C, T, H, W] (a 1 x 3 x 3 conv)."""
        return F.conv3d(s, self.conv.weight.unsqueeze(2), self.conv.bias,
                        stride=(1, *self.conv.stride), padding=padding)

    def forward(self, x: torch.Tensor, slice_bytes: int = SLICE_BYTES) -> torch.Tensor:
        if self.mode.startswith("upsample"):
            if self.mode == "upsample3d" and x.shape[2] > 1:
                # frame 0 passes; a causal conv doubles the channels of the
                # rest, [2, c] of them interleaved into time
                b, c, t, h, w = x.shape
                y = self.time_conv(F.pad(x[:, :, 1:], (0, 0, 0, 0, 2, 0)))
                y = y.view(b, 2, c, t - 1, h, w).permute(0, 2, 3, 1, 4, 5)
                x = torch.cat([x[:, :, :1], y.reshape(b, c, 2 * (t - 1), h, w)], dim=2)
                del y

            def up(x, t0, t1):
                s = F.interpolate(x[:, :, t0:t1], scale_factor=(1, 2, 2), mode="nearest")
                return self._conv_frames(s, (0, 1, 1))

            # the upsampled slice and the conv's output, at 4x the pixels
            channels = 4 * (self.conv.in_channels + self.conv.out_channels)
            return _by_slices(x, up, _frames_per_slice(x, slice_bytes, channels), x.shape[2])

        def down(x, t0, t1):
            return self._conv_frames(F.pad(x[:, :, t0:t1], (0, 1, 0, 1)), 0)

        channels = self.conv.in_channels + self.conv.out_channels  # the pad's copy, the output
        x = _by_slices(x, down, _frames_per_slice(x, slice_bytes, channels), x.shape[2])
        if self.mode == "downsample3d":
            x = torch.cat([x[:, :, :1], self.time_conv(x)], dim=2)
        return x


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    dim: int = 96  # the Wan2.1 VAE's base dim (z_dim 16)
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temporal_downsample: Tuple[bool, ...] = (False, True, True)


class Encoder3d(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv1 = CausalConv3d(3, dims[0], device=device)
        layers, scale = [], 1.0
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(cfg.num_res_blocks):
                layers.append(ResidualBlock(in_dim, out_dim, device))
                in_dim = out_dim
                if scale in cfg.attn_scales:
                    layers.append(AttentionBlock(out_dim, device))
            if i != len(cfg.dim_mult) - 1:
                mode = "downsample3d" if cfg.temporal_downsample[i] else "downsample2d"
                layers.append(Resample(out_dim, mode, device))
                scale /= 2.0
        self.downsamples = nn.ModuleList(layers)
        self.middle = nn.ModuleList([ResidualBlock(dims[-1], dims[-1], device),
                                     AttentionBlock(dims[-1], device),
                                     ResidualBlock(dims[-1], dims[-1], device)])
        self.head_norm = ChannelRMSNorm(dims[-1], device)
        self.head_conv = CausalConv3d(dims[-1], cfg.z_dim * 2, device=device)

    def forward(self, x: torch.Tensor, slice_bytes: int = SLICE_BYTES) -> torch.Tensor:
        x = self.conv1(x, slice_bytes)
        for layer in (*self.downsamples, *self.middle):
            x = layer(x, slice_bytes)
        return self.head_conv(x, slice_bytes, pre=_norm_silu(self.head_norm))


class Decoder3d(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        mult = tuple(cfg.dim_mult)
        dims = [cfg.dim * u for u in (mult[-1],) + mult[::-1]]
        temporal_up = tuple(cfg.temporal_downsample)[::-1]
        self.conv1 = CausalConv3d(cfg.z_dim, dims[0], device=device)
        self.middle = nn.ModuleList([ResidualBlock(dims[0], dims[0], device),
                                     AttentionBlock(dims[0], device),
                                     ResidualBlock(dims[0], dims[0], device)])
        layers, scale = [], 1.0 / 2 ** (len(mult) - 2)
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            if i > 0:  # the previous stage's upsample halved the channels
                in_dim //= 2
            for _ in range(cfg.num_res_blocks + 1):
                layers.append(ResidualBlock(in_dim, out_dim, device))
                in_dim = out_dim
                if scale in cfg.attn_scales:
                    layers.append(AttentionBlock(out_dim, device))
            if i != len(mult) - 1:
                mode = "upsample3d" if temporal_up[i] else "upsample2d"
                layers.append(Resample(out_dim, mode, device))
                scale *= 2.0
        self.upsamples = nn.ModuleList(layers)
        self.head_norm = ChannelRMSNorm(dims[-1], device)
        self.head_conv = CausalConv3d(dims[-1], 3, device=device)

    def forward(self, z: torch.Tensor, slice_bytes: int = SLICE_BYTES) -> torch.Tensor:
        x = self.conv1(z, slice_bytes)
        for layer in (*self.middle, *self.upsamples):
            x = layer(x, slice_bytes)
        return self.head_conv(x, slice_bytes, pre=_norm_silu(self.head_norm))


class WanVAE(nn.Module):
    """Encode and decode with the latent normalization (deterministic: the
    normalized mean, as the reference returns). Videos and latents are
    [B, T, H, W, C]; ``slice_bytes`` bounds the activations a slice of a
    frame-by-frame op spans (module docstring)."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), device=None,
                 slice_bytes: int = SLICE_BYTES):
        super().__init__()
        self.cfg, self.slice_bytes = cfg, slice_bytes
        self.encoder = Encoder3d(cfg, device)
        self.decoder = Decoder3d(cfg, device)
        self.conv1 = CausalConv3d(cfg.z_dim * 2, cfg.z_dim * 2, (1, 1, 1), device)
        self.conv2 = CausalConv3d(cfg.z_dim, cfg.z_dim, (1, 1, 1), device)

    def _stats(self, like: torch.Tensor):
        z = self.cfg.z_dim
        view = lambda v: torch.tensor(v[:z], device=like.device).view(z, 1, 1, 1)  # noqa: E731
        return view(WAN_LATENT_MEAN), view(WAN_LATENT_STD)

    @torch.no_grad()
    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """video [B, T, H, W, 3] in [-1, 1] -> normalized latents
        [B, 1 + (T - 1) / 4, H / 8, W / 8, z_dim], float32."""
        x = video.float().permute(0, 4, 1, 2, 3).contiguous()
        out = self.conv1(self.encoder(x, self.slice_bytes), self.slice_bytes)
        mean, std = self._stats(out)
        mu = out[:, : self.cfg.z_dim]
        return ((mu - mean) / std).permute(0, 2, 3, 4, 1).contiguous()

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents [B, T, H, W, z_dim] -> video [B, 1 + 4 (T - 1), 8 H, 8 W, 3]
        in [-1, 1], float32."""
        z = z.float().permute(0, 4, 1, 2, 3)
        mean, std = self._stats(z)
        x = self.conv2((z * std + mean).contiguous(), self.slice_bytes)
        x = self.decoder(x, self.slice_bytes).clamp_(-1.0, 1.0)
        return x.permute(0, 2, 3, 4, 1).contiguous()

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(video))


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch [out, in, kt, kh, kw] (or [out, in, kh, kw]) -> flax [k..., in, out]."""
    w = np.asarray(w)
    if w.ndim == 5:
        return w.transpose(2, 3, 4, 1, 0)
    if w.ndim == 4:
        return w.transpose(2, 3, 1, 0)
    return w.T


def convert_vae_checkpoint(state: Dict[str, np.ndarray], cfg: VAEConfig = VAEConfig()) -> Dict:
    """The reference's torch state dict -> the JAX package's param tree of
    ``WanVAE``. The reference names its Sequentials' entries: residual
    blocks ``<seq>.residual.{0 norm, 2 conv, 3 norm, 6 conv}`` and
    ``shortcut``; attention ``{norm, to_qkv, proj}`` (1 x 1 convs);
    resamples ``resample.1`` (the conv after the pad or upsample) and
    ``time_conv``; heads ``head.{0 norm, 2 conv}``."""

    def conv(prefix):
        out = {"kernel": _conv_kernel(state[prefix + ".weight"])}
        if prefix + ".bias" in state:
            out["bias"] = np.asarray(state[prefix + ".bias"])
        return out

    def norm(prefix):
        return {"gamma": np.asarray(state[prefix + ".gamma"]).reshape(-1)}

    def res_block(prefix, has_shortcut):
        blk = {
            "norm1": norm(prefix + ".residual.0"),
            "conv1": {"conv": conv(prefix + ".residual.2")},
            "norm2": norm(prefix + ".residual.3"),
            "conv2": {"conv": conv(prefix + ".residual.6")},
        }
        if has_shortcut:
            blk["shortcut"] = {"conv": conv(prefix + ".shortcut")}
        return blk

    def attn_block(prefix):
        dense = lambda name: {  # noqa: E731
            "kernel": np.asarray(state[f"{prefix}.{name}.weight"])[..., 0, 0].T,
            "bias": np.asarray(state[f"{prefix}.{name}.bias"]),
        }
        return {"norm": norm(prefix + ".norm"), "to_qkv": dense("to_qkv"), "proj": dense("proj")}

    def resample(prefix, mode):
        out = {"conv": conv(prefix + ".resample.1")}
        if mode.endswith("3d"):
            out["time_conv"] = conv(prefix + ".time_conv")
        return out

    def walk(side: str) -> Dict[str, Any]:
        mult = tuple(cfg.dim_mult)
        is_enc = side == "encoder"
        dims = ([cfg.dim * u for u in (1,) + mult] if is_enc
                else [cfg.dim * u for u in (mult[-1],) + mult[::-1]])
        temporal = (tuple(cfg.temporal_downsample) if is_enc
                    else tuple(cfg.temporal_downsample)[::-1])
        seq = "downsamples" if is_enc else "upsamples"
        n_res = cfg.num_res_blocks if is_enc else cfg.num_res_blocks + 1
        tree: Dict[str, Any] = {"conv1": {"conv": conv(f"{side}.conv1")}}
        idx, scale = 0, 1.0 if is_enc else 1.0 / 2 ** (len(mult) - 2)
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            cur_in = in_dim if is_enc or i == 0 else in_dim // 2
            for _ in range(n_res):
                tree[f"{seq}_{idx}"] = res_block(f"{side}.{seq}.{idx}", cur_in != out_dim)
                cur_in = out_dim
                idx += 1
                if scale in cfg.attn_scales:
                    tree[f"{seq}_{idx}"] = attn_block(f"{side}.{seq}.{idx}")
                    idx += 1
            if i != len(mult) - 1:
                kind = ("downsample" if is_enc else "upsample") + ("3d" if temporal[i] else "2d")
                scale = scale / 2.0 if is_enc else scale * 2.0
                tree[f"{seq}_{idx}"] = resample(f"{side}.{seq}.{idx}", kind)
                idx += 1
        tree["middle_0"] = res_block(f"{side}.middle.0", False)
        tree["middle_1"] = attn_block(f"{side}.middle.1")
        tree["middle_2"] = res_block(f"{side}.middle.2", False)
        tree["head_norm"] = norm(f"{side}.head.0")
        tree["head_conv"] = {"conv": conv(f"{side}.head.2")}
        return tree

    return {"params": {"encoder": walk("encoder"), "decoder": walk("decoder"),
                       "conv1": {"conv": conv("conv1")}, "conv2": {"conv": conv("conv2")}}}


# this module's parameter names -> the reference's, and the reference's shape
# of each ("c111": [C, 1, 1, 1]; "c11": [C, 1, 1]; "oi11": a 1 x 1 conv's
# [O, I, 1, 1]; None: this module's own); a name no rule matches is the same
# in both
_TO_REFERENCE = (
    (r"(.*)\.(norm1|norm2)\.gamma$",
     lambda m: f"{m[1]}.residual.{0 if m[2] == 'norm1' else 3}.gamma", "c111"),
    (r"(.*\.(?:downsamples|upsamples|middle)\.\d+)\.(conv1|conv2)\.conv\.(weight|bias)$",
     lambda m: f"{m[1]}.residual.{2 if m[2] == 'conv1' else 6}.{m[3]}", None),
    (r"(.*\.(?:downsamples|upsamples)\.\d+)\.conv\.(weight|bias)$",
     lambda m: f"{m[1]}.resample.1.{m[2]}", None),
    (r"(.*)\.(to_qkv|proj)\.weight$", lambda m: f"{m[1]}.{m[2]}.weight", "oi11"),
    (r"(.*)\.norm\.gamma$", lambda m: f"{m[1]}.norm.gamma", "c11"),
    (r"(.*)\.head_norm\.gamma$", lambda m: f"{m[1]}.head.0.gamma", "c111"),
    (r"(.*)\.head_conv\.conv\.(weight|bias)$", lambda m: f"{m[1]}.head.2.{m[2]}", None),
    (r"(.*)\.conv\.(weight|bias)$", lambda m: f"{m[1]}.{m[2]}", None),
)
_FORMS = {"c111": lambda s: (s[0], 1, 1, 1), "c11": lambda s: (s[0], 1, 1),
          "oi11": lambda s: (*s, 1, 1), None: lambda s: s}


def reference_state_shapes(model: WanVAE) -> Dict[str, Tuple[int, ...]]:
    """The names and shapes of the reference checkpoint that holds
    ``model``'s parameters (what :func:`convert_vae_checkpoint` reads)."""
    out: Dict[str, Tuple[int, ...]] = {}
    for name, p in model.state_dict().items():
        for pattern, rename, form in _TO_REFERENCE:
            m = re.match(pattern, name)
            if m:
                out[rename(m)] = _FORMS[form](tuple(p.shape))
                break
        else:
            out[name] = tuple(p.shape)
    return out
