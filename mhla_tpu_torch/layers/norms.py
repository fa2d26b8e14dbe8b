"""Normalization layers, float32 compute cast back to the input dtype
(counterpart of ``mhla_tpu/layers/norms.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dtype)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis; ``weight`` [dim]."""

    def __init__(self, dim: int, eps: float = 1e-6, elementwise_affine: bool = True,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = (
            nn.Parameter(torch.ones(dim, device=device)) if elementwise_affine else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def _head_inv_rms(x: torch.Tensor, num_heads: int, eps: float) -> torch.Tensor:
    """Per-head 1/rms of head-flat x [..., H*Dh] -> [..., H] float32 (the
    squares of bf16 values are exact in float32)."""
    xf = x.float().unflatten(-1, (num_heads, -1))
    return torch.rsqrt(torch.mean(xf * xf, dim=-1) + eps)


class GatedRMSNormHeadsFlat(nn.Module):
    """Per-head RMSNorm(x) * swish(g) on head-flat [B, T, H*Dh] tensors, with
    one ``weight`` [Dh] shared by the heads. Rounds where the JAX layer
    does: the per-head scale, the gate and each product in x's dtype."""

    def __init__(self, num_heads: int, head_dim: int, eps: float = 1e-5,
                 elementwise_affine: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.weight = (
            nn.Parameter(torch.ones(head_dim, device=device)) if elementwise_affine else None
        )

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        h = self.num_heads
        scale = _head_inv_rms(x, h, self.eps).to(x.dtype)
        gate = F.silu(g.float()).to(x.dtype)
        if self.weight is not None:
            gate = self.weight.repeat(h).to(x.dtype) * gate
        dh = x.shape[-1] // h
        return x * scale.repeat_interleave(dh, dim=-1) * gate


class RMSNormHeadsFlat(nn.Module):
    """Per-head RMSNorm on head-flat [B, T, H*Dh] (ungated counterpart of
    :class:`GatedRMSNormHeadsFlat`)."""

    def __init__(self, num_heads: int, head_dim: int, eps: float = 1e-5,
                 elementwise_affine: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.weight = (
            nn.Parameter(torch.ones(head_dim, device=device)) if elementwise_affine else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.num_heads
        dh = x.shape[-1] // h
        inv = _head_inv_rms(x, h, self.eps).to(x.dtype)
        y = x * inv.repeat_interleave(dh, dim=-1)
        if self.weight is not None:
            y = y * self.weight.repeat(h).to(x.dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with optional ``weight`` and ``bias``
    [dim], float32 compute cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, use_bias: bool = True,
                 use_scale: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)
