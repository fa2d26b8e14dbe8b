"""Causal short (depthwise) convolution with a decode cache (counterpart of
``mhla_tpu/layers/short_conv.py``).

A ``kernel_size``-tap causal depthwise convolution over time with SiLU and,
with ``use_bias`` (Mamba's), a bias added before it, as
``fla.modules.ShortConvolution`` in every layer that builds one (the JAX
layer's activation switch is not ported). The weight keeps the JAX layout
[kernel_size, features]: the output at t is sum_i x_{t - K + 1 + i} w[i],
so x_t meets w[K - 1] (an unflipped cross-correlation, and the weight bridge
copies it as it is). The decode cache holds the last K - 1 *pre-activation*
inputs. With ``segment_ids`` (packed documents) taps that reach across a
document boundary are zeroed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class ShortConvolution(nn.Module):
    def __init__(self, features: int, kernel_size: int = 4, use_bias: bool = False,
                 device=None):
        super().__init__()
        self.features = features
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.randn(kernel_size, features, device=device) * kernel_size**-0.5
        )
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        cache: Optional[torch.Tensor] = None,  # [B, kernel_size - 1, D]
        output_final_state: bool = False,
        segment_ids: Optional[torch.Tensor] = None,  # [B, T]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        w = self.weight.to(x.dtype)
        pad = self.kernel_size - 1
        t = x.shape[1]
        if cache is not None:
            ctx = torch.cat([cache.to(x.dtype), x], dim=1)
        else:
            ctx = F.pad(x, (0, 0, pad, 0))
        seg_ctx = None
        if segment_ids is not None:
            seg_ctx = F.pad(segment_ids, (pad, 0), value=-1)
        y = torch.zeros_like(x)
        for i in range(self.kernel_size):
            tap = ctx[:, i:i + t]
            if seg_ctx is not None:
                same = seg_ctx[:, i:i + t] == segment_ids
                tap = tap * same[..., None].to(tap.dtype)
            y = y + tap * w[i]
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        y = F.silu(y)
        new_cache = None
        if output_final_state:
            new_cache = ctx[:, ctx.shape[1] - pad:] if pad > 0 else ctx[:, :0]
        return y, new_cache
