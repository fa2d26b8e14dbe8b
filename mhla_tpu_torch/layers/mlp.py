"""Gated MLP (SwiGLU), the LM block MLP, and the plain MLP of the ViT and
DiT blocks (counterpart of ``mhla_tpu/layers/mlp.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .fused_dense import dense, fused_projections


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def default_intermediate_size(hidden_size: int, hidden_ratio: int = 4) -> int:
    """The multiple of 256 at or above ``2/3 * hidden_size * hidden_ratio``."""
    inter = int(hidden_size * hidden_ratio * 2 / 3)
    return 256 * ((inter + 255) // 256)


class GatedMLP(nn.Module):
    def __init__(self, hidden_size: int, hidden_ratio: int = 4,
                 intermediate_size: Optional[int] = None, device=None):
        super().__init__()
        inter = intermediate_size or default_intermediate_size(hidden_size, hidden_ratio)
        self.gate_proj = nn.Linear(hidden_size, inter, bias=False, device=device)
        self.up_proj = nn.Linear(hidden_size, inter, bias=False, device=device)
        self.down_proj = nn.Linear(inter, hidden_size, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # gate and up as one concatenated matmul (layers/fused_dense.py)
        gate, up = fused_projections(x, self, ("gate_proj", "up_proj"))
        return dense(swiglu(gate, up), self.down_proj)


_ACTIVATIONS = {
    "gelu": lambda y: F.gelu(y, approximate="tanh"),
    "gelu_exact": F.gelu,
    "silu": F.silu,
    "relu": F.relu,
}


class MLP(nn.Module):
    """fc1, activation, fc2 (the ViT / DiT block MLP); ``gelu`` is the tanh
    approximation, as ``jax.nn.gelu`` computes by default."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, activation: str = "gelu",
                 use_bias: bool = True, device=None):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        self.fc1 = nn.Linear(in_features, hidden_features, bias=use_bias, device=device)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features, bias=use_bias,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.act(dense(x, self.fc1)), self.fc2)
