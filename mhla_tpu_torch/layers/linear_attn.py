"""Global linear attention, the ViT baseline around MHLA (counterpart of
``linear_attention`` and ``LinearAttention2D`` in
``mhla_tpu/layers/linear_attn.py``). The video baselines of that module
(``STConv3D``, ``WanLinearAttention``) are not ported yet."""

from __future__ import annotations

import torch
import torch.nn as nn

from .fused_dense import dense
from .norms import RMSNorm


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Normalized global linear attention over [B, T, H, D], float32:
    (q (k^T v)) / (q . sum_t k + eps)."""
    q, k, v = q.float(), k.float(), v.float()
    kv = torch.einsum("bthk,bthv->bhkv", k, v)
    out = torch.einsum("bthk,bhkv->bthv", q, kv)
    z = torch.einsum("bthk,bhk->bth", q, k.sum(dim=1)) + eps
    return out / z[..., None]


class LinearAttention2D(nn.Module):
    """Full-dim RMSNorm on q and k, relu feature map, one global state per
    head, a per-token normalizer; flat tokens [B, T, dim]."""

    def __init__(self, dim: int, num_heads: int = 8, eps: float = 1e-6, device=None):
        super().__init__()
        self.dim, self.num_heads, self.eps = dim, num_heads, eps
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False, device=device)
        self.q_norm = RMSNorm(dim, eps=eps, device=device)
        self.k_norm = RMSNorm(dim, eps=eps, device=device)
        self.to_out = nn.Linear(dim, dim, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = dense(x, self.to_qkv).chunk(3, dim=-1)
        q, k = torch.relu(self.q_norm(q)), torch.relu(self.k_norm(k))
        q, k, v = (y.reshape(b, t, self.num_heads, -1) for y in (q, k, v))
        out = linear_attention(q, k, v, self.eps).to(x.dtype).reshape(b, t, self.dim)
        return dense(out, self.to_out)
