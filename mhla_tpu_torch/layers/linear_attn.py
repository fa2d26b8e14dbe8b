"""Global linear attention, the ViT baseline around MHLA (counterpart of
``linear_attention`` and ``LinearAttention2D`` in
``mhla_tpu/layers/linear_attn.py``), and the causal linear attention of the
LM's ``attn_extends='linear_attn'`` family (counterpart of
``_LinearAttnLayer`` in ``mhla_tpu/models/gla_lm.py``). The video baselines
of that module (``STConv3D``, ``WanLinearAttention``) are not ported yet."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


class LinearAttnState(NamedTuple):
    kv: torch.Tensor  # [B, H, Dk, Dv] float32, sum of k^T v so far
    z: torch.Tensor  # [B, H, Dk] float32, sum of k so far


def causal_linear_attention(
    q: torch.Tensor,  # [B, T, H, Dk] (after the feature map)
    k: torch.Tensor,
    v: torch.Tensor,  # [B, T, H, Dv]
    state: Optional[LinearAttnState] = None,
    chunk_size: int = 64,
) -> Tuple[torch.Tensor, LinearAttnState]:
    """o_t = (q_t sum_{j<=t} k_j^T v_j) / (q_t . sum_{j<=t} k_j + 1e-6), float32,
    sums continued from ``state``. Chunked: within a chunk the masked q k^T;
    across chunks the carried sums (an exclusive cumsum of the chunks'
    k^T v and sum k). JAX forms the same function from a [B, T, H, Dk, Dv]
    cumsum. Returns o in q's dtype and the sums after the last token."""
    in_dtype = q.dtype
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk_size, t)
    pad = (-t) % c
    q, k, v = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    n = q.shape[1] // c
    q, k, v = (x.reshape(b, n, c, h, x.shape[-1]).transpose(2, 3) for x in (q, k, v))  # [B,N,H,C,D]
    kv0 = state.kv if state is not None else q.new_zeros(b, h, dk, dv)
    z0 = state.z if state is not None else q.new_zeros(b, h, dk)
    kv_c = k.transpose(-1, -2) @ v  # [B, N, H, Dk, Dv]
    z_c = k.sum(-2)  # [B, N, H, Dk]
    kv_in = kv0[:, None] + torch.cumsum(kv_c, dim=1) - kv_c  # entering each chunk
    z_in = z0[:, None] + torch.cumsum(z_c, dim=1) - z_c
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    att = torch.where(causal, q @ k.transpose(-1, -2), 0.0)  # [B, N, H, C, C]
    num = att @ v + q @ kv_in
    den = att.sum(-1) + (q @ z_in[..., None])[..., 0] + 1e-6
    o = (num / den[..., None]).transpose(2, 3).reshape(b, n * c, h, dv)[:, :t]
    new = LinearAttnState(kv=kv_in[:, -1] + kv_c[:, -1], z=z_in[:, -1] + z_c[:, -1])
    return o.to(in_dtype), new


class CausalLinearAttention(nn.Module):
    """The LM's plain linear attention layer: relu q and k, v, the causal
    normalized linear attention of :func:`causal_linear_attention`, the
    output projection. Its cache is the running sums (``LinearAttnState``),
    so a decode step continues the full forward exactly. (JAX's layer
    returns no cache, so a cached decode there sees only the new tokens.)"""

    def __init__(self, hidden_size: int = 1024, expand_k: float = 0.5, expand_v: float = 1.0,
                 num_heads: int = 4, chunk_size: int = 64, device=None):
        super().__init__()
        self.num_heads, self.chunk_size = num_heads, chunk_size
        self.head_k_dim = int(hidden_size * expand_k) // num_heads
        self.head_v_dim = int(hidden_size * expand_v) // num_heads
        linear = lambda n_in, n_out: nn.Linear(n_in, n_out, bias=False, device=device)  # noqa: E731
        self.q_proj = linear(hidden_size, num_heads * self.head_k_dim)
        self.k_proj = linear(hidden_size, num_heads * self.head_k_dim)
        self.v_proj = linear(hidden_size, num_heads * self.head_v_dim)
        self.o_proj = linear(num_heads * self.head_v_dim, hidden_size)

    def forward(self, x: torch.Tensor, state: Optional[LinearAttnState] = None,
                use_cache: bool = False):
        h = self.num_heads
        q = torch.relu(dense(x, self.q_proj).unflatten(-1, (h, -1)))
        k = torch.relu(dense(x, self.k_proj).unflatten(-1, (h, -1)))
        v = dense(x, self.v_proj).unflatten(-1, (h, -1))
        o, new = causal_linear_attention(q, k, v, state, self.chunk_size)
        return dense(o.flatten(-2), self.o_proj), (new if use_cache else None)
