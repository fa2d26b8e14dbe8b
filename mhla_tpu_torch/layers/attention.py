"""Softmax attention (counterpart of ``mhla_tpu/layers/attention.py``):
``sdpa`` in every form (causal, sliding window, boolean mask, packed
segments) and ``SelfAttention``, the softmax layer of the hybrid LM (GQA by
repeat, qk-norm, qkv bias, RoPE with a decode offset or restarting at every
packed document, and a KV cache)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..kernels.flash_attention import flash_attention
from ..ops.mhla_chunk import segment_positions
from ..ops.rotary import apply_rotary, apply_rotary_flat, rotary_cos_sin
from .fused_dense import dense
from .norms import RMSNorm

_FLASH_MIN_QUERY = 2048
_FLASH_MIN_KEYS = 128
# what jax.nn.dot_product_attention writes into a masked float32 logit
_MASKED_LOGIT = -0.7 * torch.finfo(torch.float32).max

# (k [B, L, H, D], v [B, L, H, D], tokens written): one softmax layer's cache
KVCache = Tuple[torch.Tensor, torch.Tensor, int]


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     keep: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v as ``jax.nn.dot_product_attention`` computes
    it: float32 logits of the inputs' values, a dropped pair's logit set to a
    large negative number (a row that keeps nothing averages all keys),
    float32 softmax, probabilities rounded to v's dtype, float32 sums, the
    result in q's dtype. ``keep``: bool broadcastable to [B, H, Tq, Tk]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if keep is not None:
        s = torch.where(keep, s, _MASKED_LOGIT)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over [B, T, H, D] tensors.

    The JAX package's dispatch rule: with no window and no mask, a long
    query (>= 2048 tokens) against at least 128 keys with a head dim that
    is a multiple of 128 goes to the flash kernel (K9, in its causal and
    segment-id forms where asked; those need Tq == Tk), which never writes
    the [Tq, Tk] scores to device memory. Every other case takes the plain
    product with its masks: causal (key j <= query i), ``window`` w (i - j
    < w as well), ``mask`` (a boolean keep-mask broadcastable to [B, H, Tq,
    Tk]) and ``segment_ids`` [B, T] (tokens attend within their document)."""
    tq, tk = q.shape[1], k.shape[1]
    if (
        window is None
        and mask is None
        and tq >= _FLASH_MIN_QUERY
        and (tq == tk or (not causal and segment_ids is None))
        and tk >= _FLASH_MIN_KEYS
        and q.shape[-1] % 128 == 0
    ):
        return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    keep = mask
    if segment_ids is not None:
        same = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        keep = same if keep is None else keep & same
    if causal or window:
        i = torch.arange(tq, device=q.device)[:, None]
        j = torch.arange(tk, device=q.device)[None, :]
        band = j <= i
        if window:  # jax local_window_size=(window - 1, 0)
            band = band & (i <= j + window - 1)
        keep = band if keep is None else keep & band
    return _plain_attention(q, k, v, keep)


class SelfAttention(nn.Module):
    """Multi-head softmax self-attention with optional causality, RoPE, GQA,
    qk-norm and qkv bias; parameters named as the JAX module names them
    (``q_proj``, ``k_proj``, ``v_proj``, ``o_proj``, ``q_norm``, ``k_norm``).

    ``forward(x, kv_cache, use_cache, segment_ids)`` returns (out, cache):
    without ``kv_cache``, attention over x itself (``sdpa``; with
    ``use_cache`` the cache is (k, v, T), k and v repeated to every head);
    with ``kv_cache`` = (k_buf, v_buf, offset), x's tokens are written into
    the buffers in place at ``offset`` and attend to every cached key up to
    ``offset + t - 1``, as the JAX module's decode mask does."""

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        num_kv_heads: Optional[int] = None,
        causal: bool = True,
        qkv_bias: bool = False,
        qk_norm: bool = False,
        window_size: Optional[int] = None,
        rope: bool = True,
        rope_theta: float = 10000.0,
        max_position_embeddings: int = 4096,
        norm_eps: float = 1e-6,
        device=None,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.window_size = window_size
        self.rope = rope
        self.rope_theta = rope_theta
        self.max_position_embeddings = max_position_embeddings
        d, kv = self.head_dim, self.num_kv_heads * self.head_dim
        self.q_proj = nn.Linear(hidden_size, num_heads * d, bias=qkv_bias, device=device)
        self.k_proj = nn.Linear(hidden_size, kv, bias=qkv_bias, device=device)
        self.v_proj = nn.Linear(hidden_size, kv, bias=qkv_bias, device=device)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = RMSNorm(d, eps=norm_eps, device=device)
            self.k_norm = RMSNorm(d, eps=norm_eps, device=device)
        self.o_proj = nn.Linear(num_heads * d, hidden_size, bias=False, device=device)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, hidden]
        kv_cache: Optional[KVCache] = None,
        use_cache: bool = False,
        segment_ids: Optional[torch.Tensor] = None,  # [B, T] packed documents
    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        b, t, _ = x.shape
        h, kv_h, d = self.num_heads, self.num_kv_heads, self.head_dim
        q = dense(x, self.q_proj).unflatten(-1, (h, d))
        k = dense(x, self.k_proj).unflatten(-1, (kv_h, d))
        v = dense(x, self.v_proj).unflatten(-1, (kv_h, d))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)

        offset = kv_cache[2] if kv_cache is not None else 0
        if self.rope:
            cos, sin = rotary_cos_sin(self.max_position_embeddings, d, self.rope_theta, x.device)
            if segment_ids is not None:
                # packed varlen: positions restart at each document
                pos = segment_positions(segment_ids)
                q, k = (apply_rotary_flat(y.flatten(-2), cos, sin, y.shape[2], positions=pos)
                        .unflatten(-1, y.shape[2:]) for y in (q, k))
            else:
                q = apply_rotary(q, cos, sin, offset)
                k = apply_rotary(k, cos, sin, offset)
        if kv_h != h:
            k = torch.repeat_interleave(k, h // kv_h, dim=2)
            v = torch.repeat_interleave(v, h // kv_h, dim=2)

        new_cache = None
        if kv_cache is not None:
            k_buf, v_buf, _ = kv_cache
            k_buf[:, offset:offset + t] = k
            v_buf[:, offset:offset + t] = v
            keep = torch.arange(k_buf.shape[1], device=x.device) <= offset + t - 1
            o = _plain_attention(q, k_buf, v_buf, keep)
            new_cache = (k_buf, v_buf, offset + t)
        else:
            o = sdpa(q, k, v, causal=self.causal, window=self.window_size,
                     segment_ids=segment_ids)
            if use_cache:
                new_cache = (k, v, t)
        return dense(o.reshape(b, t, h * d), self.o_proj), new_cache
