"""Gated linear attention (GLA) op, chunked and recurrent (counterpart of
``mhla_tpu/ops/gla_chunk.py``).

Per token, with a per-key-channel log decay gk <= 0 and state S [Dk, Dv]:

    S_t = diag(exp(gk_t)) S_{t-1} + k_t^T v_t ;   o_t = (q_t * Dk**-0.5) S_t

Per chunk, with G the inclusive within-chunk cumsum of gk:

    o_i = (q_i e^{G_i}) S + sum_{j<=i} [q_i e^{G_i - G_j} . k_j] v_j   (times scale)
    S'  = e^{G_last} S + (k e^{G_last - G})^T v

For a per-key-channel ``gk`` [B, T, H, Dk] (GLA) the intra-chunk term is
factored as (q e^{G}) . (k e^{-G}), as in JAX: e^{-G} stays finite while a
chunk's summed log-decay stays above about -88. A per-head ``gk`` [B, T, H]
(simple GLA, Mamba2) takes the difference form, (q_i . k_j) e^{G_i - G_j}
masked to j <= i before the exponential, with the state update's factors
e^{G_last - G_j}: every exponent is <= 0, so it stays finite at any decay
(JAX's op broadcasts such a gk over Dk and overflows there; the port does
not copy that fault). Both forms compute in float32 whatever the inputs'
dtype and return o in q's dtype and the state float32. These are the
semantic anchor; the fused path with the hand-written kernels is
``kernels.gla_chunk.gla_chunk_fused``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .mhla_chunk import _pad_to_chunks


def _expand_gk(gk: torch.Tensor, dk: int) -> torch.Tensor:
    """A per-head decay [B, T, H] broadcast over the key channels."""
    if gk.ndim == 3:
        return gk[..., None].expand(*gk.shape, dk)
    return gk


def _initial_state(initial_state, b, h, dk, dv, device) -> torch.Tensor:
    if initial_state is not None:
        return initial_state.float()
    return torch.zeros(b, h, dk, dv, dtype=torch.float32, device=device)


def gla_recurrent(
    q: torch.Tensor,  # [B, T, H, Dk]
    k: torch.Tensor,  # [B, T, H, Dk]
    v: torch.Tensor,  # [B, T, H, Dv]
    gk: torch.Tensor,  # [B, T, H, Dk] or [B, T, H] log decay (<= 0)
    initial_state: Optional[torch.Tensor] = None,  # [B, H, Dk, Dv]
    output_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The token recurrence (the oracle and the decode path)."""
    in_dtype = q.dtype
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk**-0.5
    q, k, v, gk = (x.float() for x in (q, k, v, _expand_gk(gk, dk)))
    s = _initial_state(initial_state, b, h, dk, dv, q.device)
    outs = []
    for i in range(t):
        s = s * torch.exp(gk[:, i])[..., None] + k[:, i, :, :, None] * v[:, i, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", q[:, i] * scale, s))
    o = torch.stack(outs, dim=1).to(in_dtype)
    return o, (s if output_final_state else None)


def gla_chunk(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    gk: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
    chunk_size: int = 64,
    output_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chunked form (training path); equals :func:`gla_recurrent` up to
    float32 rounding."""
    if gk.ndim == 3:
        return _gla_chunk_per_head(q, k, v, gk, initial_state, chunk_size, output_final_state)
    in_dtype = q.dtype
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = chunk_size
    scale = dk**-0.5
    q, k, v, gk = (_pad_to_chunks(x.float(), c) for x in (q, k, v, gk))
    n = q.shape[1] // c
    # [B, N, C, H, D]
    q, k, v, gk = (x.reshape(b, n, c, h, x.shape[-1]) for x in (q, k, v, gk))
    g_cum = torch.cumsum(gk, dim=2)
    g_last = g_cum[:, :, -1]  # [B, N, H, Dk]
    tril = torch.tril(torch.ones(c, c, device=q.device))
    s = _initial_state(initial_state, b, h, dk, dv, q.device)
    outs = []
    for i in range(n):
        q_i, k_i, v_i, g_i = q[:, i], k[:, i], v[:, i], g_cum[:, i]
        q_dec = q_i * torch.exp(g_i) * scale
        o_inter = torch.einsum("bchk,bhkv->bchv", q_dec, s)
        k_dec = k_i * torch.exp(-g_i)
        attn = torch.einsum("bchk,bmhk->bhcm", q_dec / scale, k_dec) * tril * scale
        o_intra = torch.einsum("bhcm,bmhv->bchv", attn, v_i)
        k_carry = k_i * torch.exp(g_last[:, i, None] - g_i)
        s = s * torch.exp(g_last[:, i])[..., None] + torch.einsum("bchk,bchv->bhkv", k_carry, v_i)
        outs.append(o_inter + o_intra)
    o = torch.stack(outs, dim=1).reshape(b, n * c, h, dv)[:, :t]
    return o.to(in_dtype), (s if output_final_state else None)


def _gla_chunk_per_head(q, k, v, gk, initial_state, chunk_size, output_final_state):
    """:func:`gla_chunk` for a per-head gk [B, T, H], in difference form."""
    in_dtype = q.dtype
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = chunk_size
    scale = dk**-0.5
    q, k, v, gk = (_pad_to_chunks(x.float(), c) for x in (q, k, v, gk))
    n = q.shape[1] // c
    q, k, v = (x.reshape(b, n, c, h, x.shape[-1]) for x in (q, k, v))
    g_cum = torch.cumsum(gk.reshape(b, n, c, h), dim=2)  # [B, N, C, H]
    causal = torch.tril(torch.ones(c, c, dtype=torch.bool, device=q.device))
    s = _initial_state(initial_state, b, h, dk, dv, q.device)
    outs = []
    for i in range(n):
        q_i, k_i, v_i, g_i = q[:, i], k[:, i], v[:, i], g_cum[:, i]
        g_last = g_i[:, -1]  # [B, H]
        o_inter = torch.einsum("bchk,bhkv->bchv", q_i * (torch.exp(g_i) * scale)[..., None], s)
        diff = (g_i[:, :, None] - g_i[:, None, :]).permute(0, 3, 1, 2)  # [B, H, C_i, C_j]
        decay = torch.exp(torch.where(causal, diff, float("-inf")))
        attn = torch.einsum("bchk,bmhk->bhcm", q_i, k_i) * decay * scale
        o_intra = torch.einsum("bhcm,bmhv->bchv", attn, v_i)
        k_carry = k_i * torch.exp(g_last[:, None] - g_i)[..., None]
        s = s * torch.exp(g_last)[..., None, None] + torch.einsum("bchk,bchv->bhkv", k_carry, v_i)
        outs.append(o_inter + o_intra)
    o = torch.stack(outs, dim=1).reshape(b, n * c, h, dv)[:, :t]
    return o.to(in_dtype), (s if output_final_state else None)
