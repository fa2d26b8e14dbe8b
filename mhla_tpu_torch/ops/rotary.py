"""Rotary position embeddings, 1-D (counterpart of the 1-D part of
``mhla_tpu/ops/rotary.py``).

GPT-NeoX-style rotate-half rotary on the full head dim of q and k, with a
decode ``offset``. Tables are computed in float64 with numpy and stored as
float32, exactly as the JAX package builds them, so both packages rotate
with bit-identical tables.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


def rotary_freqs(dim: int, base: float = 10000.0) -> np.ndarray:
    """Inverse frequencies [dim/2]."""
    return 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


@functools.lru_cache(maxsize=16)
def _cos_sin_cached(seq_len: int, dim: int, base: float, device: str):
    inv = rotary_freqs(dim, base)
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv)
    cos = torch.from_numpy(np.cos(freqs).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(freqs).astype(np.float32)).to(device)
    return cos, sin


def rotary_cos_sin(
    seq_len: int,
    dim: int,
    base: float = 10000.0,
    device: torch.device | str = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [seq_len, dim/2] float32 on ``device``.

    The tables are cached per (seq_len, dim, base, device): every layer of
    a model shares one pair, and callers must not write into them."""
    return _cos_sin_cached(seq_len, dim, float(base), str(torch.device(device)))


def rotary_xpos_tables(
    seq_len: int,
    dim: int,
    base: float = 10000.0,
    scale_base: float = 512.0,
    device: torch.device | str = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """XPos tables (cos_q, sin_q, cos_k, sin_k), each [seq_len, dim/2]:
    q tables carry ``scale``, k tables ``1/scale`` (see the JAX
    counterpart for the formula and its reference)."""
    inv = rotary_freqs(dim, base)
    t = np.arange(seq_len, dtype=np.float64)
    freqs = np.outer(t, inv)
    scale_vec = (np.arange(0, dim, 2, dtype=np.float64) + 0.4 * dim) / (1.4 * dim)
    power = (t - seq_len // 2) / scale_base
    scale = scale_vec[None, :] ** power[:, None]
    cos, sin = np.cos(freqs), np.sin(freqs)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return as_t(cos * scale), as_t(sin * scale), as_t(cos / scale), as_t(sin / scale)


def apply_rotary(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, offset: int = 0
) -> torch.Tensor:
    """Rotate-half rotary on x [B, T, H, D] with tables [>=T+offset, D/2]."""
    t = x.shape[1]
    d2 = cos.shape[-1]
    cos_t = cos[offset : offset + t][None, :, None, :]
    sin_t = sin[offset : offset + t][None, :, None, :]
    x1, x2 = x[..., :d2], x[..., d2 : 2 * d2]
    rot = torch.cat([x1 * cos_t - x2 * sin_t, x2 * cos_t + x1 * sin_t], dim=-1)
    if x.shape[-1] > 2 * d2:  # partial-dim rotary: pass the tail through
        rot = torch.cat([rot, x[..., 2 * d2 :]], dim=-1)
    return rot.to(x.dtype)


def apply_rotary_flat(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    offset: int = 0,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rotate-half rotary on head-flat x [B, T, H*D] with the same
    [>=T+offset, D/2] tables as :func:`apply_rotary`, computed in float32.
    ``positions`` [B, T] selects explicit table rows per token."""
    b, t, f = x.shape
    dh = f // num_heads
    half = dh // 2
    if cos.shape[-1] != half:
        raise ValueError("flat rotary requires full-head-dim tables")
    if positions is not None:
        cos_t = cos[positions].float()[:, :, None, :]  # [B, T, 1, half]
        sin_t = sin[positions].float()[:, :, None, :]
    else:
        cos_t = cos[offset : offset + t].float()[None, :, None, :]
        sin_t = sin[offset : offset + t].float()[None, :, None, :]
    x4 = x.float().reshape(b, t, num_heads, dh)
    x1, x2 = x4[..., :half], x4[..., half:]
    rot = torch.cat([x1 * cos_t - x2 * sin_t, x2 * cos_t + x1 * sin_t], dim=-1)
    return rot.reshape(b, t, f).to(x.dtype)
