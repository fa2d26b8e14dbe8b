"""Rotary position embeddings, 1-D and 3-D (counterpart of
``mhla_tpu/ops/rotary.py`` and of ``rope_tables_flat`` in
``mhla_tpu/kernels/mhla_block_pallas.py``).

GPT-NeoX-style rotate-half rotary on the full head dim of q and k, with a
decode ``offset``. Tables are computed in float64 with numpy and stored as
float32, exactly as the JAX package builds them, so both packages rotate
with bit-identical tables.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

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
    counterpart for the formula and its reference). Cached as
    :func:`rotary_cos_sin`'s tables are, and as little to be written into."""
    return _xpos_cached(seq_len, dim, float(base), float(scale_base), str(torch.device(device)))


@functools.lru_cache(maxsize=16)
def _xpos_cached(seq_len: int, dim: int, base: float, scale_base: float, device: str):
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
    ``positions`` [B, T] selects explicit table rows per token (clamped to
    the tables, as the JAX gather clamps)."""
    b, t, f = x.shape
    dh = f // num_heads
    half = dh // 2
    if cos.shape[-1] != half:
        raise ValueError("flat rotary requires full-head-dim tables")
    if positions is not None:
        positions = positions.clamp(0, cos.shape[0] - 1)
        cos_t = cos[positions].float()[:, :, None, :]  # [B, T, 1, half]
        sin_t = sin[positions].float()[:, :, None, :]
    else:
        cos_t = cos[offset : offset + t].float()[None, :, None, :]
        sin_t = sin[offset : offset + t].float()[None, :, None, :]
    x4 = x.float().reshape(b, t, num_heads, dh)
    x1, x2 = x4[..., :half], x4[..., half:]
    rot = torch.cat([x1 * cos_t - x2 * sin_t, x2 * cos_t + x1 * sin_t], dim=-1)
    return rot.reshape(b, t, f).to(x.dtype)


# ---------------------------------------------------------------------------
# 3-D rotary (video)
# ---------------------------------------------------------------------------


def rope_params_3d(max_pos: int, dim: int, theta: float = 10000.0) -> np.ndarray:
    """Per-axis angle table [max_pos, dim/2], float64:
    outer(arange(max_pos), 1 / theta^(arange(0, dim, 2) / dim))."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(np.arange(max_pos, dtype=np.float64), inv)


def rope_angles_3d(
    grid: Sequence[int], head_dim: int, theta: float = 10000.0, max_pos: int = 1024
) -> np.ndarray:
    """Angle table of an (F, H, W) token grid -> [F*H*W, head_dim/2],
    float64, in flat token order. The half dim c = head_dim // 2 is split
    [c - 2*(c//3), c//3, c//3] over the frame, height and width axes."""
    f, h, w = grid
    c = head_dim // 2
    cf, ch, cw = c - 2 * (c // 3), c // 3, c // 3
    ang_f = rope_params_3d(max_pos, 2 * cf, theta)[:f]
    ang_h = rope_params_3d(max_pos, 2 * ch, theta)[:h]
    ang_w = rope_params_3d(max_pos, 2 * cw, theta)[:w]
    out = np.concatenate(
        [
            np.broadcast_to(ang_f[:, None, None, :], (f, h, w, cf)),
            np.broadcast_to(ang_h[None, :, None, :], (f, h, w, ch)),
            np.broadcast_to(ang_w[None, None, :, :], (f, h, w, cw)),
        ],
        axis=-1,
    )
    return out.reshape(f * h * w, c)


def apply_rotary_3d_halves(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary with the 3-D angle table: x [B, T, H, D], angles
    [T, D/2] float32. Computed in float32, returned in x's dtype. cos and
    sin are taken in float64 and rounded once: the float32 routines of the
    CPU's math library are not accurate to the last bits on every thread."""
    d2 = angles.shape[-1]
    xf = x.float()
    cos = torch.cos(angles.double()).float()[None, :, None, :]
    sin = torch.sin(angles.double()).float()[None, :, None, :]
    x1, x2 = xf[..., :d2], xf[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=4)
def _angles_cached(grid, head_dim: int, theta: float, max_pos: int, device: str):
    ang = rope_angles_3d(grid, head_dim, theta, max_pos).astype(np.float32)
    return torch.from_numpy(ang).to(device)


def rope_angles_3d_on(
    grid: Sequence[int],
    head_dim: int,
    theta: float = 10000.0,
    max_pos: int = 1024,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """:func:`rope_angles_3d` as a float32 tensor on ``device``, for
    :func:`apply_rotary_3d_halves`; cached like :func:`rope_tables_flat`,
    and as little to be written into."""
    return _angles_cached(tuple(grid), head_dim, float(theta), max_pos,
                          str(torch.device(device)))


@functools.lru_cache(maxsize=4)
def _tables_flat_cached(grid, head_dim: int, theta: float, max_pos: int, device: str):
    ang = rope_angles_3d(grid, head_dim, theta, max_pos).astype(np.float32).astype(np.float64)
    cos, sin = np.cos(ang), np.sin(ang)
    tables = np.concatenate([cos, cos], axis=-1), np.concatenate([-sin, sin], axis=-1)
    return tuple(torch.from_numpy(tb.astype(np.float32)).to(device) for tb in tables)


def rope_tables_flat(
    grid: Sequence[int],
    head_dim: int,
    theta: float = 10000.0,
    max_pos: int = 1024,
    device: torch.device | str = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin_signed) [T, Dh] float32 for the fused island prologue:
    rotate-half as ``y = x * cos + swap_halves(x) * sin_signed``, with cos
    repeated over both halves and sin carrying the [-, +] half signs. All
    heads share the table, in flat token order. The angles are rounded to
    float32 first, as the JAX package rounds them; cos and sin of those are
    taken in float64 on the host and rounded once.

    The tables are cached per (grid, head_dim, theta, max_pos, device):
    every layer and every denoising step share one pair, and callers must
    not write into them."""
    return _tables_flat_cached(
        tuple(grid), head_dim, float(theta), max_pos, str(torch.device(device))
    )
