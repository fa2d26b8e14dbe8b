"""Radial (n log n) sparse video attention on [B, T, H, D] tensors
(counterpart of ``mhla_tpu/kernels/sparse_attention.py``), forward only.

Tokens are frame-major: token i sits in frame ``i // hw`` at spatial index
``i % hw`` (``hw = T // num_frames``). A query in frame f attends to all of
frame g when ``|f - g| <= 1`` and to a spatial band that halves per octave
of temporal distance beyond that:

    allowed(i, j) = |s_i - s_j| < hw >> floor(log2(max(|f_i - f_j|, 1)))

K10 ``radial_flash_attention`` replaces the Pallas kernel
``_radial_fwd_kernel`` (``mhla_tpu/kernels/sparse_attention.py:312``): a
flash forward that walks, per tile of 64 query rows, only the 64-key tiles
that hold an allowed pair, and recomputes the mask inside the tile from
index arithmetic (``csrc/radial_fwd.cu``, where its bound and design are
written). The tile lists come from :func:`radial_schedule`, computed once
per geometry on frame pieces without any [T, T] array, and sit on the
device in CSR form.

A CPU tensor takes :func:`radial_flash_attention_plain`; a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches. The
differentiable splash route of the JAX package (``impl="splash"``) is not
ported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import flash_attention_plain
from .mhla_chunk import _check, _on_cpu, _raise_on_error, _stream

launches = {"radial_flash_attention": 0}

_HEAD_DIM = 128  # csrc: kD
_TILE = 64  # csrc: kBlockM = kBlockN
_lib_cache: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mhla_radial_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        lib.mhla_radial_fwd.restype = ctypes.c_int
        _lib_cache = lib
    return _lib_cache


# ---------------------------------------------------------------------------
# The mask, on the host
# ---------------------------------------------------------------------------


def radial_window(dist: np.ndarray, hw: int) -> np.ndarray:
    """Spatial bandwidth for temporal distance ``dist`` (vectorized): the
    full frame at dist <= 1, then halved per octave of distance."""
    d = np.maximum(dist, 1)
    octave = np.floor(np.log2(d)).astype(np.int64)
    return np.maximum(hw >> octave, 0)


def _radial_block(qi: np.ndarray, ki: np.ndarray, seq_len: int, num_frames: int) -> np.ndarray:
    """Mask values for the (query rows qi) x (key cols ki) tile. Padding
    tokens (index >= seq_len) attend only to themselves."""
    hw = seq_len // num_frames
    qc = np.minimum(qi, seq_len - 1)
    kc = np.minimum(ki, seq_len - 1)
    fq, sq = qc // hw, qc % hw
    fk, sk = kc // hw, kc % hw
    dist = np.abs(fq[:, None] - fk[None, :])
    mask = np.abs(sq[:, None] - sk[None, :]) < radial_window(dist, hw)
    mask |= dist <= 1
    real_q = qi < seq_len
    real_k = ki < seq_len
    mask &= real_q[:, None] & real_k[None, :]
    mask |= (~real_q[:, None]) & (qi[:, None] == ki[None, :])
    return mask


def radial_mask_dense(seq_len: int, num_frames: int, pad_to: Optional[int] = None) -> np.ndarray:
    """Dense boolean [T, T] radial mask, or [pad_to, pad_to] with padding
    rows that attend to themselves. For tests and small sizes: at 31,500
    tokens it holds 1 GB."""
    n = pad_to if pad_to is not None and pad_to > seq_len else seq_len
    idx = np.arange(n)
    return _radial_block(idx, idx, seq_len, num_frames)


def radial_allowed_pairs(seq_len: int, num_frames: int) -> int:
    """Number of allowed (query, key) pairs, counted from the mask's
    formula: a frame pair at distance d keeps the pairs with
    ``|s_q - s_k| < w`` for its window w, ``hw + (w - 1) * (2 * hw - w)``
    of its ``hw * hw``."""
    hw = seq_len // num_frames
    total = 0
    for d in range(num_frames):
        w = int(radial_window(np.array(d), hw))
        pairs = hw + (w - 1) * (2 * hw - w) if w > 0 else 0
        total += pairs * (num_frames if d == 0 else 2 * (num_frames - d))
    return total


def _tile_pieces(t: int, hw: int, tile: int, n_pieces: int):
    """Frame pieces of every tile of ``tile`` tokens: arrays [tiles,
    n_pieces] of the frame, the first and the last spatial index (inclusive)
    and validity. Tokens past ``t`` are clipped away."""
    n = -(-t // tile)
    lo = np.minimum(np.arange(n) * tile, t - 1)[:, None]
    hi = np.minimum(np.arange(n) * tile + tile - 1, t - 1)[:, None]
    f = lo // hw + np.arange(n_pieces)[None, :]
    valid = f * hw <= hi
    s0 = np.maximum(lo, f * hw) - f * hw
    s1 = np.minimum(hi, f * hw + hw - 1) - f * hw
    return f, s0, s1, valid


@functools.lru_cache(maxsize=8)
def radial_schedule(
    t: int, num_frames: int, bq: int = _TILE, bk: int = _TILE
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The key tiles each query tile must visit, in CSR form:
    ``(offsets [NQ + 1], tiles [offsets[-1]], full [offsets[-1]])``, int32;
    query tile i visits ``tiles[offsets[i]:offsets[i + 1]]`` in rising
    order. A tile is listed iff some (row, column) pair in it is allowed,
    decided exactly on frame pieces (a tile of consecutive tokens is a few
    runs of spatial indices, one per frame it touches; two runs hold an
    allowed pair iff their gap is below the window of their frame
    distance). ``full`` marks tiles in which every pair of real rows is
    allowed and no column lies past ``t``: the kernel skips the mask there.
    The same lists as the JAX package's ``_radial_schedule`` at equal tile
    sizes; callers must not write into the cached arrays."""
    hw = t // num_frames
    if hw * num_frames != t or t < 1:
        raise ValueError(f"{t} tokens do not split into {num_frames} frames")
    pq, pk = (bq - 1) // hw + 2, (bk - 1) // hw + 2
    fq, sq0, sq1, vq = _tile_pieces(t, hw, bq, pq)
    fk, sk0, sk1, vk = _tile_pieces(t, hw, bk, pk)
    nq, nk = fq.shape[0], fk.shape[0]
    hit = np.zeros((nq, nk), bool)
    full = np.ones((nq, nk), bool)
    for a in range(pq):
        for b in range(pk):
            win = radial_window(np.abs(fq[:, a, None] - fk[None, :, b]), hw)
            gap = np.maximum(0, np.maximum(sk0[None, :, b] - sq1[:, a, None],
                                           sq0[:, a, None] - sk1[None, :, b]))
            span = np.maximum(sq1[:, a, None] - sk0[None, :, b],
                              sk1[None, :, b] - sq0[:, a, None])  # max |s_q - s_k|
            both = vq[:, a, None] & vk[None, :, b]
            hit |= both & (gap < win)
            full &= ~both | (span < win)
    full &= (np.arange(nk) * bk + bk <= t)[None, :]
    rows, cols = np.nonzero(hit)  # row-major: rising tiles within each query tile
    offsets = np.zeros(nq + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=nq), out=offsets[1:])
    return offsets, cols.astype(np.int32), full[rows, cols].astype(np.int32)


@functools.lru_cache(maxsize=8)
def _schedule_on_device(t: int, num_frames: int, device: str):
    """(offsets, entries) int32 on ``device``; an entry is ``2 * tile +
    full``. Built once per geometry and device (0.03 s on the host at
    31,500 tokens), so no forward after the first waits for it."""
    offsets, tiles, full = radial_schedule(t, num_frames)
    return tuple(torch.from_numpy(a).to(device) for a in (offsets, tiles * 2 + full))


# ---------------------------------------------------------------------------
# The attention
# ---------------------------------------------------------------------------


def radial_block_mask(r0: int, r1: int, seq_len: int, num_frames: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Rows ``r0:r1`` of the [T, T] radial mask as a bool tensor on
    ``device``, from index arithmetic there (the windows per frame distance
    come from :func:`radial_window`)."""
    hw = seq_len // num_frames
    win = torch.from_numpy(radial_window(np.arange(num_frames), hw)).to(device)
    rows = torch.arange(r0, r1, device=device)
    cols = torch.arange(seq_len, device=device)
    fq, sq = rows // hw, rows % hw
    fk, sk = cols // hw, cols % hw
    dist = (fq[:, None] - fk[None, :]).abs()
    return (sq[:, None] - sk[None, :]).abs() < win[dist]


def radial_flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_frames: int,
    scale: Optional[float] = None,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """Softmax attention under the radial mask: q, k, v [B, T, H, D] ->
    [B, T, H, D] in q's dtype. Query rows are walked in blocks, each with a
    full softmax over all keys under its rows of the mask, so no [T, T]
    array exists; arithmetic and rounding as in
    :func:`flash_attention_plain`."""
    t = q.shape[1]
    if t % num_frames:
        raise ValueError(f"{t} tokens do not split into {num_frames} frames")
    return flash_attention_plain(
        q, k, v, scale, block_rows,
        row_mask=lambda r0, r1: radial_block_mask(r0, r1, t, num_frames, q.device),
    )


def radial_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_frames: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K10 (see :func:`radial_flash_attention_plain`): bf16, head dim 128,
    any T that splits into ``num_frames`` frames."""
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if t < 1 or t % num_frames:
        raise ValueError(f"{t} tokens do not split into {num_frames} frames")
    if _on_cpu(q, k, v):
        return radial_flash_attention_plain(q, k, v, num_frames, scale)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, torch.bfloat16, 4)
    if d != _HEAD_DIM:
        raise ValueError(f"kernel takes head dim {_HEAD_DIM}, got {d}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("kernel copies 16 bytes at a time: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if b * h:
        offsets, entries = _schedule_on_device(t, num_frames, str(q.device))
        with torch.cuda.device(q.device):
            err = _lib().mhla_radial_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                offsets.data_ptr(), entries.data_ptr(), b, t, h, t // num_frames,
                d**-0.5 if scale is None else scale, _stream(q),
            )
        _raise_on_error("radial_flash_attention", err)
        launches["radial_flash_attention"] += 1
    return out


def sparse_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_frames: int,
    scale: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
    impl: Optional[str] = None,  # None (auto) | "radial" | "splash"
) -> torch.Tensor:
    """Radial sparse attention, non-causal, over frame-major tokens; the
    result has q's dtype.

    ``compute_dtype`` is the dtype of the q, k and v streams. The default
    (None) casts float32 CUDA inputs to bf16, the only dtype the kernel
    takes, and leaves CPU inputs as they are: the JAX package likewise
    streams bf16 through its kernel and runs its CPU route in the inputs'
    dtype. Scores and softmax statistics are float32 regardless.
    ``compute_dtype=float32`` raises on a CUDA tensor."""
    if impl == "splash":
        raise NotImplementedError("the splash route (the differentiable path) is not ported yet")
    if impl not in (None, "radial"):
        raise ValueError(f"unknown impl {impl!r}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "radial-sparse attention has no backward yet (the JAX package differentiates "
            "through its splash route, which is not ported): training with sparse_attn_idx "
            "is not supported")
    if q.shape[1] % num_frames:
        raise NotImplementedError(
            f"{q.shape[1]} tokens in {num_frames} frames: ragged frames need the splash route, "
            "which is not ported yet")
    cdt = compute_dtype or (
        torch.bfloat16 if q.dtype == torch.float32 and q.device.type != "cpu" else q.dtype
    )
    out = radial_flash_attention(q.to(cdt), k.to(cdt), v.to(cdt), num_frames, scale)
    return out.to(q.dtype)
