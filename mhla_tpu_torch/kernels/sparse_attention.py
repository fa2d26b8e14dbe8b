"""Radial (n log n) sparse video attention on [B, T, H, D] tensors, forward
and backward (counterpart of ``mhla_tpu/kernels/sparse_attention.py``).

Tokens are frame-major: token i sits in frame ``i // hw`` at spatial index
``i % hw`` (``hw = T // num_frames``; where T is no multiple of
``num_frames`` the tokens from ``hw * num_frames`` on fall into further
frames by the same rule, the last of them shorter). A query in frame f
attends to all of frame g when ``|f - g| <= 1`` and to a spatial band that
halves per octave of temporal distance beyond that:

    allowed(i, j) = |s_i - s_j| < hw >> floor(log2(max(|f_i - f_j|, 1)))

K10 ``radial_flash_attention`` replaces the Pallas kernel
``_radial_fwd_kernel`` (``mhla_tpu/kernels/sparse_attention.py:312``) and the
forward of the JAX library's splash kernel, which the JAX package runs for
``impl="splash"`` and for ragged frames (``:477-493``): a flash forward that
walks, per tile of 64 query rows, only the 64-key tiles that hold an allowed
pair, and recomputes the mask inside the tile from index arithmetic
(``csrc/radial_fwd.cu``, where its bound and design are written). Its
training form also writes each row's log-sum-exp. K10b
``radial_flash_attention_bwd`` replaces the splash kernel's fused backward
(``:507-517``): dq, dk and dv, as the radial form of K9b's Hopper kernels
(``csrc/flash_bwd.cu``, where its bound, walk and order are written), each
walking only the tiles of its own list. Where a gradient is wanted
``radial_flash_attention`` goes through an ``autograd.Function`` of the
two; a call without gradients launches the forward that writes no
log-sum-exp.

The tile lists come from :func:`radial_schedule`, computed once per geometry
on frame pieces without any [T, T] array, and sit on the device in CSR form:
K10's 64 x 64 tiles, K10b's dQ kernel's query blocks of 128 over key tiles
of 64 and its dK/dV kernel's key blocks of 64 over query tiles of 128
(:data:`BWD_WALK_TILES`), the latter read from the key side; K10b's come
with an order of their blocks, longest list first.

A CPU tensor takes :func:`radial_flash_attention_plain` and
:func:`radial_flash_attention_bwd_plain`; a CUDA tensor launches the kernels
or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import flash_attention_bwd_plain, flash_attention_plain
from .mhla_chunk import _check, _on_cpu, _raise_on_error, _stream

launches = {"radial_flash_attention": 0, "radial_flash_attention_bwd": 0}

_HEAD_DIM = 128  # csrc: kD
_TILE = 64  # csrc: kBlockM = kBlockN
# (own block, step tile) of K10b's two kernels at head dim 128: the dK/dV
# kernel's 64 keys over query tiles of 128 (flash_bwd.cu's kTileRows and
# DkvGeom<128>::kQT), the dQ kernel's 128 queries over key tiles of 64
# (DqGeom<128>::kBlockM and kTileRows)
BWD_WALK_TILES = {"dkv": (64, 128), "dq": (128, 64)}
_lib_cache: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mhla_radial_fwd.argtypes = [p] * 6 + [i, i, i, i, ctypes.c_float, p]
        lib.mhla_radial_fwd_lse.argtypes = [p] * 7 + [i, i, i, i, ctypes.c_float, p]
        lib.mhla_flash_bwd_radial.argtypes = [p] * 17 + [i] * 4 + [ctypes.c_float, p]
        for fn in (lib.mhla_radial_fwd, lib.mhla_radial_fwd_lse, lib.mhla_flash_bwd_radial):
            fn.restype = ctypes.c_int
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


def _frame_size(seq_len: int, num_frames: int) -> int:
    hw = seq_len // num_frames if num_frames > 0 else 0
    if hw < 1:
        raise ValueError(f"{seq_len} tokens leave no token per frame in {num_frames} frames")
    return hw


def radial_allowed_pairs(seq_len: int, num_frames: int) -> int:
    """Number of allowed (query, key) pairs, counted from the mask's
    formula: two whole frames at distance d keep the pairs with
    ``|s_q - s_k| < w`` for their window w, ``hw + (w - 1) * (2 * hw - w)``
    of their ``hw * hw``; a shorter last frame of ``tail`` tokens keeps all
    pairs with itself and, against a whole frame, for each of its tokens the
    part of the band that lies inside the frame."""
    hw = _frame_size(seq_len, num_frames)
    whole, tail = divmod(seq_len, hw)
    s = np.arange(tail)
    total = tail * tail
    for d in range(whole + 1):
        w = int(radial_window(np.array(d), hw))
        if w <= 0:
            continue
        if d < whole:
            total += (hw + (w - 1) * (2 * hw - w)) * (whole if d == 0 else 2 * (whole - d))
        if d >= 1:  # the last frame against the whole frame d before it, both ways
            total += 2 * int((np.minimum(hw - 1, s + w - 1) - np.maximum(0, s - w + 1) + 1).sum())
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
    sizes; callers must not write into the cached arrays.

    The lists also read from the key side, at any two tile sizes, which is
    what the dK/dV kernel of the backward walks: the mask is symmetric, so
    ``radial_schedule(t, f, bk, bq)`` lists for key tile j (of ``bk`` keys)
    exactly the query tiles (of ``bq``) it meets, and an entry's ``full``
    then says that every pair of real keys of tile j with the listed query
    tile is allowed and that no *query* of it lies past ``t`` (tokens of the
    listing tile past ``t`` never count: they are not stored on either
    side)."""
    hw = _frame_size(t, num_frames)
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


def radial_bwd_lists(t: int, num_frames: int) -> dict:
    """K10b's lists by kernel (:data:`BWD_WALK_TILES`): for each, ``(offsets,
    tiles, full, order)`` of ``radial_schedule(t, num_frames, own, step)``,
    ``order`` the blocks by falling list length (stable: equal lengths keep
    their block order), the order the kernel's grid takes them in."""
    lists = {}
    for kernel, (own, step) in BWD_WALK_TILES.items():
        offsets, tiles, full = radial_schedule(t, num_frames, own, step)
        order = np.argsort(-np.diff(offsets), kind="stable").astype(np.int32)
        lists[kernel] = (offsets, tiles, full, order)
    return lists


def radial_bwd_visits(t: int, num_frames: int, heads: int, batch: int) -> list:
    """What K10b's ``visits`` counters read after one call on [batch, t,
    heads, 128]: the tiles of the dK/dV and the dQ kernel's lists, over all
    heads and batch rows."""
    lists = radial_bwd_lists(t, num_frames)
    return [heads * batch * len(lists[kernel][1]) for kernel in ("dkv", "dq")]


@functools.lru_cache(maxsize=8)
def _bwd_lists_on_device(t: int, num_frames: int, device: str):
    """K10b's lists on ``device``: (offsets, entries, order) int32 of the
    dK/dV kernel, then of the dQ kernel; an entry is ``2 * tile + full``.
    Built once per geometry and device."""
    out = []
    for offsets, tiles, full, order in radial_bwd_lists(t, num_frames).values():
        out += [torch.from_numpy(a).to(device) for a in (offsets, tiles * 2 + full, order)]
    return tuple(out)


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
    hw = _frame_size(seq_len, num_frames)
    win = torch.from_numpy(radial_window(np.arange(-(-seq_len // hw)), hw)).to(device)
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
    return_lse: bool = False,
):
    """Softmax attention under the radial mask: q, k, v [B, T, H, D] ->
    [B, T, H, D] in q's dtype. Query rows are walked in blocks, each with a
    full softmax over all keys under its rows of the mask, so no [T, T]
    array exists; arithmetic and rounding as in
    :func:`flash_attention_plain`. ``return_lse`` also returns each row's
    log-sum-exp of its allowed scaled scores, [B, H, T] float32 (finite: a
    row always keeps its own frame)."""
    t = q.shape[1]
    _frame_size(t, num_frames)
    return flash_attention_plain(
        q, k, v, scale, block_rows,
        row_mask=lambda r0, r1: radial_block_mask(r0, r1, t, num_frames, q.device),
        return_lse=return_lse,
    )


def radial_flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    num_frames: int,
    scale: Optional[float] = None,
    block_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`radial_flash_attention_plain` for
    ``do`` from its output ``o`` and log-sum-exp ``lse``:
    :func:`flash_attention_bwd_plain` with P zero outside the mask."""
    t = q.shape[1]
    return flash_attention_bwd_plain(
        q, k, v, o, lse, do, scale, block_rows,
        row_mask=lambda r0, r1: radial_block_mask(r0, r1, t, num_frames, q.device),
    )


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_frames: int) -> int:
    """Shape checks shared by K10 and K10b; returns the frame size."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    return _frame_size(q.shape[1], num_frames)


def _check_kernel_inputs(**tensors: torch.Tensor) -> None:
    """What the CUDA kernels take: contiguous 16-byte-aligned bf16 [B, T, H, 128]."""
    for name, x in tensors.items():
        _check(name, x, torch.bfloat16, 4)
    if tensors["q"].shape[-1] != _HEAD_DIM:
        raise ValueError(f"kernel takes head dim {_HEAD_DIM}, got {tensors['q'].shape[-1]}")
    if any(x.data_ptr() % 16 for x in tensors.values()):
        raise ValueError(f"kernel copies 16 bytes at a time: {', '.join(tensors)} must be "
                         "16-byte aligned")


def radial_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_frames: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """K10 (see :func:`radial_flash_attention_plain`): bf16, head dim 128,
    any T >= ``num_frames``. Differentiable in q, k and v through K10b.
    ``return_lse`` gives ``(out, lse)`` from the kernel's training form,
    outside autograd."""
    hw = _check_qkv(q, k, v, num_frames)
    if return_lse:
        return _radial_fwd(q, k, v, num_frames, hw, scale, True)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _RadialFlashAttention.apply(q, k, v, num_frames, scale)
    return _radial_fwd(q, k, v, num_frames, hw, scale, False)[0]


def _radial_fwd(q, k, v, num_frames: int, hw: int, scale: Optional[float], want_lse: bool):
    """``(out, lse | None)``: the plain version for CPU tensors, K10 for CUDA
    tensors, in its training form (which writes ``lse``) when ``want_lse``."""
    b, t, h, d = q.shape
    if _on_cpu(q, k, v):
        out = radial_flash_attention_plain(q, k, v, num_frames, scale, return_lse=want_lse)
        return out if want_lse else (out, None)
    _check_kernel_inputs(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device) if want_lse else None
    if b * h:
        offsets, entries = _schedule_on_device(t, num_frames, str(q.device))
        scale = d**-0.5 if scale is None else scale
        with torch.cuda.device(q.device):
            if want_lse:
                err = _lib().mhla_radial_fwd_lse(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    offsets.data_ptr(), entries.data_ptr(), b, t, h, hw, scale, _stream(q),
                )
            else:
                err = _lib().mhla_radial_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    offsets.data_ptr(), entries.data_ptr(), b, t, h, hw, scale, _stream(q),
                )
        _raise_on_error("radial_flash_attention", err)
        launches["radial_flash_attention"] += 1
    return out, lse


def radial_flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    num_frames: int,
    scale: Optional[float] = None,
    visits: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10b (see :func:`radial_flash_attention_bwd_plain`); the result is the
    same from run to run (no atomics). ``visits`` (int32 [2] on the card)
    gets the tiles walked by the dK/dV and the dQ kernel added
    (:func:`radial_bwd_visits`)."""
    b, t, h, d = q.shape
    hw = _check_qkv(q, k, v, num_frames)
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (b, h, t):
        raise ValueError(f"q {tuple(q.shape)}, o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} disagree")
    if _on_cpu(q, k, v, o, lse, do):
        return radial_flash_attention_bwd_plain(q, k, v, o, lse, do, num_frames, scale)
    _check_kernel_inputs(q=q, k=k, v=v, o=o, do=do)
    _check("lse", lse, torch.float32, 3)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b * h:
        lists = _bwd_lists_on_device(t, num_frames, str(q.device))
        delta = torch.empty_like(lse)
        with torch.cuda.device(q.device):
            err = _lib().mhla_flash_bwd_radial(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *(x.data_ptr() for x in lists), None if visits is None else visits.data_ptr(),
                b, t, h, hw, d**-0.5 if scale is None else scale, _stream(q),
            )
        _raise_on_error("radial_flash_attention_bwd", err)
        launches["radial_flash_attention_bwd"] += 1
    return dq, dk, dv


class _RadialFlashAttention(torch.autograd.Function):
    """K10 forward in its training form (it also writes the row log-sum-exp),
    K10b backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_frames, scale):
        o, lse = radial_flash_attention(q, k, v, num_frames, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_frames, ctx.scale = num_frames, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = radial_flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.num_frames,
                                           ctx.scale)
        return (*grads, None, None)


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
    result has q's dtype, and so have the gradients (the casts below lie
    outside the kernels' ``autograd.Function``).

    ``compute_dtype`` is the dtype of the q, k and v streams. The default
    (None) casts float32 CUDA inputs to bf16, the only dtype the kernels
    take, and leaves CPU inputs as they are: the JAX package likewise
    streams bf16 through its kernels and runs its CPU route in the inputs'
    dtype. Scores and softmax statistics are float32 regardless.
    ``compute_dtype=float32`` raises on a CUDA tensor.

    ``impl`` names the JAX package's two kernels, which compute the same
    function; here one kernel serves both. ``"radial"`` keeps that kernel's
    demand that the tokens split evenly into the frames; ``"splash"`` and the
    default take ragged frames too."""
    if impl not in (None, "radial", "splash"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "radial" and q.shape[1] % num_frames:
        raise ValueError(f"impl='radial': {q.shape[1]} tokens do not split into {num_frames} "
                         "frames")
    cdt = compute_dtype or (
        torch.bfloat16 if q.dtype == torch.float32 and q.device.type != "cpu" else q.dtype
    )
    out = radial_flash_attention(q.to(cdt), k.to(cdt), v.to(cdt), num_frames, scale)
    return out.to(q.dtype)
