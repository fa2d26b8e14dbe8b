"""Non-causal flash (softmax) attention forward on [B, T, H, D] tensors
(counterpart of ``mhla_tpu/kernels/flash_attention.py``).

K9 ``flash_attention`` replaces the JAX library's Pallas TPU flash kernel
that ``mhla_tpu/kernels/flash_attention.py:59-63,115-118`` calls for long
queries: the video model's text cross-attention (31,500 queries against
512 keys) and, with equal lengths, its softmax self-attention. The kernel
(``csrc/flash_fwd.cu``, where its bound and design are written) takes bf16
with a head dim of 128 and any two lengths; it needs no padding and no
segment ids, because it checks its own bounds.

A CPU tensor takes :func:`flash_attention_plain`; a CUDA tensor launches
the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from . import _build
from .mhla_chunk import _check, _on_cpu, _raise_on_error, _stream

launches = {"flash_attention": 0}

_HEAD_DIM = 128  # csrc: kD
_lib_cache: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mhla_flash_fwd.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, p]
        lib.mhla_flash_fwd.restype = ctypes.c_int
        _lib_cache = lib
    return _lib_cache


# float32 score elements one row block of the plain version may hold (2 GiB)
_PLAIN_SCORE_ELEMS = 1 << 29


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    block_rows: Optional[int] = None,
    row_mask: Optional[Callable[[int, int], torch.Tensor]] = None,
) -> torch.Tensor:
    """softmax(scale * q k^T) v per batch row and head: q [B, Tq, H, D],
    k, v [B, Tk, H, D] -> [B, Tq, H, D] in q's dtype. Scores, softmax and
    sums are float32; the probabilities are rounded to q's dtype before the
    product with v, as the kernel rounds its unnormalized ones.

    Query rows are walked ``block_rows`` at a time (None: as many as keep a
    block's [B, H, rows, Tk] scores within 2 GiB; all of them at the video
    model's cross-attention, 710 at its 31,500-token self-attention). Each
    block takes one full softmax over all keys, so the result does not
    depend on the blocking beyond the order of the products' sums.
    ``row_mask(r0, r1)`` gives a bool keep-mask [r1 - r0, Tk] for those
    query rows; every row must keep at least one key."""
    b, tq, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    if block_rows is None:
        block_rows = max(1, _PLAIN_SCORE_ELEMS // max(1, b * h * k.shape[1]))
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for r0 in range(0, tq, block_rows):
        r1 = min(tq, r0 + block_rows)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1].float(), kf) * scale
        if row_mask is not None:
            s.masked_fill_(~row_mask(r0, r1), float("-inf"))
        p = torch.softmax(s, dim=-1).to(q.dtype).float()
        out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K9 (see :func:`flash_attention_plain`): any Tq and Tk >= 1."""
    if causal or segment_ids is not None:
        raise NotImplementedError("causal and packed (segment_ids) flash attention "
                                  "are not ported yet")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if tuple(k.shape) != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if tk < 1:
        raise ValueError("attention over no keys")
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, torch.bfloat16, 4)
    if d != _HEAD_DIM:
        raise ValueError(f"kernel takes head dim {_HEAD_DIM}, got {d}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("kernel copies 16 bytes at a time: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if b * tq * h:
        with torch.cuda.device(q.device):
            err = _lib().mhla_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, tq, tk, h,
                d**-0.5 if scale is None else scale, _stream(q),
            )
        _raise_on_error("flash_attention", err)
        launches["flash_attention"] += 1
    return out
