"""Flash (softmax) attention on [B, T, H, D] tensors, forward and backward
(counterpart of ``mhla_tpu/kernels/flash_attention.py``).

K9 ``flash_attention`` replaces the JAX library's Pallas TPU flash kernel
that ``mhla_tpu/kernels/flash_attention.py:59-63,115-118`` calls for long
queries: the video model's text cross-attention (31,500 queries against
512 keys) and, with equal lengths, its softmax self-attention and the LM's
softmax layers. The kernel (``csrc/flash_fwd.cu``, where its bound and
design are written: TMA loads, wgmma products and a producer warpgroup,
``csrc/hopper.cuh``) takes bf16 with a head dim of 128 or 256 and any two
lengths; it needs no padding and no segment ids, because it checks its own
bounds. The JAX rule sends every head dim that is a multiple of 128 to the
library kernel; on a CUDA tensor any other than 128 and 256 (384, ...)
raises here.

K9b ``flash_attention_bwd`` replaces that library's backward kernels, which
``jax.grad`` reaches through the same call: from q, k, v, the output, its
row log-sum-exp and dO it gives dq, dk and dv (``csrc/flash_bwd.cu``). When a
gradient is wanted ``flash_attention`` goes through an ``autograd.Function``
whose forward is K9 in its training form, which also writes the row
log-sum-exp [B, H, Tq]; a call without gradients launches the same kernel as
before and writes none.

The causal and segment-id forms (``causal=True`` and / or ``segment_ids``
[B, T], Tq == Tk, as the JAX wrapper requires) replace the same library
kernel called with ``causal=True`` and ``SegmentIds``
(``flash_attention.py:73-104``): key j is kept for query i iff j <= i
(causal) and seg[b, i] == seg[b, j]. Their kernels (``mhla_flash_fwd_masked``
and ``mhla_flash_bwd_masked`` in the same sources, counted as
``flash_attention_masked`` and ``flash_attention_masked_bwd``) walk only the
tiles that can hold a kept pair, in each kernel's own geometry
(``WALK_TILES``); ``visited_tiles`` and ``kernel_visits`` give their
count.

A CPU tensor takes :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain`; a CUDA tensor launches the kernels or
raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from . import _build
from .mhla_chunk import _check, _on_cpu, _raise_on_error, _stream

launches = {"flash_attention": 0, "flash_attention_bwd": 0,
            "flash_attention_masked": 0, "flash_attention_masked_bwd": 0}

_HEAD_DIMS = (128, 256)  # the instantiations of csrc/flash_fwd.cu and flash_bwd.cu
_RANGE_TILE = 64  # tokens per segment-id range of the pre-pass (csrc/flash_mask.cuh kTile)
# (query rows, keys) of one step of each masked kernel's walk, per head dim:
# K9's query block x key tile, K9b's dK/dV kernel (a query tile x its block
# of 64 keys) and its dQ kernel (a query block x key tiles of 64); the
# kernels' kBlockM / kBlockN, DkvGeom::kQT and DqGeom::kBlockM
WALK_TILES = {
    128: {"fwd": (128, 128), "dkv": (128, 64), "dq": (128, 64)},
    256: {"fwd": (128, 64), "dkv": (64, 64), "dq": (64, 64)},
}
_lib_cache: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mhla_flash_fwd.argtypes = [p, p, p, p] + [i] * 5 + [ctypes.c_float, p]
        lib.mhla_flash_fwd_lse.argtypes = [p] * 5 + [i] * 5 + [ctypes.c_float, p]
        lib.mhla_flash_bwd.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_float, p]
        lib.mhla_flash_fwd_masked.argtypes = [p] * 8 + [i] * 5 + [ctypes.c_float, p]
        lib.mhla_flash_bwd_masked.argtypes = [p] * 13 + [i] * 5 + [ctypes.c_float, p]
        for fn in (lib.mhla_flash_fwd, lib.mhla_flash_fwd_lse, lib.mhla_flash_bwd,
                   lib.mhla_flash_fwd_masked, lib.mhla_flash_bwd_masked):
            fn.restype = ctypes.c_int
        _lib_cache = lib
    return _lib_cache


# float32 score elements one row block of the plain version may hold (2 GiB)
_PLAIN_SCORE_ELEMS = 1 << 29


def keep_mask(
    causal: bool, segment_ids: Optional[torch.Tensor], tk: int, device
) -> Optional[Callable[[int, int], torch.Tensor]]:
    """``row_mask`` of the causal and segment-id forms for the plain
    versions: ``(r0, r1) ->`` bool [B or 1, 1, r1 - r0, Tk], true where key
    j is kept for query i (j <= i when causal; equal segment ids); None
    when neither is asked for."""
    if not causal and segment_ids is None:
        return None

    def row_mask(r0: int, r1: int) -> torch.Tensor:
        keep = None
        if causal:
            rows = torch.arange(r0, r1, device=device)[:, None]
            keep = (rows >= torch.arange(tk, device=device)[None, :])[None, None]
        if segment_ids is not None:
            same = (segment_ids[:, r0:r1, None] == segment_ids[:, None, :tk])[:, None]
            keep = same if keep is None else keep & same
        return keep

    return row_mask


def _and_masks(a, b):
    if a is None or b is None:
        return a or b
    return lambda r0, r1: a(r0, r1) & b(r0, r1)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    block_rows: Optional[int] = None,
    row_mask: Optional[Callable[[int, int], torch.Tensor]] = None,
    return_lse: bool = False,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
):
    """softmax(scale * q k^T) v per batch row and head: q [B, Tq, H, D],
    k, v [B, Tk, H, D] -> [B, Tq, H, D] in q's dtype. Scores, softmax and
    sums are float32; the probabilities are rounded to q's dtype before the
    product with v, as the kernel rounds its unnormalized ones.

    Query rows are walked ``block_rows`` at a time (None: as many as keep a
    block's [B, H, rows, Tk] scores within 2 GiB; all of them at the video
    model's cross-attention, 710 at its 31,500-token self-attention). Each
    block takes one full softmax over all keys, so the result does not
    depend on the blocking beyond the order of the products' sums.
    ``row_mask(r0, r1)`` gives a bool keep-mask for those query rows,
    broadcastable to [B, H, r1 - r0, Tk]; ``causal`` and ``segment_ids``
    [B, T] add the masks of :func:`keep_mask`. Every row must keep at least
    one key. ``return_lse`` also returns each row's log-sum-exp of the
    scaled scores, [B, H, Tq] float32."""
    b, tq, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    row_mask = _and_masks(row_mask, keep_mask(causal, segment_ids, k.shape[1], q.device))
    if block_rows is None:
        block_rows = max(1, _PLAIN_SCORE_ELEMS // max(1, b * h * k.shape[1]))
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=q.device) if return_lse else None
    for r0 in range(0, tq, block_rows):
        r1 = min(tq, r0 + block_rows)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1].float(), kf) * scale
        if row_mask is not None:
            s.masked_fill_(~row_mask(r0, r1), float("-inf"))
        if return_lse:
            lse[:, :, r0:r1] = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1).to(q.dtype).float()
        out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return (out, lse) if return_lse else out


# float32 score elements one row block of the plain backward may hold in
# each of its four [B, H, rows, Tk] arrays (512 MiB)
_PLAIN_BWD_SCORE_ELEMS = 1 << 27


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    block_rows: Optional[int] = None,
    row_mask: Optional[Callable[[int, int], torch.Tensor]] = None,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_attention_plain` for ``do``,
    from its output ``o`` and row log-sum-exp ``lse`` [B, H, Tq], without ever
    holding [Tq, Tk]: with ``delta = rowsum(do * o)`` the query rows are
    walked ``block_rows`` at a time, ``P = exp(scale * q k^T - lse)``,
    ``dv += P^T do``, ``dS = P * (do v^T - delta)``, ``dq = scale * dS k``,
    ``dk += scale * dS^T q``. All sums are float32; P and dS are rounded to
    q's dtype before their products, and P before dS, as the kernel rounds
    them. The result does not depend on the blocking beyond the order of the
    sums over the query rows. ``row_mask``, ``causal`` and ``segment_ids``
    are the forward's: P is 0 where the mask drops a pair (set, not
    multiplied: a masked score may lie far above ``lse``)."""
    b, tq, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    row_mask = _and_masks(row_mask, keep_mask(causal, segment_ids, k.shape[1], q.device))
    if block_rows is None:
        block_rows = max(1, _PLAIN_BWD_SCORE_ELEMS // max(1, b * h * k.shape[1]))
    kf, vf = k.float(), v.float()
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)  # [B, H, Tq]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, tq, block_rows):
        r1 = min(tq, r0 + block_rows)
        qf, dof = q[:, r0:r1].float(), do[:, r0:r1].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        p = torch.exp(s - lse[:, :, r0:r1, None])
        if row_mask is not None:
            p.masked_fill_(~row_mask(r0, r1), 0.0)
        p = p.to(q.dtype).float()
        dv += torch.einsum("bhqk,bqhd->bkhd", p, dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
        ds = (p * (dp - delta[:, :, r0:r1, None])).to(q.dtype).float()
        dq[:, r0:r1] = (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq, (dk * scale).to(k.dtype), dv.to(v.dtype)


def walk_tiles(causal: bool, segment_ids: Optional[torch.Tensor], t: int, block_q: int,
               block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (query block, key tile) pairs of one head that the masked kernels
    walk, with blocks of ``block_q`` query rows and tiles of ``block_k``
    keys (multiples of 64; the last of each cut at ``t``), and which of
    those need the per-element rule (``csrc/flash_mask.cuh``): bool
    [B or 1, ceil(t / block_q), ceil(t / block_k)] each. With query span
    [qa, qb] and key span [ka, kb], causal walks the pair iff ka <= qb and
    needs the rule iff kb > qa; with ``segment_ids`` [B, t] the pair is
    walked iff the [min, max] id ranges of the two spans meet and needs the
    rule unless both hold one and the same id."""
    nq, nk = -(-t // block_q), -(-t // block_k)
    qa, qb = torch.arange(nq) * block_q, (torch.arange(nq) * block_q + block_q).clamp(max=t) - 1
    ka, kb = torch.arange(nk) * block_k, (torch.arange(nk) * block_k + block_k).clamp(max=t) - 1
    walked = torch.ones(1, nq, nk, dtype=torch.bool)
    rule = torch.zeros(1, nq, nk, dtype=torch.bool)
    if causal:
        walked = walked & (ka[None, :] <= qb[:, None])[None]
        rule = rule | (kb[None, :] > qa[:, None])[None]
    if segment_ids is None:
        return walked, rule & walked
    ids = segment_ids.detach().to("cpu", torch.int64)

    def span_ranges(size: int, n: int):
        last = ids[:, -1:].expand(-1, n * size - t)  # repeats a real id: the ranges stay the same
        spans = torch.cat([ids, last], dim=1).reshape(ids.shape[0], n, size)
        return spans.amin(-1), spans.amax(-1)

    (qlo, qhi), (klo, khi) = span_ranges(block_q, nq), span_ranges(block_k, nk)
    meets = (qlo[:, :, None] <= khi[:, None, :]) & (klo[:, None, :] <= qhi[:, :, None])
    one_id = ((qlo == qhi)[:, :, None] & (klo == khi)[:, None, :]
              & (qlo[:, :, None] == klo[:, None, :]))
    walked = walked & meets
    return walked, (rule | ~one_id) & walked


def visited_tiles(causal: bool, segment_ids: Optional[torch.Tensor], t: int,
                  block_q: int = 64, block_k: int = 64) -> int:
    """The number of (query block, key tile) pairs of one head that a masked
    kernel with that geometry walks (:func:`walk_tiles`; a dK/dV kernel
    walks query tiles from its key block: the same set), summed over the
    batch rows of ``segment_ids`` (or for one row)."""
    return int(walk_tiles(causal, segment_ids, t, block_q, block_k)[0].sum())


def kernel_visits(causal: bool, segment_ids: Optional[torch.Tensor], t: int, d: int,
                  heads: int, batch: int) -> list:
    """What the ``visits`` counters of K9 and K9b's dK/dV and dQ kernels read
    after one masked call each on [batch, t, heads, d]: the walked tiles at
    each kernel's geometry (:data:`WALK_TILES`) over all heads and rows."""
    rows = 1 if segment_ids is not None else batch
    return [heads * rows * visited_tiles(causal, segment_ids, t, *WALK_TILES[d][kernel])
            for kernel in ("fwd", "dkv", "dq")]


def _masked_args(q: torch.Tensor, causal: bool, segment_ids: Optional[torch.Tensor]):
    """Checks of the masked forms; (seg int32 [B, T] or None, the range
    scratch or None) on q's device."""
    b, t = q.shape[:2]
    if segment_ids is None:
        return None, None
    if tuple(segment_ids.shape) != (b, t) or segment_ids.device != q.device:
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} on {segment_ids.device} do "
                         f"not match q {tuple(q.shape)} on {q.device}")
    seg = segment_ids.to(torch.int32).contiguous()
    return seg, torch.empty(b, -(-t // _RANGE_TILE), 2, dtype=torch.int32, device=q.device)


def _check_head_dim(d: int) -> None:
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head dim {' or '.join(map(str, _HEAD_DIMS))}, got {d}")


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    visits: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9b (see :func:`flash_attention_bwd_plain`): any Tq and Tk >= 1, or,
    with ``causal`` and / or ``segment_ids`` [B, T], Tq == Tk; the result is
    the same from run to run (no atomics). ``visits`` (int32 [2] on the
    card, masked forms) gets the tiles walked by the dK/dV and the dQ kernel
    added."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if (tuple(k.shape) != (b, tk, h, d) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape or tuple(lse.shape) != (b, h, tq)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} disagree")
    masked = causal or segment_ids is not None
    if masked and tq != tk:
        raise ValueError(f"causal and segment-id attention need Tq == Tk, got {tq} and {tk}")
    if _on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale, causal=causal,
                                         segment_ids=segment_ids)
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check(name, x, torch.bfloat16, 4)
    _check("lse", lse, torch.float32, 3)
    _check_head_dim(d)
    if any(x.data_ptr() % 16 for x in (q, k, v, o, do)):
        raise ValueError("kernel copies 16 bytes at a time: its inputs must be 16-byte aligned")
    seg, ranges = _masked_args(q, causal, segment_ids)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b * tq * h:
        delta = torch.empty_like(lse)
        scale = d**-0.5 if scale is None else scale
        with torch.cuda.device(q.device):
            if masked:
                err = _lib().mhla_flash_bwd_masked(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), _ptr(seg), _ptr(ranges), _ptr(visits), b, tq, h, d,
                    int(causal), scale, _stream(q),
                )
            else:
                err = _lib().mhla_flash_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), b, tq, tk, h, d, scale, _stream(q),
                )
        _raise_on_error("flash_attention_bwd", err)
        launches["flash_attention_masked_bwd" if masked else "flash_attention_bwd"] += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K9 forward in its training form (it also writes the row log-sum-exp),
    K9b backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, segment_ids):
        o, lse = _flash_fwd(q, k, v, scale, True, causal, segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.scale, ctx.causal,
                                    segment_ids)
        return (*grads, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K9 (see :func:`flash_attention_plain`): any Tq and Tk >= 1; with
    ``causal`` and / or ``segment_ids`` [B, T] (tokens attend within their
    own segment), Tq == Tk. Differentiable in q, k and v through K9b."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if tuple(k.shape) != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if tk < 1:
        raise ValueError("attention over no keys")
    if (causal or segment_ids is not None) and tq != tk:
        raise ValueError(f"causal and segment-id attention need Tq == Tk, got {tq} and {tk}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, causal, segment_ids)
    return _flash_fwd(q, k, v, scale, False, causal, segment_ids)[0]


def _flash_fwd(q, k, v, scale: Optional[float], want_lse: bool, causal: bool = False,
               segment_ids: Optional[torch.Tensor] = None,
               visits: Optional[torch.Tensor] = None):
    """``(out, lse | None)``: the plain version for CPU tensors, K9 for CUDA
    tensors, in its training form (which writes ``lse``) when ``want_lse``,
    in its masked form with ``causal`` or ``segment_ids`` (``visits``, int32
    [1] on the card, then gets the walked key tiles added)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if _on_cpu(q, k, v):
        out = flash_attention_plain(q, k, v, scale, return_lse=want_lse, causal=causal,
                                    segment_ids=segment_ids)
        return out if want_lse else (out, None)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, torch.bfloat16, 4)
    _check_head_dim(d)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("kernel copies 16 bytes at a time: q, k and v must be 16-byte aligned")
    masked = causal or segment_ids is not None
    seg, ranges = _masked_args(q, causal, segment_ids)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq, dtype=torch.float32, device=q.device) if want_lse else None
    if b * tq * h:
        scale = d**-0.5 if scale is None else scale
        with torch.cuda.device(q.device):
            if masked:
                err = _lib().mhla_flash_fwd_masked(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
                    _ptr(seg), _ptr(ranges), _ptr(visits), b, tq, h, d, int(causal), scale,
                    _stream(q),
                )
            elif want_lse:
                err = _lib().mhla_flash_fwd_lse(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    b, tq, tk, h, d, scale, _stream(q),
                )
            else:
                err = _lib().mhla_flash_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, tq, tk, h, d,
                    scale, _stream(q),
                )
        _raise_on_error("flash_attention", err)
        launches["flash_attention_masked" if masked else "flash_attention"] += 1
    return out, lse
