"""Non-causal blockwise MHLA (video) on head-flat tensors through seven
hand-written kernels (counterpart of ``mhla_tpu/kernels/mhla_block_pallas.py``),
four of the forward:

  K5 ``blockify_island``    flat [B, T, F] -> blocked [B, N, C, F] with the
                            island prologue fused in: full-dim RMSNorm,
                            ``relu + eps``, 3-D rotate-half RoPE, the 3-D
                            block permutation (Triton)
  K6 ``mix_states_dense``   mixed_i = sum_j M[i, j] S_j, dense [N, N]
                            (CUDA C++, ``csrc/mhla_block.cu``: TF32 tensor
                            cores, operands split to float32 accuracy)
  K7 ``block_readout``      o_i = q_i @ mixed_i per block and head (CUDA C++,
                            ``csrc/mhla_block.cu``: TF32 tensor cores,
                            operands split to float32 accuracy)
  K8 ``unblockify_island``  blocked [B, N, C, F] -> flat [B, T, F] with the
                            per-head RMSNorm and the output cast (Triton)

K5 replaces ``_island_kernel`` (``mhla_block_pallas.py:472``) and K8
``_unisland_kernel`` (``:672``). Both are bound by bytes: one read and one
write of every element, a handful of FLOP each. The TPU kernels move whole
(f-block, h-block) stripes because of that chip's block rules; here one
program takes a few token rows, computes each row's source (K5) or
destination (K8) from the block geometry, and moves whole contiguous
head-flat rows, so every access is coalesced whatever the permutation. K5
computes the row's inverse RMS itself (a first pass over the row, which the
second pass finds in cache) instead of taking it from a separate stats
pass. K6 and K7 are described in ``csrc/mhla_block.cu``.

and three of the backward, behind the ``autograd.Function``s that follow the
custom VJPs of the JAX module:

  K8b ``blockify``           flat [B, T, F] -> blocked [B, N, C, F], optional
                             rotate-half RoPE on the way (CUDA C++,
                             ``csrc/mhla_permute.cu``); the transpose of K8's
                             permutation
  K5b ``unblockify``         blocked -> flat with the same optional RoPE, and
                             optionally a second blocked tensor summed in
                             without RoPE (the same kernel); with the sine
                             negated it is the transpose of K5's RoPE and
                             permutation
  K7b ``block_readout_bwd``  dq_i = dO_i @ mixed_i^T, dmixed_i = q_i^T @ dO_i
                             (CUDA C++, ``csrc/mhla_block_bwd.cu``: TF32
                             tensor cores, operands split to float32
                             accuracy)

K8b replaces ``_blockify_kernel`` (``mhla_block_pallas.py:261``) and K5b
``_unblockify_kernel`` (``:273``): one CUDA kernel in two directions that
moves whole token rows by bulk copies and reads each token's rotary row once
for all heads (``csrc/mhla_permute.cu``). Both are bound by bytes. They read
the incoming gradient in its own dtype and write float32, so the cast the
JAX backward makes first costs no pass; K5b takes the gradient of the
pre-RoPE copy in the same pass instead of a second launch and an addition.
The backward of the dense mix is K6 on the transposed matrix (as in JAX);
``dM`` is an einsum, as there. The elementwise parts of the islands'
backward (RMSNorm and relu) are plain PyTorch, as they are ``jnp`` in JAX.

The per-block states (phase A) have no kernel here because the JAX package
has none on this path either: at C = 210 tokens per block its ``_phase_a``
fails the tiling rule and runs an einsum
(``mhla_tpu/kernels/mhla_chunk_pallas.py:239-256``).

Each wrapper runs its plain PyTorch version (``*_plain``: same function,
same rounding points) for a CPU tensor, and launches its kernel for a CUDA
tensor or raises. ``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..ops.mhla_blockwise import mhla_blockwise_mh
from . import _build
from .mhla_chunk import _check, _on_cpu, _raise_on_error, _stream

launches = {
    "blockify_island": 0, "mix_states_dense": 0, "block_readout": 0,
    "unblockify_island": 0, "block_readout_bwd": 0, "blockify": 0, "unblockify": 0,
}

_BLOCK_R = 4  # token rows per program of K5 and K8
_MAX_BLOCKS = 224  # K6 splits N over clusters of at most four blocks (csrc: kMaxMixBlocks)
_MIX_COLS = 32  # K6 takes state sizes in multiples of 32 columns
_READ_DK = (128, 256)  # K7's head dims (csrc: readout_kernel's kDk)
_READ_DV = 128  # K7 takes Dv in multiples of it, K7b only it (csrc: kDv)
_READ_KT = 128  # K7b takes Dk in multiples of it
_MID_CODE = {None: 0, torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # 0: no rounding
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

# bound by _load_triton() at the first launch on a CUDA tensor; the kernels
# below are plain Python until then (their annotations stay unevaluated strings)
triton = tl = None
_kernels = None
_lib_cache: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mhla_mix_states_dense.argtypes = [p, p, p, i, i, ctypes.c_longlong, i, p]
        lib.mhla_block_readout.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.mhla_block_readout_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        ll = ctypes.c_longlong
        lib.mhla_permute.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll, i, i, i, i, i, i, i,
                                     ctypes.c_float, i, i, i, i, i, i, i, p]
        lib.mhla_permute.restype = ctypes.c_int
        lib.mhla_mix_states_dense.restype = ctypes.c_int
        lib.mhla_block_readout.restype = ctypes.c_int
        lib.mhla_block_readout_bwd.restype = ctypes.c_int
        _lib_cache = lib
    return _lib_cache


# ---------------------------------------------------------------------------
# block geometry
# ---------------------------------------------------------------------------


def _block_geometry(grid: Sequence[int], layout: Sequence[int]):
    """(pf, ph, pw, C, N): tokens per block along each axis, per block, and
    the number of blocks, for an (F, H, W) token grid cut into ``layout``
    blocks along each axis."""
    (fg, hg, wg), (nf, nh, nw) = grid, layout
    if fg % nf or hg % nh or wg % nw:
        raise ValueError(f"grid {tuple(grid)} is not divisible by the block layout {tuple(layout)}")
    pf, ph, pw = fg // nf, hg // nh, wg // nw
    return pf, ph, pw, pf * ph * pw, nf * nh * nw


def block_token_index(
    grid: Sequence[int], layout: Sequence[int], device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Flat token index of every blocked position, [N*C] int64: the
    permutation ``(fb p1 hb p2 wb p3) -> (fb hb wb)(p1 p2 p3)``."""
    (fg, hg, wg), (nf, nh, nw) = grid, layout
    pf, ph, pw, c, n = _block_geometry(grid, layout)
    idx = torch.arange(fg * hg * wg, device=device).reshape(nf, pf, nh, ph, nw, pw)
    return idx.permute(0, 2, 4, 1, 3, 5).reshape(n * c)


# ---------------------------------------------------------------------------
# the Triton kernels (K5, K8)
# ---------------------------------------------------------------------------


def _island_fwd(
    x_ptr, g_ptr, cos_ptr, sin_ptr, o_ptr, nope_ptr,
    n_rows, rows_per_batch, blk_c, stride_b, stride_t,
    lay_h, lay_w, part_f, part_h, part_w, grid_h, grid_w, norm_eps, relu_eps,
    F: tl.constexpr, H: tl.constexpr, DH: tl.constexpr, HALF: tl.constexpr,
    USE_NORM: tl.constexpr, RELU: tl.constexpr, ROPE: tl.constexpr,
    EMIT_NOPE: tl.constexpr, MID: tl.constexpr, BLOCK_R: tl.constexpr,
):
    # one program: BLOCK_R rows of the blocked output, all heads
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, HALF)
    mask = (rows[:, None] < n_rows) & (cols[None, :] < HALF)
    # blocked row -> (batch, block, position) -> flat token of the (F, H, W) grid
    bidx = rows // rows_per_batch
    rem = rows % rows_per_batch
    blk = rem // blk_c
    pos = rem % blk_c
    fb = blk // (lay_h * lay_w)
    hb = (blk // lay_w) % lay_h
    wb = blk % lay_w
    p1 = pos // (part_h * part_w)
    p2 = (pos // part_w) % part_h
    p3 = pos % part_w
    tok = ((fb * part_f + p1) * grid_h + hb * part_h + p2) * grid_w + wb * part_w + p3
    src = bidx.to(tl.int64) * stride_b + tok.to(tl.int64) * stride_t
    dst = rows.to(tl.int64) * F

    inv = tl.full([BLOCK_R], 1.0, dtype=tl.float32)
    if USE_NORM:
        ss = tl.zeros([BLOCK_R], dtype=tl.float32)
        for h in range(H):
            off = src[:, None] + h * DH + cols[None, :]
            x1 = tl.load(x_ptr + off, mask=mask, other=0.0)
            x2 = tl.load(x_ptr + off + HALF, mask=mask, other=0.0)
            if MID == 1:
                x1 = x1.to(tl.bfloat16)
                x2 = x2.to(tl.bfloat16)
            elif MID == 2:
                x1 = x1.to(tl.float16)
                x2 = x2.to(tl.float16)
            x1 = x1.to(tl.float32)
            x2 = x2.to(tl.float32)
            ss += tl.sum(x1 * x1, axis=1) + tl.sum(x2 * x2, axis=1)
        inv = 1.0 / tl.sqrt(ss / F + norm_eps)
    if ROPE:
        t_off = tok[:, None] * DH + cols[None, :]
        c1 = tl.load(cos_ptr + t_off, mask=mask, other=0.0)
        c2 = tl.load(cos_ptr + t_off + HALF, mask=mask, other=0.0)
        s1 = tl.load(sin_ptr + t_off, mask=mask, other=0.0)
        s2 = tl.load(sin_ptr + t_off + HALF, mask=mask, other=0.0)

    for h in range(H):
        off = src[:, None] + h * DH + cols[None, :]
        x1 = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        x2 = tl.load(x_ptr + off + HALF, mask=mask, other=0.0).to(tl.float32)
        if USE_NORM:
            g1 = tl.load(g_ptr + h * DH + cols)
            g2 = tl.load(g_ptr + h * DH + HALF + cols)
            x1 = x1 * inv[:, None] * g1[None, :]
            x2 = x2 * inv[:, None] * g2[None, :]
            if MID == 1:
                x1 = x1.to(tl.bfloat16).to(tl.float32)
                x2 = x2.to(tl.bfloat16).to(tl.float32)
            elif MID == 2:
                x1 = x1.to(tl.float16).to(tl.float32)
                x2 = x2.to(tl.float16).to(tl.float32)
        if RELU:
            x1 = tl.maximum(x1, 0.0) + relu_eps
            x2 = tl.maximum(x2, 0.0) + relu_eps
            if MID == 1:
                x1 = x1.to(tl.bfloat16).to(tl.float32)
                x2 = x2.to(tl.bfloat16).to(tl.float32)
            elif MID == 2:
                x1 = x1.to(tl.float16).to(tl.float32)
                x2 = x2.to(tl.float16).to(tl.float32)
        o_off = dst[:, None] + h * DH + cols[None, :]
        if EMIT_NOPE:
            tl.store(nope_ptr + o_off, x1.to(nope_ptr.dtype.element_ty), mask=mask)
            tl.store(nope_ptr + o_off + HALF, x2.to(nope_ptr.dtype.element_ty), mask=mask)
        if ROPE:
            y1 = x1 * c1 + x2 * s1
            y2 = x2 * c2 + x1 * s2
        else:
            y1 = x1
            y2 = x2
        tl.store(o_ptr + o_off, y1.to(o_ptr.dtype.element_ty), mask=mask)
        tl.store(o_ptr + o_off + HALF, y2.to(o_ptr.dtype.element_ty), mask=mask)


def _unisland_fwd(
    x_ptr, g_ptr, o_ptr,
    n_rows, rows_per_batch, blk_c, seq_len,
    lay_h, lay_w, part_f, part_h, part_w, grid_h, grid_w, eps,
    F: tl.constexpr, DH: tl.constexpr, MID: tl.constexpr, BLOCK_R: tl.constexpr,
):
    # one program: BLOCK_R rows of the blocked input, one head
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    head = tl.program_id(1)
    cols = tl.arange(0, DH)
    mask = (rows[:, None] < n_rows) & (cols[None, :] < DH)
    bidx = rows // rows_per_batch
    rem = rows % rows_per_batch
    blk = rem // blk_c
    pos = rem % blk_c
    fb = blk // (lay_h * lay_w)
    hb = (blk // lay_w) % lay_h
    wb = blk % lay_w
    p1 = pos // (part_h * part_w)
    p2 = (pos // part_w) % part_h
    p3 = pos % part_w
    tok = ((fb * part_f + p1) * grid_h + hb * part_h + p2) * grid_w + wb * part_w + p3
    src = rows.to(tl.int64) * F
    dst = (bidx.to(tl.int64) * seq_len + tok.to(tl.int64)) * F

    x = tl.load(x_ptr + src[:, None] + head * DH + cols[None, :], mask=mask, other=0.0)
    if MID == 1:
        x = x.to(tl.bfloat16)
    elif MID == 2:
        x = x.to(tl.float16)
    x = x.to(tl.float32)
    ss = tl.sum(x * x, axis=1) / DH
    g = tl.load(g_ptr + cols)
    y = x * (1.0 / tl.sqrt(ss + eps))[:, None] * g[None, :]
    tl.store(o_ptr + dst[:, None] + head * DH + cols[None, :],
             y.to(o_ptr.dtype.element_ty), mask=mask)


def _load_triton():
    global triton, tl, _kernels
    if _kernels is None:
        triton, tl = _build.import_triton()
        # one compiled variant per flag set, whatever the batch and the grid
        geometry = ["n_rows", "rows_per_batch", "blk_c", "seq_len", "lay_h", "lay_w",
                    "part_f", "part_h", "part_w", "grid_h", "grid_w"]
        _kernels = (
            triton.jit(_island_fwd, do_not_specialize=[n for n in geometry if n != "seq_len"]),
            triton.jit(_unisland_fwd, do_not_specialize=geometry),
        )
    return _kernels


# ---------------------------------------------------------------------------
# K5: island prologue
# ---------------------------------------------------------------------------


def _round_mid(x: torch.Tensor, mid_dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if mid_dtype is None else x.to(mid_dtype).float()


def _rope_flat_plain(x: torch.Tensor, tables, num_heads: int, sin_sign: float = 1.0):
    """Rotate-half RoPE on flat float32 x [B, T, H*Dh] with (cos, sin_signed)
    [T, Dh] tables shared by the heads."""
    b, t, f = x.shape
    dh = f // num_heads
    cos, sin = (tb.float()[None, :, None, :] for tb in tables)  # [1, T, 1, Dh]
    x4 = x.reshape(b, t, num_heads, dh)
    swapped = torch.cat([x4[..., dh // 2:], x4[..., : dh // 2]], dim=-1)
    return (x4 * cos + swapped * (sin * sin_sign)).reshape(b, t, f)


def blockify_island_plain(
    x: torch.Tensor,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]],
    gamma: Optional[torch.Tensor],
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    norm_eps: float = 1e-6,
    relu_eps: Optional[float] = None,
    mid_dtype: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
    emit_nope: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The function of :func:`blockify_island` in plain PyTorch."""
    b, t, f = x.shape
    _, _, _, c, n = _block_geometry(grid, layout)
    sub = x.float()
    if gamma is not None:
        xs = _round_mid(x, mid_dtype).float()
        inv = torch.rsqrt(torch.mean(xs * xs, dim=-1, keepdim=True) + norm_eps)
        sub = _round_mid(sub * inv * gamma.float(), mid_dtype)
    if relu_eps is not None:
        sub = _round_mid(torch.relu(sub) + relu_eps, mid_dtype)
    idx = block_token_index(grid, layout, x.device)
    blocked = lambda y: y.to(out_dtype)[:, idx].reshape(b, n, c, f)  # noqa: E731
    nope = blocked(sub) if emit_nope else None
    if tables is not None:
        sub = _rope_flat_plain(sub, tables, num_heads)
    return blocked(sub), nope


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True where autograd records and one of ``tensors`` wants a gradient:
    only then a wrapper goes through its ``autograd.Function``, so a call
    without gradients (sampling) pays nothing for it."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _BlockifyIsland(torch.autograd.Function):
    """K5 forward; backward as ``_blockify_island_bwd`` of the JAX module
    (``mhla_block_pallas.py:630``): K5b undoes the RoPE and the permutation,
    then the relu and RMSNorm terms in plain PyTorch on the flat float32
    gradient. The ``mid_dtype`` roundings pass the gradient straight through;
    the statistics are recomputed from the rounded input."""

    @staticmethod
    def forward(ctx, x, gamma, tables, args):
        ctx.save_for_backward(x, gamma)
        ctx.tables, ctx.args = tables, args
        out, nope = _blockify_island(x, tables, gamma, *args)
        return out if nope is None else (out, nope)

    @staticmethod
    def backward(ctx, dy, dnope=None):
        x, gamma = ctx.saved_tensors
        grid, layout, num_heads, norm_eps, relu_eps, mid_dtype = ctx.args[:6]
        tables = ctx.tables
        if dy is None:  # only the pre-RoPE copy was used
            dy, dnope, tables = dnope, None, None
        dr = unblockify(dy.contiguous(), tables, grid, layout, num_heads, sin_sign=-1.0,
                        out_dtype=torch.float32,
                        add=None if dnope is None else dnope.contiguous())
        xf = _round_mid(x, mid_dtype).float()
        if gamma is None:
            dxn = torch.where(xf > 0, dr, 0.0) if relu_eps is not None else dr
            return dxn.to(x.dtype), None, None, None
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + norm_eps)
        gf = gamma.float()
        dxn = torch.where(xf * inv * gf > 0, dr, 0.0) if relu_eps is not None else dr
        dgamma = None
        if ctx.needs_input_grad[1]:
            dgamma = (dxn * xf * inv).sum(dim=(0, 1)).to(gamma.dtype)
        u = dxn * gf
        dx = inv * u - xf * (inv**3 / x.shape[-1]) * torch.sum(u * xf, dim=-1, keepdim=True)
        return dx.to(x.dtype), dgamma, None, None


def blockify_island(
    x: torch.Tensor,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]],
    gamma: Optional[torch.Tensor],
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    norm_eps: float = 1e-6,
    relu_eps: Optional[float] = None,
    mid_dtype: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
    emit_nope: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5 (see :func:`_blockify_island`), differentiable in ``x`` and
    ``gamma`` through K5b."""
    args = (tuple(grid), tuple(layout), num_heads, norm_eps, relu_eps, mid_dtype, out_dtype,
            emit_nope)
    if _needs_grad(x, gamma):
        out = _BlockifyIsland.apply(x, gamma, tables, args)
        return out if emit_nope else (out, None)
    return _blockify_island(x, tables, gamma, *args)


def _blockify_island(
    x: torch.Tensor,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]],
    gamma: Optional[torch.Tensor],
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    norm_eps: float = 1e-6,
    relu_eps: Optional[float] = None,
    mid_dtype: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
    emit_nope: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K5, the fused island prologue: flat x [B, T, F] in its native dtype ->
    ``(blocked_rope, blocked_nope | None)`` [B, N, C, F] in ``out_dtype``.

    In float32 per row: full-dim RMSNorm with ``gamma`` [F] (skipped when
    None), ``relu(.) + relu_eps`` (skipped when None), rotate-half RoPE with
    ``tables`` = (cos, sin_signed) [T, Dh] shared by all heads and indexed in
    flat token order (skipped when None), then the 3-D block permutation.
    ``mid_dtype`` rounds between the steps as the composed path of a
    narrower island does; ``emit_nope`` also returns the pre-RoPE copy the
    normalizer reads. With every option off it is a cast and a permutation
    (the v stream)."""
    b, t, f = x.shape
    pf, ph, pw, c, n = _block_geometry(grid, layout)
    if t != n * c:
        raise ValueError(f"grid {tuple(grid)} does not match {t} tokens")
    if f % num_heads:
        raise ValueError(f"width {f} not divisible by {num_heads} heads")
    if mid_dtype not in _MID_CODE:
        raise TypeError(f"mid_dtype must be None or a float dtype, got {mid_dtype}")
    dh = f // num_heads
    if tables is not None and any(tuple(tb.shape) != (t, dh) for tb in tables):
        raise ValueError(f"rotary tables must be [{t}, {dh}]")
    if gamma is not None and tuple(gamma.shape) != (f,):
        raise ValueError(f"gamma must be [{f}], got {tuple(gamma.shape)}")
    operands = [x, *(tables or ()), *([gamma] if gamma is not None else [])]
    if _on_cpu(*operands):
        return blockify_island_plain(
            x, tables, gamma, grid, layout, num_heads, norm_eps, relu_eps, mid_dtype,
            out_dtype, emit_nope,
        )
    if x.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise TypeError(f"kernel takes float32, bf16 or fp16, got {x.dtype} -> {out_dtype}")
    if x.stride(-1) != 1:
        raise ValueError("kernel needs unit stride along the feature axis")
    if (dh // 2) & (dh // 2 - 1) or dh % 2:
        raise ValueError(f"kernel needs a power-of-two Dh/2, got Dh={dh}")
    f32 = lambda tb: tb.to(torch.float32).contiguous()  # noqa: E731
    cos, sin = (f32(tb) for tb in tables) if tables is not None else (x, x)
    g = f32(gamma) if gamma is not None else x
    out = torch.empty(b, n, c, f, dtype=out_dtype, device=x.device)
    nope = torch.empty_like(out) if emit_nope else None
    if b * t:
        kernel = _load_triton()[0]
        with torch.cuda.device(x.device):
            kernel[(triton.cdiv(b * t, _BLOCK_R),)](
                x, g, cos, sin, out, nope if emit_nope else out,
                b * t, t, c, x.stride(0), x.stride(1),
                layout[1], layout[2], pf, ph, pw, grid[1], grid[2],
                norm_eps, relu_eps if relu_eps is not None else 0.0,
                F=f, H=num_heads, DH=dh, HALF=dh // 2,
                USE_NORM=gamma is not None, RELU=relu_eps is not None,
                ROPE=tables is not None, EMIT_NOPE=emit_nope, MID=_MID_CODE[mid_dtype],
                BLOCK_R=_BLOCK_R, num_warps=4,
            )
        launches["blockify_island"] += 1
    return out, nope


# ---------------------------------------------------------------------------
# K6: dense state mixing
# ---------------------------------------------------------------------------


def mix_states_dense_plain(m: torch.Tensor, states4: torch.Tensor) -> torch.Tensor:
    """mixed[b, i] = sum_j m[i, j] states[b, j] for a dense [N, N] matrix,
    float32 accumulation, result in the states' dtype."""
    out = torch.einsum("ij,bjrd->bird", m.float(), states4.float())
    return out.to(states4.dtype).contiguous()


class _MixStatesDense(torch.autograd.Function):
    """K6 forward; backward as ``_mix_dense_bwd`` of the JAX module
    (``mhla_block_pallas.py:75``): ``dstates = M^T dmixed`` is K6 on the
    transposed matrix, ``dM`` an einsum, taken only where M wants a gradient."""

    @staticmethod
    def forward(ctx, m, states4):
        ctx.save_for_backward(m, states4)
        return _mix_states_dense(m, states4)

    @staticmethod
    def backward(ctx, dout):
        m, states4 = ctx.saved_tensors
        dout = dout.to(states4.dtype).contiguous()
        dm = None
        if ctx.needs_input_grad[0]:
            dm = torch.einsum("bird,bjrd->ij", dout.float(), states4.float()).to(m.dtype)
        dstates = _mix_states_dense(m.T.contiguous(), dout) if ctx.needs_input_grad[1] else None
        return dm, dstates


def mix_states_dense(m: torch.Tensor, states4: torch.Tensor) -> torch.Tensor:
    """K6 (see :func:`mix_states_dense_plain`), differentiable in both."""
    if _needs_grad(m, states4):
        return _MixStatesDense.apply(m, states4)
    return _mix_states_dense(m, states4)


def _mix_states_dense(m: torch.Tensor, states4: torch.Tensor) -> torch.Tensor:
    """K6 (see :func:`mix_states_dense_plain`): m [N, N] in any float dtype
    (its values are read as float32), states4 [B, N, H*Dk, Dv] float32 or
    bf16."""
    if _on_cpu(m, states4):
        return mix_states_dense_plain(m, states4)
    if states4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32 or bf16 states, got {states4.dtype}")
    _check("states4", states4, states4.dtype, 4)
    b, n, hdk, dv = states4.shape
    if tuple(m.shape) != (n, n):
        raise ValueError(f"m {tuple(m.shape)} does not match N={n}")
    r = hdk * dv
    if n > _MAX_BLOCKS:
        raise ValueError(f"kernel mixes at most {_MAX_BLOCKS} blocks, got N={n}")
    if r % _MIX_COLS:
        raise ValueError(f"kernel needs a state size divisible by {_MIX_COLS}, got {r}")
    if states4.data_ptr() % 16:
        raise ValueError("kernel loads the states by TMA: they must be 16-byte aligned")
    m32 = m.to(torch.float32).contiguous()
    out = torch.empty_like(states4)
    if b:
        with torch.cuda.device(states4.device):
            err = _lib().mhla_mix_states_dense(
                m32.data_ptr(), states4.data_ptr(), out.data_ptr(), b, n, r,
                int(states4.dtype == torch.bfloat16), _stream(states4),
            )
        _raise_on_error("mix_states_dense", err)
        launches["mix_states_dense"] += 1
    return out


# ---------------------------------------------------------------------------
# K7: block readout
# ---------------------------------------------------------------------------


def block_readout_plain(q4: torch.Tensor, mixed4: torch.Tensor, num_heads: int) -> torch.Tensor:
    """o[b, i, :, h] = q[b, i, :, h] @ mixed[b, i, h]: q4 [B, N, C, H*Dk],
    mixed4 [B, N, H*Dk, Dv] -> [B, N, C, H*Dv] in q's dtype, float32
    accumulation."""
    b, n, c, hdk = q4.shape
    h = num_heads
    dk, dv = hdk // h, mixed4.shape[-1]
    o = torch.einsum(
        "bnchk,bnhkv->bnchv",
        q4.reshape(b, n, c, h, dk).float(),
        mixed4.reshape(b, n, h, dk, dv).float(),
    )
    return o.to(q4.dtype).reshape(b, n, c, h * dv).contiguous()


def block_readout_bwd_plain(
    q4: torch.Tensor, mixed4: torch.Tensor, do4: torch.Tensor, num_heads: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`block_readout_plain` for ``do4``
    [B, N, C, H*Dv]: ``dq[b, i, :, h] = do[b, i, :, h] @ mixed[b, i, h]^T`` and
    ``dmixed[b, i, h] = q[b, i, :, h]^T @ do[b, i, :, h]``, float32
    accumulation, in the dtypes of q4 and mixed4."""
    b, n, c, hdk = q4.shape
    h = num_heads
    dk, dv = hdk // h, mixed4.shape[-1]
    q5 = q4.reshape(b, n, c, h, dk).float()
    m5 = mixed4.reshape(b, n, h, dk, dv).float()
    do5 = do4.reshape(b, n, c, h, dv).float()
    dq = torch.einsum("bnchv,bnhkv->bnchk", do5, m5)
    dmixed = torch.einsum("bnchk,bnchv->bnhkv", q5, do5)
    return (dq.to(q4.dtype).reshape(b, n, c, hdk).contiguous(),
            dmixed.to(mixed4.dtype).reshape(b, n, hdk, dv).contiguous())


def block_readout_bwd(
    q4: torch.Tensor, mixed4: torch.Tensor, do4: torch.Tensor, num_heads: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7b (see :func:`block_readout_bwd_plain`), float32 or bf16, Dv = 128
    and Dk a multiple of 128."""
    if _on_cpu(q4, mixed4, do4):
        return block_readout_bwd_plain(q4, mixed4, do4, num_heads)
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32 or bf16, got {q4.dtype}")
    for name, x in (("q4", q4), ("mixed4", mixed4), ("do4", do4)):
        _check(name, x, q4.dtype, 4)
    b, n, c, hdk = q4.shape
    if hdk % num_heads:
        raise ValueError(f"head-flat width {hdk} not divisible by {num_heads} heads")
    dk, dv = hdk // num_heads, mixed4.shape[-1]
    if tuple(mixed4.shape) != (b, n, hdk, dv) or tuple(do4.shape) != (b, n, c, num_heads * dv):
        raise ValueError(f"q4 {tuple(q4.shape)}, mixed4 {tuple(mixed4.shape)} and do4 "
                         f"{tuple(do4.shape)} disagree")
    if dk % _READ_KT or dv != _READ_DV:
        raise ValueError(f"kernel needs Dk % {_READ_KT} == 0 and Dv == {_READ_DV}, "
                         f"got Dk={dk}, Dv={dv}")
    if any(x.data_ptr() % 16 for x in (q4, mixed4, do4)):
        raise ValueError("kernel loads q and dO by TMA and mixed 16 bytes at a time: "
                         "they must be 16-byte aligned")
    dq, dmixed = torch.empty_like(q4), torch.empty_like(mixed4)
    if b * n * c:
        with torch.cuda.device(q4.device):
            err = _lib().mhla_block_readout_bwd(
                q4.data_ptr(), mixed4.data_ptr(), do4.data_ptr(), dq.data_ptr(),
                dmixed.data_ptr(), b * n, c, num_heads, dk, dv,
                int(q4.dtype == torch.bfloat16), _stream(q4),
            )
        _raise_on_error("block_readout_bwd", err)
        launches["block_readout_bwd"] += 1
    else:
        dmixed.zero_()
    return dq, dmixed


class _BlockReadout(torch.autograd.Function):
    """K7 forward, K7b backward (``_readout`` of the JAX module,
    ``mhla_block_pallas.py:160-225``)."""

    @staticmethod
    def forward(ctx, q4, mixed4, num_heads):
        ctx.save_for_backward(q4, mixed4)
        ctx.num_heads = num_heads
        return _block_readout(q4, mixed4, num_heads)

    @staticmethod
    def backward(ctx, do4):
        q4, mixed4 = ctx.saved_tensors
        dq, dmixed = block_readout_bwd(q4, mixed4, do4.to(q4.dtype).contiguous(), ctx.num_heads)
        return dq, dmixed, None


def block_readout(q4: torch.Tensor, mixed4: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K7 (see :func:`block_readout_plain`), differentiable through K7b."""
    if _needs_grad(q4, mixed4):
        return _BlockReadout.apply(q4, mixed4, num_heads)
    return _block_readout(q4, mixed4, num_heads)


def _block_readout(q4: torch.Tensor, mixed4: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K7 (see :func:`block_readout_plain`), float32 or bf16."""
    if _on_cpu(q4, mixed4):
        return block_readout_plain(q4, mixed4, num_heads)
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes float32 or bf16, got {q4.dtype}")
    _check("q4", q4, q4.dtype, 4)
    _check("mixed4", mixed4, q4.dtype, 4)
    b, n, c, hdk = q4.shape
    if hdk % num_heads:
        raise ValueError(f"head-flat width {hdk} not divisible by {num_heads} heads")
    dk, dv = hdk // num_heads, mixed4.shape[-1]
    if tuple(mixed4.shape) != (b, n, hdk, dv):
        raise ValueError(f"mixed4 {tuple(mixed4.shape)} does not match q4 {tuple(q4.shape)}")
    if dk not in _READ_DK or dv % _READ_DV:
        raise ValueError(
            f"kernel needs Dk in {_READ_DK} and Dv % {_READ_DV} == 0, got Dk={dk}, Dv={dv}"
        )
    if any(x.data_ptr() % 16 for x in (q4, mixed4)):
        raise ValueError("kernel loads q by TMA and mixed 16 bytes at a time: "
                         "they must be 16-byte aligned")
    out = torch.empty(b, n, c, num_heads * dv, dtype=q4.dtype, device=q4.device)
    if b * n * c:
        with torch.cuda.device(q4.device):
            err = _lib().mhla_block_readout(
                q4.data_ptr(), mixed4.data_ptr(), out.data_ptr(), b * n, c, num_heads,
                dk, dv, int(q4.dtype == torch.bfloat16), _stream(q4),
            )
        _raise_on_error("block_readout", err)
        launches["block_readout"] += 1
    return out


# ---------------------------------------------------------------------------
# K8: island epilogue
# ---------------------------------------------------------------------------


def unblockify_island_plain(
    xb: torch.Tensor,
    gamma_head: torch.Tensor,
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    norm_eps: float = 1e-6,
    mid_dtype: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The function of :func:`unblockify_island` in plain PyTorch."""
    b, n, c, f = xb.shape
    dh = f // num_heads
    x = _round_mid(xb.float(), mid_dtype).reshape(b, n * c, num_heads, dh)
    inv = torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) / dh + norm_eps)
    y = (x * inv * gamma_head.float()).reshape(b, n * c, f).to(out_dtype)
    out = torch.empty_like(y)
    out[:, block_token_index(grid, layout, xb.device)] = y
    return out


class _UnblockifyIsland(torch.autograd.Function):
    """K8 forward; backward as ``_unblockify_island_bwd`` of the JAX module
    (``mhla_block_pallas.py:752``): K8b brings the gradient into the blocked
    layout, then the per-head RMSNorm terms in plain PyTorch there."""

    @staticmethod
    def forward(ctx, xb, gamma_head, args):
        ctx.save_for_backward(xb, gamma_head)
        ctx.args = args
        return _unblockify_island(xb, gamma_head, *args)

    @staticmethod
    def backward(ctx, dy):
        xb, gamma_head = ctx.saved_tensors
        grid, layout, num_heads, norm_eps, mid_dtype = ctx.args[:5]
        dyb = blockify(dy.contiguous(), None, grid, layout, num_heads, out_dtype=torch.float32)
        d5 = dyb.unflatten(-1, (num_heads, -1))
        x5 = _round_mid(xb.float(), mid_dtype).unflatten(-1, (num_heads, -1))
        inv = torch.rsqrt(torch.mean(x5 * x5, dim=-1, keepdim=True) + norm_eps)
        dgamma = None
        if ctx.needs_input_grad[1]:
            dgamma = (d5 * x5 * inv).sum(dim=(0, 1, 2, 3)).to(gamma_head.dtype)
        u = d5 * gamma_head.float()
        dot = torch.mean(u * x5, dim=-1, keepdim=True)
        dxb = inv * u - x5 * inv**3 * dot
        return dxb.flatten(-2).to(xb.dtype), dgamma, None


def unblockify_island(
    xb: torch.Tensor,
    gamma_head: torch.Tensor,
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    norm_eps: float = 1e-6,
    mid_dtype: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K8 (see :func:`_unblockify_island`), differentiable in ``xb`` and
    ``gamma_head`` through K8b."""
    args = (tuple(grid), tuple(layout), num_heads, norm_eps, mid_dtype, out_dtype)
    if _needs_grad(xb, gamma_head):
        return _UnblockifyIsland.apply(xb, gamma_head, args)
    return _unblockify_island(xb, gamma_head, *args)


def _unblockify_island(
    xb: torch.Tensor,
    gamma_head: torch.Tensor,
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    norm_eps: float = 1e-6,
    mid_dtype: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K8, the fused island epilogue: blocked xb [B, N, C, F] -> flat
    [B, T, F] in ``out_dtype`` with the per-head RMSNorm (``gamma_head``
    [Dh], float32 statistics) applied on the way. ``mid_dtype`` rounds the
    input BEFORE the norm, as the composed path does when the island is
    wider than the model dtype (unblockify -> cast -> norm)."""
    b, n, c, f = xb.shape
    _, _, _, c_geo, n_geo = _block_geometry(grid, layout)
    if (n, c) != (n_geo, c_geo):
        raise ValueError(f"blocked shape {(n, c)} does not match grid {tuple(grid)} "
                         f"in layout {tuple(layout)}")
    if f % num_heads:
        raise ValueError(f"width {f} not divisible by {num_heads} heads")
    if mid_dtype not in _MID_CODE:
        raise TypeError(f"mid_dtype must be None or a float dtype, got {mid_dtype}")
    dh = f // num_heads
    if tuple(gamma_head.shape) != (dh,):
        raise ValueError(f"gamma_head must be [{dh}], got {tuple(gamma_head.shape)}")
    if _on_cpu(xb, gamma_head):
        return unblockify_island_plain(
            xb, gamma_head, grid, layout, num_heads, norm_eps, mid_dtype, out_dtype
        )
    if xb.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise TypeError(f"kernel takes float32, bf16 or fp16, got {xb.dtype} -> {out_dtype}")
    if not xb.is_contiguous():
        raise ValueError("xb: kernel takes contiguous tensors")
    if dh & (dh - 1):
        raise ValueError(f"kernel needs a power-of-two head dim, got {dh}")
    pf, ph, pw = _block_geometry(grid, layout)[:3]
    out = torch.empty(b, n * c, f, dtype=out_dtype, device=xb.device)
    if b * n * c:
        kernel = _load_triton()[1]
        with torch.cuda.device(xb.device):
            kernel[(triton.cdiv(b * n * c, _BLOCK_R), num_heads)](
                xb, gamma_head.to(torch.float32).contiguous(), out,
                b * n * c, n * c, c, n * c,
                layout[1], layout[2], pf, ph, pw, grid[1], grid[2], norm_eps,
                F=f, DH=dh, MID=_MID_CODE[mid_dtype], BLOCK_R=_BLOCK_R, num_warps=4,
            )
        launches["unblockify_island"] += 1
    return out


# ---------------------------------------------------------------------------
# K8b, K5b: the block permutation with optional RoPE, both directions
# ---------------------------------------------------------------------------


def blockify_plain(
    x: torch.Tensor,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]],
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    sin_sign: float = 1.0,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The function of :func:`blockify` in plain PyTorch."""
    b, t, f = x.shape
    _, _, _, c, n = _block_geometry(grid, layout)
    y = x.float()
    if tables is not None:
        y = _rope_flat_plain(y, tables, num_heads, sin_sign)
    idx = block_token_index(grid, layout, x.device)
    return y[:, idx].reshape(b, n, c, f).to(out_dtype or x.dtype)


def unblockify_plain(
    xb: torch.Tensor,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]],
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    sin_sign: float = 1.0,
    out_dtype: Optional[torch.dtype] = None,
    add: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The function of :func:`unblockify` in plain PyTorch."""
    b, n, c, f = xb.shape
    idx = block_token_index(grid, layout, xb.device)
    y = torch.empty(b, n * c, f, dtype=torch.float32, device=xb.device)
    y[:, idx] = xb.float().reshape(b, n * c, f)
    if tables is not None:
        y = _rope_flat_plain(y, tables, num_heads, sin_sign)
    if add is not None:
        y[:, idx] += add.float().reshape(b, n * c, f)
    return y.to(out_dtype or xb.dtype)


_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # csrc: kF32, kBF16, kF16
# operands a K5b / K8b launch moves by bulk copies, whether a run's flat
# rows are contiguous, the operands whose rows are 16-byte aligned, and a
# pure copy stored from the input stage (csrc/mhla_permute.cu: kBulkX .. kPass)
_BULK_X, _BULK_ADD, _BULK_TABLES, _BULK_OUT, _FLAT_RUNS = 1, 2, 4, 8, 16
_ALIGN = 64  # _BULK_* * _ALIGN: that operand's rows are 16-byte aligned
_PASS = 1024
_PERMUTE_SMEM = 232448  # shared memory a block may take (csrc: kSmemLimit)
_PERMUTE_SMEM_HALF = 115712  # two blocks an SM: 228 KB, 1 KB of it reserved a block
# bytes an input stage aims at: small tiles where the consumer threads
# rotate, convert or add (a tile's items then finish soon after it lands),
# large ones for a pure copy (fewer, longer bulk copies); both chosen by
# timing every form at Wan2.1-1.3B's width on the card (PERF.md, section 6)
_PERMUTE_STAGE, _PERMUTE_PASS_STAGE = 8 * 1024, 32 * 1024
_PERMUTE_MAX_ROWS = 16  # token rows a tile at most
_PERMUTE_MAX_STAGES = 8  # input stages at most (csrc: kMaxInStages)
_PERMUTE_OUT_STAGES = 3  # csrc: kOutStages
_PERMUTE_BARRIERS = (2 * 8 + 2 * _PERMUTE_OUT_STAGES) * 8  # csrc: kBarrierBytes


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _permute_flags(x, add, tables, out, inverse: bool) -> int:
    """Which operands of a K5b / K8b launch a bulk copy can move (address,
    row size and, on K8b's flat side, strides 16-byte aligned; each such
    operand's ``_BULK_*`` and ``_BULK_* * _ALIGN``), ``_FLAT_RUNS`` where a
    run's flat rows are contiguous, and ``_PASS`` where the launch is a pure
    copy (no tables, no add, x's dtype out) that both sides' bulk copies
    carry without the consumer threads."""
    al = lambda v: v % 16 == 0  # noqa: E731
    f, xs = x.shape[-1], x.element_size()
    flags = 0
    if al(x.data_ptr()) and al(f * xs) and (inverse or (al(x.stride(0) * xs)
                                                        and al(x.stride(1) * xs))):
        flags |= _BULK_X
    if add is not None and al(add.data_ptr()) and al(f * add.element_size()):
        flags |= _BULK_ADD
    if (tables is not None and all(al(tb.data_ptr()) for tb in tables)
            and al(tables[0].shape[1] * 4)):
        flags |= _BULK_TABLES
    if al(out.data_ptr()) and al(f * out.element_size()):
        flags |= _BULK_OUT
    flags |= (flags & (_BULK_X | _BULK_ADD | _BULK_TABLES | _BULK_OUT)) * _ALIGN
    if inverse or x.stride(1) == f:
        flags |= _FLAT_RUNS
    if (tables is None and add is None and x.dtype == out.dtype
            and flags & _BULK_X and flags & _BULK_OUT):
        flags |= _PASS
    return flags


def _permute_smem(rows: int, stages: int, f: int, dh: int, sizes, flags: int) -> int:
    """Shared memory of a K5b / K8b block: ``stages`` input stages of
    ``rows`` token rows (x's, add's, cos's and sin's parts, each 128-byte
    aligned), the output stages (none for a pure copy) and the barriers
    (csrc/mhla_permute.cu ``mhla_permute``). ``sizes``: element bytes of x,
    add and out."""
    xs, adds, outs = sizes
    parts = ((_BULK_X, f * xs), (_BULK_ADD, f * adds), (_BULK_TABLES, dh * 4),
             (_BULK_TABLES, dh * 4))
    inp = sum(_round128(rows * r) for flag, r in parts if flags & flag)
    out = _round128(rows * f * outs) if flags & _BULK_OUT and not flags & _PASS else 0
    return stages * inp + _PERMUTE_OUT_STAGES * out + _PERMUTE_BARRIERS + 128


@functools.lru_cache(maxsize=64)
def _permute_plan(f: int, dh: int, sizes: Tuple[int, int, int], flags: int) -> Tuple[int, int, int]:
    """(token rows a tile, input stages, flags) of a K5b / K8b launch: an
    input stage of about ``_PERMUTE_STAGE`` bytes (``_PERMUTE_PASS_STAGE``
    for a pure copy) and as many input stages as fit beside the output
    stages (at most ``_PERMUTE_MAX_STAGES``) in half an SM's shared memory,
    so two blocks share an SM, else in a block's most.
    Where one row a stage does not fit even that, the output, then x, add and
    the tables move by the threads' own loads and stores instead, until it
    does."""
    xs, adds, outs = sizes
    for drop in (0, _BULK_OUT | _PASS, _BULK_X | _PASS, _BULK_ADD, _BULK_TABLES):
        flags &= ~drop
        in_row = sum(r for flag, r in ((_BULK_X, f * xs), (_BULK_ADD, f * adds),
                                       (_BULK_TABLES, 2 * dh * 4)) if flags & flag)
        target = _PERMUTE_PASS_STAGE if flags & _PASS else _PERMUTE_STAGE
        rows = max(1, min(_PERMUTE_MAX_ROWS, target // max(in_row, 1)))
        fixed = _permute_smem(rows, 0, f, dh, sizes, flags)
        stage = _permute_smem(rows, 1, f, dh, sizes, flags) - fixed
        for budget in (_PERMUTE_SMEM_HALF, _PERMUTE_SMEM):
            if fixed + stage <= budget:
                stages = min(_PERMUTE_MAX_STAGES, (budget - fixed) // stage) if stage else 1
                return rows, stages, flags
    raise AssertionError("unreachable: with no operand in the stages a block needs 256 bytes")


def permute_walk(grid: Sequence[int], layout: Sequence[int], batch: int, rows: int,
                 flat_runs: bool = True):
    """The copies K5b / K8b's kernel makes, tile by tile, in its arithmetic
    (``walk_tile`` of ``csrc/mhla_permute.cu``): for each tile of ``rows``
    consecutive blocked rows, a list of (stage row, blocked row, batch row,
    flat token, rows) spans, each contiguous on both sides: the rest of a
    run of pw tokens along W within the tile, or one row where the flat
    side's rows are not contiguous (``flat_runs`` False)."""
    (_, hg, wg), (_, nh, nw) = grid, layout
    pf, ph, pw, c, n = _block_geometry(grid, layout)
    t = n * c
    for g0 in range(0, batch * t, rows):
        count = min(rows, batch * t - g0)
        copies, r = [], 0
        while r < count:
            b, rem = divmod(g0 + r, t)
            blk, pos = divmod(rem, c)
            fb, hb, wb = blk // (nh * nw), blk % (nh * nw) // nw, blk % nw
            p1, p2, p3 = pos // (ph * pw), pos // pw % ph, pos % pw
            tok = ((fb * pf + p1) * hg + hb * ph + p2) * wg + wb * pw + p3
            span = min(pw - p3, count - r) if flat_runs else 1
            copies.append((r, g0 + r, b, tok, span))
            r += span
        yield copies


def _permute(x, tables, grid, layout, num_heads, sin_sign, out_dtype, add, inverse: bool):
    """K8b (``inverse`` False: flat x [B, T, F] -> blocked) and K5b (True:
    blocked x [B, N, C, F] -> flat, plus ``add`` where given)."""
    pf, ph, pw, c, n = _block_geometry(grid, layout)
    b, f = x.shape[0], x.shape[-1]
    t = n * c
    if tuple(x.shape) != ((b, n, c, f) if inverse else (b, t, f)):
        raise ValueError(f"shape {tuple(x.shape)} does not match grid {tuple(grid)} in layout "
                         f"{tuple(layout)}")
    if f % num_heads:
        raise ValueError(f"width {f} not divisible by {num_heads} heads")
    dh = f // num_heads
    if tables is not None and any(tuple(tb.shape) != (t, dh) for tb in tables):
        raise ValueError(f"rotary tables must be [{t}, {dh}]")
    if add is not None and (not inverse or add.shape != x.shape):
        raise ValueError("add: a second blocked tensor of x's shape, for unblockify only")
    out_dtype = out_dtype or x.dtype
    if _on_cpu(x, *(tables or ()), *([add] if add is not None else [])):
        if inverse:
            return unblockify_plain(x, tables, grid, layout, num_heads, sin_sign, out_dtype, add)
        return blockify_plain(x, tables, grid, layout, num_heads, sin_sign, out_dtype)
    if any(d not in _FLOATS for d in (x.dtype, out_dtype, *([add.dtype] if add is not None else []))):
        raise TypeError(f"kernel takes float32, bf16 or fp16, got {x.dtype} -> {out_dtype}")
    if (dh // 2) & (dh // 2 - 1) or dh % 2:
        raise ValueError(f"kernel needs a power-of-two Dh/2, got Dh={dh}")
    if (inverse and not x.is_contiguous()) or x.stride(-1) != 1:
        raise ValueError("kernel needs a contiguous blocked tensor and unit stride along the "
                         "feature axis of a flat one")
    if add is not None and not add.is_contiguous():
        raise ValueError("add: kernel takes contiguous tensors")
    f32 = lambda tb: tb.to(torch.float32).contiguous()  # noqa: E731
    cos, sin = (f32(tb) for tb in tables) if tables is not None else (None, None)
    out = torch.empty((b, t, f) if inverse else (b, n, c, f), dtype=out_dtype, device=x.device)
    if b * t:
        sizes = (x.element_size(), add.element_size() if add is not None else 0, out.element_size())
        flags = _permute_flags(x, add, None if cos is None else (cos, sin), out, inverse)
        rows, stages, flags = _permute_plan(f, dh, sizes, flags)
        stride_b, stride_t = (t * f, f) if inverse else (x.stride(0), x.stride(1))
        ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
        # x's device current around the call, as torch.cuda.device makes it in
        # more steps (the host's cost a call shows beside a 0.14 ms kernel)
        prev = torch.cuda._exchange_device(x.device.index)
        try:
            err = _lib().mhla_permute(
                x.data_ptr(), ptr(add), ptr(cos), ptr(sin), out.data_ptr(), b, t, c, f, dh,
                stride_b, stride_t, layout[1], layout[2], pf, ph, pw, grid[1], grid[2],
                float(sin_sign), _CODE[x.dtype], _CODE[add.dtype] if add is not None else 0,
                _CODE[out_dtype], int(inverse), flags, rows, stages, _stream(x),
            )
        finally:
            torch.cuda._maybe_exchange_device(prev)
        name = "unblockify" if inverse else "blockify"
        _raise_on_error(name, err)
        launches[name] += 1
    return out


class _Permute(torch.autograd.Function):
    """K8b and K5b are linear and each other's transpose under a negated
    sine (``_blockify_bwd`` and ``_unblockify_bwd`` of the JAX module)."""

    @staticmethod
    def forward(ctx, x, add, tables, args, inverse):
        ctx.tables, ctx.args, ctx.inverse = tables, args, inverse
        ctx.dtypes = (x.dtype, None if add is None else add.dtype)
        return _permute(x, tables, *args, add, inverse)

    @staticmethod
    def backward(ctx, dout):
        grid, layout, num_heads, sin_sign, _ = ctx.args
        dx = _permute(dout, ctx.tables, grid, layout, num_heads, -sin_sign, ctx.dtypes[0], None,
                      not ctx.inverse)
        dadd = None
        if ctx.dtypes[1] is not None and ctx.needs_input_grad[1]:
            dadd = _permute(dout, None, grid, layout, num_heads, 1.0, ctx.dtypes[1], None, False)
        return dx, dadd, None, None, None


def blockify(
    x: torch.Tensor,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]],
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    sin_sign: float = 1.0,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K8b: flat x [B, T, F] -> blocked [B, N, C, F] in ``out_dtype`` (x's
    when None) under the 3-D block permutation, with rotate-half RoPE in flat
    token order where ``tables`` = (cos, sin_signed) [T, Dh] is given
    (``sin_sign`` -1 rotates backwards: the transpose). Differentiable in x."""
    args = (tuple(grid), tuple(layout), num_heads, sin_sign, out_dtype)
    if _needs_grad(x):
        return _Permute.apply(x, None, tables, args, False)
    return _permute(x, tables, *args, None, False)


def unblockify(
    xb: torch.Tensor,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]],
    grid: Sequence[int],
    layout: Sequence[int],
    num_heads: int,
    sin_sign: float = 1.0,
    out_dtype: Optional[torch.dtype] = None,
    add: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5b: blocked xb [B, N, C, F] -> flat [B, T, F] in ``out_dtype``, the
    inverse permutation with the same optional RoPE, applied in flat token
    order. ``add``, a second blocked tensor, is summed in without RoPE (the
    gradient of K5's pre-RoPE copy). Differentiable in xb and add."""
    args = (tuple(grid), tuple(layout), num_heads, sin_sign, out_dtype)
    if _needs_grad(xb, add):
        return _Permute.apply(xb, add, tables, args, True)
    return _permute(xb, tables, *args, add, True)


def rms_norm_heads_flat(
    x: torch.Tensor, scale: torch.Tensor, num_heads: int, eps: float = 1e-6
) -> torch.Tensor:
    """Per-head RMSNorm on head-flat x [B, T, H*Dh] with one ``scale`` [Dh]
    for all heads, float32 statistics, in x's dtype (plain PyTorch: K8 fuses
    it on the island's path)."""
    xf = x.float().unflatten(-1, (num_heads, -1))
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * scale.float()).flatten(-2).to(x.dtype)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------


def mhla_blockwise_fused(
    q4: torch.Tensor,
    k4: torch.Tensor,
    v4: torch.Tensor,
    mixing_matrix: torch.Tensor,
    num_heads: int,
    q_nope4: Optional[torch.Tensor] = None,
    k_nope4: Optional[torch.Tensor] = None,
    normalize: bool = True,
    eps: float = 1e-6,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Blockwise non-causal MHLA on head-flat blocked q4, k4 [B, N, C, H*Dk],
    v4 [B, N, C, H*Dv] with the dense [N, N] ``mixing_matrix``; same function
    as :func:`mhla_tpu_torch.ops.mhla_blockwise.mhla_blockwise_mh` up to the
    layout. Returns [B, N, C, H*Dv] in q4's dtype.

    The per-block states are an einsum (see the module docstring), K6 mixes
    them and K7 reads them out, all in ``compute_dtype`` (default float32)
    with float32 accumulation. The mixed normalizer stays in plain PyTorch
    as an elementwise product and a reduction over each head's columns.
    Head dims that are not multiples of 128 take ``mhla_blockwise_mh``, as
    the JAX op does."""
    b, n, c, hdk = q4.shape
    h = num_heads
    dk, dv = hdk // h, v4.shape[-1] // h
    in_dtype = q4.dtype
    cdt = compute_dtype or torch.float32

    if dk % 128 or dv % 128:
        out5 = mhla_blockwise_mh(
            q4.reshape(b, n, c, h, dk), k4.reshape(b, n, c, h, dk),
            v4.reshape(b, n, c, h, dv), mixing_matrix,
            q_nope=None if q_nope4 is None else q_nope4.reshape(b, n, c, h, dk),
            k_nope=None if k_nope4 is None else k_nope4.reshape(b, n, c, h, dk),
            normalize=normalize, eps=eps, compute_dtype=compute_dtype,
        )
        return out5.reshape(b, n, c, h * dv)

    q4, k4, v4 = q4.to(cdt), k4.to(cdt), v4.to(cdt)
    m = mixing_matrix.to(cdt)

    kv = torch.einsum(
        "bnchk,bnchv->bnhkv", k4.reshape(b, n, c, h, dk), v4.reshape(b, n, c, h, dv)
    ).reshape(b, n, hdk, dv)
    mixed = mix_states_dense(m, kv.contiguous())
    out = block_readout(q4.contiguous(), mixed, h)

    if normalize:
        qn = q4 if q_nope4 is None else q_nope4.to(cdt)
        kn = k4 if k_nope4 is None else k_nope4.to(cdt)
        ksum = kn.float().sum(dim=2)  # [B, N, H*Dk]
        sz = (qn.float() * ksum[:, :, None, :]).reshape(b, n, c, h, dk).sum(dim=-1)
        z = torch.einsum("ij,bjch->bich", mixing_matrix.float(), sz) + eps
        out = (out.reshape(b, n, c, h, dv).float() / z[..., None]).reshape(b, n, c, h * dv)
    return out.to(in_dtype)
