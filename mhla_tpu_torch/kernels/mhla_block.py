"""Non-causal blockwise MHLA (video) on head-flat tensors through four
hand-written kernels (counterpart of the forward of
``mhla_tpu/kernels/mhla_block_pallas.py``):

  K5 ``blockify_island``    flat [B, T, F] -> blocked [B, N, C, F] with the
                            island prologue fused in: full-dim RMSNorm,
                            ``relu + eps``, 3-D rotate-half RoPE, the 3-D
                            block permutation (Triton)
  K6 ``mix_states_dense``   mixed_i = sum_j M[i, j] S_j, dense [N, N]
                            (CUDA C++, ``csrc/mhla_block.cu``)
  K7 ``block_readout``      o_i = q_i @ mixed_i per block and head (CUDA C++)
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
from typing import Optional, Sequence, Tuple

import torch

from ..ops.mhla_blockwise import mhla_blockwise_mh
from . import _build
from .mhla_chunk import _check, _on_cpu, _raise_on_error, _stream

launches = {
    "blockify_island": 0, "mix_states_dense": 0, "block_readout": 0,
    "unblockify_island": 0,
}

_BLOCK_R = 4  # token rows per program of K5 and K8
_MAX_BLOCKS = 7 * 32  # K6 keeps ceil(N / 32) <= 7 rows per thread (csrc: kMaxMixRows)
_MIX_COLS = 32  # state columns per tile of K6 (csrc: kMixCols)
_READ_COLS = 128  # Dv columns per block of K7 (csrc: kReadCols)
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
        lib.mhla_mix_states_dense.restype = ctypes.c_int
        lib.mhla_block_readout.restype = ctypes.c_int
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
    h = num_heads
    dh = f // h
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
        cos, sin = (tb.float()[None, :, None, :] for tb in tables)  # [1, T, 1, Dh]
        x4 = sub.reshape(b, t, h, dh)
        swapped = torch.cat([x4[..., dh // 2:], x4[..., : dh // 2]], dim=-1)
        sub = (x4 * cos + swapped * sin).reshape(b, t, f)
    return blocked(sub), nope


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


def mix_states_dense(m: torch.Tensor, states4: torch.Tensor) -> torch.Tensor:
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
    smem = ((n * n + 3) // 4 * 4 + n * _MIX_COLS) * 4
    if n > _MAX_BLOCKS or smem > 227 * 1024:
        raise ValueError(f"kernel mixes at most {_MAX_BLOCKS} blocks within 227 KB of shared "
                         f"memory, got N={n} ({smem} bytes)")
    if r % _MIX_COLS:
        raise ValueError(f"kernel needs a state size divisible by {_MIX_COLS}, got {r}")
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


def block_readout(q4: torch.Tensor, mixed4: torch.Tensor, num_heads: int) -> torch.Tensor:
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
    if dk % 4 or dk > 256 or dv % _READ_COLS:
        raise ValueError(
            f"kernel needs Dk % 4 == 0, Dk <= 256 and Dv % {_READ_COLS} == 0, "
            f"got Dk={dk}, Dv={dv}"
        )
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
