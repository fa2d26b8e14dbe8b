"""Fused feature map + rotate-half rotary on head-flat [B, T, H*D] rows and
its gradient (counterpart of ``mhla_tpu/kernels/fmap_rope_pallas.py``).

K1 ``fused_fmap_rope_flat`` computes ``rope(fmap(x))`` in float32 and
stores x's dtype. It replaces ``_fwd_kernel``
(``mhla_tpu/kernels/fmap_rope_pallas.py:66``), written here in Triton.
K1b ``fmap_rope_bwd`` computes ``dx = fmap'(x) * rope_{-sin}(dy)`` (the
rotation's transpose is the rotation by negated sin) and replaces
``_bwd_kernel`` (``fmap_rope_pallas.py:72``), also in Triton. An
``autograd.Function`` joins them as the JAX ``_fused`` custom VJP does
(``fmap_rope_pallas.py:127-149``): it saves x before the feature map and
recomputes the map's derivative from it.

- Bound: bytes. Each output element depends only on its rotate-half
  partner in the same head segment: 6 FLOP per element against 4 bytes
  moved in bf16 (K1b: 6 bytes, it also reads x), with no reuse that shared
  memory could exploit.
- Design: one program per 16 rows x one head loads the two halves of the
  head segment as two [16, Dh/2] blocks, with the matching rows of the
  [max_len, Dh/2] cos/sin tables at ``offset + t``, and writes both halves
  back. The tables are indexed in the kernel, so no [T, Dh] signed copy is
  built per call, and the decode step (T = 1) launches the same kernel
  (the JAX package falls back to jnp there). Both kernels read strided
  rows (the q/k column slices of the fused projection) without a copy.

Triton is imported, and the kernels compiled, at the first launch on a CUDA
tensor; a CPU tensor takes :func:`fmap_rope_plain` and
:func:`fmap_rope_bwd_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.rotary import apply_rotary_flat
from . import _build

launches = {"fmap_rope": 0, "fmap_rope_bwd": 0}

_FMAPS = (None, "relu", "elu", "identity", "t2r")
_FMAP_CODE = {None: 0, "identity": 0, "relu": 1, "t2r": 1, "elu": 2}
_BLOCK_R = 16

# bound by _load_triton() at the first launch on a CUDA tensor; the kernels
# below are plain Python until then (their annotations stay unevaluated strings)
triton = tl = None
_kernels = None


def _fmap_rope_fwd(
    x_ptr, cos_ptr, sin_ptr, o_ptr,
    n_rows, seq_len, offset, stride_b, stride_t,
    ROW: tl.constexpr, DH: tl.constexpr, HALF: tl.constexpr,
    FMAP: tl.constexpr, BLOCK_R: tl.constexpr,
):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    head = tl.program_id(1)
    cols = tl.arange(0, HALF)
    mask = (rows[:, None] < n_rows) & (cols[None, :] < HALF)
    t = rows % seq_len
    rows64 = rows.to(tl.int64)
    src = (rows64 // seq_len) * stride_b + t.to(tl.int64) * stride_t
    x_off = src[:, None] + head * DH + cols[None, :]
    o_off = rows64[:, None] * ROW + head * DH + cols[None, :]
    t_off = (t + offset)[:, None] * HALF + cols[None, :]
    x1 = tl.load(x_ptr + x_off, mask=mask, other=0.0).to(tl.float32)
    x2 = tl.load(x_ptr + x_off + HALF, mask=mask, other=0.0).to(tl.float32)
    if FMAP == 1:  # relu
        x1 = tl.maximum(x1, 0.0)
        x2 = tl.maximum(x2, 0.0)
    elif FMAP == 2:  # elu + 1
        x1 = tl.where(x1 > 0, x1 + 1.0, tl.exp(x1))
        x2 = tl.where(x2 > 0, x2 + 1.0, tl.exp(x2))
    cos = tl.load(cos_ptr + t_off, mask=mask, other=0.0)
    sin = tl.load(sin_ptr + t_off, mask=mask, other=0.0)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    tl.store(o_ptr + o_off, y1.to(o_ptr.dtype.element_ty), mask=mask)
    tl.store(o_ptr + o_off + HALF, y2.to(o_ptr.dtype.element_ty), mask=mask)


def _fmap_rope_bwd(
    dy_ptr, x_ptr, cos_ptr, sin_ptr, dx_ptr,
    n_rows, seq_len, offset, dy_stride_b, dy_stride_t, x_stride_b, x_stride_t,
    ROW: tl.constexpr, DH: tl.constexpr, HALF: tl.constexpr,
    FMAP: tl.constexpr, BLOCK_R: tl.constexpr,
):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    head = tl.program_id(1)
    cols = tl.arange(0, HALF)
    mask = (rows[:, None] < n_rows) & (cols[None, :] < HALF)
    t = rows % seq_len
    rows64 = rows.to(tl.int64)
    bidx, t64 = rows64 // seq_len, t.to(tl.int64)
    dy_off = (bidx * dy_stride_b + t64 * dy_stride_t)[:, None] + head * DH + cols[None, :]
    x_off = (bidx * x_stride_b + t64 * x_stride_t)[:, None] + head * DH + cols[None, :]
    o_off = rows64[:, None] * ROW + head * DH + cols[None, :]
    t_off = (t + offset)[:, None] * HALF + cols[None, :]
    dy1 = tl.load(dy_ptr + dy_off, mask=mask, other=0.0).to(tl.float32)
    dy2 = tl.load(dy_ptr + dy_off + HALF, mask=mask, other=0.0).to(tl.float32)
    cos = tl.load(cos_ptr + t_off, mask=mask, other=0.0)
    sin = tl.load(sin_ptr + t_off, mask=mask, other=0.0)
    g1 = dy1 * cos + dy2 * sin  # rotation by -sin
    g2 = dy2 * cos - dy1 * sin
    if FMAP != 0:
        x1 = tl.load(x_ptr + x_off, mask=mask, other=0.0).to(tl.float32)
        x2 = tl.load(x_ptr + x_off + HALF, mask=mask, other=0.0).to(tl.float32)
        if FMAP == 1:  # relu'
            g1 = tl.where(x1 > 0, g1, 0.0)
            g2 = tl.where(x2 > 0, g2, 0.0)
        else:  # (elu + 1)'
            g1 = g1 * tl.where(x1 > 0, 1.0, tl.exp(x1))
            g2 = g2 * tl.where(x2 > 0, 1.0, tl.exp(x2))
    tl.store(dx_ptr + o_off, g1.to(dx_ptr.dtype.element_ty), mask=mask)
    tl.store(dx_ptr + o_off + HALF, g2.to(dx_ptr.dtype.element_ty), mask=mask)


def _load_triton():
    global triton, tl, _kernels
    if _kernels is None:
        triton, tl = _build.import_triton()
        # one compiled variant for every batch, length and decode position
        unspec = ["n_rows", "seq_len", "offset"]
        _kernels = (
            triton.jit(_fmap_rope_fwd, do_not_specialize=unspec),
            triton.jit(_fmap_rope_bwd, do_not_specialize=unspec),
        )
    return _kernels


def _fmap_fwd(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name in ("relu", "t2r"):
        return torch.clamp_min(x, 0.0)
    if name == "elu":
        return torch.where(x > 0, x + 1.0, torch.exp(x))  # elu(x) + 1
    return x


def _fmap_deriv(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name in ("relu", "t2r"):
        return (x > 0).float()
    if name == "elu":
        return torch.where(x > 0, 1.0, torch.exp(x))
    return torch.ones_like(x)


def fmap_rope_plain(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    feature_map: Optional[str] = None,
    offset: int = 0,
) -> torch.Tensor:
    """``rope(fmap(x))`` in float32, returned in x's dtype."""
    y = apply_rotary_flat(_fmap_fwd(x.float(), feature_map), cos, sin, num_heads, offset)
    return y.to(x.dtype)


def fmap_rope_bwd_plain(
    dy: torch.Tensor,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    feature_map: Optional[str] = None,
    offset: int = 0,
) -> torch.Tensor:
    """``fmap'(x) * rope_{-sin}(dy)`` in float32 from dy rounded to x's
    dtype (as ``_fused_bwd`` casts it), returned in x's dtype."""
    g = apply_rotary_flat(dy.to(x.dtype).float(), cos, -sin, num_heads, offset)
    return (g * _fmap_deriv(x.float(), feature_map)).to(x.dtype)


def _launch_checks(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, half: int):
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"kernel takes bf16, fp16 or fp32, got {x.dtype}")
    if x.stride(-1) != 1:
        raise ValueError("kernel needs unit stride along the feature axis")
    for name, tab in (("cos", cos), ("sin", sin)):
        if tab.dtype != torch.float32 or not tab.is_contiguous() or tab.device != x.device:
            raise ValueError(f"{name} table must be contiguous float32 on {x.device}")
    if half & (half - 1):
        raise ValueError(f"kernel needs a power-of-two Dh/2, got {half}")


def _fmap_rope(x, cos, sin, num_heads, feature_map, offset) -> torch.Tensor:
    """K1 on a checked input: the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return fmap_rope_plain(x, cos, sin, num_heads, feature_map, offset)
    b, t, f = x.shape
    dh = f // num_heads
    _launch_checks(x, cos, sin, dh // 2)
    out = torch.empty(b, t, f, dtype=x.dtype, device=x.device)
    if b * t == 0:
        return out
    kernel = _load_triton()[0]
    grid = (triton.cdiv(b * t, _BLOCK_R), num_heads)
    with torch.cuda.device(x.device):
        kernel[grid](
            x, cos, sin, out, b * t, t, offset, x.stride(0), x.stride(1),
            ROW=f, DH=dh, HALF=dh // 2, FMAP=_FMAP_CODE[feature_map],
            BLOCK_R=_BLOCK_R, num_warps=4,
        )
    launches["fmap_rope"] += 1
    return out


def fmap_rope_bwd(
    dy: torch.Tensor,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    feature_map: Optional[str] = None,
    offset: int = 0,
) -> torch.Tensor:
    """K1b: the gradient of :func:`fused_fmap_rope_flat` for the output
    gradient ``dy`` at the input ``x`` (both [B, T, H*Dh], any row strides);
    a contiguous [B, T, H*Dh] tensor in x's dtype."""
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and x {tuple(x.shape)} disagree")
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return fmap_rope_bwd_plain(dy, x, cos, sin, num_heads, feature_map, offset)
    b, t, f = x.shape
    dh = f // num_heads
    _launch_checks(x, cos, sin, dh // 2)
    if dy.device != x.device:
        raise ValueError(f"dy on {dy.device}, x on {x.device}")
    dy = dy.to(x.dtype)
    if dy.stride(-1) != 1:
        raise ValueError("kernel needs unit stride along the feature axis")
    dx = torch.empty(b, t, f, dtype=x.dtype, device=x.device)
    if b * t == 0:
        return dx
    kernel = _load_triton()[1]
    grid = (triton.cdiv(b * t, _BLOCK_R), num_heads)
    with torch.cuda.device(x.device):
        kernel[grid](
            dy, x, cos, sin, dx, b * t, t, offset,
            dy.stride(0), dy.stride(1), x.stride(0), x.stride(1),
            ROW=f, DH=dh, HALF=dh // 2, FMAP=_FMAP_CODE[feature_map],
            BLOCK_R=_BLOCK_R, num_warps=4,
        )
    launches["fmap_rope_bwd"] += 1
    return dx


class _FmapRope(torch.autograd.Function):
    """K1 forward, K1b backward; saves x before the feature map."""

    @staticmethod
    def forward(ctx, x, cos, sin, num_heads, feature_map, offset):
        ctx.save_for_backward(x, cos, sin)
        ctx.args = (num_heads, feature_map, offset)
        return _fmap_rope(x, cos, sin, num_heads, feature_map, offset)

    @staticmethod
    def backward(ctx, dy):
        x, cos, sin = ctx.saved_tensors
        return fmap_rope_bwd(dy, x, cos, sin, *ctx.args), None, None, None, None, None


def fused_fmap_rope_flat(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    feature_map: Optional[str] = None,
    offset: int = 0,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``rope(fmap(x))`` on head-flat x [B, T, H*Dh] with the
    [>= T + offset, Dh/2] float32 rotary tables (K1; differentiable in x
    through K1b).

    ``offset`` is the position of x's first token (the decode position);
    a token past the tables' last row raises ``ValueError``."""
    if positions is not None:
        raise NotImplementedError("per-token positions (packed varlen) are not ported yet")
    if feature_map not in _FMAPS:
        raise ValueError(f"feature map {feature_map!r} is not a flat map {_FMAPS}")
    b, t, f = x.shape
    if f % num_heads:
        raise ValueError(f"width {f} not divisible by {num_heads} heads")
    half = f // num_heads // 2
    if cos.shape[-1] != half or sin.shape != cos.shape:
        raise ValueError("full-head-dim rotary tables [max_len, Dh/2] required")
    if offset < 0 or offset + t > cos.shape[0]:
        raise ValueError(
            f"positions [{offset}, {offset + t}) exceed the rotary tables' "
            f"{cos.shape[0]} rows (the context bound)"
        )
    if torch.is_grad_enabled() and x.requires_grad:
        return _FmapRope.apply(x, cos, sin, num_heads, feature_map, offset)
    # no gradient (serving): skip the autograd Function's host cost per call
    return _fmap_rope(x, cos, sin, num_heads, feature_map, offset)
