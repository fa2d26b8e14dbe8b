"""Fused feature map + rotate-half rotary on head-flat [B, T, H*D] rows
(counterpart of ``mhla_tpu/kernels/fmap_rope_pallas.py``, forward only).

K1 ``fused_fmap_rope_flat`` computes ``rope(fmap(x))`` in float32 and
stores x's dtype. It replaces ``_fwd_kernel``
(``mhla_tpu/kernels/fmap_rope_pallas.py:66``), written here in Triton.

- Bound: bytes. Each output element depends only on its rotate-half
  partner in the same head segment: 6 FLOP per element against 4 bytes
  moved in bf16, with no reuse that shared memory could exploit.
- Design: one program per 16 rows x one head loads the two halves of the
  head segment as two [16, Dh/2] blocks, with the matching rows of the
  [max_len, Dh/2] cos/sin tables at ``offset + t``, and writes both halves
  back. The tables are indexed in the kernel, so no [T, Dh] signed copy is
  built per call, and the decode step (T = 1) launches the same kernel
  (the JAX package falls back to jnp there).

Triton is imported, and the kernel compiled, at the first launch on a CUDA
tensor; a CPU tensor takes :func:`fmap_rope_plain`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..ops.rotary import apply_rotary_flat
from ._build import BUILD_DIR

launches = {"fmap_rope": 0}

_FMAPS = (None, "relu", "elu", "identity", "t2r")
_FMAP_CODE = {None: 0, "identity": 0, "relu": 1, "t2r": 1, "elu": 2}
_BLOCK_R = 16

# bound by _load_triton() at the first launch on a CUDA tensor; the kernel
# below is plain Python until then (its annotations stay unevaluated strings)
triton = tl = None
_kernel = None


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


def _load_triton():
    global triton, tl, _kernel
    if _kernel is None:
        # keep Triton's compile cache inside the package's build directory
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
        import triton as _triton
        import triton.language as _tl

        triton, tl = _triton, _tl
        # one compiled variant for every batch, length and decode position
        _kernel = triton.jit(_fmap_rope_fwd, do_not_specialize=["n_rows", "seq_len", "offset"])
    return _kernel


def _fmap_fwd(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name in ("relu", "t2r"):
        return torch.clamp_min(x, 0.0)
    if name == "elu":
        return torch.where(x > 0, x + 1.0, torch.exp(x))  # elu(x) + 1
    return x


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
    [>= T + offset, Dh/2] float32 rotary tables (K1).

    ``offset`` is the position of x's first token (the decode position);
    a token past the tables' last row raises ``ValueError``."""
    if positions is not None:
        raise NotImplementedError("per-token positions (packed varlen) are not ported yet")
    if feature_map not in _FMAPS:
        raise ValueError(f"feature map {feature_map!r} is not a flat map {_FMAPS}")
    b, t, f = x.shape
    if f % num_heads:
        raise ValueError(f"width {f} not divisible by {num_heads} heads")
    dh = f // num_heads
    half = dh // 2
    if cos.shape[-1] != half or sin.shape != cos.shape:
        raise ValueError("full-head-dim rotary tables [max_len, Dh/2] required")
    if offset < 0 or offset + t > cos.shape[0]:
        raise ValueError(
            f"positions [{offset}, {offset + t}) exceed the rotary tables' "
            f"{cos.shape[0]} rows (the context bound)"
        )
    if x.device.type == "cpu":
        return fmap_rope_plain(x, cos, sin, num_heads, feature_map, offset)
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
    out = torch.empty(b, t, f, dtype=x.dtype, device=x.device)
    if b * t == 0:
        return out
    kernel = _load_triton()
    grid = (triton.cdiv(b * t, _BLOCK_R), num_heads)
    with torch.cuda.device(x.device):
        kernel[grid](
            x, cos, sin, out, b * t, t, offset, x.stride(0), x.stride(1),
            ROW=f, DH=dh, HALF=half, FMAP=_FMAP_CODE[feature_map],
            BLOCK_R=_BLOCK_R, num_warps=4,
        )
    launches["fmap_rope"] += 1
    return out
