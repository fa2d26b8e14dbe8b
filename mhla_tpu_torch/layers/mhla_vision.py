"""Non-causal MHLA attention for images and video (counterpart of
``BlockMixing``, ``MHLA2D`` and ``MHLA3D`` in
``mhla_tpu/layers/mhla_vision.py``).

:class:`MHLA2D` takes block-major tokens [B, N_blocks, C_block, dim]: an
input LayerNorm, one qkv projection, optional RMSNorm on q and k, relu
feature map, blockwise state mixing over the (p, p) block layout (fixed for
ViT, trainable and clamped for DiT) and a LePE term, a depthwise convolution
of v over the un-blocked grid, added before the output projection. It runs
the plain op ``ops.mhla_blockwise.mhla_blockwise_mh``, as the JAX layer runs
its jnp einsums.

:class:`MHLA3D` takes flat tokens [B, T, dim] plus the (F, H, W) grid:
separate q/k/v/g projections with bias, full-dim RMSNorm on q and k, relu
feature map, 3-D RoPE applied after the feature map, blockwise state mixing
over the 3-D block layout, per-head RMSNorm and a SiLU gate on the output,
and with ``is_lepe`` a 3x3x3 depthwise convolution of v added after the
gate. Head dims that are multiples of 128 run the fused island of
``mhla_tpu_torch.kernels.mhla_block`` (kernels K5-K8 on a CUDA tensor, their
plain versions on the CPU); other head dims run the composed path in plain
PyTorch, as in the JAX layer. The LePE convolution is one PyTorch call
(``F.conv2d`` / ``F.conv3d`` with ``groups=dim``) outside the island, as
JAX computes it in XLA outside its Pallas kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.mhla_block import blockify_island, mhla_blockwise_fused, unblockify_island
from ..ops.block_mix import block_mixing_matrix
from ..ops.mhla_blockwise import mhla_blockwise_mh
from ..ops.rotary import apply_rotary_3d_halves, rope_angles_3d_on, rope_tables_flat
from .fused_dense import dense
from .norms import LayerNorm, RMSNorm


class BlockMixing(nn.Module):
    """The [N, N] block-state mixing weights: a fixed buffer, or a trainable
    parameter initialized from the distance transform and clamped to [0, 1]
    where it is read."""

    def __init__(self, blocks_layout: Sequence[int], transform: str = "linear",
                 local_thres: float = 1.5, exp_sigma: float = 3.0, trainable: bool = False,
                 device=None):
        super().__init__()
        init = torch.from_numpy(
            block_mixing_matrix(tuple(blocks_layout), transform, local_thres, exp_sigma)
        ).to(device)
        self.trainable = trainable
        if trainable:
            self.weight = nn.Parameter(init)
        else:  # not in the state dict: the flax tree holds no fixed matrix either
            self.register_buffer("weight", init, persistent=False)

    def forward(self) -> torch.Tensor:
        return self.weight.clamp(0.0, 1.0) if self.trainable else self.weight


def depthwise_conv(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """The 'same' depthwise convolution ``conv`` (an ``nn.Conv2d`` or
    ``nn.Conv3d`` with ``groups`` = channels) over channels-last x [B,
    *spatial, C], in x's dtype (flax ``nn.Conv(feature_group_count=C,
    padding="SAME", dtype=x.dtype)``). Its weight [C, 1, k...] is the flax
    kernel [k..., 1, C] transposed.

    The 2-D form runs on the channels-last view; the 3-D form on a
    channels-first copy: on an H100 cuDNN's channels-last 3-D depthwise
    backward is two orders of magnitude slower than the copy's forward and
    backward at Wan's [1, 21, 30, 50, 1536] in bf16, while in 2-D the view is
    the faster (``eval/time_kernels.py lepe`` times both layouts)."""
    fn = F.conv2d if x.ndim == 4 else F.conv3d
    xc = x.movedim(-1, 1)
    if x.ndim == 5:
        xc = xc.contiguous()
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = fn(xc, conv.weight.to(x.dtype), bias, padding=conv.padding, groups=conv.groups)
    return y.movedim(1, -1)


def _depthwise(dim: int, kernel: int, dims: int, device=None) -> nn.Module:
    conv = nn.Conv2d if dims == 2 else nn.Conv3d
    return conv(dim, dim, kernel, padding=kernel // 2, groups=dim, device=device)


class MHLA2D(nn.Module):
    """Image MHLA over a (p * w, p * w) token grid in (p, p) blocks of (w, w)
    tokens. ViT's form: ``transform="cos"`` (the default), fixed mixing, LePE
    5; DiT's: ``transform="linear"``, ``trainable_mixing``, ``qkv_bias``,
    LePE 3. Parameters are named as the flax module names them (``norm``,
    ``to_qkv``, ``lepe``, ``q_norm``, ``k_norm``, ``piece_attn``,
    ``to_out``). The JAX layer's ``dropout`` (0 in every model) is left
    out."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        blocks_per_side: int = 4,
        block_len: int = 4,
        transform: str = "cos",
        local_thres: float = 1.5,
        exp_sigma: float = 3.0,
        trainable_mixing: bool = False,
        qkv_bias: bool = False,
        qk_norm: bool = False,
        lepe_kernel: int = 5,
        eps: float = 1e-6,
        use_input_norm: bool = True,
        device=None,
    ):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.dim, self.num_heads, self.eps = dim, num_heads, eps
        self.blocks_per_side, self.block_len = blocks_per_side, block_len
        self.norm = LayerNorm(dim, device=device) if use_input_norm else None
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.lepe = _depthwise(dim, lepe_kernel, 2, device)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = RMSNorm(dim, eps=eps, device=device)
            self.k_norm = RMSNorm(dim, eps=eps, device=device)
        self.piece_attn = BlockMixing((blocks_per_side, blocks_per_side), transform,
                                      local_thres, exp_sigma, trainable_mixing, device)
        self.to_out = nn.Linear(dim, dim, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, N_blocks, C_block, dim] block-major tokens -> the same shape."""
        b, n, c, _ = x.shape
        h, d = self.num_heads, self.dim // self.num_heads
        p, w = self.blocks_per_side, self.block_len
        if self.norm is not None:
            x = self.norm(x)
        q, k, v = dense(x, self.to_qkv).chunk(3, dim=-1)
        # LePE: the depthwise convolution of v over the un-blocked grid
        v_grid = v.reshape(b, p, p, w, w, self.dim).transpose(2, 3).reshape(
            b, p * w, p * w, self.dim)
        lepe = depthwise_conv(v_grid, self.lepe).reshape(b, p, w, p, w, self.dim)
        lepe = lepe.transpose(2, 3).reshape(b, n, c, self.dim)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q = (torch.relu(q) + self.eps).reshape(b, n, c, h, d)
        k = (torch.relu(k) + self.eps).reshape(b, n, c, h, d)
        out = mhla_blockwise_mh(q, k, v.reshape(b, n, c, h, d), self.piece_attn(), eps=self.eps)
        return dense(out.reshape(b, n, c, self.dim) + lepe, self.to_out)


def rearrange_to_blocks_3d(
    x: torch.Tensor, grid: Sequence[int], layout: Sequence[int]
) -> torch.Tensor:
    """[B, F*H*W, ...] -> [B, N_blocks, C_block, ...] in 3-D block-major
    order: ``(fb p1 hb p2 wb p3) -> (fb hb wb)(p1 p2 p3)``."""
    b = x.shape[0]
    (f, hh, ww), (fb, hb, wb) = grid, layout
    p1, p2, p3 = f // fb, hh // hb, ww // wb
    tail = x.shape[2:]
    x = x.reshape(b, fb, p1, hb, p2, wb, p3, *tail)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, *range(7, 7 + len(tail)))
    return x.reshape(b, fb * hb * wb, p1 * p2 * p3, *tail)


def rearrange_from_blocks_3d(
    x: torch.Tensor, grid: Sequence[int], layout: Sequence[int]
) -> torch.Tensor:
    """Inverse of :func:`rearrange_to_blocks_3d`."""
    b = x.shape[0]
    (f, hh, ww), (fb, hb, wb) = grid, layout
    p1, p2, p3 = f // fb, hh // hb, ww // wb
    tail = x.shape[3:]
    x = x.reshape(b, fb, hb, wb, p1, p2, p3, *tail)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, *range(7, 7 + len(tail)))
    return x.reshape(b, f * hh * ww, *tail)


class MHLA3D(nn.Module):
    """Video MHLA over an (F, H, W) token grid with 3-D block mixing. RoPE
    is applied after the relu feature map. ``attn_compute_dtype`` is the
    dtype of the attention island (default float32; bfloat16 keeps the
    streams and the products' inputs in bf16, sums stay float32)."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 12,
        blocks_layout: Tuple[int, int, int] = (3, 5, 10),
        transform: str = "linear",
        qk_norm: bool = True,
        is_gated: bool = True,
        is_lepe: bool = False,
        without_rope: bool = False,
        normalize_out: bool = True,
        eps: float = 1e-6,
        rope_theta: float = 10000.0,
        rope_max_pos: int = 1024,
        attn_compute_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.dim, self.num_heads = dim, num_heads
        self.blocks_layout = tuple(blocks_layout)
        self.qk_norm, self.is_gated = qk_norm, is_gated
        self.without_rope, self.normalize_out = without_rope, normalize_out
        self.eps, self.rope_theta, self.rope_max_pos = eps, rope_theta, rope_max_pos
        self.attn_compute_dtype = attn_compute_dtype
        for name in ("q", "k", "v", "o") + (("g",) if is_gated else ()):
            setattr(self, name, nn.Linear(dim, dim, bias=True, device=device))
        if qk_norm:
            self.norm_q = RMSNorm(dim, eps=eps, device=device)
            self.norm_k = RMSNorm(dim, eps=eps, device=device)
        self.g_norm = RMSNorm(dim // num_heads, eps=eps, device=device)
        self.block_attn = BlockMixing(self.blocks_layout, transform, device=device)
        self.lepe = _depthwise(dim, 3, 3, device) if is_lepe else None

    def forward(
        self,
        x: torch.Tensor,
        grid: Tuple[int, int, int],
        rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """x: [B, F*H*W, dim]; grid: (F, H, W). ``rope_tables``: optional
        (cos, sin_signed) [T, Dh] from ``rope_tables_flat``, which a model
        of many layers builds once."""
        b, t, _ = x.shape
        h, d = self.num_heads, self.dim // self.num_heads
        if grid[0] * grid[1] * grid[2] != t:
            raise ValueError(f"grid {tuple(grid)} does not match {t} tokens")
        q, k, v = dense(x, self.q), dense(x, self.k), dense(x, self.v)
        lepe = None
        if self.lepe is not None:  # LePE: the depthwise convolution of v over the grid
            lepe = depthwise_conv(v.reshape(b, *grid, self.dim), self.lepe).reshape(b, t, self.dim)
        island_dt = self.attn_compute_dtype or torch.float32
        m = self.block_attn()
        if d % 128 == 0:
            out = self._fused(q, k, v, m, grid, rope_tables, island_dt, x.dtype)
        else:
            out = self._composed(q, k, v, m, grid, island_dt, x.dtype)
        if self.is_gated:
            out = out * F.silu(dense(x, self.g))
        if lepe is not None:
            out = out + lepe
        return dense(out, self.o)

    def _fused(self, q, k, v, m, grid, rope_tables, island_dt, out_dtype):
        """The head-flat island: one fused pass per stream in (K5), dense
        mixing (K6), readout (K7), one fused pass out (K8)."""
        h, d = self.num_heads, self.dim // self.num_heads
        if self.without_rope:
            tables = None
        elif rope_tables is not None:
            tables = tuple(tb.float() for tb in rope_tables)
        else:
            tables = rope_tables_flat(grid, d, self.rope_theta, self.rope_max_pos, q.device)
        glt = (grid, self.blocks_layout, h)
        # mid_dtype repeats the composed path's rounding between the steps
        # when the island is narrower than float32
        mid = None if island_dt == torch.float32 else island_dt
        gq = self.norm_q.weight if self.qk_norm else None
        gk = self.norm_k.weight if self.qk_norm else None
        want_nope = self.normalize_out and tables is not None
        qb, q_nope = blockify_island(q, tables, gq, *glt, self.eps, self.eps, mid, island_dt,
                                     want_nope)
        kb, k_nope = blockify_island(k, tables, gk, *glt, self.eps, self.eps, mid, island_dt,
                                     want_nope)
        vb, _ = blockify_island(v, None, None, *glt, self.eps, None, mid, island_dt, False)
        if self.normalize_out and tables is None:
            q_nope, k_nope = qb, kb  # no RoPE: the normalizer reads the same streams
        out = mhla_blockwise_fused(
            qb, kb, vb, m, num_heads=h, q_nope4=q_nope, k_nope4=k_nope,
            normalize=self.normalize_out, eps=self.eps, compute_dtype=self.attn_compute_dtype,
        )
        # a wider island is rounded to the model dtype before the per-head norm
        return unblockify_island(
            out, self.g_norm.weight, *glt, self.eps,
            out_dtype if out.dtype != out_dtype else None, out_dtype,
        )

    def _composed(self, q, k, v, m, grid, island_dt, out_dtype):
        """The same function op by op in plain PyTorch."""
        b, t, _ = q.shape
        h, d = self.num_heads, self.dim // self.num_heads
        q, k, v = q.to(island_dt), k.to(island_dt), v.to(island_dt)
        if self.qk_norm:
            q, k = self.norm_q(q), self.norm_k(k)
        q5 = (torch.relu(q) + self.eps).reshape(b, t, h, d)
        k5 = (torch.relu(k) + self.eps).reshape(b, t, h, d)
        v5 = v.reshape(b, t, h, d)
        if self.without_rope:
            q_rope, k_rope = q5, k5
        else:
            angles = rope_angles_3d_on(grid, d, self.rope_theta, self.rope_max_pos, q.device)
            q_rope = apply_rotary_3d_halves(q5, angles)
            k_rope = apply_rotary_3d_halves(k5, angles)
        streams = [q_rope, k_rope, v5] + ([q5, k5] if self.normalize_out else [])
        qb, kb, vb, *nope = (rearrange_to_blocks_3d(s, grid, self.blocks_layout)
                             for s in streams)
        out = mhla_blockwise_mh(
            qb, kb, vb, m, q_nope=nope[0] if nope else None, k_nope=nope[1] if nope else None,
            normalize=self.normalize_out, eps=self.eps, compute_dtype=self.attn_compute_dtype,
        )
        out = rearrange_from_blocks_3d(out, grid, self.blocks_layout).to(out_dtype)
        return self.g_norm(out).reshape(b, t, self.dim)
