"""Non-causal blockwise MHLA in plain PyTorch (counterpart of
``mhla_tpu/ops/mhla_blockwise.py``): the definition the fused island of
``mhla_tpu_torch.kernels.mhla_block`` is held to.

    kv_j   = k_j^T v_j                       per block j   [Dk, Dv]
    kv~_i  = sum_j M[i, j] kv_j              block mixing
    z_i    = sum_j M[i, j] (q_j @ k_j.sum)   mixed normalizer
    o_i    = (q_i @ kv~_i) / (z_i + eps)

The normalizer's index is a quirk of the reference implementation that is
kept on purpose: the mixing matrix is applied to the per-block field
``q_j @ k_sum_j``, which is already indexed by the query's own block, so
block i's denominator mixes OTHER blocks' query readouts, not q_i against
other blocks' key sums. "Fixing" it to ``q_i @ (sum_j M[i,j] k_j.sum)``
changes the numerics against the reference.

q and k are already positive (``relu(norm(.)) + eps`` upstream). The video
variant uses RoPE'd q/k for the kv path and the no-RoPE q/k for the
normalizer, hence the separate ``q_nope``/``k_nope``.
"""

from __future__ import annotations

from typing import Optional

import torch


def mhla_blockwise_mh(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mixing_matrix: torch.Tensor,
    q_nope: Optional[torch.Tensor] = None,
    k_nope: Optional[torch.Tensor] = None,
    normalize: bool = True,
    eps: float = 1e-6,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """q, k [B, N, C, H, Dk], v [B, N, C, H, Dv], ``mixing_matrix`` [N, N]
    -> o [B, N, C, H, Dv] in q's dtype.

    ``compute_dtype`` is the precision of the products' inputs (default
    float32); every product accumulates in float32 and the states and the
    mixed states are rounded to it between the products. The normalizer's
    sums and the division stay float32."""
    in_dtype = q.dtype
    cdt = compute_dtype or torch.float32
    q, k, v = q.to(cdt), k.to(cdt), v.to(cdt)
    m = mixing_matrix.to(cdt)

    kv = torch.einsum("bnchk,bnchv->bnhkv", k.float(), v.float()).to(cdt)
    kv = torch.einsum("ij,bjhkv->bihkv", m.float(), kv.float()).to(cdt)
    out = torch.einsum("bnchk,bnhkv->bnchv", q.float(), kv.float())

    if normalize:
        qn = q if q_nope is None else q_nope.to(cdt)
        kn = k if k_nope is None else k_nope.to(cdt)
        k_sum = kn.float().sum(dim=2).to(cdt)  # [B, N, H, Dk]
        z = torch.einsum("bnchk,bnhk->bnch", qn.float(), k_sum.float())
        z = torch.einsum("ij,bjch->bich", m.float(), z) + eps
        out = out / z[..., None]
    return out.to(in_dtype)
