"""Gated delta rule op, DeltaNet with scalar forget gates (counterpart of
``mhla_tpu/ops/delta_rule.py``).

Per token, with state S [Dk, Dv]:

    S  *= exp(g_t)                      # scalar per-head log decay
    v'  = beta_t * (v_t - S^T k_t)      # delta rule replacement
    S  += k_t v'^T
    o_t = (q_t * Dk**-0.5) S

q/k are L2-normalized inside the op, as in every caller (JAX's
``use_qk_l2norm`` switch is not ported). Two forms, both plain PyTorch in
float32:

- :func:`gated_delta_recurrent`: the exact token loop (the oracle and the
  decode path).
- :func:`gated_delta_chunk`: the WY form. Within a chunk the sequential
  delta corrections come in closed form from the unit-lower-triangular
  system ``(I + A) v' = beta (v - decayed prefix readout)``, inverted as a
  Neumann product of log2(C) squarings (:func:`_tril_unit_inverse`).

The JAX op traces both under "highest" matmul precision, because the WY
solve and the ``v_eff = u - w S`` chain are cancelling sums whose
truncation feeds back through the state. Here every product is a float32
``torch.matmul``: full float32 on the CPU, and on a CUDA device as long as
TF32 stays off (``torch.backends.cuda.matmul.allow_tf32``, False by
default). These ops are the semantic anchor; the fused path with the
hand-written kernels is ``kernels.delta_chunk.gated_delta_chunk_fused``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .mhla_chunk import _pad_to_chunks


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def _prepare(q, k, v, g, beta, initial_state):
    b, _, h, dk = q.shape
    dv = v.shape[-1]
    q, k, v, g, beta = (x.float() for x in (q, k, v, g, beta))
    q, k = l2norm(q), l2norm(k)
    s0 = (
        initial_state.float()
        if initial_state is not None
        else torch.zeros(b, h, dk, dv, dtype=torch.float32, device=q.device)
    )
    return q, k, v, g, beta, s0


def gated_delta_recurrent(
    q: torch.Tensor,  # [B, T, H, Dk]
    k: torch.Tensor,  # [B, T, H, Dk]
    v: torch.Tensor,  # [B, T, H, Dv]
    g: torch.Tensor,  # [B, T, H] log decay (<= 0)
    beta: torch.Tensor,  # [B, T, H] in (0, 1)
    initial_state: Optional[torch.Tensor] = None,  # [B, H, Dk, Dv]
    output_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The exact token recurrence; o in q's dtype, the state float32."""
    in_dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    q, k, v, g, beta, s = _prepare(q, k, v, g, beta, initial_state)
    outs = []
    for t in range(q.shape[1]):
        s = s * torch.exp(g[:, t])[..., None, None]
        v_old = torch.einsum("bhkv,bhk->bhv", s, k[:, t])
        v_new = beta[:, t, :, None] * (v[:, t] - v_old)
        s = s + k[:, t, :, :, None] * v_new[:, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", q[:, t] * scale, s))
    o = torch.stack(outs, dim=1).to(in_dtype)
    return o, (s if output_final_state else None)


def _tril_unit_inverse(a: torch.Tensor) -> torch.Tensor:
    """(I + A)^-1 for strictly-lower-triangular A [..., C, C]: A is
    nilpotent, so (I + A)^-1 = prod_j (I + (-A)^(2^j)), log2(C) squarings."""
    c = a.shape[-1]
    eye = torch.eye(c, dtype=a.dtype, device=a.device)
    x = -a
    inv = eye + x
    for _ in range(max((c - 1).bit_length() - 1, 0)):
        x = x @ x
        inv = inv @ (eye + x)
    return inv


def gated_delta_chunk(
    q: torch.Tensor,  # [B, T, H, Dk]
    k: torch.Tensor,  # [B, T, H, Dk]
    v: torch.Tensor,  # [B, T, H, Dv]
    g: torch.Tensor,  # [B, T, H] log decay (<= 0)
    beta: torch.Tensor,  # [B, T, H]
    initial_state: Optional[torch.Tensor] = None,
    chunk_size: int = 64,
    output_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chunked WY form; equals :func:`gated_delta_recurrent` up to
    float32 rounding. o in q's dtype, the state float32."""
    in_dtype = q.dtype
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = chunk_size
    scale = dk**-0.5
    q, k, v, g, beta, s = _prepare(q, k, v, g, beta, initial_state)
    q, k, v, g, beta = (_pad_to_chunks(x, c) for x in (q, k, v, g, beta))
    n = q.shape[1] // c

    def chunked(x):  # [B, T, H(, D)] -> [B, N, H, C(, D)]
        if x.ndim == 4:
            return x.reshape(b, n, c, h, x.shape[-1]).transpose(2, 3)
        return x.reshape(b, n, c, h).transpose(2, 3)

    q, k, v, g, beta = (chunked(x) for x in (q, k, v, g, beta))
    g_cum = torch.cumsum(g, dim=-1)  # inclusive within-chunk cumsum
    g_last = g_cum[..., -1]  # [B, N, H]

    # exp(G_i - G_j) from differences (<= 0 for g <= 0): e^{-G} alone
    # overflows at delta-rule decay magnitudes
    gd = g_cum[..., :, None] - g_cum[..., None, :]
    idx = torch.arange(c, device=q.device)
    ninf = torch.tensor(float("-inf"), device=q.device)
    decay_incl = torch.exp(torch.where(idx[:, None] >= idx[None, :], gd, ninf))
    decay_strict = torch.exp(torch.where(idx[:, None] > idx[None, :], gd, ninf))

    # WY solve for all chunks: A[i, j] = beta_i <k_i, k_j> exp(G_i - G_j), j < i
    a = (k @ k.transpose(-1, -2)) * decay_strict * beta[..., :, None]
    t_inv = _tril_unit_inverse(a)
    u = t_inv @ (beta[..., None] * v)
    w = t_inv @ ((beta * torch.exp(g_cum))[..., None] * k)
    qk = (q @ k.transpose(-1, -2)) * decay_incl * scale
    q_dec = q * torch.exp(g_cum)[..., None] * scale
    k_carry = k * torch.exp(g_last[..., None] - g_cum)[..., None]

    outs = []
    for i in range(n):
        v_eff = u[:, i] - w[:, i] @ s
        outs.append(q_dec[:, i] @ s + qk[:, i] @ v_eff)
        s = s * torch.exp(g_last[:, i])[..., None, None] + k_carry[:, i].transpose(-1, -2) @ v_eff
    o = torch.stack(outs, dim=1)  # [B, N, H, C, Dv]
    o = o.transpose(2, 3).reshape(b, n * c, h, dv)[:, :t]
    return o.to(in_dtype), (s if output_final_state else None)
