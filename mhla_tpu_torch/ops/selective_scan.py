"""Mamba-1 selective scan (S6), chunked and recurrent (counterpart of
``mhla_tpu/ops/selective_scan.py``).

Per token, with a diagonal state h [Dm, N]:

    h_t = exp(A * dt_t) * h_{t-1} + (dt_t * B_t) * x_t      (per channel d)
    y_t = h_t @ C_t + D * x_t

The recurrence is elementwise, so the chunked form is a first-order linear
scan: within a chunk the (decay, increment) pairs combine as h -> a h + b
in a parallel prefix of log2(C) steps (Hillis-Steele over the chunk axis;
JAX runs ``lax.associative_scan``), and only the carry from chunk to chunk
is sequential. Both forms compute in float32 and run in plain PyTorch, as
JAX runs them in jnp (no Pallas kernel is involved). Under autograd each
chunk runs under ``torch.utils.checkpoint`` in its reentrant form: its
[B, C, Dm, N] tiles are recomputed in the backward instead of kept, so a
layer keeps only its chunks' inputs and carries. (The non-reentrant form
kept about as much as no checkpoint here: 7.6 against 9.2 GB for one
layer's scan at B=2, T=2048, Dm 2048 on the CPU; the reentrant form 0.8.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _prefix_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the maps h -> a h + b over axis 1: (prod a, the
    composed increments), in log2(C) steps."""
    c = a.shape[1]
    shift = 1
    while shift < c:
        a_next = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        b = torch.cat([b[:, :shift], b[:, :-shift] * a[:, shift:] + b[:, shift:]], dim=1)
        a = a_next
        shift *= 2
    return a, b


def _scan_chunk(h, x_i, dt_i, b_i, c_i, a, d):
    """One chunk: x_i, dt_i [B, C, Dm], b_i, c_i [B, C, N], carry h [B, Dm,
    N]; returns (y [B, C, Dm], the chunk's last state)."""
    aa = torch.exp(a[None, None] * dt_i[..., None])  # [B, C, Dm, N]
    bu = (dt_i * x_i)[..., None] * b_i[:, :, None, :]
    pa, pb = _prefix_scan(aa, bu)
    h_all = pa * h[:, None] + pb
    y = torch.einsum("bcdn,bcn->bcd", h_all, c_i) + d * x_i
    return y, h_all[:, -1].clone()


def _f32(*xs):
    return [x.float() for x in xs]


def _initial(initial_state, bsz, dm, n, device):
    if initial_state is not None:
        return initial_state.float()
    return torch.zeros(bsz, dm, n, dtype=torch.float32, device=device)


def selective_scan_chunk(
    x: torch.Tensor,  # [B, T, Dm]
    dt: torch.Tensor,  # [B, T, Dm] (post-softplus, > 0)
    a: torch.Tensor,  # [Dm, N] (negative)
    b_in: torch.Tensor,  # [B, T, N]
    c_in: torch.Tensor,  # [B, T, N]
    d: torch.Tensor,  # [Dm]
    initial_state: Optional[torch.Tensor] = None,  # [B, Dm, N]
    chunk_size: int = 64,
    output_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The chunked scan (training and prefill); y in x's dtype, the state
    float32 (None without ``output_final_state``)."""
    in_dtype = x.dtype
    bsz, t, dm = x.shape
    n = a.shape[-1]
    x, dt, a, b_in, c_in, d = _f32(x, dt, a, b_in, c_in, d)
    h = _initial(initial_state, bsz, dm, n, x.device)
    grad = torch.is_grad_enabled() and any(
        u.requires_grad for u in (x, dt, a, b_in, c_in, d, h))
    ys = []
    for s in range(0, t, chunk_size):
        chunk = [u[:, s:s + chunk_size] for u in (x, dt, b_in, c_in)]
        if grad:
            y, h = checkpoint(_scan_chunk, h, *chunk, a, d, use_reentrant=True)
        else:
            y, h = _scan_chunk(h, *chunk, a, d)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y.to(in_dtype), (h if output_final_state else None)


def selective_scan_recurrent(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_in: torch.Tensor,
    c_in: torch.Tensor,
    d: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
    output_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The token recurrence (the oracle and the decode path), same
    semantics."""
    in_dtype = x.dtype
    bsz, t, dm = x.shape
    n = a.shape[-1]
    x, dt, a, b_in, c_in, d = _f32(x, dt, a, b_in, c_in, d)
    h = _initial(initial_state, bsz, dm, n, x.device)
    ys = []
    for i in range(t):
        h = h * torch.exp(a[None] * dt[:, i, :, None]) + (dt[:, i] * x[:, i])[..., None] * b_in[
            :, i, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_in[:, i]) + d * x[:, i])
    y = torch.stack(ys, dim=1).to(in_dtype)
    return y, (h if output_final_state else None)
