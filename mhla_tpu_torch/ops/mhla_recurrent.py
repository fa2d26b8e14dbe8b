"""Recurrent (decode-mode) causal MHLA operator (counterpart of
``mhla_tpu/ops/mhla_recurrent.py``).

O(1)-per-token form of ``mhla_chunk``. For a token in chunk i,

    o_t = q_t @ ( sum_{j<i} M[i, j] S_j  +  M[i, i] S_cur )

and the prefix readout ``sum_{j<i} M[i, j] S_j`` changes only when i does,
so the cache carries it:

    state.states : [B, H, N_slots, Dk, Dv] float32  completed chunk states
    state.mixed  : [B, H, Dk, Dv] float32           cached prefix readout
    state.s_cur  : [B, H, Dk, Dv] float32           in-progress chunk state
    state.t      : int                              tokens consumed

Per token: ``s_cur += k^T v; o = q @ (mixed + M[i,i] * s_cur)``. At the end
of a chunk, s_cur is written into its slot and the prefix is re-mixed for
the next row. This equals the chunked op exactly (see ``mhla_chunk.py``).

Unlike the JAX op, which is functional and commits with a one-hot
select-add (a dynamic-index scatter is slow on a TPU), this op updates the
state tensors IN PLACE: the slot commit is a plain indexed copy. The
returned state shares its tensors with the one passed in. Where autograd
records (an input requires grad: the ``fused_recurrent`` mode in
training), the same steps run out of place, so they can be differentiated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .mhla_chunk import DEFAULT_CHUNK_SIZE


class MHLAState(NamedTuple):
    """Decode cache for one MHLA layer."""

    states: torch.Tensor  # [B, H, N_slots, Dk, Dv] float32 — completed chunks
    mixed: torch.Tensor  # [B, H, Dk, Dv] float32 — cached prefix readout
    s_cur: torch.Tensor  # [B, H, Dk, Dv] float32 — in-progress chunk state
    t: int  # number of tokens consumed


def _prep_m(mixing_matrix: torch.Tensor) -> torch.Tensor:
    return mixing_matrix.reshape(
        mixing_matrix.shape[0], mixing_matrix.shape[1]
    ).float()


def _remix(states: torch.Tensor, m: torch.Tensor, i: int) -> torch.Tensor:
    """sum_{j<i} M[i, j] states[j] — the prefix readout for chunk row i."""
    if i == 0:
        return torch.zeros_like(states[:, :, 0])
    return torch.einsum("n,bhnkv->bhkv", m[i, :i], states[:, :, :i])


def init_mhla_state(
    batch_size: int,
    num_heads: int,
    num_slots: int,
    head_k_dim: int,
    head_v_dim: int,
    device: torch.device | str | None = None,
) -> MHLAState:
    tile = (batch_size, num_heads, head_k_dim, head_v_dim)
    f32 = torch.float32
    return MHLAState(
        states=torch.zeros(
            batch_size, num_heads, num_slots, head_k_dim, head_v_dim,
            dtype=f32, device=device,
        ),
        mixed=torch.zeros(tile, dtype=f32, device=device),
        s_cur=torch.zeros(tile, dtype=f32, device=device),
        t=0,
    )


def mhla_recurrent(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mixing_matrix: torch.Tensor,
    state: Optional[MHLAState] = None,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
) -> Tuple[torch.Tensor, MHLAState]:
    """Step the recurrence over T tokens (typically T == 1 in decode).

    Args:
      q, k: [B, T, H, Dk]; v: [B, T, H, Dv] (post feature map / RoPE).
      mixing_matrix: [L, L]; L is the slot count, and L * chunk_size the
        longest context. Stepping past it raises ``ValueError`` (the JAX
        op's ``take``/``dynamic_update_slice`` would clamp silently).
      state: carry from the previous call (updated in place), or None to
        start at position 0.

    Returns (o [B, T, H, Dv], state).
    """
    in_dtype = q.dtype
    b, t_len, h, dk = q.shape
    dv = v.shape[-1]
    m = _prep_m(mixing_matrix)
    n_slots = m.shape[0]
    if state is None:
        state = init_mhla_state(b, h, n_slots, dk, dv, device=q.device)
    if state.t + t_len > n_slots * chunk_size:
        raise ValueError(
            f"decode past the context bound: {state.t} + {t_len} tokens > "
            f"{n_slots} slots x {chunk_size} = {n_slots * chunk_size}"
        )
    m_diag = torch.diagonal(m)

    qf = q.float() * dk**-0.5
    kf = k.float()
    vf = v.float()
    states, mixed, s_cur, t = state
    inplace = not (torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v, mixing_matrix, states, mixed, s_cur)))
    outs = []
    for step in range(t_len):
        i = t // chunk_size
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, step], vf[:, step])
        s_cur = s_cur.add_(kv) if inplace else s_cur + kv
        outs.append(
            torch.einsum("bhk,bhkv->bhv", qf[:, step], mixed + m_diag[i] * s_cur)
        )
        if (t + 1) % chunk_size == 0:
            # end of chunk i: write the finished chunk into its slot and
            # re-mix the prefix for row i + 1
            if inplace:
                states[:, :, i].copy_(s_cur)
                s_cur.zero_()
            else:
                slot = torch.arange(n_slots, device=states.device) == i
                states = torch.where(slot[:, None, None], s_cur[:, :, None], states)
                s_cur = torch.zeros_like(s_cur)
            if i + 1 < n_slots:
                remixed = _remix(states, m, i + 1)
                mixed = mixed.copy_(remixed) if inplace else remixed
        t += 1
    o = torch.stack(outs, dim=1)
    return o.to(in_dtype), MHLAState(states=states, mixed=mixed, s_cur=s_cur, t=t)


def state_from_chunk(
    states: torch.Tensor,
    t: int,
    mixing_matrix: torch.Tensor,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    num_slots: Optional[int] = None,
) -> MHLAState:
    """Build a decode cache from ``mhla_chunk(..., output_final_state=True)``.

    ``states``: [B, H, N, Dk, Dv] per-chunk stack. The chunked op zero-pads
    k and v, so the partial last chunk's slot ``t // chunk_size`` already
    holds the in-progress accumulation. Slots are padded to ``num_slots``.
    """
    states = states.float()
    m = _prep_m(mixing_matrix)
    n_slots = num_slots or m.shape[0]
    if states.shape[2] < n_slots:
        states = F.pad(states, (0, 0, 0, 0, 0, n_slots - states.shape[2]))
    else:
        states = states.clone()
    i = t // chunk_size
    if i >= n_slots:  # the context is full: no further token can be stepped
        zeros = torch.zeros_like(states[:, :, 0])
        return MHLAState(states=states, mixed=zeros, s_cur=zeros.clone(), t=t)
    s_cur = states[:, :, i].clone()  # own storage: s_cur is updated in place
    return MHLAState(states=states, mixed=_remix(states, m, i), s_cur=s_cur, t=t)
