"""Causal chunked MHLA operator in plain PyTorch (counterpart of
``mhla_tpu/ops/mhla_chunk.py``).

Split the sequence into chunks of ``chunk_size`` tokens, keep one KV state
``S_j = k_j^T v_j`` per chunk, and mix the chunk states with a learned
lower-triangular chunk-by-chunk matrix ``M`` before queries read them:

    o_i = q_i @ ( sum_{j<i} M[i, j] * S_j )  +  M[i, i] * ( tril(q_i k_i^T) @ v_i )

with ``scale = D_k**-0.5`` applied to q. This is the definition the kernels
in ``mhla_tpu_torch/kernels/mhla_chunk.py`` and the recurrent decode op in
``mhla_recurrent.py`` are held to.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

DEFAULT_CHUNK_SIZE = 64


def _pad_to_chunks(x: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """Zero-pad axis 1 (tokens) up to a multiple of ``chunk_size``."""
    pad = (-x.shape[1]) % chunk_size
    if pad:
        widths = [0, 0] * (x.ndim - 2) + [0, pad]
        x = F.pad(x, widths)
    return x


def prepare_mixing_matrix(mixing_matrix: torch.Tensor, num_chunks: int) -> torch.Tensor:
    """Slice a mixing matrix ([L, L] or [L, L, 1, ...]) to a dense float32
    [N, N]; raise ``ValueError`` when it has fewer than N slots."""
    m = mixing_matrix.reshape(mixing_matrix.shape[0], mixing_matrix.shape[1])
    if m.shape[0] < num_chunks:
        raise ValueError(
            f"mixing_matrix has {m.shape[0]} chunk slots but the sequence spans "
            f"{num_chunks} chunks; increase the matrix size (num_slots >= "
            f"ceil(T / chunk_size))."
        )
    return m[:num_chunks, :num_chunks].float()


def init_causal_mixing_matrix(
    num_chunks: int, device: torch.device | str | None = None
) -> torch.Tensor:
    """Row-normalized lower-triangular init: M[i, j] = 1/(i+1) for j <= i."""
    tri = torch.tril(torch.ones(num_chunks, num_chunks, device=device))
    rows = torch.arange(1, num_chunks + 1, dtype=torch.float32, device=device)
    return tri / rows[:, None]


def clamp_causal_mixing_matrix(m: torch.Tensor, min_val: float = 1e-5) -> torch.Tensor:
    """Project the mixing matrix onto [min_val, 1] * tril (a pure function
    of the parameter value, applied before every use).

    When autograd records it, it is written as max/min against tensor
    bounds so that an entry exactly on a bound gets gradient 0.5, as
    ``jnp.clip`` gives; ``torch.clamp`` passes 1 there, and the causal init
    (M[0, 0] = 1) and the post-step projection put entries on the bounds.
    Without a gradient (serving, every decode token) the one ``clamp``
    gives the same values with no bound tensors to fill."""
    if not (torch.is_grad_enabled() and m.requires_grad):
        return torch.tril(torch.clamp(m, min_val, 1.0))
    lo, hi = m.new_full((), min_val), m.new_full((), 1.0)
    return torch.tril(torch.minimum(torch.maximum(m, lo), hi))


def mhla_chunk(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mixing_matrix: torch.Tensor,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    output_final_state: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Causal chunked MHLA on [B, T, H, D] tensors.

    Args:
      q, k: [B, T, H, Dk] (post feature map / RoPE); v: [B, T, H, Dv].
      mixing_matrix: [L, L] with L >= ceil(T / chunk_size).
      output_final_state: also return the per-chunk states
        [B, H, N, Dk, Dv] float32 (the decode cache layout).

    Returns (o [B, T, H, Dv], states or None). bf16 inputs compute the
    products in float32 from bf16 operands and round the states and the
    mixed states to bf16 between the phases, as the JAX op does.
    """
    if segment_ids is not None:
        raise NotImplementedError("segment_ids (packed varlen) is not ported yet")
    in_dtype = q.dtype
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk**-0.5
    cdt = torch.bfloat16 if in_dtype == torch.bfloat16 else torch.float32

    q, k, v = (_pad_to_chunks(x, chunk_size) for x in (q, k, v))
    n = q.shape[1] // chunk_size
    c = chunk_size
    m = prepare_mixing_matrix(mixing_matrix, n)
    m_strict = torch.tril(m, diagonal=-1)
    m_diag = torch.diagonal(m)

    # float32 math on compute-dtype operands: each product below is the
    # float32-accumulated GEMM of the JAX op, rounded where it rounds
    qf = (q.reshape(b, n, c, h, dk).float() * scale).to(cdt).float()
    kf = k.reshape(b, n, c, h, dk).to(cdt).float()
    vf = v.reshape(b, n, c, h, dv).to(cdt).float()

    states = torch.einsum("bnchk,bnchv->bnhkv", kf, vf)
    mixed = torch.einsum(
        "ij,bjhkv->bihkv", m_strict.to(cdt).float(), states.to(cdt).float()
    )
    o_inter = torch.einsum("bnchk,bnhkv->bnchv", qf, mixed.to(cdt).float())
    attn = torch.einsum("bnchk,bnmhk->bnhcm", qf, kf)
    tril = torch.tril(torch.ones(c, c, device=q.device))
    attn = (attn * tril).to(cdt).float()
    o_intra = torch.einsum("bnhcm,bnmhv->bnchv", attn, vf)
    o_intra = o_intra * m_diag[None, :, None, None, None]

    o = (o_inter + o_intra).reshape(b, n * c, h, dv)[:, :t]
    states_out = states.permute(0, 2, 1, 3, 4) if output_final_state else None
    return o.to(in_dtype), states_out
