"""Causal chunked MHLA operator in plain PyTorch (counterpart of
``mhla_tpu/ops/mhla_chunk.py``).

Split the sequence into chunks of ``chunk_size`` tokens, keep one KV state
``S_j = k_j^T v_j`` per chunk, and mix the chunk states with a learned
lower-triangular chunk-by-chunk matrix ``M`` before queries read them:

    o_i = q_i @ ( sum_{j<i} M[i, j] * S_j )  +  M[i, i] * ( tril(q_i k_i^T) @ v_i )

with ``scale = D_k**-0.5`` applied to q. This is the definition the kernels
in ``mhla_tpu_torch/kernels/mhla_chunk.py`` and the recurrent decode op in
``mhla_recurrent.py`` are held to.

Packed varlen rows carry per-token ``segment_ids``: with document
boundaries on chunk boundaries, each document reads the mixing matrix at
its own document-relative chunk indices and never another document's
states (:func:`build_segment_mixing`), so a packed row equals its documents
run one by one.
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


def chunk_segments(
    segment_ids: torch.Tensor, num_chunks: int, chunk_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk segment id and document-relative chunk index.

    ``segment_ids`` [B, T] integer, one id per document run, with document
    boundaries on chunk boundaries (``data.lm_data.PackedVarlenIterator``
    packs so). Tokens past T up to ``num_chunks * chunk_size`` form a fresh
    segment. Returns (chunk_seg [B, N], rel [B, N]): ``rel[b, n]`` is the
    chunk's index within its own document, the row of the mixing matrix it
    reads."""
    b, t = segment_ids.shape
    pad = num_chunks * chunk_size - t
    if pad:
        fresh = segment_ids.max(dim=1, keepdim=True).values + 1
        segment_ids = torch.cat([segment_ids, fresh.expand(b, pad)], dim=1)
    chunk_seg = segment_ids.reshape(b, num_chunks, chunk_size)[:, :, 0]
    return chunk_seg, _run_index(chunk_seg)


def _run_index(ids: torch.Tensor) -> torch.Tensor:
    """[B, L] ids -> the index of each element within its run of equal
    neighbours (0 where the run starts), int64."""
    b, n = ids.shape
    idx = torch.arange(n, device=ids.device).expand(b, n)
    is_start = torch.ones_like(ids, dtype=torch.bool)
    is_start[:, 1:] = ids[:, 1:] != ids[:, :-1]
    start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return idx - start


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-token position within its own document, [B, T] int64, restarting
    at 0 at every segment boundary: the rotary positions of packed rows."""
    return _run_index(segment_ids)


def build_segment_mixing(
    mixing_matrix: torch.Tensor,
    segment_ids: torch.Tensor,
    num_chunks: int,
    chunk_size: int,
) -> torch.Tensor:
    """Per-row effective mixing matrix of packed rows, [B, N, N] float32,
    lower triangular: chunk i of a document reads chunk j of the same
    document with weight ``M[i - s, j - s]`` (s the document's first chunk)
    and other documents with weight 0. Differentiable in ``mixing_matrix``
    through the gather.

    A document longer than the matrix's L slots reads row and column L - 1
    for its chunks past the last slot, as the JAX package's gather clamps
    its indices; the packer never makes such a document."""
    m = mixing_matrix.reshape(mixing_matrix.shape[0], mixing_matrix.shape[1]).float()
    chunk_seg, rel = chunk_segments(segment_ids, num_chunks, chunk_size)
    rel = rel.clamp(max=m.shape[0] - 1)
    same = chunk_seg[:, :, None] == chunk_seg[:, None, :]
    mvar = m[rel[:, :, None], rel[:, None, :]]
    return torch.tril(torch.where(same, mvar, 0.0))


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
      segment_ids: optional [B, T] document ids of packed rows (boundaries
        on chunk boundaries): documents are isolated exactly, each reading
        the mixing matrix at its own chunk indices.

    Returns (o [B, T, H, Dv], states or None). bf16 inputs compute the
    products in float32 from bf16 operands and round the states and the
    mixed states to bf16 between the phases, as the JAX op does.
    """
    in_dtype = q.dtype
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk**-0.5
    cdt = torch.bfloat16 if in_dtype == torch.bfloat16 else torch.float32

    q, k, v = (_pad_to_chunks(x, chunk_size) for x in (q, k, v))
    n = q.shape[1] // chunk_size
    c = chunk_size
    if segment_ids is None:
        m = prepare_mixing_matrix(mixing_matrix, n)  # [N, N]
    else:
        m = build_segment_mixing(mixing_matrix, segment_ids, n, c)  # [B, N, N]
    m_strict = torch.tril(m, diagonal=-1)
    m_diag = torch.diagonal(m, dim1=-2, dim2=-1)  # [N] or [B, N]

    # float32 math on compute-dtype operands: each product below is the
    # float32-accumulated GEMM of the JAX op, rounded where it rounds
    qf = (q.reshape(b, n, c, h, dk).float() * scale).to(cdt).float()
    kf = k.reshape(b, n, c, h, dk).to(cdt).float()
    vf = v.reshape(b, n, c, h, dv).to(cdt).float()

    states = torch.einsum("bnchk,bnchv->bnhkv", kf, vf)
    mixed = torch.einsum(
        "ij,bjhkv->bihkv" if m.ndim == 2 else "bij,bjhkv->bihkv",
        m_strict.to(cdt).float(), states.to(cdt).float(),
    )
    o_inter = torch.einsum("bnchk,bnhkv->bnchv", qf, mixed.to(cdt).float())
    attn = torch.einsum("bnchk,bnmhk->bnhcm", qf, kf)
    tril = torch.tril(torch.ones(c, c, device=q.device))
    attn = (attn * tril).to(cdt).float()
    o_intra = torch.einsum("bnhcm,bnmhv->bnchv", attn, vf)
    o_intra = o_intra * m_diag[..., :, None, None, None]

    o = (o_inter + o_intra).reshape(b, n * c, h, dv)[:, :t]
    states_out = states.permute(0, 2, 1, 3, 4) if output_final_state else None
    return o.to(in_dtype), states_out


def mhla_chunk_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mixing_matrix: torch.Tensor,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    output_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Loop-form oracle of :func:`mhla_chunk` in float32 (a Python loop over
    chunks), for tests: states [B, H, N, Dk, Dv] when asked."""
    in_dtype = q.dtype
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    scale = dk**-0.5
    q, k, v = (_pad_to_chunks(x.float(), chunk_size) for x in (q, k, v))
    n = q.shape[1] // chunk_size
    m = prepare_mixing_matrix(mixing_matrix, n)

    def chunk_of(x, i):
        return x[:, i * chunk_size:(i + 1) * chunk_size]  # [B, C, H, D]

    states = [torch.einsum("bchk,bchv->bhkv", chunk_of(k, j), chunk_of(v, j)) for j in range(n)]
    tril = torch.tril(torch.ones(chunk_size, chunk_size, device=q.device))
    outs = []
    for i in range(n):
        qi = chunk_of(q, i) * scale
        prefix = q.new_zeros(b, h, dk, dv)
        for j in range(i):
            prefix = prefix + m[i, j] * states[j]
        attn = torch.einsum("bchk,bdhk->bhcd", qi, chunk_of(k, i)) * tril
        o_intra = m[i, i] * torch.einsum("bhcd,bdhv->bchv", attn, chunk_of(v, i))
        outs.append(torch.einsum("bchk,bhkv->bchv", qi, prefix) + o_intra)
    o = torch.cat(outs, dim=1)[:, :t].to(in_dtype)
    return o, (torch.stack(states, dim=2) if output_final_state else None)
