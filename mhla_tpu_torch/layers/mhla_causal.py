"""Causal MHLA attention layer, the LM attention module (counterpart of
``mhla_tpu/layers/mhla_causal.py``).

q/k/v/g projections (one concatenated matmul), optional causal short
convolutions of q, k and v (k and v at their grouped widths, before the GQA
repeat; SiLU; their caches in the state), optional GQA repeat, feature map
then rotary (K1), a learned lower-triangular chunk mixing matrix
clamped to [1e-5, 1] * tril on every forward, the chunked op (K2-K4) for a
prefill or the recurrent op for decode, and a per-head RMSNorm + swish
output gate before the output projection.

A right-padded batch passes ``attention_mask`` [B, T] (1 real, 0 pad):
padded k and v are zeroed, so they add nothing to any state. Packed varlen
rows pass ``segment_ids`` [B, T]: rotary positions restart at every
document, the short convolutions zero their taps across document
boundaries, and the chunked op isolates the documents (a training-path
feature; decode with them raises ``ValueError``, as in the JAX package).

``rope_scale_base`` turns on XPos: q and k rotate with their own tables
(``rotary_xpos_tables``), two launches of K1 (K1b in the backward) with
different tables. ``mode='fused_recurrent'`` runs every call through the
token recurrence (``mhla_recurrent``), as JAX's mode does. A call with a
cache runs the recurrence whatever its length: JAX sends a continuation
longer than ``chunk_size`` tokens to its chunked op and drops the cache
there (keeping only the rotary offset); the port carries the state, so the
continuation equals JAX's ``fused_recurrent`` over the whole sequence.

Waits for a later port (raises ``NotImplementedError``): head-axis tensor
parallelism.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..kernels import fused_fmap_rope_flat, mhla_chunk_fused_flat
from ..ops import (
    clamp_causal_mixing_matrix,
    get_feature_map,
    init_causal_mixing_matrix,
    mhla_recurrent,
    rotary_cos_sin,
    rotary_xpos_tables,
    segment_positions,
    state_from_chunk,
)
from ..ops.mhla_recurrent import MHLAState
from .fused_dense import dense, fused_projections
from .norms import GatedRMSNormHeadsFlat, RMSNormHeadsFlat
from .short_conv import ShortConvolution

_FLAT_FMAPS = (None, "relu", "elu", "identity", "t2r")


class MHLACausalState(NamedTuple):
    recurrent: MHLAState
    conv_q: Optional[torch.Tensor] = None  # [B, conv_size - 1, key_dim]
    conv_k: Optional[torch.Tensor] = None  # [B, conv_size - 1, key_dim / groups]
    conv_v: Optional[torch.Tensor] = None  # [B, conv_size - 1, value_dim / groups]


class MHLACausal(nn.Module):
    def __init__(
        self,
        hidden_size: int = 1024,
        expand_k: float = 0.5,
        expand_v: float = 1.0,
        num_heads: int = 4,
        num_kv_heads: Optional[int] = None,
        feature_map: Optional[str] = "relu",
        use_short_conv: bool = False,
        conv_size: int = 4,
        use_output_gate: bool = True,
        elementwise_affine: bool = True,
        norm_eps: float = 1e-5,
        chunk_size: int = 64,
        num_slots: int = 32,  # mixing-matrix size; max ctx = num_slots * chunk_size
        mode: str = "chunk",
        rope_base: float = 10000.0,
        rope_scale_base: Optional[float] = None,
        device=None,
    ):
        super().__init__()
        if mode not in ("chunk", "fused_recurrent"):
            raise ValueError(f"mode={mode!r}: 'chunk' or 'fused_recurrent'")
        self.mode = mode
        self.rope_scale_base = rope_scale_base
        self.hidden_size = hidden_size
        self.key_dim = int(hidden_size * expand_k)
        self.value_dim = int(hidden_size * expand_v)
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.groups = num_heads // self.num_kv_heads
        self.head_k_dim = self.key_dim // num_heads
        self.head_v_dim = self.value_dim // num_heads
        self.feature_map = feature_map
        self.use_output_gate = use_output_gate
        self.chunk_size = chunk_size
        self.num_slots = num_slots
        self.rope_base = rope_base

        linear = lambda n_in, n_out: nn.Linear(n_in, n_out, bias=False, device=device)  # noqa: E731
        self.q_proj = linear(hidden_size, self.key_dim)
        self.k_proj = linear(hidden_size, self.key_dim // self.groups)
        self.v_proj = linear(hidden_size, self.value_dim // self.groups)
        if use_output_gate:
            self.g_proj = linear(hidden_size, self.value_dim)
        self.mixing_matrix = nn.Parameter(init_causal_mixing_matrix(num_slots, device=device))
        norm_cls = GatedRMSNormHeadsFlat if use_output_gate else RMSNormHeadsFlat
        norm = norm_cls(num_heads, self.head_v_dim, norm_eps, elementwise_affine, device)
        if use_output_gate:
            self.g_norm_swish_gate = norm
        else:
            self.g_norm = norm
        self.o_proj = linear(self.value_dim, hidden_size)
        self.use_short_conv = use_short_conv
        if use_short_conv:
            self.q_conv1d = ShortConvolution(self.key_dim, conv_size, device=device)
            self.k_conv1d = ShortConvolution(self.key_dim // self.groups, conv_size,
                                             device=device)
            self.v_conv1d = ShortConvolution(self.value_dim // self.groups, conv_size,
                                             device=device)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, T, hidden]
        state: Optional[MHLACausalState] = None,
        use_cache: bool = False,
        attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1 real, 0 pad
        segment_ids: Optional[torch.Tensor] = None,  # [B, T] packed documents
    ) -> Tuple[torch.Tensor, Optional[MHLACausalState]]:
        b, t, _ = hidden_states.shape
        h = self.num_heads
        decode = state is not None
        recurrent = decode or self.mode == "fused_recurrent"
        if recurrent and segment_ids is not None:
            raise ValueError(
                "segment_ids (packed varlen) is a training-path feature; "
                "the recurrent decode path carries one document per row"
            )

        names = ("q_proj", "k_proj", "v_proj") + (("g_proj",) if self.use_output_gate else ())
        projs = fused_projections(hidden_states, self, names)
        q, k, v = projs[:3]
        g_raw = projs[3] if self.use_output_gate else None

        conv_q = conv_k = conv_v = None
        if self.use_short_conv:
            q, conv_q = self.q_conv1d(q, state.conv_q if decode else None, use_cache,
                                      segment_ids)
            k, conv_k = self.k_conv1d(k, state.conv_k if decode else None, use_cache,
                                      segment_ids)
            v, conv_v = self.v_conv1d(v, state.conv_v if decode else None, use_cache,
                                      segment_ids)

        if self.groups > 1:
            kv_heads = self.num_kv_heads
            k = k @ _gqa_expand(k.shape[-1], k.shape[-1] // kv_heads, self.groups,
                                k.dtype, k.device)
            v = v @ _gqa_expand(v.shape[-1], v.shape[-1] // kv_heads, self.groups,
                                v.dtype, v.device)

        fm = self.feature_map if self.feature_map in _FLAT_FMAPS else None
        if fm is None and self.feature_map is not None:
            # head-axis maps (softmax/exp/dpfp) act on the [B, T, H, D] view
            fmap = get_feature_map(self.feature_map)
            q = fmap(q.unflatten(-1, (h, -1))).flatten(-2)
            k = fmap(k.unflatten(-1, (h, -1))).flatten(-2)

        if attention_mask is not None:
            # zeroed k and v add nothing to the chunk states or the intra-chunk
            # terms (and commute with the feature map and the rotation)
            mask = attention_mask[..., None].to(k.dtype)
            k = k * mask
            v = v * mask

        # feature map + rotary after it, one fused pass (K1); packed rows
        # restart the positions at every document; XPos: k's own tables
        max_len = self.num_slots * self.chunk_size
        if self.rope_scale_base is not None:
            cos, sin, cos_k, sin_k = rotary_xpos_tables(
                max_len, self.head_k_dim, self.rope_base, self.rope_scale_base, q.device)
        else:
            cos, sin = rotary_cos_sin(max_len, self.head_k_dim, self.rope_base, q.device)
            cos_k, sin_k = cos, sin
        offset = state.recurrent.t if decode else 0
        positions = segment_positions(segment_ids) if segment_ids is not None else None
        q = fused_fmap_rope_flat(q, cos, sin, h, fm, offset=offset, positions=positions)
        k = fused_fmap_rope_flat(k, cos_k, sin_k, h, fm, offset=offset, positions=positions)

        mixing = clamp_causal_mixing_matrix(self.mixing_matrix)
        rec = None
        if recurrent:
            o4, rec = mhla_recurrent(
                q.unflatten(-1, (h, -1)),
                k.unflatten(-1, (h, -1)),
                v.unflatten(-1, (h, -1)),
                mixing,
                state.recurrent if decode else None,
                chunk_size=self.chunk_size,
            )
            o = o4.flatten(-2)
        else:
            o, states = mhla_chunk_fused_flat(
                q, k, v, mixing, num_heads=h, chunk_size=self.chunk_size,
                output_final_state=use_cache, segment_ids=segment_ids,
            )
            if use_cache:
                rec = state_from_chunk(
                    states, t, mixing, chunk_size=self.chunk_size, num_slots=self.num_slots
                )
        new_state = (
            MHLACausalState(recurrent=rec, conv_q=conv_q, conv_k=conv_k, conv_v=conv_v)
            if use_cache else None
        )

        if self.use_output_gate:
            o = self.g_norm_swish_gate(o, g_raw)
        else:
            o = self.g_norm(o)
        return dense(o, self.o_proj), new_state


def _gqa_expand(kv_dim: int, dh: int, groups: int, dtype, device) -> torch.Tensor:
    """0/1 matrix [kv_dim, kv_dim*groups] mapping head-flat kv features to
    the grouped-repeat layout ([kv0, kv0, ..., kv1, kv1, ...], the order of
    repeating each kv head ``groups`` times on the [B, T, KVH, Dh] view)."""
    src = torch.arange(kv_dim, device=device)
    dst = torch.arange(kv_dim * groups, device=device)
    src_head, src_off = src // dh, src % dh
    dst_head, dst_off = dst // dh, dst % dh
    return (
        (src_head[:, None] == dst_head[None, :] // groups)
        & (src_off[:, None] == dst_off[None, :])
    ).to(dtype)
