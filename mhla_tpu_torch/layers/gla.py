"""Gated linear attention layers, GLA (per-key-channel low-rank gates) and
simple GLA (one gate per head) (counterpart of ``mhla_tpu/layers/gla.py``;
reference ``fla/layers/gla.py`` and ``fla/layers/simple_gla.py``).

q/k/v projections with optional GQA (k, v and the gates repeated over the
head groups), decay gates ``gk = logsigmoid(proj(x)) / 16``
in float32 (GLA: a low-rank two-layer head ``gk_proj_low`` -> ``gk_proj_up``
with a bias; simple GLA: ``gk_proj``, [B, T, H]), an optional floor
``clamp_min``, the feature map on q and k, and the output through an RMSNorm
with a swish gate (``g_norm_swish_gate``) or a plain one (``g_norm``) before
the output projection.

A call with a state and T <= chunk_size tokens (decode) runs the token
recurrence; every other call the chunked form through
``kernels.gla_chunk.gla_chunk_fused`` (K12 / K12b on the card), on float32
q, k, v and gk, with o cast back to the input's dtype. JAX's layer calls its
jnp chunk op there (``mhla_tpu/layers/gla.py:22-27``, a choice timed on its
TPU); the op and the fused kernels compute the same function in float32, so
the port's layer gives JAX's layer's numbers and runs the kernels.
``GLAState`` is a named tuple, so generation passes it through as it is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.gla_chunk import gla_chunk_fused
from ..ops.feature_maps import get_feature_map
from ..ops.gla_chunk import gla_recurrent
from .fused_dense import dense, fused_projections
from .norms import GatedRMSNorm, RMSNorm


# JAX's ``gate_logit_normalizer`` and ``gate_low_rank_dim`` fields, which no
# configuration changes
GATE_LOGIT_NORMALIZER = 16
GATE_LOW_RANK_DIM = 16


class GLAState(NamedTuple):
    state: torch.Tensor  # [B, H, Dk, Dv] float32


class GatedLinearAttention(nn.Module):
    def __init__(
        self,
        hidden_size: int = 1024,
        expand_k: float = 0.5,
        expand_v: float = 1.0,
        num_heads: int = 4,
        num_kv_heads: Optional[int] = None,
        feature_map: Optional[str] = None,
        use_output_gate: bool = True,
        clamp_min: Optional[float] = None,
        elementwise_affine: bool = True,
        norm_eps: float = 1e-5,
        chunk_size: int = 64,
        simple: bool = False,
        device=None,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.groups = num_heads // (num_kv_heads or num_heads)
        self.key_dim = int(hidden_size * expand_k)
        self.value_dim = int(hidden_size * expand_v)
        self.head_k_dim = self.key_dim // num_heads
        self.head_v_dim = self.value_dim // num_heads
        self.feature_map = get_feature_map(feature_map)
        self.clamp_min = clamp_min
        self.chunk_size = chunk_size
        self.simple = simple
        self.use_output_gate = use_output_gate

        linear = lambda n_in, n_out, bias=False: nn.Linear(  # noqa: E731
            n_in, n_out, bias=bias, device=device)
        self.q_proj = linear(hidden_size, self.key_dim)
        self.k_proj = linear(hidden_size, self.key_dim // self.groups)
        self.v_proj = linear(hidden_size, self.value_dim // self.groups)
        if simple:
            self.gk_proj = linear(hidden_size, num_heads)
        else:
            self.gk_proj_low = linear(hidden_size, GATE_LOW_RANK_DIM)
            self.gk_proj_up = linear(GATE_LOW_RANK_DIM, self.key_dim // self.groups, bias=True)
        if use_output_gate:
            self.g_proj = linear(hidden_size, self.value_dim)
            self.g_norm_swish_gate = GatedRMSNorm(
                self.head_v_dim, eps=norm_eps, elementwise_affine=elementwise_affine,
                device=device)
        else:
            self.g_norm = RMSNorm(self.head_v_dim, eps=norm_eps,
                                  elementwise_affine=elementwise_affine, device=device)
        self.o_proj = linear(self.value_dim, hidden_size)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, T, hidden]
        state: Optional[GLAState] = None,
        use_cache: bool = False,
    ) -> Tuple[torch.Tensor, Optional[GLAState]]:
        b, t, _ = hidden_states.shape
        h, dk, dv = self.num_heads, self.head_k_dim, self.head_v_dim
        # simple GLA's H-wide gate stays out of the fused matmul: beside q, k, v
        # and g it would leave the output's rows misaligned for the GEMM
        names = ["q_proj", "k_proj", "v_proj"] + ([] if self.simple else ["gk_proj_low"])
        if self.use_output_gate:
            names.append("g_proj")
        q, k, v, *rest = fused_projections(hidden_states, self, names)
        if self.simple:
            gk, gate = dense(hidden_states, self.gk_proj), rest
        else:
            gk, gate = dense(rest[0], self.gk_proj_up), rest[1:]
        gk = F.logsigmoid(gk.float()) / GATE_LOGIT_NORMALIZER
        if self.clamp_min is not None:
            gk = torch.maximum(gk, gk.new_tensor(self.clamp_min))  # jnp.maximum's tie gradient

        q = q.unflatten(-1, (h, dk))
        k = k.unflatten(-1, (-1, dk))
        v = v.unflatten(-1, (-1, dv))
        if not self.simple:
            gk = gk.unflatten(-1, (-1, dk))
        if self.groups > 1:
            k = k.repeat_interleave(self.groups, dim=2)
            v = v.repeat_interleave(self.groups, dim=2)
            if not self.simple:
                gk = gk.repeat_interleave(self.groups, dim=2)
        q, k = self.feature_map(q), self.feature_map(k)

        init_s = state.state if state is not None else None
        if state is not None and t <= self.chunk_size:  # decode: the token recurrence
            o, s = gla_recurrent(q, k, v, gk, init_s, output_final_state=use_cache)
        else:  # the chunked form (K12 / K12b on the card), in float32
            o, s = gla_chunk_fused(q.float(), k.float(), v.float(), gk, init_s,
                                   chunk_size=self.chunk_size, output_final_state=use_cache)
            o = o.to(q.dtype)
        new_state = GLAState(state=s) if use_cache else None

        if self.use_output_gate:
            o = self.g_norm_swish_gate(o, gate[0].unflatten(-1, (h, dv)))
        else:
            o = self.g_norm(o)
        return dense(o.flatten(-2), self.o_proj), new_state
