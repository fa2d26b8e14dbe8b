"""Gated DeltaNet layer (counterpart of ``mhla_tpu/layers/gated_deltanet.py``;
reference ``fla/layers/gated_deltanet.py``).

q/k/v projections through causal short convolutions (SiLU), L2-normed q/k
(inside the op), a mamba2-style decay ``g = -exp(A_log) softplus(a_proj(x) +
dt_bias)`` and ``beta = sigmoid(b_proj(x))``, both float32, the gated
delta rule, and an RMSNorm with a swish output gate before the output
projection. This is the one configuration the LM builds (JAX's defaults:
gate, three 4-tap SiLU short convs, beta in (0, 1)); the JAX layer's other
switches are not ported.

A call with T <= 64 tokens (decode, short prefills) runs the exact token
recurrence; a longer one the chunked WY form through
``kernels.delta_chunk.gated_delta_chunk_fused`` (K11 / K11b on the card), as
the JAX layer does. ``DeltaNetState`` is a named tuple, so generation passes
it through as it is.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.delta_chunk import gated_delta_chunk_fused
from ..ops.delta_rule import gated_delta_recurrent
from .fused_dense import dense, fused_projections
from .norms import GatedRMSNorm
from .short_conv import ShortConvolution


class DeltaNetState(NamedTuple):
    state: torch.Tensor  # [B, H, Dk, Dv] float32
    conv_q: torch.Tensor  # [B, 3, H*Dk], the short convs' caches
    conv_k: torch.Tensor
    conv_v: torch.Tensor  # [B, 3, H*Dv]


class GatedDeltaNet(nn.Module):
    def __init__(
        self,
        hidden_size: int = 1024,
        head_dim: int = 128,
        num_heads: int = 8,
        expand_v: float = 1.0,
        norm_eps: float = 1e-5,
        device=None,
    ):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_k_dim = head_dim
        self.head_v_dim = int(head_dim * expand_v)
        self.key_dim = num_heads * head_dim
        self.value_dim = num_heads * self.head_v_dim

        linear = lambda n_in, n_out: nn.Linear(n_in, n_out, bias=False, device=device)  # noqa: E731
        self.q_proj = linear(hidden_size, self.key_dim)
        self.k_proj = linear(hidden_size, self.key_dim)
        self.v_proj = linear(hidden_size, self.value_dim)
        self.q_conv1d = ShortConvolution(self.key_dim, device=device)
        self.k_conv1d = ShortConvolution(self.key_dim, device=device)
        self.v_conv1d = ShortConvolution(self.value_dim, device=device)
        self.a_proj = linear(hidden_size, num_heads)
        self.b_proj = linear(hidden_size, num_heads)
        self.A_log = nn.Parameter(torch.empty(num_heads, device=device))
        self.dt_bias = nn.Parameter(torch.empty(num_heads, device=device))
        self.reset_gate_parameters()
        self.g_proj = linear(hidden_size, self.value_dim)
        self.o_norm = GatedRMSNorm(self.head_v_dim, eps=norm_eps, device=device)
        self.o_proj = linear(self.value_dim, hidden_size)

    @torch.no_grad()
    def reset_gate_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX inits, drawn from ``generator`` (the default generator of
        the parameters' device when None): A ~ U(1e-4, 16), A_log = log A;
        dt log-uniform in [1e-3, 0.1], clipped at 1e-4, dt_bias its inverse
        softplus, so softplus(dt_bias) == dt at init."""
        a = torch.empty_like(self.A_log).uniform_(1e-4, 16.0, generator=generator)
        self.A_log.copy_(torch.log(a))
        u = torch.empty_like(self.dt_bias).uniform_(0.0, 1.0, generator=generator)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        dt = torch.clamp(dt, min=1e-4)
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, T, hidden]
        state: Optional[DeltaNetState] = None,
        use_cache: bool = False,
    ) -> Tuple[torch.Tensor, Optional[DeltaNetState]]:
        b, t, _ = hidden_states.shape
        h, dk, dv = self.num_heads, self.head_k_dim, self.head_v_dim
        names = ("q_proj", "k_proj", "v_proj", "a_proj", "b_proj", "g_proj")
        q, k, v, a, b_raw, gate = fused_projections(hidden_states, self, names)

        q, conv_q = self.q_conv1d(q, state.conv_q if state else None, use_cache)
        k, conv_k = self.k_conv1d(k, state.conv_k if state else None, use_cache)
        v, conv_v = self.v_conv1d(v, state.conv_v if state else None, use_cache)

        g = -torch.exp(self.A_log.float()) * F.softplus(a.float() + self.dt_bias.float())
        beta = torch.sigmoid(b_raw.float())

        q = q.unflatten(-1, (h, dk))
        k = k.unflatten(-1, (h, dk))
        v = v.unflatten(-1, (h, dv))
        init_s = state.state if state is not None else None
        if t <= 64:  # decode and short prefills: the exact token recurrence
            o, s = gated_delta_recurrent(q, k, v, g, beta, initial_state=init_s,
                                         output_final_state=use_cache)
        else:  # the chunked WY form (K11 / K11b on the card)
            o, s = gated_delta_chunk_fused(q, k, v, g, beta, initial_state=init_s,
                                           output_final_state=use_cache)
        new_state = (
            DeltaNetState(state=s, conv_q=conv_q, conv_k=conv_k, conv_v=conv_v)
            if use_cache else None
        )
        o = self.o_norm(o, gate.unflatten(-1, (h, dv)))
        return dense(o.flatten(-2), self.o_proj), new_state
