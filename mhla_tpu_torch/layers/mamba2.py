"""Mamba2 layer (SSD) on the scalar-decay chunked GLA op (counterpart of
``mhla_tpu/layers/mamba2.py``).

By the SSD duality a selective state space with one decay per head is gated
linear attention with q_t = C_t and k_t = B_t (shared by the heads), v_t =
dt_t x_t and gk_t = -exp(A_log) dt_t per head. The layer: a fused input
projection split into [z, x, B, C, dt], a causal short convolution (SiLU)
over (x, B, C), dt = softplus(dt + dt_bias), the GLA op with q pre-scaled by
d_state**0.5 (the op scales by d_state**-0.5; SSD does not), the D skip,
a gated RMSNorm with z, and the output projection.

A prefill or training call runs ``gla_chunk_fused`` in float32, as JAX's
op computes (on the card K12 / K12b in their scalar-decay form, in
difference form: finite at any decay, where JAX's factored op overflows
once a chunk's decay passes -88); decode with a cache and at most
``chunk_size`` tokens runs the token recurrence, as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.gla_chunk import gla_chunk_fused
from ..ops.gla_chunk import gla_recurrent
from .fused_dense import dense
from .norms import GatedRMSNorm
from .short_conv import ShortConvolution


# JAX's defaults, the only values its LM builds: the inner width's multiple
# of hidden and the convolution's taps
_EXPAND = 2
_CONV_SIZE = 4


class Mamba2State(NamedTuple):
    state: torch.Tensor  # [B, H, d_state, head_dim] float32
    conv: torch.Tensor  # [B, _CONV_SIZE - 1, d_inner + 2 d_state], pre-activation inputs


class Mamba2(nn.Module):
    def __init__(
        self,
        hidden_size: int = 1024,
        head_dim: int = 64,
        d_state: int = 128,
        chunk_size: int = 64,
        norm_eps: float = 1e-5,
        device=None,
    ):
        super().__init__()
        self.d_inner = _EXPAND * hidden_size
        self.head_dim = head_dim
        self.d_state = d_state
        self.num_heads = self.d_inner // head_dim
        self.chunk_size = chunk_size
        h = self.num_heads
        self.in_proj = nn.Linear(hidden_size, 2 * self.d_inner + 2 * d_state + h, bias=False,
                                 device=device)
        self.conv1d = ShortConvolution(self.d_inner + 2 * d_state, _CONV_SIZE, device=device)
        self.A_log = nn.Parameter(torch.empty(h, device=device))
        self.dt_bias = nn.Parameter(torch.empty(h, device=device))
        self.reset_gate_parameters()
        self.D = nn.Parameter(torch.ones(h, device=device))
        self.norm = GatedRMSNorm(head_dim, eps=norm_eps, device=device)
        self.out_proj = nn.Linear(self.d_inner, hidden_size, bias=False, device=device)

    @torch.no_grad()
    def reset_gate_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """JAX's inits (those of the Gated DeltaNet layer): A ~ U(1e-4, 16),
        A_log = log A; dt log-uniform in [1e-3, 0.1], clipped at 1e-4,
        dt_bias its inverse softplus."""
        a = torch.empty_like(self.A_log).uniform_(1e-4, 16.0, generator=generator)
        self.A_log.copy_(torch.log(a))
        u = torch.empty_like(self.dt_bias).uniform_(0.0, 1.0, generator=generator)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        dt = torch.clamp(dt, min=1e-4)
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, T, hidden]
        state: Optional[Mamba2State] = None,
        use_cache: bool = False,
    ) -> Tuple[torch.Tensor, Optional[Mamba2State]]:
        b, t, _ = hidden_states.shape
        h, hd, ds = self.num_heads, self.head_dim, self.d_state
        z, xbc, dt_raw = dense(hidden_states, self.in_proj).split(
            [self.d_inner, self.d_inner + 2 * ds, h], dim=-1)
        xbc, conv = self.conv1d(xbc, state.conv if state is not None else None, use_cache)
        x, b_in, c_in = xbc.split([self.d_inner, ds, ds], dim=-1)

        dt = F.softplus(dt_raw.float() + self.dt_bias.float())  # [B, T, H]
        gk = -torch.exp(self.A_log.float()) * dt
        # SSD -> GLA, one group: B and C shared by the heads (views of
        # stride 0 over H, so autograd keeps one [B, T, d_state] copy of
        # each); the op's d_state**-0.5 undone on q in the compute dtype, as
        # JAX does
        q1 = c_in * (ds**0.5)
        x4 = x.unflatten(-1, (h, hd))
        v = x4 * dt[..., None].to(x.dtype)
        init_s = state.state if state is not None else None
        if state is not None and t <= self.chunk_size:
            q, k = (u[:, :, None].expand(b, t, h, ds) for u in (q1, b_in))
            y, s = gla_recurrent(q, k, v, gk, init_s, output_final_state=use_cache)
        else:  # float32, as JAX's op computes
            q, k = (u.float()[:, :, None].expand(b, t, h, ds) for u in (q1, b_in))
            y, s = gla_chunk_fused(q, k, v.float(), gk, init_s,
                                   chunk_size=self.chunk_size, output_final_state=use_cache)
            y = y.to(x.dtype)
        y = y + x4 * self.D.to(x.dtype)[:, None]
        y = self.norm(y, z.unflatten(-1, (h, hd)))
        out = dense(y.flatten(-2), self.out_proj)
        return out, (Mamba2State(state=s, conv=conv) if use_cache else None)
