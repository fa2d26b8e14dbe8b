"""Mamba-1 layer (selective state space, S6; counterpart of
``mhla_tpu/layers/mamba.py``).

``in_proj -> (x, z)``; a causal short convolution of x (SiLU, with bias);
``x_proj -> (dt_low, B, C)``; ``dt = softplus(dt_proj(dt_low))``; the
diagonal scan with ``A = -exp(A_log)`` and skip ``D``; ``out =
out_proj(y * silu(z))``. A call of at most 8 tokens runs the token
recurrence, a longer one the chunked scan (``ops.selective_scan``), as in
JAX. Both are plain PyTorch, as JAX runs them in jnp.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.selective_scan import selective_scan_chunk, selective_scan_recurrent
from .fused_dense import dense
from .short_conv import ShortConvolution


# JAX's defaults, the only values its LM builds: state size N, the inner
# width's multiple of hidden, the convolution's taps; dt's rank is
# ceil(hidden / 16); the projections take no bias, the convolution one
_STATE_SIZE = 16
_EXPAND = 2
_CONV_SIZE = 4


class MambaState(NamedTuple):
    state: torch.Tensor  # [B, Dm, N] float32
    conv: torch.Tensor  # [B, _CONV_SIZE - 1, Dm]


def _a_log_init(dm: int, n: int, device=None) -> torch.Tensor:
    """S4D-real init: A[d, n] = n + 1, A_log = log A [Dm, N]."""
    return torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device)).expand(
        dm, n).clone()


def _dt_proj_bias_init(bias: torch.Tensor, generator=None, time_step_min: float = 0.001,
                       time_step_max: float = 0.1, floor: float = 1e-4) -> None:
    """In place: softplus(bias) log-uniform in [min, max], clipped at floor."""
    u = torch.empty_like(bias).uniform_(0.0, 1.0, generator=generator)
    dt = torch.exp(u * (math.log(time_step_max) - math.log(time_step_min))
                   + math.log(time_step_min))
    dt = torch.clamp(dt, min=floor)
    bias.copy_(dt + torch.log(-torch.expm1(-dt)))


class Mamba(nn.Module):
    def __init__(self, hidden_size: int = 1024, chunk_size: int = 64, device=None):
        super().__init__()
        dm, n = _EXPAND * hidden_size, _STATE_SIZE
        self.chunk_size = chunk_size
        self.dt_rank = math.ceil(hidden_size / 16)
        self.in_proj = nn.Linear(hidden_size, 2 * dm, bias=False, device=device)
        self.conv1d = ShortConvolution(dm, _CONV_SIZE, use_bias=True, device=device)
        self.x_proj = nn.Linear(dm, self.dt_rank + 2 * n, bias=False, device=device)
        self.dt_proj = nn.Linear(self.dt_rank, dm, bias=True, device=device)
        self.A_log = nn.Parameter(_a_log_init(dm, n, device))
        self.D = nn.Parameter(torch.ones(dm, device=device))
        self.out_proj = nn.Linear(dm, hidden_size, bias=False, device=device)
        self.reset_dt_parameters()

    @torch.no_grad()
    def reset_dt_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """JAX's inits of dt_proj: weight U(-dt_rank**-0.5, dt_rank**-0.5)
        and the bias of :func:`_dt_proj_bias_init`."""
        std = self.dt_rank**-0.5
        self.dt_proj.weight.uniform_(-std, std, generator=generator)
        _dt_proj_bias_init(self.dt_proj.bias, generator)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, T, hidden]
        state: Optional[MambaState] = None,
        use_cache: bool = False,
    ) -> Tuple[torch.Tensor, Optional[MambaState]]:
        t = hidden_states.shape[1]
        n = _STATE_SIZE
        x, z = dense(hidden_states, self.in_proj).chunk(2, dim=-1)
        x, conv = self.conv1d(x, state.conv if state is not None else None, use_cache)
        dt_low, b_in, c_in = dense(x, self.x_proj).split([self.dt_rank, n, n], dim=-1)
        dt = F.softplus(dense(dt_low, self.dt_proj).float())
        a = -torch.exp(self.A_log.float())
        init_s = state.state if state is not None else None
        if t <= 8:
            y, s = selective_scan_recurrent(x, dt, a, b_in, c_in, self.D, initial_state=init_s,
                                            output_final_state=use_cache)
        else:
            y, s = selective_scan_chunk(x, dt, a, b_in, c_in, self.D, initial_state=init_s,
                                        chunk_size=self.chunk_size,
                                        output_final_state=use_cache)
        out = dense(y * F.silu(z), self.out_proj)
        return out, (MambaState(state=s, conv=conv) if use_cache else None)
