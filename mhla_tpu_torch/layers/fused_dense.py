"""Several bias-free projections of one input as ONE concatenated matmul
(counterpart of ``mhla_tpu/layers/fused_dense.py``).

The per-name parameters stay where separate ``nn.Linear`` modules put them
(``<owner>.q_proj.weight`` ...), so state dicts and the weight bridge are
unaffected. The weights are concatenated on every call: caching the
concatenation changed neither the 340M model's decode step nor its prefill
beyond run-to-run spread on an H100 80GB HBM3 at 700 W.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def fused_projections(
    x: torch.Tensor, owner: nn.Module, names: Sequence[str]
) -> Tuple[torch.Tensor, ...]:
    """Project ``x`` by the bias-free ``nn.Linear`` children ``names`` of
    ``owner`` with one matmul; returns the per-name outputs (views)."""
    linears = [getattr(owner, name) for name in names]
    w = torch.cat([lin.weight for lin in linears], dim=0)
    y = F.linear(x.to(w.dtype), w)
    return tuple(torch.split(y, [lin.out_features for lin in linears], dim=-1))
