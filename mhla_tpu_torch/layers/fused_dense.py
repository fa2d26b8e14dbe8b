"""Several bias-free projections of one input as ONE concatenated matmul
(counterpart of ``mhla_tpu/layers/fused_dense.py``).

The per-name parameters stay where separate ``nn.Linear`` modules put them
(``<owner>.q_proj.weight`` ...), so state dicts and the weight bridge are
unaffected. The weights are concatenated on every call: caching the
concatenation changed neither the 340M model's decode step nor its prefill
beyond run-to-run spread on an H100 80GB HBM3 at 700 W.

Compute dtype follows flax's ``Dense(dtype=...)``: the activation arrives
in the model's compute dtype and the weight is cast to it, so float32
parameters (training) still compute in bf16 and receive float32 gradients.
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
    ``owner`` with one matmul in x's dtype; returns the per-name outputs
    (views)."""
    linears = [getattr(owner, name) for name in names]
    w = torch.cat([lin.weight.to(x.dtype) for lin in linears], dim=0)
    y = F.linear(x, w)
    return tuple(torch.split(y, [lin.out_features for lin in linears], dim=-1))


def dense(x: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    """An ``nn.Linear`` applied in x's dtype (flax ``Dense(dtype)``): the
    weight and the bias, if any, are cast to it."""
    bias = None if linear.bias is None else linear.bias.to(x.dtype)
    return F.linear(x, linear.weight.to(x.dtype), bias)
