"""Numeric monitors (counterpart of ``mhla_tpu/utils/monitor.py``): a
finiteness check over a collection of tensors and the NaN-loss circuit
breaker (the reference aborts after 20 non-finite losses)."""

from __future__ import annotations

import math
from typing import Any, Iterable, Mapping

import torch


def _leaves(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def finite_check(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every floating tensor in the (nested dict / list /
    tuple) tree is finite. Stays on the device; no host sync."""
    flags = [torch.isfinite(x).all() for x in _leaves(tree) if x.is_floating_point()]
    return torch.stack(flags).all() if flags else torch.tensor(True)


class NaNLossBreaker:
    """Abort training after ``patience`` consecutive non-finite losses."""

    def __init__(self, patience: int = 20):
        self.patience = patience
        self.count = 0

    def update(self, loss: float) -> bool:
        """Returns True when training should abort."""
        if math.isfinite(loss):
            self.count = 0
        else:
            self.count += 1
        return self.count >= self.patience
