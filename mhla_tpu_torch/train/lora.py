"""LoRA fine-tuning (counterpart of ``mhla_tpu/train/lora.py``).

For every 2-D projection weight whose module is named in ``targets``,
low-rank factors A and B are created; :func:`merge_lora` gives the effective
weights ``W + (alpha / rank) * A @ B`` for the unchanged model, and only the
factors are trained.

Orientation: A is ``[in, rank]`` and B is ``[rank, out]``, as in the JAX
package, whose ``Dense`` kernels are ``[in, out]``. ``nn.Linear.weight`` is
``[out, in]``, so the product is transposed before it is added:
``weight + (alpha / rank) * (A @ B).T``. Factors of a JAX LoRA tree therefore
carry over as they are, under the names of
``mhla_tpu_torch.models.wan_params_from_jax``.

:func:`apply_lora` prepares a model for the trainer: it freezes the base and
makes every targeted weight a function of the base weight and its factors,
which alone are trained; on resume the frozen base comes from its own source
(a seeded init here) and the checkpoint restores the factors.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

DEFAULT_TARGETS = ("q", "k", "v", "o", "q_proj", "k_proj", "v_proj", "o_proj",
                   "to_qkv", "to_out")

Lora = Dict[str, Dict[str, torch.Tensor]]  # parameter name -> {"a": [in, r], "b": [r, out]}


def _is_target(name: str, p: torch.Tensor, targets: Sequence[str]) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-1] == "weight" and p.ndim == 2 and parts[-2] in targets


def init_lora(
    params: Mapping[str, torch.Tensor],
    generator: torch.Generator,
    rank: int = 16,
    targets: Sequence[str] = DEFAULT_TARGETS,
) -> Lora:
    """Factors for each targeted ``<module>.weight`` [out, in] of ``params``
    (a ``named_parameters`` or state-dict mapping): A ``[in, rank]`` normal /
    rank from ``generator`` (which lives on the parameters' device), B
    ``[rank, out]`` zero, so training starts from the base model. float32."""
    lora: Lora = {}
    for name, p in params.items():
        if _is_target(name, p, targets):
            n_out, n_in = p.shape
            a = torch.randn(n_in, rank, generator=generator, device=p.device) / rank
            lora[name] = {"a": a, "b": torch.zeros(rank, n_out, device=p.device)}
    return lora


def _merge(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """``w + (alpha / rank) * (a @ b).T`` in float32, cast to w's dtype."""
    return (w.float() + (a @ b).T * (alpha / a.shape[1])).to(w.dtype)


def merge_lora(
    params: Mapping[str, torch.Tensor], lora: Lora, alpha: float = 16.0
) -> Dict[str, torch.Tensor]:
    """Effective parameters: ``W + (alpha / rank) * (A @ B).T`` in float32,
    cast to W's dtype, where ``lora`` has factors; the others as they are.
    Differentiable in the factors."""
    missing = set(lora) - set(params)
    if missing:
        raise KeyError(f"lora factors for parameters the model lacks: {sorted(missing)}")
    return {name: _merge(p, lora[name]["a"], lora[name]["b"], alpha) if name in lora else p
            for name, p in params.items()}


def lora_param_count(lora: Lora) -> int:
    return sum(t.numel() for factors in lora.values() for t in factors.values())


class _LoraWeight(nn.Module):
    """Parametrization of one projection weight [out, in]: the frozen weight
    plus ``(alpha / rank) * (a @ b).T``, as :func:`merge_lora` computes it."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, alpha: float):
        super().__init__()
        self.a, self.b = nn.Parameter(a), nn.Parameter(b)
        self.alpha = alpha

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return _merge(w, self.a, self.b, self.alpha)


def apply_lora(
    model: nn.Module,
    generator: torch.Generator,
    rank: int = 16,
    alpha: float = 16.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
) -> nn.Module:
    """Freeze every parameter of ``model`` and give each targeted weight its
    factors from :func:`init_lora`, in place, as a
    ``torch.nn.utils.parametrize`` parametrization: ``module.weight`` is then
    the merged weight, computed where it is read (so a block that is
    recomputed in the backward merges again), the frozen weight is
    ``module.parametrizations.weight.original`` and the factors, the model's
    only parameters that still want a gradient, are
    ``module.parametrizations.weight[0].a`` and ``.b``. The trainer's
    optimizer, EMA, projections and checkpoints take the parameters that want
    a gradient, so they hold the factors alone, as the JAX trainer's state
    holds the LoRA tree alone."""
    model.requires_grad_(False)
    lora = init_lora(dict(model.named_parameters()), generator, rank, targets)
    if not lora:
        raise ValueError(f"no weight of the model is named by the LoRA targets {targets}")
    for name, f in lora.items():
        module = model.get_submodule(name.rpartition(".")[0])
        parametrize.register_parametrization(module, "weight", _LoraWeight(f["a"], f["b"], alpha))
    return model


def lora_state(model: nn.Module) -> Lora:
    """The factors :func:`apply_lora` put into ``model``, under the names of
    the weights they belong to."""
    return {
        f"{name}.weight": {"a": module.parametrizations.weight[0].a,
                           "b": module.parametrizations.weight[0].b}
        for name, module in model.named_modules()
        if parametrize.is_parametrized(module, "weight")
    }
