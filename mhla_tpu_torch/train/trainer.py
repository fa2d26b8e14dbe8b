"""Trainer pieces: optimizer, schedule, EMA, gradient accumulation and the
post-step parameter projections (counterpart of
``mhla_tpu/train/trainer.py``).

The optimizer reproduces the JAX package's optax chain rather than
``torch.optim``, so that a step here and there give the same parameters:

- ``make_schedule``: optax ``join_schedules([linear warmup, cosine |
  linear | constant], [warmup_steps])``, evaluated at the count before the
  step (so the first step runs at learning rate 0, as optax does);
- ``make_optimizer``: ``clip_by_global_norm`` (``g / norm * max`` when
  ``norm >= max``, no epsilon), then ``adamw`` (bias-corrected Adam, decay
  ``wd * p`` added to the update of every parameter, then ``-lr``), and with
  ``accum_steps > 1`` optax ``MultiSteps``: the running mean of the
  micro-batch gradients, one inner step every ``accum_steps`` calls and
  zero updates in between;
- ``project_params``: ``tril(clip(M, 1e-5, 1))`` on every
  ``mixing_matrix`` and ``clip(W, 0, 1)`` on every trainable vision
  block-mixing weight (``piece_attn`` / ``block_attn``), in place after each
  step.

Parameters are updated in place with ``torch._foreach_*`` ops (one launch
per op for all tensors, where a per-tensor loop would pay eager PyTorch's
host cost hundreds of times per step). ``lion``, ``came`` and the 8-bit
optimizers are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn


@dataclasses.dataclass
class OptimizerConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 1000
    total_steps: int = 100_000
    schedule: str = "cosine"  # cosine | constant | linear
    min_lr_ratio: float = 0.1
    accum_steps: int = 1
    optimizer: str = "adamw"  # adamw (lion | came | *8bit are not ported)


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule(init, end, steps) at ``count``."""
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Learning rate as a function of the update count (0 for the first)."""
    lr = cfg.learning_rate
    warmup_steps = max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")

    def decay(count: int) -> float:
        if cfg.schedule == "cosine":
            c = min(count, decay_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
            return lr * ((1.0 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)
        if cfg.schedule == "linear":
            return _linear(lr, lr * cfg.min_lr_ratio, decay_steps, count)
        return lr

    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            return _linear(0.0, lr, warmup_steps, count)
        return decay(count - cfg.warmup_steps)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), float32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """optax ``chain(clip_by_global_norm, adamw(schedule))``, wrapped in
    ``MultiSteps`` when ``accum_steps > 1``, over a fixed list of float32
    parameters updated in place."""

    def __init__(self, params: List[torch.Tensor], cfg: OptimizerConfig):
        if cfg.optimizer != "adamw":
            raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not ported yet")
        self.params = list(params)
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.count = 0  # inner (applied) updates
        self.mini_step = 0  # micro-batches accumulated since the last update
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = (
            [torch.zeros_like(p) for p in self.params] if cfg.accum_steps > 1 else None
        )

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """Apply one optimizer call for ``grads`` (one per parameter, float32
        ones clipped in place). ``norm`` is their global norm where the
        caller has it already; with ``accum_steps > 1`` the clip takes the
        norm of the accumulated mean instead."""
        cfg = self.cfg
        grads = [g.float() for g in grads]
        if self.acc is not None:
            # MultiSteps' mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step += 1
            if self.mini_step < cfg.accum_steps:
                return
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
            norm = None
        if cfg.grad_clip:
            if norm is None:
                norm = global_norm(grads)
            # optax: select(norm < max, g, g / norm * max), decided on the
            # device (g / 1 * 1 is g exactly) so the host never waits here
            keep = norm < cfg.grad_clip
            torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0, cfg.grad_clip))
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = cfg.beta1, cfg.beta2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, 1 - b1**self.count)
        nu_hat = torch._foreach_div(self.nu, 1 - b2**self.count)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, cfg.eps)
        upd = torch._foreach_div(mu_hat, nu_hat)
        if cfg.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=cfg.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "count": self.count, "mini_step": self.mini_step,
            "mu": self.mu, "nu": self.nu, "acc": self.acc,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for dst_list, key in ((self.mu, "mu"), (self.nu, "nu"), (self.acc, "acc")):
            if dst_list is not None:
                with torch.no_grad():
                    for dst, src in zip(dst_list, state[key]):
                        dst.copy_(src)


def auto_scale_lr(base_lr: float, effective_batch_size: int, base_batch_size: int = 256) -> float:
    """The linear learning-rate scaling rule: ``base_lr`` holds at
    ``base_batch_size`` and grows in proportion to the effective batch."""
    return base_lr * effective_batch_size / base_batch_size


def make_optimizer(params: List[torch.Tensor], cfg: OptimizerConfig) -> AdamW:
    return AdamW(params, cfg)


@torch.no_grad()
def project_params(model: nn.Module) -> None:
    """Post-step projections, in place: every causal ``mixing_matrix`` ->
    tril clamped to [1e-5, 1]; every trainable vision block-mixing weight
    (a parameter under ``piece_attn`` or ``block_attn``) -> clamped to [0, 1].
    Frozen parameters (``requires_grad`` false) are left as they are."""
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        parts = name.split(".")
        if parts[-1] == "mixing_matrix":
            p.copy_(torch.tril(p.clamp(1e-5, 1.0)))
        elif "piece_attn" in parts or "block_attn" in parts:
            p.clamp_(0.0, 1.0)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: AdamW
    ema: Optional[Dict[str, torch.Tensor]] = None


def init_train_state(model: nn.Module, cfg: OptimizerConfig, ema: bool = False) -> TrainState:
    """The state of a run over the parameters of ``model`` that want a
    gradient: they alone reach the optimizer and the EMA."""
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    return TrainState(
        step=0,
        model=model,
        optimizer=make_optimizer(list(trainable.values()), cfg),
        ema={n: p.detach().clone() for n, p in trainable.items()} if ema else None,
    )


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of training step ``step`` (0 for the first) of a run
    seeded with ``seed``, on ``device``: a function of the two numbers alone
    (the JAX trainer folds the step into its key likewise), so a resumed run
    draws what an unbroken one would."""
    return torch.Generator(device).manual_seed(seed * 1_000_003 + step)


def make_train_step(
    loss_fn: Callable[..., Tuple[torch.Tensor, dict]],
    ema_decay: Optional[float] = None,
    seed: Optional[int] = None,
):
    """``step(state, batch) -> (state, metrics)``: gradients of
    ``loss_fn(model, batch) -> (loss, metrics)``, one optimizer call, the
    projections, the EMA; ``metrics`` gains ``loss`` and ``grad_norm`` (of
    the raw gradients, before clipping), as 0-d tensors on the device. With
    a ``seed`` the loss draws random numbers: it is called as
    ``loss_fn(model, batch, generator)`` with :func:`step_generator` of
    ``state.step`` on the device of the model's parameters."""

    def step(state: TrainState, batch: Any) -> Tuple[TrainState, dict]:
        opt = state.optimizer
        for p in opt.params:
            p.grad = None
        if seed is None:
            loss, metrics = loss_fn(state.model, batch)
        else:
            gen = step_generator(seed, state.step, opt.params[0].device)
            loss, metrics = loss_fn(state.model, batch, gen)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in opt.params]
        gnorm = global_norm(grads)
        opt.step(grads, gnorm)
        project_params(state.model)
        if state.ema is not None and ema_decay is not None:
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    if p.requires_grad:
                        e = state.ema[name]
                        e.mul_(ema_decay).add_(p.to(e.dtype), alpha=1 - ema_decay)
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = gnorm
        state.step += 1
        return state, metrics

    return step
