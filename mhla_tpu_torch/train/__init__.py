"""Training: the trainer pieces and the entry points ``lm_train`` (the causal
MHLA LM, ``python -m mhla_tpu_torch.train.lm_train``) and ``wan_train`` (the
Wan video model, ``python -m mhla_tpu_torch.train.wan_train``)."""

from .trainer import (
    AdamW,
    OptimizerConfig,
    TrainState,
    global_norm,
    init_train_state,
    make_optimizer,
    make_schedule,
    make_train_step,
    project_params,
    step_generator,
)

__all__ = [
    "AdamW",
    "OptimizerConfig",
    "TrainState",
    "global_norm",
    "init_train_state",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "project_params",
    "step_generator",
]
