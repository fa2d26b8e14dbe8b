"""Training of the causal MHLA LM: the trainer pieces and the
``lm_train`` entry point (``python -m mhla_tpu_torch.train.lm_train``)."""

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
]
