"""Training: the trainer pieces and the entry points ``lm_train`` (the causal
MHLA LM, ``python -m mhla_tpu_torch.train.lm_train``), ``wan_train`` (the
Wan video model, ``python -m mhla_tpu_torch.train.wan_train``),
``vit_train`` (the MHLA ViT classifier) and ``dit_train`` (the MHLA DiT)."""

from .lora import (
    DEFAULT_TARGETS,
    apply_lora,
    init_lora,
    lora_param_count,
    lora_state,
    merge_lora,
)
from .trainer import (
    AdamW,
    OptimizerConfig,
    TrainState,
    auto_scale_lr,
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
    "DEFAULT_TARGETS",
    "OptimizerConfig",
    "TrainState",
    "apply_lora",
    "auto_scale_lr",
    "global_norm",
    "init_lora",
    "init_train_state",
    "lora_param_count",
    "lora_state",
    "merge_lora",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "project_params",
    "step_generator",
]
