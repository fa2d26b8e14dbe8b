"""Causal-LM pretraining entry point (counterpart of
``mhla_tpu/train/lm_train.py``): build the model from the config, seed its
weights, pack tokens, run the train step with clipping, projections and
EMA, log windowed averages, checkpoint with ``latest`` resume, and trip
the NaN circuit breaker.

Usage:
    python -m mhla_tpu_torch.train.lm_train [config.yaml] [--train.max_steps=100] ...

The defaults are the 340M model (``MHLALMConfig()``) with float32
parameters and bf16 compute (``bf16: true``), on ``--device=cuda``. A
machine without PyYAML takes no yaml file: the dataclass defaults plus
``--a.b=v`` overrides describe every run. ``--model_json=<file>`` replaces
the model section with a reference-format model json (``attn`` there makes
a hybrid with softmax layers); ``--train.varlen=true`` packs several
documents per row with exact boundaries (segment ids; the loss reads each
row's ``targets``). ``--model.attn_extends=gated_deltanet`` trains the Gated
DeltaNet baseline at the same widths (K11 / K11b on the card),
``--model.attn_extends=gla`` or ``simple_gla`` the GLA baselines (K12 / K12b),
``mamba2`` the Mamba2 baseline (K12 / K12b in their scalar-decay form),
``mamba`` the Mamba baseline (its plain selective scan) and ``linear_attn``
plain causal linear attention; none of them with ``--train.varlen``.
``--model.use_l2warp=true`` adds the L2Wrap max-logit pull to the loss's
backward (on the materialized logits, as JAX applies it). For a tiny run on
the CPU:

    python -m mhla_tpu_torch.train.lm_train --device=cpu --model.num_hidden_layers=2 \
        --model.hidden_size=512 --model.num_heads=2 --model.vocab_size=100 \
        --train.batch_size=2 --train.seq_len=130 --train.max_steps=4 --work_dir=/tmp/lm

(add ``--model.attn_extends=gated_deltanet`` for the Gated DeltaNet LM, or
``--model.attn_extends=gla`` for the GLA LM: at hidden 512 and 2 heads their
Dk is 128, so a prefill of 130 tokens takes the fused chunked path).

Not ported (``NotImplementedError``): data and tensor parallelism
(``n_data``/``n_tensor`` > 1).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import torch

from ..data import make_lm_dataloader
from ..models import MHLAForCausalLM, MHLALMConfig, cross_entropy_loss, init_lm_params
from ..ops.losses import l2_warp
from ..utils.checkpoint import (
    checkpoint_step,
    load_checkpoint,
    resolve_resume_path,
    save_checkpoint,
)
from ..utils.config import dump_config, parse_cli
from ..utils.logging import LogBuffer, Throughput, WandbSink, get_root_logger
from ..utils.monitor import NaNLossBreaker
from .trainer import OptimizerConfig, init_train_state, make_train_step


@dataclasses.dataclass
class TrainLoopConfig:
    max_steps: int = 100
    batch_size: int = 8
    seq_len: int = 2048
    log_interval: int = 10
    save_interval: int = 1000
    ema_decay: Optional[float] = None
    seed: int = 42
    n_data: int = 1
    n_tensor: int = 1
    resume_from: Optional[str] = "latest"
    nan_patience: int = 20
    varlen: bool = False


@dataclasses.dataclass
class LMTrainConfig:
    model: MHLALMConfig = dataclasses.field(default_factory=MHLALMConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    train: TrainLoopConfig = dataclasses.field(default_factory=TrainLoopConfig)
    work_dir: str = "work_dirs/lm"
    model_json: Optional[str] = None
    wandb: bool = False
    bf16: bool = True
    device: str = "cuda"


def _check_ported(cfg: LMTrainConfig) -> None:
    for what, unported in (
        ("data parallelism (train.n_data > 1)", cfg.train.n_data > 1),
        ("tensor parallelism (train.n_tensor > 1)", cfg.train.n_tensor > 1),
    ):
        if unported:
            raise NotImplementedError(f"{what} is not ported yet")


def lm_loss(model, batch):
    """Shifted next-token cross-entropy of ``model`` on token ids ``batch``,
    or on a packed varlen batch (a dict of ``input_ids``, ``segment_ids`` and
    ``targets``: documents isolated, the loss on ``targets``); with the
    config's ``use_l2warp`` through :func:`ops.losses.l2_warp` on the
    logits."""
    if isinstance(batch, dict):
        logits, _ = model(batch["input_ids"], segment_ids=batch["segment_ids"])
        loss = cross_entropy_loss(logits, batch["targets"])
    else:
        logits, _ = model(batch)
        loss = cross_entropy_loss(logits, batch)
    if model.config.use_l2warp:
        loss = l2_warp(loss, logits)
    return loss, {}


def to_device(raw, device: torch.device):
    """A numpy batch (an array, or the dict of a varlen batch) as int64
    tensors on ``device``."""
    if isinstance(raw, dict):
        return {k: torch.from_numpy(v).to(device=device, dtype=torch.long) for k, v in raw.items()}
    return torch.from_numpy(raw).to(device=device, dtype=torch.long)


def build_training(cfg: LMTrainConfig):
    """The seeded model, its train state, the train step and the token
    stream that ``cfg`` describes: ``(model, state, step_fn, data)``.
    With ``cfg.bf16`` the model computes in bf16 over float32 parameters;
    ``cfg.model_json`` replaces ``cfg.model``."""
    _check_ported(cfg)
    if cfg.model_json:
        cfg.model = MHLALMConfig.from_json(cfg.model_json)
    if cfg.bf16:
        cfg.model = dataclasses.replace(cfg.model, dtype=torch.bfloat16)
    device = torch.device(cfg.device)
    model = MHLAForCausalLM(cfg.model, device=device)
    init_lm_params(model, torch.Generator(device).manual_seed(cfg.train.seed))
    state = init_train_state(model, cfg.optimizer, ema=cfg.train.ema_decay is not None)
    step_fn = make_train_step(lm_loss, ema_decay=cfg.train.ema_decay)
    data = make_lm_dataloader(
        cfg.train.seq_len, cfg.train.batch_size, cfg.model.vocab_size,
        seed=cfg.train.seed, varlen=cfg.train.varlen, chunk_size=cfg.model.chunk_size,
        num_slots=cfg.model.num_slots,
    )
    return model, state, step_fn, data


def main(argv=None) -> dict:
    """Train; returns ``final_loss``, ``params`` (the parameter count),
    ``model``, ``start_step``, per-step ``losses``, ``grad_norms`` and
    ``step_seconds`` (host clock, each ending in a device sync), and
    ``save_seconds`` of the final checkpoint."""
    cfg = parse_cli(LMTrainConfig, argv if argv is not None else sys.argv[1:])
    model, state, step_fn, data = build_training(cfg)
    device = torch.device(cfg.device)
    logger = get_root_logger(f"{cfg.work_dir}/train.log")
    dump_config(cfg, f"{cfg.work_dir}/config.yaml")
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"params: {n_params / 1e6:.1f}M on {device}, compute {cfg.model.dtype}")

    start_step = 0
    if cfg.train.resume_from:
        path = resolve_resume_path(cfg.work_dir, cfg.train.resume_from)
        if path:
            state = load_checkpoint(path, state)
            start_step = checkpoint_step(path)
            logger.info(f"resumed from {path} at step {start_step}")

    buf = LogBuffer()
    thr = Throughput(cfg.train.max_steps)
    breaker = NaNLossBreaker(cfg.train.nan_patience)
    wb = WandbSink(cfg.wandb, "mhla_tpu_torch", "lm_train", cfg)
    losses, grad_norms, step_seconds = [], [], []
    last_loss = float("nan")

    for step_idx in range(start_step, cfg.train.max_steps):
        batch = to_device(next(data), device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        last_loss = float(metrics["loss"])  # waits for the step on the device
        grad_norm = float(metrics["grad_norm"])
        step_seconds.append(time.perf_counter() - t0)
        losses.append(last_loss)
        grad_norms.append(grad_norm)
        buf.update(loss=last_loss, grad_norm=grad_norm)
        if breaker.update(last_loss):
            logger.error("NaN circuit breaker tripped; aborting")
            break
        if (step_idx + 1) % cfg.train.log_interval == 0:
            avg = buf.average()
            speed = thr.step(step_idx + 1, cfg.train.batch_size * cfg.train.seq_len)
            logger.info(
                f"step {step_idx + 1}/{cfg.train.max_steps} "
                f"loss {avg['loss']:.4f} gnorm {avg['grad_norm']:.3f} "
                f"{speed['items_per_sec']:.0f} tok/s"
            )
            wb.log({**avg, **speed}, step_idx + 1)
        if (step_idx + 1) % cfg.train.save_interval == 0:
            save_checkpoint(cfg.work_dir, step_idx + 1, state)

    t0 = time.perf_counter()
    save_checkpoint(cfg.work_dir, cfg.train.max_steps, state)
    save_seconds = time.perf_counter() - t0
    wb.finish()
    return {
        "final_loss": last_loss,
        "params": n_params,
        "model": model,
        "start_step": start_step,
        "losses": losses,
        "grad_norms": grad_norms,
        "step_seconds": step_seconds,
        "save_seconds": save_seconds,
    }


if __name__ == "__main__":
    main()
