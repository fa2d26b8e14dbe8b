"""DiT latent-diffusion training and CFG sampling (counterpart of
``mhla_tpu/train/dit_train.py``): a class-conditional MHLA DiT trained on
VAE latents with the epsilon MSE plus the learned-range VB term, label
dropout to the null class, AdamW, EMA and the post-step clamp of the
trainable mixing matrices to [0, 1] (``project_params``); CFG sampling with
the respaced ancestral loop. ``train.finetune_from`` starts from a standard
DiT checkpoint (``models/convert_dit.py``).

Latents come from extracted ``.npy`` pairs or ``.npz`` files
(``feature_dir``) or a seeded synthetic stream; the weights from a seeded
init. The timesteps, the noise and the label dropout of step i come from
the step's generator (``trainer.step_generator``), in that order.

Usage:
    python -m mhla_tpu_torch.train.dit_train [configs/dit_s2.yaml] [--train.max_steps=...]

``--device=cuda`` is the default. For a tiny run on the CPU:

    python -m mhla_tpu_torch.train.dit_train configs/dit_s2.yaml --device=cpu --depth=2 \\
        --hidden_size=64 --num_heads=2 --input_size=8 --block_size=4 --num_classes=10 \\
        --bf16=false --train.batch_size=4 --train.max_steps=3 --train.log_interval=1 \\
        --work_dir=/tmp/dit
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..diffusion import create_diffusion
from ..models.dit import DiT, DiTConfig, build_dit, init_dit_params
from ..utils.checkpoint import (
    checkpoint_step,
    load_checkpoint,
    resolve_resume_path,
    save_checkpoint,
)
from ..utils.config import dump_config, parse_cli
from ..utils.logging import LogBuffer, Throughput, get_root_logger
from .trainer import OptimizerConfig, init_train_state, make_train_step


@dataclasses.dataclass
class DiTTrainLoop:
    max_steps: int = 100
    batch_size: int = 16
    log_interval: int = 10
    save_interval: int = 1000
    ema_decay: float = 0.9999
    seed: int = 0
    resume_from: Optional[str] = "latest"
    # a torch .pt / .pth of a standard DiT to fine-tune from (qkv -> to_qkv,
    # the MHLA parameters fresh)
    finetune_from: Optional[str] = None


@dataclasses.dataclass
class DiTTrainConfig:
    model_name: str = "DiT-S/2"
    input_size: int = 32  # 256 px images -> 32 x 32 x 4 SD-VAE latents
    block_size: int = 16
    num_classes: int = 1000
    # size overrides (None -> the preset of model_name), for small runs
    depth: Optional[int] = None
    hidden_size: Optional[int] = None
    num_heads: Optional[int] = None
    feature_dir: Optional[str] = None  # extracted latents; None -> synthetic
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(
            learning_rate=1e-4, weight_decay=0.0, grad_clip=None, schedule="constant",
            warmup_steps=0, total_steps=400_000,
        )
    )
    train: DiTTrainLoop = dataclasses.field(default_factory=DiTTrainLoop)
    work_dir: str = "work_dirs/dit"
    bf16: bool = True
    device: str = "cuda"


def latent_batches(cfg: DiTTrainConfig,
                   rng: np.random.Generator) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (latents [B, S, S, 4] NHWC float32, labels [B] int32): from
    ``feature_dir`` (``data.image_data.LatentDataset``), else standard normal
    latents and uniform labels from ``rng``."""
    if cfg.feature_dir and Path(cfg.feature_dir).exists():
        from ..data.image_data import LatentDataset

        yield from LatentDataset(cfg.feature_dir, seed=cfg.train.seed).infinite(
            cfg.train.batch_size)
    else:
        while True:
            x = rng.standard_normal(
                (cfg.train.batch_size, cfg.input_size, cfg.input_size, 4), dtype=np.float32)
            y = rng.integers(0, cfg.num_classes, cfg.train.batch_size)
            yield x, y.astype(np.int32)


def build_model(cfg: DiTTrainConfig, device=None) -> Tuple[DiT, DiTConfig]:
    overrides = {k: getattr(cfg, k) for k in ("depth", "hidden_size", "num_heads")
                 if getattr(cfg, k) is not None}
    return build_dit(cfg.model_name, device=device, input_size=cfg.input_size,
                     block_size=cfg.block_size, num_classes=cfg.num_classes,
                     dtype=torch.bfloat16 if cfg.bf16 else torch.float32, **overrides)


def dit_loss(model: DiT, diffusion, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             force_drop: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean loss, mean mse) of latents x at integer timesteps t: the labels
    drop by ``generator``'s draws unless ``force_drop`` is given, the noise
    comes from ``generator`` unless given."""

    def model_fn(x_t, tt):
        return model(x_t, tt, y, train=True, force_drop=force_drop, generator=generator)

    losses = diffusion.training_losses(model_fn, x, t, generator, noise)
    return losses["loss"].mean(), losses["mse"].mean()


def make_loss_fn(diffusion):
    """``loss_fn(model, (x, y), generator) -> (loss, {"mse"})`` for
    ``make_train_step``."""

    def loss_fn(model, batch, generator):
        x, y = batch
        t = torch.randint(0, diffusion.num_timesteps, (x.shape[0],), generator=generator,
                          device=x.device)
        loss, mse = dit_loss(model, diffusion, x, y, t, generator)
        return loss, {"mse": mse}

    return loss_fn


def load_finetune(model: DiT, path: str) -> None:
    """Load a standard DiT checkpoint (its ``ema`` or ``model`` entry, else
    the dict itself) into ``model`` through ``convert_dit_checkpoint``; the
    MHLA-only parameters keep their values."""
    from ..models.convert_dit import convert_dit_checkpoint

    blob = torch.load(path, map_location="cpu", weights_only=True)
    blob = blob.get("ema", blob.get("model", blob))
    state = {k: v.float().numpy() for k, v in blob.items()}
    model.load_state_dict(convert_dit_checkpoint(state, model.cfg, model.state_dict()))


def main(argv=None) -> dict:
    """Train; returns ``final_loss``, ``params``, ``model``, per-step
    ``losses`` and ``step_seconds`` (host clock, each ending in the loss's
    device-to-host copy)."""
    cfg = parse_cli(DiTTrainConfig, argv if argv is not None else sys.argv[1:])
    logger = get_root_logger(f"{cfg.work_dir}/train.log")
    dump_config(cfg, f"{cfg.work_dir}/config.yaml")
    device = torch.device(cfg.device)
    model, model_cfg = build_model(cfg, device)
    init_dit_params(model, torch.Generator(device).manual_seed(cfg.train.seed))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"{cfg.model_name}: {n_params / 1e6:.1f}M params on {device}")
    if cfg.train.finetune_from:
        load_finetune(model, cfg.train.finetune_from)
        logger.info(f"finetuning from {cfg.train.finetune_from}")
    diffusion, _ = create_diffusion(None, learn_sigma=model_cfg.learn_sigma)

    state = init_train_state(model, cfg.optimizer, ema=True)
    step_fn = make_train_step(make_loss_fn(diffusion), cfg.train.ema_decay, seed=cfg.train.seed)
    start = 0
    if cfg.train.resume_from:
        path = resolve_resume_path(cfg.work_dir, cfg.train.resume_from)
        if path:
            state = load_checkpoint(path, state)
            start = checkpoint_step(path)
            logger.info(f"resumed from {path} at step {start}")

    data = latent_batches(cfg, np.random.default_rng(cfg.train.seed))
    buf, thr = LogBuffer(), Throughput(cfg.train.max_steps)
    losses, step_seconds = [], []
    last = float("nan")
    for i in range(start, cfg.train.max_steps):
        x, y = next(data)
        batch = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        last = float(metrics["loss"])  # waits for the step on the device
        step_seconds.append(time.perf_counter() - t0)
        losses.append(last)
        buf.update(loss=last)
        if (i + 1) % cfg.train.log_interval == 0:
            speed = thr.step(i + 1, cfg.train.batch_size)
            logger.info(f"step {i + 1}/{cfg.train.max_steps} loss {buf.average()['loss']:.4f} "
                        f"{speed['items_per_sec']:.1f} img/s")
        if (i + 1) % cfg.train.save_interval == 0:
            save_checkpoint(cfg.work_dir, i + 1, state)
    save_checkpoint(cfg.work_dir, cfg.train.max_steps, state)
    return {"final_loss": last, "params": n_params, "model": model, "losses": losses,
            "step_seconds": step_seconds}


@torch.no_grad()
def sample(
    model: DiT,
    labels: torch.Tensor,
    cfg_scale: float = 4.0,
    num_steps: str = "250",
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    step_noises=None,
) -> torch.Tensor:
    """CFG sampling: the doubled batch with the null class in its second
    half, the respaced ancestral loop, guided eps; returns the first half's
    latents [n, S, S, C] float32. The noises come from ``generator`` (on the
    labels' device) unless given."""
    cfg = model.cfg
    diffusion, t_map = create_diffusion(num_steps, learn_sigma=cfg.learn_sigma)
    n = labels.shape[0]
    y = torch.cat([labels, torch.full_like(labels, cfg.num_classes)])

    def model_fn(x, t):
        return model.forward_with_cfg(x, t, y, cfg_scale)

    shape = (2 * n, cfg.input_size, cfg.input_size, cfg.in_channels)
    out = diffusion.p_sample_loop(model_fn, shape, generator, timestep_map=t_map, noise=noise,
                                  step_noises=step_noises, device=labels.device)
    return out[:n]


if __name__ == "__main__":
    main()
