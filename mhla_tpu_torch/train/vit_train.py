"""ViT ImageNet-style classification training (counterpart of
``mhla_tpu/train/vit_train.py``): the DeiT recipe of mixup / cutmix with
soft targets, label smoothing, EMA, cosine learning rate with warm-up,
gradient clipping and in-training validation of the live and the EMA
weights, on one device.

Images come from an ImageNet-layout folder (``data_dir``; PIL) or a seeded
synthetic stream; the weights from a seeded init. The mixup / cutmix draws
of step i come from :func:`~mhla_tpu_torch.train.trainer.step_generator`
of (seed, i) on the CPU, so they depend on nothing but the seed and the step.

Usage:
    python -m mhla_tpu_torch.train.vit_train [configs/deit_small_mhla.yaml] [--train.max_steps=...]

``--device=cuda`` is the default. For a tiny run on the CPU:

    python -m mhla_tpu_torch.train.vit_train configs/deit_small_mhla.yaml --device=cpu \\
        --model_name=deit_tiny_mhla --img_size=32 --piece_size=2 --num_classes=10 \\
        --bf16=false --train.batch_size=8 --train.max_steps=3 --train.log_interval=1 \\
        --optimizer.warmup_steps=1 --work_dir=/tmp/vit
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.vit import MHLAViT, build_vit, init_vit_params
from ..utils.checkpoint import (
    checkpoint_step,
    load_checkpoint,
    resolve_resume_path,
    save_checkpoint,
)
from ..utils.config import dump_config, parse_cli
from ..utils.logging import LogBuffer, Throughput, get_root_logger
from .trainer import OptimizerConfig, TrainState, init_train_state, make_train_step, step_generator


@dataclasses.dataclass
class ViTTrainLoop:
    max_steps: int = 100
    batch_size: int = 64
    log_interval: int = 10
    save_interval: int = 5000
    ema_decay: float = 0.9996
    label_smoothing: float = 0.1
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    seed: int = 0
    resume_from: Optional[str] = "latest"
    # every eval_interval steps, eval_batches held-out batches: top-1 of the
    # live and of the EMA weights
    eval_interval: int = 0  # 0 = off
    eval_batches: int = 8


@dataclasses.dataclass
class ViTTrainConfig:
    model_name: str = "deit_small_mhla"
    img_size: int = 256
    piece_size: int = 4
    transform: str = "linear"
    exp_sigma: float = 1.0
    num_classes: int = 1000
    data_dir: Optional[str] = None  # image-folder root; None -> synthetic
    val_dir: Optional[str] = None  # held-out image folder; None -> synthetic
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(
            learning_rate=1e-3, weight_decay=0.05, grad_clip=5.0,
            warmup_steps=10_000, total_steps=500_000,
        )
    )
    train: ViTTrainLoop = dataclasses.field(default_factory=ViTTrainLoop)
    work_dir: str = "work_dirs/vit"
    bf16: bool = True
    device: str = "cuda"


def sample_beta(a: float, b: float, generator: torch.Generator) -> float:
    """One Beta(a, b) draw by Johnk's rejection method from ``generator``'s
    uniforms (torch's gamma sampler takes no generator)."""
    while True:
        u, v = torch.rand(2, generator=generator, dtype=torch.float64).tolist()
        x, y = u ** (1.0 / a), v ** (1.0 / b)
        if 0.0 < x + y <= 1.0:
            return x / (x + y)


@dataclasses.dataclass
class MixDraws:
    """The random numbers of one batch's mixup / cutmix: which of the two,
    the two lambdas, and the cut box's center (row, column)."""

    cutmix: bool
    lam_mix: float
    lam_cut: float
    cy: int
    cx: int


def draw_mix(h: int, w: int, mixup_alpha: float, cutmix_alpha: float,
             generator: torch.Generator) -> MixDraws:
    """Draw :class:`MixDraws` for an h x w image from a CPU ``generator``."""
    cutmix = bool(torch.rand(1, generator=generator) < 0.5)
    lam_mix = sample_beta(mixup_alpha, mixup_alpha, generator)
    lam_cut = sample_beta(cutmix_alpha, cutmix_alpha, generator)
    cy = int(torch.randint(0, h, (1,), generator=generator))
    cx = int(torch.randint(0, w, (1,), generator=generator))
    return MixDraws(cutmix, lam_mix, lam_cut, cy, cx)


def mixup_cutmix(images: torch.Tensor, labels_onehot: torch.Tensor,
                 draws: MixDraws) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-level mixup or cutmix with soft targets (timm's semantics, as
    the JAX function computes them): each sample is mixed with the batch
    reversed; cutmix pastes a box of side sqrt(1 - lam_cut) centered at (cy,
    cx), clipped to the image, and the targets mix by the box's true area."""
    perm_img, perm_lab = images.flip(0), labels_onehot.flip(0)
    if draws.cutmix:
        h, w = images.shape[1], images.shape[2]
        cut = np.sqrt(np.float32(1.0 - draws.lam_cut))
        ch, cw = int(np.float32(cut * h)), int(np.float32(cut * w))
        y0, y1 = np.clip([draws.cy - ch // 2, draws.cy + ch // 2], 0, h)
        x0, x1 = np.clip([draws.cx - cw // 2, draws.cx + cw // 2], 0, w)
        images = images.clone()
        images[:, y0:y1, x0:x1] = perm_img[:, y0:y1, x0:x1]
        lam = 1.0 - ((y1 - y0) * (x1 - x0)) / (h * w)
    else:
        lam = draws.lam_mix
        images = lam * images + (1 - lam) * perm_img
    return images, lam * labels_onehot + (1 - lam) * perm_lab


def soft_target_xent(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(soft_targets * logp).sum(-1).mean()


def image_batches(cfg: ViTTrainConfig,
                  rng: np.random.Generator) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (images [B, S, S, 3] float32, labels [B] int32): the image
    folder with the timm train augmentations, else standard normal images and
    uniform labels from ``rng``."""
    if cfg.data_dir and Path(cfg.data_dir).exists():
        from ..data.image_data import ImageAugConfig, ImageFolderDataset

        ds = ImageFolderDataset(cfg.data_dir, ImageAugConfig(img_size=cfg.img_size, train=True),
                                seed=cfg.train.seed)
        yield from ds.infinite(cfg.train.batch_size)
    else:
        while True:
            x = rng.standard_normal(
                (cfg.train.batch_size, cfg.img_size, cfg.img_size, 3), np.float32)
            y = rng.integers(0, cfg.num_classes, cfg.train.batch_size).astype(np.int32)
            yield x, y


def val_batches(cfg: ViTTrainConfig, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` deterministic held-out batches: ``val_dir`` with the eval
    transforms, else a fixed synthetic set (seed + 10,000, never the train
    stream's)."""
    if cfg.val_dir and Path(cfg.val_dir).exists():
        from ..data.image_data import ImageAugConfig, ImageFolderDataset

        ds = ImageFolderDataset(cfg.val_dir, ImageAugConfig(img_size=cfg.img_size, train=False),
                                seed=0)
        it = ds.infinite(cfg.train.batch_size)
        return [next(it) for _ in range(n)]
    rng = np.random.default_rng(cfg.train.seed + 10_000)
    return [
        (rng.standard_normal((cfg.train.batch_size, cfg.img_size, cfg.img_size, 3), np.float32),
         rng.integers(0, cfg.num_classes, cfg.train.batch_size).astype(np.int32))
        for _ in range(n)
    ]


def build_model(cfg: ViTTrainConfig, device=None) -> MHLAViT:
    model, _ = build_vit(
        cfg.model_name, device=device, img_size=cfg.img_size, piece_size=cfg.piece_size,
        transform=cfg.transform, exp_sigma=cfg.exp_sigma, num_classes=cfg.num_classes,
        dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
    )
    return model


def make_loss_fn(cfg: ViTTrainConfig):
    """``loss_fn(model, (x, y, draws)) -> (loss, {"acc"})``: label-smoothed
    one-hot targets, mixup / cutmix by ``draws`` (a :class:`MixDraws`), the
    soft-target cross entropy."""
    nc, sm = cfg.num_classes, cfg.train.label_smoothing

    def loss_fn(model, batch):
        x, y, draws = batch
        onehot = F.one_hot(y.long(), nc).float() * (1 - sm) + sm / nc
        x, onehot = mixup_cutmix(x, onehot, draws)
        logits = model(x)
        acc = (logits.argmax(-1) == y).float().mean()
        return soft_target_xent(logits, onehot), {"acc": acc}

    return loss_fn


@torch.no_grad()
def run_validation(cfg: ViTTrainConfig, state: TrainState, device) -> Dict[str, float]:
    """Held-out top-1 of the live weights and of the EMA weights."""
    model = state.model
    correct = {"val_acc": 0, "val_acc_ema": 0}
    n = 0
    for x, y in val_batches(cfg, cfg.train.eval_batches):
        x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        correct["val_acc"] += int((model(x).argmax(-1) == y).sum())
        if state.ema is not None:
            logits = torch.func.functional_call(model, state.ema, (x,))
            correct["val_acc_ema"] += int((logits.argmax(-1) == y).sum())
        n += y.shape[0]
    return {k: v / max(n, 1) for k, v in correct.items()}


def main(argv=None) -> dict:
    """Train; returns ``final_loss``, ``params``, ``model``, per-step
    ``losses`` and ``step_seconds`` (host clock, each ending in the loss's
    device-to-host copy), and with ``eval_interval`` the final
    ``val_acc`` and ``val_acc_ema``."""
    cfg = parse_cli(ViTTrainConfig, argv if argv is not None else sys.argv[1:])
    logger = get_root_logger(f"{cfg.work_dir}/train.log")
    dump_config(cfg, f"{cfg.work_dir}/config.yaml")
    device = torch.device(cfg.device)
    model = init_vit_params(build_model(cfg, device),
                            torch.Generator(device).manual_seed(cfg.train.seed))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"{cfg.model_name}: {n_params / 1e6:.1f}M params on {device}")

    state = init_train_state(model, cfg.optimizer, ema=True)
    step_fn = make_train_step(make_loss_fn(cfg), ema_decay=cfg.train.ema_decay)
    start = 0
    if cfg.train.resume_from:
        path = resolve_resume_path(cfg.work_dir, cfg.train.resume_from)
        if path:
            state = load_checkpoint(path, state)
            start = checkpoint_step(path)
            logger.info(f"resumed from {path} at step {start}")

    data = image_batches(cfg, np.random.default_rng(cfg.train.seed))
    buf, thr = LogBuffer(), Throughput(cfg.train.max_steps)
    losses, step_seconds = [], []
    last = float("nan")
    for i in range(start, cfg.train.max_steps):
        x, y = next(data)
        draws = draw_mix(x.shape[1], x.shape[2], cfg.train.mixup_alpha, cfg.train.cutmix_alpha,
                         step_generator(cfg.train.seed, i, torch.device("cpu")))
        batch = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device), draws)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        last = float(metrics["loss"])  # waits for the step on the device
        step_seconds.append(time.perf_counter() - t0)
        losses.append(last)
        buf.update(loss=last, acc=float(metrics["acc"]))
        if (i + 1) % cfg.train.log_interval == 0:
            speed = thr.step(i + 1, cfg.train.batch_size)
            avg = buf.average()
            logger.info(f"step {i + 1}/{cfg.train.max_steps} loss {avg['loss']:.4f} "
                        f"acc {avg['acc']:.3f} {speed['items_per_sec']:.1f} img/s")
        if cfg.train.eval_interval and (i + 1) % cfg.train.eval_interval == 0:
            val = run_validation(cfg, state, device)
            logger.info(f"step {i + 1} val_acc {val['val_acc']:.4f} "
                        f"val_acc_ema {val['val_acc_ema']:.4f}")
        if (i + 1) % cfg.train.save_interval == 0:
            save_checkpoint(cfg.work_dir, i + 1, state)
    save_checkpoint(cfg.work_dir, cfg.train.max_steps, state)
    final_val = run_validation(cfg, state, device) if cfg.train.eval_interval else {}
    return {"final_loss": last, "params": n_params, "model": model, "losses": losses,
            "step_seconds": step_seconds, **final_val}


if __name__ == "__main__":
    main()
