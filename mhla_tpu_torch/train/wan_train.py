"""Wan video flow-matching training entry point (counterpart of
``mhla_tpu/train/wan_train.py``): flow-velocity loss with logit-normal
timesteps, null-text dropout for classifier-free guidance, the full-MHLA or
hybrid MHLA/softmax model from ``model.linear_attn_idx``, softmax layers
under the radial-sparse mask (``model.sparse_attn_idx``; training always runs
the mask, the dense guard of the early denoising steps belongs to sampling),
LoRA fine-tuning (``lora.enable``: the base stays frozen and only the
adapters are trained, averaged and checkpointed), per-block
rematerialisation, AdamW with clipping and linear learning-rate scaling by
the effective batch (``auto_scale_lr_base_batch``), EMA, the NaN circuit
breaker, time-boxed runs (``early_stop_hours``) with ``latest`` resume, and
deterministic validation sampling.

Latents and text embeddings come from a directory of webdataset-style
``*.tar`` shards (each sample a ``<key>.latent.npy`` [F, H, W, C] and a
``<key>.text_emb.npy`` [L, D]; ``data.tar_shards.write_tar_shard`` writes
them), else of cached ``*.npz`` files (``latent``, ``text_emb``), else from a
seeded synthetic stream; the weights from a seeded init. Teacher
distillation (``distill.enable``) adds the float32 MSE of the student's
velocity to a frozen teacher's (``distill_logit``) and the mean MSE over
every block's captured self-attention output and block output
(``distill_attn``); the teacher is the full model loaded from a checkpoint
of this package (``distill.teacher_ckpt``: a ``wan_train`` work_dir or step
directory, its EMA weights first). The VAE and the text encoder are not
part of training.

Usage:
    python -m mhla_tpu_torch.train.wan_train [config.yaml] [--train.max_steps=50] ...

The defaults are Wan2.1-1.3B in its hybrid form (layers 0, 3, ..., 27
softmax, the other 20 MHLA) at latents (21, 60, 100, 16) = 31,500 tokens,
batch 1, float32 parameters and bf16 compute, on ``--device=cuda``;
``"--model.linear_attn_idx=(0,1,...,29)"`` gives the full-MHLA form,
``"--model.sparse_attn_idx=(0,3,...,27)"`` puts the ten softmax layers under
the radial mask, ``--lora.enable=true`` trains adapters on q, k, v and o of
every attention only. For a tiny run on the CPU:

    python -m mhla_tpu_torch.train.wan_train --device=cpu --bf16=false \\
        --model.dim=48 --model.ffn_dim=96 --model.num_heads=4 --model.num_layers=2 \\
        "--model.linear_attn_idx=(0,)" "--model.block_layout=(2,2,2)" \\
        --data.latent_frames=4 --data.latent_height=8 --data.latent_width=8 \\
        --data.latent_dim=4 --data.text_len=8 --data.text_dim=32 --train.max_steps=2 \\
        --train.log_interval=1 --work_dir=/tmp/wan

``--model.is_lepe=true`` adds the LePE convolution to every MHLA layer;
``--distill.enable=true --distill.teacher_ckpt=/tmp/wan`` distills from that
run's weights. ``model.rope_after`` is taken and read by no ported layer (in
the JAX package only the linear baselines, not ported here, read it).

Not ported: image-to-video training, which the JAX entry point cannot run
either (it initialises the model without CLIP features).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..diffusion import (
    flow_euler_sample_loop,
    flow_q_sample,
    flow_training_loss,
    logit_normal_timesteps,
)
from ..models.wan import WanConfig, WanModel, build_wan_config, init_wan_params
from ..utils.checkpoint import (
    checkpoint_step,
    load_checkpoint,
    load_model_params,
    resolve_resume_path,
    save_checkpoint,
)
from ..utils.config import dump_config, parse_cli
from ..utils.logging import LogBuffer, Throughput, get_root_logger
from ..utils.monitor import NaNLossBreaker
from .lora import apply_lora, lora_param_count, lora_state
from .trainer import (
    OptimizerConfig,
    TrainState,
    auto_scale_lr,
    init_train_state,
    make_train_step,
)


@dataclasses.dataclass
class WanTrainLoop:
    max_steps: int = 50
    batch_size: int = 1
    log_interval: int = 5
    save_interval: int = 1000
    ema_decay: Optional[float] = 0.9999
    class_dropout_prob: float = 0.1  # null-text dropout for CFG
    timestep_mean: float = 0.0  # logit-normal parameters
    timestep_std: float = 1.0
    early_stop_hours: Optional[float] = None
    nan_patience: int = 20
    seed: int = 0
    resume_from: Optional[str] = "latest"
    # deterministic validation sampling every N steps: FlowEuler from a fixed
    # noise and context, latents written to work_dir/validation/step_XXXXXX.npy
    eval_sampling_steps: int = 0  # 0 = off
    eval_solver_steps: int = 8


@dataclasses.dataclass
class WanModelCfg:
    model: str = "Wan_T2V_1300M"
    linear_attn_idx: Optional[Tuple[int, ...]] = tuple(
        i for i in range(30) if i % 3 != 0
    )  # the hybrid 2/3 schedule
    self_attn_type: str = "mhla_uni"
    sparse_attn_idx: Optional[Tuple[int, ...]] = None
    rope_after: bool = True
    without_rope: bool = False
    norm_output: bool = False
    is_gated: bool = True
    is_lepe: bool = False
    block_layout: Tuple[int, int, int] = (3, 5, 10)
    mhla_adjust: bool = True
    # size overrides (None -> the preset of ``model``), for small runs
    dim: Optional[int] = None
    ffn_dim: Optional[int] = None
    num_heads: Optional[int] = None
    num_layers: Optional[int] = None


@dataclasses.dataclass
class WanDataCfg:
    latent_dir: Optional[str] = None  # cached latents; None -> synthetic
    latent_frames: int = 21  # 81 frames / VAE stride 4 (+1)
    latent_height: int = 60  # 480 / 8
    latent_width: int = 100  # 800 / 8
    latent_dim: int = 16
    text_len: int = 512
    text_dim: int = 4096


@dataclasses.dataclass
class WanDistillCfg:
    """Teacher distillation: MSE on the teacher's velocity and on every
    block's captured attention and block outputs."""

    enable: bool = False
    teacher_ckpt: Optional[str] = None  # a wan_train work_dir or step directory
    logit_weight: float = 1.0
    attn_weight: float = 1.0


@dataclasses.dataclass
class WanLoraCfg:
    """LoRA fine-tuning of the attention projections (``train.lora``)."""

    enable: bool = False
    rank: int = 16
    alpha: float = 16.0


@dataclasses.dataclass
class WanTrainConfig:
    model: WanModelCfg = dataclasses.field(default_factory=WanModelCfg)
    data: WanDataCfg = dataclasses.field(default_factory=WanDataCfg)
    distill: WanDistillCfg = dataclasses.field(default_factory=WanDistillCfg)
    lora: WanLoraCfg = dataclasses.field(default_factory=WanLoraCfg)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(
            learning_rate=1e-4, weight_decay=0.01, grad_clip=0.1,
            warmup_steps=100, total_steps=100_000, optimizer="adamw",
        )
    )
    train: WanTrainLoop = dataclasses.field(default_factory=WanTrainLoop)
    work_dir: str = "work_dirs/wan"
    bf16: bool = True
    auto_scale_lr_base_batch: Optional[int] = None
    device: str = "cuda"


def _check_ported(cfg: WanTrainConfig) -> None:
    if "i2v" in cfg.model.model.lower():
        raise NotImplementedError(
            f"{cfg.model.model}: image-to-video training is not ported (the JAX entry point "
            "cannot initialise an i2v model either: it passes no CLIP features)")
    if cfg.distill.enable and not cfg.distill.teacher_ckpt:
        raise ValueError("distill.enable requires distill.teacher_ckpt")


def build_model(cfg: WanTrainConfig, device=None) -> Tuple[WanModel, WanConfig]:
    """The model ``cfg`` describes, with per-block remat on and without the
    sparse layers' dense guard (it belongs to inference: training always
    runs the radial mask in the layers of ``model.sparse_attn_idx``)."""
    _check_ported(cfg)
    size_overrides = {
        k: getattr(cfg.model, k)
        for k in ("dim", "ffn_dim", "num_heads", "num_layers")
        if getattr(cfg.model, k) is not None
    }
    idx, sparse_idx = cfg.model.linear_attn_idx, cfg.model.sparse_attn_idx
    mc = build_wan_config(
        cfg.model.model,
        **size_overrides,
        linear_attn_idx=None if idx is None else tuple(idx),
        attn_type=cfg.model.self_attn_type,
        sparse_attn_idx=None if sparse_idx is None else tuple(sparse_idx),
        sparse_dense_from_t=None,
        rope_after=cfg.model.rope_after,
        without_rope=cfg.model.without_rope,
        normalize_out=cfg.model.norm_output,
        is_gated=cfg.model.is_gated,
        is_lepe=cfg.model.is_lepe,
        block_layout=tuple(cfg.model.block_layout),
        grid_adjust=cfg.model.mhla_adjust,
        in_dim=cfg.data.latent_dim,
        out_dim=cfg.data.latent_dim,
        text_dim=cfg.data.text_dim,
        text_len=cfg.data.text_len,
        remat=True,
        dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
    )
    return WanModel(mc, device=device), mc


def _rank_and_world() -> Tuple[int, int]:
    """This process's rank and the world size from ``torch.distributed``
    where it is initialised, else 0 and 1."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def video_batches(
    cfg: WanTrainConfig, rng: np.random.Generator
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless ``(latents [B, F, H, W, C], text embeddings [B, L, D])`` float32
    batches: from the ``*.tar`` shards of ``data.latent_dir`` where it holds
    any (samples' ``latent.npy`` and ``text_emb.npy`` fields; this rank's
    contiguous range of the samples, in order, epoch after epoch; the tail
    that fills no batch is dropped), else from its ``*.npz`` files in sorted
    order (likewise), else synthetic: standard normal latents and 0.02 x
    normal embeddings from ``rng``."""
    d = cfg.data
    bsz = cfg.train.batch_size
    shape = (bsz, d.latent_frames, d.latent_height, d.latent_width, d.latent_dim)
    root = Path(d.latent_dir) if d.latent_dir else None
    tars = sorted(root.glob("*.tar")) if root is not None and root.exists() else []
    if tars:
        from ..data.tar_shards import DistributedRangedSampler, ShardListDataset

        ds = ShardListDataset([str(p) for p in tars])
        rank, world = _rank_and_world()
        sampler = DistributedRangedSampler(ds, rank=rank, world_size=world)
        if len(sampler) < bsz:
            raise ValueError(f"{len(sampler)} samples for rank {rank} of {world} in the shards "
                             f"under {root}: a batch needs {bsz}")
        while True:
            zs, cs = [], []
            for idx in sampler:  # one epoch; the sampler then starts the next
                sample = ds[idx]
                zs.append(np.asarray(sample["latent.npy"], np.float32))
                cs.append(np.asarray(sample["text_emb.npy"], np.float32))
                if len(zs) == bsz:
                    yield np.stack(zs), np.stack(cs)
                    zs, cs = [], []
    if root is not None and root.exists():
        files = sorted(root.glob("*.npz"))
        if len(files) < bsz:
            raise ValueError(f"{len(files)} cached latents under {root}: a batch needs {bsz}")
        while True:
            for start in range(0, len(files) - bsz + 1, bsz):
                blobs = [np.load(f) for f in files[start: start + bsz]]
                yield (np.stack([b["latent"] for b in blobs]).astype(np.float32),
                       np.stack([b["text_emb"] for b in blobs]).astype(np.float32))
    while True:
        z = rng.standard_normal(shape, dtype=np.float32)
        c = rng.standard_normal((bsz, d.text_len, d.text_dim), dtype=np.float32) * 0.02
        yield z, c


def video_loss(
    model: WanModel,
    z: torch.Tensor,
    ctx: torch.Tensor,
    t01: torch.Tensor,
    drop: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The mean flow-velocity loss of latents ``z`` [B, F, H, W, C] at times
    ``t01`` [B], the text embeddings ``ctx`` zeroed where ``drop`` [B] is
    set (the null condition), the model called at ``t01 * 1000`` in its
    compute dtype. The noise comes from ``generator`` unless given."""
    dtype = model.cfg.dtype
    ctx = torch.where(drop.reshape(-1, 1, 1), 0.0, ctx).to(dtype)

    def vmodel(x_t, tt):
        return model(x_t.to(dtype), tt * 1000.0, ctx)

    return flow_training_loss(vmodel, z, t01, generator, noise)["loss"].mean()


def distill_video_loss(
    model: WanModel,
    teacher: WanModel,
    z: torch.Tensor,
    ctx: torch.Tensor,
    t01: torch.Tensor,
    drop: torch.Tensor,
    noise: torch.Tensor,
    logit_weight: float = 1.0,
    attn_weight: float = 1.0,
) -> Tuple[torch.Tensor, dict]:
    """The flow loss of :func:`video_loss` plus distillation from the frozen
    ``teacher``: the student's ``capture`` forward on the flow loss's own
    x_t (one forward gives both), the teacher's on the same x_t without
    gradients, ``distill_logit`` the float32 MSE of the two velocities and
    ``distill_attn`` the mean over every captured tensor (each block's
    attention output and block output) of its float32 MSE. Returns (loss,
    metrics)."""
    dtype = model.cfg.dtype
    ctx = torch.where(drop.reshape(-1, 1, 1), 0.0, ctx).to(dtype)
    caps = {}

    def vmodel(x_t, tt):
        out, caps["student"] = model(x_t.to(dtype), tt * 1000.0, ctx, capture=True)
        caps["velocity"] = out
        return out

    loss = flow_training_loss(vmodel, z, t01, noise=noise)["loss"].mean()
    with torch.no_grad():
        t_out, t_caps = teacher(flow_q_sample(z, t01, noise).to(dtype), t01 * 1000.0, ctx,
                                capture=True)
    d_logit = torch.mean(torch.square(caps["velocity"].float() - t_out.float()))
    # the JAX trainer's jax.tree.leaves order: every attn_out, then every block_out
    s_leaves = caps["student"]["attn_out"] + caps["student"]["block_out"]
    t_leaves = t_caps["attn_out"] + t_caps["block_out"]
    d_attn = sum(torch.mean(torch.square(a.float() - b.float()))
                 for a, b in zip(s_leaves, t_leaves)) / max(len(s_leaves), 1)
    loss = loss + logit_weight * d_logit + attn_weight * d_attn
    return loss, {"distill_logit": d_logit.detach(), "distill_attn": d_attn.detach()}


def make_loss_fn(cfg: WanTrainConfig, teacher: Optional[WanModel] = None):
    """``loss_fn(model, (z, ctx), generator) -> (loss, metrics)`` for
    ``make_train_step``: timesteps, the dropout mask and the noise are drawn
    from the step's generator, in that order; with a ``teacher`` the loss is
    :func:`distill_video_loss` and the metrics hold its two terms."""
    loop = cfg.train

    def loss_fn(model, batch, generator):
        z, ctx = batch
        t01 = logit_normal_timesteps(z.shape[0], loop.timestep_mean, loop.timestep_std,
                                     generator, z.device)
        drop = torch.rand(z.shape[0], generator=generator, device=z.device)
        drop = drop < loop.class_dropout_prob
        if teacher is None:
            return video_loss(model, z, ctx, t01, drop, generator), {}
        noise = torch.randn(z.shape, generator=generator, dtype=z.dtype, device=z.device)
        return distill_video_loss(model, teacher, z, ctx, t01, drop, noise,
                                  cfg.distill.logit_weight, cfg.distill.attn_weight)

    return loss_fn


def load_teacher(cfg: WanTrainConfig, device: torch.device) -> WanModel:
    """The frozen distillation teacher: the full model ``cfg`` describes
    (never LoRA's adapters) with the weights of ``distill.teacher_ckpt``,
    EMA first."""
    teacher, _ = build_model(cfg, device)
    load_model_params(cfg.distill.teacher_ckpt, teacher)
    return teacher.requires_grad_(False).eval()


@torch.no_grad()
def validation_sample(cfg: WanTrainConfig, state: TrainState, step: int) -> str:
    """A FlowEuler rollout of ``train.eval_solver_steps`` steps from a noise
    and a context that depend on ``train.seed`` alone, through the EMA
    weights where the run keeps them (with LoRA: the averaged adapters merged
    into the base), so checkpoints can be compared; the latents go to
    ``work_dir/validation/step_XXXXXX.npy``."""
    model, d = state.model, cfg.data
    device = next(model.parameters()).device
    gen = torch.Generator(device).manual_seed(cfg.train.seed + 777)
    ctx = torch.randn(1, d.text_len, d.text_dim, generator=gen, device=device) * 0.02
    noise = torch.randn(1, d.latent_frames, d.latent_height, d.latent_width, d.latent_dim,
                        generator=gen, device=device)
    dtype = model.cfg.dtype

    def vmodel(x, t):
        args = (x.to(dtype), t * 1000.0, ctx.to(dtype))
        if state.ema is None:
            return model(*args)
        return torch.func.functional_call(model, state.ema, args)

    lat = flow_euler_sample_loop(vmodel, noise, num_steps=cfg.train.eval_solver_steps)
    out_dir = Path(cfg.work_dir) / "validation"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"step_{step:06d}.npy"
    np.save(path, lat.cpu().numpy())
    return str(path)


def build_training(cfg: WanTrainConfig):
    """The seeded model, its train state, the train step and the batch stream
    that ``cfg`` describes: ``(model, state, step_fn, data)``. With
    ``lora.enable`` the seeded model is frozen and carries adapters
    (:func:`apply_lora`), and the state holds the adapters alone; with
    ``distill.enable`` the teacher (:func:`load_teacher`, loaded before the
    adapters go in) rides in the train step."""
    device = torch.device(cfg.device)
    model, _ = build_model(cfg, device)
    init_wan_params(model, torch.Generator(device).manual_seed(cfg.train.seed))
    teacher = load_teacher(cfg, device) if cfg.distill.enable else None
    if cfg.lora.enable:
        apply_lora(model, torch.Generator(device).manual_seed(cfg.train.seed + 999),
                   cfg.lora.rank, cfg.lora.alpha)
    state = init_train_state(model, cfg.optimizer, ema=cfg.train.ema_decay is not None)
    step_fn = make_train_step(make_loss_fn(cfg, teacher), cfg.train.ema_decay,
                              seed=cfg.train.seed)
    data = video_batches(cfg, np.random.default_rng(cfg.train.seed))
    return model, state, step_fn, data


def main(argv=None) -> dict:
    """Train; returns ``final_loss``, ``params`` (the model's parameter
    count without LoRA adapters), ``model``, ``start_step``, per-step ``losses``, ``grad_norms`` and
    ``step_seconds`` (host clock, each ending in the loss's device-to-host
    copy), with ``distill.enable`` per-step ``distill_logit`` and
    ``distill_attn``, and ``save_seconds`` and ``checkpoint_bytes`` of the
    final checkpoint."""
    cfg = parse_cli(WanTrainConfig, argv if argv is not None else sys.argv[1:])
    if cfg.auto_scale_lr_base_batch:
        eff = cfg.train.batch_size * max(cfg.optimizer.accum_steps, 1)
        cfg.optimizer = dataclasses.replace(
            cfg.optimizer,
            learning_rate=auto_scale_lr(cfg.optimizer.learning_rate, eff,
                                        cfg.auto_scale_lr_base_batch),
        )
    model, state, step_fn, data = build_training(cfg)
    device = torch.device(cfg.device)
    logger = get_root_logger(f"{cfg.work_dir}/train.log")
    dump_config(cfg, f"{cfg.work_dir}/config.yaml")
    mc = model.cfg
    n_lora = lora_param_count(lora_state(model)) if cfg.lora.enable else 0
    n_params = sum(p.numel() for p in model.parameters()) - n_lora
    logger.info(f"{cfg.model.model}: {n_params / 1e6:.1f}M params on {device}, compute "
                f"{mc.dtype}, hybrid={len(mc.linear_attn_idx or ())}/{mc.num_layers} MHLA layers, "
                f"{len(mc.sparse_attn_idx or ())} radial-sparse softmax layers")
    if cfg.lora.enable:
        logger.info(f"LoRA: training {n_lora / 1e6:.2f}M adapter params")

    start = 0
    if cfg.train.resume_from:
        path = resolve_resume_path(cfg.work_dir, cfg.train.resume_from)
        if path:
            state = load_checkpoint(path, state)
            start = checkpoint_step(path)
            logger.info(f"resumed from {path} at step {start}")

    buf, thr = LogBuffer(), Throughput(cfg.train.max_steps)
    breaker = NaNLossBreaker(cfg.train.nan_patience)
    losses, grad_norms, step_seconds = [], [], []
    distill = {"distill_logit": [], "distill_attn": []} if cfg.distill.enable else {}
    last = float("nan")
    t_start = time.time()
    done = start
    for i in range(start, cfg.train.max_steps):
        z, c = next(data)
        batch = (torch.from_numpy(z).to(device), torch.from_numpy(c).to(device))
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        last = float(metrics["loss"])  # waits for the step on the device
        grad_norm = float(metrics["grad_norm"])
        step_seconds.append(time.perf_counter() - t0)
        losses.append(last)
        grad_norms.append(grad_norm)
        for name, values in distill.items():
            values.append(float(metrics[name]))
        done = i + 1
        buf.update(loss=last, grad_norm=grad_norm, **{k: v[-1] for k, v in distill.items()})
        if breaker.update(last):
            logger.error("NaN circuit breaker tripped; aborting")
            break
        if done % cfg.train.log_interval == 0:
            speed = thr.step(done, cfg.train.batch_size)
            avg = buf.average()
            terms = "".join(f" {k} {avg[k]:.4g}" for k in distill)
            logger.info(f"step {done}/{cfg.train.max_steps} loss {avg['loss']:.4f} "
                        f"gnorm {avg['grad_norm']:.3f}{terms} {speed['items_per_sec']:.2f} vid/s")
        if cfg.train.eval_sampling_steps and done % cfg.train.eval_sampling_steps == 0:
            path = validation_sample(cfg, state, done)
            logger.info(f"step {done} validation sample -> {path}")
        if done % cfg.train.save_interval == 0:
            save_checkpoint(cfg.work_dir, done, state)
        if (cfg.train.early_stop_hours
                and (time.time() - t_start) / 3600 > cfg.train.early_stop_hours):
            logger.info("early_stop_hours reached; checkpointing and exiting")
            break

    t0 = time.perf_counter()
    ckpt = save_checkpoint(cfg.work_dir, min(cfg.train.max_steps, done), state)
    save_seconds = time.perf_counter() - t0
    return {
        "final_loss": last,
        "params": n_params,
        "model": model,
        "start_step": start,
        "losses": losses,
        "grad_norms": grad_norms,
        "step_seconds": step_seconds,
        **distill,
        "save_seconds": save_seconds,
        "checkpoint_bytes": (Path(ckpt) / "state.pt").stat().st_size,
    }


if __name__ == "__main__":
    main()
