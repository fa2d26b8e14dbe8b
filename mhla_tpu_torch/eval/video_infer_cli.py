"""Video inference CLI: prompts file -> sampled latents (counterpart of
``mhla_tpu/eval/video_infer_cli.py``).

Configuration is the dataclass defaults (the full-MHLA Wan2.1-1.3B of
``configs/wan_1300m_mhla.yaml``: all 30 layers MHLA) plus ``--a.b=v``
overrides, or a YAML file where PyYAML is installed. A ``linear_attn_idx``
with gaps gives the hybrid model: the layers it leaves out run dense
softmax self-attention (``configs/wan_1300m_hybrid_mhla.yaml``:
``--linear_attn_idx=(1,2,4,5,...,28,29)``).

Text conditioning: ``emb_file`` names an .npz of precomputed text
embeddings keyed ``emb_0``, ``emb_1``, ... (one per prompt line) and an
optional ``null`` for the unconditional pass; without it the embeddings are
zero (smoke and timing runs). The model runs from a seeded random init:
checkpoint loading (``ckpt``, ``wan_safetensors``), live text encoding
(``t5_dir``) and VAE decoding (``vae_ckpt``) are not ported and raise
``NotImplementedError``. Latents are saved as ``sample_<i>.npy``.

Usage:
    python -m mhla_tpu_torch.eval.video_infer_cli --txt_file=prompts.txt \\
        --sampling.num_steps=4 [--device=cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.wan import WanModel, build_wan_config, init_wan_params
from ..utils.config import dump_config, parse_cli
from .video_inference import sample_video_latents


@dataclasses.dataclass
class SamplingConfig:
    solver: str = "dpm-solver"  # dpm-solver | flow_euler
    num_steps: int = 20
    cfg_scale: float = 5.0
    flow_shift: float = 3.0
    latent_shape: Tuple[int, int, int, int] = (21, 60, 100, 16)
    seed: int = 0


@dataclasses.dataclass
class VideoInferConfig:
    model_name: str = "Wan_T2V_1300M"
    linear_attn_idx: Optional[Tuple[int, ...]] = tuple(range(30))  # full MHLA
    txt_file: str = "samples_video.txt"
    out_dir: str = "work_dirs/video_infer"
    ckpt: Optional[str] = None
    wan_safetensors: Optional[str] = None
    emb_file: Optional[str] = None  # precomputed text embeddings npz
    t5_dir: Optional[str] = None
    vae_ckpt: Optional[str] = None
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    batch_size: int = 1
    bf16: bool = True
    device: str = "cuda"
    # tiny-override knobs for smoke tests
    num_layers: Optional[int] = None
    dim: Optional[int] = None
    num_heads: Optional[int] = None
    ffn_dim: Optional[int] = None
    text_dim: Optional[int] = None
    text_len: Optional[int] = None


def read_prompts(txt_file: str) -> List[str]:
    """One prompt per line; blank lines are skipped."""
    return [
        line.strip() for line in Path(txt_file).read_text().splitlines() if line.strip()
    ]


def _build_model(cfg: VideoInferConfig, device: torch.device, **model_overrides) -> WanModel:
    """The configured model on ``device``, from a seeded init;
    ``model_overrides`` are ``WanConfig`` fields the CLI has no option for."""
    overrides = {
        k: getattr(cfg, k)
        for k in ("num_layers", "dim", "num_heads", "ffn_dim", "text_dim", "text_len")
        if getattr(cfg, k) is not None
    }
    if cfg.linear_attn_idx is not None:
        overrides["linear_attn_idx"] = tuple(cfg.linear_attn_idx)
    if cfg.bf16:
        overrides["dtype"] = torch.bfloat16
    overrides.update(model_overrides)
    model = WanModel(build_wan_config(cfg.model_name, **overrides), device=device)
    # float32 parameters from a seeded init; bf16 is the compute dtype
    return init_wan_params(model, torch.Generator(device).manual_seed(0)).eval()


def _text_embeddings(cfg: VideoInferConfig, prompts, model_cfg):
    shape = (len(prompts), model_cfg.text_len, model_cfg.text_dim)
    if not cfg.emb_file:
        return torch.zeros(shape), None
    with np.load(cfg.emb_file) as data:
        embs = np.stack([data[f"emb_{i}"] for i in range(len(prompts))])
        null = data["null"] if "null" in data else None
    if embs.shape[1:] != shape[1:]:
        raise ValueError(f"{cfg.emb_file}: embeddings {embs.shape[1:]}, model needs {shape[1:]}")
    embs = torch.from_numpy(embs).float()
    if null is None:
        return embs, None
    return embs, torch.from_numpy(null).float()[None].expand(len(prompts), -1, -1)


def main(argv=None) -> dict:
    cfg = parse_cli(VideoInferConfig, argv if argv is not None else sys.argv[1:])
    for name in ("ckpt", "wan_safetensors", "t5_dir", "vae_ckpt"):
        if getattr(cfg, name):
            raise NotImplementedError(f"{name} is not ported yet: the model runs from a "
                                      "seeded init on precomputed text embeddings")
    device = torch.device(cfg.device)
    os.makedirs(cfg.out_dir, exist_ok=True)
    dump_config(cfg, os.path.join(cfg.out_dir, "config.yaml"))

    prompts = read_prompts(cfg.txt_file)
    model = _build_model(cfg, device)
    text_emb, null_emb = _text_embeddings(cfg, prompts, model.cfg)

    results, sample_seconds = [], []
    for start in range(0, len(prompts), cfg.batch_size):
        batch = prompts[start : start + cfg.batch_size]
        null_b = null_emb[start : start + len(batch)] if null_emb is not None else None
        t0 = time.perf_counter()
        latents = sample_video_latents(
            model, text_emb[start : start + len(batch)], null_b,
            latent_shape=tuple(cfg.sampling.latent_shape),
            cfg_scale=cfg.sampling.cfg_scale,
            num_steps=cfg.sampling.num_steps,
            solver=cfg.sampling.solver,
            flow_shift=cfg.sampling.flow_shift,
            generator=torch.Generator(device).manual_seed(cfg.sampling.seed + start),
        ).cpu().numpy()  # the copy waits for the device
        sample_seconds.append(time.perf_counter() - t0)
        for j, prompt in enumerate(batch):
            path = os.path.join(cfg.out_dir, f"sample_{start + j:04d}.npy")
            np.save(path, latents[j])
            results.append({"prompt": prompt, "path": path})

    manifest = os.path.join(cfg.out_dir, "manifest.json")
    with open(manifest, "w") as fh:
        json.dump(results, fh, indent=2)
    return {"outputs": results, "manifest": manifest, "model": model,
            "sample_seconds": sample_seconds}


if __name__ == "__main__":
    main()
