"""Video inference CLI: prompts file -> sampled videos (mp4) or latents
(counterpart of ``mhla_tpu/eval/video_infer_cli.py``).

Configuration is the dataclass defaults (the full-MHLA Wan2.1-1.3B of
``configs/wan_1300m_mhla.yaml``: all 30 layers MHLA) plus ``--a.b=v``
overrides, or a YAML file. A ``linear_attn_idx`` with gaps gives the hybrid
model: the layers it leaves out run dense softmax self-attention
(``configs/wan_1300m_hybrid_mhla.yaml``: ``--linear_attn_idx=(1,2,4,5,...,28,29)``).

Text conditioning:
- ``t5_dir``: umT5 weights (``*.safetensors`` of a HF UMT5 encoder or the
  reference's ``*.pth``) and a tokenizer, encoding the prompts and the null
  prompt live (``models.t5.T5TextEncoder``); the encoder is freed before
  sampling;
- ``emb_file``: an .npz of precomputed text embeddings keyed ``emb_0``,
  ``emb_1``, ... (one per prompt line) and an optional ``null``;
- neither: zero embeddings (smoke and timing runs).

Weights: ``wan_safetensors`` (a reference Wan2.1 checkpoint, converted on
load; the MHLA layers' gate and g_norm from the seeded init) or ``ckpt``
(a ``wan_train`` work_dir or step directory, its EMA weights first); absent
both, the model runs from a seeded init. An orbax checkpoint of the JAX
package cannot be read without JAX and raises.

Text to video only: the CLI takes no image, as in the JAX package, so an
image-to-video model name raises ``ValueError`` where sampling finds no CLIP
features (``video_inference.sample_video_latents(..., clip_fea=...)``
samples one).

Decoding: ``vae_ckpt`` (the reference's ``Wan2.1_VAE.pth``) decodes each
sample to ``sample_<i>.mp4``; without it the latents are saved as
``sample_<i>.npy``. ``manifest.json`` lists prompt and path of each.

Usage:
    python -m mhla_tpu_torch.eval.video_infer_cli --txt_file=prompts.txt \\
        --t5_dir=umt5-xxl --wan_safetensors=Wan2.1-T2V-1.3B.safetensors \\
        --vae_ckpt=Wan2.1_VAE.pth --sampling.solver=unipc [--device=cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.convert_jax import vae_params_from_jax, wan_params_from_jax
from ..models.convert_wan import convert_wan_checkpoint, load_wan_safetensors, mhla_init_params
from ..models.vae import VAEConfig, WanVAE, convert_vae_checkpoint
from ..models.wan import WanConfig, WanModel, build_wan_config, init_wan_params
from ..utils.checkpoint import load_model_params
from ..utils.config import dump_config, parse_cli
from .vbench import read_prompts, to_uint8_video, write_mp4
from .video_inference import sample_video_latents


@dataclasses.dataclass
class SamplingConfig:
    solver: str = "dpm-solver"  # dpm-solver | flow_euler | unipc | sa-solver
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
    ckpt: Optional[str] = None  # a wan_train work_dir or step directory
    wan_safetensors: Optional[str] = None  # a reference Wan2.1 checkpoint
    emb_file: Optional[str] = None  # precomputed text embeddings npz
    t5_dir: Optional[str] = None  # umT5 weights and tokenizer (live encode)
    vae_ckpt: Optional[str] = None  # the reference's Wan2.1_VAE.pth; None -> save latents
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    batch_size: int = 1
    bf16: bool = True
    fps: int = 16
    device: str = "cuda"
    # tiny-override knobs for smoke tests
    num_layers: Optional[int] = None
    dim: Optional[int] = None
    num_heads: Optional[int] = None
    ffn_dim: Optional[int] = None
    text_dim: Optional[int] = None
    text_len: Optional[int] = None


def _wan_config(cfg: VideoInferConfig, **model_overrides) -> WanConfig:
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
    return build_wan_config(cfg.model_name, **overrides)


def _build_model(cfg: VideoInferConfig, device: torch.device, **model_overrides) -> WanModel:
    """The configured model on ``device``, from a seeded init;
    ``model_overrides`` are ``WanConfig`` fields the CLI has no option for."""
    model = WanModel(_wan_config(cfg, **model_overrides), device=device)
    # float32 parameters from a seeded init; bf16 is the compute dtype
    return init_wan_params(model, torch.Generator(device).manual_seed(0)).eval()


def _load_params(cfg: VideoInferConfig, model: WanModel) -> None:
    """The weights of ``wan_safetensors`` or ``ckpt`` into ``model``, in place."""
    if cfg.wan_safetensors:
        tree = convert_wan_checkpoint(load_wan_safetensors(cfg.wan_safetensors), model.cfg,
                                      mhla_init_params(model))
        model.load_state_dict(wan_params_from_jax(tree))
    elif cfg.ckpt:
        if not Path(cfg.ckpt).exists():
            raise FileNotFoundError(cfg.ckpt)
        try:
            load_model_params(cfg.ckpt, model)
        except FileNotFoundError as err:
            raise ValueError(f"{cfg.ckpt} holds no checkpoint of this package (state.pt); an "
                             "orbax checkpoint of the JAX package cannot be read without JAX"
                             ) from err


def _load_vae(path: str, device: torch.device) -> WanVAE:
    """The reference's torch ``Wan2.1_VAE.pth`` through ``convert_vae_checkpoint``."""
    if Path(path).suffix not in (".pth", ".pt"):
        raise ValueError(f"vae_ckpt {path}: give the reference's torch Wan2.1_VAE.pth (an orbax "
                         "tree of the JAX package cannot be read without JAX)")
    blob = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    state = {k: v.float().numpy() for k, v in blob.items()}
    vae = WanVAE(VAEConfig(), device=device)
    vae.load_state_dict(vae_params_from_jax(convert_vae_checkpoint(state, vae.cfg)))
    return vae.eval()


def _text_embeddings(cfg: VideoInferConfig, prompts, model_cfg: WanConfig,
                     device: torch.device):
    """(embeddings [P, text_len, text_dim], null embeddings of the same
    shape or None)."""
    shape = (len(prompts), model_cfg.text_len, model_cfg.text_dim)
    if cfg.t5_dir:
        from ..models.t5 import T5TextEncoder

        encoder = T5TextEncoder(cfg.t5_dir, text_len=model_cfg.text_len, device=device)
        # the null (CFG) prompt rides in the prompts' batch
        all_embs = encoder(list(prompts) + [""])
        del encoder  # umT5-XXL holds 22.7 GB in float32
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if all_embs.shape[-1] != model_cfg.text_dim:
            raise ValueError(f"T5 dim {all_embs.shape[-1]} != the model's text_dim "
                             f"{model_cfg.text_dim}")
        return all_embs[:-1], all_embs[-1:].expand(len(prompts), -1, -1)
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
    device = torch.device(cfg.device)
    os.makedirs(cfg.out_dir, exist_ok=True)
    dump_config(cfg, os.path.join(cfg.out_dir, "config.yaml"))

    prompts = read_prompts(cfg.txt_file)
    text_emb, null_emb = _text_embeddings(cfg, prompts, _wan_config(cfg), device)
    model = _build_model(cfg, device)
    _load_params(cfg, model)
    vae = _load_vae(cfg.vae_ckpt, device) if cfg.vae_ckpt else None

    results, sample_seconds, decode_seconds = [], [], []
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
        )
        if device.type == "cuda":
            torch.cuda.synchronize()
        sample_seconds.append(time.perf_counter() - t0)
        for j, prompt in enumerate(batch):
            stem = os.path.join(cfg.out_dir, f"sample_{start + j:04d}")
            if vae is not None:
                t0 = time.perf_counter()
                frames = vae.decode(latents[j : j + 1])[0].cpu().numpy()  # waits for the device
                decode_seconds.append(time.perf_counter() - t0)
                path = write_mp4(stem + ".mp4", to_uint8_video(frames), fps=cfg.fps)
            else:
                path = stem + ".npy"
                np.save(path, latents[j].cpu().numpy())
            results.append({"prompt": prompt, "path": path})

    manifest = os.path.join(cfg.out_dir, "manifest.json")
    with open(manifest, "w") as fh:
        json.dump(results, fh, indent=2)
    return {"outputs": results, "manifest": manifest, "model": model,
            "sample_seconds": sample_seconds, "decode_seconds": decode_seconds}


if __name__ == "__main__":
    main()
