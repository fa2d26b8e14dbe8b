"""FID sampler CLI: a DiT checkpoint -> an ADM-evaluator ``.npz``
(counterpart of ``mhla_tpu/eval/fid_cli.py``): class-conditional CFG
sampling with the respaced ancestral loop, in batches, packed by
``eval.fid.build_sample_npz``. Without a VAE the latents themselves are
packed (clipped to [-1, 1]), as the JAX CLI does, and the manifest says
``decoded: false``; decoding through the 2-D SD-VAE (``vae_ckpt``) needs
``models/vae2d.py``, which is not ported yet.

Usage:
    python -m mhla_tpu_torch.eval.fid_cli --model_name=DiT-S/2 --ckpt=<dit_train work_dir> \\
        --num_samples=50000 --out=samples.npz

``--device=cuda`` is the default; ``--ckpt`` takes a run's ``work_dir`` or a
step directory (EMA weights first), and without it the model is a seeded
init.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional

import torch

from ..models.dit import build_dit, init_dit_params
from ..train.dit_train import sample
from ..utils.checkpoint import load_model_params
from ..utils.config import dump_config, parse_cli
from .fid import build_sample_npz


@dataclasses.dataclass
class FIDSampleConfig:
    model_name: str = "DiT-S/2"
    input_size: int = 32
    block_size: int = 16
    num_classes: int = 1000
    ckpt: Optional[str] = None  # dit_train work_dir or step directory; None -> seeded init
    vae_ckpt: Optional[str] = None  # SD-VAE decoder weights (not ported)
    num_samples: int = 50000
    batch_size: int = 32
    cfg_scale: float = 1.5
    num_sampling_steps: int = 250
    seed: int = 0
    out: str = "work_dirs/fid/samples.npz"
    # size overrides for small runs
    depth: Optional[int] = None
    hidden_size: Optional[int] = None
    num_heads: Optional[int] = None
    device: str = "cuda"


def main(argv=None) -> dict:
    """Sample and write the npz; returns the manifest (``npz``,
    ``num_samples``, ``decoded``, ``cfg_scale``, ``steps``) and
    ``sample_seconds``, the host-clock time of the sampling and packing."""
    cfg = parse_cli(FIDSampleConfig, argv if argv is not None else sys.argv[1:])
    if cfg.vae_ckpt:
        raise NotImplementedError("decoding through the SD-VAE (vae_ckpt) needs models/vae2d.py, "
                                  "which is not ported yet")
    out_dir = os.path.dirname(cfg.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    dump_config(cfg, os.path.join(out_dir, "fid_config.yaml"))
    device = torch.device(cfg.device)
    overrides = {k: getattr(cfg, k) for k in ("depth", "hidden_size", "num_heads")
                 if getattr(cfg, k) is not None}
    model, _ = build_dit(cfg.model_name, device=device, input_size=cfg.input_size,
                         block_size=cfg.block_size, num_classes=cfg.num_classes, **overrides)
    if cfg.ckpt:
        load_model_params(cfg.ckpt, model)
    else:
        init_dit_params(model, torch.Generator(device).manual_seed(cfg.seed))

    def sample_fn(labels, generator):
        # the latent-space npz (no VAE)
        return sample(model, labels, cfg.cfg_scale, str(cfg.num_sampling_steps),
                      generator).clamp(-1, 1)

    t0 = time.perf_counter()
    path = build_sample_npz(sample_fn, cfg.num_samples, cfg.batch_size, cfg.num_classes,
                            cfg.out, torch.Generator(device).manual_seed(cfg.seed))
    seconds = time.perf_counter() - t0
    manifest = {"npz": path, "num_samples": cfg.num_samples, "decoded": False,
                "cfg_scale": cfg.cfg_scale, "steps": cfg.num_sampling_steps}
    with open(os.path.join(out_dir, "fid_manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return {**manifest, "sample_seconds": seconds}


if __name__ == "__main__":
    main()
