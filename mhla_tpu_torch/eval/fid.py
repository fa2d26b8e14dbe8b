"""FID evaluation plumbing: the ADM-evaluator sample ``.npz`` builder
(counterpart of ``mhla_tpu/eval/fid.py``). The FID score itself comes from
the external ADM evaluator."""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def latents_to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1, 1] float NHWC -> uint8 (the ADM npz convention)."""
    x = np.clip((images + 1.0) * 127.5, 0, 255)
    return np.rint(x).astype(np.uint8)


def build_sample_npz(
    sample_fn: Callable[[torch.Tensor, torch.Generator], torch.Tensor],
    num_samples: int,
    batch_size: int,
    num_classes: int,
    out_path: str,
    generator: Optional[torch.Generator] = None,
) -> str:
    """Generate ``num_samples`` images and write them as ``arr_0`` [N, H, W,
    C] uint8. ``sample_fn(labels, generator) -> [B, H, W, C]`` images in [-1,
    1]; each batch's labels are drawn uniformly from ``generator`` (on the
    device the labels should live on), then the batch is sampled from it."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    chunks, done = [], 0
    while done < num_samples:
        n = min(batch_size, num_samples - done)
        labels = torch.randint(0, num_classes, (batch_size,), generator=generator,
                               device=generator.device)
        imgs = sample_fn(labels, generator)[:n]
        chunks.append(latents_to_uint8(imgs.float().cpu().numpy()))
        done += n
    arr = np.concatenate(chunks, axis=0)[:num_samples]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, arr_0=arr)
    return out_path
