"""VBench plumbing: sample videos and export mp4s (counterpart of
``mhla_tpu/eval/vbench.py``).

The reference's flow: prompts from a txt file -> latents sampled under CFG
-> the VAE decode -> an mp4 each through imageio; the VBench scores
themselves come from the VBench toolkit run over the exported directory.
``imageio`` is imported only by :func:`write_mp4`, which raises
``ImportError`` where it is missing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Sequence

import numpy as np
import torch


def to_uint8_video(frames: np.ndarray) -> np.ndarray:
    """[T, H, W, 3] in [-1, 1] -> uint8."""
    return np.rint(np.clip((frames + 1.0) * 127.5, 0, 255)).astype(np.uint8)


def write_mp4(path: str, frames: np.ndarray, fps: int = 16) -> str:
    """frames: [T, H, W, 3], float in [-1, 1] or uint8."""
    try:
        import imageio
    except ImportError as err:
        raise ImportError("write_mp4 needs the imageio package (with its ffmpeg plugin)") from err

    if frames.dtype != np.uint8:
        frames = to_uint8_video(frames)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    imageio.mimwrite(path, list(frames), fps=fps, codec="libx264")
    return path


def read_prompts(txt_file: str) -> List[str]:
    """One prompt per line; blank lines are skipped."""
    return [line.strip() for line in Path(txt_file).read_text().splitlines() if line.strip()]


def export_vbench_videos(
    prompts: Sequence[str],
    sample_latents: Callable[[str, torch.Generator], torch.Tensor],
    decode: Callable[[torch.Tensor], torch.Tensor],
    out_dir: str,
    fps: int = 16,
    seeds: Sequence[int] = (0,),
) -> List[str]:
    """Sample, decode and export one mp4 per (prompt, seed), named as the
    VBench toolkit reads them (``<prompt>-<seed>.mp4``). ``sample_latents``
    takes a CPU generator seeded with the seed."""
    paths = []
    for prompt in prompts:
        for seed in seeds:
            lat = sample_latents(prompt, torch.Generator().manual_seed(seed))
            video = decode(lat)[0].float().cpu().numpy()  # [T, H, W, 3]
            safe = prompt[:180].replace("/", "_")
            paths.append(write_mp4(f"{out_dir}/{safe}-{seed}.mp4", video, fps=fps))
    return paths
