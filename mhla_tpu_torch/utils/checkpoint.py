"""Checkpoints of a training run with ``latest``-symlink resume (counterpart
of ``mhla_tpu/utils/checkpoint.py``, which uses orbax).

Layout: ``<work_dir>/checkpoints/step_XXXXXXXX/state.pt`` (``torch.save`` of
the model's state dict without its frozen parameters, which a fine-tuning
run takes from their own source again, the optimizer state, the step and
the EMA) and a
``latest`` symlink to the newest step directory; the oldest step
directories beyond ``keep`` are pruned. ``state.pt`` is written to a
temporary name and renamed, so its presence marks a complete checkpoint:
an interrupted save leaves no ``state.pt`` and resume skips it.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch

_STATE = "state.pt"


def _ckpt_dir(work_dir: str, step: int) -> Path:
    return Path(work_dir) / "checkpoints" / f"step_{step:08d}"


def save_checkpoint(work_dir: str, step: int, state, keep: int = 3) -> str:
    """Save a ``TrainState`` (``train.trainer``) and point ``latest`` at it."""
    path = _ckpt_dir(work_dir, step)
    path.mkdir(parents=True, exist_ok=True)
    frozen = _frozen_names(state.model)
    payload = {
        "step": state.step,
        "model": {n: t for n, t in state.model.state_dict().items() if n not in frozen},
        "optimizer": state.optimizer.state_dict(),
        "ema": state.ema,
    }
    tmp = path / f"{_STATE}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path / _STATE)
    link = path.parent / "latest"
    if link.is_symlink() or link.exists():
        link.unlink()
    link.symlink_to(path.name)
    _prune(path.parent, keep)
    return str(path)


def _frozen_names(model) -> set:
    return {n for n, p in model.named_parameters() if not p.requires_grad}


def _prune(root: Path, keep: int) -> None:
    ckpts = sorted(p for p in root.glob("step_*") if p.is_dir())
    for p in ckpts[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def _is_complete(path: Path) -> bool:
    return (path / _STATE).exists()


def resolve_resume_path(work_dir: str, resume_from: str = "latest") -> Optional[str]:
    """The checkpoint to resume from ('latest' follows the symlink, else the
    newest complete step); incomplete checkpoints are skipped."""
    root = Path(work_dir) / "checkpoints"
    if resume_from == "latest":
        link = root / "latest"
        if link.exists() and _is_complete(link.resolve()):
            return str(link.resolve())
        ckpts = sorted(p for p in root.glob("step_*") if p.is_dir() and _is_complete(p))
        return str(ckpts[-1]) if ckpts else None
    p = Path(resume_from)
    return str(p) if p.exists() and _is_complete(p) else None


def load_checkpoint(path: str, state):
    """Restore a checkpoint into ``state`` in place (onto the devices its
    tensors live on) and return it."""
    payload = torch.load(Path(path) / _STATE, map_location="cpu", weights_only=True)
    missing, unexpected = state.model.load_state_dict(payload["model"], strict=False)
    missing = set(missing) - _frozen_names(state.model)  # frozen parameters are not saved
    if missing or unexpected:
        raise RuntimeError(f"checkpoint {path} does not fit the model: missing "
                           f"{sorted(missing)}, unexpected {sorted(unexpected)}")
    state.optimizer.load_state_dict(payload["optimizer"])  # copies onto the state's devices
    if state.ema is not None and payload["ema"] is not None:
        for name, t in payload["ema"].items():
            state.ema[name].copy_(t)
    state.step = int(payload["step"])
    return state


def load_model_params(path: str, model) -> None:
    """Load a model's weights, in place, from a checkpoint: ``path`` is a
    step directory or a run's ``work_dir`` (its newest complete checkpoint).
    The EMA weights replace the raw ones where the run kept an EMA, as the
    JAX package's ``load_params_from_checkpoint`` prefers them."""
    step_dir = path if _is_complete(Path(path)) else resolve_resume_path(path, "latest")
    if step_dir is None:
        raise FileNotFoundError(f"no complete checkpoint at {path}")
    payload = torch.load(Path(step_dir) / _STATE, map_location="cpu", weights_only=True)
    weights = dict(payload["model"])
    weights.update(payload.get("ema") or {})
    model.load_state_dict(weights, strict=True)


def checkpoint_step(path: str) -> int:
    name = os.path.basename(path.rstrip("/"))
    return int(name.split("_")[-1]) if name.startswith("step_") else -1
