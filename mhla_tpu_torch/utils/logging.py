"""Logging and metric buffering (counterpart of
``mhla_tpu/utils/logging.py``): a file + stdout root logger, windowed
running averages and a throughput tracker. The wandb sink is not ported:
it does nothing when off and raises when on."""

from __future__ import annotations

import logging
import sys
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Any, Dict, Optional


def get_root_logger(
    log_file: Optional[str] = None, level: int = logging.INFO, name: str = "mhla_tpu_torch"
) -> logging.Logger:
    """The named logger with a stdout handler and, the first time it is
    built, a file handler on ``log_file``."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class LogBuffer:
    """Windowed running averages of scalar metrics."""

    def __init__(self, window: int = 50):
        self.window = window
        self._vals: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window))

    def update(self, **metrics: float) -> None:
        for k, v in metrics.items():
            self._vals[k].append(float(v))

    def average(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._vals.items() if v}


class Throughput:
    """Items per second and ETA between successive calls (host clock)."""

    def __init__(self, total_steps: int):
        self.total_steps = total_steps
        self.start = time.perf_counter()
        self.last = self.start
        self.last_step = 0

    def step(self, step: int, items: int) -> Dict[str, float]:
        now = time.perf_counter()
        dt = max(now - self.last, 1e-9)
        d_steps = max(step - self.last_step, 1)
        out = {
            "steps_per_sec": d_steps / dt,
            "items_per_sec": items * d_steps / dt,
            "eta_hours": (self.total_steps - step) / (d_steps / dt) / 3600,
        }
        self.last, self.last_step = now, step
        return out


class WandbSink:
    """wandb logging is not ported: a no-op when off, ``NotImplementedError``
    when asked for."""

    def __init__(self, enable: bool, project: str = "", name: str = "", config: Any = None):
        if enable:
            raise NotImplementedError("wandb logging is not ported")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        pass

    def finish(self) -> None:
        pass
