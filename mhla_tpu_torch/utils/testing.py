"""Relative-error comparison utilities (counterpart of
``mhla_tpu/utils/testing.py``): the same relative-RMS semantics, so a
tolerance means the same thing in both packages. Accepts torch tensors
(any device, any float dtype) and anything ``numpy.asarray`` takes."""

from __future__ import annotations

import numpy as np
import torch


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64).ravel()


def get_abs_err(x, y) -> float:
    return float(np.max(np.abs(_np64(x) - _np64(y))))


def get_err_ratio(x, y) -> float:
    """Relative RMS error: ||x - y||_rms / ||x||_rms."""
    x, y = _np64(x), _np64(y)
    err = np.sqrt(np.mean(np.square(x - y)))
    base = np.sqrt(np.mean(np.square(x)))
    return float(err / (base + 1e-20))


def assert_close(prefix: str, ref, tri, ratio: float):
    """Raise ``AssertionError`` unless the relative RMS error of ``tri``
    against ``ref`` is below ``ratio``."""
    rel_err = get_err_ratio(ref, tri)
    if not rel_err < ratio:
        raise AssertionError(
            f"{prefix} diff: {get_abs_err(ref, tri):.6f} ratio: {rel_err:.6f}"
        )
