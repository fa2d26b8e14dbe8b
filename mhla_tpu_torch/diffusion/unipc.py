"""UniPC multistep predictor-corrector sampler for flow matching
(counterpart of ``mhla_tpu/diffusion/unipc.py``).

The UniPC-p / UniC-p updates (Zhao et al., 2023; bh2 variant, data
prediction) as diffusers' ``UniPCMultistepScheduler`` runs them with flow
sigmas and a ``flow_shift``. Every per-step scalar (logSNR gaps, B(h), the
R-matrix solves for the D1 weights) depends only on the timestep grid and
is computed on the host with numpy, as in the JAX package; the loop spends
one model call a step, the corrector reusing the next step's output (PEC).

Conventions as :mod:`.dpm_solver`: alpha_t = 1 - t, sigma_t = t;
``model_x0(x_t, t)`` is the data prediction (wrap a velocity model with
``flow_velocity_to_x0``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .dpm_solver import Model, _flow_grid


def _unipc_coefficients(ts: np.ndarray, order: int):
    """Per-transition UniPC scalars from the grid ``ts``, stacked over the
    transitions i (t_i -> t_{i+1}), float32:

    - ``sig_ratio, a1, a2``: sigma_{i+1} / sigma_i, alpha * phi1, alpha * B(h)
    - ``wp[i, j]``: the predictor's D1 weight on history slot j + 1 (slot 0
      is m_i itself), divided by r_j, so the update is a weighted sum of
      (M[j + 1] - M[0])
    - ``wc[i, j], wc_new[i]``: the corrector's weights, applied one step
      later with the model output at t_{i+1} as the new point
    """
    n = ts.shape[0] - 1
    eps = 1e-7
    lam = np.log(np.clip(1.0 - ts, eps, None)) - np.log(np.clip(ts, eps, None))
    sig, alp = ts, 1.0 - ts
    sig_ratio, a1, a2 = np.zeros(n), np.zeros(n), np.zeros(n)
    wp, wc, wc_new = np.zeros((n, order)), np.zeros((n, order)), np.zeros(n)

    for i in range(n):
        # diffusers' order policy: warm up 1, 2, ..., taper to 1 at the end
        p = min(order, i + 1, n - i)
        h = lam[i + 1] - lam[i]
        hh = -h  # the data prediction's sign
        h_phi_1 = math.expm1(hh)
        sig_ratio[i] = sig[i + 1] / max(sig[i], eps)
        a1[i] = alp[i + 1] * h_phi_1
        b_h = math.expm1(hh)  # bh2: B(h) = expm1(hh)
        a2[i] = alp[i + 1] * b_h

        # r_k of the p - 1 older history points (slot j holds m_{i-j})
        rks = np.asarray([(lam[i - j] - lam[i]) / h for j in range(1, p)] + [1.0])
        R = np.stack([rks**k for k in range(p)])
        b = np.zeros(p)
        h_phi_k = h_phi_1 / hh - 1.0
        fact = 1.0
        for k in range(1, p + 1):
            b[k - 1] = h_phi_k * fact / b_h
            fact *= k + 1
            h_phi_k = h_phi_k / hh - 1.0 / fact

        if p > 1:  # predictor: the (p - 1)-system over the older points
            rhos_p = np.linalg.solve(R[: p - 1, : p - 1], b[: p - 1])
            for j in range(1, p):
                wp[i, j - 1] = rhos_p[j - 1] / rks[j - 1]
        # corrector of this transition: the p-system with the new point
        rhos_c = np.asarray([0.5]) if p == 1 else np.linalg.solve(R, b)
        for j in range(1, p):
            wc[i, j - 1] = rhos_c[j - 1] / rks[j - 1]
        wc_new[i] = rhos_c[-1]

    return tuple(a.astype(np.float32) for a in (sig_ratio, a1, a2, wp, wc, wc_new))


def unipc_sample(
    model_x0: Model,
    x: torch.Tensor,
    num_steps: int = 25,
    order: int = 2,
    shift: float = 1.0,
    use_corrector: bool = True,
) -> torch.Tensor:
    """UniPC-p with the UniC corrector over the flow schedule, from the
    noise ``x``: one model call a step, the corrector reusing the next
    step's model output, as diffusers' scheduler loop does."""
    ts = _flow_grid(num_steps, shift)
    sig_ratio, a1, a2, wp, wc, wc_new = _unipc_coefficients(ts, order)
    ts = ts.astype(np.float32)

    def d1_sum(w_row, hist):  # the D1 terms over history slots 1..order
        return sum(float(w_row[j]) * (hist[j + 1] - hist[0]) for j in range(order))

    x = x.float()
    hist = [torch.zeros_like(x)] * (order + 1)  # model outputs, newest first
    last_x = None
    for i in range(num_steps):
        t = torch.full((x.shape[0],), float(ts[i]), dtype=torch.float32, device=x.device)
        m_new = model_x0(x, t).float()
        if use_corrector and i > 0:
            # correct the (i-1) -> i transition with the model output at t_i
            d1 = d1_sum(wc[i - 1], hist) + float(wc_new[i - 1]) * (m_new - hist[0])
            x = (float(sig_ratio[i - 1]) * last_x - float(a1[i - 1]) * hist[0]
                 - float(a2[i - 1]) * d1)
        hist = [m_new] + hist[:-1]
        # predictor i -> i+1
        last_x, x = x, (float(sig_ratio[i]) * x - float(a1[i]) * hist[0]
                        - float(a2[i]) * d1_sum(wp[i], hist))
    return x
