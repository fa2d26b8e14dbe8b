"""SA-Solver: stochastic Adams predictor-corrector sampling (counterpart of
``mhla_tpu/diffusion/sa_solver.py``).

Data prediction, predictor and corrector of order 2, PEC mode, the
stochastic tau active for t in [0.2, 0.8], as the reference's
``sa_sampler.py`` runs the paper's implementation. The exponential-Adams
coefficients (SA-Solver Eq. 15 / 18: Lagrange interpolation over logSNRs
integrated against exp((1 + tau^2) x) x^k) depend only on the timestep
grid, so they are computed on the host with numpy, as in the JAX package.

Supports the rectified-flow schedule (video: alpha = 1 - t, sigma = t) and
a discrete DDPM ``alphas_cumprod`` schedule. ``model_x0(x_t, t)`` is a data
prediction at continuous t in (0, 1].
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .dpm_solver import Model, _flow_grid


def flow_lambdas(ts: np.ndarray, eps: float = 1e-7) -> Tuple[np.ndarray, ...]:
    """(alpha, sigma, lambda) of the rectified-flow schedule."""
    alp = np.clip(1.0 - ts, eps, None)
    sig = np.clip(ts, eps, None)
    return alp, sig, np.log(alp) - np.log(sig)


def discrete_lambdas(
    ts: np.ndarray, alphas_cumprod: np.ndarray, eps: float = 1e-7
) -> Tuple[np.ndarray, ...]:
    """(alpha, sigma, lambda) of a discrete VP schedule: log(alpha_bar) / 2
    interpolated on t in [1/N, 1] (NoiseScheduleVP's 'discrete' form)."""
    n = alphas_cumprod.shape[0]
    grid = np.arange(1, n + 1) / n
    log_alpha = 0.5 * np.log(np.clip(alphas_cumprod, eps, None))
    la = np.interp(ts, grid, log_alpha)
    alp = np.exp(la)
    sig = np.sqrt(np.clip(1.0 - alp**2, eps, None))
    return alp, sig, la - np.log(sig)


def _int_exp_pos(order: int, a: float, b: float, tau: float) -> float:
    """``int_a^b exp(x (1 + tau^2)) x^order dx`` in closed form, the overall
    exp(bc) factored out so the bracket holds exp(ac - bc) <= 1."""
    c = 1.0 + tau * tau
    bc, ac = c * b, c * a
    if order == 0:
        return math.exp(bc) * (1.0 - math.exp(ac - bc)) / c
    if order == 1:
        return math.exp(bc) * ((bc - 1.0) - (ac - 1.0) * math.exp(ac - bc)) / c**2
    if order == 2:
        return (math.exp(bc) * ((bc**2 - 2 * bc + 2) - (ac**2 - 2 * ac + 2) * math.exp(ac - bc))
                / c**3)
    if order == 3:
        return (math.exp(bc) * ((bc**3 - 3 * bc**2 + 6 * bc - 6)
                                - (ac**3 - 3 * ac**2 + 6 * ac - 6) * math.exp(ac - bc)) / c**4)
    raise ValueError(order)


def _lagrange_coeffs(lams: Sequence[float]) -> np.ndarray:
    """Row i: the polynomial coefficients (highest power first) of the
    Lagrange basis polynomial l_i over ``lams``."""
    k = len(lams)
    out = np.zeros((k, k))
    for i in range(k):
        poly, denom = np.poly1d([1.0]), 1.0
        for j in range(k):
            if j != i:
                poly = poly * np.poly1d([1.0, -lams[j]])
                denom *= lams[i] - lams[j]
        coeffs = poly.coeffs / denom
        out[i, k - len(coeffs):] = coeffs
    return out


def _gradient_coeffs(lam_list: Sequence[float], lam_start: float, lam_end: float,
                     tau: float) -> np.ndarray:
    """The model history interpolated over ``lam_list`` and integrated
    against the exponential kernel from ``lam_start`` to ``lam_end``."""
    k = len(lam_list)
    integrals = np.asarray([_int_exp_pos(k - 1 - j, lam_start, lam_end, tau) for j in range(k)])
    return _lagrange_coeffs(lam_list) @ integrals


def _order2_refinement(h: float, lam_end: float, tau: float) -> float:
    """The O(h^3) term of the 'few steps' mode: exp((1 + tau^2) lam_t) *
    (h^2 / 2 - (h (1 + tau^2) - 1 + exp(-(1 + tau^2) h)) / (1 + tau^2)^2)."""
    c = 1.0 + tau * tau
    return math.exp(c * lam_end) * (h * h / 2.0 - (h * c - 1.0 + math.exp(-c * h)) / (c * c))


def _sa_step_coeffs(alp, sig, lam, i_from: int, i_to: int, hist_lams: Sequence[float],
                    tau: float):
    """One update's (decay, weights on the history, noise std);
    ``hist_lams`` are the history's logSNRs, newest first (the corrector's
    first is the new point's)."""
    lam_s, lam_t = lam[i_from], lam[i_to]
    h = lam_t - lam_s
    g = _gradient_coeffs(hist_lams, lam_s, lam_t, tau)
    if len(hist_lams) == 2:
        # the O(h^3) refinement on the two newest points; the reference's
        # predictor divides by (lam_prev1 - lam_prev2) and its corrector by
        # h, both hist_lams[0] - hist_lams[1] here
        ref = _order2_refinement(h, lam_t, tau) / (hist_lams[0] - hist_lams[1])
        g = g + np.asarray([ref, -ref])
    scale = (1.0 + tau * tau) * sig[i_to] * math.exp(-tau * tau * lam_t)
    decay = math.exp(-tau * tau * h) * sig[i_to] / sig[i_from]
    noise_std = sig[i_to] * math.sqrt(max(1.0 - math.exp(-2.0 * tau * tau * h), 0.0))
    return decay, scale * g, noise_std


def sa_solver_sample(
    model_x0: Model,
    x: torch.Tensor,
    num_steps: int = 25,
    predictor_order: int = 2,
    corrector_order: int = 2,
    eta: float = 0.0,
    shift: float = 1.0,
    generator: Optional[torch.Generator] = None,
    ts: Optional[np.ndarray] = None,
    alphas_cumprod: Optional[np.ndarray] = None,
    tau_window: Tuple[float, float] = (0.2, 0.8),
) -> torch.Tensor:
    """SA-Solver sampling (PEC) from the noise ``x``: predict with
    stochastic Adams-Bashforth, evaluate once, correct with Adams-Moulton on
    that evaluation and the same noise draw. ``eta = 0`` gives the
    deterministic exponential-Adams ODE solver; tau = eta only for t inside
    ``tau_window``. The final transition runs at tau = 0 without evaluation
    or correction. ``generator`` (on ``x``'s device; seed 0 when None)
    draws one noise tensor a transition, whatever its std."""
    if ts is None:
        ts = _flow_grid(num_steps, shift)
    if alphas_cumprod is not None:
        alp, sig, lam = discrete_lambdas(ts, np.asarray(alphas_cumprod))
    else:
        alp, sig, lam = flow_lambdas(ts)
    n = num_steps
    taus = [eta if tau_window[0] <= t <= tau_window[1] else 0.0 for t in ts]
    max_hist = max(predictor_order, corrector_order)
    f32 = np.float32

    def coeffs(i: int, hist_lams, tau: float):
        d, w, s = _sa_step_coeffs(alp, sig, lam, i, i + 1, hist_lams, tau)
        return float(f32(d)), [float(f32(v)) for v in w], float(f32(s))

    if generator is None:
        generator = torch.Generator(x.device).manual_seed(0)
    x = x.float()
    t_of = lambda i: torch.full((x.shape[0],), float(f32(ts[i])), device=x.device)  # noqa: E731
    hist = [model_x0(x, t_of(0)).float()] + [torch.zeros_like(x)] * (max_hist - 1)
    for i in range(n):
        final = i == n - 1
        tau = 0.0 if final else float(taus[i + 1])
        z = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
        # order policy: warm up with the history available, taper to 1 at the end
        p = min(predictor_order, i + 1, n - i)
        dec, w, std = coeffs(i, [lam[i - j] for j in range(p)], tau)
        x_p = dec * x + sum(wj * hj for wj, hj in zip(w, hist)) + std * z
        if final:
            # the JAX scan spends one model call here and masks its result
            # out; skipping it gives the same output with one call fewer
            x = x_p
            break
        m_new = model_x0(x_p, t_of(i + 1)).float()
        c = min(corrector_order, i + 2, n - i + 1)
        dec, w, std = coeffs(i, [lam[i + 1]] + [lam[i - j] for j in range(c - 1)], tau)
        hist = [m_new] + hist[:-1]
        x = dec * x + sum(wj * hj for wj, hj in zip(w, hist)) + std * z
    return x
