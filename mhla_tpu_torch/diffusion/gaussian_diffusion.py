"""Gaussian diffusion (DDPM / IDDPM) for the DiT and rectified flow matching
for the video model (counterpart of ``mhla_tpu/diffusion/gaussian_diffusion.py``;
the FlowEuler sampler of that module lives in ``dpm_solver.py``).

- beta schedules ``linear`` (scaled DDPM) and ``squaredcos_cap_v2``
  (IDDPM), uniform timestep respacing (one section, e.g. '250');
- model mean types ``epsilon`` (DiT), ``x_start`` and ``velocity``;
  variances fixed small / large or ``learned_range`` (DiT's learn_sigma);
- losses: the MSE, plus for a learned range the VB term, the KL of the
  true posterior against the model's with the mean frozen, at every t
  (t = 0 included, as the JAX function computes it);
- samplers: ancestral ``p_sample_loop`` and ``ddim_sample_loop``, one model
  call a step in a Python loop.

The tables are numpy float64, rounded once to float32 where they are
gathered by timestep, as the JAX module casts them. Where the JAX functions
draw from a key, these take a ``torch.Generator`` (on the device of what
they draw) or the ready-made numbers, so a caller can hand both packages
the same draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def make_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(scale * 1e-4, scale * 0.02, num_steps, dtype=np.float64)
    if name == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = [
            min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), 0.999)
            for i in range(num_steps)
        ]
        return np.asarray(betas, dtype=np.float64)
    raise ValueError(f"unknown beta schedule {name}")


def space_timesteps(num_timesteps: int, count: int) -> np.ndarray:
    """Uniformly respaced timestep subset (one section, e.g. '250')."""
    frac = num_timesteps / count
    cur, taken = 0.0, []
    for _ in range(count):
        taken.append(round(cur))
        cur += frac
    return np.asarray(sorted(set(taken)), dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    betas: Tuple[float, ...]
    mean_type: str = "epsilon"  # epsilon | x_start | velocity (flow)
    var_type: str = "learned_range"  # fixed_small | fixed_large | learned_range
    # float32 copies of the tables by (name, device), made at first use
    _cache: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def _np(self) -> Dict[str, np.ndarray]:
        if "np" not in self._cache:
            betas = np.asarray(self.betas, dtype=np.float64)
            alphas = 1.0 - betas
            acp = np.cumprod(alphas)
            acp_prev = np.append(1.0, acp[:-1])
            post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
            self._cache["np"] = dict(
                betas=betas,
                log_betas=np.log(betas),
                alphas_cumprod=acp,
                alphas_cumprod_prev=acp_prev,
                sqrt_acp=np.sqrt(acp),
                sqrt_om_acp=np.sqrt(1.0 - acp),
                sqrt_recip_acp=np.sqrt(1.0 / acp),
                sqrt_recipm1_acp=np.sqrt(1.0 / acp - 1.0),
                posterior_variance=post_var,
                posterior_log_var_clipped=np.log(np.append(post_var[1], post_var[1:])),
                log_var_large=np.log(np.append(post_var[1], betas[1:])),
                posterior_mean_c0=betas * np.sqrt(acp_prev) / (1.0 - acp),
                posterior_mean_ct=(1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
            )
        return self._cache["np"]

    def _g(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """The float32 table ``name`` at timesteps t [B], shaped [B, 1, ...]
        to broadcast against a tensor of ``ndim`` dims."""
        key = (name, t.device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self._np()[name], dtype=torch.float32,
                                               device=t.device)
        out = self._cache[key][t]
        return out.reshape(out.shape + (1,) * (ndim - 1))

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    # ---- forward process --------------------------------------------------
    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return self._g("sqrt_acp", t, x0.ndim) * x0 + self._g("sqrt_om_acp", t, x0.ndim) * noise

    # ---- training ---------------------------------------------------------
    def training_losses(
        self,
        model: Callable[..., torch.Tensor],
        x0: torch.Tensor,
        t: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        model_kwargs: Optional[dict] = None,
    ) -> Dict[str, torch.Tensor]:
        """Per-sample float32 ``mse``, ``loss`` (mse + vb) and, with a learned
        range, ``vb``, of ``model(x_t, t)`` on NHWC x0 at integer timesteps t
        [B]. ``noise`` is drawn from ``generator`` (standard normal, x0's
        shape, dtype and device) unless given."""
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
        x_t = self.q_sample(x0, t, noise)
        out = model(x_t, t, **(model_kwargs or {}))
        c = x0.shape[-1]
        vb = None
        if self.var_type == "learned_range":
            out, var_raw = out[..., :c], out[..., c:]
            vb = self._vb_term(out, var_raw, x0, x_t, t)
        if self.mean_type == "epsilon":
            target = noise
        elif self.mean_type == "x_start":
            target = x0
        elif self.mean_type == "velocity":
            target = noise - x0
        else:
            raise ValueError(self.mean_type)
        mse = torch.mean(torch.square(out.float() - target.float()),
                         dim=tuple(range(1, x0.ndim)))
        losses = {"mse": mse, "loss": mse + (vb if vb is not None else 0.0)}
        if vb is not None:
            losses["vb"] = vb
        return losses

    def _vb_term(self, eps_pred, var_raw, x0, x_t, t):
        """KL (bits) of the true posterior against the model's with the
        learned-range variance; the mean is detached, so the term trains the
        variance head alone."""
        n = x0.ndim
        true_mean = self._g("posterior_mean_c0", t, n) * x0 + self._g("posterior_mean_ct", t, n) * x_t
        true_logvar = self._g("posterior_log_var_clipped", t, n)
        mean, logvar = self._p_mean_logvar(eps_pred.detach(), var_raw, x_t, t)
        kl = 0.5 * (-1.0 + logvar - true_logvar + torch.exp(true_logvar - logvar)
                    + torch.square(true_mean - mean) * torch.exp(-logvar))
        return torch.mean(kl, dim=tuple(range(1, n))) / math.log(2.0)

    # ---- reverse process ---------------------------------------------------
    def predict_x0(self, model_out: torch.Tensor, x_t: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
        n = x_t.ndim
        if self.mean_type == "epsilon":
            return self._g("sqrt_recip_acp", t, n) * x_t - self._g("sqrt_recipm1_acp", t, n) * model_out
        if self.mean_type == "x_start":
            return model_out
        if self.mean_type == "velocity":
            # v = eps - x0 and x_t = alp x0 + sig eps  =>  x0 = (x_t - sig v) / (alp + sig)
            sig, alp = self._g("sqrt_om_acp", t, n), self._g("sqrt_acp", t, n)
            return (x_t - sig * model_out) / (alp + sig)
        raise ValueError(self.mean_type)

    def _p_mean_logvar(self, model_out, var_raw, x_t, t, clip: bool = True):
        n = x_t.ndim
        if self.var_type == "learned_range":
            frac = (var_raw.float() + 1) / 2
            logvar = (frac * self._g("log_betas", t, n)
                      + (1 - frac) * self._g("posterior_log_var_clipped", t, n))
        elif self.var_type == "fixed_small":
            logvar = self._g("posterior_log_var_clipped", t, n)
        else:  # fixed_large
            logvar = self._g("log_var_large", t, n)
        x0 = self.predict_x0(model_out.float(), x_t, t)
        if clip:
            x0 = x0.clamp(-1.0, 1.0)
        mean = self._g("posterior_mean_c0", t, n) * x0 + self._g("posterior_mean_ct", t, n) * x_t
        return mean, logvar

    def _loop(self, step, model, shape, generator, model_kwargs, timestep_map, noise,
              step_noises, device):
        """The shared sampler loop: the respaced index i from n - 1 down to 0,
        the model called at the original timestep ``timestep_map[i]``, ``step``
        giving the next x from the model's output and the step's noise. The
        start and the steps' noises (one per step, in the loop's order) are
        drawn from ``generator`` unless given, as the JAX loop draws each
        step's noise, the last step's too."""
        kw = model_kwargs or {}
        sub = self._respaced(timestep_map)
        n = sub.num_timesteps
        t_map = timestep_map if timestep_map is not None else np.arange(self.num_timesteps)
        x = noise if noise is not None else torch.randn(
            tuple(shape), generator=generator, dtype=torch.float32, device=device)
        for k, i in enumerate(range(n - 1, -1, -1)):
            b = x.shape[0]
            t_model = torch.full((b,), int(t_map[i]), dtype=torch.int32, device=x.device)
            t_sub = torch.full((b,), i, dtype=torch.long, device=x.device)
            out = model(x, t_model, **kw)
            z = step_noises[k] if step_noises is not None else torch.randn(
                x.shape, generator=generator, dtype=x.dtype, device=x.device)
            x = step(sub, x, out, t_sub, z, i)
        return x

    def p_sample_loop(
        self,
        model: Callable[..., torch.Tensor],
        shape: Sequence[int],
        generator: Optional[torch.Generator] = None,
        model_kwargs: Optional[dict] = None,
        timestep_map: Optional[np.ndarray] = None,
        clip_denoised: bool = True,
        noise: Optional[torch.Tensor] = None,
        step_noises: Optional[Sequence[torch.Tensor]] = None,
        device=None,
    ) -> torch.Tensor:
        """Ancestral sampling over the (respaced) steps, float32 NHWC."""
        c = shape[-1]

        def step(sub, x, out, t_sub, z, i):
            pred, var_raw = (out[..., :c], out[..., c:]) if sub.var_type == "learned_range"                 else (out, None)
            mean, logvar = sub._p_mean_logvar(pred, var_raw, x, t_sub, clip_denoised)
            return mean + torch.exp(0.5 * logvar) * z if i != 0 else mean

        return self._loop(step, model, shape, generator, model_kwargs, timestep_map, noise,
                          step_noises, device)

    def ddim_sample_loop(
        self,
        model: Callable[..., torch.Tensor],
        shape: Sequence[int],
        generator: Optional[torch.Generator] = None,
        model_kwargs: Optional[dict] = None,
        timestep_map: Optional[np.ndarray] = None,
        eta: float = 0.0,
        clip_denoised: bool = True,
        noise: Optional[torch.Tensor] = None,
        step_noises: Optional[Sequence[torch.Tensor]] = None,
        device=None,
    ) -> torch.Tensor:
        """DDIM over the (respaced) steps, float32 NHWC; ``eta`` 0 is
        deterministic."""
        ch = shape[-1]

        def step(sub, x, out, t_sub, z, i):
            pred = out[..., :ch] if sub.var_type == "learned_range" else out
            x0 = sub.predict_x0(pred.float(), x, t_sub)
            if clip_denoised:
                x0 = x0.clamp(-1, 1)
            a_t = sub._g("alphas_cumprod", t_sub, x.ndim)
            a_prev = sub._g("alphas_cumprod_prev", t_sub, x.ndim)
            eps = (torch.sqrt(1.0 / a_t) * x - x0) / torch.sqrt(1.0 / a_t - 1)
            sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t)) * torch.sqrt(1 - a_t / a_prev)
            mean = torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev - sigma ** 2) * eps
            return mean + sigma * z if i != 0 else mean

        return self._loop(step, model, shape, generator, model_kwargs, timestep_map, noise,
                          step_noises, device)

    def _respaced(self, timestep_map: Optional[np.ndarray]) -> "GaussianDiffusion":
        """The diffusion over the respaced beta subsequence."""
        if timestep_map is None:
            return self
        key = ("respaced", tuple(int(i) for i in timestep_map))
        if key not in self._cache:
            acp = self._np()["alphas_cumprod"][timestep_map]
            new_betas = 1.0 - acp / np.append(1.0, acp[:-1])
            self._cache[key] = GaussianDiffusion(tuple(new_betas.tolist()), self.mean_type,
                                                 self.var_type)
        return self._cache[key]


def create_diffusion(
    timestep_respacing: Optional[str] = None,
    noise_schedule: str = "linear",
    diffusion_steps: int = 1000,
    learn_sigma: bool = True,
    mean_type: str = "epsilon",
) -> Tuple[GaussianDiffusion, Optional[np.ndarray]]:
    """(diffusion, timestep_map): pass the map to the sample loops."""
    betas = make_beta_schedule(noise_schedule, diffusion_steps)
    diff = GaussianDiffusion(tuple(betas.tolist()), mean_type,
                             "learned_range" if learn_sigma else "fixed_small")
    t_map = None
    if timestep_respacing:
        t_map = space_timesteps(diffusion_steps, int(timestep_respacing))
    return diff, t_map


def flow_q_sample(x0: torch.Tensor, t01: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Linear-flow interpolation x_t = (1 - t) x0 + t noise for t [B] in [0, 1]."""
    t = t01.reshape(t01.shape + (1,) * (x0.ndim - 1))
    return (1 - t) * x0 + t * noise


def flow_training_loss(
    model: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    t01: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    model_kwargs: Optional[dict] = None,
) -> Dict[str, torch.Tensor]:
    """Flow-velocity MSE per sample, float32: ``model(x_t, t01)`` against the
    target ``noise - x0``. ``noise`` is drawn from ``generator`` (standard
    normal, x0's shape, dtype and device) unless given."""
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
    v = model(flow_q_sample(x0, t01, noise), t01, **(model_kwargs or {}))
    target = noise - x0
    mse = torch.mean(torch.square(v.float() - target.float()), dim=tuple(range(1, x0.ndim)))
    return {"loss": mse, "mse": mse}


def logit_normal_timesteps(
    batch: int,
    mean: float = 0.0,
    std: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Logit-normal t [batch] in (0, 1): the sigmoid of a normal(mean, std)
    draw from ``generator`` on ``device``, float32."""
    u = torch.randn(batch, generator=generator, dtype=torch.float32, device=device)
    return torch.sigmoid(u * std + mean)
