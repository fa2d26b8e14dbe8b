"""Query/key feature maps for linear attention: the stateless maps of
``mhla_tpu/ops/feature_maps.py``. The learnable maps live in the JAX
package's ``layers/feature_maps.py`` and are not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def relu_map(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def elu_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def identity_map(x: torch.Tensor) -> torch.Tensor:
    return x


def softmax_map(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def exp_map(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x - torch.amax(x, dim=-1, keepdim=True).detach())


def dpfp_map(x: torch.Tensor, nu: int = 1) -> torch.Tensor:
    """Deterministic Parameter-Free Projection (DPFP) feature map."""
    x_pos_neg = torch.cat([F.relu(x), F.relu(-x)], dim=-1)
    rolled = torch.cat(
        [torch.roll(x_pos_neg, shifts=-(j + 1), dims=-1) for j in range(nu)], dim=-1
    )
    tiled = torch.cat([x_pos_neg] * nu, dim=-1)
    return tiled * rolled


def t2r_map(x: torch.Tensor) -> torch.Tensor:
    """Transformers-to-RNNs style map without the learned projection."""
    return F.relu(x)


FEATURE_MAPS = {
    "relu": relu_map,
    "elu": elu_map,
    "identity": identity_map,
    "softmax": softmax_map,
    "exp": exp_map,
    "dpfp": dpfp_map,
    "t2r": t2r_map,
}


def get_feature_map(name: str | None):
    if name is None:
        return identity_map
    if name not in FEATURE_MAPS:
        raise NotImplementedError(f"Not supported feature map `{name}`.")
    return FEATURE_MAPS[name]
