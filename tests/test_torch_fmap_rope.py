"""Port of the fused feature map + rotary (K1) and of the rotary and
feature-map ops, held against the JAX package on the CPU.

On the CPU the port's wrapper runs its plain version; the JAX kernel runs
its Pallas body in interpret mode (T = 1 takes the JAX jnp path, as on a
TPU). Inputs come from numpy with a fixed seed and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import fused_fmap_rope_flat as jax_fused_fmap_rope_flat
from mhla_tpu.ops import feature_maps as jax_feature_maps
from mhla_tpu.ops import rotary as jax_rotary
from mhla_tpu_torch.kernels import fmap_rope
from mhla_tpu_torch.ops import feature_maps, rotary
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32 elementwise on both sides with bit-identical tables: only the
# compilers' FMA contraction and exp differ, a few float32 ulp (~1e-7)
TOL = 1e-6
H, DH, MAX_LEN = 2, 128, 512


@pytest.fixture(autouse=True)
def _force_interpret():
    from mhla_tpu.kernels import mhla_chunk_pallas as mod

    mod.FORCE_INTERPRET = True
    yield
    mod.FORCE_INTERPRET = False


def _x(t: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((2, t, H * DH)).astype(np.float32)


def test_tables_bit_identical():
    cos_j, sin_j = jax_rotary.rotary_cos_sin(MAX_LEN, DH)
    cos, sin = rotary.rotary_cos_sin(MAX_LEN, DH)
    np.testing.assert_array_equal(np.asarray(cos_j), cos.numpy())
    np.testing.assert_array_equal(np.asarray(sin_j), sin.numpy())
    xpos_j = jax_rotary.rotary_xpos_tables(MAX_LEN, DH)
    for a, b in zip(xpos_j, rotary.rotary_xpos_tables(MAX_LEN, DH)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("fmap", ["relu", "elu", "identity"])
@pytest.mark.parametrize("t,offset", [(256, 0), (256, 37), (1, 0), (1, 300)])
def test_fused_fmap_rope_matches_jax(fmap, t, offset):
    x = _x(t)
    cos_j, sin_j = jax_rotary.rotary_cos_sin(MAX_LEN, DH)
    ref = jax_fused_fmap_rope_flat(jnp.asarray(x), cos_j, sin_j, H, fmap, offset=offset)
    cos, sin = rotary.rotary_cos_sin(MAX_LEN, DH)
    out = fmap_rope.fused_fmap_rope_flat(torch.from_numpy(x), cos, sin, H, fmap, offset=offset)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert_close(f"fmap_rope {fmap} t={t} offset={offset}", np.asarray(ref), out, TOL)


def test_apply_rotary_matches_jax():
    x = _x(64).reshape(2, 64, H, DH)
    cos_j, sin_j = jax_rotary.rotary_cos_sin(MAX_LEN, DH)
    cos, sin = rotary.rotary_cos_sin(MAX_LEN, DH)
    ref = jax_rotary.apply_rotary(jnp.asarray(x), cos_j, sin_j, offset=5)
    out = rotary.apply_rotary(torch.from_numpy(x), cos, sin, offset=5)
    assert_close("apply_rotary", np.asarray(ref), out, TOL)
    ref_flat = jax_rotary.apply_rotary_flat(
        jnp.asarray(x.reshape(2, 64, -1)), cos_j, sin_j, H, offset=5
    )
    out_flat = rotary.apply_rotary_flat(torch.from_numpy(x.reshape(2, 64, -1)), cos, sin, H, 5)
    assert_close("apply_rotary_flat", np.asarray(ref_flat), out_flat, TOL)


@pytest.mark.parametrize("name", sorted(feature_maps.FEATURE_MAPS))
def test_feature_maps_match_jax(name):
    x = _x(16).reshape(2, 16, H, DH)
    ref = jax_feature_maps.get_feature_map(name)(jnp.asarray(x))
    out = feature_maps.get_feature_map(name)(torch.from_numpy(x))
    assert_close(f"feature map {name}", np.asarray(ref), out, TOL)


def test_context_bound_raises():
    cos, sin = rotary.rotary_cos_sin(MAX_LEN, DH)
    x = torch.from_numpy(_x(1))
    fmap_rope.fused_fmap_rope_flat(x, cos, sin, H, "relu", offset=MAX_LEN - 1)
    with pytest.raises(ValueError, match="context bound"):
        fmap_rope.fused_fmap_rope_flat(x, cos, sin, H, "relu", offset=MAX_LEN)


@pytest.mark.parametrize("dh", [64, 96, 128, 256, 384])
def test_kernel_route_is_jaxs_head_dim_term(dh):
    """K1's route is JAX's: where JAX's ``_use_kernel`` takes its Pallas kernel
    (interpret mode here, T a multiple of 8, so only Dh % 128 decides), the
    port launches K1; elsewhere both run the plain rotary."""
    from mhla_tpu.kernels import fmap_rope_pallas

    assert fmap_rope.kernel_route(dh) == fmap_rope_pallas._use_kernel(256, dh)


def test_off_route_head_dim_matches_jax_forward_and_gradient():
    """Dk = 96 (hidden 768, 4 heads, expand_k 0.5), where JAX runs jnp: the
    port's forward and its gradient (plain PyTorch under autograd) against
    JAX's ``fused_fmap_rope_flat`` and ``jax.grad``."""
    import jax

    h, dh, t = 4, 96, 24
    x = np.random.default_rng(3).standard_normal((2, t, h * dh)).astype(np.float32)
    w = np.random.default_rng(4).standard_normal((2, t, h * dh)).astype(np.float32)
    cos_j, sin_j = jax_rotary.rotary_cos_sin(64, dh)
    cos, sin = rotary.rotary_cos_sin(64, dh)
    assert not fmap_rope.kernel_route(dh)

    def loss_j(xj):
        return (jax_fused_fmap_rope_flat(xj, cos_j, sin_j, h, "elu", offset=5) * w).sum()

    ref, ref_grad = jax.value_and_grad(loss_j)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = fmap_rope.fused_fmap_rope_flat(xt, cos, sin, h, "elu", offset=5)
    (out * torch.from_numpy(w)).sum().backward()
    assert_close("fmap_rope Dh=96", np.asarray(jax_fused_fmap_rope_flat(
        jnp.asarray(x), cos_j, sin_j, h, "elu", offset=5)), out.detach(), TOL)
    assert_close("fmap_rope Dh=96 grad", np.asarray(ref_grad), xt.grad, TOL)
    assert np.isfinite(float(ref))
