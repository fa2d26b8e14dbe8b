"""Port of the non-causal flash-attention forward (K9) and of ``sdpa``, held
against ``mhla_tpu.kernels.flash_attention`` and ``mhla_tpu.layers.sdpa`` on
the CPU, where the JAX side takes its reference route and the port its
plain version. Inputs come from numpy with fixed seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from mhla_tpu.layers import sdpa as jax_sdpa
from mhla_tpu_torch.kernels import flash_attention as flash
from mhla_tpu_torch.layers import attention
from mhla_tpu_torch.utils import assert_close

# float32 on both sides, the same arithmetic in another summation order
TOL = 1e-5


def _qkv(b, tq, tk, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32) for t in (tq, tk, tk))


# lengths that are multiples of no tile (the kernel's are 64 x 64), Tq != Tk and Tq == Tk
@pytest.mark.parametrize("tq,tk", [(70, 33), (33, 70), (130, 130), (1, 5), (257, 64)])
def test_flash_attention_matches_jax(tq, tk):
    q, k, v = _qkv(2, tq, tk, 2, 128, seed=tq + tk)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = dict(flash.launches)
    out = flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert flash.launches == before  # CPU tensors: the plain version, no launch
    assert out.shape == (2, tq, 2, 128)
    assert_close(f"flash_attention {tq}x{tk}", np.asarray(ref), out, TOL)


def test_flash_attention_scale_and_plain_agree():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 40, 50, 2, 64, seed=3))
    ref = jax_flash_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)), scale=0.3)
    assert_close("scale", np.asarray(ref), flash.flash_attention(q, k, v, scale=0.3), TOL)
    assert torch.equal(flash.flash_attention(q, k, v), flash.flash_attention_plain(q, k, v))


def test_flash_plain_rounds_probabilities_like_the_kernel_in_bf16():
    """bf16 inputs: the result stays within bf16 rounding of the float32 one."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 70, 90, 2, 128, seed=5))
    ref = flash.flash_attention_plain(q, k, v)
    out = flash.flash_attention_plain(*(a.to(torch.bfloat16) for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    assert_close("bf16 plain", ref, out, 2e-2)


@pytest.mark.parametrize("tq,tk", [(40, 16), (2100, 130)])  # short: plain; long: flash route
def test_sdpa_matches_jax(tq, tk, monkeypatch):
    q, k, v = _qkv(1, tq, tk, 2, 128, seed=7)
    routed = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a: routed.append("flash") or flash.flash_attention(*a))
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = attention.sdpa(*(torch.from_numpy(a) for a in (q, k, v)))
    assert_close(f"sdpa {tq}x{tk}", np.asarray(ref), out, TOL)
    assert routed == (["flash"] if tq >= 2048 else [])


def test_unported_attention_options_raise():
    q = torch.zeros(1, 8, 2, 128)
    with pytest.raises(NotImplementedError):
        flash.flash_attention(q, q, q, causal=True)
    with pytest.raises(NotImplementedError):
        flash.flash_attention(q, q, q, segment_ids=torch.zeros(1, 8, dtype=torch.long))
    for kwargs in ({"causal": True}, {"window": 4}, {"mask": torch.ones(1, 1, 8, 8).bool()},
                   {"segment_ids": torch.zeros(1, 8, dtype=torch.long)}):
        with pytest.raises(NotImplementedError):
            attention.sdpa(q, q, q, **kwargs)
    with pytest.raises(NotImplementedError):
        attention.SelfAttention(dim=256, num_heads=2)
    with pytest.raises(ValueError):  # k and v disagree
        flash.flash_attention(q, q, torch.zeros(1, 9, 2, 128))
