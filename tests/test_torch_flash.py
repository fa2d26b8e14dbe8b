"""Port of the non-causal flash-attention forward (K9) and of ``sdpa``, held
against ``mhla_tpu.kernels.flash_attention`` and ``mhla_tpu.layers.sdpa`` on
the CPU, where the JAX side takes its reference route and the port its
plain version. Inputs come from numpy with fixed seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from mhla_tpu.layers import sdpa as jax_sdpa
from mhla_tpu_torch.kernels import flash_attention as flash
from mhla_tpu_torch.layers import attention
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

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
                        lambda *a, **kw: routed.append("flash") or flash.flash_attention(*a, **kw))
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = attention.sdpa(*(torch.from_numpy(a) for a in (q, k, v)))
    assert_close(f"sdpa {tq}x{tk}", np.asarray(ref), out, TOL)
    assert routed == (["flash"] if tq >= 2048 else [])


def test_unported_attention_options_raise():
    """The causal and segment-id forms are ported (``test_torch_attention.py``);
    what the JAX wrapper refuses the port refuses too: those forms need
    Tq == Tk."""
    q = torch.zeros(1, 8, 2, 128)
    with pytest.raises(ValueError):
        flash.flash_attention(q, q[:, :4], q[:, :4], causal=True)
    with pytest.raises(ValueError):
        flash.flash_attention(q, q[:, :4], q[:, :4],
                              segment_ids=torch.zeros(1, 8, dtype=torch.long))
    with pytest.raises(ValueError):  # k and v disagree
        flash.flash_attention(q, q, torch.zeros(1, 9, 2, 128))


# ---------------------------------------------------------------------------
# backward: K9b's plain version and the autograd Function
# ---------------------------------------------------------------------------


# Tq != Tk, ragged lengths, one key
@pytest.mark.parametrize("tq,tk", [(70, 33), (33, 70), (130, 130), (257, 64), (5, 1)])
def test_flash_attention_bwd_plain_matches_jax_grad(tq, tk):
    """dq, dk, dv from (q, k, v, o, lse, do) against ``jax.vjp`` of the JAX
    ``flash_attention`` (its CPU route), float32."""
    q, k, v = _qkv(2, tq, tk, 2, 128, seed=11 + tq + tk)
    do = np.random.default_rng(tq).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(jax_flash_attention, *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash.flash_attention_plain(qt, kt, vt, return_lse=True)
    assert lse.shape == (2, 2, tq) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * 128**-0.5
    assert_close("lse", torch.logsumexp(s, dim=-1), lse, 1e-6)
    before = dict(flash.launches)
    got = flash.flash_attention_bwd(qt, kt, vt, o, lse, dot)
    assert flash.launches == before  # CPU tensors: the plain version, no launch
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        assert g.shape == r.shape
        if name != "dv" and tk == 1:  # one key: P = 1, dS = 0, so dq and dk are rounding noise
            assert g.abs().max() < 1e-5 and np.abs(np.asarray(r)).max() < 1e-5
            continue
        assert_close(f"flash bwd {name} {tq}x{tk}", np.asarray(r), g, TOL)


def test_flash_attention_gradients_through_the_function_match_jax():
    """``flash_attention`` under autograd (the Function: forward with lse,
    backward from it), with a scale, against ``jax.grad``."""
    q, k, v = _qkv(1, 90, 50, 2, 64, seed=13)
    w = np.random.default_rng(14).normal(size=q.shape).astype(np.float32)
    ref = jax.grad(
        lambda *a: jnp.sum(jax_flash_attention(*a, scale=0.3) * jnp.asarray(w)), argnums=(0, 1, 2)
    )(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash.flash_attention(*leaves, scale=0.3)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    for name, r, leaf in zip(("dq", "dk", "dv"), ref, leaves):
        assert_close(f"flash grad {name}", np.asarray(r), leaf.grad, TOL)
    with torch.no_grad():  # no gradient wanted: the plain forward, nothing recorded
        assert flash.flash_attention(*leaves).grad_fn is None


@pytest.mark.parametrize("block_rows", [1, 7, 64])
def test_flash_bwd_blocked_equals_unblocked(block_rows):
    """Walking the query rows in blocks changes only the order of the sums
    over the rows (dk, dv); dq's rows do not see it at all."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 100, 45, 2, 128, seed=17))
    do = torch.from_numpy(np.random.default_rng(18).normal(size=q.shape).astype(np.float32))
    o, lse = flash.flash_attention_plain(q, k, v, return_lse=True, block_rows=block_rows)
    whole = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, block_rows=100)
    blocked = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, block_rows=block_rows)
    assert_close("dq", whole[0], blocked[0], 1e-6)
    assert_close("dk", whole[1], blocked[1], 1e-6)
    assert_close("dv", whole[2], blocked[2], 1e-6)


def test_flash_bwd_plain_rounds_like_the_kernel_in_bf16():
    """bf16 inputs: P and dS are rounded to bf16 before their products; the
    result stays within bf16 rounding of the float32 one."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 70, 90, 2, 128, seed=19))
    do = torch.from_numpy(np.random.default_rng(20).normal(size=q.shape).astype(np.float32))
    o, lse = flash.flash_attention_plain(q, k, v, return_lse=True)
    ref = flash.flash_attention_bwd_plain(q, k, v, o, lse, do)
    bf = lambda a: a.to(torch.bfloat16)  # noqa: E731
    ob, lseb = flash.flash_attention_plain(bf(q), bf(k), bf(v), return_lse=True)
    got = flash.flash_attention_bwd_plain(bf(q), bf(k), bf(v), ob, lseb, bf(do))
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        assert g.dtype == torch.bfloat16
        assert_close(f"bf16 plain bwd {name}", r, g, 2e-2)


def test_flash_bwd_wrapper_rejects_mismatched_shapes():
    q = torch.zeros(1, 8, 2, 128)
    with pytest.raises(ValueError):  # lse [B, Tq, H] instead of [B, H, Tq]
        flash.flash_attention_bwd(q, q, q, q, torch.zeros(1, 8, 2), q)
    with pytest.raises(ValueError):  # do of another length
        flash.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 8), torch.zeros(1, 9, 2, 128))
