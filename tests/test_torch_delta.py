"""The gated delta rule of the port against the JAX package on the CPU: the
plain ops (``ops/delta_rule.py``), the plain versions of K11 / K11b behind
``gated_delta_chunk_fused`` against the JAX Pallas kernels run in interpret
mode, the op's gradients against ``jax.grad``, and the dispatch rule.

Inputs come from numpy with fixed seeds and go to both packages. The decay
follows the layer's: g = -A softplus(x + dt_bias) with A up to 16, so G
reaches tens inside a chunk.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import delta_chunk_pallas as jax_fused
from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu.ops import delta_rule as jax_delta
from mhla_tpu_torch.kernels import delta_chunk
from mhla_tpu_torch.kernels.delta_chunk import gated_delta_chunk_fused, kernel_route
from mhla_tpu_torch.ops import delta_rule
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32, the same math in other summation orders (the JAX op runs under
# "highest" matmul precision); the JAX package's own bound between its
# fused kernel and its op (tests/test_kernels.py TestDeltaFused)
TOL = 1e-4
# bf16 inputs against the float32 oracle: JAX's tolerances for its bf16
# kernel path (tests/test_kernels.py:520-555)
BF16_FWD_TOL, BF16_GRAD_TOL = 2e-2, 5e-2


def _inputs(b, t, h, dk, dv, seed=0, init=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = rng.uniform(1e-4, 16.0, h).astype(np.float32)
    dt = np.exp(rng.uniform(0, 1, h) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    x = f(b, t, h) + np.log(np.expm1(dt)).astype(np.float32)
    g = (-a * np.logaddexp(x, 0.0)).astype(np.float32)
    beta = (1.0 / (1.0 + np.exp(-f(b, t, h)))).astype(np.float32)
    s0 = (0.1 * f(b, h, dk, dv)) if init else None
    return f(b, t, h, dk), f(b, t, h, dk), f(b, t, h, dv), g, beta, s0


def _torch(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _jax(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


@pytest.mark.parametrize(
    "b,t,h,dk,dv,chunk,init",
    [(2, 75, 2, 32, 64, 32, True), (1, 64, 1, 16, 16, 16, False), (2, 37, 2, 16, 32, 64, True)],
)
def test_ops_match_jax(b, t, h, dk, dv, chunk, init):
    """The recurrent and chunked ops, with and without an initial state, a
    ragged last chunk and dv = 2 dk."""
    q, k, v, g, beta, s0 = _inputs(b, t, h, dk, dv, init=init)
    ref_o, ref_s = jax_delta.gated_delta_recurrent(*_jax(q, k, v, g, beta), initial_state=_jax(s0)[0],
                                                   output_final_state=True)
    o, s = delta_rule.gated_delta_recurrent(*_torch(q, k, v, g, beta), initial_state=_torch(s0)[0],
                                            output_final_state=True)
    assert_close("recurrent o", np.asarray(ref_o), o, TOL)
    assert_close("recurrent state", np.asarray(ref_s), s, TOL)
    ref_o, ref_s = jax_delta.gated_delta_chunk(*_jax(q, k, v, g, beta), initial_state=_jax(s0)[0],
                                               chunk_size=chunk, output_final_state=True)
    o, s = delta_rule.gated_delta_chunk(*_torch(q, k, v, g, beta), initial_state=_torch(s0)[0],
                                        chunk_size=chunk, output_final_state=True)
    assert_close("chunk o", np.asarray(ref_o), o, TOL)
    assert_close("chunk state", np.asarray(ref_s), s, TOL)
    # chunk == recurrent inside the port
    o_rec, _ = delta_rule.gated_delta_recurrent(*_torch(q, k, v, g, beta),
                                                initial_state=_torch(s0)[0])
    assert_close("chunk vs recurrent", o_rec, o, TOL)


def test_ops_keep_the_input_dtype():
    q, k, v, g, beta, _ = _inputs(1, 20, 2, 16, 16)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    for op in (delta_rule.gated_delta_chunk, delta_rule.gated_delta_recurrent):
        o, s = op(qb, kb, vb, *_torch(g, beta))
        assert o.dtype == torch.bfloat16 and s is None


def test_substitution_inverse_equals_neumann_inverse():
    """The kernels' forward substitution and the op's Neumann product give
    the same (I + A)^-1 in float32."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(np.tril(rng.uniform(-1, 1, (3, 64, 64)), -1).astype(np.float32) * 0.2)
    t_sub = delta_chunk._unit_lower_inverse(a)
    assert_close("substitution vs Neumann", delta_rule._tril_unit_inverse(a), t_sub, 1e-5)
    eye = torch.eye(64).expand(3, 64, 64)
    assert_close("(I + A) T = I", eye, (eye + a) @ t_sub, 1e-5)


@pytest.fixture
def interpret():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    yield
    mhla_chunk_pallas.FORCE_INTERPRET = False


def test_fused_forward_and_backward_match_the_pallas_kernels(interpret):
    """The plain versions of K11 / K11b (through ``gated_delta_chunk_fused``
    and its autograd Function) against ``_delta_fused_fwd_impl`` and
    ``_delta_bwd_impl`` in interpret mode: b=1, h=2, Dk=Dv=128, T=200 (a
    ragged last chunk), an initial state, output and state cotangents."""
    q, k, v, g, beta, s0 = _inputs(1, 200, 2, 128, 128, seed=4)
    rng = np.random.default_rng(5)
    do = rng.standard_normal(v.shape).astype(np.float32)
    ds = rng.standard_normal(s0.shape).astype(np.float32)
    ref_o, ref_s, states4 = jax_fused._delta_fused_fwd_impl(
        *_jax(q, k, v, g, beta, s0), 64, True, collect_states=True)
    ref_grads = jax_fused._delta_bwd_impl(*_jax(q, k, v, g, beta, s0), states4, *_jax(do, ds),
                                          64, True)
    xs = [x.requires_grad_() for x in _torch(q, k, v, g, beta, s0)]
    o, s = gated_delta_chunk_fused(*xs[:5], initial_state=xs[5], output_final_state=True)
    assert_close("K11 plain o", np.asarray(ref_o), o, TOL)
    assert_close("K11 plain state", np.asarray(ref_s), s, TOL)
    grads = torch.autograd.grad((o, s), xs, _torch(do, ds))
    for name, r, got in zip(("q", "k", "v", "g", "beta", "s0"), ref_grads, grads):
        assert_close(f"K11b plain d{name}", np.asarray(r), got, TOL)


@pytest.mark.parametrize("t,dv", [(200, 128), (128, 256)])
def test_fused_path_at_strong_decay_matches_the_pallas_kernels(interpret, t, dv):
    """Gates whose log-decay summed over a chunk of 64 falls below -88.7,
    where e^{-G} overflows float32: the plain K11 / K11b (through
    ``gated_delta_chunk_fused``, decays from differences of G) are finite
    and match ``_delta_fused_fwd_impl`` / ``_delta_bwd_impl`` in interpret
    mode, and their output matches JAX's token recurrence."""
    q, k, v, _, beta, s0 = _inputs(1, t, 2, 128, dv, seed=8)
    rng = np.random.default_rng(9)
    g = -(1.5 + 1.5 * rng.uniform(size=beta.shape)).astype(np.float32)
    assert np.cumsum(g[:, :64], axis=1)[:, -1].max() < -88.7
    do = rng.standard_normal(v.shape).astype(np.float32)
    ds = rng.standard_normal(s0.shape).astype(np.float32)
    ref_o, ref_s, states4 = jax_fused._delta_fused_fwd_impl(
        *_jax(q, k, v, g, beta, s0), 64, True, collect_states=True)
    ref_grads = jax_fused._delta_bwd_impl(*_jax(q, k, v, g, beta, s0), states4, *_jax(do, ds),
                                          64, True)
    rec_o, rec_s = jax_delta.gated_delta_recurrent(*_jax(q, k, v, g, beta),
                                                   initial_state=jnp.asarray(s0),
                                                   output_final_state=True)
    xs = [x.requires_grad_() for x in _torch(q, k, v, g, beta, s0)]
    o, s = gated_delta_chunk_fused(*xs[:5], initial_state=xs[5], output_final_state=True)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    assert_close("K11 plain o", np.asarray(ref_o), o, TOL)
    assert_close("K11 plain state", np.asarray(ref_s), s, TOL)
    assert_close("K11 plain o vs the recurrence", np.asarray(rec_o), o, TOL)
    assert_close("K11 plain state vs the recurrence", np.asarray(rec_s), s, TOL)
    grads = torch.autograd.grad((o, s), xs, _torch(do, ds))
    for name, r, got in zip(("q", "k", "v", "g", "beta", "s0"), ref_grads, grads):
        assert torch.isfinite(got).all(), name
        assert_close(f"K11b plain d{name}", np.asarray(r), got, TOL)


def _loss_grads_jax(fn, xs, **kw):
    def loss(q, k, v, g, beta, s0):
        o, s = fn(q, k, v, g, beta, initial_state=s0, output_final_state=True, **kw)
        return jnp.sum(jnp.cos(o.astype(jnp.float32))) + jnp.sum(jnp.sin(s))

    return jax.grad(loss, argnums=tuple(range(6)))(*xs)


def _loss_grads_port(xs, chunk_size=64):
    xs = [x.detach().requires_grad_() for x in xs]
    o, s = gated_delta_chunk_fused(*xs[:5], initial_state=xs[5], chunk_size=chunk_size,
                                   output_final_state=True)
    (torch.cos(o.float()).sum() + torch.sin(s).sum()).backward()
    return o, [x.grad for x in xs]


@pytest.mark.parametrize("t,chunk,dv", [(200, 64, 128), (160, 32, 256)])
def test_fused_op_gradients_match_jax_grad(t, chunk, dv):
    """Gradients of q, k, v, g, beta and s0 through the fused path against
    ``jax.grad`` of the JAX op, float32 (the state weighed in the loss, so
    the ds0 / dS chain is exercised)."""
    q, k, v, g, beta, s0 = _inputs(1, t, 2, 128, dv, seed=6)
    ref = _loss_grads_jax(jax_delta.gated_delta_chunk, _jax(q, k, v, g, beta, s0),
                          chunk_size=chunk)
    _, got = _loss_grads_port(_torch(q, k, v, g, beta, s0), chunk)
    for name, r, x in zip(("q", "k", "v", "g", "beta", "s0"), ref, got):
        assert_close(f"d{name}", np.asarray(r), x, TOL)


def test_fused_bf16_forward_and_gradients_match_the_float32_oracle():
    """bf16 q, k, v take the bf16 rounding points (bf16 entry states and
    products) and stay within JAX's bf16 bounds of the float32 op on the
    same (rounded) values."""
    q, k, v, g, beta, s0 = _inputs(1, 200, 2, 128, 128, seed=7)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    qf, kf, vf = (x.float().numpy() for x in (qb, kb, vb))
    ref_o, ref_s = jax_delta.gated_delta_chunk(*_jax(qf, kf, vf, g, beta),
                                               initial_state=jnp.asarray(s0),
                                               output_final_state=True)
    o, s = gated_delta_chunk_fused(qb, kb, vb, *_torch(g, beta, s0), output_final_state=True)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert_close("bf16 o", np.asarray(ref_o), o.float(), BF16_FWD_TOL)
    assert_close("bf16 state", np.asarray(ref_s), s, BF16_FWD_TOL)
    ref = _loss_grads_jax(jax_delta.gated_delta_chunk, _jax(qf, kf, vf, g, beta, s0))
    _, got = _loss_grads_port([qb, kb, vb, *_torch(g, beta, s0)])
    for name, r, x in zip(("q", "k", "v", "g", "beta", "s0"), ref, got):
        assert x.dtype == (torch.bfloat16 if name in "qkv" else torch.float32), name
        assert_close(f"bf16 d{name}", np.asarray(r), x.float(), BF16_GRAD_TOL)


def test_dispatch_follows_the_jax_rule():
    """T >= chunk and the Pallas block rule take the fused path (its plain
    versions on the CPU); other calls go to the op, as JAX sends them."""
    assert kernel_route(64, 64, 128, 256) and kernel_route(200, 32, 128, 128)
    assert not kernel_route(63, 64, 128, 256)  # shorter than a chunk
    assert not kernel_route(200, 64, 64, 128)  # Dk % 128
    assert not kernel_route(200, 64, 128, 192)  # Dv % 128
    assert not kernel_route(200, 60, 128, 128)  # chunk % 8
    q, k, v, g, beta, s0 = _torch(*_inputs(1, 90, 2, 64, 64, seed=8))
    before = dict(delta_chunk.launches)
    o, s = gated_delta_chunk_fused(q, k, v, g, beta, s0, output_final_state=True)
    o_op, s_op = delta_rule.gated_delta_chunk(q, k, v, g, beta, s0, output_final_state=True)
    assert torch.equal(o, o_op) and torch.equal(s, s_op)
    assert delta_chunk.launches == before  # nothing launches on the CPU


def test_without_final_state_the_state_is_none_and_its_cotangent_zero():
    q, k, v, g, beta, s0 = _torch(*_inputs(1, 130, 1, 128, 128, seed=9))
    s0.requires_grad_()
    o, s = gated_delta_chunk_fused(q, k, v, g, beta, initial_state=s0)
    assert s is None
    o.float().sum().backward()
    ref = s0.grad.clone()
    s0.grad = None
    o2, s2 = gated_delta_chunk_fused(q, k, v, g, beta, initial_state=s0, output_final_state=True)
    o2.float().sum().backward()  # s2 unused: zero cotangent
    assert torch.equal(o, o2) and torch.equal(ref, s0.grad)


def test_kernel_wrappers_take_the_plain_path_on_the_cpu():
    """The wrappers' CPU route is their plain version, bit for bit."""
    rng = np.random.default_rng(10)
    b, t, h, c = 1, 128, 2, 64
    qn = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((b, t, h, 128))
                                                        .astype(np.float32)), dim=-1)
    kn = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((b, t, h, 128))
                                                        .astype(np.float32)), dim=-1)
    v = torch.from_numpy(rng.standard_normal((b, t, h, 128)).astype(np.float32))
    g_cum = torch.cumsum(-torch.rand(b, t // c, c, h), 2).reshape(b, t, h)
    beta = torch.rand(b, t, h)
    s0 = torch.zeros(b, h, 128, 128)
    out = delta_chunk.delta_chunk_fwd(qn, kn, v, g_cum, beta, s0, c, True)
    ref = delta_chunk.delta_chunk_fwd_plain(qn, kn, v, g_cum, beta, s0, c, True)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    assert out[2].shape == (b, t // c, h, 128, 128)
    do, ds = torch.randn_like(v), torch.randn_like(s0)
    got = delta_chunk.delta_chunk_bwd(qn, kn, v, g_cum, beta, out[2], do, ds, c)
    want = delta_chunk.delta_chunk_bwd_plain(qn, kn, v, g_cum, beta, out[2], do, ds, c)
    assert all(torch.equal(a, r) for a, r in zip(got, want))
