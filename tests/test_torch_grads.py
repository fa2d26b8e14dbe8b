"""Gradients of the port against ``jax.grad`` of the JAX package on the CPU:
the chunk op's autograd Function (the plain versions of K4b, K3b, K2b), the
fmap+RoPE Function (plain K1b), every parameter of the LM, the
mixing-matrix clamp at its bounds, and the compute dtype of a model with
float32 parameters and bf16 compute.

The JAX op and fmap+RoPE comparisons run the JAX Pallas backward bodies in
interpret mode (``FORCE_INTERPRET``). Inputs and weights come from numpy
with fixed seeds and go to both packages.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhla_tpu_torch.layers.mhla_causal as port_layer
from mhla_tpu.kernels import fmap_rope_pallas as jax_fmap
from mhla_tpu.kernels import mhla_chunk_pallas as jax_chunk
from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu.models import cross_entropy_loss as jax_cross_entropy_loss
from mhla_tpu.ops import rotary as jax_rotary
from mhla_tpu_torch.kernels import fmap_rope, mhla_chunk
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    cross_entropy_loss,
    params_from_jax,
)
from mhla_tpu_torch.ops import rotary
from mhla_tpu_torch.ops.mhla_chunk import clamp_causal_mixing_matrix, init_causal_mixing_matrix
from mhla_tpu_torch.utils import assert_close, get_err_ratio

from test_torch_lm import TINY, _random_params
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# the ops package re-exports the function under its module's name
jax_clamp = importlib.import_module("mhla_tpu.ops.mhla_chunk").clamp_causal_mixing_matrix

# float32 on both sides: the same gradient in other summation orders (the
# Pallas bodies' per-supertile products against ATen einsums), a few
# float32 ulp of the largest partial sum; measured <= 5e-7 for the op,
# so 1e-5 as for the forward (tests/test_torch_mhla_chunk.py)
TOL = 1e-5


@pytest.fixture
def interpret():
    jax_chunk.FORCE_INTERPRET = True
    yield
    jax_chunk.FORCE_INTERPRET = False


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, dtype=np.float32)).requires_grad_(grad)


# T = 781 spans 13 chunks (the JAX op pads them to 4 supertiles: far, near
# and padding paths); T = 130 spans 3 chunks in one padded supertile.
@pytest.mark.parametrize("t", [781, 130])
def test_op_gradients_match_jax_interpret(interpret, t):
    b, h, d = 2, 2, 128
    rng = np.random.default_rng(t)
    q = np.maximum(rng.standard_normal((b, t, h * d)), 0).astype(np.float32)
    k = np.maximum(rng.standard_normal((b, t, h * d)), 0).astype(np.float32)
    v = rng.standard_normal((b, t, h * d)).astype(np.float32)
    m = np.tril(rng.uniform(0.0, 1.0, (16, 16))).astype(np.float32)
    w = rng.standard_normal((b, t, h * d)).astype(np.float32)

    def loss(q, k, v, m):
        return jnp.sum(jax_chunk.mhla_chunk_fused_flat(q, k, v, m, num_heads=h)[0] * w)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, m)))
    inputs = [_t(x, grad=True) for x in (q, k, v, m)]
    o, _ = mhla_chunk.mhla_chunk_fused_flat(*inputs, num_heads=h)
    (o * _t(w)).sum().backward()
    for name, r, x in zip(("dq", "dk", "dv", "dM"), ref, inputs):
        assert_close(f"op {name} t={t}", np.asarray(r), x.grad, TOL)


@pytest.mark.parametrize("fmap", ["relu", "elu", "identity"])
def test_fmap_rope_gradient_matches_jax_interpret(interpret, fmap):
    h, dh, t = 2, 128, 256
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, t, h * dh)).astype(np.float32)
    w = rng.standard_normal((2, t, h * dh)).astype(np.float32)
    cos_j, sin_j = jax_rotary.rotary_cos_sin(512, dh)

    def loss(x):
        return jnp.sum(jax_fmap.fused_fmap_rope_flat(x, cos_j, sin_j, h, fmap, offset=37) * w)

    ref = jax.grad(loss)(jnp.asarray(x))
    cos, sin = rotary.rotary_cos_sin(512, dh)
    xt = _t(x, grad=True)
    (fmap_rope.fused_fmap_rope_flat(xt, cos, sin, h, fmap, offset=37) * _t(w)).sum().backward()
    # float32 elementwise: a few ulp, as the forward (tests/test_torch_fmap_rope.py)
    assert_close(f"fmap_rope grad {fmap}", np.asarray(ref), xt.grad, 1e-6)


@pytest.mark.parametrize("name", ["chunk_output", "mix_states", "chunk_states"])
def test_plain_backward_equals_autograd_of_plain_forward(name):
    """Each plain backward (the kernels' reference) is the exact gradient of
    its plain forward in float32."""
    b, n, c, h, dk, dv = 2, 3, 16, 2, 16, 32
    rng = np.random.default_rng(11)
    g = lambda *s: _t(rng.standard_normal(s), grad=True)  # noqa: E731
    q4, k4, v4 = g(b, n, c, h * dk), g(b, n, c, h * dk), g(b, n, c, h * dv)
    mixed4, states4 = g(b, n, h * dk, dv), g(b, n, h * dk, dv)
    m_strict = _t(np.tril(rng.uniform(0, 1, (n, n)), -1), grad=True)
    m_diag = _t(rng.uniform(0, 1, n), grad=True)
    if name == "chunk_output":
        out = mhla_chunk.chunk_output_plain(q4, k4, v4, mixed4, m_diag, h)
        dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
        got = mhla_chunk.chunk_output_bwd_plain(q4, k4, v4, mixed4, m_diag, dout, h)
        want = torch.autograd.grad(out, (q4, k4, v4, mixed4, m_diag), dout)
        # K4's whole k/v gradient is the intra-chunk part
        pairs = zip(("dq", "dk_intra", "dv_intra", "dmixed", "dmd"), want, got)
    elif name == "mix_states":
        out = mhla_chunk.mix_states_plain(m_strict, states4)
        dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
        want_ds, want_dm = torch.autograd.grad(out, (states4, m_strict), dout)
        got = mhla_chunk.mix_states_bwd_plain(m_strict, dout, states4)
        pairs = zip(("dstates", "dMs"), (want_ds, torch.tril(want_dm, -1)), got)
    else:
        out = mhla_chunk.chunk_states_plain(k4, v4, h)
        dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
        want = torch.autograd.grad(out, (k4, v4), dout)
        zeros = torch.zeros_like(k4), torch.zeros_like(v4)
        got = mhla_chunk.chunk_states_bwd_plain(k4, v4, dout, *zeros, h)
        pairs = zip(("dk", "dv"), want, got)
    for label, w, g_ in pairs:
        assert_close(f"{name} {label}", w, g_.reshape(w.shape), TOL)


@pytest.fixture(scope="module")
def lm():
    jax_model = JaxLM(JaxConfig(**TINY))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params_np = _random_params(shapes)
    return jax_model, params_np


def test_lm_parameter_gradients_match_jax(lm):
    """Every parameter's gradient of the shifted CE loss at T = 130 (two
    chunk boundaries and a padded last chunk), through the JAX package's
    CPU path and the port's Functions with plain backwards."""
    jax_model, params_np = lm
    ids = np.random.default_rng(3).integers(0, TINY["vocab_size"], (2, 130)).astype(np.int32)

    def loss(p):
        logits, _ = jax_model.apply(p, jnp.asarray(ids))
        return jax_cross_entropy_loss(logits, jnp.asarray(ids))

    ref_loss, ref_grads = jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, params_np))
    cfg = MHLALMConfig(**TINY)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), cfg)
    port = MHLAForCausalLM(cfg)
    port.load_state_dict(params_from_jax(params_np, cfg))
    logits, _ = port(torch.from_numpy(ids).long())
    out = cross_entropy_loss(logits, torch.from_numpy(ids).long())
    out.backward()
    assert_close("LM loss", np.asarray(ref_loss), out.detach(), 1e-5)
    grads = dict(port.named_parameters())
    assert set(grads) == set(ref)
    for name, g in ref.items():
        # float32 through two blocks and the tied logits: the forward's 1e-4
        # (tests/test_torch_lm.py), the backward sums in other orders too
        assert_close(f"grad {name}", g, grads[name].grad, 1e-4)


@pytest.mark.parametrize("case", ["causal_init", "both_bounds"])
def test_clamp_gradient_matches_jax_at_the_bounds(case):
    """jnp.clip passes gradient 0.5 at a bound (torch.clamp passes 1); the
    causal init has M[0, 0] = 1 and the post-step projection leaves
    entries on both bounds."""
    rng = np.random.default_rng(5)
    if case == "causal_init":
        m = np.asarray(init_causal_mixing_matrix(8))
        assert m[0, 0] == 1.0
    else:
        m = rng.uniform(-0.5, 1.5, (8, 8)).astype(np.float32)
        m[::2, 0] = np.float32(1e-5)
        m[1::2, 1] = 1.0
    w = rng.standard_normal((8, 8)).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(jax_clamp(x) * w))(jnp.asarray(m))
    mt = _t(m, grad=True)
    (clamp_causal_mixing_matrix(mt) * _t(w)).sum().backward()
    np.testing.assert_array_equal(np.asarray(ref), mt.grad.numpy())


def _upcast_bf16_dots(fn):
    """The JAX CPU backend has no bf16 x bf16 -> float32 dot; a float32 dot
    of the bf16 values computes the same products exactly."""

    @functools.wraps(fn)
    def wrapped(*args, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            args = [
                a.astype(jnp.float32) if getattr(a, "dtype", None) == jnp.bfloat16 else a
                for a in args
            ]
        return fn(*args, preferred_element_type=preferred_element_type, **kw)

    return wrapped


def test_float32_params_compute_in_bf16_as_jax(lm, monkeypatch):
    """flax ``Dense(dtype=bf16)`` semantics: float32 parameters, bf16
    compute. The logits are bf16, q/k/v reach the chunk op in bf16, and the
    logits agree with the JAX model's (bf16 compute, same weights) to
    1.95e-3 relative RMS; a port that computed in float32 gives 2.49e-3
    (both measured here). 2.2e-3 lies between: bf16 rounding of the logits
    alone is ~1.1e-3, and the JAX CPU path rounds its jnp fmap+RoPE in
    bf16 where the port keeps float32 as the kernel does."""
    jax_model, params_np = lm
    for mod, name in ((jnp, "einsum"), (jnp, "dot"), (jax.lax, "dot_general")):
        monkeypatch.setattr(mod, name, _upcast_bf16_dots(getattr(mod, name)))
    ids = np.random.default_rng(3).integers(0, TINY["vocab_size"], (2, 130)).astype(np.int32)
    jax_bf16 = JaxLM(JaxConfig(**TINY, dtype=jnp.bfloat16))
    ref, _ = jax_bf16.apply(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(ids))
    assert ref.dtype == jnp.bfloat16

    cfg = MHLALMConfig(**TINY, dtype=torch.bfloat16)
    port = MHLAForCausalLM(cfg).eval()
    port.load_state_dict(params_from_jax(params_np, cfg))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    seen = []
    op = port_layer.mhla_chunk_fused_flat

    def recording_op(q, k, v, *args, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype))
        return op(q, k, v, *args, **kwargs)

    monkeypatch.setattr(port_layer, "mhla_chunk_fused_flat", recording_op)
    with torch.no_grad():
        out, _ = port(torch.from_numpy(ids).long())
    assert out.dtype == torch.bfloat16
    assert seen == [(torch.bfloat16,) * 3] * TINY["num_hidden_layers"]
    rel = get_err_ratio(np.asarray(ref.astype(jnp.float32)), out)
    assert rel < 2.2e-3, rel
