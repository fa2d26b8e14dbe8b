"""The LM's remaining families and options in the port against the JAX
package on the CPU: the selective scan, the Mamba2, Mamba and causal
linear-attention layers (prefill, decode, gradients against ``jax.grad``),
the per-head chunked GLA op and the plain K12 / K12b scalar-decay form at a
decay where JAX's chunked op overflows, 2-layer LMs of each family
(logits, generation, three trainer steps, ``lm_train`` with resume), and
MHLACausal's XPos, ``fused_recurrent`` mode and long cache continuation
against JAX's ``fused_recurrent``; ``remat`` on against off.

Weights and inputs come from numpy with fixed seeds and go to both
packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.layers.mamba import Mamba as JaxMamba
from mhla_tpu.layers.mamba2 import Mamba2 as JaxMamba2
from mhla_tpu.layers.mhla_causal import MHLACausal as JaxMHLA
from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu.models import cross_entropy_loss as jax_cross_entropy_loss
from mhla_tpu.models import generate as jax_generate
from mhla_tpu.models.gla_lm import _LinearAttnLayer as JaxLinearAttn
from mhla_tpu.ops.gla_chunk import gla_chunk as jax_gla_chunk
from mhla_tpu.ops.gla_chunk import gla_recurrent as jax_gla_recurrent
from mhla_tpu.ops.selective_scan import selective_scan_chunk as jax_scan_chunk
from mhla_tpu.ops.selective_scan import selective_scan_recurrent as jax_scan_recurrent
from mhla_tpu.train import trainer as jax_trainer
from mhla_tpu_torch.kernels import gla_chunk as gla_kernels
from mhla_tpu_torch.layers import (
    CausalLinearAttention,
    Mamba,
    Mamba2,
    Mamba2State,
    MambaState,
    MHLACausal,
)
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    generate,
    init_lm_params,
    params_from_jax,
)
from mhla_tpu_torch.ops import gla_chunk, selective_scan_chunk, selective_scan_recurrent
from mhla_tpu_torch.train import OptimizerConfig, init_train_state, lm_train, make_train_step
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.checkpoint import resolve_resume_path

# float32 on both sides through the same math in other summation orders
# (the bound of tests/test_torch_gla.py and tests/test_torch_lm.py)
TOL = 1e-4
TINY = dict(hidden_size=64, num_hidden_layers=2, num_heads=2, vocab_size=50, chunk_size=16)


def _draw(tree, seed: int):
    """Every leaf of a flax tree from numpy: Dense and conv kernels N(0,
    0.1), A_log log U(0.5, 2) (Mamba's [Dm, N] log U(1, 16)), dt_bias and
    dt_proj's bias N(-2.5, 0.5) (dt about 0.08), other biases N(0, 0.1), the
    embedding N(0, 0.5), D, norm weights and mixing matrices near 1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "A_log" in name:
            x = np.log(rng.uniform(1.0, 16.0, shape) if len(shape) == 2
                       else rng.uniform(0.5, 2.0, shape))
        elif "dt_bias" in name or ("dt_proj" in name and "bias" in name):
            x = rng.normal(-2.5, 0.5, shape)
        elif "bias" in name:
            x = rng.normal(0.0, 0.1, shape)
        elif "embedding" in name:
            x = rng.normal(0.0, 0.5, shape)
        elif "kernel" in name:
            x = rng.normal(0.0, 0.1, shape)
        elif "mixing_matrix" in name:
            x = rng.uniform(0.0, 1.0, shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _layer_sd(params) -> dict:
    """A layer's flax params -> its port state dict: Dense kernels
    transposed; short-conv kernels ([K, F] in both), biases, norm weights and
    bare parameters as they are."""
    sd = {}
    for name, value in params.items():
        if not isinstance(value, dict):
            sd[name] = torch.from_numpy(np.array(value))
            continue
        for leaf, x in value.items():
            x = np.array(x)
            if leaf == "kernel" and name != "conv1d":
                x = x.T.copy()
            sd[f"{name}.{'weight' if leaf in ('kernel', 'weight') else leaf}"] = torch.from_numpy(x)
    return sd


def _pair(jax_layer, layer, x0, seed=1):
    params = _draw(jax.eval_shape(jax_layer.init, jax.random.PRNGKey(0), jnp.asarray(x0)), seed)
    layer.load_state_dict(_layer_sd(params["params"]))
    return jax.tree_util.tree_map(jnp.asarray, params)


def _x(*shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --- the selective scan -----------------------------------------------------


@pytest.mark.parametrize("t,init", [(5, False), (70, True)])
def test_selective_scan_ops_match_jax(t, init):
    """Both scans against JAX's at a ragged chunk, with and without an
    initial state; the chunked scan against the recurrence; gradients of the
    chunked scan (through its per-chunk checkpoints) against ``jax.grad``."""
    rng = np.random.default_rng(2)
    b, dm, n = 2, 12, 4
    x, bi, ci = _x(b, t, dm), _x(b, t, n, seed=6), _x(b, t, n, seed=7)
    dt = np.log1p(np.exp(rng.normal(-2.0, 1.0, (b, t, dm)))).astype(np.float32)
    a = -rng.uniform(0.5, 8.0, (dm, n)).astype(np.float32)
    d = rng.normal(1.0, 0.1, dm).astype(np.float32)
    h0 = _x(b, dm, n, seed=8) if init else None
    args = (x, dt, a, bi, ci, d)
    jargs = [jnp.asarray(u) for u in args]
    targs = [torch.from_numpy(u) for u in args]
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    ref_y, ref_h = jax_scan_recurrent(*jargs, jh0, output_final_state=True)
    y, h = selective_scan_recurrent(*targs, th0, output_final_state=True)
    assert_close("recurrent y", np.asarray(ref_y), y, TOL)
    assert_close("recurrent h", np.asarray(ref_h), h, TOL)
    ref_y, ref_h = jax_scan_chunk(*jargs, jh0, chunk_size=16, output_final_state=True)
    y2, h2 = selective_scan_chunk(*targs, th0, chunk_size=16, output_final_state=True)
    assert_close("chunk y", np.asarray(ref_y), y2, TOL)
    assert_close("chunk h", np.asarray(ref_h), h2, TOL)
    assert_close("chunk vs recurrent", y, y2, TOL)
    w = _x(b, t, dm, seed=9)

    def loss(*u):
        yy, hh = jax_scan_chunk(*u, jh0, chunk_size=16, output_final_state=True)
        return jnp.sum(yy * w) + jnp.sum(jnp.sin(hh))

    ref = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*jargs)
    xs = [u.clone().requires_grad_() for u in targs]
    yy, hh = selective_scan_chunk(*xs, th0, chunk_size=16, output_final_state=True)
    ((yy * torch.from_numpy(w)).sum() + torch.sin(hh).sum()).backward()
    for name, r, u in zip(("x", "dt", "a", "b", "c", "d"), ref, xs):
        assert_close(f"scan d{name}", np.asarray(r), u.grad, TOL)


# --- the layers -------------------------------------------------------------


@pytest.mark.parametrize("t", [6, 40])
def test_mamba_layer_matches_jax(t):
    """Prefill on the recurrence (t <= 8) or the chunked scan (t > 8) with
    the cache, then two decode steps; on the chunked scan every parameter's
    and the input's gradient against ``jax.grad``."""
    kw = dict(hidden_size=32, chunk_size=16)
    jax_layer, layer = JaxMamba(**kw), Mamba(**kw)
    x = _x(2, t + 2, 32)
    jp = _pair(jax_layer, layer, x[:, :4])
    apply = jax.jit(jax_layer.apply, static_argnums=(3,))
    ref, ref_state = apply(jp, jnp.asarray(x[:, :t]), None, True)
    with torch.no_grad():
        out, state = layer(torch.from_numpy(x[:, :t]), None, True)
        assert isinstance(state, MambaState)
        assert_close(f"mamba prefill {t}", np.asarray(ref), out, TOL)
        for i in (t, t + 1):
            ref, ref_state = apply(jp, jnp.asarray(x[:, i:i + 1]), ref_state, True)
            out, state = layer(torch.from_numpy(x[:, i:i + 1]), state, True)
            assert_close(f"mamba decode {i}", np.asarray(ref), out, TOL)
        assert_close("mamba state", np.asarray(ref_state.state), state.state, TOL)
    if t <= 8:
        return
    w = _x(2, t, 32, seed=11)
    g_p, g_x = jax.jit(jax.grad(lambda p, xx: jnp.sum(jax_layer.apply(p, xx)[0] * w),
                                argnums=(0, 1)))(jp, jnp.asarray(x[:, :t]))
    xt = torch.from_numpy(x[:, :t]).requires_grad_()
    (layer(xt)[0] * torch.from_numpy(w)).sum().backward()
    assert_close("mamba dx", np.asarray(g_x), xt.grad, TOL)
    want = _layer_sd(jax.tree_util.tree_map(np.asarray, g_p["params"]))
    for name, p in layer.named_parameters():
        assert_close(f"mamba d{name}", want[name], p.grad, TOL)


@pytest.mark.parametrize("hidden,head_dim,d_state", [(32, 16, 16), (128, 128, 128)])
def test_mamba2_layer_matches_jax(hidden, head_dim, d_state):
    """Prefill of 40 tokens (the op's route at Dk 16; at Dk = Dv = 128 the
    fused route, the plain K12 / K12b scalar form) with the cache, two decode
    steps on the recurrence, and on the fused route the gradients against
    ``jax.grad`` of JAX's layer (its factored op, finite at these decays)."""
    kw = dict(hidden_size=hidden, head_dim=head_dim, d_state=d_state, chunk_size=16)
    jax_layer, layer = JaxMamba2(**kw), Mamba2(**kw)
    x = _x(2, 42, hidden, seed=3)
    jp = _pair(jax_layer, layer, x[:, :4], seed=2)
    apply = jax.jit(jax_layer.apply, static_argnums=(3,))
    before = dict(gla_kernels.launches)
    ref, ref_state = apply(jp, jnp.asarray(x[:, :40]), None, True)
    with torch.no_grad():
        out, state = layer(torch.from_numpy(x[:, :40]), None, True)
        assert isinstance(state, Mamba2State)
        assert_close("mamba2 prefill", np.asarray(ref), out, TOL)
        assert_close("mamba2 state", np.asarray(ref_state.state), state.state, TOL)
        for i in (40, 41):
            ref, ref_state = apply(jp, jnp.asarray(x[:, i:i + 1]), ref_state, True)
            out, state = layer(torch.from_numpy(x[:, i:i + 1]), state, True)
            assert_close(f"mamba2 decode {i}", np.asarray(ref), out, TOL)
    assert gla_kernels.launches == before  # the CPU runs the plain versions
    if d_state < 128:
        return
    w = _x(1, 40, hidden, seed=12)
    g_p, g_x = jax.jit(jax.grad(lambda p, xx: jnp.sum(jax_layer.apply(p, xx)[0] * w),
                                argnums=(0, 1)))(jp, jnp.asarray(x[:1, :40]))
    xt = torch.from_numpy(x[:1, :40]).requires_grad_()
    (layer(xt)[0] * torch.from_numpy(w)).sum().backward()
    assert_close("mamba2 dx", np.asarray(g_x), xt.grad, TOL)
    want = _layer_sd(jax.tree_util.tree_map(np.asarray, g_p["params"]))
    for name, p in layer.named_parameters():
        assert_close(f"mamba2 d{name}", want[name], p.grad, TOL)


def test_mamba2_hands_the_op_head_shared_q_and_k(monkeypatch):
    """The chunked route gets q and k as views of stride 0 over the heads,
    so autograd keeps one [B, T, d_state] copy of each and not one a head."""
    from mhla_tpu_torch.layers import mamba2

    seen = []

    def spy(q, k, *args, **kw):
        seen.append((q.stride(2), k.stride(2), q.untyped_storage().nbytes()))
        return gla_kernels.gla_chunk_fused(q, k, *args, **kw)

    monkeypatch.setattr(mamba2, "gla_chunk_fused", spy)
    layer = Mamba2(hidden_size=128, head_dim=64, d_state=128, chunk_size=16)
    x = torch.from_numpy(_x(2, 32, 128, seed=9)).requires_grad_()
    layer(x)[0].sum().backward()
    assert seen == [(0, 0, 2 * 32 * 128 * 4)]  # q: one float32 [B, T, d_state]
    assert torch.isfinite(x.grad).all()


def test_per_head_chunk_op_is_finite_where_jax_overflows():
    """A per-head decay whose chunks sum below -88.7: JAX's chunked op
    (k e^{-G}) gives non-finite values; the port's op (difference form) and
    the plain K12 / K12b scalar form behind ``gla_chunk_fused`` match JAX's
    token recurrence, outputs, state and gradients."""
    rng = np.random.default_rng(4)
    b, t, h, dk, dv = 1, 130, 2, 128, 128
    q, k, v = _x(b, t, h, dk, seed=13), _x(b, t, h, dk, seed=14), _x(b, t, h, dv, seed=15)
    gk = (-rng.uniform(1.5, 3.0, (b, t, h))).astype(np.float32)
    assert np.cumsum(gk[:, :64], axis=1)[:, -1].max() < -88.7
    jx = [jnp.asarray(u) for u in (q, k, v, gk)]
    bad, _ = jax_gla_chunk(*jx)
    assert not np.isfinite(np.asarray(bad)).all()
    w = _x(b, t, h, dv, seed=16)

    def loss(*u):
        o, s = jax_gla_recurrent(*u, output_final_state=True)
        return jnp.sum(o * w) + jnp.sum(jnp.sin(s)), (o, s)

    (_, (ref_o, ref_s)), ref_g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                    has_aux=True)(*jx)
    for name, fn in (("op", gla_chunk), ("fused", gla_kernels.gla_chunk_fused)):
        xs = [torch.from_numpy(u).requires_grad_() for u in (q, k, v, gk)]
        o, s = fn(*xs, output_final_state=True)
        assert torch.isfinite(o).all() and torch.isfinite(s).all()
        assert_close(f"{name} o", np.asarray(ref_o), o, TOL)
        assert_close(f"{name} state", np.asarray(ref_s), s, TOL)
        ((o * torch.from_numpy(w)).sum() + torch.sin(s).sum()).backward()
        for gname, r, u in zip(("q", "k", "v", "gk"), ref_g, xs):
            assert torch.isfinite(u.grad).all()
            assert_close(f"{name} d{gname}", np.asarray(r), u.grad, TOL)


def test_plain_scalar_kernels_equal_autograd_of_their_forward():
    """The plain K12b scalar form's gradients (dG per token and head among
    them) against autograd of the plain K12 scalar form, float32."""
    rng = np.random.default_rng(5)
    b, n, c, h = 1, 3, 16, 2
    q4, k4 = torch.from_numpy(_x(b, n * c, h, 128, seed=17)), torch.from_numpy(
        _x(b, n * c, h, 128, seed=18))
    v4 = torch.from_numpy(_x(b, n * c, h, 64, seed=19))
    gk = torch.from_numpy(-rng.uniform(0.5, 6.0, (b, n, c, h)).astype(np.float32))
    g4 = torch.cumsum(gk, dim=2).reshape(b, n * c, h)
    s0 = torch.from_numpy(0.1 * _x(b, h, 128, 64, seed=20))
    do, ds = torch.from_numpy(_x(b, n * c, h, 64, seed=21)), torch.from_numpy(
        _x(b, h, 128, 64, seed=22))
    xs = [u.clone().requires_grad_() for u in (q4, k4, v4, g4, s0)]
    o, s, states = gla_kernels.gla_chunk_fwd_scalar_plain(*xs, chunk_size=c,
                                                          collect_states=True)
    ref = torch.autograd.grad((o, s), xs, (do, ds))
    got = gla_kernels.gla_chunk_bwd_scalar(q4, k4, v4, g4, states.detach(), do, ds, c)
    for name, r, x in zip(("q", "k", "v", "G", "s0"), ref, got):
        assert_close(f"plain K12b scalar d{name}", r, x, 1e-5)


def test_causal_linear_attention_layer():
    """The full forward against JAX's layer (its [B, T, H, Dk, Dv] cumsum) and
    its gradients against ``jax.grad``; decode on the carried sums equals
    the port's own full forward (JAX's layer keeps no cache)."""
    cfg = JaxConfig(**{**TINY, "attn_extends": "linear_attn"})
    jax_layer = JaxLinearAttn(cfg)
    layer = CausalLinearAttention(hidden_size=64, num_heads=2, chunk_size=16)
    x = _x(2, 40, 64, seed=6)
    jp = _pair(jax_layer, layer, x[:, :4], seed=3)
    ref, _ = jax.jit(jax_layer.apply)(jp, jnp.asarray(x))
    with torch.no_grad():
        full, _ = layer(torch.from_numpy(x))
        assert_close("linear attn forward", np.asarray(ref), full, TOL)
        out, state = layer(torch.from_numpy(x[:, :35]), None, True)
        steps = [out]
        for i in range(35, 40):
            o, state = layer(torch.from_numpy(x[:, i:i + 1]), state, True)
            steps.append(o)
        assert_close("linear attn decode vs full", full, torch.cat(steps, 1), 1e-5)
    w = _x(2, 40, 64, seed=7)
    g_p, g_x = jax.jit(jax.grad(lambda p, xx: jnp.sum(jax_layer.apply(p, xx)[0] * w),
                                argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (layer(xt)[0] * torch.from_numpy(w)).sum().backward()
    assert_close("linear attn dx", np.asarray(g_x), xt.grad, TOL)
    want = _layer_sd(jax.tree_util.tree_map(np.asarray, g_p["params"]))
    for name, p in layer.named_parameters():
        assert_close(f"linear attn d{name}", want[name], p.grad, TOL)


# --- MHLACausal's options ---------------------------------------------------


def _mhla_pair(**extra):
    kw = dict(hidden_size=64, num_heads=2, chunk_size=16, num_slots=8)
    jax_layer = JaxMHLA(**kw, **{k: v for k, v in extra.items() if k != "port_mode"})
    layer = MHLACausal(**kw, **{k: v for k, v in extra.items() if k != "port_mode"})
    x = _x(2, 100, 64, seed=8)
    jp = _pair(jax_layer, layer, x[:, :4], seed=4)
    return jax_layer, layer, jp, x


def test_xpos_and_fused_recurrent_match_jax():
    """XPos (q and k with their own tables) in chunk mode and in
    ``fused_recurrent`` mode against JAX's layer; the two modes of the port
    against each other; gradients of the XPos layer against ``jax.grad``."""
    jax_layer, layer, jp, x = _mhla_pair(rope_scale_base=64.0)
    ref, _ = jax.jit(jax_layer.apply)(jp, jnp.asarray(x[:, :70]))
    with torch.no_grad():
        out, _ = layer(torch.from_numpy(x[:, :70]))
    assert_close("xpos chunk", np.asarray(ref), out, TOL)
    jrec, rec, jp2, _ = _mhla_pair(rope_scale_base=64.0, mode="fused_recurrent")
    rec.load_state_dict(layer.state_dict())
    ref_rec, _ = jax.jit(jrec.apply)(jp, jnp.asarray(x[:, :70]))
    with torch.no_grad():
        out_rec, _ = rec(torch.from_numpy(x[:, :70]))
    assert_close("xpos fused_recurrent", np.asarray(ref_rec), out_rec, TOL)
    assert_close("fused_recurrent vs chunk", out, out_rec, TOL)
    w = _x(2, 70, 64, seed=9)
    g_p, g_x = jax.jit(jax.grad(lambda p, xx: jnp.sum(jax_layer.apply(p, xx)[0] * w),
                                argnums=(0, 1)))(jp, jnp.asarray(x[:, :70]))
    for mod in (layer, rec):
        xt = torch.from_numpy(x[:, :70]).requires_grad_()
        mod.zero_grad()
        (mod(xt)[0] * torch.from_numpy(w)).sum().backward()
        assert_close("xpos dx", np.asarray(g_x), xt.grad, TOL)
        want = _layer_sd(jax.tree_util.tree_map(np.asarray, g_p["params"]))
        for name, p in mod.named_parameters():
            assert_close(f"xpos d{name}", want[name].reshape(p.shape), p.grad, TOL)


def test_long_cache_continuation_matches_jax_fused_recurrent():
    """A cache of 37 tokens continued by 40 (more than a chunk of 16): the
    port carries the state through the recurrence, so its outputs equal
    JAX's ``fused_recurrent`` over the whole 77 tokens (JAX's chunk mode
    drops the cache there), and the cache equals that of one prefill of 77.""" 
    jax_layer, layer, jp, x = _mhla_pair(mode="fused_recurrent")
    ref, _ = jax.jit(jax_layer.apply)(jp, jnp.asarray(x[:, :77]))
    chunk = MHLACausal(hidden_size=64, num_heads=2, chunk_size=16, num_slots=8).eval()
    chunk.load_state_dict(layer.state_dict())
    with torch.no_grad():
        _, state = chunk(torch.from_numpy(x[:, :37]), None, True)
        out, state = chunk(torch.from_numpy(x[:, 37:77]), state, True)
        _, once = chunk(torch.from_numpy(x[:, :77]), None, True)
    assert_close("continuation vs JAX fused_recurrent", np.asarray(ref)[:, 37:], out, TOL)
    assert state.recurrent.t == once.recurrent.t == 77
    # the completed chunks' slots (a prefill's cache also holds the
    # in-progress chunk in its slot; the recurrence keeps it in s_cur)
    assert_close("cache states", once.recurrent.states[:, :, :4],
                 state.recurrent.states[:, :, :4], TOL)
    for name in ("mixed", "s_cur"):
        assert_close(f"cache {name}", getattr(once.recurrent, name),
                     getattr(state.recurrent, name), TOL)


# --- the LMs ----------------------------------------------------------------


@pytest.fixture(scope="module", params=["mamba2", "mamba", "linear_attn"])
def family_lm(request):
    over = {**TINY, "attn_extends": request.param}
    jax_model = JaxLM(JaxConfig(**over))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params_np = _draw(shapes, 8)
    cfg = MHLALMConfig(**over)
    port = MHLAForCausalLM(cfg).eval()
    port.load_state_dict(params_from_jax(params_np, cfg))
    return jax_model, params_np, port, cfg


def _ids(b, t, seed=3):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t)).astype(np.int32)


def test_family_lm_logits_and_generation(family_lm):
    """Logits over 40 tokens against JAX's; 5 greedy tokens after a 30-token
    prompt against JAX's ``generate`` (Mamba2, Mamba; JAX's linear-attention
    layer keeps no cache); the decode-step logits against one forward."""
    jax_model, params_np, port, cfg = family_lm
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    ids = _ids(2, 40)
    ref, _ = jax.jit(jax_model.apply)(jp, jnp.asarray(ids))
    with torch.no_grad():
        out, _ = port(torch.from_numpy(ids).long())
    assert_close(f"{cfg.attn_extends} logits", np.asarray(ref), out, TOL)
    prompt = _ids(2, 30, seed=5)
    toks, scores = generate(port, torch.from_numpy(prompt).long(), max_new_tokens=5,
                            output_scores=True)
    if cfg.attn_extends != "linear_attn":
        want = jax_generate(jax_model, jp, jnp.asarray(prompt), max_new_tokens=5)
        np.testing.assert_array_equal(np.asarray(want), toks.numpy())
    with torch.no_grad():
        full, _ = port(toks[:, :-1])
    assert_close("decode-step logits vs one forward", full[:, 29:], scores, TOL)


def test_family_lm_three_trainer_steps_match_jax(family_lm):
    """make_train_step + AdamW against JAX's trainer on the same batches:
    loss, grad norm and the distance every parameter travelled."""
    jax_model, params_np, _, cfg = family_lm
    opt = dict(learning_rate=1e-3, weight_decay=0.01, grad_clip=1.0, warmup_steps=2,
               total_steps=10, schedule="cosine")

    def jax_loss(p, batch, _rng):
        logits, _ = jax_model.apply(p, batch)
        return jax_cross_entropy_loss(logits, batch), {}

    tx = jax_trainer.make_optimizer(jax_trainer.OptimizerConfig(**opt))
    state = jax_trainer.init_train_state(jax.tree_util.tree_map(jnp.asarray, params_np), tx)
    jax_step = jax_trainer.make_train_step(jax_loss, tx, donate=False)
    model = MHLAForCausalLM(cfg)
    model.load_state_dict(params_from_jax(params_np, cfg))
    port_state = init_train_state(model, OptimizerConfig(**opt))
    port_step = make_train_step(lm_train.lm_loss)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(2)
    for i in range(3):
        ids = rng.integers(0, TINY["vocab_size"], (2, 40)).astype(np.int32)
        state, ref = jax_step(state, jnp.asarray(ids), jax.random.PRNGKey(i))
        port_state, got = port_step(port_state, torch.from_numpy(ids).long())
        assert_close(f"step {i} loss", np.asarray(ref["loss"]), got["loss"], 1e-5)
        assert_close(f"step {i} grad norm", np.asarray(ref["grad_norm"]), got["grad_norm"], TOL)
        if i == 0:
            continue  # learning rate 0
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params), cfg)
        for name, p in model.named_parameters():
            assert_close(f"step {i} {name}", want[name] - start[name],
                         p.detach() - start[name], 1e-4)


def test_family_lm_init_and_remat(family_lm):
    """``init_lm_params`` draws the family's parameters as JAX's scheme does
    (2-D weights N(0, 0.02), Mamba's S4D A_log and Mamba2's gates kept in
    their init ranges, the same seed the same model); ``remat=True`` gives
    the same loss and gradients as ``remat=False``."""
    cfg = family_lm[3]
    models = [init_lm_params(MHLAForCausalLM(cfg, remat=r), torch.Generator().manual_seed(0))
              for r in (False, True)]
    attn = models[0].model.layers[0].attn
    if cfg.attn_extends == "mamba":
        assert torch.equal(attn.A_log, torch.log(torch.arange(1.0, 17.0)).expand(128, 16))
        assert bool((torch.nn.functional.softplus(attn.dt_proj.bias) >= 1e-4 - 1e-9).all())
    elif cfg.attn_extends == "mamba2":
        assert bool((attn.A_log.exp() <= 16).all()) and bool((attn.D == 1).all())
    ids = torch.from_numpy(_ids(2, 40, seed=7)).long()
    grads = []
    for m in models:
        loss, _ = lm_train.lm_loss(m.train(), ids)
        loss.backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for (name, p), (_, q) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(p, q), name
        assert_close(f"remat d{name}", grads[0][name], grads[1][name], 1e-6)


def test_lm_train_family_runs_and_resumes(family_lm, tmp_path):
    """``--model.attn_extends=<family>`` two steps, then a resume."""
    cfg = family_lm[3]
    args = ["--device=cpu", f"--model.attn_extends={cfg.attn_extends}",
            "--model.num_hidden_layers=2", "--model.hidden_size=64", "--model.num_heads=2",
            "--model.vocab_size=50", "--model.chunk_size=16", "--train.batch_size=2",
            "--train.seq_len=40", "--train.log_interval=1", "--optimizer.warmup_steps=1",
            f"--work_dir={tmp_path}"]
    out = lm_train.main(args + ["--train.max_steps=2"])
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))
    assert resolve_resume_path(str(tmp_path)).endswith("step_00000002")
    again = lm_train.main(args + ["--train.max_steps=3"])
    assert again["start_step"] == 2 and len(again["losses"]) == 1
    assert math.isfinite(again["losses"][0])
