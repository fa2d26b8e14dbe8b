"""The GLA (gated linear attention) LM of the port against the JAX package on
the CPU: the plain ops (``ops/gla_chunk.py``), the plain versions of K12 /
K12b behind ``gla_chunk_fused`` against the JAX Pallas kernels run in
interpret mode, the op's gradients against ``jax.grad``, the dispatch rule,
the ``GatedLinearAttention`` layer (GLA and simple GLA, GQA, prefill then
decode, parameter gradients), a 2-layer ``attn_extends='gla'`` LM (logits,
greedy generation, three trainer steps, ``lm_train`` with resume), its
init and its refusal of ``segment_ids``.

Inputs and weights come from numpy with fixed seeds and go to both
packages. The decay follows the layer's: gk = logsigmoid(x) / 16.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import gla_chunk_pallas as jax_fused
from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu.layers.gla import GatedLinearAttention as JaxGLA
from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu.models import cross_entropy_loss as jax_cross_entropy_loss
from mhla_tpu.models import generate as jax_generate
from mhla_tpu.ops.gla_chunk import gla_chunk as jax_gla_chunk
from mhla_tpu.ops.gla_chunk import gla_recurrent as jax_gla_recurrent
from mhla_tpu.train import trainer as jax_trainer
from mhla_tpu_torch.kernels import gla_chunk as gla_kernels
from mhla_tpu_torch.kernels.gla_chunk import gla_chunk_fused, kernel_route
from mhla_tpu_torch.layers import GatedLinearAttention, GLAState
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    generate,
    init_lm_params,
    params_from_jax,
)
from mhla_tpu_torch.ops import gla_chunk, gla_recurrent
from mhla_tpu_torch.train import OptimizerConfig, init_train_state, lm_train, make_train_step
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.checkpoint import resolve_resume_path
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32 through the same math in other summation orders: JAX's own bound
# between its ops and between its fused kernel and its op (tests/test_gla.py,
# tests/test_kernels.py TestGLAFused)
TOL = 1e-4
# bf16 rounding points on both sides (the plain K12 / K12b against the Pallas
# kernels in interpret mode): the same roundings of the same float32 values,
# whose sums differ in order only, so a few roundings may flip by one bf16
# ulp; a half ulp is 2^-9 = 1.95e-3 relative (5.4e-5 at most measured over
# three seeds)
BF16_TOL = 2e-3
GLA = dict(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100,
           attn_extends="gla")


def _inputs(b, t, h, dk, dv, seed=0, per_head=False, init=True):
    """relu q, k (the LM's feature map), v, gk = logsigmoid(x) / 16 per key
    channel (or per head) and an initial state."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(b, t, h) if per_head else f(b, t, h, dk)
    gk = (-np.logaddexp(0.0, -(2.0 * x + 1.0)) / 16).astype(np.float32)
    s0 = (0.1 * f(b, h, dk, dv)) if init else None
    return np.maximum(f(b, t, h, dk), 0), np.maximum(f(b, t, h, dk), 0), f(b, t, h, dv), gk, s0


def _torch(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _jax(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


@pytest.mark.parametrize(
    "b,t,h,dk,dv,chunk,per_head,init",
    [(2, 75, 2, 32, 64, 32, False, True), (1, 64, 1, 16, 16, 16, True, False),
     (2, 37, 2, 16, 32, 64, False, True), (1, 50, 3, 16, 16, 16, True, True)],
)
def test_ops_match_jax(b, t, h, dk, dv, chunk, per_head, init):
    """The recurrent and chunked ops, per key channel and per head, with and
    without an initial state, ragged last chunks and dv = 2 dk."""
    q, k, v, gk, s0 = _inputs(b, t, h, dk, dv, per_head=per_head, init=init)
    ref_o, ref_s = jax_gla_recurrent(*_jax(q, k, v, gk), _jax(s0)[0], output_final_state=True)
    o, s = gla_recurrent(*_torch(q, k, v, gk), _torch(s0)[0], output_final_state=True)
    assert_close("recurrent o", np.asarray(ref_o), o, TOL)
    assert_close("recurrent state", np.asarray(ref_s), s, TOL)
    ref_o, ref_s = jax_gla_chunk(*_jax(q, k, v, gk), _jax(s0)[0], chunk_size=chunk,
                                 output_final_state=True)
    o, s = gla_chunk(*_torch(q, k, v, gk), _torch(s0)[0], chunk_size=chunk,
                     output_final_state=True)
    assert_close("chunk o", np.asarray(ref_o), o, TOL)
    assert_close("chunk state", np.asarray(ref_s), s, TOL)
    o_rec, _ = gla_recurrent(*_torch(q, k, v, gk), _torch(s0)[0])
    assert_close("chunk vs recurrent", o_rec, o, TOL)


def test_state_hand_off_and_dtype():
    """Two calls chained through the state equal one call; bf16 inputs give
    a bf16 o and a float32 state."""
    q, k, v, gk, s0 = _torch(*_inputs(1, 90, 2, 16, 32, seed=1))
    o, s = gla_chunk(q, k, v, gk, s0, chunk_size=16, output_final_state=True)
    o1, s1 = gla_chunk(q[:, :40], k[:, :40], v[:, :40], gk[:, :40], s0,
                       chunk_size=16, output_final_state=True)
    o2, s2 = gla_chunk(q[:, 40:], k[:, 40:], v[:, 40:], gk[:, 40:], s1,
                       chunk_size=16, output_final_state=True)
    assert_close("hand-off o", o, torch.cat([o1, o2], 1), TOL)
    assert_close("hand-off state", s, s2, TOL)
    for op in (gla_chunk, gla_recurrent):
        ob, sb = op(q.bfloat16(), k.bfloat16(), v.bfloat16(), gk, output_final_state=True)
        assert ob.dtype == torch.bfloat16 and sb.dtype == torch.float32


@pytest.fixture
def interpret():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    yield
    mhla_chunk_pallas.FORCE_INTERPRET = False


@pytest.mark.parametrize("dtype,tol", [(np.float32, TOL), ("bf16", BF16_TOL)])
def test_fused_forward_and_backward_match_the_pallas_kernels(interpret, dtype, tol):
    """The plain versions of K12 / K12b (through ``gla_chunk_fused`` and its
    autograd Function) against JAX's ``gla_chunk_fused`` in interpret mode:
    b=1, h=2, Dk=128, Dv=256, T=150 (3 chunks, the last ragged; JAX pads
    them to a supertile of 4), an initial state, output and state
    cotangents: o, the final state and the gradients of q, k, v, gk and s0,
    in float32 and in bf16 (q, k, v)."""
    q, k, v, gk, s0 = _inputs(1, 150, 2, 128, 256, seed=4)
    rng = np.random.default_rng(5)
    do = rng.standard_normal(v.shape).astype(np.float32)
    ds = rng.standard_normal(s0.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))

    def fused(q_, k_, v_, g_, s_):
        return jax_fused.gla_chunk_fused(q_, k_, v_, g_, s_, output_final_state=True)

    (ref_o, ref_s), vjp = jax.vjp(fused, jq, jk, jv, *_jax(gk, s0))
    ref_grads = vjp((jnp.asarray(do, jdt), jnp.asarray(ds)))
    xs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    xs += [x.requires_grad_() for x in _torch(gk, s0)]
    o, s = gla_chunk_fused(*xs[:4], initial_state=xs[4], output_final_state=True)
    assert o.dtype == tdt and s.dtype == torch.float32
    assert_close("K12 plain o", np.asarray(ref_o.astype(jnp.float32)), o.float(), tol)
    assert_close("K12 plain state", np.asarray(ref_s), s, tol)
    grads = torch.autograd.grad((o, s), xs, (torch.from_numpy(do).to(tdt), torch.from_numpy(ds)))
    for name, r, got in zip(("q", "k", "v", "gk", "s0"), ref_grads, grads):
        assert got.dtype == (tdt if name in "qkv" else torch.float32), name
        assert_close(f"K12b plain d{name}", np.asarray(r.astype(jnp.float32)), got.float(), tol)


@pytest.mark.parametrize("t,chunk,dv,per_head", [(200, 64, 128, False), (160, 32, 256, True)])
def test_fused_op_gradients_match_jax_grad(t, chunk, dv, per_head):
    """Gradients of q, k, v, gk (per channel, or per head through the
    broadcast) and s0 through the fused path against ``jax.grad`` of JAX's
    op ``gla_chunk``, float32, the state weighed in the loss."""
    q, k, v, gk, s0 = _inputs(1, t, 2, 128, dv, seed=6, per_head=per_head)

    def loss(q_, k_, v_, g_, s_):
        o, s = jax_gla_chunk(q_, k_, v_, g_, s_, chunk_size=chunk, output_final_state=True)
        return jnp.sum(jnp.cos(o)) + jnp.sum(jnp.sin(s))

    ref = jax.grad(loss, argnums=tuple(range(5)))(*_jax(q, k, v, gk, s0))
    xs = [x.requires_grad_() for x in _torch(q, k, v, gk, s0)]
    o, s = gla_chunk_fused(*xs[:4], initial_state=xs[4], chunk_size=chunk,
                           output_final_state=True)
    (torch.cos(o).sum() + torch.sin(s).sum()).backward()
    for name, r, x in zip(("q", "k", "v", "gk", "s0"), ref, xs):
        assert_close(f"d{name}", np.asarray(r), x.grad, TOL)


def test_padded_cotangents_stay_out_of_real_tokens():
    """T = 448 + 13: the pad tokens of the last chunk carry no gradient into
    the real ones (JAX's test_grads_with_padding, tests/test_kernels.py)."""
    q, k, v, gk, _ = _inputs(1, 461, 1, 128, 128, seed=11, init=False)

    def loss(q_, k_, v_, g_):
        return jnp.sum(jnp.cos(jax_gla_chunk(q_, k_, v_, g_)[0]))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*_jax(q, k, v, gk))
    xs = [x.requires_grad_() for x in _torch(q, k, v, gk)]
    torch.cos(gla_chunk_fused(*xs)[0]).sum().backward()
    for name, r, x in zip(("q", "k", "v", "gk"), ref, xs):
        assert_close(f"padded d{name}", np.asarray(r), x.grad, TOL)


def test_dispatch_follows_the_jax_rule():
    """T >= chunk and the Pallas block rule (gla_chunk_pallas.py:507,
    mhla_chunk_pallas.py:838-846) take the fused path (its plain versions on
    the CPU); other calls go to the op, bit for bit, as JAX sends them."""
    assert kernel_route(64, 64, 128, 256) and kernel_route(200, 32, 128, 128)
    assert not kernel_route(63, 64, 128, 256)  # shorter than a chunk
    assert not kernel_route(200, 64, 64, 128)  # Dk % 128
    assert not kernel_route(200, 64, 128, 192)  # Dv % 128
    assert not kernel_route(200, 60, 128, 128)  # chunk % 8
    q, k, v, gk, s0 = _torch(*_inputs(1, 90, 2, 64, 64, seed=8))
    before = dict(gla_kernels.launches)
    o, s = gla_chunk_fused(q, k, v, gk, s0, output_final_state=True)
    o_op, s_op = gla_chunk(q, k, v, gk, s0, output_final_state=True)
    assert torch.equal(o, o_op) and torch.equal(s, s_op)
    assert gla_kernels.launches == before  # nothing launches on the CPU


def test_without_final_state_the_state_is_none_and_its_cotangent_zero():
    q, k, v, gk, s0 = _torch(*_inputs(1, 130, 1, 128, 128, seed=9))
    s0.requires_grad_()
    o, s = gla_chunk_fused(q, k, v, gk, initial_state=s0)
    assert s is None
    o.sum().backward()
    ref = s0.grad.clone()
    s0.grad = None
    o2, _ = gla_chunk_fused(q, k, v, gk, initial_state=s0, output_final_state=True)
    o2.sum().backward()  # the state unused: zero cotangent
    assert torch.equal(o, o2) and torch.equal(ref, s0.grad)


def test_kernel_wrappers_take_the_plain_path_on_the_cpu():
    """The wrappers' CPU route is their plain version, bit for bit."""
    q, k, v, gk, s0 = _torch(*_inputs(1, 128, 2, 128, 128, seed=10))
    qd, kd, v4, egl, _ = gla_kernels._prep(q, k, v, gk, 64)
    out = gla_kernels.gla_chunk_fwd(qd, kd, v4, egl, s0, 64, True)
    ref = gla_kernels.gla_chunk_fwd_plain(qd, kd, v4, egl, s0, 64, True)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    assert out[2].shape == (1, 2, 2, 128, 128)
    do, ds = torch.randn_like(v), torch.randn_like(s0)
    got = gla_kernels.gla_chunk_bwd(qd, kd, v4, egl, out[2], do, ds, 64)
    want = gla_kernels.gla_chunk_bwd_plain(qd, kd, v4, egl, out[2], do, ds, 64)
    assert all(torch.equal(a, r) for a, r in zip(got, want))


def _draw(tree, seed: int):
    """Every leaf of a flax tree from numpy: Dense kernels N(0, 0.02) (the
    gate projections N(0, 0.2), so the decays spread), biases N(0, 1), the
    embedding N(0, 0.5), norm weights 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "bias" in name:
            x = rng.normal(0.0, 1.0, leaf.shape)
        elif "embedding" in name:
            x = rng.normal(0.0, 0.5, leaf.shape)
        elif "kernel" in name:
            x = rng.normal(0.0, 0.2 if "gk_proj" in name else 0.02, leaf.shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, leaf.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _layer_state_dict(params) -> dict:
    """A GLA layer's flax params -> its port state dict: Dense kernels
    transposed, biases and norm weights as they are."""
    sd = {}
    for name, value in params.items():
        if "kernel" in value:
            sd[f"{name}.weight"] = torch.from_numpy(np.asarray(value["kernel"]).T.copy())
        if "bias" in value:
            sd[f"{name}.bias"] = torch.from_numpy(np.array(value["bias"]))
        if "weight" in value:
            sd[f"{name}.weight"] = torch.from_numpy(np.array(value["weight"]))
    return sd


LAYER_FORMS = {
    "gla": dict(),
    "gla_gqa": dict(num_kv_heads=1),
    "simple_gla": dict(simple=True),
    "simple_gla_gqa": dict(simple=True, num_kv_heads=1),
    "gla_elu_clamp_no_gate": dict(feature_map="elu", clamp_min=-0.05, use_output_gate=False),
}


def _gla_layer(form: str):
    kw = {"hidden_size": 512, "num_heads": 2, "norm_eps": 1e-6, "feature_map": "relu",
          **LAYER_FORMS[form]}
    jax_layer = JaxGLA(**kw)
    shapes = jax.eval_shape(jax_layer.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 512)))
    params = _draw(shapes, 4)
    layer = GatedLinearAttention(**kw)
    layer.load_state_dict(_layer_state_dict(params["params"]))
    return jax_layer, jax.tree_util.tree_map(jnp.asarray, params), layer


@pytest.mark.parametrize("form", list(LAYER_FORMS))
def test_gla_layer_prefill_and_decode_match_jax(form):
    """Hidden 512, 2 heads (Dk 128, Dv 256): a prefill of 100 tokens (the
    fused chunked path, a ragged last chunk) with the cache, then two decode
    steps on the token recurrence."""
    jax_layer, jp, layer = _gla_layer(form)
    x = np.random.default_rng(5).standard_normal((2, 102, 512)).astype(np.float32)
    ref, ref_state = jax_layer.apply(jp, jnp.asarray(x[:, :100]), None, True)
    with torch.no_grad():
        out, state = layer(torch.from_numpy(x[:, :100]), None, True)
        assert isinstance(state, GLAState)
        assert_close(f"{form} prefill", np.asarray(ref), out, TOL)
        assert_close(f"{form} state", np.asarray(ref_state.state), state.state, TOL)
        for i in (100, 101):
            ref, ref_state = jax_layer.apply(jp, jnp.asarray(x[:, i:i + 1]), ref_state, True)
            out, state = layer(torch.from_numpy(x[:, i:i + 1]), state, True)
            assert_close(f"{form} decode {i}", np.asarray(ref), out, TOL)
        assert_close(f"{form} state after decode", np.asarray(ref_state.state), state.state, TOL)


@pytest.mark.parametrize("form", ["gla", "simple_gla_gqa"])
def test_gla_layer_parameter_gradients_match_jax(form):
    """Every parameter's gradient and the input's through the fused chunked
    path (T = 100) against ``jax.grad`` of JAX's layer (its jnp op)."""
    jax_layer, jp, layer = _gla_layer(form)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 100, 512)).astype(np.float32)
    w = rng.standard_normal((1, 100, 512)).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jax_layer.apply(p, xx)[0] * w)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (layer(xt)[0] * torch.from_numpy(w)).sum().backward()
    assert_close(f"{form} dx", np.asarray(g_x), xt.grad, TOL)
    want = _layer_state_dict(jax.tree_util.tree_map(np.asarray, g_params["params"]))
    assert set(want) == {n for n, _ in layer.named_parameters()}
    for name, p in layer.named_parameters():
        assert_close(f"{form} d{name}", want[name], p.grad, TOL)


@pytest.fixture(scope="module", params=["gla", "simple_gla"])
def gla_lm(request):
    over = {**GLA, "attn_extends": request.param}
    jax_model = JaxLM(JaxConfig(**over))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params_np = _draw(shapes, 8)
    cfg = MHLALMConfig(**over)
    port = MHLAForCausalLM(cfg).eval()
    port.load_state_dict(params_from_jax(params_np, cfg))
    return jax_model, params_np, port, cfg


def _ids(b, t, seed=3):
    return np.random.default_rng(seed).integers(0, GLA["vocab_size"], (b, t)).astype(np.int32)


def test_gla_lm_logits_match_jax(gla_lm):
    jax_model, params_np, port, _ = gla_lm
    ids = _ids(2, 130)
    ref, _ = jax_model.apply(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(ids))
    with torch.no_grad():
        out, _ = port(torch.from_numpy(ids).long())
    assert_close("GLA LM logits", np.asarray(ref), out, TOL)


def test_gla_lm_greedy_generate_matches_jax(gla_lm):
    """A 70-token prompt (the fused chunked prefill) and 6 greedy tokens (the
    token recurrence from the prefill's states)."""
    jax_model, params_np, port, _ = gla_lm
    ids = _ids(2, 70, seed=5)
    ref = jax_generate(jax_model, jax.tree_util.tree_map(jnp.asarray, params_np),
                       jnp.asarray(ids), max_new_tokens=6)
    out, scores = generate(port, torch.from_numpy(ids).long(), max_new_tokens=6,
                           output_scores=True)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    with torch.no_grad():  # chunk == recurrent inside the port
        full, _ = port(out[:, :-1])
    assert_close("decode-step logits vs one forward", full[:, 69:], scores, TOL)


def test_gla_lm_three_trainer_steps_match_jax(gla_lm):
    """make_train_step + AdamW against the JAX trainer on the same batches
    (T = 70: the fused chunked path and its backward): loss, grad norm and
    the distance every parameter travelled."""
    jax_model, params_np, _, cfg = gla_lm
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
        ids = rng.integers(0, GLA["vocab_size"], (2, 70)).astype(np.int32)
        state, ref = jax_step(state, jnp.asarray(ids), jax.random.PRNGKey(i))
        port_state, got = port_step(port_state, torch.from_numpy(ids).long())
        assert_close(f"step {i} loss", np.asarray(ref["loss"]), got["loss"], 1e-5)
        assert_close(f"step {i} grad norm", np.asarray(ref["grad_norm"]), got["grad_norm"], TOL)
        if i == 0:
            continue  # learning rate 0
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params), cfg)
        for name, p in model.named_parameters():
            # Adam's ~lr steps: compare the distance travelled (as
            # tests/test_torch_train.py), float32 gradient noise ~1e-6 lr
            assert_close(f"step {i} {name}", want[name] - start[name],
                         p.detach() - start[name], 1e-4)


@pytest.mark.parametrize("extends", ["gla", "simple_gla"])
def test_init_lm_params_draws_every_gla_parameter(extends):
    """Every 2-D weight (the gate projections too) from normal(0.02), o_proj
    rescaled, the gate bias zero, the norms ones; the same generator seed,
    the same model."""
    cfg = MHLALMConfig(**{**GLA, "attn_extends": extends, "num_hidden_layers": 1})
    models = [init_lm_params(MHLAForCausalLM(cfg), torch.Generator().manual_seed(0))
              for _ in range(2)]
    attn = models[0].model.layers[0].attn
    assert isinstance(attn, GatedLinearAttention) and attn.simple == (extends == "simple_gla")
    gates = [attn.gk_proj] if attn.simple else [attn.gk_proj_low, attn.gk_proj_up]
    for lin in [attn.q_proj, attn.k_proj, attn.v_proj, attn.g_proj, *gates]:
        assert abs(float(lin.weight.detach().std()) - 0.02) < 0.004
    assert abs(float(attn.o_proj.weight.detach().std()) - 0.02 / math.sqrt(2)) < 0.003
    if not attn.simple:
        assert attn.gk_proj_up.bias.shape == (256,) and not attn.gk_proj_up.bias.any()
    assert bool((attn.g_norm_swish_gate.weight == 1).all())
    for (name, p), (_, q) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(p, q), name


def test_gla_lm_refuses_segment_ids():
    model = MHLAForCausalLM(MHLALMConfig(**{**GLA, "num_hidden_layers": 1}))
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="gla"):
        model(ids, segment_ids=torch.ones(1, 8, dtype=torch.long))


def test_lm_train_gla_runs_and_resumes(tmp_path):
    """``--model.attn_extends=gla`` at hidden 512, 2 heads (Dk = 128: the
    fused chunked path at T = 130), two steps, then a resume."""
    args = ["--device=cpu", "--model.attn_extends=gla", "--model.num_hidden_layers=2",
            "--model.hidden_size=512", "--model.num_heads=2", "--model.vocab_size=100",
            "--train.batch_size=2", "--train.seq_len=130", "--train.log_interval=1",
            "--optimizer.warmup_steps=1", f"--work_dir={tmp_path}"]
    out = lm_train.main(args + ["--train.max_steps=2"])
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))
    assert isinstance(out["model"].model.layers[1].attn, GatedLinearAttention)
    assert resolve_resume_path(str(tmp_path)).endswith("step_00000002")
    again = lm_train.main(args + ["--train.max_steps=3"])
    assert again["start_step"] == 2 and len(again["losses"]) == 1
    assert math.isfinite(again["losses"][0])
