"""The Gated DeltaNet LM of the port against the JAX package on the CPU: the
short convolution, the gated output norm, the ``GatedDeltaNet`` layer on
both sides of T = 64 (the token recurrence below, the fused chunked path
above) with its decode cache and parameter gradients, a 2-layer
``attn_extends='gated_deltanet'`` LM (logits, greedy generation, three
trainer steps, ``lm_train`` with resume), and the MHLA layer with
``use_short_conv``.

One set of weights, drawn with numpy from a fixed seed, goes into the JAX
flax tree and through the weight bridge into the port. The LM keeps the
340M head geometry (hidden 512, 2 heads: Dk = 128, Dv = 256).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.layers.gated_deltanet import GatedDeltaNet as JaxGDN
from mhla_tpu.layers.mhla_causal import MHLACausal as JaxMHLACausal
from mhla_tpu.layers.norms import GatedRMSNorm as JaxGatedRMSNorm
from mhla_tpu.layers.short_conv import ShortConvolution as JaxShortConv
from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu.models import cross_entropy_loss as jax_cross_entropy_loss
from mhla_tpu.models import generate as jax_generate
from mhla_tpu.train import trainer as jax_trainer
from mhla_tpu_torch.layers import GatedDeltaNet, GatedRMSNorm, MHLACausal, ShortConvolution
from mhla_tpu_torch.layers.gated_deltanet import DeltaNetState
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    generate,
    init_lm_params,
    params_from_jax,
)
from mhla_tpu_torch.train import OptimizerConfig, init_train_state, lm_train, make_train_step
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.checkpoint import resolve_resume_path

# float32 through the same math in other summation orders; the fused path's
# plain versions substitute where the JAX op squares (tests/test_torch_delta.py)
TOL = 1e-4
GDN = dict(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100,
           attn_extends="gated_deltanet")


def _draw(tree, seed: int):
    """Every leaf of a flax tree of shapes from numpy: Dense kernels
    N(0, 0.02), short-conv kernels N(0, 0.3), the embedding N(0, 0.5),
    ``A_log`` log U(0.5, 16), ``dt_bias`` the inverse softplus of a
    log-uniform dt in [1e-3, 0.1] (the layer's init), mixing matrices
    U(0, 1), other weights 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "A_log" in name:
            x = np.log(rng.uniform(0.5, 16.0, shape))
        elif "dt_bias" in name:
            dt = np.exp(rng.uniform(0, 1, shape) * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
            x = dt + np.log(-np.expm1(-dt))
        elif "conv1d" in name:
            x = rng.normal(0.0, 0.3, shape)
        elif "mixing_matrix" in name:
            x = rng.uniform(0.0, 1.0, shape)
        elif "embedding" in name:
            x = rng.normal(0.0, 0.5, shape)
        elif "kernel" in name:
            x = rng.normal(0.0, 0.02, shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _layer_state_dict(params) -> dict:
    """A single attention layer's flax params -> its port state dict: Dense
    kernels transposed, conv kernels, norms and the gate parameters as
    they are."""
    sd = {}
    for name, value in params.items():
        if not isinstance(value, dict):
            sd[name] = torch.from_numpy(np.array(value))
        elif "conv1d" in name or "kernel" not in value:
            sd[f"{name}.weight"] = torch.from_numpy(
                np.array(value["kernel"] if "kernel" in value else value["weight"]))
        else:
            sd[f"{name}.weight"] = torch.from_numpy(np.asarray(value["kernel"]).T.copy())
    return sd


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_short_conv_matches_jax():
    """A prefill, then three tokens one at a time from the cache, then the
    segment-id reset on packed rows."""
    jax_conv = JaxShortConv(48, 4)
    x = _x(2, 13, 48)
    shapes = jax.eval_shape(jax_conv.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 48)))
    params = _draw(shapes, 2)
    conv = ShortConvolution(48, 4)
    conv.load_state_dict({"weight": torch.from_numpy(params["params"]["kernel"])})
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref, ref_cache = jax_conv.apply(jp, jnp.asarray(x[:, :10]), None, True)
    with torch.no_grad():
        out, cache = conv(torch.from_numpy(x[:, :10]), None, True)
        assert_close("conv prefill", np.asarray(ref), out, 1e-6)
        assert_close("conv cache", np.asarray(ref_cache), cache, 1e-6)
        for i in range(10, 13):
            ref, ref_cache = jax_conv.apply(jp, jnp.asarray(x[:, i:i + 1]), ref_cache, True)
            out, cache = conv(torch.from_numpy(x[:, i:i + 1]), cache, True)
            assert_close(f"conv step {i}", np.asarray(ref), out, 1e-6)
        assert_close("conv cache after steps", np.asarray(ref_cache), cache, 1e-6)
        seg = np.array([[0] * 5 + [1] * 6 + [2] * 2, [0] * 13], np.int32)
        ref = jax_conv.apply(jp, jnp.asarray(x), None, False, jnp.asarray(seg))[0]
        out, none = conv(torch.from_numpy(x), segment_ids=torch.from_numpy(seg).long())
        assert none is None
        assert_close("conv with segment ids", np.asarray(ref), out, 1e-6)
        # a document's first token sees nothing of the one before
        alone, _ = conv(torch.from_numpy(x[:1, 5:11]))
        assert_close("a document on its own", alone, out[:1, 5:11], 1e-6)


def test_gated_rms_norm_matches_jax_in_bf16():
    x, g = _x(2, 5, 3, 64), _x(2, 5, 3, 64, seed=2)
    w = 1.0 + 0.1 * _x(64, seed=3)
    ref = JaxGatedRMSNorm(eps=1e-6).apply(
        {"params": {"weight": jnp.asarray(w)}},
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16))
    norm = GatedRMSNorm(64, eps=1e-6)
    norm.weight.data = torch.from_numpy(w)
    out = norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(g).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)), out.detach().float().numpy())


def _gdn_layer(expand_v=2.0):
    kw = dict(hidden_size=256, head_dim=128, num_heads=2, expand_v=expand_v, norm_eps=1e-6)
    jax_layer = JaxGDN(**kw)
    shapes = jax.eval_shape(jax_layer.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 256)))
    params = _draw(shapes, 4)
    layer = GatedDeltaNet(**kw)
    layer.load_state_dict(_layer_state_dict(params["params"]))
    return jax_layer, jax.tree_util.tree_map(jnp.asarray, params), layer


@pytest.mark.parametrize("t", [40, 100])
def test_gdn_layer_prefill_and_decode_match_jax(t):
    """T = 40 runs the token recurrence, T = 100 the chunked path (ragged
    last chunk); then two decode steps continue the caches."""
    jax_layer, jp, layer = _gdn_layer()
    x = _x(2, t + 2, 256, seed=5)
    ref, ref_state = jax_layer.apply(jp, jnp.asarray(x[:, :t]), None, True)
    with torch.no_grad():
        out, state = layer(torch.from_numpy(x[:, :t]), None, True)
        assert isinstance(state, DeltaNetState)
        assert_close(f"GDN prefill T={t}", np.asarray(ref), out, TOL)
        assert_close("GDN state", np.asarray(ref_state.state), state.state, TOL)
        assert_close("GDN conv_v cache", np.asarray(ref_state.conv_v), state.conv_v, TOL)
        for i in (t, t + 1):
            ref, ref_state = jax_layer.apply(jp, jnp.asarray(x[:, i:i + 1]), ref_state, True)
            out, state = layer(torch.from_numpy(x[:, i:i + 1]), state, True)
            assert_close(f"GDN decode {i}", np.asarray(ref), out, TOL)
        assert_close("GDN state after decode", np.asarray(ref_state.state), state.state, TOL)


def test_gdn_layer_parameter_gradients_match_jax():
    """Every parameter's gradient and the input's through the chunked path
    (T = 100) against ``jax.grad``."""
    jax_layer, jp, layer = _gdn_layer(expand_v=1.0)
    x = _x(1, 100, 256, seed=6)
    w = _x(1, 100, 256, seed=7)

    def loss(p, xx):
        return jnp.sum(jax_layer.apply(p, xx)[0] * w)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (layer(xt)[0] * torch.from_numpy(w)).sum().backward()
    assert_close("GDN dx", np.asarray(g_x), xt.grad, TOL)
    want = _layer_state_dict(jax.tree_util.tree_map(np.asarray, g_params["params"]))
    for name, p in layer.named_parameters():
        assert_close(f"GDN d{name}", want[name], p.grad, TOL)


@pytest.fixture(scope="module")
def gdn_lm():
    jax_model = JaxLM(JaxConfig(**GDN))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params_np = _draw(shapes, 8)
    cfg = MHLALMConfig(**GDN)
    port = MHLAForCausalLM(cfg).eval()
    port.load_state_dict(params_from_jax(params_np, cfg))
    return jax_model, params_np, port


def _ids(b, t, seed=3):
    return np.random.default_rng(seed).integers(0, GDN["vocab_size"], (b, t)).astype(np.int32)


def test_gdn_lm_logits_match_jax(gdn_lm):
    jax_model, params_np, port = gdn_lm
    ids = _ids(2, 130)
    ref, _ = jax_model.apply(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(ids))
    with torch.no_grad():
        out, _ = port(torch.from_numpy(ids).long())
    assert_close("GDN LM logits", np.asarray(ref), out, TOL)


def test_gdn_lm_greedy_generate_matches_jax(gdn_lm):
    """A 70-token prompt (the chunked prefill) and 6 greedy tokens (the
    token recurrence from the prefill's states and conv caches)."""
    jax_model, params_np, port = gdn_lm
    ids = _ids(2, 70, seed=5)
    ref = jax_generate(jax_model, jax.tree_util.tree_map(jnp.asarray, params_np),
                       jnp.asarray(ids), max_new_tokens=6)
    out, scores = generate(port, torch.from_numpy(ids).long(), max_new_tokens=6,
                           output_scores=True)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    with torch.no_grad():  # chunk == recurrent inside the port
        full, _ = port(out[:, :-1])
    assert_close("decode-step logits vs one forward", full[:, 69:], scores, TOL)


def test_gdn_lm_three_trainer_steps_match_jax(gdn_lm):
    """make_train_step + AdamW against the JAX trainer on the same batches
    (T = 70: the chunked path and its backward): loss, grad norm and the
    distance every parameter travelled."""
    jax_model, params_np, _ = gdn_lm
    cfg = MHLALMConfig(**GDN)
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
        ids = rng.integers(0, GDN["vocab_size"], (2, 70)).astype(np.int32)
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


def test_init_lm_params_draws_every_gdn_parameter():
    """Every 2-D weight, the short convolutions' too, from normal(0.02); A
    and dt in their init ranges; the same generator seed, the same model."""
    cfg = MHLALMConfig(**{**GDN, "num_hidden_layers": 1})
    models = [init_lm_params(MHLAForCausalLM(cfg), torch.Generator().manual_seed(0))
              for _ in range(2)]
    attn = models[0].model.layers[0].attn
    assert isinstance(attn, GatedDeltaNet)
    assert attn.q_conv1d.weight.shape == (4, 256)
    assert abs(float(attn.q_conv1d.weight.detach().std()) - 0.02) < 0.004
    a = torch.exp(attn.A_log)
    assert bool(((a >= 1e-4) & (a <= 16.0)).all())
    dt = torch.nn.functional.softplus(attn.dt_bias)
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())
    for (name, p), (_, q) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(p, q), name


def test_gdn_lm_refuses_segment_ids():
    model = MHLAForCausalLM(MHLALMConfig(**{**GDN, "num_hidden_layers": 1}))
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="gated_deltanet"):
        model(ids, segment_ids=torch.ones(1, 8, dtype=torch.long))


def test_lm_train_gated_deltanet_runs_and_resumes(tmp_path):
    """``--model.attn_extends=gated_deltanet`` at hidden 512, 2 heads (Dk =
    128: the chunked path at T = 130), two steps, then a resume."""
    args = ["--device=cpu", "--model.attn_extends=gated_deltanet", "--model.num_hidden_layers=2",
            "--model.hidden_size=512", "--model.num_heads=2", "--model.vocab_size=100",
            "--train.batch_size=2", "--train.seq_len=130", "--train.log_interval=1",
            "--optimizer.warmup_steps=1", f"--work_dir={tmp_path}"]
    out = lm_train.main(args + ["--train.max_steps=2"])
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))
    assert isinstance(out["model"].model.layers[1].attn, GatedDeltaNet)
    assert resolve_resume_path(str(tmp_path)).endswith("step_00000002")
    again = lm_train.main(args + ["--train.max_steps=3"])
    assert again["start_step"] == 2 and len(again["losses"]) == 1
    assert math.isfinite(again["losses"][0])


@pytest.mark.parametrize("kv_heads", [None, 1])
def test_mhla_short_conv_layer_matches_jax(kv_heads):
    """``use_short_conv``: q, k and v convolutions (k and v at the grouped
    widths) with packed-row segment ids on the training path, and a
    prefill with the caches followed by two decode steps."""
    kw = dict(hidden_size=64, num_heads=2, num_kv_heads=kv_heads, use_short_conv=True,
              chunk_size=16, num_slots=8)
    jax_layer = JaxMHLACausal(**kw)
    shapes = jax.eval_shape(jax_layer.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 64)))
    params = _draw(shapes, 9)
    layer = MHLACausal(**kw)
    sd = _layer_state_dict(params["params"])
    sd["mixing_matrix"] = sd["mixing_matrix"].reshape(8, 8)
    layer.load_state_dict(sd)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    x = _x(2, 42, 64, seed=10)
    seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]]), [15, 20, 5], axis=1).astype(np.int32)
    ref, _ = jax_layer.apply(jp, jnp.asarray(x[:, :40]), segment_ids=jnp.asarray(seg))
    with torch.no_grad():
        out, _ = layer(torch.from_numpy(x[:, :40]), segment_ids=torch.from_numpy(seg).long())
        assert_close("short-conv MHLA, packed rows", np.asarray(ref), out, TOL)
        ref, ref_state = jax_layer.apply(jp, jnp.asarray(x[:, :40]), use_cache=True)
        out, state = layer(torch.from_numpy(x[:, :40]), use_cache=True)
        assert_close("short-conv MHLA prefill", np.asarray(ref), out, TOL)
        assert_close("conv_k cache", np.asarray(ref_state.conv_k), state.conv_k, TOL)
        for i in (40, 41):
            ref, ref_state = jax_layer.apply(jp, jnp.asarray(x[:, i:i + 1]), ref_state,
                                             use_cache=True)
            out, state = layer(torch.from_numpy(x[:, i:i + 1]), state, use_cache=True)
            assert_close(f"short-conv MHLA decode {i}", np.asarray(ref), out, TOL)
