"""Image to video and ``capture`` in the port's ``WanModel``, held against
the JAX package on the CPU at a tiny size: the i2v forward with CLIP
features (the image embedding, the second cross-attention over the image
tokens), the capture dict of an i2v and a hybrid t2v model, capture under
remat, the i2v checkpoint converter, and two DPM-Solver++ steps with
``clip_fea`` on shared noise.

Weights are drawn with numpy and go into the JAX model's flax tree and
through ``wan_params_from_jax`` into the port. Narrow widths (head dim 32):
both packages run MHLA's plain einsums; the cross-attention is what is new
here. The JAX calls run under ``jax.jit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.eval import video_inference as jax_video_inference
from mhla_tpu.models import convert_wan as jax_convert_wan
from mhla_tpu.models.wan import WanModel as JaxWanModel
from mhla_tpu.models.wan import build_wan_config as jax_build_wan_config
from mhla_tpu_torch.eval import video_inference
from mhla_tpu_torch.models import (
    WanModel,
    build_wan_config,
    convert_wan,
    init_wan_params,
    wan_params_from_jax,
)
from mhla_tpu_torch.utils import assert_close

from t2v_fixtures import assert_trees_equal
from test_torch_wan import _random_params, _to_jax
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32 through 2 blocks and 2 sampler steps (XLA vs ATen GEMMs), as
# test_torch_wan.py's TOL
TOL = 1e-4
# layer 0 MHLA, layer 1 dense softmax; 5 image tokens of width 48
I2V = dict(model_type="i2v", num_layers=2, dim=64, num_heads=2, ffn_dim=128, text_len=16,
           text_dim=32, image_dim=48, img_tokens=5, linear_attn_idx=(0,),
           block_layout=(2, 2, 2))
T2V = {k: v for k, v in I2V.items() if k not in ("model_type", "image_dim", "img_tokens")}
LATENT = (2, 8, 12, 16)  # patch (1, 2, 2) -> grid (2, 4, 6)


def _pair(kw, seed):
    jax_model = JaxWanModel(jax_build_wan_config(remat=False, **kw))
    extra = {}
    if kw.get("model_type") == "i2v":
        extra["clip_fea"] = jnp.zeros((1, kw["img_tokens"], kw["image_dim"]))
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *LATENT)), jnp.zeros((1,)),
        jnp.zeros((1, kw["text_len"], kw["text_dim"])), **extra))
    params = _random_params(shapes, seed=seed)
    port = WanModel(build_wan_config(**kw)).eval()
    port.load_state_dict(wan_params_from_jax(params))  # strict: every key, every shape
    return jax_model, _to_jax(params), port


def _inputs(kw, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *LATENT)).astype(np.float32)
    t = np.array([700.0, 300.0], np.float32)
    ctx = rng.normal(size=(2, kw["text_len"], kw["text_dim"])).astype(np.float32)
    fea = rng.normal(size=(2, kw.get("img_tokens", 1), kw.get("image_dim", 1))).astype(np.float32)
    return x, t, ctx, fea


@pytest.fixture(scope="module")
def i2v():
    """The i2v pair and JAX's velocity and capture dict on one input, computed once."""
    jax_model, params, port = _pair(I2V, seed=1)
    x, t, ctx, fea = _inputs(I2V, seed=2)
    ref, caps = jax.jit(lambda p, *a: jax_model.apply(p, *a, capture=True))(
        params, *(jnp.asarray(a) for a in (x, t, ctx, fea)))
    return jax_model, params, port, (x, t, ctx, fea), ref, caps


def test_i2v_forward_with_clip_features_matches_jax(i2v):
    _, _, port, inputs, ref, _ = i2v
    x, t, ctx, fea = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        out = port(x, t, ctx, clip_fea=fea)
        without_image = port(x, t, ctx, clip_fea=torch.zeros_like(fea))
    assert out.shape == (2, *LATENT)
    assert_close("i2v velocity", np.asarray(ref), out, TOL)
    assert not torch.allclose(out, without_image)  # the image tokens are read
    assert port.blocks[0].cross_attn.k_img.weight.shape == (64, 64)
    assert port.img_fc1.weight.shape == (48, 48) and port.img_fc2.weight.shape == (64, 48)


def test_i2v_model_needs_clip_features(i2v):
    x, t, ctx, _ = (torch.from_numpy(a) for a in i2v[3])
    with pytest.raises(ValueError, match="clip_fea"):
        i2v[2](x, t, ctx)


def _check_capture(tag, ref_out, ref_caps, out, caps, n_layers):
    assert set(caps) == {"attn_out", "block_out"}
    assert len(caps["attn_out"]) == len(caps["block_out"]) == n_layers
    assert_close(f"{tag} velocity", np.asarray(ref_out), out, TOL)
    for key in ("attn_out", "block_out"):
        for i, (a, b) in enumerate(zip(ref_caps[key], caps[key])):
            assert b.shape == a.shape
            assert_close(f"{tag} {key}[{i}]", np.asarray(a), b, TOL)


def test_i2v_capture_matches_jax(i2v):
    _, _, port, inputs, ref, ref_caps = i2v
    x, t, ctx, fea = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        out, caps = port(x, t, ctx, clip_fea=fea, capture=True)
    _check_capture("i2v", ref, ref_caps, out, caps, I2V["num_layers"])


def test_hybrid_t2v_capture_matches_jax():
    """An MHLA layer and a dense softmax layer; the block outputs are the
    residual stream after each block, the attention outputs what the
    self-attention returned."""
    jax_model, params, port = _pair(T2V, seed=3)
    x, t, ctx, _ = _inputs(T2V, seed=4)
    ref, ref_caps = jax.jit(lambda p, *a: jax_model.apply(p, *a, capture=True))(
        params, *(jnp.asarray(a) for a in (x, t, ctx)))
    with torch.no_grad():
        out, caps = port(*(torch.from_numpy(a) for a in (x, t, ctx)), capture=True)
        plain = port(*(torch.from_numpy(a) for a in (x, t, ctx)))
    assert torch.equal(out, plain)
    _check_capture("t2v", ref, ref_caps, out, caps, T2V["num_layers"])


def test_capture_under_remat_equals_capture_without(i2v):
    """With autograd recording, per-block remat changes no bit of the
    velocity, the captures or the gradients of a loss over all of them."""
    port = i2v[2]
    remat = WanModel(dataclasses.replace(port.cfg, remat=True))
    remat.load_state_dict(port.state_dict())
    x, t, ctx, fea = (torch.from_numpy(a) for a in i2v[3])
    results = []
    for model in (port, remat):
        model.zero_grad()
        out, caps = model(x, t, ctx, clip_fea=fea, capture=True)
        loss = out.square().mean() + sum(c.square().mean()
                                         for c in caps["attn_out"] + caps["block_out"])
        loss.backward()
        results.append((out.detach(), [c.detach() for c in caps["attn_out"] + caps["block_out"]],
                        {n: p.grad.clone() for n, p in model.named_parameters()}))
    (o1, c1, g1), (o2, c2, g2) = results
    assert torch.equal(o1, o2) and all(torch.equal(a, b) for a, b in zip(c1, c2))
    assert g1.keys() == g2.keys()
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


def _reference_state(model, seed):
    rng = np.random.default_rng(seed)
    state = {}
    for name, shape in convert_wan.reference_state_shapes(model).items():
        if "norm" in name and name.endswith("weight"):
            x = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name.endswith("bias"):
            x = rng.normal(0.0, 0.02, shape)
        elif "modulation" in name:
            x = rng.normal(0.0, 1 / 16, shape)
        else:
            x = rng.normal(0.0, np.prod(shape[1:]) ** -0.5, shape)
        state[name] = x.astype(np.float32)
    return state


def test_i2v_converter_is_bit_equal_to_jax_and_loads(i2v):
    """A reference-named i2v state dict (``cross_attn.k_img``, ``v_img``,
    ``norm_k_img``, ``img_emb.proj.{0,1,3,4}``) through both converters:
    the same tree bit for bit, which loads into the port strictly and gives
    JAX's velocity on it."""
    jax_model = i2v[0]
    model = init_wan_params(WanModel(build_wan_config(**I2V)), torch.Generator().manual_seed(5))
    state = _reference_state(model, seed=6)
    for key in ("img_emb.proj.0.weight", "img_emb.proj.0.bias", "img_emb.proj.1.weight",
                "img_emb.proj.3.weight", "img_emb.proj.4.bias", "blocks.1.cross_attn.k_img.weight",
                "blocks.1.cross_attn.v_img.bias", "blocks.0.cross_attn.norm_k_img.weight"):
        assert key in state, key
    init = convert_wan.mhla_init_params(model)
    tree = convert_wan.convert_wan_checkpoint(state, model.cfg, init)
    assert_trees_equal(tree, jax_convert_wan.convert_wan_checkpoint(state, jax_model.cfg, init))
    model.load_state_dict(wan_params_from_jax(tree))
    assert set(convert_wan.reference_names(model).values()) == set(state)
    x, t, ctx, fea = i2v[3]
    ref = jax.jit(jax_model.apply)(_to_jax(tree), *(jnp.asarray(a) for a in (x, t, ctx, fea)))
    with torch.no_grad():
        out = model.eval()(*(torch.from_numpy(a) for a in (x, t, ctx, fea)))
    assert_close("converted i2v velocity", np.asarray(ref), out, TOL)


class _Jitted:
    """A JAX model whose ``apply`` runs under ``jax.jit``, for JAX's sampler."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.apply = jax.jit(model.apply)


def test_sampler_with_clip_features_matches_jax(i2v, monkeypatch):
    """Two DPM-Solver++ steps with CFG 5.0 and shift 3.0 from JAX's noise:
    the features are tiled to the CFG batch in both packages."""
    jax_model, params, port, _, _, _ = i2v
    rng = np.random.default_rng(7)
    text = rng.normal(size=(1, I2V["text_len"], I2V["text_dim"])).astype(np.float32)
    null = rng.normal(size=text.shape).astype(np.float32)
    fea = rng.normal(size=(1, I2V["img_tokens"], I2V["image_dim"])).astype(np.float32)
    key = jax.random.PRNGKey(8)
    noise = np.asarray(jax.random.normal(key, (1, *LATENT), jnp.float32))
    ref = jax_video_inference.sample_video_latents(
        _Jitted(jax_model), params, jnp.asarray(text), jnp.asarray(null), latent_shape=LATENT,
        cfg_scale=5.0, num_steps=2, solver="dpm-solver", flow_shift=3.0, rng=key,
        clip_fea=jnp.asarray(fea))
    monkeypatch.setattr(video_inference.torch, "randn",
                        lambda *a, **kw: torch.from_numpy(noise.copy()))
    out = video_inference.sample_video_latents(
        port, torch.from_numpy(text), torch.from_numpy(null), latent_shape=LATENT, cfg_scale=5.0,
        num_steps=2, solver="dpm-solver", flow_shift=3.0, clip_fea=torch.from_numpy(fea))
    assert out.shape == (1, *LATENT)
    assert_close("i2v dpm-solver latents", np.asarray(ref), out, TOL)
    with pytest.raises(ValueError, match="clip_fea"):
        video_inference.sample_video_latents(port, torch.from_numpy(text), latent_shape=LATENT,
                                             num_steps=1)
