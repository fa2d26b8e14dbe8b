"""The image tower of image-to-video (``mhla_tpu_torch.models.clip``) held
against ``mhla_tpu.models.clip`` on the CPU at a tiny size: the tower
(2 layers, narrow) in its i2v and contrastive forms, the resize of
``preprocess_frames`` shrinking 480 x 800 to 224 and enlarging, the learned
positions' interpolation, and the three converters, whose trees must equal
JAX's bit for bit.

One set of weights, drawn with numpy, goes into the JAX module's flax tree
and through ``clip_params_from_jax`` into the port. The JAX calls run under
``jax.jit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mhla_tpu.models import clip as jax_clip
from mhla_tpu_torch.kernels import flash_attention as flash
from mhla_tpu_torch.models import clip
from mhla_tpu_torch.utils import assert_close

from t2v_fixtures import assert_trees_equal
from test_torch_wan import _random_params, _to_jax
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32 through 2 blocks: the same math in other summation orders (XLA at
# "highest" precision vs ATen)
TOL = 1e-5
TINY = dict(image_size=28, patch_size=7, dim=32, mlp_ratio=2.0, out_dim=16, num_heads=4,
            num_layers=2)
_FORMS = {
    "vit_h_14_form": dict(),  # pre-norm, exact GELU, class token
    "post_norm_quick_gelu": dict(pre_norm=False, post_norm=True, activation="quick_gelu"),
    "no_class_token": dict(pool_type="none"),
}


def _configs(**kw):
    return jax_clip.CLIPVisionConfig(**TINY, **kw), clip.CLIPVisionConfig(**TINY, **kw)


def _towers(form, seed=0):
    jax_cfg, cfg = _configs(**_FORMS[form])
    jax_model = jax_clip.CLIPVisionTransformer(jax_cfg)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 28, 28, 3))))
    params = _random_params(shapes, seed=seed)
    port = clip.CLIPVisionTransformer(cfg)
    port.load_state_dict(clip.clip_params_from_jax(params))  # strict
    return jax_model, _to_jax(params), port


@pytest.mark.parametrize("form", sorted(_FORMS))
def test_tower_matches_jax(form):
    """Every block, the i2v features (``use_31_block``) and, on a 35 x 35
    input (a 5 x 5 grid), the positions interpolated from the 4 x 4 grid."""
    jax_model, params, port = _towers(form)
    apply = jax.jit(jax_model.apply, static_argnames=("use_31_block", "interpolation"))
    rng = np.random.default_rng(1)
    for size, kwargs in ((28, dict(use_31_block=False)), (28, dict(use_31_block=True)),
                         (35, dict(interpolation=True))):
        x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
        ref = apply(params, jnp.asarray(x), **kwargs)
        with torch.no_grad():
            out = port(torch.from_numpy(x), **kwargs)
        assert out.shape == ref.shape
        assert_close(f"{form} {size} {kwargs}", np.asarray(ref), out, TOL)


def test_tower_in_bf16_stays_near_float32():
    """``dtype=bfloat16`` computes in bf16 over float32 parameters."""
    _, _, port = _towers("vit_h_14_form", seed=2)
    half = clip.CLIPVisionTransformer(dataclasses.replace(port.cfg, dtype=torch.bfloat16))
    half.load_state_dict(port.state_dict())
    x = torch.randn(2, 28, 28, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref, out = port(x), half(x)
    assert out.dtype == torch.bfloat16 and all(p.dtype == torch.float32
                                               for p in half.parameters())
    assert_close("bf16 tower", ref, out, 2e-2)  # bf16 rounding through 2 blocks


@pytest.mark.parametrize("shape,size", [((2, 480, 800, 3), 224), ((1, 100, 150, 3), 224),
                                        ((2, 17, 23, 3), 28), ((1, 224, 224, 3), 224)],
                         ids=["shrink_480x800", "enlarge_100x150", "mixed_17x23", "same_size"])
def test_preprocess_frames_matches_jax(shape, size):
    """Keys' cubic (a = -0.5) with the kernel widened when shrinking, as
    ``jax.image.resize(..., "cubic")``; torch's own bicubic (a = -0.75, no
    antialiasing) is not that resize."""
    frames = np.random.default_rng(4).uniform(-1, 1, size=shape).astype(np.float32)
    ref = np.asarray(jax.jit(jax_clip.preprocess_frames, static_argnums=1)(
        jnp.asarray(frames), size))
    out = clip.preprocess_frames(torch.from_numpy(frames), size)
    assert out.shape == (shape[0], size, size, 3) and out.dtype == torch.float32
    assert_close(f"preprocess {shape}", ref, out, 1e-5)
    if shape[1] != size:
        x = torch.from_numpy(frames).permute(0, 3, 1, 2)
        bicubic = F.interpolate(x, (size, size), mode="bicubic", align_corners=False)
        normed = (bicubic.permute(0, 2, 3, 1) * 0.5 + 0.5 - torch.tensor(clip.CLIP_MEAN)) / (
            torch.tensor(clip.CLIP_STD))
        with pytest.raises(AssertionError):
            assert_close("torch bicubic", ref, normed, 1e-3)


def test_cubic_weights_interpolate_and_sum_to_one():
    w = clip.cubic_weights(37, 224)
    assert w.shape == (37, 224)
    torch.testing.assert_close(w.sum(0), torch.ones(224), atol=1e-6, rtol=0)
    assert torch.equal(clip.cubic_weights(9, 9), torch.eye(9))


def test_pos_interpolate_matches_jax():
    pos = np.random.default_rng(5).normal(size=(1, 1 + 16 * 16, 24)).astype(np.float32)
    for seq_len in (1 + 16 * 16, 1 + 9, 1 + 20 * 20):
        ref = np.asarray(jax_clip.pos_interpolate(jnp.asarray(pos), seq_len))
        out = clip.pos_interpolate(torch.from_numpy(pos), seq_len)
        assert out.shape == (1, seq_len, 24)
        assert_close(f"pos {seq_len}", ref, out, 1e-6)
        assert torch.equal(out[:, 0], torch.from_numpy(pos[:, 0]))  # the class entry


def test_encode_i2v_features_matches_jax():
    """The i2v entry: preprocess (a 60 x 90 frame shrunk to 28) and the
    penultimate block's hidden states."""
    jax_model, params, port = _towers("vit_h_14_form", seed=6)
    frames = np.random.default_rng(7).uniform(-1, 1, size=(2, 60, 90, 3)).astype(np.float32)
    ref = jax.jit(lambda p, f: jax_clip.encode_i2v_features(jax_model, p, f))(
        params, jnp.asarray(frames))
    out = clip.encode_i2v_features(port, torch.from_numpy(frames))
    assert out.shape == (2, 17, 32)
    assert_close("encode_i2v_features", np.asarray(ref), out, TOL)


def _reference_state(cfg, rng):
    """A reference-named ``visual.*`` state dict of ``cfg`` (and a few text
    tower entries, which the image converters leave unread)."""
    sd = lambda *shape: rng.standard_normal(shape).astype(np.float32) * 0.05  # noqa: E731
    mid = int(cfg.dim * cfg.mlp_ratio)
    p = cfg.patch_size
    s = {"visual.patch_embedding.weight": sd(cfg.dim, 3, p, p),
         "visual.cls_embedding": sd(1, 1, cfg.dim),
         "visual.pos_embedding": sd(1, 1 + (cfg.image_size // p) ** 2, cfg.dim),
         "visual.pre_norm.weight": 1 + sd(cfg.dim), "visual.pre_norm.bias": sd(cfg.dim),
         "textual.token_embedding.weight": sd(8, 4), "log_scale": np.float32(2.65926)}
    for i in range(cfg.num_layers):
        q = f"visual.transformer.{i}."
        for n in ("norm1", "norm2"):
            s[q + n + ".weight"], s[q + n + ".bias"] = 1 + sd(cfg.dim), sd(cfg.dim)
        for n, (o, i_) in {"attn.to_qkv": (3 * cfg.dim, cfg.dim), "attn.proj": (cfg.dim, cfg.dim),
                           "mlp.0": (mid, cfg.dim), "mlp.2": (cfg.dim, mid)}.items():
            s[q + n + ".weight"], s[q + n + ".bias"] = sd(o, i_), sd(o)
    return s


def test_reference_converters_equal_jax_and_load():
    """``convert_clip_vision`` and the visual part of
    ``convert_clip_checkpoint`` give JAX's trees bit for bit; the tree loads
    into the port strictly and gives JAX's features."""
    jax_cfg, cfg = _configs()
    state = _reference_state(cfg, np.random.default_rng(8))
    tree = clip.convert_clip_vision(state, cfg)
    assert_trees_equal(tree, jax_clip.convert_clip_vision(state, jax_cfg))
    visual = clip.convert_clip_checkpoint(state, cfg)["params"]["visual"]
    assert_trees_equal(visual, tree["params"])
    port = clip.CLIPVisionTransformer(cfg)
    port.load_state_dict(clip.clip_params_from_jax(tree))
    x = np.random.default_rng(9).normal(size=(1, 28, 28, 3)).astype(np.float32)
    ref = jax.jit(jax_clip.CLIPVisionTransformer(jax_cfg).apply)(_to_jax(tree), jnp.asarray(x))
    with torch.no_grad():
        assert_close("converted tower", np.asarray(ref), port(torch.from_numpy(x)), TOL)


def test_hf_converter_equals_jax_and_matches_hf_clip_vision():
    """``convert_hf_clip_vision`` gives JAX's tree bit for bit, and the port
    on it gives HuggingFace's own ``CLIPVisionModel`` hidden states."""
    transformers = pytest.importorskip("transformers")
    jax_cfg, cfg = _configs()
    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        image_size=28, patch_size=7, hidden_act="gelu", layer_norm_eps=1e-5)
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModel(hf_cfg).eval()
    state = {k: v.numpy() for k, v in hf.state_dict().items()}
    tree = clip.convert_hf_clip_vision(state, cfg)
    assert_trees_equal(tree, jax_clip.convert_hf_clip_vision(state, jax_cfg))
    port = clip.CLIPVisionTransformer(cfg)
    port.load_state_dict(clip.clip_params_from_jax(tree))
    img = np.random.default_rng(10).standard_normal((2, 3, 28, 28)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(img)).last_hidden_state
        out = port(torch.from_numpy(img.transpose(0, 2, 3, 1)))
    assert_close("HF CLIPVisionModel", ref, out, 1e-5)


def test_vit_h_14_names_and_shapes_equal_jax():
    """The full ViT-H/14 (32 layers, dim 1280, 16 heads of 80): every JAX
    parameter has its port counterpart of the bridged shape, and no more."""
    shapes = jax.eval_shape(lambda: jax_clip.CLIPVisionTransformer().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    tiny = jax.tree_util.tree_map(lambda s: np.zeros((1,) * len(s.shape), np.float32), shapes)
    names = clip.clip_params_from_jax(tiny)  # names only: each leaf a 1-element stand-in
    port = clip.CLIPVisionTransformer(clip.CLIP_VIT_H_14, device="meta").state_dict()
    assert set(names) == set(port)
    flat = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert sum(int(np.prod(s)) for s in flat.values()) == sum(t.numel() for t in port.values())
    assert port["blocks.31.attn.to_qkv.weight"].shape == (3840, 1280)
    assert port["patch_embedding.weight"].shape == (1280, 3, 14, 14)
    assert port["pos_embedding"].shape == (1, 257, 1280)


def test_head_dim_80_stays_off_the_flash_route(monkeypatch):
    """257 tokens of 16 heads of 80 take the plain attention, as JAX's sdpa
    routes them (head dim not a multiple of 128, fewer than 2,048 queries)."""
    def refuse(*args, **kwargs):
        raise AssertionError("CLIP attention reached the flash kernel")

    monkeypatch.setattr(flash, "flash_attention", refuse)
    monkeypatch.setattr("mhla_tpu_torch.layers.attention.flash_attention", refuse)
    attn = clip.CLIPAttention(1280, 16)
    with torch.no_grad():
        out = attn(torch.randn(1, 257, 1280, generator=torch.Generator().manual_seed(11)))
    assert out.shape == (1, 257, 1280) and torch.isfinite(out).all()
