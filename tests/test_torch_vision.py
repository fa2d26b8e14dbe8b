"""Port of the image models (``MLP``, ``MHLA2D``, ``LinearAttention2D``,
``MHLAViT``, ``DiT``, the standard-DiT checkpoint conversion) and of
``MHLA3D``'s LePE convolution, held against the JAX package on the CPU at a
tiny size.

One set of weights, drawn with numpy from a fixed seed, goes into the JAX
modules' flax trees and through the weight bridges into the port; outputs
and gradients (by ``jax.vjp`` and torch autograd of sum(out * w)) are
compared. Float32 outputs within rel-RMS 1e-5, gradients 1e-4, bf16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu.layers import MHLA2D as JaxMHLA2D
from mhla_tpu.layers import MHLA3D as JaxMHLA3D
from mhla_tpu.layers import MLP as JaxMLP
from mhla_tpu.layers import LinearAttention2D as JaxLinearAttention2D
from mhla_tpu.models.convert_dit import convert_dit_checkpoint as jax_convert_dit_checkpoint
from mhla_tpu.models.dit import DiT as JaxDiT
from mhla_tpu.models.dit import DiTConfig as JaxDiTConfig
from mhla_tpu.models.dit import sincos_pos_embed_2d as jax_sincos_pos_embed_2d
from mhla_tpu.models.dit import timestep_embedding as jax_timestep_embedding
from mhla_tpu.models.vit import MHLAViT as JaxMHLAViT
from mhla_tpu.models.vit import ViTConfig as JaxViTConfig
from mhla_tpu_torch.layers import MHLA2D, MHLA3D, MLP, LinearAttention2D
from mhla_tpu_torch.models import (
    DiT,
    DiTConfig,
    MHLAViT,
    ViTConfig,
    build_dit,
    build_vit,
    convert_dit_checkpoint,
    dit_params_from_jax,
    init_dit_params,
    init_vit_params,
    vit_params_from_jax,
    wan_params_from_jax,
)
from mhla_tpu_torch.models.dit import sincos_pos_embed_2d, timestep_embedding
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

TOL_OUT, TOL_GRAD, TOL_BF16 = 1e-5, 1e-4, 3e-2
VIT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, piece_size=2,
           num_classes=10)
DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64, depth=2, num_heads=2,
           block_size=4, num_classes=10)
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _force_interpret():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    yield
    mhla_chunk_pallas.FORCE_INTERPRET = False


def random_params(tree, seed: int = 0):
    """Draw every leaf of a flax tree of shapes with numpy: kernels N(0,
    1/fan_in), biases N(0, 0.02), trainable mixing U(0.05, 0.95), position
    embeddings and label tables N(0, 0.5), norm weights 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            x = rng.normal(0.0, np.prod(leaf.shape[:-1]) ** -0.5, leaf.shape)
        elif "bias" in name:
            x = rng.normal(0.0, 0.02, leaf.shape)
        elif "piece_attn" in name:
            x = rng.uniform(0.05, 0.95, leaf.shape)
        elif "pos_embed" in name or "embedding" in name:
            x = rng.normal(0.0, 0.5, leaf.shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, leaf.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def pair(jax_module, init_args, port_module, bridge, seed=0, rngs=None):
    """Random numpy weights for ``jax_module`` (initialized on
    ``init_args``), loaded into ``port_module``; returns the flax tree."""
    rngs = rngs or jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jax_module.init(rngs, *init_args))
    params = random_params(shapes, seed)
    port_module.load_state_dict(bridge(params))
    return params


def check_outputs_and_grads(tag, jax_fn, params, port_module, port_fn, inputs, tol_out=TOL_OUT,
                            tol_grad=TOL_GRAD, bridge=vit_params_from_jax, input_grads=True,
                            grad_limits=None):
    """Output of ``jax_fn(params, *inputs)`` against ``port_fn(*inputs)``,
    then the gradients of sum(out * w) in the float inputs and in every
    parameter of ``port_module``: each tensor within ``tol_grad``, or within
    its own limit in ``grad_limits`` (name -> limit)."""
    jin = [jnp.asarray(x) for x in inputs]
    shape = jax.eval_shape(jax_fn, params, *jin)
    w = np.random.default_rng(99).normal(size=shape.shape).astype(np.float32)

    @jax.jit
    def value_and_vjp(p, xs, w):
        out, vjp = jax.vjp(jax_fn, p, *xs)
        return out, vjp(w.astype(out.dtype))

    ref, (dparams, *dins) = value_and_vjp(to_jax(params), jin, jnp.asarray(w))
    tin = [torch.from_numpy(x) for x in inputs]
    for x in tin:
        if x.is_floating_point() and input_grads:
            x.requires_grad_()
    out = port_fn(*tin)
    assert out.shape == tuple(ref.shape)
    assert_close(f"{tag} output", np.asarray(ref, np.float32), out.detach(), tol_out)
    (out.float() * torch.from_numpy(w)).sum().backward()
    for x, dx in zip(tin, dins):
        if x.requires_grad:
            assert_close(f"{tag} d input", np.asarray(dx, np.float32), x.grad, tol_grad)
    want = bridge(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), dparams))
    names = [n for n, _ in port_module.named_parameters()]
    assert set(want) == set(names)
    limits = grad_limits or {}
    assert set(limits) <= set(names)
    for name, p in port_module.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert_close(f"{tag} d {name}", want[name], p.grad, limits.get(name, tol_grad))


# ---- layers ------------------------------------------------------------


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact", "silu"])
def test_mlp_matches_jax(activation):
    x = np.random.default_rng(1).normal(size=(2, 5, 16)).astype(np.float32)
    jax_mlp = JaxMLP(hidden_features=48, activation=activation)
    mlp = MLP(16, 48, activation=activation)
    params = pair(jax_mlp, (jnp.asarray(x),), mlp, vit_params_from_jax)
    check_outputs_and_grads(f"MLP {activation}", jax_mlp.apply, params, mlp, mlp, [x])


_MHLA2D_CASES = {
    # ViT's form: fixed cos mixing, LePE 5, q/k RMSNorm, qkv bias
    "vit": dict(transform="cos", qk_norm=True, qkv_bias=True, lepe_kernel=5),
    # DiT's form: trainable clamped linear mixing, LePE 3, qkv bias
    "dit": dict(transform="linear", trainable_mixing=True, qkv_bias=True, lepe_kernel=3),
    "lepe5_trainable_no_input_norm": dict(trainable_mixing=True, lepe_kernel=5,
                                          use_input_norm=False),
    "lepe3_fixed_exp": dict(transform="exp", exp_sigma=1.0, lepe_kernel=3),
}


@pytest.mark.parametrize("case", sorted(_MHLA2D_CASES))
def test_mhla2d_matches_jax(case):
    """Blocks of 2 x 2 tokens on a (3, 3) block layout: a 6 x 6 grid, so the
    LePE convolution's padding and the block rearrange both matter."""
    kw = _MHLA2D_CASES[case]
    x = np.random.default_rng(2).normal(size=(2, 9, 4, 32)).astype(np.float32)
    jax_layer = JaxMHLA2D(dim=32, num_heads=2, blocks_per_side=3, block_len=2, **kw)
    layer = MHLA2D(32, 2, blocks_per_side=3, block_len=2, **kw)
    params = pair(jax_layer, (jnp.asarray(x),), layer, vit_params_from_jax, seed=3)
    check_outputs_and_grads(f"MHLA2D {case}", jax_layer.apply, params, layer, layer, [x])


def test_mhla2d_trainable_mixing_is_clamped_where_read():
    """Mixing weights outside [0, 1] are read clamped in both packages, and
    give no gradient there."""
    x = np.random.default_rng(4).normal(size=(1, 4, 4, 32)).astype(np.float32)
    kw = dict(transform="linear", trainable_mixing=True, lepe_kernel=3)
    jax_layer = JaxMHLA2D(dim=32, num_heads=2, blocks_per_side=2, block_len=2, **kw)
    layer = MHLA2D(32, 2, blocks_per_side=2, block_len=2, **kw)
    params = pair(jax_layer, (jnp.asarray(x),), layer, vit_params_from_jax, seed=5)
    params["params"]["piece_attn"]["weight"] = np.array(
        [[1.5, 0.2, -0.3, 0.4], [0.1, 0.9, 0.2, 2.0], [-1.0, 0.3, 0.5, 0.2], [0.3, 0.3, 0.3, 0.3]],
        np.float32)
    layer.load_state_dict(vit_params_from_jax(params))
    check_outputs_and_grads("MHLA2D clamped", jax_layer.apply, params, layer, layer, [x])
    grad = layer.piece_attn.weight.grad
    assert torch.all(grad[layer.piece_attn.weight > 1] == 0)
    assert torch.all(grad[layer.piece_attn.weight < 0] == 0)


def test_linear_attention2d_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 12, 32)).astype(np.float32)
    jax_layer = JaxLinearAttention2D(dim=32, num_heads=2)
    layer = LinearAttention2D(32, 2)
    params = pair(jax_layer, (jnp.asarray(x),), layer, vit_params_from_jax, seed=7)
    check_outputs_and_grads("LinearAttention2D", jax_layer.apply, params, layer, layer, [x])


_LEPE3D_CASES = {
    # head dim 128: K5-K8's route (their plain versions here), as Wan builds
    # the layer (norm_output false)
    "fused_no_normalize": dict(dim=256, normalize_out=False),
    "composed_head_dim_32": dict(dim=64),
}


@pytest.mark.parametrize("case", sorted(_LEPE3D_CASES))
def test_mhla3d_lepe_matches_jax(case):
    """``MHLA3D(is_lepe=True)``: the 3 x 3 x 3 depthwise convolution of v
    over (F, H, W), added after the gate, output and gradients at the
    tolerances of ``tests/test_torch_wan.py`` (one layer 1e-5, 1e-4)."""
    kw = dict(_LEPE3D_CASES[case])
    dim = kw.pop("dim")
    grid, layout = (4, 4, 6), (2, 2, 2)
    x = np.random.default_rng(8).normal(size=(2, 96, dim)).astype(np.float32)
    jax_layer = JaxMHLA3D(dim=dim, num_heads=2, blocks_layout=layout, is_lepe=True, **kw)
    layer = MHLA3D(dim, 2, layout, is_lepe=True, **kw)
    params = pair(jax_layer, (jnp.asarray(x), grid), layer, wan_params_from_jax, seed=9)
    assert layer.lepe.weight.shape == (dim, 1, 3, 3, 3)
    check_outputs_and_grads(f"MHLA3D LePE {case}",
                            lambda p, xs: jax_layer.apply(p, xs, grid), params, layer,
                            lambda xs: layer(xs, grid), [x], bridge=wan_params_from_jax)


# ---- ViT ---------------------------------------------------------------


def _vit_pair(attn_type, dtype="float32", **kw):
    cfg = dict(VIT, attn_type=attn_type, **kw)
    jdt, tdt = _DT[dtype]
    jax_model = JaxMHLAViT(JaxViTConfig(**cfg, dtype=jdt))
    model = MHLAViT(ViTConfig(**cfg, dtype=tdt))
    params = pair(jax_model, (jnp.zeros((1, cfg["img_size"], cfg["img_size"], 3)),), model,
                  vit_params_from_jax, seed=11)
    return jax_model, model, params


@pytest.mark.parametrize("attn_type", ["mhla", "linear", "softmax"])
def test_vit_matches_jax(attn_type):
    """Logits and every parameter's gradient, float32."""
    jax_model, model, params = _vit_pair(attn_type)
    x = np.random.default_rng(12).normal(size=(2, 32, 32, 3)).astype(np.float32)
    check_outputs_and_grads(f"ViT {attn_type}", jax_model.apply, params, model, model, [x])


def test_vit_pads_smaller_images_as_jax():
    """A 27 x 30 image is padded to 32 x 32 (the odd pixel after) on both
    sides."""
    jax_model, model, params = _vit_pair("mhla")
    x = np.random.default_rng(13).normal(size=(2, 27, 30, 3)).astype(np.float32)
    check_outputs_and_grads("ViT padded", jax_model.apply, params, model, model, [x])


# Block 0's k projection in the bf16 MHLA ViT: four of the 2,048 features
# k_norm(k) sit within a bf16 rounding of relu's kink and change sign
# between the float32 and the bf16 forward (float32 2.4e-3 -> bf16
# -2.4e-4), one of them at a token whose dk is 4.8x dk's RMS. Both
# packages round the qkv product to bf16, but not to the same bits (XLA's
# and oneDNN's bf16 dots), so those signs differ between them too. Readings
# on this test's inputs: to_qkv.weight's bf16 gradient is 3.81e-2 from
# JAX's bf16 gradient, 3.86e-2 from the port's own float32 one and 1.13e-2
# from it with the flipped features left out; JAX's bf16 is 1.16e-2 from
# float32; every other tensor of the ViT and DiT bf16 tests is within
# 2.8e-2 of JAX's.
_VIT_BF16_GRAD_LIMITS = {"mhla": {"blocks.0.attn.to_qkv.weight": 5e-2}, "softmax": {}}


@pytest.mark.parametrize("attn_type", ["mhla", "softmax"])
def test_vit_bf16_matches_jax(attn_type):
    """bf16 compute over float32 parameters: logits within 3e-2, each
    parameter's gradient within 3e-2 (one tensor within its own limit)."""
    jax_model, model, params = _vit_pair(attn_type, "bfloat16")
    x = np.random.default_rng(14).normal(size=(2, 32, 32, 3)).astype(np.float32)
    check_outputs_and_grads(f"ViT bf16 {attn_type}", jax_model.apply, params, model, model, [x],
                            TOL_BF16, TOL_BF16, input_grads=False,
                            grad_limits=_VIT_BF16_GRAD_LIMITS[attn_type])


@pytest.mark.parametrize("attn_type", ["mhla", "linear", "softmax"])
def test_vit_forward_shapes(attn_type):
    """tests/test_vision_models.py::TestViT::test_forward on the port, from
    its own seeded init."""
    cfg = ViTConfig(img_size=64, patch_size=8, embed_dim=64, depth=2, num_heads=2, piece_size=2,
                    num_classes=10, attn_type=attn_type)
    model = init_vit_params(MHLAViT(cfg), torch.Generator().manual_seed(0))
    logits = model(torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)))
    assert logits.shape == (2, 10) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    small = model(torch.zeros(1, 56, 56, 3))  # smaller than img_size: padded
    assert small.shape == (1, 10)


def test_vit_registry():
    model, cfg = build_vit("deit_tiny_mhla", img_size=64, patch_size=8, piece_size=2, depth=2)
    assert cfg.embed_dim == 192 and cfg.attn_type == "mhla" and len(model.blocks) == 2
    _, small = build_vit("deit_small_softmax")
    assert (small.embed_dim, small.num_heads, small.attn_type) == (384, 6, "softmax")
    with pytest.raises(ValueError):
        build_vit("vit_small")


def test_init_vit_params_draws_flax_initializers():
    """lecun-normal kernels (std 1 / sqrt(fan_in), truncated at two std),
    zero biases, pos_embed truncated normal(0.02)."""
    model = init_vit_params(MHLAViT(ViTConfig(**VIT)), torch.Generator().manual_seed(0))
    fc1 = model.blocks[0].mlp.fc1.weight
    assert abs(float(fc1.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert float(fc1.abs().max()) <= 2 * 64 ** -0.5 / 0.87962566103423978 + 1e-6
    assert not model.blocks[0].mlp.fc1.bias.any()
    assert float(model.pos_embed.abs().max()) <= 0.04 and float(model.pos_embed.std()) > 0.01


# ---- DiT ---------------------------------------------------------------


def _dit_pair(dtype="float32", seed=15):
    jdt, tdt = _DT[dtype]
    jax_model = JaxDiT(JaxDiTConfig(**DIT, dtype=jdt))
    model = DiT(DiTConfig(**DIT, dtype=tdt))
    rngs = {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)}
    params = pair(jax_model, (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1,), jnp.int32)), model, dit_params_from_jax, seed,
                  rngs)
    return jax_model, model, params


def _dit_inputs(b=2, seed=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 701, 250, 999][:b], np.int64)
    y = np.array([1, 7, 10, 4][:b], np.int64)  # 10 is the null class
    return x, t, y


def test_dit_matches_jax():
    """Output and every parameter's gradient (the trainable mixing, the
    LePE, adaLN), float32."""
    jax_model, model, params = _dit_pair()
    x, t, y = _dit_inputs()
    check_outputs_and_grads("DiT", lambda p, xs: jax_model.apply(p, xs, jnp.asarray(t),
                                                                 jnp.asarray(y)),
                            params, model, lambda xs: model(xs, torch.from_numpy(t),
                                                            torch.from_numpy(y)),
                            [x], bridge=dit_params_from_jax)


def test_dit_bf16_matches_jax():
    jax_model, model, params = _dit_pair("bfloat16")
    x, t, y = _dit_inputs()
    check_outputs_and_grads("DiT bf16", lambda p, xs: jax_model.apply(p, xs, jnp.asarray(t),
                                                                      jnp.asarray(y)),
                            params, model, lambda xs: model(xs, torch.from_numpy(t),
                                                            torch.from_numpy(y)),
                            [x], TOL_BF16, TOL_BF16, bridge=dit_params_from_jax,
                            input_grads=False)


def test_dit_label_dropout_and_forward_with_cfg_match_jax():
    """``force_drop`` sends labels to the null class in both packages; the
    CFG forward guides eps only and repeats it over both halves."""
    jax_model, model, params = _dit_pair(seed=17)
    x, t, y = _dit_inputs(4, seed=18)
    drop = np.array([True, False, True, False])
    ref = jax.jit(lambda p, x_, t_, y_, d_: jax_model.apply(p, x_, t_, y_, train=True,
                                                            force_drop=d_))(
        to_jax(params), jnp.asarray(x), jnp.asarray(t), jnp.asarray(y), jnp.asarray(drop))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y), train=True,
                    force_drop=torch.from_numpy(drop))
    assert_close("DiT force_drop", np.asarray(ref), out, TOL_OUT)
    ref = jax.jit(lambda p, *a: jax_model.forward_with_cfg(p, *a, 4.0))(
        to_jax(params), jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        out = model.forward_with_cfg(torch.from_numpy(x), torch.from_numpy(t),
                                     torch.from_numpy(y), 4.0)
    assert_close("DiT forward_with_cfg", np.asarray(ref), out, TOL_OUT)
    assert torch.equal(out[:2, ..., :4], out[2:, ..., :4])


def test_dit_label_dropout_draws_from_the_generator():
    model = init_dit_params(DiT(DiTConfig(**DIT)), torch.Generator().manual_seed(0))
    x, t, _ = (torch.from_numpy(a) for a in _dit_inputs(4))
    y = torch.tensor([1, 2, 3, 4])

    def run(seed):
        return model(x, t, y, train=True, generator=torch.Generator().manual_seed(seed))

    u = torch.rand(4, generator=torch.Generator().manual_seed(5))
    want = model(x, t, y, force_drop=u < model.cfg.class_dropout_prob)
    assert torch.equal(run(5), want) and torch.equal(run(5), run(5))


def test_timestep_and_position_embeddings_match_jax():
    t = np.array([0, 1, 17, 999], np.float32)
    for dim in (256, 33):
        assert_close(f"timestep_embedding {dim}", np.asarray(jax_timestep_embedding(
            jnp.asarray(t), dim)), timestep_embedding(torch.from_numpy(t), dim), TOL_OUT)
    np.testing.assert_array_equal(sincos_pos_embed_2d(64, 4), jax_sincos_pos_embed_2d(64, 4))


def test_dit_zero_init_final_and_identity_lepe():
    """tests/test_vision_models.py::TestDiT::test_zero_init_final on the
    port: adaLN-Zero gives an output of exactly 0 at init; the LePE starts as
    the identity."""
    model = init_dit_params(DiT(DiTConfig(input_size=16, patch_size=2, hidden_size=64, depth=1,
                                          num_heads=2, block_size=4, num_classes=10)),
                            torch.Generator().manual_seed(0))
    out = model(torch.zeros(1, 16, 16, 4), torch.zeros(1, dtype=torch.long),
                torch.zeros(1, dtype=torch.long))
    assert out.shape == (1, 16, 16, 8) and float(out.abs().max()) == 0.0
    lepe = model.blocks[0].attn.lepe
    v = torch.randn(1, 5, 5, 64)
    from mhla_tpu_torch.layers import depthwise_conv

    assert torch.equal(depthwise_conv(v, lepe), v)


def test_dit_registry_names():
    model, cfg = build_dit("DiT-S/2", input_size=16, block_size=4)
    assert cfg.hidden_size == 384 and cfg.depth == 12 and len(model.blocks) == 12
    _, xl = build_dit("DiT-XL/4", depth=2)
    assert (xl.hidden_size, xl.patch_size, xl.depth) == (1152, 4, 2)


def _standard_dit_state(cfg, rng):
    """A synthetic standard-DiT state dict (facebook layout), as
    tests/test_vision_models.py builds one."""
    d, s = cfg["hidden_size"], {}

    def lin(name, nin, nout):
        s[name + ".weight"] = rng.standard_normal((nout, nin), np.float32) * 0.02
        s[name + ".bias"] = np.zeros(nout, np.float32)

    s["x_embedder.proj.weight"] = rng.standard_normal((d, 4, 2, 2), np.float32) * 0.02
    s["x_embedder.proj.bias"] = np.zeros(d, np.float32)
    s["pos_embed"] = np.zeros((1, 16, d), np.float32)  # a buffer the model computes
    lin("t_embedder.mlp.0", 256, d)
    lin("t_embedder.mlp.2", d, d)
    s["y_embedder.embedding_table.weight"] = rng.standard_normal(
        (cfg["num_classes"] + 1, d), np.float32) * 0.02
    for i in range(cfg["depth"]):
        lin(f"blocks.{i}.attn.qkv", d, 3 * d)
        lin(f"blocks.{i}.attn.proj", d, d)
        lin(f"blocks.{i}.adaLN_modulation.1", d, 6 * d)
        lin(f"blocks.{i}.mlp.fc1", d, 4 * d)
        lin(f"blocks.{i}.mlp.fc2", 4 * d, d)
    lin("final_layer.adaLN_modulation.1", d, 2 * d)
    lin("final_layer.linear", d, 2 * 2 * 8)
    return s


def test_convert_dit_checkpoint_matches_jax():
    """The same standard-DiT state dict through both conversions, the MHLA
    parameters from the same fresh weights: the port's result is the JAX
    result through the bridge, and the converted models agree."""
    jax_model, model, params = _dit_pair(seed=19)
    state = _standard_dit_state(DIT, np.random.default_rng(0))
    ref = jax_convert_dit_checkpoint(state, JaxDiTConfig(**DIT), to_jax(params))
    ref_np = jax.tree_util.tree_map(np.asarray, ref)
    got = convert_dit_checkpoint(state, model.cfg, model.state_dict())
    want = dit_params_from_jax(ref_np)
    assert set(got) == set(want) == set(model.state_dict())
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # checkpoint projections inherited, the MHLA mixing and LePE fresh
    assert torch.equal(got["blocks.0.attn.to_qkv.weight"],
                       torch.from_numpy(state["blocks.0.attn.qkv.weight"]))
    assert torch.equal(got["blocks.1.attn.lepe.weight"], model.blocks[1].attn.lepe.weight)
    model.load_state_dict(got)
    x, t, y = _dit_inputs()
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    ref_out = jax_model.apply(ref, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    assert out.shape == (2, 8, 8, 8) and torch.isfinite(out).all()
    assert_close("converted DiT", np.asarray(ref_out), out, TOL_OUT)
    with pytest.raises(KeyError):
        convert_dit_checkpoint(state, model.cfg, {})
