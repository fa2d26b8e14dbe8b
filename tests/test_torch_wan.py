"""Port of the video path (``MHLA3D``, ``WanModel``, the samplers and the
inference CLI), held against the JAX package on the CPU at a tiny size.

One set of weights, drawn with numpy from a fixed seed, goes into the JAX
modules' flax trees and through ``wan_params_from_jax`` into the port. Head
dim 128 (dim 256, 2 heads) takes the fused island on both sides: the JAX
side runs its Pallas bodies in interpret mode, the port its plain versions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.eval.video_inference import sample_video_latents as jax_sample_video_latents
from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu.layers import MHLA3D as JaxMHLA3D
from mhla_tpu.models.wan import WanModel as JaxWanModel
from mhla_tpu.models.wan import build_wan_config as jax_build_wan_config
from mhla_tpu_torch.eval import video_infer_cli, video_inference
from mhla_tpu_torch.layers import MHLA3D, BlockMixing
from mhla_tpu_torch.models import (
    WanConfig,
    WanModel,
    build_wan_config,
    init_wan_params,
    wan_params_from_jax,
)
from mhla_tpu_torch.utils import assert_close

# float32 through one layer: the same math in other summation orders
TOL_LAYER = 1e-5
# float32 through 2 blocks and up to 3 sampler steps (XLA vs ATen GEMMs)
TOL = 1e-4
TINY = dict(num_layers=2, dim=256, num_heads=2, ffn_dim=512, text_len=16, text_dim=64,
            linear_attn_idx=(0, 1), block_layout=(2, 2, 2))
LATENT = (2, 10, 12, 16)  # patch (1, 2, 2) -> grid (2, 5, 6), cropped to (2, 4, 6)
_JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _force_interpret():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    yield
    mhla_chunk_pallas.FORCE_INTERPRET = False


def _random_params(tree, seed: int = 0):
    """Draw every leaf of a flax tree of shapes with numpy: kernels
    N(0, 1/fan_in), biases N(0, 0.02), modulations N(0, 1/16), norm weights
    1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            x = rng.normal(0.0, np.prod(leaf.shape[:-1]) ** -0.5, leaf.shape)
        elif "bias" in name:
            x = rng.normal(0.0, 0.02, leaf.shape)
        elif "modulation" in name:
            x = rng.normal(0.0, 1 / 16, leaf.shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, leaf.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


_LAYER_CASES = {
    # name: (layer kwargs, tolerance)
    "default": (dict(), TOL_LAYER),
    "no_normalize_out": (dict(normalize_out=False), TOL_LAYER),
    "without_rope": (dict(without_rope=True), TOL_LAYER),
    "no_qk_norm_no_gate": (dict(qk_norm=False, is_gated=False), TOL_LAYER),
    "bf16_island": (dict(attn_compute_dtype="bfloat16"), 2e-2),
    "bf16_island_no_normalize": (dict(attn_compute_dtype="bfloat16", normalize_out=False), 2e-2),
    "composed_head_dim_64": (dict(dim=128), TOL_LAYER),
    "composed_no_normalize": (dict(dim=128, normalize_out=False), TOL_LAYER),
}


@pytest.mark.parametrize("case", sorted(_LAYER_CASES))
def test_mhla3d_matches_jax(case):
    kwargs, tol = _LAYER_CASES[case]
    kwargs = dict(kwargs)
    dim = kwargs.pop("dim", 256)
    island = kwargs.pop("attn_compute_dtype", None)
    grid, layout = (4, 4, 6), (2, 2, 2)  # blocks of 2 x 2 x 3 tokens
    x = np.random.default_rng(1).normal(size=(2, 96, dim)).astype(np.float32)

    jax_layer = JaxMHLA3D(dim=dim, num_heads=2, blocks_layout=layout,
                          attn_compute_dtype=_JAX_DT.get(island), **kwargs)
    shapes = jax.eval_shape(
        lambda: jax_layer.init(jax.random.PRNGKey(0), jnp.asarray(x), grid))
    params_np = _random_params(shapes)
    ref = jax_layer.apply(_to_jax(params_np), jnp.asarray(x), grid)

    layer = MHLA3D(dim=dim, num_heads=2, blocks_layout=layout,
                   attn_compute_dtype=_TORCH_DT.get(island), **kwargs)
    layer.load_state_dict(wan_params_from_jax(params_np))
    with torch.no_grad():
        out = layer(torch.from_numpy(x), grid)
    assert out.shape == (2, 96, dim)
    assert_close(f"MHLA3D {case}", np.asarray(ref), out, tol)


def test_block_mixing_fixed_and_trainable():
    fixed, trainable = BlockMixing((2, 2, 2)), BlockMixing((2, 2, 2), trainable=True)
    assert not list(fixed.parameters()) and not fixed.state_dict()
    assert torch.equal(fixed(), trainable())
    with torch.no_grad():
        trainable.weight.add_(torch.linspace(-2, 2, 64).reshape(8, 8))
    out = trainable()
    assert out.min() >= 0.0 and out.max() <= 1.0 and out.requires_grad


@pytest.fixture(scope="module")
def wan_models():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    try:
        jax_model = JaxWanModel(jax_build_wan_config(remat=False, **TINY))
        shapes = jax.eval_shape(
            lambda: jax_model.init(
                jax.random.PRNGKey(0), jnp.zeros((1, *LATENT)), jnp.zeros((1,)),
                jnp.zeros((1, TINY["text_len"], TINY["text_dim"])),
            )
        )
    finally:
        mhla_chunk_pallas.FORCE_INTERPRET = False
    params_np = _random_params(shapes)
    port = WanModel(build_wan_config(**TINY)).eval()
    port.load_state_dict(wan_params_from_jax(params_np))  # strict: every key, every shape
    return jax_model, _to_jax(params_np), port


def _wan_inputs(seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *LATENT)).astype(np.float32)
    t = np.array([700.0, 300.0], np.float32)
    ctx = rng.normal(size=(2, TINY["text_len"], TINY["text_dim"])).astype(np.float32)
    return x, t, ctx


def test_wan_model_matches_jax(wan_models):
    """Two blocks in float32 on a grid that ``grid_adjust`` crops."""
    jax_model, params, port = wan_models
    x, t, ctx = _wan_inputs()
    ref = jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert out.shape == (2, 2, 8, 12, 16)  # (2, 5, 6) cropped to (2, 4, 6), unpatchified
    assert_close("WanModel velocity", np.asarray(ref), out, TOL)


def test_wan_model_bf16_compute_with_float32_parameters_matches_jax(wan_models):
    """``dtype=bfloat16`` over float32 parameters: weights are cast per call,
    the time embedding and the adaLN arithmetic stay float32."""
    jax_model, params, port = wan_models
    x, t, ctx = _wan_inputs(seed=4)
    jax_bf16 = JaxWanModel(jax_build_wan_config(remat=False, dtype=jnp.bfloat16, **TINY))
    ref = jax_bf16.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    port_bf16 = WanModel(build_wan_config(dtype=torch.bfloat16, **TINY)).eval()
    port_bf16.load_state_dict(port.state_dict())
    with torch.no_grad():
        out = port_bf16(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port_bf16.parameters())
    # bf16 rounds at other places in the two frameworks: the model's own
    # bf16-vs-float32 distance at this depth is 6e-3
    assert_close("WanModel bf16", np.asarray(ref.astype(jnp.float32)), out, 3e-2)


@pytest.mark.parametrize("solver", ["dpm-solver", "flow_euler"])
def test_samplers_with_cfg_match_jax(wan_models, solver, monkeypatch):
    """Three steps with CFG 5.0 and shift 3.0 from the same starting noise,
    through both packages' ``sample_video_latents``."""
    jax_model, params, port = wan_models
    latent = (2, 8, 12, 16)
    rng = np.random.default_rng(5)
    text = rng.normal(size=(1, TINY["text_len"], TINY["text_dim"])).astype(np.float32)
    null = rng.normal(size=text.shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (1, *latent), jnp.float32))
    ref = jax_sample_video_latents(
        jax_model, params, jnp.asarray(text), jnp.asarray(null), latent_shape=latent,
        cfg_scale=5.0, num_steps=3, solver=solver, flow_shift=3.0, rng=key,
    )
    monkeypatch.setattr(video_inference.torch, "randn",
                        lambda *a, **kw: torch.from_numpy(noise.copy()))
    out = video_inference.sample_video_latents(
        port, torch.from_numpy(text), torch.from_numpy(null), latent_shape=latent,
        cfg_scale=5.0, num_steps=3, solver=solver, flow_shift=3.0,
    )
    assert out.shape == (1, *latent) and out.dtype == torch.float32
    assert_close(f"{solver} latents", np.asarray(ref), out, TOL)


def test_init_wan_params_follows_the_flax_distributions():
    model = init_wan_params(WanModel(build_wan_config(**TINY)), torch.Generator().manual_seed(0))
    w = model.blocks[0].ffn_fc1.weight  # fan_in 256
    bound = 2 * 256**-0.5 / 0.87962566103423978
    assert abs(w.std().item() - 256**-0.5) < 0.05 * 256**-0.5
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.9 * bound
    conv = model.patch_embedding.weight  # fan_in 16 * 1 * 2 * 2
    assert abs(conv.std().item() - 64**-0.5) < 0.05 * 64**-0.5
    assert all(torch.count_nonzero(m.bias) == 0 for m in model.modules()
               if isinstance(m, (torch.nn.Linear, torch.nn.Conv3d)))
    mod = torch.cat([b.modulation.flatten() for b in model.blocks])
    assert abs(mod.std().item() - 1 / 16) < 0.1 / 16
    assert torch.equal(model.blocks[0].self_attn.norm_q.weight, torch.ones(256))
    again = init_wan_params(WanModel(build_wan_config(**TINY)), torch.Generator().manual_seed(0))
    assert torch.equal(again.head.weight, model.head.weight)


def _cli_args(tmp_path, **extra):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a red kite over dunes\n\n  a tram at night  \n")
    args = {
        "device": "cpu", "txt_file": prompts, "out_dir": tmp_path / "out", "bf16": "false",
        "num_layers": 2, "dim": 256, "num_heads": 2, "ffn_dim": 512, "text_len": 16,
        "text_dim": 64, "sampling.latent_shape": "(3,10,20,16)", "sampling.num_steps": 2,
        **extra,
    }
    return [f"--{k}={v}" for k, v in args.items()]


@pytest.mark.parametrize("with_emb_file", [False, True])
def test_video_infer_cli_writes_latents_and_manifest(tmp_path, with_emb_file):
    extra = {}
    if with_emb_file:
        rng = np.random.default_rng(6)
        emb = {f"emb_{i}": rng.normal(size=(16, 64)).astype(np.float32) for i in range(2)}
        np.savez(tmp_path / "emb.npz", null=rng.normal(size=(16, 64)).astype(np.float32), **emb)
        extra["emb_file"] = tmp_path / "emb.npz"
    out = video_infer_cli.main(_cli_args(tmp_path, **extra))
    manifest = json.loads((tmp_path / "out" / "manifest.json").read_text())
    assert [m["prompt"] for m in manifest] == ["a red kite over dunes", "a tram at night"]
    assert manifest == out["outputs"] and len(out["sample_seconds"]) == 2
    latents = [np.load(m["path"]) for m in manifest]
    for lat in latents:
        assert lat.shape == (3, 10, 20, 16) and lat.dtype == np.float32
        assert np.isfinite(lat).all()
    # each prompt starts from its own noise (seed + index), so the samples differ
    assert not np.allclose(latents[0], latents[1])
    assert (tmp_path / "out" / "config.yaml").exists()


def test_video_infer_cli_rejects_mismatched_embeddings(tmp_path):
    np.savez(tmp_path / "emb.npz", emb_0=np.zeros((8, 64), np.float32),
             emb_1=np.zeros((8, 64), np.float32))
    with pytest.raises(ValueError):
        video_infer_cli.main(_cli_args(tmp_path, emb_file=tmp_path / "emb.npz"))


@pytest.mark.parametrize("overrides", [
    dict(model_type="i2v"), dict(attn_type="linear"), dict(sparse_attn_idx=(0,)),
    dict(remat=True), dict(linear_attn_idx=(0,)), dict(linear_attn_idx=None),
    dict(is_lepe=True),
], ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_unported_model_options_raise(overrides):
    with pytest.raises(NotImplementedError):
        WanModel(WanConfig(**{**TINY, **overrides}))


@pytest.mark.parametrize("kwargs", [dict(capture=True), dict(clip_fea=torch.zeros(2, 257, 1280))],
                         ids=["capture", "clip_fea"])
def test_unported_forward_options_raise(wan_models, kwargs):
    x, t, ctx = (torch.from_numpy(a) for a in _wan_inputs())
    with pytest.raises(NotImplementedError):
        wan_models[2](x, t, ctx, **kwargs)


@pytest.mark.parametrize("solver", ["unipc", "sa-solver"])
def test_unported_solvers_raise(wan_models, solver):
    with pytest.raises(NotImplementedError):
        video_inference.sample_video_latents(
            wan_models[2], torch.zeros(1, 16, 64), latent_shape=(2, 8, 12, 16), solver=solver)
    with pytest.raises(ValueError):
        video_inference.sample_video_latents(
            wan_models[2], torch.zeros(1, 16, 64), latent_shape=(2, 8, 12, 16), solver="ddim")


@pytest.mark.parametrize("option", ["ckpt", "wan_safetensors", "t5_dir", "vae_ckpt"])
def test_unported_cli_options_raise(tmp_path, option):
    with pytest.raises(NotImplementedError):
        video_infer_cli.main(_cli_args(tmp_path, **{option: tmp_path / "missing"}))


def test_empty_token_grid_is_rejected(wan_models):
    with pytest.raises(ValueError):
        wan_models[2](torch.zeros(1, 1, 10, 12, 16), torch.zeros(1), torch.zeros(1, 16, 64))
