"""Port of the video path (``MHLA3D``, ``WanModel`` in its full-MHLA, hybrid
and radial-sparse forms, the samplers and the inference CLI), held against
the JAX package on the CPU at a tiny size.

One set of weights, drawn with numpy from a fixed seed, goes into the JAX
modules' flax trees and through ``wan_params_from_jax`` into the port. Head
dim 128 (dim 256, 2 heads) takes the fused island on both sides: the JAX
side runs its Pallas bodies in interpret mode, the port its plain versions.
"""

import dataclasses
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
from mhla_tpu_torch.models import wan
from mhla_tpu_torch.models import (
    WanConfig,
    WanModel,
    build_wan_config,
    init_wan_params,
    wan_params_from_jax,
)
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

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
    "lepe": (dict(is_lepe=True), TOL_LAYER),
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


# ---------------------------------------------------------------------------
# hybrid: MHLA, radial-sparse and dense softmax layers in one model
# ---------------------------------------------------------------------------

HYBRID = dict(TINY, num_layers=4, linear_attn_idx=(0,), sparse_attn_idx=(1, 2))
# grid (4, 6, 6): 4 frames (as no other axis) of 36 tokens, so frame distances
# 2 and 3 are banded
HYBRID_LATENT = (4, 12, 12, 16)


@pytest.fixture(scope="module")
def hybrid_models():
    """(JAX model, its params, port) with layers mhla_uni, sparse, sparse,
    flash; the JAX sparse layers take that package's CPU route (masked
    softmax), the port's their plain version."""
    mhla_chunk_pallas.FORCE_INTERPRET = True
    try:
        jax_model = JaxWanModel(jax_build_wan_config(remat=False, **HYBRID))
        shapes = jax.eval_shape(
            lambda: jax_model.init(
                jax.random.PRNGKey(0), jnp.zeros((1, *HYBRID_LATENT)), jnp.zeros((1,)),
                jnp.zeros((1, TINY["text_len"], TINY["text_dim"])),
            )
        )
    finally:
        mhla_chunk_pallas.FORCE_INTERPRET = False
    params_np = _random_params(shapes, seed=7)
    port = WanModel(build_wan_config(**HYBRID)).eval()
    assert [b.attn_type for b in port.blocks] == ["mhla_uni", "sparse", "sparse", "flash"]
    port.load_state_dict(wan_params_from_jax(params_np))  # strict: q, k, v, o, norm_q, norm_k
    return jax_model, _to_jax(params_np), port


def _hybrid_inputs(t_value, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *HYBRID_LATENT)).astype(np.float32)
    ctx = rng.normal(size=(2, TINY["text_len"], TINY["text_dim"])).astype(np.float32)
    return x, np.full((2,), t_value, np.float32), ctx


def _with_cfg(port, **changes):
    """A model of the same weights under a changed config."""
    other = WanModel(dataclasses.replace(port.cfg, **changes)).eval()
    other.load_state_dict(port.state_dict())
    return other


@pytest.mark.parametrize("t_value", [100.0, 900.0], ids=["sparse", "dense_guard"])
def test_hybrid_wan_model_matches_jax(hybrid_models, t_value):
    jax_model, params, port = hybrid_models
    x, t, ctx = _hybrid_inputs(t_value)
    ref = jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert out.shape == (2, *HYBRID_LATENT)
    assert_close(f"hybrid WanModel t={t_value}", np.asarray(ref), out, TOL)


@pytest.mark.parametrize("t_value", [100.0, 900.0], ids=["sparse", "dense_guard"])
def test_hybrid_wan_model_bf16_compute_matches_jax(hybrid_models, t_value):
    jax_model, params, port = hybrid_models
    x, t, ctx = _hybrid_inputs(t_value, seed=9)
    jax_bf16 = JaxWanModel(jax_build_wan_config(remat=False, dtype=jnp.bfloat16, **HYBRID))
    ref = jax_bf16.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        out = _with_cfg(port, dtype=torch.bfloat16)(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert out.dtype == torch.bfloat16
    # the two frameworks round to bf16 at other places: see the full-MHLA test
    assert_close(f"hybrid bf16 t={t_value}", np.asarray(ref.astype(jnp.float32)), out, 3e-2)


def test_sparse_layers_run_dense_from_the_guard_timestep(hybrid_models):
    """max(t) >= sparse_dense_from_t (850): the sparse layers run dense
    attention, so the model equals the one without ``sparse_attn_idx``;
    below it the mask is active. Without a guard it is active at every t."""
    port = hybrid_models[2]
    dense = _with_cfg(port, sparse_attn_idx=None)
    unguarded = _with_cfg(port, sparse_dense_from_t=None)
    with torch.no_grad():
        for t_value, guarded in ((900.0, True), (850.0, True), (849.0, False), (100.0, False)):
            x, t, ctx = (torch.from_numpy(a) for a in _hybrid_inputs(t_value))
            out, ref = port(x, t, ctx), dense(x, t, ctx)
            assert torch.equal(out, ref) == guarded, t_value
            assert torch.equal(unguarded(x, t, ctx), out) == (not guarded), t_value
        # one row of the batch at or above the threshold is enough
        x, t, ctx = (torch.from_numpy(a) for a in _hybrid_inputs(100.0))
        t[1] = 900.0
        assert torch.equal(port(x, t, ctx), dense(x, t, ctx))


@pytest.mark.parametrize("solver", ["dpm-solver", "flow_euler"])
def test_hybrid_samplers_with_cfg_match_jax(hybrid_models, solver, monkeypatch):
    """Four steps with CFG 5.0 and shift 3.0: the model is called at t x
    1000 = 1000, 900, 750, 501, so two calls take the dense guard and two
    the radial mask."""
    jax_model, params, port = hybrid_models
    rng = np.random.default_rng(10)
    text = rng.normal(size=(1, TINY["text_len"], TINY["text_dim"])).astype(np.float32)
    null = rng.normal(size=text.shape).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, (1, *HYBRID_LATENT), jnp.float32))
    ref = jax_sample_video_latents(
        jax_model, params, jnp.asarray(text), jnp.asarray(null), latent_shape=HYBRID_LATENT,
        cfg_scale=5.0, num_steps=4, solver=solver, flow_shift=3.0, rng=key,
    )
    monkeypatch.setattr(video_inference.torch, "randn",
                        lambda *a, **kw: torch.from_numpy(noise.copy()))
    routes = []
    real = wan.sparse_flash_attention
    monkeypatch.setattr(wan, "sparse_flash_attention",
                        lambda *a, **kw: routes.append("sparse") or real(*a, **kw))
    out = video_inference.sample_video_latents(
        port, torch.from_numpy(text), torch.from_numpy(null), latent_shape=HYBRID_LATENT,
        cfg_scale=5.0, num_steps=4, solver=solver, flow_shift=3.0,
    )
    assert len(routes) == 2 * 2  # two sparse layers in the two calls below t = 850
    assert_close(f"hybrid {solver} latents", np.asarray(ref), out, TOL)


def test_softmax_only_model_matches_jax():
    """``linear_attn_idx=None``: every layer dense softmax, the grid is not
    cropped, and the rotary runs on an odd grid."""
    kw = dict(TINY, linear_attn_idx=None)
    jax_model = JaxWanModel(jax_build_wan_config(remat=False, **kw))
    x, t, ctx = _wan_inputs(seed=11)
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    params_np = _random_params(shapes, seed=12)
    ref = jax_model.apply(_to_jax(params_np), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    port = WanModel(build_wan_config(**kw)).eval()
    port.load_state_dict(wan_params_from_jax(params_np))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert out.shape == (2, 2, 10, 12, 16)  # grid (2, 5, 6), uncropped
    assert_close("softmax-only WanModel", np.asarray(ref), out, TOL)


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


def test_video_infer_cli_samples_a_hybrid_model(tmp_path):
    """``--linear_attn_idx`` with gaps: the other layers are dense softmax."""
    out = video_infer_cli.main(_cli_args(
        tmp_path, num_layers=3, linear_attn_idx="(1,2)", **{"sampling.num_steps": 3}))
    assert [b.attn_type for b in out["model"].blocks] == ["flash", "mhla_uni", "mhla_uni"]
    assert out["model"].cfg.linear_attn_idx == (1, 2)
    for item in out["outputs"]:
        lat = np.load(item["path"])
        assert lat.shape == (3, 10, 20, 16) and np.isfinite(lat).all()


def test_video_infer_cli_rejects_mismatched_embeddings(tmp_path):
    np.savez(tmp_path / "emb.npz", emb_0=np.zeros((8, 64), np.float32),
             emb_1=np.zeros((8, 64), np.float32))
    with pytest.raises(ValueError):
        video_infer_cli.main(_cli_args(tmp_path, emb_file=tmp_path / "emb.npz"))


@pytest.mark.parametrize("overrides", [
    dict(model_type="i2v"), dict(attn_type="linear"), dict(attn_type="gla"),
], ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_unported_model_options_raise(overrides):
    """The linear baselines are not ported and raise when built. Image to
    video is ported (``tests/test_torch_i2v.py``): an i2v model builds and
    raises when called without its CLIP features, as the JAX model asserts."""
    if overrides.get("model_type") == "i2v":
        model = WanModel(WanConfig(**{**TINY, **overrides}))
        x, t, ctx = (torch.from_numpy(a) for a in _wan_inputs())
        with pytest.raises(ValueError, match="clip_fea"):
            model(x, t, ctx)
        return
    with pytest.raises(NotImplementedError):
        WanModel(WanConfig(**{**TINY, **overrides}))


@pytest.mark.parametrize("kwargs", [dict(capture=True), dict(clip_fea=torch.zeros(2, 257, 1280))],
                         ids=["capture", "clip_fea"])
def test_unported_forward_options_raise(wan_models, kwargs):
    """``capture`` is ported (``tests/test_torch_i2v.py`` holds it against
    JAX): it returns the velocity unchanged with one attention and one block
    output per layer. CLIP features given to a text-to-video model raise,
    naming the i2v model that reads them."""
    x, t, ctx = (torch.from_numpy(a) for a in _wan_inputs())
    model = wan_models[2]
    if "capture" in kwargs:
        with torch.no_grad():
            out, caps = model(x, t, ctx, **kwargs)
            assert torch.equal(out, model(x, t, ctx))
        assert [len(caps[k]) for k in ("attn_out", "block_out")] == [TINY["num_layers"]] * 2
        return
    with pytest.raises(ValueError, match="i2v"):
        model(x, t, ctx, **kwargs)


@pytest.mark.parametrize("solver", ["ddim", "lcm"])
def test_unported_solvers_raise(wan_models, solver):
    """Solvers neither package's ``sample_video_latents`` runs."""
    with pytest.raises(ValueError):
        video_inference.sample_video_latents(
            wan_models[2], torch.zeros(1, 16, 64), latent_shape=(2, 8, 12, 16), solver=solver)


def _orbax_like_dir(path):
    """A directory of the JAX package's checkpoint layout: no state.pt."""
    (path / "checkpoints" / "100" / "default").mkdir(parents=True)
    (path / "checkpoints" / "100" / "_CHECKPOINT_METADATA").write_text("{}")
    return path


@pytest.mark.parametrize("option", ["ckpt", "t5_dir", "vae_ckpt", "i2v"])
def test_unported_cli_options_raise(tmp_path, option):
    """What the CLI still cannot take raises, naming it: an orbax checkpoint
    (of the model or the VAE: no JAX here), flax's msgpack T5 weights, and
    an image-to-video model (the CLI takes no image, as JAX's)."""
    if option == "i2v":
        with pytest.raises(ValueError, match="i2v"):
            video_infer_cli.main(_cli_args(tmp_path, model_name="Wan_I2V_1300M"))
        return
    if option == "t5_dir":
        (tmp_path / "t5").mkdir()
        (tmp_path / "t5" / "params.msgpack").write_bytes(b"\x80")
        value, match = tmp_path / "t5", "msgpack"
    else:
        value, match = _orbax_like_dir(tmp_path / option), "orbax"
    with pytest.raises(ValueError, match=match):
        video_infer_cli.main(_cli_args(tmp_path, **{option: value}))


def test_empty_token_grid_is_rejected(wan_models):
    with pytest.raises(ValueError):
        wan_models[2](torch.zeros(1, 1, 10, 12, 16), torch.zeros(1), torch.zeros(1, 16, 64))
