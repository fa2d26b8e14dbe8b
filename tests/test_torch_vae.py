"""Port of the Wan2.1 VAE (``mhla_tpu_torch/models/vae.py``), held against
the JAX package on the CPU at tiny sizes.

One set of weights, drawn with numpy from a fixed seed, goes into the JAX
module's flax tree and through ``vae_params_from_jax`` into the port;
``convert_vae_checkpoint`` gives a tree bit-equal to JAX's from a
reference-named state dict. The port runs its frame-by-frame ops in slices
of a byte budget: a budget of one byte (one frame a slice) gives the JAX
package's single-shot result too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.models import vae as jax_vae
from mhla_tpu_torch.models import vae
from mhla_tpu_torch.models.convert_jax import vae_params_from_jax
from mhla_tpu_torch.utils import assert_close
from t2v_fixtures import assert_trees_equal, random_params
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32 through a few convolutions and norms: other summation orders
TOL = 1e-5
CONFIGS = {
    # one temporal stage (the JAX package's own test config)
    "tiny": dict(dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1, temporal_downsample=(True,)),
    # two temporal stages, a stage with attention, shortcuts
    "two_temporal": dict(dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
                         attn_scales=(0.5,), temporal_downsample=(True, True)),
    # Wan2.1's layout (a 2-D stage, two 3-D stages), narrow
    "wan_layout": dict(dim=4, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
                       temporal_downsample=(False, True, True)),
}
FRAMES = {"tiny": 5, "two_temporal": 9, "wan_layout": 9}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def vaes(request):
    name = request.param
    jcfg, cfg = jax_vae.VAEConfig(**CONFIGS[name]), vae.VAEConfig(**CONFIGS[name])
    model = jax_vae.WanVAE(jcfg)
    video = jnp.zeros((1, FRAMES[name], 16, 16, 3))
    params = random_params(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), video)),
                           seed=1, scale=0.5)
    port = vae.WanVAE(cfg)
    port.load_state_dict(vae_params_from_jax(params))  # strict: every key, every shape
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    encode = jax.jit(lambda v: model.apply(jparams, v, method=jax_vae.WanVAE.encode))
    decode = jax.jit(lambda z: model.apply(jparams, z, method=jax_vae.WanVAE.decode))
    return name, encode, decode, port, params


@pytest.mark.parametrize("slice_bytes", [vae.SLICE_BYTES, 1], ids=["whole", "frame_slices"])
def test_encode_matches_jax(vaes, slice_bytes):
    name, encode, _, port, _ = vaes
    video = np.random.default_rng(2).uniform(-1, 1, (1, FRAMES[name], 16, 16, 3))
    video = video.astype(np.float32)
    ref = np.asarray(encode(video))
    port.slice_bytes = slice_bytes
    out = port.encode(torch.from_numpy(video))
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert_close(f"{name} encode", ref, out, TOL)


@pytest.mark.parametrize("slice_bytes", [vae.SLICE_BYTES, 1], ids=["whole", "frame_slices"])
def test_decode_matches_jax(vaes, slice_bytes):
    name, encode, decode, port, _ = vaes
    z_shape = encode.eval_shape(jnp.zeros((1, FRAMES[name], 16, 16, 3))).shape
    z = np.random.default_rng(3).normal(size=z_shape).astype(np.float32)
    ref = np.asarray(decode(z))
    port.slice_bytes = slice_bytes
    out = port.decode(torch.from_numpy(z))
    assert out.shape == (1, FRAMES[name], 16, 16, 3)
    assert out.abs().max() <= 1.0 and (out.abs() < 1.0).float().mean() > 0.5  # mostly unclipped
    assert_close(f"{name} decode", ref, out, TOL)


def test_decode_is_causal_in_time(vaes):
    """Frames decoded from the first latent frames do not see later ones."""
    name, encode, _, port, _ = vaes
    z_shape = encode.eval_shape(jnp.zeros((1, FRAMES[name], 16, 16, 3))).shape
    z = torch.from_numpy(np.random.default_rng(4).normal(size=z_shape).astype(np.float32))
    port.slice_bytes = vae.SLICE_BYTES
    full = port.decode(z)
    head = port.decode(z[:, :2])
    torch.testing.assert_close(full[:, : head.shape[1]], head, rtol=1e-5, atol=1e-6)


def test_convert_vae_checkpoint_is_bit_equal_to_jax(vaes):
    """A reference-named state dict of the port's shapes: both converters
    give the same tree, and the port loads it strictly."""
    name, _, _, port, params = vaes
    cfg = vae.VAEConfig(**CONFIGS[name])
    rng = np.random.default_rng(5)
    state = {k: rng.normal(size=s).astype(np.float32)
             for k, s in vae.reference_state_shapes(port).items()}
    tree = vae.convert_vae_checkpoint(state, cfg)
    assert_trees_equal(tree, jax_vae.convert_vae_checkpoint(state, jax_vae.VAEConfig(
        **CONFIGS[name])))
    assert_trees_equal(jax.tree_util.tree_map(np.shape, tree),
                       jax.tree_util.tree_map(np.shape, params))
    other = vae.WanVAE(cfg)
    other.load_state_dict(vae_params_from_jax(tree))


def test_reference_names_of_the_full_vae():
    """Wan2.1_VAE.pth's layout: 194 tensors, 126.9 M parameters, the names
    the reference's Sequentials give."""
    shapes = vae.reference_state_shapes(vae.WanVAE(vae.VAEConfig(), device="meta"))
    assert len(shapes) == 194
    assert sum(int(np.prod(s)) for s in shapes.values()) == 126_892_531
    assert shapes["decoder.upsamples.0.residual.0.gamma"] == (384, 1, 1, 1)
    assert shapes["decoder.middle.1.to_qkv.weight"] == (1152, 384, 1, 1)
    assert shapes["decoder.middle.1.norm.gamma"] == (384, 1, 1)
    assert shapes["decoder.upsamples.3.resample.1.weight"] == (192, 384, 3, 3)
    assert shapes["decoder.upsamples.3.time_conv.weight"] == (768, 384, 3, 1, 1)
    assert shapes["decoder.upsamples.4.shortcut.weight"] == (384, 192, 1, 1, 1)
    assert shapes["encoder.head.2.weight"] == (32, 384, 3, 3, 3)
    assert shapes["conv2.weight"] == (16, 16, 1, 1, 1)


MODES = ("upsample2d", "upsample3d", "downsample2d", "downsample3d")


@pytest.mark.parametrize("mode", MODES)
def test_resample_matches_jax(mode):
    """Each resample on 5 frames (4 after frame 0: the time path's [2, c]
    interleave and its stride-2 windows), channels-first in the port."""
    c = 6
    x = np.random.default_rng(6).normal(size=(2, 5, 6, 8, c)).astype(np.float32)
    module = jax_vae.Resample(c, mode)
    params = random_params(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x)), 7)
    ref = np.asarray(module.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    port = vae.Resample(c, mode)
    port.load_state_dict(vae_params_from_jax(params))
    for slice_bytes in (vae.SLICE_BYTES, 1):
        with torch.no_grad():
            out = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(), slice_bytes)
        assert_close(f"{mode} resample", ref, out.permute(0, 2, 3, 4, 1), TOL)


def test_nearest_resize_agrees_at_exact_2x():
    """``jax.image.resize(..., "nearest")`` (the JAX upsample) and
    ``F.interpolate(..., mode="nearest")`` (the port's) pick the same
    source pixels at an exact factor of 2, odd sizes included."""
    x = np.random.default_rng(8).normal(size=(3, 5, 7, 4)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, 10, 14, 4), "nearest"))
    out = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                          scale_factor=2, mode="nearest").permute(0, 2, 3, 1)
    np.testing.assert_array_equal(ref, out.numpy())


def test_channel_rms_norm_and_causal_conv_match_jax():
    x = np.random.default_rng(9).normal(size=(1, 4, 5, 6, 8)).astype(np.float32)
    norm, conv = jax_vae.ChannelRMSNorm(), jax_vae.CausalConv3d(5)
    p_norm = random_params(jax.eval_shape(lambda: norm.init(jax.random.PRNGKey(0), x)), 10)
    p_conv = random_params(jax.eval_shape(lambda: conv.init(jax.random.PRNGKey(0), x)), 11)
    ref_n = np.asarray(norm.apply(jax.tree_util.tree_map(jnp.asarray, p_norm), x))
    ref_c = np.asarray(conv.apply(jax.tree_util.tree_map(jnp.asarray, p_conv), x))
    pn, pc = vae.ChannelRMSNorm(8), vae.CausalConv3d(8, 5)
    pn.load_state_dict(vae_params_from_jax(p_norm))
    pc.load_state_dict(vae_params_from_jax(p_conv))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
    with torch.no_grad():
        assert_close("ChannelRMSNorm", ref_n, pn(xt).permute(0, 2, 3, 4, 1), TOL)
        for slice_bytes in (vae.SLICE_BYTES, 1):
            assert_close("CausalConv3d", ref_c, pc(xt, slice_bytes).permute(0, 2, 3, 4, 1), TOL)
