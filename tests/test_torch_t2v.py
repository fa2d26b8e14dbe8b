"""Port of the text-to-video pipeline around ``WanModel``: the Wan
checkpoint converter and the safetensors reader, UniPC and SA-Solver, the
VBench plumbing and ``video_infer_cli`` end to end (T5 weights and a
tokenizer, a reference safetensors checkpoint, a reference VAE ``.pth``),
held against the JAX package on the CPU at a tiny size.

One set of weights, drawn with numpy from a fixed seed, goes through both
packages' converters; the starting noise (and SA-Solver's per-step noise)
is JAX's, handed to the port through ``torch.randn``. Head dim 128 (dim
256, 2 heads) takes the fused island on both sides: the JAX side runs its
Pallas bodies in interpret mode, the port its plain versions.
"""

import functools
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.diffusion import sa_solver as jax_sa_solver
from mhla_tpu.diffusion import unipc as jax_unipc
from mhla_tpu.eval import vbench as jax_vbench
from mhla_tpu.eval import video_inference as jax_video_inference
from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu.models import convert_wan as jax_convert_wan
from mhla_tpu.models import t5 as jax_t5
from mhla_tpu.models import vae as jax_vae
from mhla_tpu.models.wan import WanModel as JaxWanModel
from mhla_tpu.models.wan import build_wan_config as jax_build_wan_config
from mhla_tpu_torch.diffusion import sa_solver, unipc
from mhla_tpu_torch.eval import vbench, video_infer_cli, video_inference
from mhla_tpu_torch.models import WanModel, build_wan_config, init_wan_params, wan_params_from_jax
from mhla_tpu_torch.models import convert_wan, vae
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.checkpoint import save_checkpoint
from mhla_tpu_torch.utils.safetensors_io import load_safetensors
from t2v_fixtures import assert_trees_equal, save_tokenizer, t5_reference_state

os.environ.setdefault("HF_HUB_OFFLINE", "1")

# float32 through 2 blocks and up to 3 sampler steps (XLA vs ATen GEMMs), as
# test_torch_wan.py's TOL
TOL = 1e-4
TINY = dict(num_layers=2, dim=256, num_heads=2, ffn_dim=512, text_len=16, text_dim=32,
            linear_attn_idx=(0, 1), block_layout=(2, 2, 2))
LATENT = (3, 8, 12, 16)  # patch (1, 2, 2) -> grid (3, 4, 6), cropped to (2, 4, 6)
SAMPLE = (2, 8, 12, 16)  # a grid the block layout divides: the sampler's latents
CLI_LATENT = (3, 10, 20, 16)  # the CLI's model keeps the (3, 5, 10) block layout
TINY_VAE = dict(dim=8, z_dim=16, dim_mult=(1, 2), num_res_blocks=1, temporal_downsample=(True,))


@pytest.fixture(autouse=True)
def _force_interpret():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    yield
    mhla_chunk_pallas.FORCE_INTERPRET = False


def _reference_state(model: WanModel, seed: int = 0, with_mhla: bool = False):
    """A seeded state dict in the reference's names and shapes, numpy."""
    rng = np.random.default_rng(seed)
    state = {}
    params = model.state_dict()
    for ours, name in convert_wan.reference_names(model, with_mhla).items():
        shape = tuple(params[ours].shape)
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


@pytest.fixture(scope="module")
def wan_pair():
    """The JAX model, its params converted from a reference state dict
    saved from the MHLA model (gates included), and the port on the same."""
    port = WanModel(build_wan_config(**TINY)).eval()
    state = _reference_state(port, with_mhla=True)
    port.load_state_dict(wan_params_from_jax(convert_wan.convert_wan_checkpoint(state, port.cfg)))
    jax_model = JaxWanModel(jax_build_wan_config(remat=False, **TINY))
    params = jax_convert_wan.convert_wan_checkpoint(state, jax_model.cfg)
    return jax_model, jax.tree_util.tree_map(jnp.asarray, params), port, state


CONVERT_CASES = {
    "full_mhla_with_gates": (dict(), True, False),
    "full_mhla_fresh_gates": (dict(), False, True),
    "hybrid": (dict(num_layers=3, linear_attn_idx=(1, 2)), False, True),
    "no_qk_norm_ungated": (dict(qk_norm=False, is_gated=False), False, False),
}


@pytest.mark.parametrize("case", sorted(CONVERT_CASES))
def test_convert_wan_checkpoint_is_bit_equal_to_jax(case):
    overrides, with_mhla, fresh = CONVERT_CASES[case]
    cfg = build_wan_config(**{**TINY, **overrides})
    model = init_wan_params(WanModel(cfg), torch.Generator().manual_seed(1))
    state = _reference_state(model, seed=2, with_mhla=with_mhla)
    init = convert_wan.mhla_init_params(model) if fresh else None
    tree = convert_wan.convert_wan_checkpoint(state, cfg, init)
    ref = jax_convert_wan.convert_wan_checkpoint(
        state, jax_build_wan_config(**{**TINY, **overrides}), init)
    assert_trees_equal(tree, ref)
    model.load_state_dict(wan_params_from_jax(tree))  # strict: every key, every shape


def test_converted_model_follows_the_checkpoint():
    """q and k (and their norms) by ``rope_feature_permutation``, every
    other parameter as saved, the MHLA gates from the seeded init."""
    cfg = build_wan_config(**TINY)
    model = init_wan_params(WanModel(cfg), torch.Generator().manual_seed(1))
    init = {n: p.clone() for n, p in model.state_dict().items()}
    state = _reference_state(model, seed=3)
    model.load_state_dict(wan_params_from_jax(
        convert_wan.convert_wan_checkpoint(state, cfg, convert_wan.mhla_init_params(model))))
    perm = convert_wan.rope_feature_permutation(cfg.dim, cfg.num_heads)
    np.testing.assert_array_equal(perm, jax_convert_wan.rope_feature_permutation(256, 2))
    assert sorted(perm.tolist()) == list(range(256)) and perm[:3].tolist() == [0, 2, 4]
    names = convert_wan.reference_names(model)
    assert sorted(names.values()) == sorted(state)
    for name, p in model.state_dict().items():
        if name not in names:  # the MHLA gates
            assert name.split(".")[3] in ("g", "g_norm") and torch.equal(p, init[name]), name
            continue
        src = state[names[name]]
        if name.split(".")[2:4] in (["self_attn", n] for n in ("q", "k", "norm_q", "norm_k")):
            src = src[perm]
        np.testing.assert_array_equal(p.numpy(), src, err_msg=name)


def test_gate_without_init_params_raises():
    cfg = build_wan_config(**TINY)
    state = _reference_state(WanModel(cfg, device="meta"))
    with pytest.raises(KeyError):
        convert_wan.convert_wan_checkpoint(state, cfg)


def test_converted_checkpoint_runs_like_jax(wan_pair):
    jax_model, params, port, _ = wan_pair
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, *LATENT)).astype(np.float32)
    t = np.array([700.0, 300.0], np.float32)
    ctx = rng.normal(size=(2, 16, 32)).astype(np.float32)
    ref = jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert_close("converted WanModel", np.asarray(ref), out, TOL)


@pytest.mark.parametrize("dtype", ["float32", "float16", "int64", "bool", "uint8"])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(5)
    tensors = {
        "w": (rng.normal(size=(7, 5)) * 10).astype(dtype),
        "scalar": np.asarray(3, dtype),
        "empty": np.zeros((0, 4), dtype),
        "odd": (rng.normal(size=(3,)) * 10).astype(dtype),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "np"})
    ref, out = load_file(path), load_safetensors(path)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape
        np.testing.assert_array_equal(out[k], ref[k])


def test_safetensors_reader_widens_bf16_exactly(tmp_path):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(6)
    tensors = {"a": torch.randn(33, 17, generator=gen).bfloat16(),
               "b": torch.randn(5, generator=gen).to(torch.bfloat16),
               "f": torch.randn(4, 4, generator=gen)}
    path = str(tmp_path / "bf16.safetensors")
    save_file(tensors, path)
    ref, out = load_file(path), load_safetensors(path)
    for k in ref:
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], ref[k].float().numpy())


def test_safetensors_reader_rejects_an_unknown_dtype(tmp_path):
    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}})
    path = tmp_path / "f8.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header.encode() + b"\x00\x00")
    with pytest.raises(ValueError, match="F8_E4M3"):
        load_safetensors(str(path))


@pytest.mark.parametrize("steps,order", [(1, 2), (3, 2), (6, 2), (6, 3), (10, 1)])
def test_unipc_coefficients_match_jax(steps, order):
    ts = unipc._flow_grid(steps, 3.0)
    for a, b in zip(unipc._unipc_coefficients(ts, order),
                    jax_unipc._unipc_coefficients(ts, order)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _toy_x0(shift):
    """A smooth data prediction for sampler-only checks, in both frameworks."""
    def model(x, t, lib):
        tt = t.reshape(-1, *([1] * (x.ndim - 1)))
        return lib.tanh(x) * (1 - tt) + shift * tt
    return model


@pytest.mark.parametrize("schedule", ["flow", "discrete"])
@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_sa_solver_matches_jax_on_a_toy_model(schedule, eta):
    """Both schedules, with and without noise (JAX's per-step draws handed
    to the port): the coefficients, the order policy, the corrector."""
    n = 7
    model = _toy_x0(0.3)
    key = jax.random.PRNGKey(7)
    x = np.random.default_rng(8).normal(size=(2, 5, 3)).astype(np.float32)
    kw = dict(num_steps=n, eta=eta, shift=2.0)
    if schedule == "discrete":
        ac = np.cumprod(1 - np.linspace(1e-4, 2e-2, 1000))
        kw.update(alphas_cumprod=ac, ts=np.linspace(1.0, 1e-3, n + 1))
    ref = jax_sa_solver.sa_solver_sample(lambda x, t: model(x, t, jnp), jnp.asarray(x),
                                         rng=key, **kw)
    draws = iter([torch.from_numpy(np.array(jax.random.normal(k, x.shape)))
                  for k in jax.random.split(key, n)])
    calls = []

    def port_model(x, t):
        calls.append(float(t[0]))
        return model(x, t, torch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sa_solver.torch, "randn", lambda *a, **k: next(draws))
        out = sa_solver.sa_solver_sample(port_model, torch.from_numpy(x), **kw)
    # one model call a transition and one at t_0; JAX's final masked call skipped
    assert len(calls) == n
    if eta:  # the noise entered
        zero = sa_solver.sa_solver_sample(lambda x, t: model(x, t, torch), torch.from_numpy(x),
                                          **{**kw, "eta": 0.0})
        assert not torch.allclose(out, zero, atol=1e-3)
    assert_close(f"sa-solver {schedule} eta={eta}", np.asarray(ref), out, 1e-5)


@pytest.mark.parametrize("use_corrector", [True, False])
def test_unipc_matches_jax_on_a_toy_model(use_corrector):
    model = _toy_x0(-0.2)
    x = np.random.default_rng(9).normal(size=(2, 5, 3)).astype(np.float32)
    for order in (1, 2, 3):
        ref = jax_unipc.unipc_sample(lambda x, t: model(x, t, jnp), jnp.asarray(x), num_steps=6,
                                     order=order, shift=3.0, use_corrector=use_corrector)
        out = unipc.unipc_sample(lambda x, t: model(x, t, torch), torch.from_numpy(x),
                                 num_steps=6, order=order, shift=3.0,
                                 use_corrector=use_corrector)
        assert_close(f"unipc order {order}", np.asarray(ref), out, 1e-5)


def _sample_both(wan_pair, solver, monkeypatch, eta=None, steps=3):
    """Both packages' ``sample_video_latents`` with CFG 5.0 and shift 3.0
    from JAX's noise; ``eta`` sets SA-Solver's in both."""
    jax_model, params, port, _ = wan_pair
    latent = SAMPLE
    rng = np.random.default_rng(10)
    text = rng.normal(size=(1, 16, 32)).astype(np.float32)
    null = rng.normal(size=text.shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    if eta is not None:
        monkeypatch.setattr(jax_video_inference, "sa_solver_sample",
                            functools.partial(jax_sa_solver.sa_solver_sample, eta=eta))
        monkeypatch.setattr(video_inference, "sa_solver_sample",
                            functools.partial(sa_solver.sa_solver_sample, eta=eta))
    ref = jax_video_inference.sample_video_latents(
        jax_model, params, jnp.asarray(text), jnp.asarray(null), latent_shape=latent,
        cfg_scale=5.0, num_steps=steps, solver=solver, flow_shift=3.0, rng=key)
    draws = iter([np.asarray(jax.random.normal(key, (1, *latent)))]
                 + [np.asarray(jax.random.normal(k, (1, *latent)))
                    for k in jax.random.split(key, steps)])
    monkeypatch.setattr(video_inference.torch, "randn",
                        lambda *a, **kw: torch.from_numpy(next(draws).copy()))
    out = video_inference.sample_video_latents(
        port, torch.from_numpy(text), torch.from_numpy(null), latent_shape=latent,
        cfg_scale=5.0, num_steps=steps, solver=solver, flow_shift=3.0)
    assert out.shape == (1, *latent) and out.dtype == torch.float32
    return np.asarray(ref), out


@pytest.mark.parametrize("solver", ["unipc", "sa-solver"])
def test_samplers_with_cfg_match_jax(wan_pair, solver, monkeypatch):
    ref, out = _sample_both(wan_pair, solver, monkeypatch)
    assert_close(f"{solver} latents", ref, out, TOL)


def test_sa_solver_with_noise_matches_jax(wan_pair, monkeypatch):
    """eta = 1 on the tiny WanModel: 4 steps with shift 3.0 put t = 0.75 and
    0.5 inside the stochastic window, so JAX's per-step draws enter."""
    ref, out = _sample_both(wan_pair, "sa-solver", monkeypatch, eta=1.0, steps=4)
    assert_close("sa-solver eta=1 latents", ref, out, TOL)


def _t5_dir(tmp_path):
    """A tiny umT5 (dim 32) in the reference's naming as a .pth, with a
    tokenizer; the same weights as JAX's converter reads them."""
    cfg = jax_t5.T5Config(vocab_size=64, dim=32, dim_attn=32, dim_ffn=48,
                          num_heads=4, num_layers=2, num_buckets=8)
    d = tmp_path / "t5"
    d.mkdir()
    save_tokenizer(d / "tokenizer")
    (d / "config.json").write_text(json.dumps(
        {k: getattr(cfg, k) for k in ("vocab_size", "dim", "dim_attn", "dim_ffn", "num_heads",
                                      "num_layers", "num_buckets")}))
    torch.save({k: torch.from_numpy(v) for k, v in t5_reference_state(cfg).items()},
               d / "umt5-xxl-enc.pth")
    return d


def _vae_pth(tmp_path):
    """A reference-named seeded state dict of the tiny VAE, as a .pth."""
    shapes = vae.reference_state_shapes(vae.WanVAE(vae.VAEConfig(**TINY_VAE)))
    rng = np.random.default_rng(12)
    state = {k: (1 + 0.1 * rng.normal(size=s) if k.endswith("gamma") else
                 rng.normal(size=s) * (0.5 * np.prod(s[1:]) ** -0.5 if len(s) > 1 else 0.02))
             .astype(np.float32) for k, s in shapes.items()}
    path = tmp_path / "Wan2.1_VAE.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    return path, state


def _cli_args(tmp_path, **extra):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a red kite over dunes\n\n  a tram at night  \n")
    args = {
        "device": "cpu", "txt_file": prompts, "out_dir": tmp_path / "out", "bf16": "false",
        "num_layers": 2, "dim": 256, "num_heads": 2, "ffn_dim": 512, "text_len": 16,
        "text_dim": 32, "linear_attn_idx": "(0,1)", "sampling.latent_shape": "(3,10,20,16)",
        "sampling.num_steps": 2, **extra,
    }
    return [f"--{k}={v}" for k, v in args.items()]


def test_video_infer_cli_end_to_end_matches_jax_pieces(tmp_path, monkeypatch, wan_pair):
    """``--t5_dir`` (a .pth and a tokenizer), ``--wan_safetensors``,
    ``--vae_ckpt`` (a .pth) and UniPC: the latents and the frames written
    agree with JAX's T5TextEncoder, converter, sampler, VAE and
    ``to_uint8_video`` on the same files and noise."""
    from safetensors.numpy import save_file

    _, params, _, state = wan_pair
    jax_model = JaxWanModel(jax_build_wan_config(
        remat=False, **{k: v for k, v in TINY.items() if k != "block_layout"}))
    save_file(state, str(tmp_path / "wan.safetensors"))
    t5_dir = _t5_dir(tmp_path)
    vae_path, vae_state = _vae_pth(tmp_path)
    monkeypatch.setattr(video_infer_cli, "VAEConfig", lambda: vae.VAEConfig(**TINY_VAE))
    written = {}
    monkeypatch.setattr(video_infer_cli, "write_mp4",
                        lambda path, frames, fps: written.setdefault(path, (frames, fps)) and path)
    sampled = []
    sample = video_infer_cli.sample_video_latents
    monkeypatch.setattr(video_infer_cli, "sample_video_latents",
                        lambda *a, **kw: sampled.append(sample(*a, **kw)) or sampled[-1])
    key = jax.random.PRNGKey(0)  # seed + the batch's first index
    noise = iter([np.asarray(jax.random.normal(key, (2, *CLI_LATENT)))])
    monkeypatch.setattr(video_inference.torch, "randn",
                        lambda *a, **kw: torch.from_numpy(next(noise).copy()))

    out = video_infer_cli.main(_cli_args(
        tmp_path, t5_dir=t5_dir, wan_safetensors=tmp_path / "wan.safetensors",
        vae_ckpt=vae_path, fps=8, batch_size=2, **{"sampling.solver": "unipc"}))

    prompts = ["a red kite over dunes", "a tram at night"]
    manifest = json.loads((tmp_path / "out" / "manifest.json").read_text())
    assert [m["prompt"] for m in manifest] == prompts and manifest == out["outputs"]
    assert [m["path"] for m in manifest] == [str(tmp_path / "out" / f"sample_{i:04d}.mp4")
                                             for i in range(2)]
    # JAX's pieces on the same inputs
    embs = jax_t5.T5TextEncoder(str(t5_dir), text_len=16)(prompts + [""])
    jvae = jax_vae.WanVAE(jax_vae.VAEConfig(**TINY_VAE))
    vae_params = jax_vae.convert_vae_checkpoint(vae_state, jax_vae.VAEConfig(**TINY_VAE))
    lat = jax_video_inference.sample_video_latents(
        jax_model, params, embs[:2], jnp.tile(embs[-1:], (2, 1, 1)), latent_shape=CLI_LATENT,
        cfg_scale=5.0, num_steps=2, solver="unipc", flow_shift=3.0, rng=key)
    assert len(sampled) == 1
    assert_close("CLI latents", np.asarray(lat), sampled[0], TOL)
    decode = jax.jit(lambda z: jvae.apply(vae_params, z, method=jax_vae.WanVAE.decode))
    for i, m in enumerate(manifest):
        video = np.asarray(decode(lat[i : i + 1]))[0]
        frames, fps = written[m["path"]]
        assert fps == 8 and frames.dtype == np.uint8 and frames.shape == (5, 20, 40, 3)
        ref_frames = jax_vbench.to_uint8_video(video)
        diff = np.abs(frames.astype(int) - ref_frames.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


def test_video_infer_cli_loads_a_wan_train_checkpoint_ema_first(tmp_path):
    """``--ckpt`` takes a ``wan_train`` work_dir: its newest checkpoint, the
    EMA weights over the raw ones."""
    cfg = build_wan_config(**{k: v for k, v in TINY.items() if k != "block_layout"})
    model = init_wan_params(WanModel(cfg), torch.Generator().manual_seed(3))
    ema = {n: p.detach() + 0.5 for n, p in model.named_parameters()}
    state = types.SimpleNamespace(model=model, step=4, ema=ema,
                                  optimizer=torch.optim.SGD(model.parameters(), lr=0.1))
    save_checkpoint(str(tmp_path / "run"), 4, state)
    out = video_infer_cli.main(_cli_args(tmp_path, ckpt=tmp_path / "run"))
    for name, p in out["model"].named_parameters():
        assert torch.equal(p, ema[name]), name
    for item in out["outputs"]:
        assert np.isfinite(np.load(item["path"])).all()


def test_video_infer_cli_runs_sa_solver_on_precomputed_embeddings(tmp_path):
    rng = np.random.default_rng(13)
    np.savez(tmp_path / "emb.npz", null=rng.normal(size=(16, 32)).astype(np.float32),
             **{f"emb_{i}": rng.normal(size=(16, 32)).astype(np.float32) for i in range(2)})
    out = video_infer_cli.main(_cli_args(tmp_path, emb_file=tmp_path / "emb.npz",
                                         **{"sampling.solver": "sa-solver"}))
    latents = [np.load(m["path"]) for m in out["outputs"]]
    assert all(lat.shape == CLI_LATENT and np.isfinite(lat).all() for lat in latents)
    assert not np.allclose(latents[0], latents[1])


def test_vbench_helpers_match_jax(tmp_path):
    frames = np.linspace(-1.2, 1.2, 2 * 3 * 4 * 3).reshape(2, 3, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(vbench.to_uint8_video(frames), jax_vbench.to_uint8_video(frames))
    (tmp_path / "p.txt").write_text("one\n\n two \n")
    assert vbench.read_prompts(tmp_path / "p.txt") == jax_vbench.read_prompts(tmp_path / "p.txt")


def test_write_mp4_names_a_missing_imageio(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError, match="imageio"):
        vbench.write_mp4(str(tmp_path / "a.mp4"), np.zeros((2, 4, 4, 3), np.uint8))


def test_export_vbench_videos_writes_one_file_per_prompt_and_seed(monkeypatch, tmp_path):
    calls = []
    fake = types.SimpleNamespace(mimwrite=lambda path, frames, fps, codec: calls.append(
        (path, len(frames), frames[0].dtype, fps, codec)))
    monkeypatch.setitem(sys.modules, "imageio", fake)
    seeds_seen = []

    def sample(prompt, gen):
        seeds_seen.append(gen.initial_seed())
        return torch.zeros(1, 2, 2, 2, 16)

    paths = vbench.export_vbench_videos(
        ["a/b kite", "tram"], sample, lambda z: torch.zeros(1, 5, 8, 8, 3), str(tmp_path),
        fps=12, seeds=(0, 3))
    assert paths == [f"{tmp_path}/a_b kite-0.mp4", f"{tmp_path}/a_b kite-3.mp4",
                     f"{tmp_path}/tram-0.mp4", f"{tmp_path}/tram-3.mp4"]
    assert seeds_seen == [0, 3, 0, 3]
    assert calls[0][1:] == (5, np.uint8, 12, "libx264")
