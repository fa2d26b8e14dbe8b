"""The port's image harnesses against the JAX package on the CPU at a tiny
size: Gaussian diffusion (schedules, respacing, ``q_sample``, the losses
with the VB term, both sample loops), the DiT loss and CFG sampling, the ViT
loss with mixup / cutmix, the data streams, the trainers ``dit_train`` and
``vit_train`` (mirrors of ``tests/test_harnesses.py``), the FID npz and its
CLI, and the configs read without PyYAML.

Where a JAX function draws from a key, the test makes the same draws with
JAX and hands them to the port.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.diffusion import create_diffusion as jax_create_diffusion
from mhla_tpu.diffusion import make_beta_schedule as jax_make_beta_schedule
from mhla_tpu.diffusion import space_timesteps as jax_space_timesteps
from mhla_tpu.eval.fid import latents_to_uint8 as jax_latents_to_uint8
from mhla_tpu.models.dit import DiT as JaxDiT
from mhla_tpu.models.dit import DiTConfig as JaxDiTConfig
from mhla_tpu.train import dit_train as jax_dit_train
from mhla_tpu.train import vit_train as jax_vit_train
from mhla_tpu_torch.data import image_data
from mhla_tpu_torch.diffusion import (
    GaussianDiffusion,
    create_diffusion,
    make_beta_schedule,
    space_timesteps,
)
from mhla_tpu_torch.eval import fid_cli
from mhla_tpu_torch.eval.fid import build_sample_npz, latents_to_uint8
from mhla_tpu_torch.models import DiT, DiTConfig, MHLAViT, ViTConfig, dit_params_from_jax
from mhla_tpu_torch.models import init_vit_params, vit_params_from_jax
from mhla_tpu_torch.train import OptimizerConfig, dit_train, init_train_state, make_train_step
from mhla_tpu_torch.train import vit_train
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.config import read_simple_yaml

from test_torch_vision import DIT, VIT, check_outputs_and_grads, pair, to_jax
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

TOL = 1e-5


def _jax_loop_draws(key, shape, n):
    """The start and per-step noises the JAX sample loops draw from ``key``."""
    key, init = jax.random.split(key)
    x = np.asarray(jax.random.normal(init, shape, jnp.float32))
    steps = [np.asarray(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(key, n)]
    return torch.from_numpy(x), [torch.from_numpy(z) for z in steps]


# ---- Gaussian diffusion -----------------------------------------------


@pytest.mark.parametrize("schedule", ["linear", "squaredcos_cap_v2"])
def test_schedules_tables_and_respacing_match_jax(schedule):
    np.testing.assert_array_equal(make_beta_schedule(schedule, 1000),
                                  jax_make_beta_schedule(schedule, 1000))
    for total, count in ((1000, 250), (1000, 4), (100, 7)):
        np.testing.assert_array_equal(space_timesteps(total, count),
                                      jax_space_timesteps(total, count))
    ours, t_map = create_diffusion("25", noise_schedule=schedule)
    ref, ref_map = jax_create_diffusion("25", noise_schedule=schedule)
    np.testing.assert_array_equal(t_map, ref_map)
    for sub, ref_sub in ((ours, ref), (ours._respaced(t_map), ref._respaced(ref_map))):
        tables = sub._np()
        for name, table in ref_sub._np().items():
            np.testing.assert_array_equal(tables[name], table, err_msg=name)


def test_q_sample_matches_jax():
    rng = np.random.default_rng(0)
    x0, noise = (rng.normal(size=(4, 8, 8, 3)).astype(np.float32) for _ in range(2))
    t = np.array([0, 10, 500, 999])
    ref_diff, _ = jax_create_diffusion(None)
    diff, _ = create_diffusion(None)
    ref = ref_diff.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    out = diff.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))
    assert_close("q_sample", np.asarray(ref), out, TOL)


def _toy_model(c):
    """A smooth deterministic model of (x_t, t) with 2c output channels."""

    def jax_fn(x, t):
        s = jnp.sin(x + t[:, None, None, None] * 1e-3)
        return jnp.concatenate([0.7 * s, jnp.tanh(x[..., :c] - 0.2)], -1)

    def torch_fn(x, t):
        s = torch.sin(x + t[:, None, None, None] * 1e-3)
        return torch.cat([0.7 * s, torch.tanh(x[..., :c] - 0.2)], -1)

    return jax_fn, torch_fn


@pytest.mark.parametrize("learn_sigma,mean_type", [(True, "epsilon"), (False, "epsilon"),
                                                   (True, "x_start"), (False, "velocity")])
def test_training_losses_match_jax(learn_sigma, mean_type):
    """The MSE and, with a learned range, the VB term at t = 0 (the KL there,
    as the JAX function computes it), small and large t, on the noise JAX
    draws from its key."""
    c = 3
    rng = np.random.default_rng(1)
    x0 = (rng.normal(size=(4, 6, 6, c)) * 0.6).astype(np.float32)
    t = np.array([0, 3, 400, 999])
    key = jax.random.PRNGKey(2)
    noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    jfn, tfn = _toy_model(c)
    if not learn_sigma:
        jfn_, tfn_ = jfn, tfn
        jfn, tfn = (lambda x, tt: jfn_(x, tt)[..., :c]), (lambda x, tt: tfn_(x, tt)[..., :c])
    ref_diff, _ = jax_create_diffusion(None, learn_sigma=learn_sigma, mean_type=mean_type)
    diff, _ = create_diffusion(None, learn_sigma=learn_sigma, mean_type=mean_type)
    ref = ref_diff.training_losses(jfn, jnp.asarray(x0), jnp.asarray(t), key)
    out = diff.training_losses(tfn, torch.from_numpy(x0), torch.from_numpy(t),
                               noise=torch.from_numpy(noise))
    assert set(out) == set(ref)
    for name in ref:
        assert out[name].dtype == torch.float32
        assert_close(f"{name}", np.asarray(ref[name]), out[name], TOL)


def test_training_losses_perfect_eps_and_generator():
    """tests/test_vision_models.py::TestDiffusion::test_training_losses_epsilon
    on the port; the generator's form draws what torch.randn does."""
    diff, _ = create_diffusion(None, learn_sigma=True)
    x0 = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([10, 500])
    losses = diff.training_losses(lambda x_t, tt: torch.cat([noise, torch.zeros_like(noise)], -1),
                                  x0, t, torch.Generator().manual_seed(1))
    assert float(losses["mse"].max()) < 1e-8
    x_t = diff.q_sample(x0, t, noise)
    assert float(x_t[0].std()) > 0


def test_q_sample_interpolates_and_respacing():
    """TestDiffusion's q_sample and respacing cases on the port."""
    diff, _ = create_diffusion(None, learn_sigma=False)
    x0 = torch.ones(2, 4, 4, 3)
    x_t = diff.q_sample(x0, torch.tensor([0, 999]), torch.zeros_like(x0))
    assert float(x_t[0].mean()) == pytest.approx(1.0, abs=1e-2)
    assert abs(float(x_t[1].mean())) < 0.25
    t_map = space_timesteps(1000, 250)
    assert len(t_map) == 250 and t_map[0] == 0


@pytest.mark.parametrize("learn_sigma", [True, False])
def test_p_sample_loop_matches_jax(learn_sigma):
    """Four respaced ancestral steps on the noises JAX draws from its key."""
    c, shape = 3, (2, 6, 6, 3)
    jfn, tfn = _toy_model(c)
    if not learn_sigma:
        jfn_, tfn_ = jfn, tfn
        jfn, tfn = (lambda x, tt: jfn_(x, tt)[..., :c]), (lambda x, tt: tfn_(x, tt)[..., :c])
    ref_diff, t_map = jax_create_diffusion("4", learn_sigma=learn_sigma)
    diff, _ = create_diffusion("4", learn_sigma=learn_sigma)
    key = jax.random.PRNGKey(3)
    ref = ref_diff.p_sample_loop(jfn, shape, key, timestep_map=t_map)
    x, steps = _jax_loop_draws(key, shape, len(t_map))
    out = diff.p_sample_loop(tfn, shape, timestep_map=t_map, noise=x, step_noises=steps)
    assert out.shape == shape and torch.isfinite(out).all()
    assert_close("p_sample_loop", np.asarray(ref), out, TOL)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_matches_jax(eta):
    c, shape = 3, (2, 6, 6, 3)
    jfn, tfn = _toy_model(c)
    ref_diff, t_map = jax_create_diffusion("5", learn_sigma=True)
    diff, _ = create_diffusion("5", learn_sigma=True)
    key = jax.random.PRNGKey(4)
    ref = ref_diff.ddim_sample_loop(jfn, shape, key, timestep_map=t_map, eta=eta)
    x, steps = _jax_loop_draws(key, shape, len(t_map))
    out = diff.ddim_sample_loop(tfn, shape, timestep_map=t_map, eta=eta, noise=x,
                                step_noises=steps)
    assert_close(f"ddim eta={eta}", np.asarray(ref), out, TOL)


def test_sample_loops_from_a_generator_are_deterministic():
    """TestDiffusion's p_sample_loop and ddim cases on the port: finite, and
    the same generator seed gives the same latents."""
    diff, t_map = create_diffusion("4", learn_sigma=True)

    def zeros(x, t):
        return torch.zeros(*x.shape[:-1], 2 * x.shape[-1])

    out = diff.p_sample_loop(zeros, (1, 8, 8, 3), torch.Generator().manual_seed(0),
                             timestep_map=t_map)
    assert out.shape == (1, 8, 8, 3) and torch.isfinite(out).all()
    plain, t_map = create_diffusion("4", learn_sigma=False)
    o1, o2 = (plain.ddim_sample_loop(lambda x, t: 0.1 * x, (1, 8, 8, 3),
                                     torch.Generator().manual_seed(5), timestep_map=t_map)
              for _ in range(2))
    assert torch.equal(o1, o2)
    assert isinstance(plain._respaced(t_map), GaussianDiffusion)


# ---- DiT: loss, sampling, trainer, FID -----------------------------------


def _dit(seed=21):
    jax_model = JaxDiT(JaxDiTConfig(**DIT))
    model = DiT(DiTConfig(**DIT))
    rngs = {"params": jax.random.PRNGKey(0), "label_dropout": jax.random.PRNGKey(1)}
    params = pair(jax_model, (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1,), jnp.int32)), model, dit_params_from_jax, seed,
                  rngs)
    return jax_model, model, params


def test_dit_training_loss_and_gradients_match_jax():
    """``dit_train``'s loss (epsilon MSE + VB) at fixed timesteps, noise and
    label dropout: the loss and every parameter's gradient, float32."""
    jax_model, model, params = _dit()
    rng = np.random.default_rng(22)
    x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    y, t = np.array([1, 5, 9]), np.array([0, 37, 880])
    drop = np.array([False, True, False])
    key = jax.random.PRNGKey(23)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    diff, ref_diff = create_diffusion(None)[0], jax_create_diffusion(None)[0]

    def jax_loss(p, xs):
        def model_fn(x_t, tt):
            return jax_model.apply(p, x_t, tt, jnp.asarray(y), train=True,
                                   force_drop=jnp.asarray(drop))

        return ref_diff.training_losses(model_fn, xs, jnp.asarray(t), key)["loss"].mean()[None]

    def port_loss(xs):
        loss, _ = dit_train.dit_loss(model, diff, xs, torch.from_numpy(y), torch.from_numpy(t),
                                     noise=torch.from_numpy(noise),
                                     force_drop=torch.from_numpy(drop))
        return loss[None]

    check_outputs_and_grads("DiT loss", jax_loss, params, model, port_loss, [x],
                            bridge=dit_params_from_jax)


def test_dit_cfg_sampling_matches_jax():
    """``dit_train.sample``: the doubled batch with null labels, the
    respaced ancestral loop, guided eps; on JAX's draws."""
    jax_model, model, params = _dit(seed=24)
    labels = np.array([3, 8])
    key = jax.random.PRNGKey(25)
    ref = jax_dit_train.sample(jax_model, to_jax(params), jnp.asarray(labels), cfg_scale=4.0,
                               num_steps="4", rng=key)
    _, t_map = create_diffusion("4")
    x, steps = _jax_loop_draws(key, (4, 8, 8, 4), len(t_map))
    out = dit_train.sample(model, torch.from_numpy(labels), cfg_scale=4.0, num_steps="4",
                           noise=x, step_noises=steps)
    assert out.shape == (2, 8, 8, 4)
    assert_close("DiT CFG sample", np.asarray(ref), out, TOL)


_DIT_ARGS = [
    "--device=cpu", "--model_name=DiT-S/2", "--depth=2", "--hidden_size=64", "--num_heads=2",
    "--input_size=8", "--block_size=4", "--num_classes=10", "--bf16=false",
    "--train.batch_size=4", "--train.log_interval=1", "--train.save_interval=100",
    "--optimizer.total_steps=3",
]


def test_dit_train_few_steps_sample_and_fid_cli(tmp_path):
    """tests/test_harnesses.py::TestDiTTrain on the port: three steps (the
    trainable mixing clamped to [0, 1] after each), CFG sampling, and the
    FID CLI on the run's checkpoint writing the latent-space npz."""
    out = dit_train.main(_DIT_ARGS + [f"--work_dir={tmp_path}/dit", "--train.max_steps=3",
                                      "--optimizer.learning_rate=0.5"])
    assert math.isfinite(out["final_loss"]) and len(out["losses"]) == 3
    model = out["model"]
    mix = [p.detach() for n, p in model.named_parameters() if n.endswith("piece_attn.weight")]
    assert len(mix) == 2 and all(0.0 <= float(p.min()) and float(p.max()) <= 1.0 for p in mix)
    assert any(float(p.min()) == 0.0 for p in mix)  # lr 0.5 drove weights onto the clamp
    imgs = dit_train.sample(model, torch.tensor([1, 2]), num_steps="4",
                            generator=torch.Generator().manual_seed(0))
    assert imgs.shape == (2, 8, 8, 4) and torch.isfinite(imgs).all()
    res = fid_cli.main(["--device=cpu", f"--ckpt={tmp_path}/dit", "--depth=2",
                        "--hidden_size=64", "--num_heads=2", "--input_size=8", "--block_size=4",
                        "--num_classes=10", "--num_samples=5", "--batch_size=4",
                        "--num_sampling_steps=3", f"--out={tmp_path}/fid/samples.npz"])
    arr = np.load(res["npz"])["arr_0"]
    assert arr.shape == (5, 8, 8, 4) and arr.dtype == np.uint8
    manifest = json.loads((tmp_path / "fid" / "fid_manifest.json").read_text())
    assert manifest["num_samples"] == 5 and manifest["decoded"] is False
    with pytest.raises(NotImplementedError):
        fid_cli.main(["--device=cpu", "--vae_ckpt=vae.pt", f"--out={tmp_path}/x.npz"])


def test_dit_train_finetunes_from_a_standard_checkpoint(tmp_path):
    from test_torch_vision import _standard_dit_state

    cfg = dict(DIT, hidden_size=64)
    state = _standard_dit_state(cfg, np.random.default_rng(3))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}},
               tmp_path / "dit.pt")
    out = dit_train.main(_DIT_ARGS + [f"--work_dir={tmp_path}/ft", "--train.max_steps=0",
                                      f"--train.finetune_from={tmp_path}/dit.pt"])
    model = out["model"]
    assert torch.equal(model.blocks[1].attn.to_qkv.weight,
                       torch.from_numpy(state["blocks.1.attn.qkv.weight"]))
    assert torch.equal(model.final_linear.weight, torch.from_numpy(state["final_layer.linear.weight"]))


def test_latents_to_uint8_and_npz_builder(tmp_path):
    x = np.linspace(-1.3, 1.3, 2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    np.testing.assert_array_equal(latents_to_uint8(x), jax_latents_to_uint8(x))
    calls = []

    def sample_fn(labels, generator):
        calls.append(labels.clone())
        return torch.rand(labels.shape[0], 4, 4, 3, generator=generator) * 2 - 1

    path = build_sample_npz(sample_fn, 7, 3, 10, str(tmp_path / "s.npz"),
                            torch.Generator().manual_seed(0))
    arr = np.load(path)["arr_0"]
    assert arr.shape == (7, 4, 4, 3) and arr.dtype == np.uint8 and len(calls) == 3
    assert all(c.shape == (3,) and int(c.max()) < 10 for c in calls)


# ---- ViT: loss with mixup / cutmix, trainer ------------------------------


def _jax_mix_draws(key, h, w, mixup_alpha=0.8, cutmix_alpha=1.0):
    """The draws of JAX's ``mixup_cutmix`` for ``key``."""
    r_kind, r_lam, r_box = jax.random.split(key, 3)
    return vit_train.MixDraws(
        cutmix=bool(jax.random.bernoulli(r_kind)),
        lam_mix=float(jax.random.beta(r_lam, mixup_alpha, mixup_alpha)),
        lam_cut=float(jax.random.beta(r_lam, cutmix_alpha, cutmix_alpha)),
        cy=int(jax.random.randint(r_box, (), 0, h)),
        cx=int(jax.random.randint(jax.random.fold_in(r_box, 1), (), 0, w)),
    )


def _keys_of_both_kinds(h=16, w=16):
    kinds = {}
    for i in range(20):
        draws = _jax_mix_draws(jax.random.PRNGKey(i), h, w)
        kinds.setdefault(draws.cutmix, i)
    return [kinds[False], kinds[True]]


@pytest.mark.parametrize("kind", ["mixup", "cutmix"])
def test_mixup_cutmix_matches_jax_on_its_draws(kind):
    key = jax.random.PRNGKey(_keys_of_both_kinds()[kind == "cutmix"])
    rng = np.random.default_rng(30)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[[0, 1, 2, 3]]
    ref_x, ref_y = jax_vit_train.mixup_cutmix(key, jnp.asarray(x), jnp.asarray(y), 0.8, 1.0)
    draws = _jax_mix_draws(key, 16, 16)
    assert draws.cutmix == (kind == "cutmix")
    out_x, out_y = vit_train.mixup_cutmix(torch.from_numpy(x), torch.from_numpy(y), draws)
    assert_close(f"{kind} images", np.asarray(ref_x), out_x, 1e-6)
    assert_close(f"{kind} targets", np.asarray(ref_y), out_y, 1e-6)
    np.testing.assert_allclose(out_y.sum(-1).numpy(), 1.0, rtol=1e-5)  # the target mass


def test_mix_draws_come_from_the_generator():
    """Draws of one seed repeat; Beta(0.8, 0.8) by Johnk's method has the
    right mean and variance; both kinds occur."""
    a = vit_train.draw_mix(16, 16, 0.8, 1.0, torch.Generator().manual_seed(1))
    b = vit_train.draw_mix(16, 16, 0.8, 1.0, torch.Generator().manual_seed(1))
    assert a == b and 0 <= a.cy < 16 and 0 <= a.cx < 16
    gen = torch.Generator().manual_seed(2)
    lam = np.array([vit_train.sample_beta(0.8, 0.8, gen) for _ in range(3000)])
    assert abs(lam.mean() - 0.5) < 0.02 and abs(lam.var() - 0.64 / (2.56 * 2.6)) < 0.01
    kinds = {vit_train.draw_mix(8, 8, 0.8, 1.0, gen).cutmix for _ in range(40)}
    assert kinds == {False, True}


@pytest.mark.parametrize("kind", ["mixup", "cutmix"])
def test_vit_loss_and_gradients_match_jax(kind):
    """``vit_train``'s loss (label smoothing 0.1, mixup or cutmix, the
    soft-target cross entropy) and every gradient, float32."""
    cfg = dict(VIT, img_size=16, patch_size=4)
    from mhla_tpu.models.vit import MHLAViT as JaxMHLAViT
    from mhla_tpu.models.vit import ViTConfig as JaxViTConfig

    jax_model, model = JaxMHLAViT(JaxViTConfig(**cfg)), MHLAViT(ViTConfig(**cfg))
    params = pair(jax_model, (jnp.zeros((1, 16, 16, 3)),), model, vit_params_from_jax, 31)
    key = jax.random.PRNGKey(_keys_of_both_kinds()[kind == "cutmix"])
    rng = np.random.default_rng(32)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = np.array([1, 4, 9, 0])
    nc, sm = 10, 0.1

    def jax_loss(p, xs):
        onehot = jax.nn.one_hot(jnp.asarray(y), nc) * (1 - sm) + sm / nc
        xs, onehot = jax_vit_train.mixup_cutmix(key, xs, onehot, 0.8, 1.0)
        return jax_vit_train.soft_target_xent(jax_model.apply(p, xs), onehot)[None]

    loss_fn = vit_train.make_loss_fn(vit_train.ViTTrainConfig(num_classes=nc))
    draws = _jax_mix_draws(key, 16, 16)
    check_outputs_and_grads(f"ViT loss {kind}", jax_loss, params, model,
                            lambda xs: loss_fn(model, (xs, torch.from_numpy(y), draws))[0][None],
                            [x])


_VIT_ARGS = [
    "--device=cpu", "--model_name=deit_tiny_mhla", "--img_size=32", "--piece_size=2",
    "--num_classes=10", "--bf16=false", "--train.batch_size=8", "--train.save_interval=100",
    "--optimizer.warmup_steps=1",
]


def test_vit_train_few_steps_and_in_training_validation(tmp_path):
    """tests/test_harnesses.py::TestViTTrain on the port: steps with mixup /
    cutmix, the held-out top-1 of the live and the EMA weights, resume."""
    out = vit_train.main(_VIT_ARGS + [f"--work_dir={tmp_path}/vit", "--train.max_steps=4",
                                      "--train.log_interval=2", "--train.eval_interval=2",
                                      "--train.eval_batches=2", "--optimizer.total_steps=4"])
    assert math.isfinite(out["final_loss"]) and len(out["losses"]) == 4
    assert 0.0 <= out["val_acc"] <= 1.0 and 0.0 <= out["val_acc_ema"] <= 1.0
    more = vit_train.main(_VIT_ARGS + [f"--work_dir={tmp_path}/vit", "--train.max_steps=5",
                                       "--optimizer.total_steps=5"])
    assert len(more["losses"]) == 1  # resumed at step 4 from `latest`


def test_synthetic_streams_equal_jax():
    vcfg, jvcfg = vit_train.ViTTrainConfig(img_size=16), jax_vit_train.ViTTrainConfig(img_size=16)
    for c in (vcfg, jvcfg):
        c.train.batch_size, c.num_classes = 3, 10
    ours = vit_train.image_batches(vcfg, np.random.default_rng(4))
    ref = jax_vit_train.image_batches(jvcfg, np.random.default_rng(4))
    for _ in range(2):
        for a, b in zip(next(ours), next(ref)):
            np.testing.assert_array_equal(a, b)
    for (a, b), (c, d) in zip(vit_train.val_batches(vcfg, 2), jax_vit_train.val_batches(jvcfg, 2)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    dcfg, jdcfg = dit_train.DiTTrainConfig(input_size=8), jax_dit_train.DiTTrainConfig(input_size=8)
    for c in (dcfg, jdcfg):
        c.train.batch_size = 3
    ours = dit_train.latent_batches(dcfg, np.random.default_rng(5))
    ref = jax_dit_train.latent_batches(jdcfg, np.random.default_rng(5))
    for a, b in zip(next(ours), next(ref)):
        np.testing.assert_array_equal(a, b)


def test_image_datasets_read_files_as_jax(tmp_path):
    """The port's copy of the image data module reads a latent directory and
    an image folder (PIL) into the batches JAX's does."""
    from mhla_tpu.data import image_data as jax_image_data

    rng = np.random.default_rng(6)
    for sub in ("imagenet256_features", "imagenet256_labels"):
        (tmp_path / "lat" / sub).mkdir(parents=True)
    for i in range(4):
        np.save(tmp_path / "lat" / "imagenet256_features" / f"{i}.npy",
                rng.normal(size=(2, 4, 8, 8)).astype(np.float32))
        np.save(tmp_path / "lat" / "imagenet256_labels" / f"{i}.npy", np.array([i]))
    a = next(image_data.LatentDataset(str(tmp_path / "lat"), seed=1).infinite(2))
    b = next(jax_image_data.LatentDataset(str(tmp_path / "lat"), seed=1).infinite(2))
    assert a[0].shape == (2, 8, 8, 4)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    Image = pytest.importorskip("PIL.Image")
    for cls in ("cat", "dog"):
        (tmp_path / "img" / cls).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(
                tmp_path / "img" / cls / f"{i}.png")
    for train in (True, False):
        aug = dict(img_size=16, train=train)
        ours = image_data.ImageFolderDataset(str(tmp_path / "img"),
                                             image_data.ImageAugConfig(**aug), seed=2)
        ref = jax_image_data.ImageFolderDataset(str(tmp_path / "img"),
                                                jax_image_data.ImageAugConfig(**aug), seed=2)
        for u, v in zip(next(ours.batches(2)), next(ref.batches(2))):
            np.testing.assert_array_equal(u, v)


def test_vit_learns_separable_task():
    """tests/test_harnesses.py::TestConvergence::test_vit_learns_separable_task
    on the port: a tiny ViT and the trainer fit a separable task well above
    chance within 60 steps."""
    cfg = ViTConfig(img_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=2,
                    piece_size=2, num_classes=4)
    model = init_vit_params(MHLAViT(cfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)

    def batch():
        y = rng.integers(0, 4, 32)
        x = rng.standard_normal((32, 16, 16, 3), np.float32) * 0.1
        for j, cls in enumerate(y):  # a class-dependent mean in one quadrant
            x[j, (cls // 2) * 8:(cls // 2) * 8 + 8, (cls % 2) * 8:(cls % 2) * 2 + 8, 0] += 2.0
        return torch.from_numpy(x), torch.from_numpy(y)

    def loss_fn(model, b):
        x, y = b
        logits = model(x)
        acc = (logits.argmax(-1) == y).float().mean()
        return vit_train.soft_target_xent(logits, torch.nn.functional.one_hot(y, 4).float()), \
            {"acc": acc}

    state = init_train_state(model, OptimizerConfig(learning_rate=3e-3, warmup_steps=5,
                                                    total_steps=60, grad_clip=1.0))
    step = make_train_step(loss_fn)
    accs = []
    for _ in range(60):
        state, m = step(state, batch())
        accs.append(float(m["acc"]))
    assert np.mean(accs[-10:]) > 0.6, f"did not learn: {accs[-10:]}"


# ---- configs -------------------------------------------------------------


@pytest.mark.parametrize("name", ["deit_small_mhla", "dit_s2", "mhla_340m", "wan_1300m_mhla",
                                  "wan_1300m_hybrid_mhla"])
def test_configs_read_without_pyyaml_as_with_it(name):
    yaml = pytest.importorskip("yaml")
    text = open(f"configs/{name}.yaml").read()
    assert read_simple_yaml(text) == yaml.safe_load(text)


def test_simple_yaml_reads_its_subset():
    """Comments outside quotes only, ``key:`` with nothing below is null,
    flow lists of scalars, and ``1e-4`` a float (PyYAML: a string)."""
    text = ('a: "x # y"  # c\nb: it\'s # c\nc:\n  d:\n  e: [1, 2.5, x, null]\n'
            "f: 'it''s'\ng: 1e-4\nh: ~\ni: http://x\n")
    assert read_simple_yaml(text) == {"a": "x # y", "b": "it's", "c": {"d": None,
                                      "e": [1, 2.5, "x", None]}, "f": "it's", "g": 1e-4,
                                      "h": None, "i": "http://x"}


@pytest.mark.parametrize("text", [
    "- a", "a:\n  - 1", "---\na: 1", "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x",
    "a: {b: 1}", "a: 1\na: 2", "'a': 1", "a:\n  b: 1\n c: 2", "a: b\n  c", "a: yes",
    "a: 0x10", "a: 1.0.0", "a: b: c", "a: [[1]]", "a: [1, , 2]", "a:b", "\ta: 1", "a: 'x",
])
def test_simple_yaml_raises_outside_its_subset(text):
    with pytest.raises(ValueError, match="outside the YAML subset"):
        read_simple_yaml(text)


def test_entry_points_run_the_shipped_configs_at_tiny_overrides(tmp_path):
    """``configs/deit_small_mhla.yaml`` and ``configs/dit_s2.yaml`` through
    the entry points on the CPU."""
    vit = vit_train.main(["configs/deit_small_mhla.yaml", "--device=cpu",
                          "--model_name=deit_tiny_mhla", "--img_size=32", "--piece_size=2",
                          "--num_classes=10", "--train.batch_size=4", "--train.max_steps=1",
                          f"--work_dir={tmp_path}/vit"])
    assert math.isfinite(vit["final_loss"])
    assert vit["model"].cfg.dtype == torch.bfloat16  # the config's bf16: true
    dit = dit_train.main(["configs/dit_s2.yaml", "--device=cpu", "--depth=1", "--input_size=8",
                          "--block_size=4", "--train.batch_size=2", "--train.max_steps=1",
                          f"--work_dir={tmp_path}/dit"])
    assert math.isfinite(dit["final_loss"]) and dit["model"].cfg.hidden_size == 384
    assert (tmp_path / "dit" / "config.yaml").exists()
