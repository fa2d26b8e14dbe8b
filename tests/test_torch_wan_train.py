"""The port's video training path, part one: every parameter's gradient
of the full-MHLA, hybrid and radial-sparse ``WanModel``, the flow-matching
loss, the trainer with the Wan optimizer settings against JAX's over three
steps, the step's generator and the batch streams, held against the JAX
package on the CPU at a tiny size (part two: ``test_torch_wan_train_entry.py``;
the shared pieces: ``wan_train_fixtures.py``).

Weights, latents, timesteps, noise and dropout masks come from numpy (or
from one JAX key, converted) and go to both packages. Head dim 128 takes the
fused island on both sides: the JAX side runs its Pallas bodies in interpret
mode, the port its plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.diffusion import flow_q_sample as jax_flow_q_sample
from mhla_tpu.diffusion import flow_training_loss as jax_flow_training_loss
from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu.train import trainer as jax_trainer
from mhla_tpu.train import wan_train as jax_wan_train
from mhla_tpu.train.optim8bit import auto_scale_lr as jax_auto_scale_lr
from mhla_tpu_torch.data import write_tar_shard
from mhla_tpu_torch.diffusion import flow_q_sample, flow_training_loss, logit_normal_timesteps
from mhla_tpu_torch.models import wan_params_from_jax
from mhla_tpu_torch.train import (
    OptimizerConfig,
    init_train_state,
    make_train_step,
    step_generator,
    wan_train,
)
from mhla_tpu_torch.utils import assert_close

from wan_train_fixtures import (
    _FORM_NAMES,
    _HYBRID_ARGS,
    FORMS,
    FULL,
    TOL,
    WAN_OPT,
    _batch,
    _jax_batch,
    _jax_loss,
    _models,
    _port_loss,
    _torch_batch,
    jax_value_and_grad,
)
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _force_interpret():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    yield
    mhla_chunk_pallas.FORCE_INTERPRET = False


@pytest.mark.parametrize("form", _FORM_NAMES)
def test_wan_parameter_gradients_match_jax(form):
    """The training loss and every parameter's gradient, float32."""
    kw, latent = FORMS[form]
    _, params, port = _models(kw, seed=11, latent=latent)
    batch = _batch(12, latent=latent)
    ref_loss, ref_grads = jax_value_and_grad(kw, params, batch)
    loss, _ = _port_loss(port, _torch_batch(batch))
    loss.backward()
    assert_close(f"{form} loss", np.asarray(ref_loss), loss.detach(), 1e-5)
    want = wan_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))
    names = [n for n, _ in port.named_parameters()]
    assert set(want) == set(names)
    for name, p in port.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert_close(f"{form} d {name}", want[name], p.grad, TOL)


@pytest.mark.parametrize("form", _FORM_NAMES)
def test_three_wan_trainer_steps_match_jax(form):
    """make_train_step with the Wan optimizer settings (AdamW 1e-4, wd 0.01,
    clip 0.1; warm-up cut to one step) against the JAX make_train_step on
    the same batches and draws: loss, grad norm, every parameter and its EMA
    after each step. The EMA decays by 0.9 here: at the entry point's 0.9999
    three steps move it by less than float32 resolves."""
    kw, latent = FORMS[form]
    jax_model, params, port = _models(kw, seed=19, remat=True, latent=latent)
    tx = jax_trainer.make_optimizer(jax_trainer.OptimizerConfig(**WAN_OPT))
    state = jax_trainer.init_train_state(params, tx, ema=True)
    jax_step = jax_trainer.make_train_step(_jax_loss(jax_model, jnp.float32), tx,
                                           ema_decay=0.9, donate=False)
    port_state = init_train_state(port, OptimizerConfig(**WAN_OPT), ema=True)
    port_step = make_train_step(_port_loss, ema_decay=0.9)
    start = {n: p.detach().clone() for n, p in port.named_parameters()}
    for i in range(3):
        batch = _batch(20 + i, latent=latent)
        state, ref = jax_step(state, _jax_batch(batch), jax.random.PRNGKey(i))
        port_state, got = port_step(port_state, _torch_batch(batch))
        assert_close(f"step {i} loss", np.asarray(ref["loss"]), got["loss"], 1e-5)
        assert_close(f"step {i} grad norm", np.asarray(ref["grad_norm"]), got["grad_norm"], TOL)
        assert float(got["grad_norm"]) > WAN_OPT["grad_clip"]  # the clip is active
        want = wan_params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))
        want_ema = wan_params_from_jax(jax.tree_util.tree_map(np.asarray, state.ema_params))
        for name, p in port.named_parameters():
            if i == 0:  # learning rate 0: nothing moves, exactly
                assert torch.equal(p.detach(), want[name]), name
                # d * e + (1 - d) * p with e == p: p up to one float32 rounding
                np.testing.assert_allclose(port_state.ema[name].numpy(), want_ema[name].numpy(),
                                           rtol=1e-6, atol=1e-9, err_msg=name)
                continue
            # Adam normalises each update to ~lr, so a gradient's float32 noise
            # moves its parameter by a small share of lr: compare the distance
            # travelled since the start (tests/test_torch_train.py). The
            # gradients agree to TOL, so do the distances, with room for the
            # entries whose gradient is near zero
            assert_close(f"step {i} {name}", want[name] - start[name],
                         p.detach() - start[name], 20 * TOL)
            # the EMA moves a tenth as far, too little to resolve as a distance
            # on weights near 1: compared in place
            np.testing.assert_allclose(port_state.ema[name].numpy(), want_ema[name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {i} ema {name}")
    assert port_state.step == 3 and port_state.optimizer.count == 3


def test_flow_loss_pieces_match_jax():
    """``flow_q_sample`` and ``flow_training_loss`` on the noise the JAX
    function draws from its key, with a toy velocity model; the timesteps are
    the sigmoid of the generator's normal draws."""
    rng = np.random.default_rng(17)
    x0 = rng.normal(size=(3, 2, 4, 4, 5)).astype(np.float32)
    t01 = rng.uniform(size=(3,)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, x0.shape, jnp.float32))
    ref_xt = jax_flow_q_sample(jnp.asarray(x0), jnp.asarray(t01), jnp.asarray(noise))
    xt = flow_q_sample(torch.from_numpy(x0), torch.from_numpy(t01), torch.from_numpy(noise))
    assert_close("flow_q_sample", np.asarray(ref_xt), xt, 1e-6)

    ref = jax_flow_training_loss(lambda x, t: 0.5 * x + t[:, None, None, None, None],
                                 jnp.asarray(x0), jnp.asarray(t01), key)
    toy = lambda x, t: 0.5 * x + t[:, None, None, None, None]  # noqa: E731
    out = flow_training_loss(toy, torch.from_numpy(x0), torch.from_numpy(t01),
                             noise=torch.from_numpy(noise))
    assert out["loss"].shape == (3,) and out["loss"].dtype == torch.float32
    assert_close("flow_training_loss", np.asarray(ref["loss"]), out["loss"], 1e-6)
    # the generator's form: the same draws as torch.randn from that generator
    drawn = flow_training_loss(toy, torch.from_numpy(x0), torch.from_numpy(t01),
                               torch.Generator().manual_seed(3))
    same = torch.randn(x0.shape, generator=torch.Generator().manual_seed(3))
    again = flow_training_loss(toy, torch.from_numpy(x0), torch.from_numpy(t01), noise=same)
    assert torch.equal(drawn["loss"], again["loss"])

    t = logit_normal_timesteps(1000, 0.5, 2.0, torch.Generator().manual_seed(4))
    u = torch.randn(1000, generator=torch.Generator().manual_seed(4))
    assert torch.equal(t, torch.sigmoid(u * 2.0 + 0.5)) and 0 < t.min() and t.max() < 1


def test_train_step_hands_the_loss_a_generator_of_the_step():
    """With a seed the loss gets ``step_generator(seed, state.step)``: a
    function of the two numbers, so a resumed run draws what an unbroken one
    would; other steps and other seeds draw other numbers."""
    _, _, port = _models(FULL, seed=21)
    state = init_train_state(port, OptimizerConfig(**WAN_OPT))
    draws = []

    def loss_fn(model, batch, generator):
        draws.append(torch.rand(4, generator=generator))
        return _port_loss(model, batch)

    step = make_train_step(loss_fn, seed=7)
    batch = _torch_batch(_batch(22))
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    for i in (0, 1):
        assert torch.equal(draws[i], torch.rand(4, generator=step_generator(7, i, "cpu")))
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], torch.rand(4, generator=step_generator(8, 0, "cpu")))


def test_synthetic_video_batches_equal_jax():
    cfg = wan_train.WanTrainConfig()
    cfg.data = wan_train.WanDataCfg(latent_frames=2, latent_height=4, latent_width=6,
                                    latent_dim=3, text_len=5, text_dim=7)
    cfg.train.batch_size = 2
    jax_cfg = jax_wan_train.WanTrainConfig()
    jax_cfg.data = jax_wan_train.WanDataCfg(**dataclasses.asdict(cfg.data))
    jax_cfg.train.batch_size = 2
    ours = wan_train.video_batches(cfg, np.random.default_rng(3))
    ref = jax_wan_train.video_batches(jax_cfg, np.random.default_rng(3))
    for _ in range(3):
        (z, c), (zr, cr) = next(ours), next(ref)
        assert z.shape == (2, 2, 4, 6, 3) and c.shape == (2, 5, 7) and z.dtype == np.float32
        np.testing.assert_array_equal(z, zr)
        np.testing.assert_array_equal(c, cr)


def test_cached_latent_batches(tmp_path):
    """The ``*.npz`` directory branch: files in sorted order, batches of two,
    the odd file out dropped, then around again."""
    cfg = wan_train.WanTrainConfig()
    cfg.data.latent_dir = str(tmp_path)
    cfg.train.batch_size = 2
    for i in range(5):
        np.savez(tmp_path / f"clip_{i}.npz", latent=np.full((2, 4, 4, 3), i, np.float64),
                 text_emb=np.full((5, 7), 10 + i, np.float64))
    data = wan_train.video_batches(cfg, np.random.default_rng(0))
    firsts = []
    for _ in range(3):
        z, c = next(data)
        assert z.shape == (2, 2, 4, 4, 3) and c.shape == (2, 5, 7) and z.dtype == np.float32
        firsts.append((z[:, 0, 0, 0, 0].tolist(), c[:, 0, 0].tolist()))
    assert firsts == [([0, 1], [10, 11]), ([2, 3], [12, 13]), ([0, 1], [10, 11])]
    # a tar shard in the directory takes precedence over the npz files
    write_tar_shard(str(tmp_path / "shard.tar"), [
        {"__key__": f"clip_{i}", "latent.npy": np.full((2, 4, 4, 3), 20 + i, np.float32),
         "text_emb.npy": np.full((5, 7), 30 + i, np.float32)} for i in range(2)])
    z, c = next(wan_train.video_batches(cfg, np.random.default_rng(0)))
    assert z[:, 0, 0, 0, 0].tolist() == [20, 21] and c[:, 0, 0].tolist() == [30, 31]


def test_auto_scale_lr_reaches_the_optimizer(tmp_path, monkeypatch):
    """``auto_scale_lr_base_batch`` scales the learning rate by batch x
    accumulation over the base batch before the run is built, as the JAX
    entry point does; the config written to the work dir holds the result."""
    for fn in (wan_train.auto_scale_lr, jax_auto_scale_lr):  # tests/test_optim8bit.py's cases
        assert fn(1e-4, 512) == pytest.approx(2e-4)
        assert fn(1e-4, 256) == pytest.approx(1e-4)
        assert fn(2e-5, 64, base_batch_size=32) == pytest.approx(4e-5)
    seen = {}
    real = wan_train.build_training

    def spy(cfg):
        seen["lr"] = cfg.optimizer.learning_rate
        return real(cfg)

    monkeypatch.setattr(wan_train, "build_training", spy)
    wan_train.main(_HYBRID_ARGS + [
        f"--work_dir={tmp_path}/wan", "--train.max_steps=1", "--train.batch_size=2",
        "--optimizer.accum_steps=3", "--optimizer.learning_rate=1e-3",
        "--auto_scale_lr_base_batch=4"])
    assert seen["lr"] == pytest.approx(1e-3 * 6 / 4)
    assert "0.0015" in (tmp_path / "wan" / "config.yaml").read_text()

