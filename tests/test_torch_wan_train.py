"""The port's video training path (``WanModel`` gradients with and without
remat, the flow-matching loss, the trainer with the Wan optimizer settings
and the ``wan_train`` entry point), held against the JAX package on the CPU
at a tiny size.

Weights, latents, timesteps, noise and dropout masks come from numpy (or
from one JAX key, converted) and go to both packages. Head dim 128 takes the
fused island on both sides: the JAX side runs its Pallas bodies in interpret
mode, the port its plain versions.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.diffusion import flow_q_sample as jax_flow_q_sample
from mhla_tpu.diffusion import flow_training_loss as jax_flow_training_loss
from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu.models.wan import WanModel as JaxWanModel
from mhla_tpu.models.wan import build_wan_config as jax_build_wan_config
from mhla_tpu.train import trainer as jax_trainer
from mhla_tpu.train import wan_train as jax_wan_train
from mhla_tpu.train.optim8bit import auto_scale_lr as jax_auto_scale_lr
from mhla_tpu_torch.diffusion import flow_q_sample, flow_training_loss, logit_normal_timesteps
from mhla_tpu_torch.models import WanModel, build_wan_config, wan_params_from_jax
from mhla_tpu_torch.train import (
    OptimizerConfig,
    init_train_state,
    make_train_step,
    step_generator,
    wan_train,
)
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.checkpoint import resolve_resume_path

from test_torch_wan import TINY, _random_params, _to_jax

LATENT = (2, 8, 12, 16)  # patch (1, 2, 2) -> grid (2, 4, 6): nothing for grid_adjust to crop
# float32 gradients through 2 or 3 blocks (XLA vs ATen GEMMs, other summation orders)
TOL = 1e-4
FULL = dict(TINY)  # 2 layers, both MHLA
HYBRID = dict(TINY, num_layers=3, linear_attn_idx=(1, 2))  # layer 0 dense softmax
# layers: radial-sparse softmax, MHLA, dense softmax; no dense guard, as the
# video trainer builds the model. 4 frames of 24 tokens (grid (4, 4, 6)), so
# that frame distances 2 and 3 are banded: with 2 frames the mask keeps all
SPARSE = dict(TINY, num_layers=3, linear_attn_idx=(1,), sparse_attn_idx=(0,),
              sparse_dense_from_t=None)
SPARSE_LATENT = (4, 8, 12, 16)
FORMS = {"full": (FULL, LATENT), "hybrid": (HYBRID, LATENT), "sparse": (SPARSE, SPARSE_LATENT)}
_FORM_NAMES = list(FORMS)
WAN_OPT = dict(learning_rate=1e-4, weight_decay=0.01, grad_clip=0.1, warmup_steps=1,
               total_steps=10, optimizer="adamw")


@pytest.fixture(autouse=True)
def _force_interpret():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    yield
    mhla_chunk_pallas.FORCE_INTERPRET = False


def _models(kw, seed, jax_dtype=jnp.float32, torch_dtype=torch.float32, remat=False,
            latent=LATENT):
    jax_model = JaxWanModel(jax_build_wan_config(remat=False, dtype=jax_dtype, **kw))
    shapes = jax.eval_shape(
        lambda: jax_model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, *latent)), jnp.zeros((1,)),
            jnp.zeros((1, kw["text_len"], kw["text_dim"])),
        )
    )
    params_np = _random_params(shapes, seed=seed)
    port = WanModel(build_wan_config(dtype=torch_dtype, remat=remat, **kw))
    port.load_state_dict(wan_params_from_jax(params_np))
    return jax_model, _to_jax(params_np), port


def _batch(seed, b=2, latent=LATENT):
    """Latents, text embeddings, timesteps in (0, 1), noise and a dropout
    mask that drops the second sample's text."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, *latent)).astype(np.float32)
    ctx = (rng.normal(size=(b, TINY["text_len"], TINY["text_dim"])) * 0.5).astype(np.float32)
    t01 = rng.uniform(0.1, 0.9, size=(b,)).astype(np.float32)
    noise = rng.normal(size=z.shape).astype(np.float32)
    drop = np.arange(b) % 2 == 1
    return z, ctx, t01, noise, drop


def _jax_loss(jax_model, dtype):
    """The loss of ``mhla_tpu.train.wan_train.main``'s ``loss_fn`` with the
    step's draws taken from the batch instead of a key."""

    def loss(p, batch, _rng=None):
        z, ctx, t01, noise, drop = batch
        ctx = jnp.where(drop[:, None, None], 0.0, ctx)
        x_t = jax_flow_q_sample(z, t01, noise)
        v = jax_model.apply(p, x_t.astype(dtype), t01 * 1000.0, ctx.astype(dtype))
        mse = jnp.mean(jnp.square(v.astype(jnp.float32) - (noise - z)), axis=(1, 2, 3, 4))
        return mse.mean(), {}

    return loss


def _port_loss(model, batch):
    z, ctx, t01, noise, drop = batch
    return wan_train.video_loss(model, z, ctx, t01, drop, noise=noise), {}


def _torch_batch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _jax_batch(batch):
    return tuple(jnp.asarray(a) for a in batch)


@pytest.mark.parametrize("form", _FORM_NAMES)
def test_wan_parameter_gradients_match_jax(form):
    """The training loss and every parameter's gradient, float32."""
    kw, latent = FORMS[form]
    jax_model, params, port = _models(kw, seed=11, latent=latent)
    batch = _batch(12, latent=latent)
    ref_loss, ref_grads = jax.value_and_grad(lambda p: _jax_loss(jax_model, jnp.float32)(
        p, _jax_batch(batch))[0])(params)
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
def test_wan_gradients_bf16_compute_match_jax(form):
    """bf16 compute over float32 parameters: the two frameworks round to bf16
    at other places (the forward agrees to 3e-2, tests/test_torch_wan.py), so
    the gradients are compared as one vector, and each against its own
    float32 run to show that level is bf16's and not a fault."""
    kw, latent = FORMS[form]
    jax_model, params, port = _models(kw, 13, jnp.bfloat16, torch.bfloat16, latent=latent)
    batch = _batch(14, latent=latent)
    ref = jax.grad(lambda p: _jax_loss(jax_model, jnp.bfloat16)(p, _jax_batch(batch))[0])(params)
    want = wan_params_from_jax(jax.tree_util.tree_map(np.asarray, ref))
    _port_loss(port, _torch_batch(batch))[0].backward()
    f32 = WanModel(dataclasses.replace(port.cfg, dtype=torch.float32))
    f32.load_state_dict(port.state_dict())
    _port_loss(f32, _torch_batch(batch))[0].backward()
    names = [n for n, _ in port.named_parameters()]
    flat = lambda grads: torch.cat([grads[n].flatten() for n in names])  # noqa: E731
    got = flat({n: p.grad for n, p in port.named_parameters()})
    exact = flat({n: p.grad for n, p in f32.named_parameters()})
    assert all(p.grad.dtype == torch.float32 for p in port.parameters())
    assert_close(f"{form} bf16 gradients vs JAX bf16", flat(want), got, 5e-2)
    assert_close(f"{form} bf16 gradients vs float32", exact, got, 5e-2)


@pytest.mark.parametrize("form", _FORM_NAMES)
def test_remat_on_equals_remat_off_bit_for_bit(form):
    """Recomputing each block in the backward changes no bit of the loss or
    of any gradient; without autograd the flag changes nothing at all."""
    kw, latent = FORMS[form]
    _, _, plain = _models(kw, seed=15, latent=latent)
    _, _, remat = _models(kw, seed=15, remat=True, latent=latent)
    batch = _torch_batch(_batch(16, latent=latent))
    losses = []
    for model in (plain, remat):
        loss, _ = _port_loss(model, batch)
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(*losses)
    for (name, a), (_, b) in zip(plain.named_parameters(), remat.named_parameters()):
        assert torch.equal(a.grad, b.grad), name
    with torch.no_grad():
        assert torch.equal(_port_loss(plain, batch)[0], _port_loss(remat, batch)[0])


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
    (tmp_path / "shard.tar").write_bytes(b"")
    with pytest.raises(NotImplementedError):
        next(wan_train.video_batches(cfg, np.random.default_rng(0)))


# the sizes of tests/test_harnesses.py::TestWanTrain
_TINY_ARGS = [
    "--device=cpu", "--model.model=Wan_T2V_1300M", "--model.dim=48", "--model.ffn_dim=96",
    "--model.num_heads=4", "--model.block_layout=(2,2,2)", "--bf16=false",
    "--data.latent_frames=4", "--data.latent_height=8", "--data.latent_width=8",
    "--data.latent_dim=4", "--data.text_len=8", "--data.text_dim=32", "--train.log_interval=1",
    "--train.save_interval=100", "--optimizer.total_steps=2", "--optimizer.warmup_steps=1",
]
_HYBRID_ARGS = _TINY_ARGS + ["--model.num_layers=2", "--model.linear_attn_idx=(0,)"]


def test_wan_train_few_steps(tmp_path):
    """A 2-layer hybrid model (one MHLA, one softmax layer), two steps."""
    out = wan_train.main(_HYBRID_ARGS + [f"--work_dir={tmp_path}/wan", "--train.max_steps=2"])
    assert math.isfinite(out["final_loss"]) and len(out["losses"]) == 2
    assert all(math.isfinite(g) and g > 0 for g in out["grad_norms"])
    model = out["model"]
    assert model.cfg.remat and model.cfg.sparse_dense_from_t is None
    assert [b.attn_type for b in model.blocks] == ["mhla_uni", "flash"]
    sparse = wan_train.main(_HYBRID_ARGS + [f"--work_dir={tmp_path}/sparse", "--train.max_steps=2",
                                            "--model.sparse_attn_idx=(1,)"])
    assert [b.attn_type for b in sparse["model"].blocks] == ["mhla_uni", "sparse"]
    # training runs the mask whatever the timestep: the model carries no dense guard
    assert sparse["model"].cfg.sparse_dense_from_t is None
    assert math.isfinite(sparse["final_loss"]) and sparse["losses"] != out["losses"]
    assert out["params"] == sum(p.numel() for p in model.parameters())
    assert (tmp_path / "wan" / "config.yaml").exists()
    assert out["checkpoint_bytes"] > 0 and out["save_seconds"] > 0


def test_wan_train_validation_sampling(tmp_path):
    """Validation latents are written every ``eval_sampling_steps`` and a
    re-run of the same configuration writes the same ones (fixed seeds
    throughout)."""
    def args(work):
        return _TINY_ARGS + [
            f"--work_dir={tmp_path}/{work}", "--model.num_layers=1", "--train.max_steps=2",
            "--train.eval_sampling_steps=2", "--train.eval_solver_steps=2"]
    wan_train.main(args("a"))
    lat = np.load(tmp_path / "a" / "validation" / "step_000002.npy")
    assert lat.shape == (1, 4, 8, 8, 4) and np.isfinite(lat).all()
    wan_train.main(args("b"))
    np.testing.assert_array_equal(lat, np.load(tmp_path / "b" / "validation" / "step_000002.npy"))


def test_wan_train_resumes_from_latest_and_draws_what_an_unbroken_run_would(tmp_path):
    """Two steps, then a run that resumes from ``latest`` and takes the
    third: the same parameters and EMA as three steps in one run (the
    synthetic stream restarts on a resume, as in the JAX entry point, so
    both runs see the same third batch only because it is fed by hand)."""
    work = [f"--work_dir={tmp_path}/split"]
    first = wan_train.main(_HYBRID_ARGS + work + ["--train.max_steps=2"])
    assert first["start_step"] == 0
    path = resolve_resume_path(str(tmp_path / "split"))
    assert path is not None and path.endswith("step_00000002")
    assert (tmp_path / "split" / "checkpoints" / "latest").is_symlink()
    again = wan_train.main(_HYBRID_ARGS + work + ["--train.max_steps=2"])
    assert again["start_step"] == 2 and again["losses"] == []
    for (name, a), (_, b) in zip(first["model"].named_parameters(),
                                 again["model"].named_parameters()):
        assert torch.equal(a, b), name

    # step 3 after a resume against step 3 of an unbroken run, on one batch
    def third_step(cfg_args, steps_before):
        cfg = wan_train.parse_cli(wan_train.WanTrainConfig, cfg_args)
        model, state, step_fn, data = wan_train.build_training(cfg)
        if steps_before:
            for _ in range(steps_before):
                z, c = next(data)
                state, _ = step_fn(state, (torch.from_numpy(z), torch.from_numpy(c)))
        else:
            state = wan_train.load_checkpoint(path, state)
        rng = np.random.default_rng(99)
        z = rng.standard_normal((1, 4, 8, 8, 4), dtype=np.float32)
        c = rng.standard_normal((1, 8, 32), dtype=np.float32)
        state, metrics = step_fn(state, (torch.from_numpy(z), torch.from_numpy(c)))
        return state, metrics

    resumed, m1 = third_step(_HYBRID_ARGS + work, 0)
    unbroken, m2 = third_step(_HYBRID_ARGS + [f"--work_dir={tmp_path}/whole"], 2)
    assert resumed.step == unbroken.step == 3
    assert torch.equal(m1["loss"], m2["loss"])
    for (name, a), (_, b) in zip(resumed.model.named_parameters(),
                                 unbroken.model.named_parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(resumed.ema[name], unbroken.ema[name]), name


@pytest.mark.parametrize(
    "arg",
    ["--distill.enable=True", "--model.is_lepe=True", "--model.rope_after=False",
     "--model.model=Wan_I2V_14B", "--model.self_attn_type=gla"],
)
def test_wan_train_unported_options_raise(tmp_path, arg):
    with pytest.raises(NotImplementedError):
        wan_train.main(_HYBRID_ARGS + [f"--work_dir={tmp_path}", "--train.max_steps=1", arg])


@pytest.mark.parametrize("side", ["dense_at_900", "sparse_at_300"])
def test_sparse_layers_refuse_gradients(side):
    """The radial-sparse layers take gradients (this test's name dates from
    when they refused them). A model built *with* the dense guard, as a
    caller outside the video trainer may build it, runs the dense backward
    while max(t) >= 850 and the sparse one below: every parameter's gradient
    against ``jax.grad`` of the JAX model, which selects the branch with
    ``lax.cond``, on both sides of the guard; above it the gradients equal
    those of the model without ``sparse_attn_idx``, below it they differ."""
    kw = dict(SPARSE, sparse_dense_from_t=850.0)
    jax_model, params, port = _models(kw, seed=23, latent=SPARSE_LATENT)
    z, ctx, _, noise, drop = _batch(24, latent=SPARSE_LATENT)
    t01 = np.array([0.9, 0.95] if side == "dense_at_900" else [0.3, 0.84], np.float32)
    batch = (z, ctx, t01, noise, drop)
    ref = jax.grad(lambda p: _jax_loss(jax_model, jnp.float32)(p, _jax_batch(batch))[0])(params)
    want = wan_params_from_jax(jax.tree_util.tree_map(np.asarray, ref))
    _port_loss(port, _torch_batch(batch))[0].backward()
    dense = WanModel(dataclasses.replace(port.cfg, sparse_attn_idx=None))
    dense.load_state_dict(port.state_dict())
    _port_loss(dense, _torch_batch(batch))[0].backward()
    for (name, p), (_, d) in zip(port.named_parameters(), dense.named_parameters()):
        assert_close(f"{side} d {name}", want[name], p.grad, TOL)
        if side == "dense_at_900":
            assert torch.equal(p.grad, d.grad), name
    if side == "sparse_at_300":
        got = torch.cat([p.grad.flatten() for p in port.parameters()])
        other = torch.cat([p.grad.flatten() for p in dense.parameters()])
        assert (got - other).norm() > 1e-2 * other.norm()


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
