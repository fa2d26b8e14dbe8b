"""The port's video training path, part two: gradients with bf16 compute,
remat on against off, the dense guard's gradients, LePE, and the
``wan_train`` entry point (steps, validation sampling, resume, what it
refuses), held against the JAX package on the CPU at a tiny size (part one:
``test_torch_wan_train.py``; the shared pieces: ``wan_train_fixtures.py``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu_torch.models import WanModel, wan_params_from_jax
from mhla_tpu_torch.train import wan_train
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.checkpoint import resolve_resume_path

from wan_train_fixtures import (
    _FORM_NAMES,
    _HYBRID_ARGS,
    _TINY_ARGS,
    FORMS,
    FULL,
    SPARSE,
    SPARSE_LATENT,
    TOL,
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
def test_wan_gradients_bf16_compute_match_jax(form):
    """bf16 compute over float32 parameters: the two frameworks round to bf16
    at other places (the forward agrees to 3e-2, tests/test_torch_wan.py), so
    the gradients are compared as one vector, and each against its own
    float32 run to show that level is bf16's and not a fault."""
    kw, latent = FORMS[form]
    _, params, port = _models(kw, 13, jnp.bfloat16, torch.bfloat16, latent=latent)
    batch = _batch(14, latent=latent)
    _, ref = jax_value_and_grad(kw, params, batch, jnp.bfloat16)
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
    _, params, port = _models(kw, seed=23, latent=SPARSE_LATENT)
    z, ctx, _, noise, drop = _batch(24, latent=SPARSE_LATENT)
    t01 = np.array([0.9, 0.95] if side == "dense_at_900" else [0.3, 0.84], np.float32)
    batch = (z, ctx, t01, noise, drop)
    _, ref = jax_value_and_grad(kw, params, batch)
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


def test_wan_train_with_lepe_matches_jax_loss(tmp_path):
    """``--model.is_lepe=True``: the trainer's model (full MHLA, remat)
    carries the LePE convolution in every MHLA layer and, on JAX's weights,
    gives JAX's loss; a step of ``wan_train.main`` runs with it. (The
    layer's gradients against JAX, on the fused island's route too:
    ``tests/test_torch_vision.py``.)"""
    args = ["--device=cpu", "--bf16=false", "--model.dim=64", "--model.ffn_dim=128",
            "--model.num_heads=2", "--model.num_layers=2", "--model.linear_attn_idx=(0,1)",
            "--model.block_layout=(2,2,2)", "--model.is_lepe=True", "--data.latent_dim=16",
            "--data.text_len=16", "--data.text_dim=64"]
    port, _ = wan_train.build_model(wan_train.parse_cli(wan_train.WanTrainConfig, args))
    assert port.cfg.remat and all(b.self_attn.lepe is not None for b in port.blocks)
    jax_model, params, jax_port = _models(dict(FULL, dim=64, ffn_dim=128, is_lepe=True), seed=31)
    port.load_state_dict(jax_port.state_dict())
    batch = _batch(32)
    ref = jax.jit(lambda p, b: _jax_loss(jax_model, jnp.float32)(p, b)[0])(params,
                                                                           _jax_batch(batch))
    with torch.no_grad():
        loss, _ = _port_loss(port, _torch_batch(batch))
    assert_close("LePE loss", np.asarray(ref), loss, 1e-5)
    out = wan_train.main(_HYBRID_ARGS + [f"--work_dir={tmp_path}", "--train.max_steps=1",
                                         "--model.is_lepe=True"])
    assert out["model"].blocks[0].self_attn.lepe is not None
    assert len(out["losses"]) == 1 and math.isfinite(out["losses"][0])


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


# what the entry point still refuses, by the option that reaches it: each
# case's extra arguments and the error
_REFUSED = {
    # distillation without a teacher (the JAX entry point asserts one)
    "--distill.enable=True": ((), ValueError),
    # rope_after is read by the linear baselines alone, which are not ported
    "--model.rope_after=False": (("--model.self_attn_type=linear",), NotImplementedError),
    # i2v training: the JAX entry point cannot initialise an i2v model either
    "--model.model=Wan_I2V_14B": ((), NotImplementedError),
    "--model.self_attn_type=gla": ((), NotImplementedError),
}


@pytest.mark.parametrize("arg", list(_REFUSED))
def test_wan_train_unported_options_raise(tmp_path, arg):
    extra, error = _REFUSED[arg]
    with pytest.raises(error):
        wan_train.main(_HYBRID_ARGS + [f"--work_dir={tmp_path}", "--train.max_steps=1", arg,
                                       *extra])
