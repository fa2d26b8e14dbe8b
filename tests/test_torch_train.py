"""The port's training path against the JAX package on the CPU: the
trainer (AdamW, clipping, schedule, projections) step for step, the
schedule and gradient accumulation against optax, the data pipeline batch
for batch, the utilities, and the ``lm_train`` entry point with resume.

Weights, batches and gradients come from numpy with fixed seeds and go to
both packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mhla_tpu.data import make_lm_dataloader as jax_make_lm_dataloader
from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu.models import cross_entropy_loss as jax_cross_entropy_loss
from mhla_tpu.train import trainer as jax_trainer
from mhla_tpu_torch.data import make_lm_dataloader
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    params_from_jax,
)
from mhla_tpu_torch.train import (
    AdamW,
    OptimizerConfig,
    init_train_state,
    make_schedule,
    make_train_step,
    project_params,
)
from mhla_tpu_torch.train import lm_train
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.checkpoint import resolve_resume_path
from mhla_tpu_torch.utils.config import dump_config, parse_cli
from mhla_tpu_torch.utils.monitor import NaNLossBreaker, finite_check

from test_torch_lm import _random_params

SMALL = dict(hidden_size=64, num_hidden_layers=1, num_heads=2, vocab_size=50,
             max_position_embeddings=256)
OPT = dict(learning_rate=1e-3, weight_decay=0.01, grad_clip=1.0, warmup_steps=2,
           total_steps=10, schedule="cosine")


def _jax_opt(**kw):
    return jax_trainer.OptimizerConfig(**{**OPT, **kw})


def _port_opt(**kw):
    return OptimizerConfig(**{**OPT, **kw})


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_optax(schedule):
    """Steps 0 to total + 3, the first at learning rate 0 (optax evaluates
    the schedule at the count before the step)."""
    ref = jax_trainer.make_schedule(_jax_opt(schedule=schedule, min_lr_ratio=0.1))
    ours = make_schedule(_port_opt(schedule=schedule, min_lr_ratio=0.1))
    assert ours(0) == 0.0
    for count in range(OPT["total_steps"] + 4):
        # optax computes in float32, the port in float64
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12)


def test_accumulation_matches_optax_multisteps():
    """accum_steps = 2: the running mean of two micro-batch gradients feeds
    one clipped AdamW step; the calls in between leave the parameters."""
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (7,), (3, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.5 for s in shapes] for _ in range(6)]
    tx = jax_trainer.make_optimizer(_jax_opt(accum_steps=2))
    p_j = [jnp.asarray(p) for p in params]
    st = tx.init(p_j)
    p_t = [torch.from_numpy(p.copy()) for p in params]
    opt = AdamW(p_t, _port_opt(accum_steps=2))
    for i, g in enumerate(grads):
        upd, st = tx.update([jnp.asarray(x) for x in g], st, p_j)
        p_j = optax.apply_updates(p_j, upd)
        before = [p.clone() for p in p_t]
        opt.step([torch.from_numpy(x) for x in g])
        if i % 2 == 0:
            assert all(torch.equal(a, b) for a, b in zip(before, p_t))
        for r, p in zip(p_j, p_t):
            # float32, same formulas: a few ulp of the parameter
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
    assert opt.count == 3


@pytest.fixture(scope="module")
def small_lm():
    jax_model = JaxLM(JaxConfig(**SMALL))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax_model, _random_params(shapes, seed=1)


def test_three_trainer_steps_match_jax(small_lm):
    """make_train_step + AdamW (clip 1.0, wd 0.01, warm-up 2, cosine) against
    the JAX make_train_step + make_optimizer on the same batches: loss,
    grad norm and every parameter after each step."""
    jax_model, params_np = small_lm
    cfg = MHLALMConfig(**SMALL)

    def jax_loss(p, batch, _rng):
        logits, _ = jax_model.apply(p, batch)
        return jax_cross_entropy_loss(logits, batch), {}

    tx = jax_trainer.make_optimizer(_jax_opt())
    state = jax_trainer.init_train_state(jax.tree_util.tree_map(jnp.asarray, params_np), tx)
    jax_step = jax_trainer.make_train_step(jax_loss, tx, donate=False)

    model = MHLAForCausalLM(cfg)
    model.load_state_dict(params_from_jax(params_np, cfg))
    port_state = init_train_state(model, _port_opt())

    port_step = make_train_step(lm_train.lm_loss)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(2)
    for i in range(3):
        ids = rng.integers(0, SMALL["vocab_size"], (2, 70)).astype(np.int32)
        state, ref = jax_step(state, jnp.asarray(ids), jax.random.PRNGKey(i))
        port_state, got = port_step(port_state, torch.from_numpy(ids).long())
        # loss and grad norm: the forward's float32 bound (tests/test_torch_lm.py)
        assert_close(f"step {i} loss", np.asarray(ref["loss"]), got["loss"], 1e-5)
        assert_close(f"step {i} grad norm", np.asarray(ref["grad_norm"]), got["grad_norm"], 1e-5)
        assert float(got["grad_norm"]) > OPT["grad_clip"]  # the clip is active
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params), cfg)
        for name, p in model.named_parameters():
            if i == 0:  # learning rate 0: only the projection acts, exactly
                assert torch.equal(p.detach(), want[name]), name
                continue
            # Adam normalises each update to ~lr, so a gradient's float32
            # noise moves its parameter by ~1e-6 lr: compare the distance
            # travelled since the start (~lr per entry and step). Measured
            # <= 2.2e-6 relative RMS; 2e-5 leaves 10x for summation order
            delta_ref = want[name] - start[name]
            assert_close(f"step {i} {name}", delta_ref, p.detach() - start[name], 2e-5)
    mm = model.model.layers[0].attn.mixing_matrix
    assert torch.equal(mm, torch.tril(mm.clamp(1e-5, 1.0)))


def test_project_params_clamps_mixing_matrices_in_place():
    model = MHLAForCausalLM(MHLALMConfig(**SMALL))
    mm = model.model.layers[0].attn.mixing_matrix
    raw = np.linspace(-1.0, 2.0, mm.numel(), dtype=np.float32).reshape(mm.shape)
    with torch.no_grad():
        mm.copy_(torch.from_numpy(raw))
    project_params(model)
    ref = jax_trainer.project_params({"mixing_matrix": jnp.asarray(raw)})["mixing_matrix"]
    np.testing.assert_array_equal(np.asarray(ref), mm.detach().numpy())


@pytest.mark.parametrize("owner", ["block_attn", "piece_attn"])
def test_project_params_clamps_trainable_block_mixing_weights(owner):
    """A trainable vision block-mixing weight is clamped to [0, 1] after each
    step, as the JAX ``project_params`` clamps every leaf under
    ``block_attn`` / ``piece_attn``; a fixed one (a buffer) and other
    parameters are left alone."""
    from mhla_tpu_torch.layers import BlockMixing

    model = torch.nn.Module()
    setattr(model, owner, BlockMixing((2, 2, 2), trainable=True))
    model.fixed = BlockMixing((2, 2, 2))
    model.other = torch.nn.Linear(4, 4)
    weight = getattr(model, owner).weight
    raw = np.linspace(-1.0, 2.0, weight.numel(), dtype=np.float32).reshape(weight.shape)
    with torch.no_grad():
        weight.copy_(torch.from_numpy(raw))
        model.other.weight.fill_(3.0)
    fixed = model.fixed.weight.clone()
    project_params(model)
    ref = jax_trainer.project_params({owner: {"weight": jnp.asarray(raw)}})[owner]["weight"]
    np.testing.assert_array_equal(np.asarray(ref), weight.detach().numpy())
    assert weight.min() == 0.0 and weight.max() == 1.0
    assert torch.equal(model.fixed.weight, fixed) and (model.other.weight == 3.0).all()


def test_unported_optimizers_raise():
    for name in ("lion", "came", "adamw8bit", "came8bit"):
        with pytest.raises(NotImplementedError):
            AdamW([torch.zeros(2)], OptimizerConfig(optimizer=name))


def test_dataloader_batches_equal_jax():
    kw = dict(seq_len=64, batch_size=3, vocab_size=100, seed=7)
    ref = jax_make_lm_dataloader(**kw)
    ours = make_lm_dataloader(**kw)
    for _ in range(5):
        a, b = next(ref), next(ours)
        assert b.dtype == np.int32 and b.shape == (3, 64)
        np.testing.assert_array_equal(a, b)
    # the packed varlen batches too: dicts of the same rows
    ref = jax_make_lm_dataloader(**kw, varlen=True)
    ours = make_lm_dataloader(**kw, varlen=True)
    for _ in range(3):
        a, b = next(ref), next(ours)
        assert set(a) == set(b) == {"input_ids", "segment_ids", "targets"}
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_monitor_and_config_utilities(tmp_path):
    breaker = NaNLossBreaker(patience=2)
    assert not breaker.update(float("nan")) and not breaker.update(1.0)
    assert not breaker.update(float("inf")) and breaker.update(float("nan"))
    assert bool(finite_check({"a": torch.ones(2), "b": [torch.zeros(1), torch.arange(3)]}))
    assert not bool(finite_check([torch.ones(2), {"c": torch.tensor([math.nan])}]))
    cfg = parse_cli(lm_train.LMTrainConfig, ["--train.max_steps=3", "--model.feature_map=elu",
                                             "--optimizer.grad_clip=None"])
    assert cfg.train.max_steps == 3 and cfg.model.feature_map == "elu"
    assert cfg.optimizer.grad_clip is None
    with pytest.raises(KeyError):
        parse_cli(lm_train.LMTrainConfig, ["--train.nope=1"])
    dump_config(cfg, str(tmp_path / "config.yaml"))
    assert "max_steps: 3" in (tmp_path / "config.yaml").read_text()


_TINY_ARGS = [
    "--device=cpu", "--model.num_hidden_layers=2", "--model.hidden_size=512",
    "--model.num_heads=2", "--model.vocab_size=100", "--train.batch_size=2",
    "--train.seq_len=130", "--train.log_interval=1", "--optimizer.warmup_steps=1",
]


def test_lm_train_runs_and_resumes_from_latest(tmp_path):
    """Two steps into tmp_path, then a run that resumes from ``latest`` at
    the same step with the same parameters and optimizer state."""
    args = _TINY_ARGS + [f"--work_dir={tmp_path}", "--train.max_steps=2"]
    out = lm_train.main(args)
    assert out["start_step"] == 0 and len(out["losses"]) == 2
    assert all(map(math.isfinite, out["losses"])) and math.isfinite(out["final_loss"])
    assert out["params"] == sum(p.numel() for p in out["model"].parameters())
    path = resolve_resume_path(str(tmp_path))
    assert path is not None and path.endswith("step_00000002")
    assert (tmp_path / "checkpoints" / "latest").is_symlink()
    assert (tmp_path / "config.yaml").exists()
    again = lm_train.main(args)
    assert again["start_step"] == 2 and again["losses"] == []
    for (name, a), (_, b) in zip(out["model"].named_parameters(),
                                 again["model"].named_parameters()):
        assert torch.equal(a, b), name
    more = lm_train.main(_TINY_ARGS + [f"--work_dir={tmp_path}", "--train.max_steps=3"])
    assert more["start_step"] == 2 and len(more["losses"]) == 1


@pytest.mark.parametrize(
    "arg",
    ["--train.n_data=2", "--train.n_tensor=2",
     "--model.attn_extends=mamba2 --train.varlen=true --train.seq_len=128", "--wandb=True"],
)
def test_lm_train_unported_options_raise(tmp_path, arg):
    """Data and tensor parallelism, wandb, and packed documents in a family
    that refuses segment ids (as JAX's block does)."""
    with pytest.raises(NotImplementedError):
        lm_train.main(_TINY_ARGS + [f"--work_dir={tmp_path}", "--train.max_steps=1",
                                    *arg.split()])

