"""Teacher distillation in the port's video trainer, held against the JAX
package's ``wan_train`` on the CPU at a tiny size: the loss (flow loss,
``distill_logit``, ``distill_attn``) and its gradients against a mirror of
JAX's ``loss_fn`` with and without LoRA, the trainer's draws, the teacher's
load, ``wan_train.main`` distilling on tar-shard latents, and
``model.rope_after=false``, which the port used to refuse.

Weights, latents, timesteps, noise and dropout masks come from numpy and go
to both packages. Narrow widths (head dim 32): both run MHLA's plain
einsums; layer 1 runs dense softmax attention. The JAX calls run under
``jax.jit``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.diffusion import flow_q_sample as jax_flow_q_sample
from mhla_tpu.models.wan import WanModel as JaxWanModel
from mhla_tpu.models.wan import build_wan_config as jax_build_wan_config
from mhla_tpu.train import lora as jax_lora
from mhla_tpu_torch.data import write_tar_shard
from mhla_tpu_torch.models import WanModel, build_wan_config, wan_params_from_jax
from mhla_tpu_torch.train import apply_lora, lora_state, step_generator, wan_train
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.checkpoint import resolve_resume_path

from test_torch_lora import ALPHA, RANK, _lora_from_jax, _random_jax_lora
from test_torch_wan import _random_params, _to_jax
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32 through 2 blocks, three forwards (XLA vs ATen GEMMs), as
# test_torch_wan_train.py's TOL
TOL = 1e-4
NARROW = dict(num_layers=2, dim=64, num_heads=2, ffn_dim=128, text_len=16, text_dim=32,
              linear_attn_idx=(0,), block_layout=(2, 2, 2))
LATENT = (2, 8, 12, 16)
WEIGHTS = (1.0, 0.5)  # distill.logit_weight, distill.attn_weight


def _params(jax_model, seed):
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *LATENT)), jnp.zeros((1,)),
        jnp.zeros((1, NARROW["text_len"], NARROW["text_dim"]))))
    return _random_params(shapes, seed=seed)


def _port(params_np, remat=True, **kw):
    port = WanModel(build_wan_config(remat=remat, **{**NARROW, **kw}))
    port.load_state_dict(wan_params_from_jax(params_np))
    return port


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, *LATENT)).astype(np.float32)
    ctx = (rng.normal(size=(b, NARROW["text_len"], NARROW["text_dim"])) * 0.5).astype(np.float32)
    t01 = rng.uniform(0.1, 0.9, size=(b,)).astype(np.float32)
    noise = rng.normal(size=z.shape).astype(np.float32)
    return z, ctx, t01, noise, np.arange(b) % 2 == 1


def _jax_distill_loss(jax_model, lora_base=None):
    """``mhla_tpu.train.wan_train.main``'s ``loss_fn`` with a teacher, its
    draws taken from the batch: the flow loss, then a second student forward
    with ``capture`` and the teacher's on the same x_t."""
    lw, aw = WEIGHTS

    def loss(p, teacher, batch):
        z, ctx, t01, noise, drop = batch
        ctx = jnp.where(drop[:, None, None], 0.0, ctx)
        eff = jax_lora.merge_lora(lora_base, p, ALPHA) if lora_base is not None else p
        x_t = jax_flow_q_sample(z, t01, noise)
        v = jax_model.apply(eff, x_t, t01 * 1000.0, ctx)
        out = jnp.mean(jnp.mean(jnp.square(v - (noise - z)), axis=(1, 2, 3, 4)))
        s_out, s_caps = jax_model.apply(eff, x_t, t01 * 1000.0, ctx, capture=True)
        t_out, t_caps = jax_model.apply(jax.lax.stop_gradient(teacher), x_t, t01 * 1000.0, ctx,
                                        capture=True)
        d_logit = jnp.mean((s_out - t_out) ** 2)
        s_attn, t_attn = jax.tree.leaves(s_caps), jax.tree.leaves(t_caps)
        d_attn = sum(jnp.mean((a - b) ** 2) for a, b in zip(s_attn, t_attn)) / len(s_attn)
        return out + lw * d_logit + aw * d_attn, (d_logit, d_attn, len(s_attn))

    return loss


def _port_loss(student, teacher, batch):
    z, ctx, t01, noise, drop = (torch.from_numpy(a) for a in batch)
    return wan_train.distill_video_loss(student, teacher, z, ctx, t01, drop, noise, *WEIGHTS)


@pytest.fixture(scope="module")
def pair():
    jax_model = JaxWanModel(jax_build_wan_config(remat=False, **NARROW))
    student, teacher = _params(jax_model, seed=1), _params(jax_model, seed=2)
    return jax_model, student, teacher


def test_distillation_loss_and_gradients_match_jax(pair):
    """Every parameter's gradient of the student (remat on), the loss and
    both distillation terms; ``distill_attn`` averages 2 x num_layers
    tensors, every attention output and every block output."""
    jax_model, student_np, teacher_np = pair
    batch = _batch(3)
    (ref, (ref_logit, ref_attn, n_leaves)), ref_grads = jax.jit(jax.value_and_grad(
        _jax_distill_loss(jax_model), has_aux=True))(
        _to_jax(student_np), _to_jax(teacher_np), tuple(jnp.asarray(a) for a in batch))
    assert n_leaves == 2 * NARROW["num_layers"]
    student, teacher = _port(student_np), _port(teacher_np).requires_grad_(False)
    loss, metrics = _port_loss(student, teacher, batch)
    loss.backward()
    assert_close("distillation loss", np.asarray(ref), loss.detach(), 1e-5)
    assert_close("distill_logit", np.asarray(ref_logit), metrics["distill_logit"], 1e-5)
    assert_close("distill_attn", np.asarray(ref_attn), metrics["distill_attn"], 1e-5)
    assert float(metrics["distill_logit"]) > 0.01 and float(metrics["distill_attn"]) > 0.01
    want = wan_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))
    for name, p in student.named_parameters():
        assert_close(f"d {name}", want[name], p.grad, TOL)
    assert all(p.grad is None for p in teacher.parameters())


def test_distillation_gradients_with_lora_match_jax(pair):
    """LoRA on the student: the adapters' gradients through the merged
    weights, the teacher the full model."""
    jax_model, student_np, teacher_np = pair
    tree = _random_jax_lora(_to_jax(student_np), seed=4)
    batch = _batch(5)
    (ref, _), ref_grads = jax.jit(jax.value_and_grad(
        _jax_distill_loss(jax_model, _to_jax(student_np)), has_aux=True))(
        tree, _to_jax(teacher_np), tuple(jnp.asarray(a) for a in batch))
    want = _lora_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads)["params"])
    student, teacher = _port(student_np), _port(teacher_np).requires_grad_(False)
    apply_lora(student, torch.Generator().manual_seed(0), RANK, ALPHA)
    mine = lora_state(student)
    with torch.no_grad():
        for name, f in _lora_from_jax(tree["params"]).items():
            mine[name]["a"].copy_(f["a"])
            mine[name]["b"].copy_(f["b"])
    loss, _ = _port_loss(student, teacher, batch)
    loss.backward()
    assert_close("LoRA distillation loss", np.asarray(ref), loss.detach(), 1e-5)
    assert len(mine) == 4 * 2 * NARROW["num_layers"]
    for name, f in mine.items():
        for which in "ab":
            assert_close(f"d {name} {which}", want[name][which], f[which].grad, TOL)
    assert all(p.grad is None for p in student.parameters() if not p.requires_grad)


def test_trainer_draws_the_noise_once_for_both_losses(pair):
    """``make_loss_fn`` with a teacher draws timesteps, the dropout mask and
    the noise from the step's generator as the plain loss does: with the
    student itself as the teacher, both terms are zero and the loss is the
    plain loss on the same generator, bit for bit."""
    _, student_np, _ = pair
    cfg = wan_train.WanTrainConfig()
    student = _port(student_np)
    teacher = _port(student_np).requires_grad_(False)
    z, ctx = (torch.from_numpy(a) for a in _batch(6)[:2])
    plain, _ = wan_train.make_loss_fn(cfg)(student, (z, ctx), step_generator(3, 0, "cpu"))
    loss, metrics = wan_train.make_loss_fn(cfg, teacher)(student, (z, ctx),
                                                         step_generator(3, 0, "cpu"))
    assert float(metrics["distill_logit"]) == 0.0 and float(metrics["distill_attn"]) == 0.0
    assert torch.equal(loss, plain)


# the tiny model of tests/test_torch_wan_train_entry.py's runs
_ARGS = ["--device=cpu", "--bf16=false", "--model.dim=48", "--model.ffn_dim=96",
         "--model.num_heads=4", "--model.num_layers=2", "--model.linear_attn_idx=(0,)",
         "--model.block_layout=(2,2,2)", "--data.latent_frames=4", "--data.latent_height=8",
         "--data.latent_width=8", "--data.latent_dim=4", "--data.text_len=8",
         "--data.text_dim=32", "--train.log_interval=1", "--optimizer.warmup_steps=1"]


def test_wan_train_distills_on_tar_latents(tmp_path):
    """A teacher run (another seed) writes its checkpoint; the student then
    trains 2 steps with ``distill.enable`` and LoRA on latents from two tar
    shards: finite losses and terms, the teacher the teacher run's EMA
    weights bit for bit, loaded into the full model (no adapters) and
    frozen."""
    teacher_run = wan_train.main(_ARGS + [f"--work_dir={tmp_path}/teacher", "--train.max_steps=2",
                                          "--train.seed=1", "--train.ema_decay=0.5"])
    rng = np.random.default_rng(7)
    (tmp_path / "latents").mkdir()
    for s in range(2):
        write_tar_shard(str(tmp_path / "latents" / f"part-{s}.tar"), [
            {"__key__": f"clip_{s}_{i}",
             "latent.npy": rng.normal(size=(4, 8, 8, 4)).astype(np.float32),
             "text_emb.npy": rng.normal(size=(8, 32)).astype(np.float32)} for i in range(3)])
    args = _ARGS + [f"--work_dir={tmp_path}/student", "--train.max_steps=2",
                    f"--data.latent_dir={tmp_path}/latents", "--distill.enable=true",
                    f"--distill.teacher_ckpt={tmp_path}/teacher", "--distill.attn_weight=0.5",
                    "--lora.enable=true", "--lora.rank=4", "--train.batch_size=2"]
    out = wan_train.main(args)
    assert len(out["losses"]) == len(out["distill_logit"]) == len(out["distill_attn"]) == 2
    for values in (out["losses"], out["distill_logit"], out["distill_attn"]):
        assert all(math.isfinite(v) for v in values)
    assert min(out["distill_logit"]) > 0 and min(out["distill_attn"]) > 0

    cfg = wan_train.parse_cli(wan_train.WanTrainConfig, args)
    teacher = wan_train.load_teacher(cfg, torch.device("cpu"))
    payload = torch.load(f"{resolve_resume_path(f'{tmp_path}/teacher')}/state.pt",
                         weights_only=True)
    assert not any(p.requires_grad for p in teacher.parameters())
    assert not any("lora" in n or "parametrizations" in n for n in teacher.state_dict())
    for name, p in teacher.state_dict().items():
        assert torch.equal(p, payload["ema"][name]), name
    assert not torch.equal(payload["ema"]["head.weight"], teacher_run["model"].head.weight)


def test_wan_train_refuses_distillation_without_a_teacher(tmp_path):
    with pytest.raises(ValueError, match="teacher_ckpt"):
        wan_train.main(_ARGS + [f"--work_dir={tmp_path}", "--train.max_steps=1",
                                "--distill.enable=true"])


@pytest.mark.parametrize("form", ["full", "hybrid"])
def test_rope_after_false_models_match_jax(form):
    """``rope_after=False`` in the config of a full-MHLA and of a hybrid
    model: carried, read by no ported layer, and JAX's forward (JAX's
    MHLA3D and softmax layers do not read it either)."""
    kw = dict(NARROW, rope_after=False)
    if form == "full":
        kw["linear_attn_idx"] = (0, 1)
    jax_model = JaxWanModel(jax_build_wan_config(remat=False, **kw))
    params_np = _params(jax_model, seed=8)
    port = _port(params_np, remat=False, **kw).eval()
    assert port.cfg.rope_after is False
    z, ctx, t01, _, _ = _batch(9)
    ref = jax.jit(jax_model.apply)(_to_jax(params_np), jnp.asarray(z), jnp.asarray(t01 * 1000),
                                   jnp.asarray(ctx))
    with torch.no_grad():
        out = port(torch.from_numpy(z), torch.from_numpy(t01 * 1000), torch.from_numpy(ctx))
    assert_close(f"{form} rope_after=False", np.asarray(ref), out, TOL)


def test_wan_train_runs_with_rope_after_false(tmp_path):
    out = wan_train.main(_ARGS + [f"--work_dir={tmp_path}", "--train.max_steps=2",
                                  "--model.rope_after=false"])
    assert out["model"].cfg.rope_after is False
    assert len(out["losses"]) == 2 and all(math.isfinite(v) for v in out["losses"])
