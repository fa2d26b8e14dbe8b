"""The port's LM losses (``ops/losses.py``) and the LM's fused loss against
the JAX package on the CPU: values and gradients against ``jax.grad``,
float32. Inputs come from numpy with fixed seeds."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu.models import cross_entropy_loss as jax_cross_entropy_loss
from mhla_tpu.models.gla_lm import fused_lm_loss as jax_fused_lm_loss
from mhla_tpu.ops import losses as jl
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    fused_lm_loss,
    params_from_jax,
    unembedding_weight,
)
from mhla_tpu_torch.ops import losses as tl
from mhla_tpu_torch.train import lm_train
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32 on both sides, the same math in other summation orders
TOL = 1e-5


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _labels(shape, v, seed=1, ignored=5):
    y = np.random.default_rng(seed).integers(0, v, shape).astype(np.int64)
    y.reshape(-1)[:ignored] = -100
    return y


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    logits, y = _x(2, 9, 30), _labels((2, 9), 30)
    ref_nll, ref_mask = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(y),
                                         label_smoothing=smoothing)
    nll, mask = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                                 label_smoothing=smoothing)
    assert_close("nll", np.asarray(ref_nll), nll, TOL)
    assert torch.equal(mask, torch.from_numpy(np.array(ref_mask)))


@pytest.mark.parametrize("bias,smoothing", [(False, 0.0), (True, 0.1)])
def test_fused_linear_cross_entropy_matches_jax(bias, smoothing):
    """74 rows in chunks of 16 (the last ragged), 5 ignored labels: the mean
    loss and the gradients of hidden, weight and bias."""
    h, w, y = _x(2, 37, 24), _x(40, 24, seed=2, scale=0.3), _labels((2, 37), 40)
    b = _x(40, seed=3) if bias else None

    def f(h_, w_, b_):
        return jl.fused_linear_cross_entropy(h_, w_, jnp.asarray(y), b_, chunk_size=16,
                                             label_smoothing=smoothing)

    args = [jnp.asarray(u) for u in (h, w)] + [None if b is None else jnp.asarray(b)]
    argnums = (0, 1, 2) if bias else (0, 1)
    ref = f(*args)
    ref_g = jax.grad(f, argnums=argnums)(*args)
    xs = [torch.from_numpy(u).requires_grad_() for u in (h, w)]
    xs.append(torch.from_numpy(b).requires_grad_() if bias else None)
    loss = tl.fused_linear_cross_entropy(xs[0], xs[1], torch.from_numpy(y), xs[2],
                                         chunk_size=16, label_smoothing=smoothing)
    assert_close("fused linear CE", np.asarray(ref), loss, TOL)
    loss.backward()
    for name, r, x in zip(("hidden", "weight", "bias"), ref_g, xs):
        assert_close(f"fused linear CE d{name}", np.asarray(r), x.grad, TOL)


@pytest.mark.parametrize("reduction", ["batchmean", "sum"])
def test_fused_kl_div_loss_matches_jax(reduction):
    """37 rows in chunks of 16: KL(teacher || student) and the gradients of
    both hidden states and both unembeddings; an unknown reduction raises."""
    args = [_x(37, 24, seed=4), _x(37, 24, seed=5), _x(40, 24, seed=6, scale=0.3),
            _x(40, 24, seed=7, scale=0.3)]

    def f(*u):
        return jl.fused_kl_div_loss(*u, reduction=reduction, chunk_size=16)

    ja = [jnp.asarray(u) for u in args]
    ref, ref_g = f(*ja), jax.grad(f, argnums=(0, 1, 2, 3))(*ja)
    xs = [torch.from_numpy(u).requires_grad_() for u in args]
    loss = tl.fused_kl_div_loss(*xs, reduction=reduction, chunk_size=16)
    assert_close("fused KL", np.asarray(ref), loss, TOL)
    loss.backward()
    for name, r, x in zip(("x", "target_x", "weight", "target_weight"), ref_g, xs):
        assert_close(f"fused KL d{name}", np.asarray(r), x.grad, TOL)
    with pytest.raises(ValueError):
        tl.fused_kl_div_loss(*xs, reduction="mean")


@pytest.mark.parametrize("masked", [False, True])
def test_grpo_loss_matches_jax(masked):
    """Per-token loss and KL (``save_kl``), and the logits' gradient of the
    summed loss (the advantage times d logp, plus the KL's)."""
    logits, ids = _x(3, 8, 20), _labels((3, 8), 20, ignored=0)
    ref_logp, adv = _x(3, 7, seed=8, scale=0.5) - 3.0, _x(3, seed=9)
    mask = (np.random.default_rng(10).random((3, 7)) > 0.3).astype(np.float32) if masked else None

    def f(lg):
        return jl.grpo_loss(lg, jnp.asarray(ref_logp), jnp.asarray(ids), jnp.asarray(adv),
                            beta=0.1, completion_mask=None if mask is None else jnp.asarray(mask),
                            save_kl=True)

    ref_loss, ref_kl = f(jnp.asarray(logits))
    ref_g = jax.grad(lambda lg: jnp.sum(f(lg)[0]))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    loss, kl = tl.grpo_loss(lt, torch.from_numpy(ref_logp), torch.from_numpy(ids),
                            torch.from_numpy(adv), beta=0.1,
                            completion_mask=None if mask is None else torch.from_numpy(mask),
                            save_kl=True)
    assert_close("grpo loss", np.asarray(ref_loss), loss, TOL)
    assert_close("grpo kl", np.asarray(ref_kl), kl, TOL)
    loss.sum().backward()
    assert_close("grpo dlogits", np.asarray(ref_g), lt.grad, TOL)


def test_l2_warp_keeps_the_value_and_matches_jax_grad():
    """l2_warp(loss, logits) has the loss's value; the logits' gradient of
    a cross-entropy through it against ``jax.grad``."""
    logits, y = _x(2, 9, 30, scale=3.0), _labels((2, 9), 30, ignored=0)

    def f(lg):
        return jl.l2_warp(jax_cross_entropy_loss(lg, jnp.asarray(y)), lg)

    ref_g = jax.grad(f)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    from mhla_tpu_torch.models import cross_entropy_loss

    plain = cross_entropy_loss(lt, torch.from_numpy(y))
    loss = tl.l2_warp(plain, lt)
    assert torch.equal(loss, plain)
    assert_close("l2 warp value", np.asarray(f(jnp.asarray(logits))), loss, TOL)
    loss.backward()
    assert_close("l2 warp dlogits", np.asarray(ref_g), lt.grad, TOL)


def test_l2_warp_splits_the_pull_among_tied_maxima():
    """Rows whose maximum is held by two or three positions, as bf16 logits
    can tie: the pull is split equally among them, as ``jax.grad`` of
    ``jnp.max`` splits it."""
    logits = np.round(_x(3, 4, 16, seed=7, scale=3.0))  # integers: ties within a row
    for row, cols in ((0, (2, 9)), (5, (0, 7, 15))):
        flat = logits.reshape(-1, 16)
        flat[row, list(cols)] = flat[row].max() + 1.0
    w = _x(3, 4, seed=8)
    ties = (logits == logits.max(-1, keepdims=True)).sum(-1)
    assert ties.max() >= 3 and (ties >= 2).sum() >= 2

    def f(lg):
        return jl.l2_warp(jnp.sum(lg[..., 0] * w), lg, weight=0.1)

    ref_g = jax.grad(f)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    tl.l2_warp((lt[..., 0] * torch.from_numpy(w)).sum(), lt, weight=0.1).backward()
    assert_close("l2 warp dlogits at ties", np.asarray(ref_g), lt.grad, TOL)


TINY = dict(hidden_size=64, num_hidden_layers=2, num_heads=2, vocab_size=50, chunk_size=16)


def _lm(**over):
    cfg = dict(TINY, **over)
    jax_model = JaxLM(JaxConfig(**cfg))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(11)

    def draw(path, leaf):  # mixing matrices U(0.2, 1), other 2-D leaves N(0, 0.2), norms ~1
        if "mixing_matrix" in jax.tree_util.keystr(path):
            return rng.uniform(0.2, 1.0, leaf.shape).astype(np.float32)
        if leaf.ndim == 2:
            return rng.normal(0.0, 0.2, leaf.shape).astype(np.float32)
        return (1.0 + rng.normal(0.0, 0.1, leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    port = MHLAForCausalLM(MHLALMConfig(**cfg))
    port.load_state_dict(params_from_jax(params, port.config))
    return jax_model, jax.tree_util.tree_map(jnp.asarray, params), port


@pytest.mark.parametrize("tied", [True, False])
def test_fused_lm_loss_matches_jax(tied):
    """``fused_lm_loss`` (hidden states against ``unembedding_weight`` in
    chunks of 16 rows) against JAX's and against the port's loss on the
    materialized logits, with the parameters' gradients equal to the
    latter's."""
    jax_model, jp, port = _lm(tie_word_embeddings=tied)
    ids = np.random.default_rng(12).integers(0, 50, (2, 30)).astype(np.int32)
    w = unembedding_weight(port)
    assert w.shape == (50, 64)
    assert (w is port.model.embeddings.weight) == tied
    ref = jax_fused_lm_loss(jax_model, jp, jnp.asarray(ids), chunk_size=16)
    tids = torch.from_numpy(ids).long()
    loss = fused_lm_loss(port, tids, chunk_size=16)
    assert_close("fused LM loss", np.asarray(ref), loss, TOL)
    loss.backward()
    fused = {n: p.grad.clone() for n, p in port.named_parameters()}
    port.zero_grad()
    plain, _ = lm_train.lm_loss(port, tids)
    assert_close("fused vs materialized loss", plain, loss, TOL)
    plain.backward()
    for name, p in port.named_parameters():
        assert_close(f"fused LM loss d{name}", p.grad, fused[name], TOL)


def test_lm_loss_applies_l2_warp_where_jax_does(tmp_path):
    """With ``use_l2warp`` the train step's loss is JAX's: l2_warp on the
    materialized logits' cross-entropy; its gradients against ``jax.grad``
    of JAX's loss_fn; ``lm_train.main --model.use_l2warp=true`` trains."""
    jax_model, jp, port = _lm(use_l2warp=True)
    ids = np.random.default_rng(13).integers(0, 50, (2, 30)).astype(np.int32)

    def jax_loss(p):
        logits, _ = jax_model.apply(p, jnp.asarray(ids))
        return jl.l2_warp(jax_cross_entropy_loss(logits, jnp.asarray(ids)), logits)

    ref_g = jax.jit(jax.grad(jax_loss))(jp)
    loss, _ = lm_train.lm_loss(port, torch.from_numpy(ids).long())
    loss.backward()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_g), port.config)
    for name, p in port.named_parameters():
        assert_close(f"l2warp d{name}", want[name], p.grad, 1e-4)
    args = ["--device=cpu", "--model.use_l2warp=true", "--model.num_hidden_layers=1",
            "--model.hidden_size=64", "--model.num_heads=2", "--model.vocab_size=50",
            "--train.batch_size=2", "--train.seq_len=32", "--train.max_steps=2",
            "--train.log_interval=1", f"--work_dir={tmp_path}"]
    out = lm_train.main(args)
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))
