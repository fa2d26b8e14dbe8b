"""The port's LoRA (``mhla_tpu_torch.train.lora``) and its place in the video
trainer, held against ``mhla_tpu.train.lora`` on the CPU at a tiny size.

The JAX package keeps the factors in a tree that mirrors the parameters
(``{"a": [in, r], "b": [r, out]}`` at each targeted ``kernel``); the port
keeps them by the name of the ``weight`` they belong to, in the same
orientation. Weights and factors come from numpy and go to both packages.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels import mhla_chunk_pallas
from mhla_tpu.train import lora as jax_lora
from mhla_tpu_torch.models import wan_params_from_jax
from mhla_tpu_torch.train import (
    OptimizerConfig,
    apply_lora,
    init_lora,
    init_train_state,
    lora_param_count,
    lora_state,
    make_train_step,
    merge_lora,
    wan_train,
)
from mhla_tpu_torch.utils import assert_close
from mhla_tpu_torch.utils.checkpoint import load_checkpoint, resolve_resume_path

from wan_train_fixtures import SPARSE, SPARSE_LATENT, _batch, _jax_batch, _jax_loss, _models
from wan_train_fixtures import _port_loss, _torch_batch, _TINY_ARGS
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

RANK, ALPHA = 4, 8.0


@pytest.fixture(autouse=True)
def _force_interpret():
    mhla_chunk_pallas.FORCE_INTERPRET = True
    yield
    mhla_chunk_pallas.FORCE_INTERPRET = False


def _lora_from_jax(tree, prefix=""):
    """A JAX LoRA tree (``None`` or ``{"a", "b"}`` in place of each leaf) ->
    the port's mapping, under the names ``wan_params_from_jax`` gives the
    weights; the factors carry over untransposed."""
    out = {}
    for key, value in tree.items():
        name = key.replace("blocks_", "blocks.") if key.startswith("blocks_") else key
        if value is None:
            continue
        if set(value) == {"a", "b"} and not isinstance(value["a"], dict):
            assert key == "kernel"
            out[f"{prefix}weight"] = {k: torch.from_numpy(np.array(v)) for k, v in value.items()}
        else:
            out.update(_lora_from_jax(value, f"{prefix}{name}."))
    return out


def _random_jax_lora(params, seed):
    """The JAX package's LoRA tree for ``params`` with both factors drawn
    from numpy (a zero B would hide A and the orientation)."""
    rng = np.random.default_rng(seed)
    tree = jax_lora.init_lora(params, jax.random.PRNGKey(0), RANK)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.1), tree)


def test_init_lora_targets_the_same_weights_as_jax():
    """q, k, v and o of every self- and cross-attention, MHLA and softmax
    alike, and nothing else; A normal / rank, B zero."""
    _, params, port = _models(SPARSE, seed=1, latent=SPARSE_LATENT)
    ref = _lora_from_jax(jax_lora.init_lora(params, jax.random.PRNGKey(0), RANK)["params"])
    ours = init_lora(dict(port.named_parameters()), torch.Generator().manual_seed(0), RANK)
    assert set(ours) == set(ref) and len(ours) == 3 * 2 * 4
    assert all(name.rsplit(".", 2)[-2] in "qkvo" for name in ours)
    for name, f in ours.items():
        n_out, n_in = port.get_parameter(name).shape
        assert f["a"].shape == ref[name]["a"].shape == (n_in, RANK), name
        assert f["b"].shape == ref[name]["b"].shape == (RANK, n_out), name
        assert not f["b"].any() and not ref[name]["b"].any()
        assert 0.5 / RANK < f["a"].std() < 2.0 / RANK
    n = sum(a["a"].numel() + a["b"].numel() for a in ours.values())
    assert lora_param_count(ours) == n == jax_lora.lora_param_count(
        jax_lora.init_lora(params, jax.random.PRNGKey(0), RANK))
    assert init_lora(dict(port.named_parameters()), torch.Generator().manual_seed(0), RANK,
                     targets=("ffn_fc1",)).keys() == {f"blocks.{i}.ffn_fc1.weight" for i in range(3)}


def test_merge_lora_matches_jax_and_fixes_the_orientation():
    """JAX's A and B carried across untransposed give JAX's merged weights:
    ``W + (alpha / rank) * (A @ B).T`` on ``[out, in]`` weights. The model's
    targets are square, so a toy projection that is not checks the shapes."""
    _, params, port = _models(SPARSE, seed=2, latent=SPARSE_LATENT)
    tree = _random_jax_lora(params, seed=3)
    want = wan_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_lora.merge_lora(params, tree, ALPHA)))
    lora = _lora_from_jax(tree["params"])
    got = merge_lora(port.state_dict(), lora, ALPHA)
    assert set(got) == set(want)
    for name, w in got.items():
        if name in lora:
            assert_close(name, want[name], w, 1e-6)
            assert not torch.equal(w, port.state_dict()[name])
        else:
            assert w is port.state_dict()[name] or torch.equal(w, port.state_dict()[name])

    rng = np.random.default_rng(4)
    kernel, a, b = (rng.normal(size=s).astype(np.float32) for s in ((3, 5), (3, RANK), (RANK, 5)))
    ref = jax_lora.merge_lora({"x": {"q": {"kernel": jnp.asarray(kernel)}}},
                              {"x": {"q": {"kernel": {"a": jnp.asarray(a), "b": jnp.asarray(b)}}}},
                              ALPHA)["x"]["q"]["kernel"]
    toy = merge_lora({"x.q.weight": torch.from_numpy(kernel.T.copy())},
                     {"x.q.weight": {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}}, ALPHA)
    assert toy["x.q.weight"].shape == (5, 3)
    assert_close("toy [out, in]", np.asarray(ref).T, toy["x.q.weight"], 1e-6)
    bf = merge_lora({"x.q.weight": torch.from_numpy(kernel.T.copy()).bfloat16()},
                    {"x.q.weight": {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}}, ALPHA)
    assert bf["x.q.weight"].dtype == torch.bfloat16  # summed in float32, cast to W's dtype
    with pytest.raises(KeyError):
        merge_lora({"x.q.weight": torch.zeros(5, 3)}, {"y.q.weight": {"a": a, "b": b}})


def test_zero_b_start_is_a_no_op_and_only_adapters_want_gradients():
    _, _, base = _models(SPARSE, seed=5, latent=SPARSE_LATENT)
    _, _, port = _models(SPARSE, seed=5, latent=SPARSE_LATENT)
    apply_lora(port, torch.Generator().manual_seed(0), RANK, ALPHA)
    z, ctx, t01, _, _ = _torch_batch(_batch(6, latent=SPARSE_LATENT))
    with torch.no_grad():
        assert torch.equal(port(z, t01 * 1000.0, ctx), base(z, t01 * 1000.0, ctx))
    trainable = {n for n, p in port.named_parameters() if p.requires_grad}
    assert trainable == {f"{n[:-len('.weight')]}.parametrizations.weight.0.{f}"
                         for n in lora_state(port) for f in "ab"}
    frozen = {n.replace(".parametrizations.weight.original", ".weight"): p
              for n, p in port.named_parameters() if not p.requires_grad}
    assert set(frozen) == set(base.state_dict())
    assert all(torch.equal(p, base.state_dict()[n]) for n, p in frozen.items())
    # the weight a layer reads is merge_lora of the frozen weight and its factors
    with torch.no_grad():
        for f in lora_state(port).values():
            f["b"].normal_(generator=torch.Generator().manual_seed(1))
        merged = merge_lora(base.state_dict(), lora_state(port), ALPHA)
        for name in lora_state(port):
            assert torch.equal(port.get_submodule(name[:-len(".weight")]).weight, merged[name])
    with pytest.raises(ValueError):
        apply_lora(base, torch.Generator().manual_seed(0), targets=("no_such_layer",))


def test_adapter_gradients_match_jax_grad():
    """The training loss differentiated in the LoRA tree (base frozen, remat
    on, one radial-sparse layer), with JAX's factors carried across."""
    jax_model, params, port = _models(SPARSE, seed=7, remat=True, latent=SPARSE_LATENT)
    tree = _random_jax_lora(params, seed=8)
    batch = _batch(9, latent=SPARSE_LATENT)
    loss = _jax_loss(jax_model, jnp.float32)
    ref_loss, ref = jax.value_and_grad(
        lambda lo: loss(jax_lora.merge_lora(params, lo, ALPHA), _jax_batch(batch))[0])(tree)
    want = _lora_from_jax(jax.tree_util.tree_map(np.asarray, ref)["params"])
    apply_lora(port, torch.Generator().manual_seed(0), RANK, ALPHA)
    mine = lora_state(port)
    with torch.no_grad():
        for name, f in _lora_from_jax(tree["params"]).items():
            mine[name]["a"].copy_(f["a"])
            mine[name]["b"].copy_(f["b"])
    got_loss, _ = _port_loss(port, _torch_batch(batch))
    got_loss.backward()
    assert_close("loss", np.asarray(ref_loss), got_loss.detach(), 1e-5)
    for name, f in mine.items():
        for which in "ab":
            assert_close(f"d {name} {which}", want[name][which], f[which].grad, 1e-4)
    assert all(p.grad is None for p in port.parameters() if not p.requires_grad)


def test_three_lora_steps_move_only_the_adapters_and_the_loss_falls(tmp_path):
    """The trainer over a LoRA model: the optimizer, the EMA and the
    checkpoint hold the adapters alone, the base stays bit for bit, B leaves
    zero, and on a repeated batch with fixed noise the loss falls."""
    _, _, port = _models(SPARSE, seed=10, remat=True, latent=SPARSE_LATENT)
    base = {n: p.detach().clone() for n, p in port.named_parameters()}
    apply_lora(port, torch.Generator().manual_seed(0), RANK, ALPHA)
    opt = OptimizerConfig(learning_rate=2e-3, weight_decay=0.0, grad_clip=None, warmup_steps=0,
                          total_steps=10)
    state = init_train_state(port, opt, ema=True)
    n_adapters = 2 * len(lora_state(port))
    assert len(state.optimizer.params) == len(state.ema) == n_adapters
    step = make_train_step(_port_loss, ema_decay=0.5)
    batch = _torch_batch(_batch(11, latent=SPARSE_LATENT))
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[2] < losses[1] < losses[0]
    for name, p in port.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, base[name.replace(".parametrizations.weight.original",
                                                    ".weight")]), name
    assert all(f["b"].abs().max() > 0 for f in lora_state(port).values())
    assert all(not torch.equal(state.ema[n], p) for n, p in port.named_parameters()
               if p.requires_grad and n.endswith(".b"))

    from mhla_tpu_torch.utils.checkpoint import save_checkpoint

    path = save_checkpoint(str(tmp_path), 3, state)
    saved = torch.load(f"{path}/state.pt", weights_only=True)
    assert len(saved["model"]) == len(saved["ema"]) == n_adapters
    assert all(".parametrizations.weight.0." in n for n in saved["model"])
    _, _, again = _models(SPARSE, seed=10, remat=True, latent=SPARSE_LATENT)
    apply_lora(again, torch.Generator().manual_seed(1), RANK, ALPHA)  # other factors
    restored = load_checkpoint(path, init_train_state(again, opt, ema=True))
    for (name, a), (_, b) in zip(port.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), name
        if a.requires_grad:
            assert torch.equal(state.ema[name], restored.ema[name]), name
    plain, _ = wan_train.build_model(wan_train.parse_cli(wan_train.WanTrainConfig, _LORA_ARGS))
    with pytest.raises(RuntimeError):  # a checkpoint of adapters does not fit a plain model
        load_checkpoint(path, init_train_state(plain, opt))


_LORA_ARGS = _TINY_ARGS + ["--model.num_layers=2", "--model.linear_attn_idx=(0,)",
                           "--lora.enable=true", "--lora.rank=4"]


def test_wan_lora_smoke(tmp_path):
    """``wan_train.main`` with LoRA at the sizes of the JAX package's
    ``TestLoRATrain``, with a radial-sparse softmax layer besides: finite
    loss, adapters alone in the checkpoint, validation sampling through the
    merged EMA adapters, and a resumed run that picks the adapters up."""
    args = _LORA_ARGS + [f"--work_dir={tmp_path}/wan_lora", "--model.sparse_attn_idx=(1,)",
                         "--train.eval_sampling_steps=2", "--train.eval_solver_steps=2"]
    out = wan_train.main(args + ["--train.max_steps=2"])
    assert math.isfinite(out["final_loss"]) and len(out["losses"]) == 2
    model = out["model"]
    assert [b.attn_type for b in model.blocks] == ["mhla_uni", "sparse"]
    n_lora = lora_param_count(lora_state(model))
    assert n_lora == 2 * 2 * 4 * 2 * 48 * 4  # layers x attentions x projections x (A, B) x dim x rank
    assert out["params"] == sum(p.numel() for p in model.parameters()) - n_lora
    lat = np.load(tmp_path / "wan_lora" / "validation" / "step_000002.npy")
    assert lat.shape == (1, 4, 8, 8, 4) and np.isfinite(lat).all()
    path = resolve_resume_path(str(tmp_path / "wan_lora"))
    saved = torch.load(f"{path}/state.pt", weights_only=True)
    assert sum(t.numel() for t in saved["model"].values()) == n_lora
    assert out["checkpoint_bytes"] < 40 * n_lora  # factors, two moments, EMA; no base weight
    again = wan_train.main(args + ["--train.max_steps=3"])
    assert again["start_step"] == 2 and len(again["losses"]) == 1
    resumed = lora_state(again["model"])
    assert all(f["b"].abs().max() > 0 for f in resumed.values())
