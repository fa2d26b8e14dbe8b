"""Softmax attention of the port in every form and the hybrid LM, held
against the JAX package on the CPU: ``sdpa`` (causal, window, mask,
segment ids, and the flash dispatch at 2,048 tokens through the plain K9 /
K9b mirror in its causal and segment-id forms), ``SelfAttention`` with
converted weights (GQA, qk-norm, qkv bias, segment RoPE, KV cache), hybrid
and all-softmax ``MHLAForCausalLM``s (logits and parameter gradients with
segment ids against ``jax.grad``), greedy generation of a hybrid, and the
trainer on packed rows with a reference-format model json. Inputs and
weights come from numpy with fixed seeds.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from mhla_tpu.layers import SelfAttention as JaxSelfAttention
from mhla_tpu.layers import sdpa as jax_sdpa
from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu.models import cross_entropy_loss as jax_cross_entropy_loss
from mhla_tpu.models import generate as jax_generate
from mhla_tpu.models.generation import _pad_softmax_caches as jax_pad_caches
from mhla_tpu_torch.kernels import flash_attention as flash
from mhla_tpu_torch.layers import attention
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    cross_entropy_loss,
    generate,
    params_from_jax,
)
from mhla_tpu_torch.models.generation import _pad_softmax_caches
from mhla_tpu_torch.train import lm_train
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32 on both sides, the same arithmetic in other summation orders
TOL = 1e-5
# float32 through the layers of a model, forward and backward: the bound of
# tests/test_torch_lm.py and tests/test_torch_grads.py
MODEL_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3))


def _docs(lengths_per_row, t):
    """[B, T] int32 document ids, the rest of a row one more document."""
    out = np.zeros((len(lengths_per_row), t), np.int32)
    for bi, lengths in enumerate(lengths_per_row):
        pos = 0
        for sid, n in enumerate(lengths):
            out[bi, pos:pos + n] = sid
            pos += n
        out[bi, pos:] = len(lengths)
    return out


def _forms(t):
    """The keyword arguments of each sdpa form at T tokens, as numpy."""
    seg = _docs([[t // 3, t // 4], [t // 2]], t)
    mask = np.random.default_rng(4).uniform(size=(2, 1, t, t)) < 0.7
    mask |= np.eye(t, dtype=bool)  # every row keeps a key
    return {
        "causal": {"causal": True},
        "window": {"causal": True, "window": 7},
        "mask": {"mask": mask},
        "segment": {"segment_ids": seg},
        "causal_segment": {"causal": True, "segment_ids": seg},
    }


@pytest.mark.parametrize("form", ["causal", "window", "mask", "segment", "causal_segment"])
def test_sdpa_forms_match_jax(form):
    """The plain product with each mask, at a length below the flash route."""
    kw = _forms(100)[form]
    q, k, v = _qkv(2, 100, 2, 64, seed=1)
    ref = jax_sdpa(*map(jnp.asarray, (q, k, v)), **{n: jnp.asarray(x) if isinstance(x, np.ndarray)
                                                     else x for n, x in kw.items()})
    out = attention.sdpa(*map(_t, (q, k, v)), **{n: _t(x) if isinstance(x, np.ndarray) else x
                                                  for n, x in kw.items()})
    assert_close(f"sdpa {form}", np.asarray(ref), out, TOL)


@pytest.mark.parametrize("form", ["causal", "segment", "causal_segment"])
def test_sdpa_flash_route_masked_forms_match_jax(form, monkeypatch):
    """At 2,048 tokens and head dim 128 sdpa takes the flash route (on the
    CPU the plain K9 mirror, and K9b's under autograd); the output and the
    ``jax.vjp`` gradients of JAX's sdpa with the same mask agree."""
    t = 2048
    kw = {n: x for n, x in _forms(t)[form].items()}
    seg = kw.get("segment_ids")
    q, k, v = _qkv(2, t, 1, 128, seed=2)
    w = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
    routed = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **k_: routed.append(k_) or flash.flash_attention(*a, **k_))
    jkw = {"causal": kw.get("causal", False),
           "segment_ids": None if seg is None else jnp.asarray(seg)}
    ref, vjp = jax.vjp(lambda *x: jax_sdpa(*x, **jkw), *map(jnp.asarray, (q, k, v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attention.sdpa(*leaves, causal=jkw["causal"], segment_ids=None if seg is None else _t(seg))
    (out * _t(w)).sum().backward()
    assert len(routed) == 1 and routed[0]["causal"] == jkw["causal"]
    assert_close(f"sdpa flash route {form}", np.asarray(ref), out.detach(), TOL)
    for name, r, x in zip("qkv", vjp(jnp.asarray(w)), leaves):
        assert_close(f"sdpa flash route grad {name} {form}", np.asarray(r), x.grad, TOL)


@pytest.mark.parametrize("form", ["causal", "segment", "causal_segment"])
def test_flash_attention_masked_forms_match_jax_flash_wrapper(form):
    """flash_attention's causal and segment-id forms against the JAX
    wrapper's CPU route, at a length that is a multiple of no tile, with
    one-token documents; the plain backward against ``jax.vjp`` of it."""
    t = 300
    seg = _docs([[1, 1, 150, 7], [299]], t)
    causal = form.startswith("causal")
    jseg = jnp.asarray(seg) if "segment" in form else None
    tseg = _t(seg) if "segment" in form else None
    q, k, v = _qkv(2, t, 2, 128, seed=5)
    w = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda *x: jax_flash_attention(*x, causal=causal, segment_ids=jseg),
                       *map(jnp.asarray, (q, k, v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = flash.flash_attention(*leaves, causal=causal, segment_ids=tseg)
    (out * _t(w)).sum().backward()
    assert_close(f"flash {form}", np.asarray(ref), out.detach(), TOL)
    for name, r, x in zip("qkv", vjp(jnp.asarray(w)), leaves):
        assert_close(f"flash grad {name} {form}", np.asarray(r), x.grad, TOL)


def _attn_pair(seed=7, **kw):
    """The JAX SelfAttention and the port's with one set of numpy weights."""
    jl = JaxSelfAttention(hidden_size=256, **kw)
    shapes = jax.eval_shape(jl.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 256)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(0, 0.1, s.shape) + (1.0 if len(s.shape) == 1 else 0.0)
                   ).astype(np.float32), shapes)
    port = attention.SelfAttention(hidden_size=256, **kw)
    sd = {}
    for name, tree in params["params"].items():
        for leaf, x in tree.items():
            sd[f"{name}.{'weight' if leaf in ('kernel', 'weight') else leaf}"] = (
                _t(x).T if leaf == "kernel" else _t(x))
    port.load_state_dict(sd)
    return jl, jax.tree_util.tree_map(jnp.asarray, params), port


@pytest.mark.parametrize("kw", [
    {"num_heads": 4, "num_kv_heads": 1},
    {"num_heads": 2, "qk_norm": True, "qkv_bias": True},
    {"num_heads": 2, "window_size": 9},
    {"num_heads": 2, "causal": False, "rope": False},
], ids=["gqa", "qk_norm_bias", "window", "bidirectional"])
def test_self_attention_matches_jax(kw):
    jl, params, port = _attn_pair(**kw)
    x = np.random.default_rng(8).normal(size=(2, 70, 256)).astype(np.float32)
    seg = _docs([[20, 30], [69]], 70)
    for ids in (None, seg):  # RoPE restarting per document with segment ids
        jseg = None if ids is None else jnp.asarray(ids)
        ref, _ = jl.apply(params, jnp.asarray(x), segment_ids=jseg)
        out, _ = port(_t(x), segment_ids=None if ids is None else _t(ids))
        assert_close(f"SelfAttention {kw} segments={ids is not None}", np.asarray(ref),
                     out.detach(), TOL)


def test_self_attention_cache_matches_jax():
    """A prefill of 40 tokens with the cache, the caches grown to 44 tokens,
    then four decode steps (mask ``pos <= offset + t - 1``)."""
    jl, params, port = _attn_pair(num_heads=2, qk_norm=True)
    x = np.random.default_rng(9).normal(size=(2, 44, 256)).astype(np.float32)
    ref, rc = jl.apply(params, jnp.asarray(x[:, :40]), use_cache=True)
    with torch.no_grad():
        out, c = port(_t(x[:, :40]), use_cache=True)
        assert_close("prefill", np.asarray(ref), out, TOL)
        (rc,), (c,) = jax_pad_caches([rc], 44), _pad_softmax_caches([c], 44)
        for i in range(40, 44):
            ref, rc = jl.apply(params, jnp.asarray(x[:, i:i + 1]), rc)
            out, c = port(_t(x[:, i:i + 1]), c)
            assert_close(f"decode {i}", np.asarray(ref), out, TOL)
    assert c[2] == int(rc[2]) == 44
    assert_close("k cache", np.asarray(rc[0]), c[0], TOL)


def _random_params(tree, seed=0):
    """Dense kernels N(0, 0.02), the embedding N(0, 0.5), norm weights
    1 + N(0, 0.1), mixing matrices U(0, 1), as tests/test_torch_lm.py."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "mixing_matrix" in name:
            x = rng.uniform(0.0, 1.0, leaf.shape)
        elif "embedding" in name:
            x = rng.normal(0.0, 0.5, leaf.shape)
        elif "kernel" in name:
            x = rng.normal(0.0, 0.02, leaf.shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, leaf.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


_HYBRID = dict(hidden_size=512, num_hidden_layers=3, num_heads=2, vocab_size=100,
               attn={"layers": [0, 2], "num_heads": 4})
_TRANSFORMER = dict(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100,
                    attn_extends="transformer")


def _lm_pair(over):
    jax_model = JaxLM(JaxConfig(**over))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params_np = _random_params(shapes)
    cfg = MHLALMConfig(**over)
    port = MHLAForCausalLM(cfg)
    port.load_state_dict(params_from_jax(params_np, cfg))
    return jax_model, params_np, cfg, port


@pytest.mark.parametrize("over", [_HYBRID, _TRANSFORMER], ids=["hybrid", "transformer"])
def test_lm_logits_and_gradients_with_segment_ids_match_jax(over):
    """A 3-layer hybrid (softmax, MHLA, softmax) and a 2-layer all-softmax
    model on packed rows: the logits and every parameter's gradient of the
    loss on the rows' targets."""
    jax_model, params_np, cfg, port = _lm_pair(over)
    t = 192
    ids = np.random.default_rng(10).integers(0, 100, (2, t)).astype(np.int32)
    seg = _docs([[64, 64], [128]], t)
    tgt = np.where(np.random.default_rng(11).uniform(size=(2, t)) < 0.9, ids, -100).astype(np.int32)

    def loss(p):
        logits, _ = jax_model.apply(p, jnp.asarray(ids), segment_ids=jnp.asarray(seg))
        return jax_cross_entropy_loss(logits, jnp.asarray(tgt)), logits

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params_np))
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), cfg)
    logits, _ = port(_t(ids).long(), segment_ids=_t(seg))
    out = cross_entropy_loss(logits, _t(tgt).long())
    out.backward()
    assert_close("logits", np.asarray(ref_logits), logits.detach(), MODEL_TOL)
    assert_close("loss", np.asarray(ref_loss), out.detach(), MODEL_TOL)
    grads = dict(port.named_parameters())
    assert set(grads) == set(ref)
    for name, g in ref.items():
        assert_close(f"grad {name}", g, grads[name].grad, MODEL_TOL)


def test_hybrid_greedy_generation_matches_jax():
    """12 greedy tokens after a 60-token prompt: the MHLA layer's decode
    crosses a chunk boundary while the softmax layers read their caches."""
    jax_model, params_np, cfg, port = _lm_pair(_HYBRID)
    ids = np.random.default_rng(12).integers(0, 100, (2, 60)).astype(np.int32)
    ref = jax_generate(jax_model, jax.tree_util.tree_map(jnp.asarray, params_np),
                       jnp.asarray(ids), max_new_tokens=12)
    out = generate(port.eval(), _t(ids).long(), max_new_tokens=12)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_lm_train_on_packed_rows_with_a_model_json_resumes(tmp_path):
    """``lm_train.main`` with a reference-format json of a hybrid and
    ``--train.varlen=true``: two steps, then a run that resumes at step 2
    and takes one more; ``from_json`` keeps the json's known keys."""
    path = tmp_path / "hybrid.json"
    path.write_text(json.dumps({**_HYBRID, "model_type": "mhla", "num_hidden_layers": 2}))
    cfg = MHLALMConfig.from_json(str(path))
    assert cfg.attn == _HYBRID["attn"] and cfg.num_hidden_layers == 2
    args = ["--device=cpu", f"--model_json={path}", "--train.varlen=true",
            "--train.batch_size=2", "--train.seq_len=256", "--train.log_interval=1",
            "--optimizer.warmup_steps=1", f"--work_dir={tmp_path}"]
    out = lm_train.main(args + ["--train.max_steps=2"])
    assert out["start_step"] == 0 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    assert type(out["model"].model.layers[0].attn).__name__ == "SelfAttention"
    more = lm_train.main(args + ["--train.max_steps=3"])
    assert more["start_step"] == 2 and len(more["losses"]) == 1
