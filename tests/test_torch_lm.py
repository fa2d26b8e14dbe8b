"""Port of the causal MHLA LM (layers, model, generation, weight bridge),
held against the JAX package on the CPU at a tiny size.

One set of weights, drawn with numpy from a fixed seed, goes into the JAX
model's flax tree and through ``params_from_jax`` into the port. The
config keeps Dk = 128 and Dv = 256 (hidden 512, 2 heads), the 340M head
geometry, with 2 layers and a vocabulary of 100.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu.models import cross_entropy_loss as jax_cross_entropy_loss
from mhla_tpu.models import generate as jax_generate
from mhla_tpu_torch.models import (
    MHLAForCausalLM,
    MHLALMConfig,
    cross_entropy_loss,
    generate,
    params_from_jax,
)
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

TINY = dict(hidden_size=512, num_hidden_layers=2, num_heads=2, vocab_size=100)
# float32 through 2 blocks: the same math on both sides in other summation
# orders (XLA vs ATen GEMMs); 2e-4 is the JAX package's own golden bound
# for a block against its reference (tests/test_parity_lm.py)
TOL = 1e-4


def _random_params(tree, seed: int = 0):
    """Draw every leaf of a flax tree of shapes with numpy: Dense kernels
    N(0, 0.02), the embedding N(0, 0.5), norm weights 1 + N(0, 0.1), mixing
    matrices U(0, 1) (the layer clamps them)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "mixing_matrix" in name:
            x = rng.uniform(0.0, 1.0, shape)
        elif "embedding" in name:
            x = rng.normal(0.0, 0.5, shape)
        elif "kernel" in name:
            x = rng.normal(0.0, 0.02, shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def models():
    jax_model = JaxLM(JaxConfig(**TINY))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params_np = _random_params(shapes)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    cfg = MHLALMConfig(**TINY)
    port = MHLAForCausalLM(cfg).eval()
    port.load_state_dict(params_from_jax(params_np, cfg))
    return jax_model, params, port


def _ids(b: int, t: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t)).astype(np.int32)


def test_logits_match_jax(models):
    """T = 130 crosses two chunk boundaries and pads the last chunk."""
    jax_model, params, port = models
    ids = _ids(2, 130)
    ref, _ = jax_model.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        out, _ = port(torch.from_numpy(ids).long())
    assert out.shape == (2, 130, TINY["vocab_size"])
    assert_close("LM logits", np.asarray(ref), out, TOL)
    labels = ids.copy()
    labels[:, -5:] = -100
    loss_ref = jax_cross_entropy_loss(ref, jnp.asarray(labels))
    loss = cross_entropy_loss(out, torch.from_numpy(labels).long())
    assert_close("LM loss", np.asarray(loss_ref), loss, TOL)


def test_prefill_and_decode_logits_match_jax(models):
    """Prefill 62 tokens with the cache, then decode 4 tokens one at a time
    across the 64-token chunk boundary: every step's logits and the final
    cache against the JAX model's."""
    jax_model, params, port = models
    ids = _ids(2, 66)
    ref_pre, ref_states = jax_model.apply(params, jnp.asarray(ids[:, :62]), use_cache=True)
    with torch.no_grad():
        out_pre, states = port(torch.from_numpy(ids[:, :62]).long(), use_cache=True)
        assert_close("prefill logits", np.asarray(ref_pre), out_pre, TOL)
        for i in range(62, 66):
            ref_step, ref_states = jax_model.apply(
                params, jnp.asarray(ids[:, i:i + 1]), ref_states, use_cache=True
            )
            out_step, states = port(torch.from_numpy(ids[:, i:i + 1]).long(), states,
                                    use_cache=True)
            assert_close(f"decode logits at {i}", np.asarray(ref_step), out_step, TOL)
    for layer, (ref_s, s) in enumerate(zip(ref_states, states)):
        assert s.recurrent.t == int(ref_s.recurrent.t) == 66
        for name in ("states", "mixed", "s_cur"):
            assert_close(f"layer {layer} cache {name}",
                         np.asarray(getattr(ref_s.recurrent, name)),
                         getattr(s.recurrent, name), TOL)


def test_greedy_generate_matches_jax(models):
    """8 greedy tokens after a 60-token prompt (decode crosses a chunk
    boundary), identical token for token."""
    jax_model, params, port = models
    ids = _ids(2, 60, seed=5)
    ref = jax_generate(jax_model, params, jnp.asarray(ids), max_new_tokens=8)
    out = generate(port, torch.from_numpy(ids).long(), max_new_tokens=8)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_generate_logits_equal_full_forward(models):
    """chunk == recurrent inside the port: the logits each new token was
    chosen from equal one chunked forward over prompt + generated tokens."""
    _, _, port = models
    ids = torch.from_numpy(_ids(2, 60, seed=6)).long()
    out, scores = generate(port, ids, max_new_tokens=8, output_scores=True)
    with torch.no_grad():
        full, _ = port(out[:, :-1])
    assert_close("generate vs full forward", full[:, 59:], scores, TOL)


def test_sampling_is_seeded(models):
    _, _, port = models
    ids = torch.from_numpy(_ids(1, 20)).long()
    runs = [
        generate(port, ids, max_new_tokens=6, temperature=0.8, top_k=10,
                 generator=torch.Generator().manual_seed(7))
        for _ in range(2)
    ]
    assert torch.equal(runs[0], runs[1])


def test_generate_eos_and_stop_fn(models):
    """After a row emits eos every later token is eos (as JAX's loop does);
    stop_fn ends the loop early."""
    _, _, port = models
    ids = torch.from_numpy(_ids(2, 20, seed=8)).long()
    free = generate(port, ids, max_new_tokens=6)
    eos = int(free[0, 21])  # row 0's second new token
    out = generate(port, ids, max_new_tokens=6, eos_token_id=eos)
    first = (out[0, 20:] == eos).nonzero()[0, 0] + 20
    assert torch.all(out[0, first:] == eos)
    assert torch.equal(out[:, :first + 1], free[:, :first + 1])
    short = generate(port, ids, max_new_tokens=6, stop_fn=lambda seq: seq.shape[1] >= 23)
    assert short.shape == (2, 23) and torch.equal(short, free[:, :23])


def test_untied_lm_head_matches_jax():
    cfg = dict(hidden_size=64, num_hidden_layers=1, num_heads=2, vocab_size=50,
               tie_word_embeddings=False)
    jax_model = JaxLM(JaxConfig(**cfg))
    params_np = _random_params(
        jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    )
    port = MHLAForCausalLM(MHLALMConfig(**cfg)).eval()
    port.load_state_dict(params_from_jax(params_np, MHLALMConfig(**cfg)))
    ids = _ids(2, 70) % 50
    ref, _ = jax_model.apply(jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(ids))
    with torch.no_grad():
        out, _ = port(torch.from_numpy(ids).long())
    assert_close("untied LM logits", np.asarray(ref), out, TOL)


def test_generate_context_bound_raises(models):
    _, _, port = models
    ids = torch.zeros(1, 2040, dtype=torch.long)
    with pytest.raises(ValueError, match="context bound"):
        generate(port, ids, max_new_tokens=9)  # 2049 > 32 slots x 64


def test_config_defaults_equal_340m_yaml():
    """MHLALMConfig() is the 340M model: no yaml reader on the card."""
    path = Path(__file__).resolve().parents[1] / "configs" / "mhla_340m.yaml"
    model_cfg = yaml.safe_load(path.read_text())["model"]
    cfg = MHLALMConfig()
    for key, value in model_cfg.items():
        assert getattr(cfg, key) == value, key
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for f in dataclasses.fields(MHLALMConfig):
        if f.name != "dtype":
            assert f.default == jax_fields[f.name], f.name
    assert cfg.num_slots == 32 and cfg.max_context == 2048


@pytest.mark.parametrize(
    "kv_heads,gate,fmap",
    [(None, True, "relu"), (1, True, "elu"), (None, False, "identity"), (None, True, "softmax")],
)
def test_mhla_causal_layer_matches_jax(kv_heads, gate, fmap):
    """One attention layer, prefill with cache then two decode steps, with
    GQA, the ungated output norm and the non-flat feature maps."""
    from mhla_tpu.layers import MHLACausal as JaxLayer
    from mhla_tpu_torch.layers import MHLACausal

    kw = dict(hidden_size=64, num_heads=2, num_kv_heads=kv_heads, feature_map=fmap,
              use_output_gate=gate, chunk_size=16, num_slots=8)
    jax_layer = JaxLayer(**kw)
    x = np.random.default_rng(4).standard_normal((2, 40, 64)).astype(np.float32)
    params = _random_params(
        jax.eval_shape(jax_layer.init, jax.random.PRNGKey(0), jnp.asarray(x[:, :8]))
    )
    layer = MHLACausal(**kw).eval()
    sd = {}
    for name, value in params["params"].items():
        if isinstance(value, dict) and "kernel" in value:
            sd[f"{name}.weight"] = torch.from_numpy(value["kernel"].T.copy())
        elif isinstance(value, dict):
            sd[f"{name}.weight"] = torch.from_numpy(value["weight"])
        else:
            sd[name] = torch.from_numpy(value)
    layer.load_state_dict(sd)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    ref, ref_state = jax_layer.apply(jparams, jnp.asarray(x[:, :38]), use_cache=True)
    with torch.no_grad():
        out, state = layer(torch.from_numpy(x[:, :38]), use_cache=True)
        assert_close("layer prefill", np.asarray(ref), out, TOL)
        for i in (38, 39):
            ref, ref_state = jax_layer.apply(jparams, jnp.asarray(x[:, i:i + 1]), ref_state,
                                             use_cache=True)
            out, state = layer(torch.from_numpy(x[:, i:i + 1]), state, use_cache=True)
            assert_close(f"layer decode {i}", np.asarray(ref), out, TOL)


@pytest.mark.parametrize(
    "over,call",
    [
        ({"attn_extends": "linear_attn"}, {"segment_ids"}),
        ({"attn_extends": "mamba2"}, {"segment_ids"}),
        ({"tp_mesh": object()}, {}),
        ({"attn_extends": "mamba"}, {"segment_ids"}),
    ],
)
def test_unported_options_raise(over, call):
    """Tensor parallelism, and packed documents (segment ids) in the
    families that JAX's block refuses them in."""
    cfg = MHLALMConfig(**{**TINY, "num_hidden_layers": 1, **over})
    with pytest.raises(NotImplementedError):
        model = MHLAForCausalLM(cfg)
        ids = torch.zeros(1, 8, dtype=torch.long)
        kwargs = {name: torch.ones(1, 8, dtype=torch.long) for name in call}
        model(ids, **kwargs)
