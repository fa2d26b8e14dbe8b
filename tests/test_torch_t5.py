"""Port of the umT5 text encoder and the prompt tokenizer
(``mhla_tpu_torch/models/t5.py``, ``mhla_tpu_torch/data/tokenizers.py``),
held against the JAX package on the CPU at a tiny size.

One set of weights, drawn with numpy from a fixed seed, goes into the JAX
module's flax tree and through ``t5_params_from_jax`` into the port; the
converters of HF UMT5 and of the reference's naming give bit-equal trees;
``T5TextEncoder`` reads a directory with a tokenizer built here in memory.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.data import tokenizers as jax_tokenizers
from mhla_tpu.models import t5 as jax_t5
from mhla_tpu_torch.data import tokenizers
from mhla_tpu_torch.models import t5
from mhla_tpu_torch.models.convert_jax import t5_params_from_jax
from mhla_tpu_torch.utils import assert_close
from t2v_fixtures import (assert_trees_equal, random_params, save_tokenizer,
                          t5_reference_state)

os.environ.setdefault("HF_HUB_OFFLINE", "1")

# float32 through 2 blocks: the same math in other summation orders
TOL = 1e-5
# test_encoders.py's TINY_T5 (its vocabulary holds the tokenizer's ids)
TINY = dict(vocab_size=64, dim=32, dim_attn=32, dim_ffn=48, num_heads=4,
            num_layers=2, num_buckets=8)


def _configs(**extra):
    return jax_t5.T5Config(**TINY, **extra), t5.T5Config(**TINY, **extra)


def _jax_params(cfg, seed=0):
    shapes = jax.eval_shape(lambda: jax_t5.T5Encoder(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return random_params(shapes, seed)


def _ids_and_mask(seed=1, b=3, length=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (b, length)).astype(np.int32)
    lens = [length, 7, 1][:b]
    mask = (np.arange(length)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_matches_jax(bidirectional):
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 40)[:, None]
    for buckets, dist in ((32, 128), (8, 16)):
        np.testing.assert_array_equal(
            t5.relative_position_bucket(rel, buckets, dist, bidirectional),
            jax_t5.relative_position_bucket(rel, buckets, dist, bidirectional))


@pytest.mark.parametrize("shared_pos", [False, True], ids=["per_layer", "shared"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
def test_t5_encoder_matches_jax(shared_pos, with_mask):
    """Unscaled attention, the -1e9 mask bias, the float32 softmax, the tanh
    GELU and the relative embeddings (umT5's per layer, or one shared)."""
    jcfg, cfg = _configs(shared_pos=shared_pos)
    params = _jax_params(jcfg)
    ids, mask = _ids_and_mask()
    ref = jax_t5.T5Encoder(jcfg).apply(jax.tree_util.tree_map(jnp.asarray, params),
                                       jnp.asarray(ids), jnp.asarray(mask) if with_mask else None)
    port = t5.T5Encoder(cfg).eval()
    port.load_state_dict(t5_params_from_jax(params))  # strict: every key, every shape
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long(), torch.from_numpy(mask) if with_mask else None)
    assert out.shape == (3, 12, 32) and out.dtype == torch.float32
    assert_close("T5Encoder", np.asarray(ref), out, TOL)


def test_masked_keys_do_not_reach_unmasked_positions():
    _, cfg = _configs()
    model = t5.init_t5_params(t5.T5Encoder(cfg), torch.Generator().manual_seed(0)).eval()
    ids, mask = _ids_and_mask()
    ids2 = ids.copy()
    ids2[1, 7:] = 0
    with torch.no_grad():
        a = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        b = model(torch.from_numpy(ids2).long(), torch.from_numpy(mask))
    torch.testing.assert_close(a[1, :7], b[1, :7], rtol=0, atol=0)
    assert not torch.equal(a[1, 7:], b[1, 7:])


def test_init_t5_params_follows_the_flax_distributions():
    cfg = t5.T5Config(**{**TINY, "vocab_size": 4000, "dim": 64, "dim_attn": 64,
                         "dim_ffn": 256})
    model = t5.init_t5_params(t5.T5Encoder(cfg), torch.Generator().manual_seed(0))
    assert abs(model.token_embedding.weight.std().item() - 1.0) < 0.02
    w = model.blocks[0].ffn_fc2.weight  # fan_in 256
    assert abs(w.std().item() - 256**-0.5) < 0.1 * 256**-0.5
    assert w.abs().max().item() <= 2 * 256**-0.5 / 0.8796256610342398 + 1e-6
    pos = model.blocks[1].pos_embedding.weight
    assert abs(pos.std().item() - (2 * 8 * 4) ** -0.5) < 0.4 * (2 * 8 * 4) ** -0.5
    assert torch.equal(model.norm.weight, torch.ones(64))


def _hf_state(cfg, seed=3):
    """A HuggingFace UMT5 encoder state dict of ``cfg``'s shapes, numpy."""
    rng = np.random.default_rng(seed)
    d, f = cfg.dim, cfg.dim_ffn
    state = {"shared.weight": rng.normal(size=(cfg.vocab_size, d)),
             "encoder.final_layer_norm.weight": 1 + 0.1 * rng.normal(size=d)}
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}.layer."
        state.update({
            p + "0.layer_norm.weight": 1 + 0.1 * rng.normal(size=d),
            p + "1.layer_norm.weight": 1 + 0.1 * rng.normal(size=d),
            **{f"{p}0.SelfAttention.{n}.weight": rng.normal(size=(d, d)) * d**-0.5
               for n in "qkvo"},
            p + "0.SelfAttention.relative_attention_bias.weight":
                0.1 * rng.normal(size=(cfg.num_buckets, cfg.num_heads)),
            p + "1.DenseReluDense.wi_0.weight": rng.normal(size=(f, d)) * d**-0.5,
            p + "1.DenseReluDense.wi_1.weight": rng.normal(size=(f, d)) * d**-0.5,
            p + "1.DenseReluDense.wo.weight": rng.normal(size=(d, f)) * f**-0.5,
        })
    return {k: v.astype(np.float32) for k, v in state.items()}


def test_convert_hf_umt5_is_bit_equal_to_jax():
    jcfg, cfg = _configs()
    state = _hf_state(cfg)
    assert_trees_equal(t5.convert_hf_umt5(state, cfg), jax_t5.convert_hf_umt5(state, jcfg))


@pytest.mark.parametrize("shared_pos", [False, True], ids=["per_layer", "shared"])
def test_convert_t5_checkpoint_is_bit_equal_to_jax(shared_pos):
    jcfg, cfg = _configs(shared_pos=shared_pos)
    state = t5_reference_state(cfg)
    tree = t5.convert_t5_checkpoint(state, cfg)
    assert_trees_equal(tree, jax_t5.convert_t5_checkpoint(state, jcfg))
    port = t5.T5Encoder(cfg)
    port.load_state_dict(t5_params_from_jax(tree))  # strict


def test_hf_umt5_weights_give_hf_encodings():
    """HF's own UMT5 encoder and the port on its converted weights."""
    from transformers import UMT5Config, UMT5EncoderModel

    _, cfg = _configs()
    hf_cfg = UMT5Config(vocab_size=cfg.vocab_size, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                        num_heads=4, relative_attention_num_buckets=8,
                        feed_forward_proj="gated-gelu", is_encoder_decoder=False,
                        use_cache=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = UMT5EncoderModel(hf_cfg).eval()
    ids, mask = _ids_and_mask()
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask)).last_hidden_state
    state = {k: v.numpy() for k, v in hf.state_dict().items()}
    port = t5.T5Encoder(cfg).eval()
    port.load_state_dict(t5_params_from_jax(t5.convert_hf_umt5(state, cfg)))
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    valid = torch.from_numpy(mask).bool()
    assert_close("HF UMT5", ref[valid], out[valid], 5e-4)


def _t5_dir(tmp_path, form: str, cfg):
    d = tmp_path / f"t5_{form}"
    d.mkdir()
    save_tokenizer(d / "tokenizer")
    (d / "config.json").write_text(
        '{"vocab_size": %d, "dim": 32, "dim_attn": 32, "dim_ffn": 48, "num_heads": 4, '
        '"num_layers": 2, "num_buckets": 8}' % cfg.vocab_size)
    if form == "pth":
        torch.save({k: torch.from_numpy(v) for k, v in t5_reference_state(cfg).items()},
                   d / "umt5.pth")
    else:
        from safetensors.numpy import save_file

        save_file(_hf_state(cfg), str(d / "model.safetensors"))
    return d


PROMPTS = ["a red kite over the dunes", "  a tram   at night  ", "a boat &amp; rain"]


@pytest.mark.parametrize("form", ["pth", "safetensors"])
def test_t5_text_encoder_matches_jax(tmp_path, form):
    """The same directory through both packages' ``T5TextEncoder``: the
    embeddings agree and are zero past each prompt's length."""
    _, cfg = _configs()
    d = _t5_dir(tmp_path, form, cfg)
    ref = np.asarray(jax_t5.T5TextEncoder(str(d), text_len=10)(PROMPTS + [""]))
    enc = t5.T5TextEncoder(str(d), text_len=10)
    out = enc(PROMPTS + [""])
    assert out.shape == (4, 10, 32) and out.dtype == torch.float32
    _, mask = enc.tokenizer(PROMPTS + [""], return_mask=True)
    assert mask.sum(1).tolist() == [7, 5, 5, 1]  # eos included; "&amp;" -> "&", unknown
    assert torch.all(out[torch.from_numpy(mask) == 0] == 0)
    assert_close(f"T5TextEncoder ({form})", ref, out, TOL)


def test_flax_msgpack_weights_raise(tmp_path):
    _, cfg = _configs()
    d = _t5_dir(tmp_path, "pth", cfg)
    (d / "params.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="msgpack"):
        t5.T5TextEncoder(str(d), text_len=10)


def test_t5_dir_without_weights_raises(tmp_path):
    with pytest.raises(FileNotFoundError):  # before the (here umT5-XXL) model is built
        t5.T5TextEncoder(str(tmp_path), text_len=10)


TEXTS = ["  A tram &amp;amp; the   night\t", "snake_case words, with: punctuation!",
         "keep-this-dash and_that", ""]


@pytest.mark.parametrize("fn", ["basic_clean", "whitespace_clean", "canonicalize"])
def test_cleaning_matches_jax(fn):
    for text in TEXTS:
        assert getattr(tokenizers, fn)(text) == getattr(jax_tokenizers, fn)(text)
    assert tokenizers.canonicalize(TEXTS[2], "-") == jax_tokenizers.canonicalize(TEXTS[2], "-")


@pytest.mark.parametrize("clean", [None, "whitespace", "lower", "canonicalize"])
def test_prompt_tokenizer_matches_jax(tmp_path, clean):
    path = str(save_tokenizer(tmp_path / "tok"))
    texts = ["A red KITE over dunes", "  tram_at   night ", "a boat drifting down " * 4]
    ref = jax_tokenizers.PromptTokenizer(path, seq_len=8, clean=clean)(texts, return_mask=True)
    tok = tokenizers.PromptTokenizer(path, seq_len=8, clean=clean)
    out = tok(texts, return_mask=True)
    for a, b in zip(ref, out):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tok("a red kite"), tok(["a red kite"]))


def test_prompt_tokenizer_names_a_missing_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tokenizers.PromptTokenizer("anything", seq_len=8)
    with pytest.raises(ValueError):
        tokenizers.PromptTokenizer("anything", clean="upper")
