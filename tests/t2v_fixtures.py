"""Shared pieces of the text-to-video tests: a word-level tokenizer built
in memory and saved as a HuggingFace tokenizer directory, the random param
tree draw, a recursive tree comparison and a T5 state dict in the
reference's naming."""

from pathlib import Path

import jax
import numpy as np

WORDS = ("a red kite over dunes tram at night the boat drifting down rain filled gutter "
         "of and in on with").split()


def save_tokenizer(directory: Path) -> Path:
    """A word-level tokenizer over ``WORDS`` (pad 0, eos 1, unk 2; each text
    ends with eos, as umT5's does), saved for ``AutoTokenizer``."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, **{w: i + 3 for i, w in enumerate(WORDS)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
                                   unk_token="<unk>")
    fast.save_pretrained(str(directory))
    return directory


def random_params(tree, seed: int = 0, scale: float = 1.0):
    """Draw every leaf of a flax tree of shapes with numpy: kernels
    N(0, scale^2 / fan_in), biases N(0, 0.02), embeddings N(0, 1), norm
    weights and gammas 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            x = rng.normal(0.0, scale * np.prod(leaf.shape[:-1]) ** -0.5, leaf.shape)
        elif "bias" in name:
            x = rng.normal(0.0, 0.02, leaf.shape)
        elif "embedding" in name or "modulation" in name:
            x = rng.normal(0.0, 1.0 if "token" in name else 0.1, leaf.shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, leaf.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def assert_trees_equal(a, b, path="") -> None:
    """Same keys at every level and bit-equal leaves of the same dtype and shape."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"{path}: {sorted(a)} vs {sorted(b)}"
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=path)


def t5_reference_state(cfg, seed=4):
    """A state dict in the reference's T5 naming of ``cfg``'s shapes, numpy."""
    rng = np.random.default_rng(seed)
    d, f = cfg.dim, cfg.dim_ffn
    state = {"token_embedding.weight": rng.normal(size=(cfg.vocab_size, d)),
             "norm.weight": 1 + 0.1 * rng.normal(size=d)}
    if cfg.shared_pos:
        state["pos_embedding.embedding.weight"] = 0.1 * rng.normal(
            size=(cfg.num_buckets, cfg.num_heads))
    for i in range(cfg.num_layers):
        p = f"blocks.{i}."
        state.update({
            p + "norm1.weight": 1 + 0.1 * rng.normal(size=d),
            p + "norm2.weight": 1 + 0.1 * rng.normal(size=d),
            **{f"{p}attn.{n}.weight": rng.normal(size=(d, d)) * d**-0.5 for n in "qkvo"},
            p + "ffn.gate.0.weight": rng.normal(size=(f, d)) * d**-0.5,
            p + "ffn.fc1.weight": rng.normal(size=(f, d)) * d**-0.5,
            p + "ffn.fc2.weight": rng.normal(size=(d, f)) * f**-0.5,
        })
        if not cfg.shared_pos:
            state[p + "pos_embedding.embedding.weight"] = 0.1 * rng.normal(
                size=(cfg.num_buckets, cfg.num_heads))
    return {k: v.astype(np.float32) for k, v in state.items()}
