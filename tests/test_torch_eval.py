"""The port's LM evaluation (``eval/ppl.py``, ``eval/ppl_cli.py``,
``eval/harness.py``) held against the JAX package's on the CPU, with
weights bridged from JAX: token NLL, the block-wise perplexity report,
loglikelihood, rolling loglikelihood and generation; the CLI on a token
shard and on an ``lm_train`` checkpoint. Inputs come from numpy seeds."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhla_tpu.eval.harness import SimpleLMEval as JaxSimpleLMEval
from mhla_tpu.eval.ppl import PerplexityEvaluator as JaxPerplexityEvaluator
from mhla_tpu.eval.ppl import token_nll as jax_token_nll
from mhla_tpu.models import MHLAForCausalLM as JaxLM
from mhla_tpu.models import MHLALMConfig as JaxConfig
from mhla_tpu_torch.eval import PerplexityEvaluator, SimpleLMEval, token_nll
from mhla_tpu_torch.eval import ppl_cli
from mhla_tpu_torch.models import MHLAForCausalLM, MHLALMConfig, params_from_jax
from mhla_tpu_torch.train import lm_train
from mhla_tpu_torch.utils import assert_close
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

# float32 through the layers of a model (as tests/test_torch_lm.py)
MODEL_TOL = 1e-4

# a hybrid (softmax layer 0 with 2 heads of 32, MHLA layer 1) with 16 mixing
# slots: 1,024 positions
_TINY = dict(hidden_size=64, num_hidden_layers=2, num_heads=2, vocab_size=64,
             max_position_embeddings=1024, attn={"layers": [0]})


def _random_params(tree, seed=0):
    """Dense kernels N(0, 0.05), the embedding N(0, 0.5), norm weights
    1 + N(0, 0.1), mixing matrices U(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "mixing_matrix" in name:
            x = rng.uniform(0.0, 1.0, leaf.shape)
        elif "embedding" in name:
            x = rng.normal(0.0, 0.5, leaf.shape)
        elif "kernel" in name:
            x = rng.normal(0.0, 0.05, leaf.shape)
        else:
            x = 1.0 + rng.normal(0.0, 0.1, leaf.shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def pair():
    jax_model = JaxLM(JaxConfig(**_TINY))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(jnp.asarray, _random_params(shapes))
    cfg = MHLALMConfig(**_TINY)
    port = MHLAForCausalLM(cfg).eval()
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jax_model, params, port


def _tokens(n, seed=3):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


def test_token_nll_matches_jax(pair):
    jax_model, params, port = pair
    ids = _tokens(2 * 200).reshape(2, 200)
    ref = jax_token_nll(jax_model, params, jnp.asarray(ids))
    with torch.no_grad():
        out = token_nll(port, torch.from_numpy(ids).long())
    assert out.shape == (2, 199) and out.dtype == torch.float32
    assert_close("token_nll", np.asarray(ref), out, MODEL_TOL)


def test_perplexity_evaluator_matches_jax(pair):
    """Two blocks of 256 tokens (and a partial third, dropped), buckets of
    64: the same keys and values as the JAX evaluator's report."""
    jax_model, params, port = pair
    tokens = _tokens(2 * 256 + 100)
    ref = JaxPerplexityEvaluator(jax_model, params, block_size=256,
                                 bucket_size=64).evaluate_tokens(tokens)
    out = PerplexityEvaluator(port, block_size=256, bucket_size=64).evaluate_tokens(tokens)
    assert list(out) == list(ref) == ["ppl", "ppl@64", "ppl@128", "ppl@192", "ppl@256"]
    for key in ref:
        assert abs(out[key] - ref[key]) <= 1e-4 * ref[key], (key, out[key], ref[key])
    with pytest.raises(ValueError):
        PerplexityEvaluator(port, block_size=1024).evaluate_tokens(tokens)


def test_simple_lm_eval_matches_jax(pair):
    """loglikelihood (sum and greedy flag), rolling loglikelihood over
    windows of 64 with overlap 32, and greedy generation with a stop token."""
    jax_model, params, port = pair
    ref, out = JaxSimpleLMEval(jax_model, params, max_len=64), SimpleLMEval(port, max_len=64)
    rng = np.random.default_rng(4)
    ctxs = [rng.integers(0, 64, n).tolist() for n in (10, 70, 3)]
    conts = [rng.integers(0, 64, n).tolist() for n in (5, 1, 20)]
    r_ll, o_ll = ref.loglikelihood(ctxs, conts), out.loglikelihood(ctxs, conts)
    for (r, rg), (o, og) in zip(r_ll, o_ll):
        assert abs(o - r) <= 1e-4 * abs(r) + 1e-5 and og == rg
    seqs = [rng.integers(0, 64, n).tolist() for n in (150, 40, 64)]
    np.testing.assert_allclose(out.loglikelihood_rolling(seqs), ref.loglikelihood_rolling(seqs),
                               rtol=1e-4)
    r_gen = ref.generate(ctxs, max_new_tokens=8)
    assert out.generate(ctxs, max_new_tokens=8) == r_gen
    stop = r_gen[0][3]
    assert out.generate(ctxs, max_new_tokens=8, until_ids=[stop]) == ref.generate(
        ctxs, max_new_tokens=8, until_ids=[stop])


_CLI_TINY = ["--vocab_size=64", "--hidden_size=32", "--num_hidden_layers=1", "--num_heads=2",
             "--bf16=false", "--device=cpu"]


def test_ppl_cli_tokens_report(tmp_path):
    """The port's mirror of tests/test_clis.py's TestPPLCLI on the CPU: a
    2,048-token shard, blocks of 512, buckets of 128, a tiny model."""
    rng = np.random.default_rng(0)
    shard = tmp_path / "tokens.npy"
    np.save(shard, rng.integers(0, 64, 2048, dtype=np.int32))
    report = ppl_cli.main([f"--tokens={shard}", "--block_size=512", "--bucket_size=128",
                           *_CLI_TINY, f"--out={tmp_path}/report.json"])
    assert set(report) == {"ppl", "ppl@128", "ppl@256", "ppl@384", "ppl@512"}
    assert all(np.isfinite(list(report.values())))
    assert json.loads((tmp_path / "report.json").read_text()) == report
    bin_shard = tmp_path / "tokens.bin"
    np.load(shard).astype(np.uint16).tofile(bin_shard)
    assert ppl_cli.main([f"--tokens={bin_shard}", "--block_size=512", "--bucket_size=128",
                         *_CLI_TINY]) == report
    with pytest.raises(ValueError):  # fewer tokens than one block
        ppl_cli.main([f"--tokens={shard}", "--block_size=4096", *_CLI_TINY])


def test_ppl_cli_dataset_needs_its_packages(tmp_path, monkeypatch):
    """``--dataset`` imports ``datasets`` and ``transformers`` only when
    asked, and raises without them; no tokens at all raise too."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError):
        ppl_cli.main(["--dataset=pg19", *_CLI_TINY])
    with pytest.raises(ValueError):
        ppl_cli.main(_CLI_TINY)


def test_ppl_cli_reads_an_lm_train_checkpoint(tmp_path):
    """``--ckpt`` reads what ``lm_train`` wrote (its work_dir or a step
    directory), the EMA weights where the run kept them: the report equals
    the evaluator's on the trained model's EMA weights."""
    work = tmp_path / "run"
    model_args = ["--model.vocab_size=64", "--model.hidden_size=32",
                  "--model.num_hidden_layers=1", "--model.num_heads=2"]
    out = lm_train.main(["--device=cpu", "--bf16=false", f"--work_dir={work}", *model_args,
                         "--train.batch_size=2", "--train.seq_len=130", "--train.max_steps=2",
                         "--train.ema_decay=0.5", "--optimizer.warmup_steps=1"])
    assert len(out["losses"]) == 2
    shard = tmp_path / "tokens.npy"
    np.save(shard, _tokens(1024))
    args = [f"--tokens={shard}", "--block_size=512", "--bucket_size=128", *_CLI_TINY]
    report = ppl_cli.main([f"--ckpt={work}", *args])
    step_dir = work / "checkpoints" / "step_00000002"
    assert ppl_cli.main([f"--ckpt={step_dir}", *args]) == report
    trained = out["model"]
    ema = torch.load(step_dir / "state.pt", weights_only=True)["ema"]
    with torch.no_grad():
        for name, p in trained.named_parameters():
            p.copy_(ema[name])
    want = PerplexityEvaluator(trained.eval(), block_size=512,
                               bucket_size=128).evaluate_tokens(np.load(shard))
    assert report == want
    seeded = ppl_cli.main(args)
    assert seeded != report
    with pytest.raises(FileNotFoundError):
        ppl_cli.main([f"--ckpt={tmp_path / 'nothing'}", *args])
