"""Long-context perplexity CLI (counterpart of ``mhla_tpu/eval/ppl_cli.py``,
the reference's ``python evals/ppl.py -p <model> -d fla-hub/pg19``): builds
the LM from a reference-format model json (or the 340M defaults), takes its
weights from a seeded init or from a checkpoint of this package's
``train.lm_train``, streams tokens from a pre-tokenized .npy / .bin shard
(or a Hugging Face dataset, when ``datasets`` and ``transformers`` are
installed; nothing is downloaded otherwise), and prints a JSON report with
the total perplexity and the per-bucket breakdown.

Usage:
    python -m mhla_tpu_torch.eval.ppl_cli --ckpt=work_dirs/lm \\
        --tokens=shard.npy --block_size=28672

``--ckpt`` takes a run's ``work_dir`` (its newest complete checkpoint) or
one ``checkpoints/step_XXXXXXXX`` directory, and prefers the EMA weights
where the run kept them. The model runs on ``--device`` (default ``cuda``);
for a tiny run on the CPU:

    python -m mhla_tpu_torch.eval.ppl_cli --device=cpu --tokens=shard.npy \\
        --block_size=512 --bucket_size=128 --vocab_size=64 --hidden_size=32 \\
        --num_hidden_layers=1 --num_heads=2 --bf16=false
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Optional

import numpy as np
import torch

from ..models import MHLAForCausalLM, MHLALMConfig, init_lm_params
from ..utils.checkpoint import load_model_params
from ..utils.config import parse_cli
from .ppl import PerplexityEvaluator


@dataclasses.dataclass
class PPLConfig:
    ckpt: Optional[str] = None  # lm_train work_dir or step directory; None -> seeded init
    model_json: Optional[str] = None  # reference-format model config json
    tokens: Optional[str] = None  # pre-tokenized .npy/.bin int shard
    dataset: Optional[str] = None  # HF dataset name (streamed + tokenized)
    tokenizer: str = "gpt2"
    text_key: str = "text"
    max_tokens: int = 1 << 20
    block_size: int = 28672
    bucket_size: int = 2048
    bf16: bool = True  # bf16 compute over float32 parameters
    out: Optional[str] = None  # write the JSON report here too
    device: str = "cuda"
    # tiny-model overrides (smoke)
    vocab_size: Optional[int] = None
    hidden_size: Optional[int] = None
    num_hidden_layers: Optional[int] = None
    num_heads: Optional[int] = None


def _load_tokens(cfg: PPLConfig) -> np.ndarray:
    if cfg.tokens:
        if cfg.tokens.endswith(".npy"):
            return np.load(cfg.tokens).astype(np.int32).reshape(-1)
        return np.fromfile(cfg.tokens, dtype=np.uint16).astype(np.int32)
    if cfg.dataset:
        from datasets import load_dataset
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(cfg.tokenizer)
        ds = load_dataset(cfg.dataset, split="test", streaming=True)
        out = []
        for row in ds:
            out.extend(tok(row[cfg.text_key]).input_ids)
            if len(out) >= cfg.max_tokens:
                break
        return np.asarray(out[: cfg.max_tokens], np.int32)
    raise ValueError("provide --tokens=<shard> or --dataset=<name>")


def build_model(cfg: PPLConfig) -> MHLAForCausalLM:
    """The LM ``cfg`` describes on ``cfg.device``, in eval mode, with the
    checkpoint's weights or an init seeded with 0 (the JAX CLI's
    ``PRNGKey(0)``; the two draw different numbers)."""
    model_cfg = MHLALMConfig.from_json(cfg.model_json) if cfg.model_json else MHLALMConfig()
    for k in ("vocab_size", "hidden_size", "num_hidden_layers", "num_heads"):
        v = getattr(cfg, k)
        if v is not None:
            model_cfg = dataclasses.replace(model_cfg, **{k: v})
    if cfg.bf16:
        model_cfg = dataclasses.replace(model_cfg, dtype=torch.bfloat16)
    device = torch.device(cfg.device)
    model = MHLAForCausalLM(model_cfg, device=device)
    if cfg.ckpt:
        load_model_params(cfg.ckpt, model)
    else:
        init_lm_params(model, torch.Generator(device).manual_seed(0))
    return model.eval()


def main(argv=None) -> dict:
    cfg = parse_cli(PPLConfig, argv if argv is not None else sys.argv[1:])
    model = build_model(cfg)
    tokens = _load_tokens(cfg)
    if len(tokens) // cfg.block_size == 0:
        raise ValueError(
            f"{len(tokens)} tokens < one block ({cfg.block_size}); lower --block_size"
        )
    evaluator = PerplexityEvaluator(model, block_size=cfg.block_size,
                                    bucket_size=cfg.bucket_size)
    report = evaluator.evaluate_tokens(tokens)
    print(json.dumps(report))
    if cfg.out:
        with open(cfg.out, "w") as fh:
            json.dump(report, fh, indent=2)
    return report


if __name__ == "__main__":
    main()
