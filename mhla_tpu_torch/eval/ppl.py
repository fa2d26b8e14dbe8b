"""Block-wise long-context perplexity (counterpart of
``mhla_tpu/eval/ppl.py``, the reference evaluator
``mhla_nlp/evals/ppl.py``): tokens are streamed in contiguous blocks
(28,672 = 14 x 2048 by default), each block takes one forward, and the
report gives the total perplexity and one per bucket of 2,048 positions,
which exposes degradation along the context.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def token_nll(model, ids: torch.Tensor) -> torch.Tensor:
    """Per-token shifted NLL, [B, T - 1] float32: the log-sum-exp of the
    float32 logits of positions 0 .. T - 2 less the logit of the next token."""
    logits, _ = model(ids)
    logits = logits[:, :-1].float()
    labels = ids[:, 1:]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return logz - gold


class PerplexityEvaluator:
    """Perplexity of ``model`` (an ``MHLAForCausalLM``, on the device its
    parameters lie on) over blocks of ``block_size`` tokens, reported per
    ``bucket_size`` positions."""

    def __init__(self, model, block_size: int = 28672, bucket_size: int = 2048):
        self.model = model
        self.block_size = block_size
        self.bucket_size = bucket_size

    @torch.no_grad()
    def block_nll(self, ids: np.ndarray) -> np.ndarray:
        """The [len(ids) - 1] float32 NLL of one block of token ids."""
        device = next(self.model.parameters()).device
        x = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)[None]
        return token_nll(self.model, x)[0].cpu().numpy()

    def evaluate_tokens(self, tokens: np.ndarray) -> Dict[str, float]:
        """tokens: 1-D int array, evaluated in contiguous blocks (a partial
        last block is dropped). Keys ``ppl`` and ``ppl@<position>``, the
        latter the exp of the mean over blocks of each bucket's mean NLL."""
        n_blocks = len(tokens) // self.block_size
        if n_blocks == 0:
            raise ValueError(f"{len(tokens)} tokens make no block of {self.block_size}")
        total_nll, total_count = 0.0, 0
        buckets: Dict[int, List[float]] = {}
        for b in range(n_blocks):
            nll = self.block_nll(tokens[b * self.block_size:(b + 1) * self.block_size])
            total_nll += float(nll.sum(dtype=np.float64))
            total_count += nll.size
            for start in range(0, nll.size, self.bucket_size):
                buckets.setdefault(start // self.bucket_size, []).append(
                    float(nll[start:start + self.bucket_size].mean())
                )
        out = {"ppl": float(np.exp(total_nll / total_count))}
        for idx, vals in sorted(buckets.items()):
            out[f"ppl@{(idx + 1) * self.bucket_size}"] = float(np.exp(np.mean(vals)))
        return out
