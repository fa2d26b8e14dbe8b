"""lm-evaluation-harness bridge (counterpart of ``mhla_tpu/eval/harness.py``,
the reference's ``mhla_nlp/evals/harness.py``).

:class:`SimpleLMEval` gives loglikelihood, rolling loglikelihood and
generation over token ids with lm-eval's interface shape; the lm-eval model
wrapper is registered only where ``lm_eval`` is installed.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..models.generation import generate as _generate


class SimpleLMEval:
    """Minimal lm-eval-shaped API over an ``MHLAForCausalLM`` (no tokenizer
    assumed: callers pass token ids); the model runs on the device its
    parameters lie on."""

    def __init__(self, model, max_len: int = 2048):
        self.model = model
        self.max_len = max_len

    def _ids(self, ids: List[int]) -> torch.Tensor:
        device = next(self.model.parameters()).device
        return torch.as_tensor(ids, dtype=torch.long, device=device)[None]

    @torch.no_grad()
    def _nll(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(log-probability of each next token [1, T - 1] float32, whether it
        is the greedy choice [1, T - 1])."""
        logits, _ = self.model(ids)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        gold = torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
        greedy = torch.argmax(logits[:, :-1], dim=-1) == ids[:, 1:]
        return gold, greedy

    def loglikelihood(
        self, context_ids: List[List[int]], continuation_ids: List[List[int]]
    ) -> List[Tuple[float, bool]]:
        """Per (context, continuation): (sum logprob, is_greedy)."""
        out = []
        for ctx, cont in zip(context_ids, continuation_ids):
            gold, greedy = self._nll(self._ids((ctx + cont)[-self.max_len:]))
            n_cont = len(cont)
            out.append((float(gold[0, -n_cont:].sum()), bool(greedy[0, -n_cont:].all())))
        return out

    def loglikelihood_rolling(self, token_ids: List[List[int]]) -> List[float]:
        """Full-sequence loglikelihood, windowed at max_len with a
        max_len // 2-token overlap carried as context (every token scored
        exactly once)."""
        stride = self.max_len // 2
        out = []
        for ids in token_ids:
            total, scored, pos = 0.0, 0, 0
            while scored < len(ids) - 1:
                window = ids[pos:pos + self.max_len]
                gold, _ = self._nll(self._ids(window))
                # the first window scores all its targets; later ones only
                # the tokens past the overlap
                new = len(window) - 1 if pos == 0 else len(window) - 1 - (scored - pos)
                total += float(gold[0, -new:].sum())
                scored = pos + len(window) - 1
                if pos + self.max_len >= len(ids):
                    break
                pos += stride
            out.append(total)
        return out

    def generate(
        self,
        context_ids: List[List[int]],
        max_new_tokens: int = 64,
        until_ids: Optional[List[int]] = None,
        temperature: float = 0.0,
    ) -> List[List[int]]:
        """Greedy or sampled continuation per context; stops at any token in
        ``until_ids`` (kept out of the returned continuation)."""
        outs = []
        for ctx in context_ids:
            ids = self._ids(ctx[-self.max_len:])
            full = _generate(self.model, ids, max_new_tokens=max_new_tokens,
                             temperature=temperature)
            cont = full[0, ids.shape[1]:].tolist()
            for stop in until_ids or ():
                if stop in cont:
                    cont = cont[:cont.index(stop)]
            outs.append([int(t) for t in cont])
        return outs


try:  # pragma: no cover - lm_eval is not installed here
    from lm_eval.api.model import LM  # type: ignore
    from lm_eval.api.registry import register_model  # type: ignore

    @register_model("mhla_tpu_torch")
    class MHLATorchLMWrapper(LM):
        """lm-eval model wrapper: construct with the model and a tokenizer."""

        def __init__(self, model, tokenizer, max_len: int = 2048):
            super().__init__()
            self.inner = SimpleLMEval(model, max_len)
            self.tokenizer = tokenizer

        def loglikelihood(self, requests):
            ctxs, conts = [], []
            for req in requests:
                ctx, cont = req.args
                ctxs.append(self.tokenizer.encode(ctx))
                conts.append(self.tokenizer.encode(cont))
            return self.inner.loglikelihood(ctxs, conts)

        def loglikelihood_rolling(self, requests):
            return self.inner.loglikelihood_rolling(
                [self.tokenizer.encode(req.args[0]) for req in requests])

        def generate_until(self, requests):
            outs = []
            for req in requests:
                ctx, gen_kwargs = req.args
                until = gen_kwargs.get("until", [])
                if isinstance(until, str):
                    until = [until]
                cont = self.inner.generate(
                    [self.tokenizer.encode(ctx)],
                    max_new_tokens=gen_kwargs.get("max_gen_toks", 64),
                    temperature=gen_kwargs.get("temperature", 0.0),
                )[0]
                text = self.tokenizer.decode(cont)
                for stop in until:  # string-level stop sequences
                    if stop and stop in text:
                        text = text[:text.index(stop)]
                outs.append(text)
            return outs

except ImportError:  # lm_eval unavailable: SimpleLMEval still works
    pass
