"""Autoregressive generation for the MHLA LM (counterpart of
``mhla_tpu/models/generation.py``): one prefill through the chunked op
(K1-K4 on the card), then O(1)-per-token recurrent decode. The softmax
layers of a hybrid model keep KV caches: the prefill returns (k, v, T),
:func:`_pad_softmax_caches` grows them to the full length once, and every
decode step writes its token into them in place.

The JAX package runs its decode loop as one jitted scan; PyTorch runs
eagerly, so the loop here is a plain Python loop with the caches updated
in place. For serving, cast the model to bf16 first
(``model.to(torch.bfloat16)`` with ``config.dtype = torch.bfloat16``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _pad_softmax_caches(states, max_length: int):
    """Grow the softmax layers' KV caches (plain (k, v, t) tuples; every other
    layer's state is a named tuple and passes through)
    from the prefill length to ``max_length`` tokens, zero-filled."""
    out = []
    for s in states:
        if isinstance(s, tuple) and len(s) == 3 and not hasattr(s, "_fields"):
            k, v, t = s
            pad = (0, 0, 0, 0, 0, max_length - k.shape[1])
            out.append((F.pad(k, pad), F.pad(v, pad), t))
        else:
            out.append(s)
    return out


def _make_sampler(temperature: float, top_k: Optional[int]):
    def sample(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        logits = logits[:, -1].float()
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, float("-inf"), logits)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return sample


@torch.no_grad()
def generate(
    model,
    input_ids: torch.Tensor,  # [B, T] int64
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_token_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    stop_fn: Optional[Callable[[torch.Tensor], bool]] = None,
    output_scores: bool = False,
):
    """Greedy (``temperature=0``) or sampled decoding; returns [B, T + new]
    token ids, and with ``output_scores`` also the logits each new token
    was chosen from, [B, new, V].

    ``generator`` seeds sampling (on the model's device). ``stop_fn(ids)``
    is asked after every token and ends the loop when it returns True.
    Raises ``ValueError`` when T + max_new_tokens exceeds the model's
    context (``config.max_context``)."""
    b, t = input_ids.shape
    limit = model.config.max_context
    if t + max_new_tokens > limit:
        raise ValueError(
            f"prompt {t} + {max_new_tokens} new tokens exceed the context bound "
            f"{limit} (num_slots x chunk_size)"
        )
    sample = _make_sampler(temperature, top_k)
    logits, states = model(input_ids, use_cache=True)
    states = _pad_softmax_caches(states, t + max_new_tokens)
    tok = sample(logits, generator)
    out = [input_ids, tok[:, None]]
    scores = [logits[:, -1]] if output_scores else None
    finished = torch.zeros(b, dtype=torch.bool, device=input_ids.device)
    for _ in range(max_new_tokens - 1):
        logits, states = model(tok[:, None], states, use_cache=True)
        nxt = sample(logits, generator)
        if eos_token_id is not None:
            finished = finished | (tok == eos_token_id)
            nxt = torch.where(finished, eos_token_id, nxt)
        tok = nxt
        out.append(tok[:, None])
        if output_scores:
            scores.append(logits[:, -1])
        if stop_fn is not None and stop_fn(torch.cat(out, dim=1)):
            break
    ids = torch.cat(out, dim=1)
    if output_scores:
        return ids, torch.stack(scores, dim=1)
    return ids
