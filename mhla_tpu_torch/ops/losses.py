"""LM losses (counterpart of ``mhla_tpu/ops/losses.py``): the per-token
cross-entropy, the fused linear + cross-entropy and the fused KL divergence
that never hold the [N, V] logits whole, the GRPO loss and the L2Wrap
max-logit pull.

The fused losses walk the token rows in chunks of ``chunk_size``; each
chunk's logits are formed, reduced and dropped under
``torch.utils.checkpoint``, so the backward recomputes them one chunk at a
time, as JAX's ``jax.checkpoint`` inside its scan does: peak memory
O(chunk * V) instead of O(N * V).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token cross-entropy over the last axis, float32: returns (nll
    masked to zero at ``ignore_index`` [..., T], the mask)."""
    logits = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = logz - gold
    if label_smoothing > 0:
        nll = (1 - label_smoothing) * nll + label_smoothing * (logz - logits.mean(dim=-1))
    return nll * mask, mask


def _rows_in_chunks(x: torch.Tensor, chunk_size: int, fill=0.0):
    """[N, ...] -> [n_chunks, chunk_size, ...], the last chunk padded."""
    pad = (-x.shape[0]) % chunk_size
    if pad:
        x = torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])
    return x.reshape(-1, chunk_size, *x.shape[1:])


def fused_linear_cross_entropy(
    hidden: torch.Tensor,  # [B, T, H] final hidden states
    weight: torch.Tensor,  # [V, H] unembedding matrix
    labels: torch.Tensor,  # [B, T] labels (already shifted)
    bias: Optional[torch.Tensor] = None,
    chunk_size: int = 4096,
    ignore_index: int = -100,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Mean cross-entropy of ``hidden @ weight.T (+ bias)`` against
    ``labels`` (float32 logits), over the tokens not at ``ignore_index``."""
    h = hidden.shape[-1]
    xs = _rows_in_chunks(hidden.reshape(-1, h), chunk_size)
    ys = _rows_in_chunks(labels.reshape(-1), chunk_size, ignore_index)

    def chunk_loss(x_c, y_c, w, b_):
        logits = x_c.float() @ w.float().T
        if b_ is not None:
            logits = logits + b_.float()
        nll, mask = cross_entropy(logits, y_c, ignore_index, label_smoothing)
        return nll.sum(), mask.sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.long, device=hidden.device)
    for x_c, y_c in zip(xs, ys):
        s, c = checkpoint(chunk_loss, x_c, y_c, weight, bias, use_reentrant=False)
        total, count = total + s, count + c
    return total / torch.clamp(count, min=1)


def fused_kl_div_loss(
    x: torch.Tensor,  # [N, H] student hidden states
    target_x: torch.Tensor,  # [N, H] teacher hidden states
    weight: torch.Tensor,  # [V, H] student unembedding
    target_weight: torch.Tensor,  # [V, H] teacher unembedding
    reduction: str = "batchmean",
    chunk_size: int = 4096,
) -> torch.Tensor:
    """KL(teacher || student) over the vocabulary, float32, logits never
    whole. ``batchmean`` divides by the token count N, ``sum`` does not.
    Padded rows have equal (zero) logits on both sides: KL 0."""
    if reduction not in ("batchmean", "sum"):
        raise ValueError(f"unsupported reduction: {reduction}")
    n = x.shape[0]

    def chunk_kl(x_c, tx_c, w, tw):
        sp_log = F.log_softmax(x_c.float() @ w.float().T, dim=-1)
        tp_log = F.log_softmax(tx_c.float() @ tw.float().T, dim=-1)
        return torch.sum(torch.exp(tp_log) * (tp_log - sp_log))

    total = x.new_zeros((), dtype=torch.float32)
    for x_c, tx_c in zip(_rows_in_chunks(x, chunk_size), _rows_in_chunks(target_x, chunk_size)):
        total = total + checkpoint(chunk_kl, x_c, tx_c, weight, target_weight,
                                   use_reentrant=False)
    return total / n if reduction == "batchmean" else total


def grpo_loss(
    logits: torch.Tensor,  # [B, T, V] policy logits
    ref_logp: torch.Tensor,  # [B, T-1] reference-policy per-token log-probs
    input_ids: torch.Tensor,  # [B, T] completion ids
    advantages: torch.Tensor,  # [B] group-relative advantages
    beta: float = 0.1,
    completion_mask: Optional[torch.Tensor] = None,  # [B, T-1] 1 = real token
    save_kl: bool = False,
):
    """Per-token GRPO loss [B, T-1]: -(exp(logp - sg(logp)) * advantage -
    beta * kl) with the k3 estimator kl = exp(ref - logp) - (ref - logp) - 1;
    its value's first term is the advantage, its gradient advantage * d logp.
    With ``save_kl`` returns (loss, kl), both masked by ``completion_mask``."""
    logits = logits[:, :-1].float()
    ids = input_ids[:, -logits.shape[1]:]
    logp = torch.gather(F.log_softmax(logits, dim=-1), -1, ids[..., None])[..., 0]
    ref = ref_logp.float()
    kl = torch.exp(ref - logp) - (ref - logp) - 1.0
    ratio = torch.exp(logp - logp.detach())
    loss = -(ratio * advantages[:, None] - beta * kl)
    if completion_mask is not None:
        loss = loss * completion_mask
        if save_kl:
            kl = kl * completion_mask
    return (loss, kl) if save_kl else loss


class _L2Warp(torch.autograd.Function):
    """The loss as it is; the backward adds (weight / N) * max at each
    position's maximum of the logits (N = the positions), the gradient of
    weight / 2 * mean(max^2). A pull is split equally among tied maxima, as
    the gradient of JAX's ``jnp.max`` is (bf16 logits do tie)."""

    @staticmethod
    def forward(ctx, loss, logits, weight):
        ctx.save_for_backward(logits)
        ctx.weight = weight
        return loss.clone()

    @staticmethod
    def backward(ctx, grad):
        (logits,) = ctx.saved_tensors
        lf = logits.float()
        top = lf.amax(dim=-1, keepdim=True)
        at_top = (lf == top).float()
        n = lf.numel() // lf.shape[-1]
        pull = at_top * (top * (ctx.weight / n) / at_top.sum(-1, keepdim=True))
        return grad, (grad * pull).to(logits.dtype), None


def l2_warp(loss: torch.Tensor, logits: torch.Tensor, weight: float = 1e-4) -> torch.Tensor:
    """L2Wrap: the loss's value unchanged; its backward pulls each
    position's largest logit toward zero (``fla/modules/l2warp.py``)."""
    return _L2Warp.apply(loss, logits, weight)
