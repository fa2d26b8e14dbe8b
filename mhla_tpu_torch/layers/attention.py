"""Softmax attention (counterpart of ``sdpa`` in
``mhla_tpu/layers/attention.py``): the non-causal form the video model's
text cross-attention and its dense softmax self-attention use. Causal
attention, windows, masks, packed segments and the ``SelfAttention`` module
wait for the slices that need them."""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention, flash_attention_plain

_FLASH_MIN_QUERY = 2048
_FLASH_MIN_KEYS = 128


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    window: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over [B, T, H, D] tensors.

    The JAX package's dispatch rule: a long query (>= 2048 tokens) against
    at least 128 keys with a head dim that is a multiple of 128 goes to the
    flash kernel, which never writes the [Tq, Tk] scores to device memory;
    short cases take the plain product."""
    if causal or window is not None or mask is not None or segment_ids is not None:
        raise NotImplementedError(
            "causal, windowed, masked and packed softmax attention are not ported yet"
        )
    if (
        q.shape[1] >= _FLASH_MIN_QUERY
        and k.shape[1] >= _FLASH_MIN_KEYS
        and q.shape[-1] % 128 == 0
    ):
        return flash_attention(q, k, v)
    return flash_attention_plain(q, k, v)


class SelfAttention(torch.nn.Module):
    """Placeholder of the JAX package's softmax self-attention layer."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the softmax SelfAttention layer is not ported yet")
