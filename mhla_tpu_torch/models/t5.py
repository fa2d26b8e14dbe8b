"""umT5 text encoder, frozen, for the video pipeline (counterpart of
``mhla_tpu/models/t5.py``).

The reference's trimmed T5 stack: unscaled attention with an additive
relative-position bias, a gated-GELU feed-forward (tanh GELU), log-bucketed
relative positions, pre-norm blocks and a final norm; umT5-XXL has 24
layers, dim 4096, 64 heads and a relative embedding per layer. The
attention's scores and softmax are float32 whatever ``cfg.dtype``; a padded
key gets a bias of -1e9.

Checkpoints: ``convert_hf_umt5`` (HuggingFace ``UMT5EncoderModel``) and
``convert_t5_checkpoint`` (the reference's naming) give the JAX package's
param tree, which ``t5_params_from_jax`` turns into this module's state
dict. :class:`T5TextEncoder` encodes prompts from a directory of weights
and a tokenizer.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.safetensors_io import load_safetensors
from .convert_jax import t5_params_from_jax
from .initializers import lecun_normal_


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    shared_pos: bool = False  # umT5: a relative embedding per layer
    max_dist: int = 128
    eps: float = 1e-6
    dtype: torch.dtype = torch.float32


UMT5_XXL = T5Config()


def relative_position_bucket(
    rel_pos: np.ndarray, num_buckets: int = 32, max_dist: int = 128, bidirectional: bool = True,
) -> np.ndarray:
    """T5's log-bucketed relative positions."""
    if bidirectional:
        half = num_buckets // 2
        buckets = (rel_pos > 0).astype(np.int64) * half
        rel_pos = np.abs(rel_pos)
    else:
        half = num_buckets
        buckets = np.zeros_like(rel_pos)
        rel_pos = -np.minimum(rel_pos, 0)
    max_exact = half // 2
    large = max_exact + (
        np.log(np.maximum(rel_pos, 1) / max_exact) / math.log(max_dist / max_exact)
        * (half - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, half - 1)
    return buckets + np.where(rel_pos < max_exact, rel_pos, large)


class T5LayerNorm(nn.Module):
    """RMS norm without centring, float32 inside, ``weight`` [dim]."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight).to(x.dtype)


class T5RelativeEmbedding(nn.Module):
    """A bias per (bucket, head), ``weight`` [num_buckets, num_heads]."""

    def __init__(self, num_buckets: int, num_heads: int, max_dist: int = 128, device=None):
        super().__init__()
        self.num_buckets, self.max_dist = num_buckets, max_dist
        self.weight = nn.Parameter(torch.zeros(num_buckets, num_heads, device=device))

    def forward(self, lq: int, lk: int) -> torch.Tensor:
        """The bias [1, H, lq, lk], float32."""
        rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]
        buckets = torch.from_numpy(relative_position_bucket(rel, self.num_buckets, self.max_dist))
        return self.weight.float()[buckets.to(self.weight.device)].permute(2, 0, 1)[None]


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype))


class T5EncoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        lin = lambda i, o: nn.Linear(i, o, bias=False, device=device)  # noqa: E731
        self.norm1 = T5LayerNorm(cfg.dim, cfg.eps, device)
        self.q, self.k, self.v = (lin(cfg.dim, cfg.dim_attn) for _ in range(3))
        self.o = lin(cfg.dim_attn, cfg.dim)
        self.norm2 = T5LayerNorm(cfg.dim, cfg.eps, device)
        self.ffn_gate = lin(cfg.dim, cfg.dim_ffn)
        self.ffn_fc1 = lin(cfg.dim, cfg.dim_ffn)
        self.ffn_fc2 = lin(cfg.dim_ffn, cfg.dim)
        self.pos_embedding = (None if cfg.shared_pos else
                              T5RelativeEmbedding(cfg.num_buckets, cfg.num_heads, cfg.max_dist,
                                                  device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                pos_bias: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        h, d = cfg.num_heads, cfg.dim_attn // cfg.num_heads
        if pos_bias is None:  # the per-layer relative embedding (umT5)
            pos_bias = self.pos_embedding(x.shape[1], x.shape[1])

        y = self.norm1(x)
        b, t, _ = y.shape
        q, k, v = (_linear(y, proj).reshape(b, t, h, d) for proj in (self.q, self.k, self.v))
        bias = pos_bias.float()
        if mask is not None:
            bias = bias + torch.where(mask.bool()[:, None, None, :], 0.0, -1e9)
        # T5 attention is unscaled
        attn = torch.einsum("bihd,bjhd->bhij", q, k).float() + bias
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        y = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, t, cfg.dim_attn)
        x = x + _linear(y, self.o)

        y = self.norm2(x)
        gate = F.gelu(_linear(y, self.ffn_gate), approximate="tanh")
        return x + _linear(_linear(y, self.ffn_fc1) * gate, self.ffn_fc2)


class T5Encoder(nn.Module):
    """Token ids [B, L] (and an optional mask [B, L], 1 for a real token)
    -> hidden states [B, L, dim] in ``cfg.dtype``."""

    def __init__(self, cfg: T5Config = UMT5_XXL, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.dim, device=device)
        self.pos_embedding = (T5RelativeEmbedding(cfg.num_buckets, cfg.num_heads, cfg.max_dist,
                                                  device) if cfg.shared_pos else None)
        self.blocks = nn.ModuleList(T5EncoderBlock(cfg, device) for _ in range(cfg.num_layers))
        self.norm = T5LayerNorm(cfg.dim, cfg.eps, device)

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.token_embedding(ids).to(self.cfg.dtype)
        pos_bias = None
        if self.pos_embedding is not None:
            pos_bias = self.pos_embedding(ids.shape[1], ids.shape[1])
        for block in self.blocks:
            x = block(x, mask, pos_bias)
        return self.norm(x)


@torch.no_grad()
def init_t5_params(model: T5Encoder, generator: torch.Generator) -> T5Encoder:
    """Draw the parameters in place as the flax initializers of the JAX
    module do: the token embedding from normal(1), every projection from
    flax's ``lecun_normal``, the relative embeddings from normal(std
    (2 * buckets * heads)^-0.5); norm weights one. ``generator`` lives on
    the parameters' device."""
    cfg = model.cfg
    model.token_embedding.weight.normal_(0.0, 1.0, generator=generator)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            lecun_normal_(module.weight, generator)
        elif isinstance(module, T5RelativeEmbedding):
            module.weight.normal_(0.0, (2 * cfg.num_buckets * cfg.num_heads) ** -0.5,
                                  generator=generator)
        elif isinstance(module, T5LayerNorm):
            module.weight.fill_(1.0)
    return model


def convert_hf_umt5(state: Dict[str, np.ndarray], cfg: T5Config) -> Dict:
    """A HuggingFace UMT5 encoder state dict -> the JAX package's param tree.
    HF naming: ``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}`` (and the
    per-layer ``relative_attention_bias``),
    ``layer.1.DenseReluDense.{wi_0,wi_1,wo}`` (wi_0 the gate), ``shared``,
    ``encoder.final_layer_norm``."""

    def lin(k):
        return {"kernel": np.asarray(state[k]).T}

    params: Dict[str, Any] = {
        "token_embedding": {"embedding": np.asarray(state["shared.weight"])},
        "norm": {"weight": np.asarray(state["encoder.final_layer_norm.weight"])},
    }
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}.layer."
        params[f"blocks_{i}"] = {
            "norm1": {"weight": np.asarray(state[p + "0.layer_norm.weight"])},
            "norm2": {"weight": np.asarray(state[p + "1.layer_norm.weight"])},
            **{name: lin(f"{p}0.SelfAttention.{name}.weight") for name in ("q", "k", "v", "o")},
            "pos_embedding": {
                "embedding": np.asarray(state[p + "0.SelfAttention.relative_attention_bias.weight"])
            },
            "ffn_gate": lin(p + "1.DenseReluDense.wi_0.weight"),
            "ffn_fc1": lin(p + "1.DenseReluDense.wi_1.weight"),
            "ffn_fc2": lin(p + "1.DenseReluDense.wo.weight"),
        }
    return {"params": params}


def convert_t5_checkpoint(state: Dict[str, np.ndarray], cfg: T5Config = UMT5_XXL) -> Dict:
    """A torch state dict in the reference's naming (encoder prefix
    stripped) -> the JAX package's param tree."""

    def lin(k):
        return {"kernel": np.asarray(state[k]).T}

    params: Dict[str, Any] = {
        "token_embedding": {"embedding": np.asarray(state["token_embedding.weight"])},
        "norm": {"weight": np.asarray(state["norm.weight"])},
    }
    if cfg.shared_pos:
        params["pos_embedding"] = {"embedding": np.asarray(state["pos_embedding.embedding.weight"])}
    for i in range(cfg.num_layers):
        p = f"blocks.{i}."
        blk = {
            "norm1": {"weight": np.asarray(state[p + "norm1.weight"])},
            "norm2": {"weight": np.asarray(state[p + "norm2.weight"])},
            **{name: lin(f"{p}attn.{name}.weight") for name in ("q", "k", "v", "o")},
            "ffn_gate": lin(p + "ffn.gate.0.weight"),
            "ffn_fc1": lin(p + "ffn.fc1.weight"),
            "ffn_fc2": lin(p + "ffn.fc2.weight"),
        }
        if not cfg.shared_pos:
            blk["pos_embedding"] = {
                "embedding": np.asarray(state[p + "pos_embedding.embedding.weight"])
            }
        params[f"blocks_{i}"] = blk
    return {"params": params}


@torch.no_grad()
def encode_masked(model: T5Encoder, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The encoder's output for ``ids`` [B, L] under ``mask`` [B, L] (1 for a
    real token), zero past each row's length."""
    return model(ids, mask) * mask[..., None].to(model.cfg.dtype)


def _read_t5_state(d: Path, cfg: T5Config) -> Dict:
    """The param tree of the weights under ``d``: ``*.safetensors`` (HF
    UMT5) or ``*.pth`` / ``*.pt`` (the reference's naming)."""
    if (d / "params.msgpack").exists():
        raise ValueError(f"{d}/params.msgpack is flax's msgpack format, which this package "
                         "does not read: give the weights as *.safetensors or *.pth")
    sts = sorted(d.glob("*.safetensors"))
    pths = sorted(list(d.glob("*.pth")) + list(d.glob("*.pt")))
    state: Dict[str, np.ndarray] = {}
    if sts:
        for f in sts:
            state.update(load_safetensors(str(f)))
        return convert_hf_umt5(state, cfg)
    if pths:
        for f in pths:
            blob = torch.load(str(f), map_location="cpu", weights_only=True, mmap=True)
            state.update({k: v.float().numpy() for k, v in blob.items()})
        return convert_t5_checkpoint(state, cfg)
    raise FileNotFoundError(f"no *.safetensors or *.pth under {d}")


class T5TextEncoder:
    """Prompt encoding for the video pipeline: tokenize, padded or truncated
    to ``text_len`` after whitespace cleaning, run the frozen encoder with
    the attention mask, and zero every position past each prompt's length
    (the reference trims to the lengths and the model zero-pads back to
    ``text_len``: the same tensor).

    ``t5_dir`` holds ``config.json`` (optional: ``T5Config`` field overrides
    and an optional ``"tokenizer"`` name or path, by default
    ``<t5_dir>/tokenizer``) and the weights, ``*.safetensors`` (a HF UMT5
    encoder) or ``*.pth`` (the reference's naming); flax's
    ``params.msgpack`` raises.
    """

    def __init__(self, t5_dir: str, text_len: int, dtype: torch.dtype = torch.float32,
                 device=None):
        d = Path(t5_dir)
        raw = json.loads((d / "config.json").read_text()) if (d / "config.json").exists() else {}
        tokenizer_name = raw.pop("tokenizer", str(d / "tokenizer"))
        fields = {f.name for f in dataclasses.fields(T5Config)}
        self.cfg = T5Config(**{k: v for k, v in raw.items() if k in fields and k != "dtype"},
                            dtype=dtype)
        self.text_len = text_len
        state = t5_params_from_jax(_read_t5_state(d, self.cfg))
        self.model = T5Encoder(self.cfg, device=device).eval().requires_grad_(False)
        self.model.load_state_dict(state)
        del state

        from ..data.tokenizers import PromptTokenizer

        self.tokenizer = PromptTokenizer(tokenizer_name, seq_len=text_len, clean="whitespace")

    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        """texts -> [B, text_len, dim] on the encoder's device, zeroed past
        each prompt's length."""
        ids, mask = self.tokenizer(texts, return_mask=True)
        device = self.model.token_embedding.weight.device
        return encode_masked(self.model, torch.from_numpy(ids).long().to(device),
                             torch.from_numpy(mask).to(device))
