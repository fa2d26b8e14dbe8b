"""MHLA causal language model (counterpart of ``mhla_tpu/models/gla_lm.py``,
the ``attn_extends='mhla'`` family, its softmax hybrid, the all-softmax
``'transformer'`` family and the ``'gated_deltanet'``, ``'gla'``,
``'simple_gla'``, ``'mamba2'``, ``'mamba'`` and ``'linear_attn'`` baselines).

Pre-norm blocks of [RMSNorm -> attention -> residual -> RMSNorm -> GatedMLP
-> residual], a final RMSNorm and tied (or separate) unembedding. The
attention of a layer is ``SelfAttention`` (causal softmax with RoPE) when
the layer is listed in ``config.attn["layers"]`` or ``attn_extends ==
"transformer"``, else ``GatedDeltaNet`` for ``attn_extends ==
"gated_deltanet"`` (head dim hidden * expand_k / heads, value expansion
expand_v / expand_k, as the JAX branch sets them),
``GatedLinearAttention`` for ``"gla"`` and ``"simple_gla"`` (the config's
widths, feature map, output gate and chunk size; simple GLA with one
decay per head), ``Mamba2`` for ``"mamba2"`` (head dim hidden * expand_v /
heads, at least 8, d_state 128), ``Mamba`` for ``"mamba"``,
``CausalLinearAttention`` for ``"linear_attn"`` (its cache the running sums;
JAX's layer keeps none) and ``MHLACausal`` otherwise. The ``MHLALMConfig``
defaults are the 340M model of ``configs/mhla_340m.yaml``, so that model
needs no yaml reader; ``MHLALMConfig.from_json`` reads a reference-format
model json.

``attention_mask`` reaches the MHLA layers only and ``segment_ids`` every
layer, as in the JAX package; ``segment_ids`` with any other family than
MHLA and softmax raises ``NotImplementedError``, as it does there.
``MHLAForCausalLM(remat=True)`` recomputes each block in the backward
(``torch.utils.checkpoint``, JAX's ``nn.remat``); ``output_hidden=True``
returns the final hidden states for :func:`fused_lm_loss`. Waits for a
later port (raises ``NotImplementedError``): tensor parallelism.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..layers import GatedMLP, MHLACausal, RMSNorm, dense
from ..layers.attention import SelfAttention
from ..layers.gated_deltanet import GatedDeltaNet
from ..layers.gla import GatedLinearAttention
from ..layers.linear_attn import CausalLinearAttention
from ..layers.mamba import Mamba, _dt_proj_bias_init
from ..layers.mamba2 import Mamba2
from ..ops.losses import fused_linear_cross_entropy

_FAMILIES = ("softmax", "mhla", "gated_deltanet", "gla", "simple_gla", "mamba2", "mamba",
             "linear_attn")


@dataclasses.dataclass
class MHLALMConfig:
    hidden_size: int = 1024
    expand_k: float = 0.5
    expand_v: float = 1.0
    hidden_ratio: int = 4
    intermediate_size: Optional[int] = None
    num_hidden_layers: int = 24
    num_heads: int = 4
    num_kv_heads: Optional[int] = None
    feature_map: Optional[str] = "relu"
    attn_mode: str = "chunk"
    use_short_conv: bool = False
    conv_size: int = 4
    use_output_gate: bool = True
    hidden_act: str = "swish"
    max_position_embeddings: int = 2048
    elementwise_affine: bool = True
    norm_eps: float = 1e-6
    attn: Optional[Dict[str, Any]] = None  # hybrid softmax layers
    vocab_size: int = 32000
    tie_word_embeddings: bool = True
    initializer_range: float = 0.02
    fuse_cross_entropy: bool = True
    use_l2warp: bool = False
    attn_extends: str = "mhla"
    chunk_size: int = 64
    dtype: torch.dtype = torch.float32  # activation (compute) dtype
    tp_mesh: Any = None

    @property
    def num_slots(self) -> int:
        return max(1, -(-self.max_position_embeddings // self.chunk_size))

    @property
    def max_context(self) -> int:
        """The longest prompt + decoded context the mixing matrix covers."""
        return self.num_slots * self.chunk_size

    def is_softmax(self, layer_idx: int) -> bool:
        """Whether layer ``layer_idx`` is a softmax ``SelfAttention`` layer."""
        return self.attn_extends == "transformer" or (
            self.attn is not None and layer_idx in self.attn.get("layers", ())
        )

    @classmethod
    def from_json(cls, path: str, **overrides) -> "MHLALMConfig":
        """Load a reference-format model json (e.g. ``mhla_340M.json``): its
        keys that name a field of this config, then ``overrides``."""
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        kwargs.update(overrides)
        return cls(**kwargs)


class MHLABlock(nn.Module):
    def __init__(self, config: MHLALMConfig, layer_idx: int, device=None):
        super().__init__()
        cfg = config
        self.is_softmax = cfg.is_softmax(layer_idx)
        self.extends = "softmax" if self.is_softmax else cfg.attn_extends
        if self.extends not in _FAMILIES:
            raise NotImplementedError(f"attn_extends={cfg.attn_extends!r} (layer {layer_idx})")
        if cfg.tp_mesh is not None:
            raise NotImplementedError("tensor parallelism is not ported yet")
        self.attn_norm = RMSNorm(cfg.hidden_size, eps=cfg.norm_eps, device=device)
        if self.is_softmax:
            attn_cfg = cfg.attn or {}
            self.attn = SelfAttention(
                hidden_size=cfg.hidden_size,
                num_heads=attn_cfg.get("num_heads", cfg.num_heads),
                num_kv_heads=attn_cfg.get("num_kv_heads"),
                qkv_bias=attn_cfg.get("qkv_bias", False),
                window_size=attn_cfg.get("window_size"),
                rope_theta=attn_cfg.get("rope_theta", 10000.0),
                max_position_embeddings=cfg.max_position_embeddings,
                device=device,
            )
        elif self.extends == "gated_deltanet":
            self.attn = GatedDeltaNet(
                hidden_size=cfg.hidden_size,
                head_dim=int(cfg.hidden_size * cfg.expand_k) // cfg.num_heads,
                num_heads=cfg.num_heads,
                expand_v=cfg.expand_v / cfg.expand_k,
                norm_eps=cfg.norm_eps,
                device=device,
            )
        elif self.extends in ("gla", "simple_gla"):
            self.attn = GatedLinearAttention(
                hidden_size=cfg.hidden_size,
                expand_k=cfg.expand_k,
                expand_v=cfg.expand_v,
                num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                feature_map=cfg.feature_map,
                use_output_gate=cfg.use_output_gate,
                elementwise_affine=cfg.elementwise_affine,
                norm_eps=cfg.norm_eps,
                chunk_size=cfg.chunk_size,
                simple=self.extends == "simple_gla",
                device=device,
            )
        elif self.extends == "mamba2":
            self.attn = Mamba2(
                hidden_size=cfg.hidden_size,
                head_dim=max(int(cfg.hidden_size * cfg.expand_v) // cfg.num_heads, 8),
                chunk_size=cfg.chunk_size,
                norm_eps=cfg.norm_eps,
                device=device,
            )
        elif self.extends == "mamba":
            self.attn = Mamba(hidden_size=cfg.hidden_size, chunk_size=cfg.chunk_size,
                              device=device)
        elif self.extends == "linear_attn":
            self.attn = CausalLinearAttention(
                hidden_size=cfg.hidden_size, expand_k=cfg.expand_k, expand_v=cfg.expand_v,
                num_heads=cfg.num_heads, chunk_size=cfg.chunk_size, device=device,
            )
        else:
            self.attn = MHLACausal(
                hidden_size=cfg.hidden_size,
                expand_k=cfg.expand_k,
                expand_v=cfg.expand_v,
                num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                feature_map=cfg.feature_map,
                use_short_conv=cfg.use_short_conv,
                conv_size=cfg.conv_size,
                use_output_gate=cfg.use_output_gate,
                elementwise_affine=cfg.elementwise_affine,
                norm_eps=cfg.norm_eps,
                chunk_size=cfg.chunk_size,
                num_slots=cfg.num_slots,
                mode=cfg.attn_mode,
                device=device,
            )
        self.mlp_norm = RMSNorm(cfg.hidden_size, eps=cfg.norm_eps, device=device)
        self.mlp = GatedMLP(
            cfg.hidden_size, cfg.hidden_ratio, cfg.intermediate_size, device=device
        )

    def forward(self, x, state=None, use_cache=False, attention_mask=None, segment_ids=None):
        if self.is_softmax:
            h, new_state = self.attn(self.attn_norm(x), state, use_cache, segment_ids)
        elif self.extends != "mhla":
            if segment_ids is not None:
                raise NotImplementedError(
                    "packed-varlen segment_ids is implemented for the mhla and softmax "
                    f"attention paths, not attn_extends={self.extends}"
                )
            h, new_state = self.attn(self.attn_norm(x), state, use_cache)
        else:
            h, new_state = self.attn(
                self.attn_norm(x), state, use_cache, attention_mask, segment_ids
            )
        x = x + h
        return x + self.mlp(self.mlp_norm(x)), new_state


class MHLAModel(nn.Module):
    def __init__(self, config: MHLALMConfig, remat: bool = False, device=None):
        super().__init__()
        self.config = config
        self.remat = remat
        self.embeddings = nn.Embedding(config.vocab_size, config.hidden_size, device=device)
        self.layers = nn.ModuleList(
            MHLABlock(config, i, device=device) for i in range(config.num_hidden_layers)
        )
        self.norm = RMSNorm(config.hidden_size, eps=config.norm_eps, device=device)

    def forward(self, input_ids, states=None, use_cache=False, attention_mask=None,
                segment_ids=None):
        x = self.embeddings(input_ids).to(self.config.dtype)
        remat = self.remat and torch.is_grad_enabled()
        new_states = []
        for i, layer in enumerate(self.layers):
            args = (x, states[i] if states is not None else None, use_cache, attention_mask,
                    segment_ids)
            x, s = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
            new_states.append(s)
        return self.norm(x), (new_states if use_cache else None)


class MHLAForCausalLM(nn.Module):
    def __init__(self, config: MHLALMConfig, remat: bool = False, device=None):
        super().__init__()
        self.config = config
        self.model = MHLAModel(config, remat=remat, device=device)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(
                config.hidden_size, config.vocab_size, bias=False, device=device
            )

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T] int64
        states: Optional[List[Any]] = None,
        use_cache: bool = False,
        attention_mask: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        output_hidden: bool = False,
    ):
        """(logits, states), or with ``output_hidden`` (the final hidden
        states, states): the caller forms the loss with
        :func:`fused_lm_loss`, logits never whole."""
        x, new_states = self.model(input_ids, states, use_cache, attention_mask, segment_ids)
        if output_hidden:
            return x, new_states
        if self.config.tie_word_embeddings:
            logits = x @ self.model.embeddings.weight.to(x.dtype).T
        else:
            logits = dense(x, self.lm_head)
        return logits, new_states


@torch.no_grad()
def init_lm_params(model: MHLAForCausalLM, generator: torch.Generator) -> MHLAForCausalLM:
    """Reference init scheme, in place: normal(initializer_range) for the
    embedding and every Linear weight, o_proj/down_proj rescaled by
    1/sqrt(2 * num_layers); biases zero (flax's), norms stay ones and mixing
    matrices keep their causal init. Every 2-D weight counts, the short
    convolutions' [kernel_size, features] weights and Mamba's ``dt_proj``
    too, as in JAX (Mamba's 2-D ``A_log`` keeps its S4D init); the Gated
    DeltaNet and Mamba2 layers draw their ``A_log`` and ``dt_bias`` and the
    Mamba layers their ``dt_proj`` bias from ``generator`` as well.
    ``generator`` lives on the parameters' device."""
    cfg = model.config
    scale = 1.0 / math.sqrt(2 * cfg.num_hidden_layers)
    for name, p in model.named_parameters():
        if p.ndim == 2 and name.endswith(".weight"):
            p.normal_(0.0, cfg.initializer_range, generator=generator)
            if name.endswith(("o_proj.weight", "down_proj.weight")):
                p.mul_(scale)
        elif name.endswith(".bias"):
            p.zero_()
    for module in model.modules():
        if isinstance(module, (GatedDeltaNet, Mamba2)):
            module.reset_gate_parameters(generator)
        elif isinstance(module, Mamba):
            _dt_proj_bias_init(module.dt_proj.bias, generator)
    return model


def unembedding_weight(model: MHLAForCausalLM) -> torch.Tensor:
    """The [V, H] unembedding matrix: the tied embedding or ``lm_head``."""
    if model.config.tie_word_embeddings:
        return model.model.embeddings.weight
    return model.lm_head.weight


def fused_lm_loss(model: MHLAForCausalLM, input_ids: torch.Tensor, ignore_index: int = -100,
                  chunk_size: int = 4096) -> torch.Tensor:
    """The shifted LM loss without the logits whole (the
    ``fuse_linear_cross_entropy`` path): the final hidden states against
    the unembedding in chunks of ``chunk_size`` rows."""
    hidden, _ = model(input_ids, output_hidden=True)
    return fused_linear_cross_entropy(hidden[:, :-1], unembedding_weight(model), input_ids[:, 1:],
                                      chunk_size=chunk_size, ignore_index=ignore_index)


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100
) -> torch.Tensor:
    """Shifted LM cross-entropy: predict token t+1 from position t."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:]
    mask = labels != ignore_index
    labels_safe = torch.where(mask, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
