"""Data pipelines (numpy) of the port."""

from .lm_data import (
    PackedTokenIterator,
    PackedVarlenIterator,
    PackingState,
    batched,
    make_lm_dataloader,
    shard_documents,
    synthetic_documents,
)

__all__ = [
    "PackedTokenIterator",
    "PackedVarlenIterator",
    "PackingState",
    "batched",
    "make_lm_dataloader",
    "shard_documents",
    "synthetic_documents",
]
