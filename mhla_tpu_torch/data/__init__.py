"""Data pipelines (numpy) of the port."""

from .lm_data import (
    PackedTokenIterator,
    PackingState,
    batched,
    make_lm_dataloader,
    shard_documents,
    synthetic_documents,
)

__all__ = [
    "PackedTokenIterator",
    "PackingState",
    "batched",
    "make_lm_dataloader",
    "shard_documents",
    "synthetic_documents",
]
