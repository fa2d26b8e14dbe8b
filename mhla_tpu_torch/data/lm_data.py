"""LM data pipeline in numpy: shard + shuffle + token packing with resumable
state (counterpart of ``mhla_tpu/data/lm_data.py``; the same rows and
batches for the same seed).

Documents are packed into a rolling token buffer and emitted as fixed-length
rows; iteration order is shuffle-then-shard by rank per epoch; the
iterator exposes ``state_dict``/``load_state_dict``. A synthetic Zipf-like
corpus stands in when no dataset is given. Packed varlen rows (segment ids)
are not ported: ``varlen=True`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class PackingState:
    doc_index: int = 0
    buffer: List[int] = dataclasses.field(default_factory=list)
    epoch: int = 0


class PackedTokenIterator:
    """Packs a document stream into fixed-length token rows.

    ``source(epoch) -> iterable of token lists``; rows are contiguous token
    windows (no padding) and the remainder stays in the buffer across
    documents."""

    def __init__(
        self,
        source: Callable[[int], Iterable[List[int]]],
        seq_len: int,
        state: Optional[PackingState] = None,
    ):
        self.source = source
        self.seq_len = seq_len
        self.state = state or PackingState()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            it = iter(self.source(self.state.epoch))
            for _ in range(self.state.doc_index):  # fast-forward to the resume point
                next(it, None)
            for doc in it:
                self.state.doc_index += 1
                self.state.buffer.extend(doc)
                while len(self.state.buffer) >= self.seq_len:
                    row = self.state.buffer[: self.seq_len]
                    del self.state.buffer[: self.seq_len]
                    yield np.asarray(row, dtype=np.int32)
            self.state.epoch += 1
            self.state.doc_index = 0

    def state_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.state = PackingState(**d)


def shard_documents(
    docs: List[Any], rank: int, world_size: int, seed: int, epoch: int
) -> List[Any]:
    """Shuffle deterministically per epoch, then contiguous-shard by rank."""
    order = np.random.default_rng(seed + epoch).permutation(len(docs))
    per_rank = len(docs) // world_size
    return [docs[i] for i in order[rank * per_rank : (rank + 1) * per_rank]]


def batched(row_iter: Iterator[np.ndarray], batch_size: int) -> Iterator[np.ndarray]:
    buf = []
    for row in row_iter:
        buf.append(row)
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []


def synthetic_documents(
    vocab_size: int, num_docs: int = 1024, mean_len: int = 512, seed: int = 0
) -> List[List[int]]:
    """Zipf-like synthetic corpus for training without a dataset."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(num_docs):
        n = int(rng.integers(mean_len // 2, mean_len * 2))
        ranks = rng.zipf(1.3, size=n)
        docs.append(np.minimum(ranks, vocab_size - 1).astype(np.int32).tolist())
    return docs


def make_lm_dataloader(
    seq_len: int,
    batch_size: int,
    vocab_size: int = 32000,
    rank: int = 0,
    world_size: int = 1,
    seed: int = 42,
    docs: Optional[List[List[int]]] = None,
    varlen: bool = False,
    chunk_size: int = 64,
    num_slots: int = 32,
) -> Iterator[np.ndarray]:
    """Batches of [batch, seq_len] int32 token rows."""
    if varlen:
        raise NotImplementedError("packed varlen rows (segment ids) are not ported yet")
    all_docs = docs if docs is not None else synthetic_documents(vocab_size)

    def source(epoch: int):
        return shard_documents(all_docs, rank, world_size, seed, epoch)

    return batched(iter(PackedTokenIterator(source, seq_len)), batch_size)
