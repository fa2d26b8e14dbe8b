"""LM data pipeline in numpy: shard + shuffle + token packing with resumable
state (counterpart of ``mhla_tpu/data/lm_data.py``; the same rows and
batches for the same seed).

Documents are packed into a rolling token buffer and emitted as fixed-length
rows; iteration order is shuffle-then-shard by rank per epoch; the
iterator exposes ``state_dict``/``load_state_dict``. A synthetic Zipf-like
corpus stands in when no dataset is given. ``varlen=True`` packs several
documents per row with exact boundaries instead (``PackedVarlenIterator``:
dict rows with segment ids and targets).
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


class PackedVarlenIterator:
    """Varlen packing: several documents per row with exact boundaries.

    Each document is padded to a multiple of ``chunk_size`` (boundaries on
    chunk boundaries, so the MHLA chunk grid isolates documents exactly; see
    ``ops.mhla_chunk.build_segment_mixing``), rows are filled greedily, and
    a document longer than the room left in the row (or than ``num_slots``
    chunks) is split, its remainder starting a fresh segment.

    Yields dict rows:
      input_ids   [T] int32 (``pad_id`` at alignment pads)
      segment_ids [T] int32 (one id per document or pad run, increasing)
      targets     [T] int32 (``input_ids`` where the previous token is a
                  real token of the same document, else ``ignore_index``;
                  the loss shifts it as it shifts token rows)
    """

    def __init__(
        self,
        source: Callable[[int], Iterable[List[int]]],
        seq_len: int,
        chunk_size: int = 64,
        num_slots: int = 32,
        pad_id: int = 0,
        ignore_index: int = -100,
        state: Optional[PackingState] = None,
    ):
        if seq_len % chunk_size:
            raise ValueError("seq_len must be a multiple of chunk_size")
        self.source = source
        self.seq_len = seq_len
        self.chunk_size = chunk_size
        self.max_doc = min(num_slots * chunk_size, seq_len)
        self.pad_id = pad_id
        self.ignore_index = ignore_index
        self.state = state or PackingState()

    def _emit(self, docs: List[List[int]]) -> Dict[str, np.ndarray]:
        t, c = self.seq_len, self.chunk_size
        tokens = np.full(t, self.pad_id, np.int32)
        seg = np.zeros(t, np.int32)
        targets = np.full(t, self.ignore_index, np.int32)
        pos = sid = 0
        for doc in docs:
            n = len(doc)
            tokens[pos:pos + n] = doc
            seg[pos:pos + n] = sid
            targets[pos + 1:pos + n] = doc[1:]
            pos += n
            pad = (-n) % c
            if pad:  # the alignment pad run is a segment of its own
                sid += 1
                seg[pos:pos + pad] = sid
                pos += pad
            sid += 1
        if pos < t:  # the trailing pad
            seg[pos:] = sid
        return {"input_ids": tokens, "segment_ids": seg, "targets": targets}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            it = iter(self.source(self.state.epoch))
            for _ in range(self.state.doc_index):  # fast-forward to the resume point
                next(it, None)
            row: List[List[int]] = []
            room = self.seq_len
            for doc in it:
                self.state.doc_index += 1
                doc = list(doc)
                while doc:
                    piece = doc[:min(self.max_doc, room)]
                    doc = doc[len(piece):]
                    row.append(piece)
                    room -= len(piece) + (-len(piece)) % self.chunk_size
                    if room < self.chunk_size:
                        yield self._emit(row)
                        row, room = [], self.seq_len
            if row:
                yield self._emit(row)
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


def batched(row_iter: Iterator[Any], batch_size: int) -> Iterator[Any]:
    """Stack ``batch_size`` rows: arrays into one array, dict rows key by key."""
    buf = []
    for row in row_iter:
        buf.append(row)
        if len(buf) == batch_size:
            if isinstance(buf[0], dict):
                yield {k: np.stack([r[k] for r in buf]) for k in buf[0]}
            else:
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
) -> Iterator[Any]:
    """Batches of [batch, seq_len] int32 token rows, or with ``varlen`` dict
    batches (``input_ids``, ``segment_ids``, ``targets``) of packed
    documents with exact boundaries."""
    all_docs = docs if docs is not None else synthetic_documents(vocab_size)

    def source(epoch: int):
        return shard_documents(all_docs, rank, world_size, seed, epoch)

    if varlen:
        rows = PackedVarlenIterator(source, seq_len, chunk_size=chunk_size, num_slots=num_slots)
    else:
        rows = PackedTokenIterator(source, seq_len)
    return batched(iter(rows), batch_size)
