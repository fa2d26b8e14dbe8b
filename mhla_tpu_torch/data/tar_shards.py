"""Webdataset-style tar-shard datasets (counterpart of
``mhla_tpu/data/tar_shards.py``, the reference's wids subsystem): indexed
random access into ``.tar`` shards, samples grouped by basename key with
one field per extension, a shard-list dataset with cumulative lengths and
an LRU of open shards, chunk-local shuffling samplers and per-rank
contiguous ranges (``DistributedRangedSampler``) with resumable state, and
``write_tar_shard``. numpy only: the samplers are plain iterables, and a
shard written by either package reads the same in the other.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .native import TarShard


def split_key(name: str) -> Tuple[str, str]:
    """webdataset key split: directory + basename up to the FIRST dot is
    the sample key, the rest is the field extension
    (reference ``wids.py:115-123``)."""
    p = Path(name)
    stem = p.name.split(".", 1)
    ext = stem[1] if len(stem) > 1 else ""
    return str(p.parent / stem[0]) if str(p.parent) != "." else stem[0], ext


def group_by_key(names: Sequence[str]) -> List[Dict[str, int]]:
    """Group member indices into samples keyed by extension
    (reference ``wids.py:125-151``). Order of first appearance is kept."""
    samples: List[Dict[str, Any]] = []
    index: Dict[str, int] = {}
    for i, name in enumerate(names):
        key, ext = split_key(name)
        if key not in index:
            index[key] = len(samples)
            samples.append({"__key__": key})
        samples[index[key]][ext] = i
    return samples


def default_decode(ext: str, blob: bytes) -> Any:
    """Extension-driven field decoding (reference ``wids.py:154-227``).
    Unknown extensions pass through as raw bytes."""
    e = ext.lower().rsplit(".", 1)[-1]
    if e == "json":
        return json.loads(blob)
    if e in ("txt", "text", "caption"):
        return blob.decode("utf-8")
    if e == "cls":
        return int(blob.decode("utf-8").strip())
    if e == "npy":
        return np.load(io.BytesIO(blob), allow_pickle=False)
    if e == "npz":
        return dict(np.load(io.BytesIO(blob), allow_pickle=False))
    if e in ("jpg", "jpeg", "png", "webp"):
        try:
            from PIL import Image

            return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        except Exception:
            return blob
    return blob  # mp4/mkv/bin/...: caller-side decoding


class ShardListDataset:
    """Random access over a list of tar shards (reference ``wids.py:478``).

    ``shards``: tar paths, or a JSON spec file/list of ``{"url": ...,
    "nsamples": ...}`` dicts (wids shard-spec shape, ``wids_specs.py``).
    Shards without a sample count are opened once to count. An LRU of open
    ``TarShard`` readers bounds file handles (reference ``wids_lru.py``).
    """

    def __init__(
        self,
        shards: Union[str, Sequence[Union[str, Dict[str, Any]]]],
        transform: Optional[Callable[[Dict[str, Any]], Any]] = None,
        decode: Callable[[str, bytes], Any] = default_decode,
        lru_size: int = 8,
    ):
        if isinstance(shards, (str, Path)):
            spec = json.loads(Path(shards).read_text())
            shards = spec["shardlist"] if isinstance(spec, dict) else spec
        self.paths: List[str] = []
        counts: List[Optional[int]] = []
        for s in shards:
            if isinstance(s, dict):
                self.paths.append(s["url"])
                counts.append(s.get("nsamples"))
            else:
                self.paths.append(str(s))
                counts.append(None)
        self.decode = decode
        self.transform = transform
        self.lru_size = lru_size
        self._open: Dict[int, Tuple[TarShard, List[Dict[str, int]]]] = {}
        self.lengths = [
            c if c is not None else len(self._shard(i)[1])
            for i, c in enumerate(counts)
        ]
        self.cum_lengths = np.cumsum(self.lengths)
        self.total_length = int(self.cum_lengths[-1]) if self.lengths else 0

    def _shard(self, i: int) -> Tuple[TarShard, List[Dict[str, int]]]:
        if i in self._open:
            # refresh recency (dict preserves insertion order, eviction pops
            # the front) so the cache is LRU, not FIFO
            self._open[i] = self._open.pop(i)
            return self._open[i]
        if len(self._open) >= self.lru_size:
            evict = next(iter(self._open))
            self._open.pop(evict)[0].close()
        reader = TarShard(self.paths[i])
        samples = group_by_key(reader.names())
        self._open[i] = (reader, samples)
        return self._open[i]

    def __len__(self) -> int:
        return self.total_length

    def __getitem__(self, index: int) -> Dict[str, Any]:
        shard_idx = int(np.searchsorted(self.cum_lengths, index, side="right"))
        inner = index - (int(self.cum_lengths[shard_idx - 1]) if shard_idx else 0)
        reader, samples = self._shard(shard_idx)
        fields = samples[inner]
        out: Dict[str, Any] = {
            "__key__": fields["__key__"],
            "__index__": index,
            "__shard__": self.paths[shard_idx],
        }
        for ext, member in fields.items():
            if ext.startswith("__"):
                continue
            out[ext] = self.decode(ext, reader.read(member))
        if self.transform is not None:
            out = self.transform(out)
        return out

    def close(self):
        for reader, _ in self._open.values():
            reader.close()
        self._open.clear()


class ChunkedSampler:
    """Chunk-local shuffling: indices are split into contiguous chunks,
    chunks and intra-chunk order shuffle per epoch (reference
    ``wids.py:881-924`` — preserves shard locality of reference while
    still randomizing)."""

    def __init__(
        self,
        dataset,
        num_samples: Optional[Union[int, Tuple[int, int]]] = None,
        chunksize: int = 2000,
        seed: int = 0,
        shuffle: bool = True,
        shufflefirst: bool = False,
    ):
        if isinstance(num_samples, int):
            lo, hi = 0, num_samples
        elif num_samples is None:
            lo, hi = 0, len(dataset)
        else:
            lo, hi = num_samples
        self.ranges = [
            (i, min(i + chunksize, hi)) for i in range(lo, hi, chunksize)
        ]
        self.seed = seed
        self.shuffle = shuffle
        self.shufflefirst = shufflefirst
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return sum(hi - lo for lo, hi in self.ranges)

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + 1289738273 * self.epoch)
        ranges = list(self.ranges)
        if self.shuffle and (self.shufflefirst or self.epoch > 0):
            rng.shuffle(ranges)
        for lo, hi in ranges:
            block = np.arange(lo, hi)
            if self.shuffle:
                rng.shuffle(block)
            yield from block.tolist()
        self.epoch += 1


def distributed_chunked_sampler(
    dataset,
    rank: int = 0,
    world_size: int = 1,
    num_samples: Optional[int] = None,
    chunksize: int = 1_000_000,
    seed: int = 0,
    shuffle: bool = True,
    shufflefirst: bool = False,
) -> ChunkedSampler:
    """Per-rank contiguous split, then chunk shuffling within the split —
    each rank touches a fixed subset of shards (reference
    ``wids.py:927-971``)."""
    num_samples = num_samples or len(dataset)
    per = (num_samples + world_size - 1) // world_size
    lo = rank * per
    hi = min(lo + per, num_samples)
    return ChunkedSampler(
        dataset,
        num_samples=(lo, hi),
        chunksize=chunksize,
        seed=seed,
        shuffle=shuffle,
        shufflefirst=shufflefirst,
    )


class DistributedRangedSampler:
    """Sequential per-rank range with a resumable start offset (reference
    ``wids.py:972-1018``); ``state_dict``/``load_state_dict`` give exact
    mid-epoch resume for the trainers."""

    def __init__(
        self,
        dataset,
        rank: int = 0,
        world_size: int = 1,
        num_samples: Optional[int] = None,
    ):
        num_samples = num_samples or len(dataset)
        per = num_samples // world_size
        self.worker_start = rank * per
        self.worker_end = min((rank + 1) * per, num_samples)
        self.step_start = 0
        self.epoch = 0

    def __len__(self) -> int:
        return self.worker_end - self.worker_start

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_start(self, start: int):
        self.step_start = start

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "step_start": self.step_start}

    def load_state_dict(self, state: Dict[str, int]):
        self.epoch = int(state["epoch"])
        self.step_start = int(state["step_start"])

    def __iter__(self) -> Iterator[int]:
        for i in range(self.worker_start + self.step_start, self.worker_end):
            self.step_start = i - self.worker_start + 1
            yield i
        self.epoch += 1
        self.step_start = 0


def write_tar_shard(path: str, samples: Sequence[Dict[str, Any]]):
    """Test/tooling helper: write samples (dicts of field-extension ->
    bytes/str/array) as one webdataset-style tar shard."""
    import tarfile
    import time

    with tarfile.open(path, "w") as tf:
        for sample in samples:
            key = sample["__key__"]
            for ext, value in sample.items():
                if ext.startswith("__"):
                    continue
                if isinstance(value, np.ndarray):
                    buf = io.BytesIO()
                    np.save(buf, value)
                    blob = buf.getvalue()
                elif isinstance(value, (dict, list)):
                    blob = json.dumps(value).encode()
                elif isinstance(value, str):
                    blob = value.encode()
                else:
                    blob = value
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(blob)
                info.mtime = int(time.time())
                tf.addfile(info, io.BytesIO(blob))
