"""The port's tar-shard data path (``mhla_tpu_torch.data.native``,
``mhla_tpu_torch.data.tar_shards`` and the video trainer's tar latents) held
against ``mhla_tpu.data`` on the CPU: shards written by either package read
the same in the other, key grouping and decoding, the samplers' index
streams for several ranks, world sizes, seeds and epochs, mid-epoch resume
(across the packages too), and ``video_batches`` from tar shards for rank 0
of 1 and rank 1 of 2."""

import dataclasses
import io
import json
import tarfile

import numpy as np
import pytest
import torch

from mhla_tpu.data import native as jax_native
from mhla_tpu.data import tar_shards as jax_tar
from mhla_tpu.train import wan_train as jax_wan_train
from mhla_tpu_torch.data import native, tar_shards
from mhla_tpu_torch.train import wan_train
from torch_threads import _two_torch_threads  # noqa: F401  (autouse)

PACKAGES = {"jax": jax_tar, "port": tar_shards}


def _samples(n, offset=0):
    return [{"__key__": f"sample_{offset + i:05d}",
             "npy": np.full((3, 4), offset + i, np.float32),
             "json": {"idx": offset + i, "tags": ["a", "b"]},
             "txt": f"caption {offset + i}",
             "bin": bytes([offset + i, 0, 255])}
            for i in range(n)]


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_shards_round_trip_between_the_packages(tmp_path, writer, reader):
    """Two shards written by ``writer``, every sample read through
    ``reader``'s ``ShardListDataset``: the same fields, decoded alike, as
    the writer's own package reads them."""
    paths = []
    for s, (n, offset) in enumerate(((3, 0), (4, 3))):
        path = str(tmp_path / f"shard-{s}.tar")
        PACKAGES[writer].write_tar_shard(path, _samples(n, offset))
        paths.append(path)
    ds = PACKAGES[reader].ShardListDataset(paths)
    own = PACKAGES[writer].ShardListDataset(paths)
    assert len(ds) == len(own) == 7 and list(ds.lengths) == [3, 4]
    for i in range(7):
        got = ds[i]
        assert got["__key__"] == f"sample_{i:05d}" and got["__index__"] == i
        assert got["json"] == {"idx": i, "tags": ["a", "b"]} and got["txt"] == f"caption {i}"
        np.testing.assert_array_equal(got["npy"], np.full((3, 4), i, np.float32))
        assert got["bin"] == bytes([i, 0, 255])
        _same_sample(got, own[i])
    ds.close()
    own.close()


def test_tar_reader_matches_jax_members_and_pax_long_names(tmp_path):
    """Member names in archive order, reads by index and by name, and a PAX
    archive with names past 100 characters (directories skipped)."""
    longkey = "d/" * 60 + "sample_00001"
    path = tmp_path / "pax.tar"
    with tarfile.open(path, "w", format=tarfile.PAX_FORMAT) as tf:
        folder = tarfile.TarInfo("d")
        folder.type = tarfile.DIRTYPE  # not a regular member
        tf.addfile(folder)
        for ext, data in (("npy", b"A" * 17), ("txt", b"hello"), ("json", b"")):
            info = tarfile.TarInfo(f"{longkey}.{ext}")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    with native.TarShard(str(path)) as ours:
        ref = jax_native.TarShard(str(path))
        assert ours.names() == ref.names() == [f"{longkey}.{e}" for e in ("npy", "txt", "json")]
        for i, name in enumerate(ours.names()):
            assert ours.read(i) == ours.read(name) == ref.read(i)
        assert ours.read(2) == b""
        ref.close()


def test_keys_groups_and_decoders_match_jax():
    names = ["a.npy", "a.json", "b.npy", "b.json", "dir/c.meta.json", "noext", "a.txt"]
    for name in names:
        assert tar_shards.split_key(name) == jax_tar.split_key(name)
    assert tar_shards.group_by_key(names) == jax_tar.group_by_key(names)
    assert tar_shards.group_by_key(names)[0] == {"__key__": "a", "npy": 0, "json": 1, "txt": 6}
    buf = io.BytesIO()
    np.save(buf, np.arange(6.0).reshape(2, 3))
    npz = io.BytesIO()
    np.savez(npz, x=np.ones(2), y=np.arange(3))
    for ext, blob in (("json", b'{"a": [1, 2]}'), ("txt", "hé".encode()), ("cls", b"7\n"),
                      ("npy", buf.getvalue()), ("npz", npz.getvalue()), ("mp4", b"\x00raw"),
                      ("latent.npy", buf.getvalue()), ("caption", b"x")):
        a, b = tar_shards.default_decode(ext, blob), jax_tar.default_decode(ext, blob)
        if isinstance(b, dict) and ext == "npz":
            assert a.keys() == b.keys() and all((a[k] == b[k]).all() for k in a)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b and type(a) is type(b)


def test_dataset_spec_transform_and_lru_match_jax(tmp_path):
    paths = []
    for s in range(4):
        path = str(tmp_path / f"s{s}.tar")
        tar_shards.write_tar_shard(path, _samples(2, 2 * s))
        paths.append(path)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"shardlist": [{"url": p, "nsamples": 2} for p in paths]}))
    ds = tar_shards.ShardListDataset(str(spec), transform=lambda s: s["json"]["idx"],
                                     lru_size=2)
    ref = jax_tar.ShardListDataset(str(spec), transform=lambda s: s["json"]["idx"], lru_size=2)
    order = [0, 2, 0, 4, 7, 3, 6, 1]
    assert [ds[i] for i in order] == [ref[i] for i in order] == order
    assert list(ds._open) == list(ref._open) and len(ds._open) == 2  # the same LRU state
    ds.close()
    ref.close()


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_sampler_streams_match_jax(world):
    """Every rank's index stream over two epochs: ``ChunkedSampler`` with
    and without shuffling, ``distributed_chunked_sampler`` and
    ``DistributedRangedSampler``, as JAX's."""
    data = list(range(103))
    for rank in range(world):
        for seed in (0, 5):
            pairs = [
                (tar_shards.distributed_chunked_sampler(data, rank, world, chunksize=10,
                                                        seed=seed),
                 jax_tar.distributed_chunked_sampler(data, rank, world, chunksize=10, seed=seed)),
                (tar_shards.distributed_chunked_sampler(data, rank, world, chunksize=7, seed=seed,
                                                        shufflefirst=True),
                 jax_tar.distributed_chunked_sampler(data, rank, world, chunksize=7, seed=seed,
                                                     shufflefirst=True)),
                (tar_shards.DistributedRangedSampler(data, rank, world),
                 jax_tar.DistributedRangedSampler(data, rank, world)),
            ]
            for ours, ref in pairs:
                assert len(ours) == len(ref)
                for _ in range(2):
                    assert list(ours) == list(ref)
    ours = tar_shards.ChunkedSampler(data, num_samples=(10, 60), chunksize=8, shuffle=False)
    assert list(ours) == list(jax_tar.ChunkedSampler(data, (10, 60), 8, shuffle=False))
    covered = sorted(i for r in range(3) for i in tar_shards.DistributedRangedSampler(data, r, 3))
    assert covered == list(range(102))  # the ranged split drops 103 % 3 samples


def test_ranged_sampler_resumes_mid_epoch_across_the_packages():
    """A state taken after 7 indices of rank 1 of 3, loaded by either
    package's sampler, gives the rest of that epoch and then the next."""
    data = list(range(50))
    ours = tar_shards.DistributedRangedSampler(data, rank=1, world_size=3)
    it = iter(ours)
    first = [next(it) for _ in range(7)]
    assert first == list(range(16, 23))
    state = ours.state_dict()
    assert state == {"epoch": 0, "step_start": 7}
    for cls in (tar_shards.DistributedRangedSampler, jax_tar.DistributedRangedSampler):
        again = cls(data, rank=1, world_size=3)
        again.load_state_dict(state)
        assert first + list(again) == list(range(16, 32))
        assert again.state_dict() == {"epoch": 1, "step_start": 0}
        assert list(again) == list(range(16, 32))
    ref = jax_tar.DistributedRangedSampler(data, rank=1, world_size=3)
    it = iter(ref)
    [next(it) for _ in range(3)]
    ours.load_state_dict(ref.state_dict())
    assert list(ours) == list(range(19, 32))


def _latent_shards(root, n, shard_sizes, d):
    start = 0
    for s, size in enumerate(shard_sizes):
        tar_shards.write_tar_shard(str(root / f"latents-{s:04d}.tar"), [
            {"__key__": f"clip_{i:04d}",
             "latent.npy": np.full((d.latent_frames, d.latent_height, d.latent_width,
                                    d.latent_dim), i, np.float16),
             "text_emb.npy": np.full((d.text_len, d.text_dim), 100 + i, np.float32)}
            for i in range(start, start + size)])
        start += size
    assert start == n


def _tar_configs(tmp_path, batch):
    data = dict(latent_dir=str(tmp_path), latent_frames=2, latent_height=4, latent_width=6,
                latent_dim=3, text_len=5, text_dim=7)
    cfg = wan_train.WanTrainConfig(data=wan_train.WanDataCfg(**data),
                                   train=wan_train.WanTrainLoop(batch_size=batch))
    ref = jax_wan_train.WanTrainConfig(data=jax_wan_train.WanDataCfg(**data),
                                       train=jax_wan_train.WanTrainLoop(batch_size=batch))
    return cfg, ref


def test_video_batches_from_tar_shards_match_jax(tmp_path):
    """Seven clips in two shards (float16 latents, stored as written),
    batches of two: (0, 1), (2, 3), (4, 5), the seventh dropped, then the
    next epoch; float32 out, as the JAX trainer's stream. The npz files
    beside the shards are not read."""
    cfg, ref_cfg = _tar_configs(tmp_path, 2)
    _latent_shards(tmp_path, 7, (3, 4), cfg.data)
    np.savez(tmp_path / "ignored.npz", latent=np.zeros(1), text_emb=np.zeros(1))
    ours = wan_train.video_batches(cfg, np.random.default_rng(0))
    ref = jax_wan_train.video_batches(ref_cfg, np.random.default_rng(0))
    firsts = []
    for _ in range(5):
        (z, c), (zr, cr) = next(ours), next(ref)
        assert z.dtype == c.dtype == np.float32 and z.shape == (2, 2, 4, 6, 3)
        np.testing.assert_array_equal(z, zr)
        np.testing.assert_array_equal(c, cr)
        firsts.append(z[:, 0, 0, 0, 0].tolist())
    assert firsts == [[0, 1], [2, 3], [4, 5], [0, 1], [2, 3]]


def test_video_batches_take_rank_and_world_from_torch_distributed(tmp_path, monkeypatch):
    """Rank 1 of 2 (from ``torch.distributed``, as JAX takes them from its
    process index and count): the second half of the clips, 5 .. 9, in
    batches of two, its odd one out dropped."""
    cfg, ref_cfg = _tar_configs(tmp_path, 2)
    _latent_shards(tmp_path, 10, (4, 6), cfg.data)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(jax_wan_train.jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax_wan_train.jax, "process_count", lambda: 2)
    ours = wan_train.video_batches(cfg, np.random.default_rng(0))
    ref = jax_wan_train.video_batches(ref_cfg, np.random.default_rng(0))
    got = []
    for _ in range(3):
        (z, c), (zr, cr) = next(ours), next(ref)
        np.testing.assert_array_equal(z, zr)
        np.testing.assert_array_equal(c, cr)
        got.append(z[:, 0, 0, 0, 0].tolist())
    assert got == [[5, 6], [7, 8], [5, 6]]
    bigger = dataclasses.replace(cfg, train=wan_train.WanTrainLoop(batch_size=6))
    with pytest.raises(ValueError, match="a batch needs 6"):
        next(wan_train.video_batches(bigger, np.random.default_rng(0)))
